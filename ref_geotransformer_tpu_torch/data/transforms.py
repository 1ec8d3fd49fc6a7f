"""Numpy augmentation library for synthetic registration datasets.

Ref parity: geotransformer/transforms/functional.py:7-162 — normalization,
(random) sampling, scale/shift, jitter, shuffle, dropout, plane and
viewpoint crops. All functions take an explicit np.random.Generator for
reproducibility (the reference uses global numpy/random state).

A copy of `ref_geotransformer_tpu/data/transforms.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def normalize_points(points: np.ndarray) -> np.ndarray:
    """Center at origin, scale into the unit sphere."""
    points = points - points.mean(axis=0)
    return points / np.max(np.linalg.norm(points, axis=1))


def sample_points(points: np.ndarray, num_samples: int, normals: Optional[np.ndarray] = None):
    """First-K sampling."""
    if normals is not None:
        return points[:num_samples], normals[:num_samples]
    return points[:num_samples]


def random_sample_points(
    points: np.ndarray, num_samples: int, normals: Optional[np.ndarray] = None, rng: Optional[np.random.Generator] = None
):
    """Random sampling with repeat-padding when the cloud is too small."""
    rng = rng or np.random.default_rng()
    n = points.shape[0]
    sel = rng.permutation(n)
    if n > num_samples:
        sel = sel[:num_samples]
    elif n < num_samples:
        reps = [sel] * (num_samples // n)
        if num_samples % n:
            reps.append(sel[: num_samples % n])
        sel = np.concatenate(reps)
    if normals is not None:
        return points[sel], normals[sel]
    return points[sel]


def random_scale_shift_points(
    points: np.ndarray,
    low: float = 2.0 / 3.0,
    high: float = 3.0 / 2.0,
    shift: float = 0.2,
    normals: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
):
    rng = rng or np.random.default_rng()
    scale = rng.uniform(low, high, (1, 3))
    bias = rng.uniform(-shift, shift, (1, 3))
    out = points * scale + bias
    if normals is not None:
        normals = normals * scale
        normals = normals / np.linalg.norm(normals, axis=1, keepdims=True)
        return out, normals
    return out


def random_rotate_points_along_up_axis(
    points: np.ndarray, normals: Optional[np.ndarray] = None, rng: Optional[np.random.Generator] = None
):
    rng = rng or np.random.default_rng()
    theta = rng.random() * 2.0 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    rotation_t = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    if normals is not None:
        return points @ rotation_t, normals @ rotation_t
    return points @ rotation_t


def random_rescale_points(points, low=0.8, high=1.2, rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    return points * rng.uniform(low, high)


def random_jitter_points(points, scale, noise_magnitude=0.05, rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    noise = np.clip(rng.normal(scale=scale, size=points.shape), -noise_magnitude, noise_magnitude)
    return points + noise


def random_shuffle_points(points, normals: Optional[np.ndarray] = None, rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    indices = rng.permutation(points.shape[0])
    if normals is not None:
        return points[indices], normals[indices]
    return points[indices]


def random_dropout_points(points, max_p, rng: Optional[np.random.Generator] = None):
    """PointNet++-style dropout: dropped points collapse onto point 0."""
    rng = rng or np.random.default_rng()
    p = rng.random(points.shape[0]) * max_p
    masks = rng.random(points.shape[0]) < p
    points = points.copy()
    points[masks] = points[0]
    return points


def random_jitter_features(features, mu=0.0, sigma=0.01, rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    if rng.random() < 0.95:
        features = features + rng.normal(mu, sigma, features.shape).astype(np.float32)
    return features


def random_sample_plane(rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    phi = rng.uniform(0.0, 2 * np.pi)
    theta = rng.uniform(0.0, np.pi)
    return np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)])


def random_crop_points_with_plane(
    points, p_normal=None, keep_ratio=0.7, normals: Optional[np.ndarray] = None, rng=None
):
    """Keep the `keep_ratio` fraction on one side of a random plane."""
    rng = rng or np.random.default_rng()
    num_samples = int(np.floor(points.shape[0] * keep_ratio + 0.5))
    if p_normal is None:
        p_normal = random_sample_plane(rng)
    distances = points @ p_normal
    sel = np.argsort(-distances)[:num_samples]
    if normals is not None:
        return points[sel], normals[sel]
    return points[sel]


def random_sample_viewpoint(limit=500, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    return rng.random(3) + np.array([limit, limit, limit]) * rng.choice([1.0, -1.0], size=3)


def random_crop_points_from_viewpoint(
    points, viewpoint=None, keep_ratio=0.7, normals: Optional[np.ndarray] = None, rng=None
):
    """Keep the `keep_ratio` fraction closest to a random viewpoint."""
    rng = rng or np.random.default_rng()
    num_samples = int(np.floor(points.shape[0] * keep_ratio + 0.5))
    if viewpoint is None:
        viewpoint = random_sample_viewpoint(rng=rng)
    distances = np.linalg.norm(viewpoint - points, axis=1)
    sel = np.argsort(distances)[:num_samples]
    if normals is not None:
        return points[sel], normals[sel]
    return points[sel]
