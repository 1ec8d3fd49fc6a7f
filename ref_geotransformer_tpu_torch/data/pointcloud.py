"""Host-side (numpy) point-cloud utilities: random rotations, transforms,
sampling. Ref parity: utils/pointcloud.py:11-273 (the numpy mirror of the
device-side ops in ref_geotransformer_tpu_torch.ops).

A copy of `ref_geotransformer_tpu/data/pointcloud.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def np_apply_transform(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    return points @ transform[:3, :3].T + transform[:3, 3]


def np_get_transform(rotation: np.ndarray, translation: np.ndarray) -> np.ndarray:
    transform = np.eye(4, dtype=rotation.dtype)
    transform[:3, :3] = rotation
    transform[:3, 3] = translation
    return transform


def np_inverse_transform(transform: np.ndarray) -> np.ndarray:
    rotation = transform[:3, :3].T
    translation = -rotation @ transform[:3, 3]
    return np_get_transform(rotation, translation)


def random_sample_rotation(rotation_factor: float = 1.0, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random rotation from zyx Euler angles in [0, 2pi/rotation_factor)
    (utils/pointcloud.py:112-117 semantics: LARGER factor = SMALLER rotations)."""
    from scipy.spatial.transform import Rotation

    rng = rng or np.random.default_rng()
    euler = rng.random(3) * 2.0 * np.pi / rotation_factor
    return Rotation.from_euler("zyx", euler).as_matrix().astype(np.float32)


def random_sample_rotation_v2(rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Fully random SO(3) rotation (utils/pointcloud.py:126-133)."""
    rng = rng or np.random.default_rng()
    # QR of a random Gaussian matrix with sign fix -> Haar-uniform rotation
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def random_point_limit(points: np.ndarray, limit: Optional[int], rng: Optional[np.random.Generator] = None):
    """Random truncation to at most `limit` points (dataset.py:60-66)."""
    if limit is not None and points.shape[0] > limit:
        rng = rng or np.random.default_rng()
        indices = rng.permutation(points.shape[0])[:limit]
        points = points[indices]
    return points


def get_nearest_correspondences(
    ref_points: np.ndarray, src_points: np.ndarray, transform: np.ndarray, matching_radius: float
) -> np.ndarray:
    """GT point correspondences within a radius, via scipy cKDTree
    (utils/registration.py:161-173)."""
    from scipy.spatial import cKDTree

    src_t = np_apply_transform(src_points, transform)
    tree = cKDTree(ref_points)
    pairs = tree.query_ball_point(src_t, matching_radius)
    corr = [(r, s) for s, rs in enumerate(pairs) for r in rs]
    return np.asarray(corr, dtype=np.int64).reshape(-1, 2)


def random_sample_keypoints(
    points: np.ndarray, feats: np.ndarray, num_keypoints: int, rng: Optional[np.random.Generator] = None
):
    """Uniform keypoint sampling (utils/pointcloud.py:139-151)."""
    rng = rng or np.random.default_rng()
    n = points.shape[0]
    if n > num_keypoints:
        sel = rng.choice(n, num_keypoints, replace=False)
        return points[sel], feats[sel]
    return points, feats


def sample_keypoints_with_scores(points: np.ndarray, feats: np.ndarray, scores: np.ndarray, num_keypoints: int):
    """Top-score keypoints (utils/pointcloud.py:154-165)."""
    if points.shape[0] > num_keypoints:
        sel = np.argsort(-scores)[:num_keypoints]
        return points[sel], feats[sel]
    return points, feats


def random_sample_keypoints_with_scores(
    points: np.ndarray, feats: np.ndarray, scores: np.ndarray, num_keypoints: int,
    rng: Optional[np.random.Generator] = None,
):
    """Score-weighted random sampling (utils/pointcloud.py:168-181)."""
    rng = rng or np.random.default_rng()
    n = points.shape[0]
    if n > num_keypoints:
        probs = scores / scores.sum()
        sel = rng.choice(n, num_keypoints, replace=False, p=probs)
        return points[sel], feats[sel]
    return points, feats


def sample_keypoints_with_nms(
    points: np.ndarray, feats: np.ndarray, scores: np.ndarray, num_keypoints: int, radius: float
):
    """Greedy score-ordered NMS keypoint selection (utils/pointcloud.py:184-210)."""
    from scipy.spatial import cKDTree

    order = np.argsort(-scores)
    tree = cKDTree(points)
    suppressed = np.zeros(points.shape[0], bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) >= num_keypoints:
            break
        for j in tree.query_ball_point(points[i], radius):
            suppressed[j] = True
    keep = np.asarray(keep, np.int64)
    return points[keep], feats[keep]


def random_sample_keypoints_with_nms(
    points: np.ndarray, feats: np.ndarray, scores: np.ndarray, num_keypoints: int, radius: float,
    rng: Optional[np.random.Generator] = None,
):
    """NMS pre-filter then random selection (utils/pointcloud.py:213-239)."""
    rng = rng or np.random.default_rng()
    nms_points, nms_feats = sample_keypoints_with_nms(points, feats, scores, points.shape[0], radius)
    n = nms_points.shape[0]
    if n > num_keypoints:
        sel = rng.choice(n, num_keypoints, replace=False)
        return nms_points[sel], nms_feats[sel]
    return nms_points, nms_feats


def regularize_normals(points: np.ndarray, normals: np.ndarray, positive: bool = True) -> np.ndarray:
    """Flip normals towards (or away from) the viewpoint at the origin
    (utils/pointcloud.py convention)."""
    dot = np.sum(points * normals, axis=1, keepdims=True)
    sign = -np.sign(dot) if positive else np.sign(dot)
    sign[sign == 0] = 1.0
    return normals * sign
