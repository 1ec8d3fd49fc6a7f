"""Numpy registration/eval helpers for the offline evaluation protocol.

Ref parity: geotransformer/utils/registration.py:17-281 (RRE/RTE, inlier
ratio, overlap, correspondence metrics) plus a numpy weighted-Procrustes and
a RANSAC baseline (utils/open3d.py:133-198's role, implemented open3d-free).

A copy of `ref_geotransformer_tpu/utils/registration.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def apply_transform_np(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    return points @ transform[:3, :3].T + transform[:3, 3]


def compute_relative_rotation_error(gt_rotation: np.ndarray, rotation: np.ndarray) -> float:
    x = np.clip(0.5 * (np.trace(gt_rotation.T @ rotation) - 1.0), -1.0, 1.0)
    return float(np.degrees(np.arccos(x)))


def compute_relative_translation_error(gt_translation: np.ndarray, translation: np.ndarray) -> float:
    return float(np.linalg.norm(gt_translation - translation))


def compute_registration_error(gt_transform: np.ndarray, transform: np.ndarray):
    rre = compute_relative_rotation_error(gt_transform[:3, :3], transform[:3, :3])
    rte = compute_relative_translation_error(gt_transform[:3, 3], transform[:3, 3])
    return rre, rte


def compute_inlier_ratio(
    ref_corr_points: np.ndarray, src_corr_points: np.ndarray, transform: np.ndarray, positive_radius: float = 0.1
) -> float:
    if ref_corr_points.shape[0] == 0:
        return 0.0
    residuals = np.linalg.norm(ref_corr_points - apply_transform_np(src_corr_points, transform), axis=1)
    return float(np.mean(residuals < positive_radius))


def compute_overlap(
    ref_points: np.ndarray, src_points: np.ndarray, transform: np.ndarray, positive_radius: float = 0.1
) -> float:
    from scipy.spatial import cKDTree

    src_t = apply_transform_np(src_points, transform)
    tree = cKDTree(src_t)
    dist, _ = tree.query(ref_points, k=1)
    return float(np.mean(dist < positive_radius))


def compute_registration_rmse(src_points: np.ndarray, gt_transform: np.ndarray, transform: np.ndarray) -> float:
    realignment = np.linalg.inv(gt_transform) @ transform
    realigned = apply_transform_np(src_points, realignment)
    return float(np.mean(np.linalg.norm(realigned - src_points, axis=1)))


def weighted_procrustes_np(
    src_points: np.ndarray, ref_points: np.ndarray, weights: Optional[np.ndarray] = None, eps: float = 1e-5
) -> np.ndarray:
    """Weighted Kabsch in numpy (offline mirror of models/procrustes.py)."""
    if weights is None:
        weights = np.ones(src_points.shape[0])
    weights = weights / (weights.sum() + eps)
    src_centroid = (src_points * weights[:, None]).sum(0)
    ref_centroid = (ref_points * weights[:, None]).sum(0)
    src_c = src_points - src_centroid
    ref_c = ref_points - ref_centroid
    h = src_c.T @ (weights[:, None] * ref_c)
    u, _, vt = np.linalg.svd(h)
    v, ut = vt.T, u.T
    d = np.sign(np.linalg.det(v @ ut))
    rotation = v @ np.diag([1.0, 1.0, d]) @ ut
    translation = ref_centroid - rotation @ src_centroid
    transform = np.eye(4)
    transform[:3, :3] = rotation
    transform[:3, 3] = translation
    return transform.astype(np.float32)


def ransac_registration_np(
    ref_corr_points: np.ndarray,
    src_corr_points: np.ndarray,
    distance_threshold: float = 0.05,
    num_points: int = 3,
    num_iterations: int = 1000,
    seed: int = 0,
) -> np.ndarray:
    """Correspondence-based RANSAC (open3d-free baseline; role parity with
    utils/open3d.py:133-166)."""
    n = ref_corr_points.shape[0]
    if n < num_points:
        return weighted_procrustes_np(src_corr_points, ref_corr_points)
    rng = np.random.default_rng(seed)
    best_transform = np.eye(4, dtype=np.float32)
    best_inliers = -1
    for _ in range(num_iterations):
        idx = rng.choice(n, num_points, replace=False)
        t = weighted_procrustes_np(src_corr_points[idx], ref_corr_points[idx])
        residuals = np.linalg.norm(
            ref_corr_points - apply_transform_np(src_corr_points, t), axis=1
        )
        inliers = int((residuals < distance_threshold).sum())
        if inliers > best_inliers:
            best_inliers = inliers
            best_transform = t
    # final refit on inliers
    residuals = np.linalg.norm(
        ref_corr_points - apply_transform_np(src_corr_points, best_transform), axis=1
    )
    mask = residuals < distance_threshold
    if mask.sum() >= num_points:
        best_transform = weighted_procrustes_np(src_corr_points[mask], ref_corr_points[mask])
    return best_transform


def evaluate_sparse_correspondences(
    ref_points: np.ndarray,
    src_points: np.ndarray,
    ref_corr_indices: np.ndarray,
    src_corr_indices: np.ndarray,
    gt_node_corr_map: np.ndarray,
) -> Dict:
    """Coarse (superpoint) matching precision / recall-ish stats
    (utils/registration.py:253-281) from the dense GT map."""
    hits = gt_node_corr_map[ref_corr_indices, src_corr_indices]
    precision = float(np.mean(hits > 0)) if hits.size else 0.0

    ref_hit = np.zeros(ref_points.shape[0], bool)
    src_hit = np.zeros(src_points.shape[0], bool)
    ref_hit[ref_corr_indices[hits > 0]] = True
    src_hit[src_corr_indices[hits > 0]] = True
    gt_ref = gt_node_corr_map.max(1) > 0
    gt_src = gt_node_corr_map.max(0) > 0
    ref_hit_ratio = float(ref_hit[gt_ref].mean()) if gt_ref.any() else 0.0
    src_hit_ratio = float(src_hit[gt_src].mean()) if gt_src.any() else 0.0

    return {
        "PIR": precision,
        "ref_hit_ratio": ref_hit_ratio,
        "src_hit_ratio": src_hit_ratio,
        "hit_ratio": 0.5 * (ref_hit_ratio + src_hit_ratio),
    }


def compute_correspondence_residual(
    ref_corr_points: np.ndarray, src_corr_points: np.ndarray, transform: np.ndarray
) -> float:
    """Mean distance between corresponding points under the GT transform
    (utils/registration.py:227-232)."""
    if ref_corr_points.shape[0] == 0:
        return 0.0
    residuals = np.linalg.norm(
        ref_corr_points - apply_transform_np(src_corr_points, transform), axis=1
    )
    return float(np.mean(residuals))


def evaluate_correspondences(
    ref_corr_points: np.ndarray, src_corr_points: np.ndarray, transform: np.ndarray, positive_radius: float = 0.1
) -> Dict:
    """Fine correspondence metrics (utils/registration.py:240-250): overlap of
    the correspondence sets, inlier ratio, mean residual, count."""
    return {
        "num_corr": int(ref_corr_points.shape[0]),
        "IR": compute_inlier_ratio(ref_corr_points, src_corr_points, transform, positive_radius),
        "overlap": compute_overlap(ref_corr_points, src_corr_points, transform, positive_radius),
        "residual": compute_correspondence_residual(ref_corr_points, src_corr_points, transform),
    }
