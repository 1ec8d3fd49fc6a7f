"""PLY / OBJ exports for any point-cloud viewer (numpy only, no open3d).

A copy of `ref_geotransformer_tpu/utils/visualization.py` (ref parity roles:
utils/visualization.py:14-158, utils/open3d.py:39-130): the writers format
every number as the JAX package's do, so the same arrays give byte-identical
files. `save_corr_pcd` also takes the port's output dict, whose values are
torch tensors on any device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _np(x) -> np.ndarray:
    """A torch tensor (any device) or array-like -> numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """ASCII PLY point-cloud writer."""
    n = points.shape[0]
    has_color = colors is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if has_color:
            c = np.clip(colors * 255 if colors.max() <= 1.0 else colors, 0, 255).astype(np.uint8)
            for p, cc in zip(points, c):
                f.write(f"{p[0]} {p[1]} {p[2]} {cc[0]} {cc[1]} {cc[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")


def write_obj_lines(path: str, ref_points: np.ndarray, src_points: np.ndarray) -> None:
    """Correspondence line set as OBJ (ref_points[i] <-> src_points[i])."""
    n = ref_points.shape[0]
    with open(path, "w") as f:
        for p in ref_points:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for p in src_points:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for i in range(n):
            f.write(f"l {i + 1} {i + n + 1}\n")


def node_color_map(point_to_node: np.ndarray, num_nodes: int, seed: int = 0) -> np.ndarray:
    """Random color per owning node (the point-to-node partition's view)."""
    rng = np.random.default_rng(seed)
    palette = rng.random((num_nodes + 1, 3))
    return palette[np.minimum(point_to_node, num_nodes)]


def feature_tsne_colors(features: np.ndarray, seed: int = 0, method: str = "pca") -> np.ndarray:
    """High-dimensional features -> RGB in [0, 1].

    method="pca" (default): the 3 principal components, deterministic.
    method="tsne": the reference's recipe (sklearn 1-D t-SNE, perplexity 40,
    300 iterations, Spectral colormap) where sklearn and matplotlib are
    installed; PCA with a warning otherwise.
    """
    if method == "tsne":
        try:
            from matplotlib import pyplot as plt
            from sklearn.manifold import TSNE

            feats64 = np.asarray(features, np.float64)
            try:
                tsne = TSNE(n_components=1, perplexity=40, max_iter=300, random_state=seed)
                t = tsne.fit_transform(feats64).reshape(-1)
            except TypeError:  # sklearn < 1.5 spells it n_iter
                tsne = TSNE(n_components=1, perplexity=40, n_iter=300, random_state=seed)
                t = tsne.fit_transform(feats64).reshape(-1)
            t = (t - t.min()) / max(t.max() - t.min(), 1e-9)
            return plt.cm.Spectral(t)[:, :3]
        except ImportError:  # pragma: no cover - env-dependent
            import warnings

            warnings.warn("sklearn/matplotlib unavailable; falling back to PCA colors")
    x = features - features.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    emb = x @ vt[:3].T
    emb = emb - emb.min(0, keepdims=True)
    return emb / np.maximum(emb.max(0, keepdims=True), 1e-9)


def dump_registration_ply(path_prefix: str, ref_points: np.ndarray, src_points: np.ndarray,
                          estimated_transform: np.ndarray) -> None:
    """Before/after clouds: ref (blue), src (orange), aligned src (green)."""
    blue = np.tile([0.2, 0.4, 1.0], (ref_points.shape[0], 1))
    orange = np.tile([1.0, 0.6, 0.1], (src_points.shape[0], 1))
    green = np.tile([0.2, 0.9, 0.3], (src_points.shape[0], 1))
    aligned = src_points @ estimated_transform[:3, :3].T + estimated_transform[:3, 3]
    write_ply(path_prefix + "_ref.ply", ref_points, blue)
    write_ply(path_prefix + "_src.ply", src_points, orange)
    write_ply(path_prefix + "_src_aligned.ply", aligned, green)


def write_ply_lines(path: str, points: np.ndarray, edges: np.ndarray, color: Optional[np.ndarray] = None) -> None:
    """ASCII PLY line set (vertex and edge elements)."""
    n, m = points.shape[0], edges.shape[0]
    rgb = (np.clip(color, 0, 1) * 255).astype(np.uint8) if color is not None else None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {m}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        if rgb is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for e in edges:
            if rgb is not None:
                f.write(f"{int(e[0])} {int(e[1])} {rgb[0]} {rgb[1]} {rgb[2]}\n")
            else:
                f.write(f"{int(e[0])} {int(e[1])}\n")


def _corr_lineset(src_pcd: np.ndarray, tgt_pcd: np.ndarray, pairs: np.ndarray):
    """(P, 2) [ref_idx, src_idx] pairs -> interleaved endpoints and edges."""
    points = np.empty((2 * len(pairs), 3), np.float32)
    points[0::2] = src_pcd[pairs[:, 1]]
    points[1::2] = tgt_pcd[pairs[:, 0]]
    edges = np.stack([np.arange(0, 2 * len(pairs), 2), np.arange(1, 2 * len(pairs), 2)], axis=1)
    return points, edges


def save_corr_pcd(output: dict, out_dir: str, prefix: str = "") -> float:
    """The coarse clouds and the ground-truth, predicted, inlier and outlier
    node correspondences as PLY line sets (ref parity:
    linemod/bop_utils.py:364-441 `save_corr_pcd`, the encoder trainer's
    validation dump). `output` is the model's output dict (padded, with
    masks and the dense ground-truth overlap map). Returns the coarse
    inlier ratio of the predictions."""
    os.makedirs(out_dir, exist_ok=True)
    ref_node_masks = _np(output["ref_node_masks"])
    src_node_masks = _np(output["src_node_masks"])
    tgt_pcd = _np(output["ref_points_c"])
    src_pcd = _np(output["src_points_c"])

    write_ply(os.path.join(out_dir, f"{prefix}pcd_frame.ply"), tgt_pcd[ref_node_masks])
    write_ply(os.path.join(out_dir, f"{prefix}pcd_model.ply"), src_pcd[src_node_masks])

    ref_idx = _np(output["ref_node_corr_indices"])
    src_idx = _np(output["src_node_corr_indices"])
    if "node_corr_masks" in output:
        keep = _np(output["node_corr_masks"]).astype(bool)
        ref_idx, src_idx = ref_idx[keep], src_idx[keep]
    pred_pairs = np.stack([ref_idx, src_idx], axis=1)

    gt_map = _np(output["gt_node_overlap_map"]) > 0.0
    gt_pairs = np.argwhere(gt_map)

    is_inlier = gt_map[pred_pairs[:, 0], pred_pairs[:, 1]]
    for name, pairs, color in (
        ("line_gt", gt_pairs, np.array([0.0, 1.0, 0.0])),
        ("line_pred", pred_pairs, np.array([0.0, 0.8, 0.2])),
        ("line_inlier", pred_pairs[is_inlier], np.array([0.0, 1.0, 0.0])),
        ("line_outlier", pred_pairs[~is_inlier], np.array([1.0, 0.0, 0.0])),
    ):
        points, edges = _corr_lineset(src_pcd, tgt_pcd, pairs.astype(np.int64))
        write_ply_lines(os.path.join(out_dir, f"{prefix}{name}.ply"), points, edges, color)
    return float(np.mean(is_inlier)) if len(is_inlier) else 0.0
