"""Correspondence extraction and conversion, static shapes.

Counterpart of `ref_geotransformer_tpu/models/correspondence.py` (ref
parity: modules/registration/matching.py:12-228 and :331-443, and the
matching-only head modules/geotransformer/point_matching.py:5-115): score
matrix extractors (max, threshold, top-k, mutual), node to dense point
correspondences, per-patch overlap ratios and `point_matching`. Every
variable-length output is a fixed-capacity index buffer with a mask.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ref_geotransformer_tpu_torch.models.registration import compute_correspondence_matrix
from ref_geotransformer_tpu_torch.ops import selection
from ref_geotransformer_tpu_torch.ops.pairwise import masked_pairwise_distance
from ref_geotransformer_tpu_torch.ops.se3 import apply_transform


def extract_correspondences_from_scores(score_mat: torch.Tensor, mutual: bool = False, threshold: float = 0.0,
                                        limit: int = 256
                                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-max (optionally mutual) correspondences of an (M, N) score
    matrix above `threshold` (matching.py:12-76), the best `limit` by score.
    Returns (ref_indices, src_indices, scores, masks), each (limit,)."""
    m = score_mat.shape[0]
    row_best = torch.argmax(score_mat, dim=1)
    col_best = torch.argmax(score_mat, dim=0)
    row_scores = torch.gather(score_mat, 1, row_best[:, None])[:, 0]
    keep = row_scores > threshold
    if mutual:
        keep = keep & (col_best[row_best] == torch.arange(m, device=score_mat.device))
    keyed = torch.where(keep, row_scores, -torch.inf)
    top_scores, ref_indices = selection.max_k(keyed, min(limit, m))
    src_indices = row_best[ref_indices]
    masks = torch.isfinite(top_scores)
    pad = limit - ref_indices.shape[0]
    if pad > 0:
        ref_indices, src_indices, masks = F.pad(ref_indices, (0, pad)), F.pad(src_indices, (0, pad)), F.pad(masks, (0, pad))
        top_scores = F.pad(top_scores, (0, pad), value=-torch.inf)
    return ref_indices.int(), src_indices.int(), torch.where(masks, top_scores, 0.0), masks


def extract_correspondences_topk(score_mat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k highest cells of an (M, N) score matrix (matching.py:79-106):
    (ref_indices, src_indices, scores)."""
    n = score_mat.shape[1]
    scores, idx = selection.max_k(score_mat.reshape(-1), k)
    return (idx // n).int(), (idx % n).int(), scores


def _patch_cells(flat_idx: torch.Tensor, k: int):
    """Flat indices into (P, K, K) -> (patch, row, column)."""
    return flat_idx // (k * k), (flat_idx // k) % k, flat_idx % k


def node_correspondences_to_dense(ref_node_corr_indices, src_node_corr_indices, ref_node_knn_indices,
                                  src_node_knn_indices, ref_node_knn_masks, src_node_knn_masks, corr_mat, score_mat,
                                  limit: int):
    """Node (patch) correspondences and their (P, K, K) assignments ->
    the `limit` best dense point correspondences (matching.py:331-370 role):
    fine-point index pairs, scores and masks."""
    k = corr_mat.shape[1]
    weights = torch.where(corr_mat, score_mat, 0.0).reshape(-1)
    scores, flat = selection.max_k(weights, limit)
    b, r, s = _patch_cells(flat, k)
    ref_fine = ref_node_knn_indices[ref_node_corr_indices.long()[b], r]
    src_fine = src_node_knn_indices[src_node_corr_indices.long()[b], s]
    masks = scores > 0.0
    return ref_fine, src_fine, torch.where(masks, scores, 0.0), masks


def patch_overlap_ratios(ref_knn_points, src_knn_points, ref_knn_masks, src_knn_masks, transform, pos_radius: float):
    """Overlap ratios of paired patches (P, K, 3) (matching.py:373-443):
    the share of each side's valid points with a match of the other side
    within pos_radius under `transform`."""
    src_t = apply_transform(src_knn_points, transform)
    match = masked_pairwise_distance(ref_knn_points, src_t, ref_knn_masks, src_knn_masks) < pos_radius**2
    ref_counts = match.any(dim=2).sum(dim=1).float()
    src_counts = match.any(dim=1).sum(dim=1).float()
    ref_sizes = torch.clamp(ref_knn_masks.sum(dim=1).float(), min=1.0)
    src_sizes = torch.clamp(src_knn_masks.sum(dim=1).float(), min=1.0)
    return ref_counts / ref_sizes, src_counts / src_sizes


class PointMatchingResult(NamedTuple):
    ref_corr_points: torch.Tensor
    src_corr_points: torch.Tensor
    corr_scores: torch.Tensor
    corr_masks: torch.Tensor


def point_matching(ref_knn_points, src_knn_points, ref_knn_masks, src_knn_masks, matching_scores, node_corr_scores,
                   k: int, mutual: bool = True, confidence_threshold: float = 0.05, use_dustbin: bool = False,
                   use_global_score: bool = False, correspondence_limit: int = 8192) -> PointMatchingResult:
    """The matching-only head (point_matching.py:5-115): the cell selection
    of local-to-global registration, without the registration. As in the
    JAX package, the dustbin row and column are stripped before the
    selection whatever `use_dustbin` says."""
    if matching_scores.shape[1] == ref_knn_points.shape[1] + 1:
        matching_scores = matching_scores[:, :-1, :-1]
    score_mat = torch.exp(matching_scores)
    corr_mat = compute_correspondence_matrix(score_mat, ref_knn_masks, src_knn_masks, k, mutual,
                                             confidence_threshold)
    if use_global_score:
        score_mat = score_mat * node_corr_scores[:, None, None]
    score_mat = torch.where(corr_mat, score_mat, 0.0)
    kk = score_mat.shape[1]
    flat = score_mat.reshape(-1)
    corr_scores, flat_idx = selection.max_k(flat, min(correspondence_limit, flat.shape[0]))
    corr_masks = corr_scores > 0.0
    b, r, s = _patch_cells(flat_idx, kk)
    return PointMatchingResult(ref_knn_points[b, r], src_knn_points[b, s], torch.where(corr_masks, corr_scores, 0.0),
                               corr_masks)
