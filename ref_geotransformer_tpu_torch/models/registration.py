"""Ground-truth patch overlaps and local-to-global registration, static shapes.

Counterpart of `get_node_correspondences`, `compute_correspondence_matrix`
and `local_to_global_registration` in
`ref_geotransformer_tpu/models/registration.py`: a dense (M, N) overlap map
of the training labels; per-patch weighted Procrustes over all K^2 cells of
(P, K, K) weight tensors, a top-C dense verification set, the patch
hypothesis with the most inliers, then `num_refinement_steps` global refits.
The fits take their 3 x 3 SVDs from `ops/svd.py::svd` (on the card
cuSOLVER's batched Jacobi SVD, called as `torch.linalg.svd` calls it but
without its checks' read-backs), so nothing in the registration reads back
to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ref_geotransformer_tpu_torch.models.procrustes import weighted_procrustes
from ref_geotransformer_tpu_torch.ops import selection
from ref_geotransformer_tpu_torch.ops.pairwise import pairwise_distance
from ref_geotransformer_tpu_torch.ops.se3 import apply_transform


def get_node_correspondences(
    ref_nodes: torch.Tensor,
    src_nodes: torch.Tensor,
    ref_knn_points: torch.Tensor,
    src_knn_points: torch.Tensor,
    transform: torch.Tensor,
    pos_radius: float,
    ref_masks: torch.Tensor,
    src_masks: torch.Tensor,
    ref_knn_masks: torch.Tensor,
    src_knn_masks: torch.Tensor,
    candidate_limit: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (M, N) ground-truth patch-overlap map and ambiguity mask.

    overlap(i, j) is the mean of the fraction of ref patch i's points with a
    match in src patch j and the reverse, with src moved by `transform`; two
    points match when closer than pos_radius. Exact overlaps are computed
    for the `candidate_limit` node pairs whose enclosing spheres intersect
    the most (exact top-k by margin); an intersecting pair left out by the
    cap is marked ambiguous, neither positive nor negative.
    """
    m, n = ref_nodes.shape[0], src_nodes.shape[0]
    src_nodes_t = apply_transform(src_nodes, transform)
    src_knn_points_t = apply_transform(src_knn_points, transform)

    ref_dists = torch.linalg.norm(ref_knn_points - ref_nodes[:, None, :], dim=-1)
    ref_max_dists = torch.where(ref_knn_masks, ref_dists, 0.0).amax(dim=1)  # (M,)
    src_dists = torch.linalg.norm(src_knn_points_t - src_nodes_t[:, None, :], dim=-1)
    src_max_dists = torch.where(src_knn_masks, src_dists, 0.0).amax(dim=1)  # (N,)

    node_dists = torch.sqrt(pairwise_distance(ref_nodes, src_nodes_t))  # (M, N)
    margin = ref_max_dists[:, None] + src_max_dists[None, :] + pos_radius - node_dists
    margin = torch.where(ref_masks[:, None] & src_masks[None, :], margin, -torch.inf)

    top_margin, cand = torch.topk(margin.reshape(-1), candidate_limit)
    cand_valid = top_margin > 0.0
    cand_ref, cand_src = cand // n, cand % n

    ref_m = ref_knn_masks[cand_ref]  # (P, K)
    src_m = src_knn_masks[cand_src]
    dist2 = pairwise_distance(ref_knn_points[cand_ref], src_knn_points_t[cand_src])  # (P, K, K)
    match = (dist2 < pos_radius**2) & ref_m[:, :, None] & src_m[:, None, :]
    ref_overlap = match.any(dim=2).sum(dim=1).float() / torch.clamp(ref_m.sum(dim=1).float(), min=1.0)
    src_overlap = match.any(dim=1).sum(dim=1).float() / torch.clamp(src_m.sum(dim=1).float(), min=1.0)
    overlaps = torch.where(cand_valid, 0.5 * (ref_overlap + src_overlap), 0.0)

    overlap_map = torch.zeros((m * n,), dtype=ref_nodes.dtype, device=ref_nodes.device)
    overlap_map = overlap_map.scatter_reduce(0, cand, overlaps.to(ref_nodes.dtype), "amax")
    evaluated = torch.zeros((m * n,), dtype=torch.float32, device=ref_nodes.device)
    evaluated = evaluated.scatter_reduce(0, cand, cand_valid.float(), "amax") > 0.0
    ambiguous_map = (margin > 0.0) & ~evaluated.reshape(m, n)
    return overlap_map.reshape(m, n), ambiguous_map


class LGRResult(NamedTuple):
    ref_corr_points: torch.Tensor  # (C, 3) verification set
    src_corr_points: torch.Tensor  # (C, 3)
    corr_scores: torch.Tensor  # (C,) zeros in padded slots
    corr_masks: torch.Tensor  # (C,) bool
    estimated_transform: torch.Tensor  # (4, 4)


def compute_correspondence_matrix(score_mat, ref_knn_masks, src_knn_masks, k, mutual, confidence_threshold):
    """(P, K, K) bool: cells among the top-k of their row and (mutual) of
    their column, above the confidence threshold; score_mat is in
    probability space."""
    mask_mat = ref_knn_masks[:, :, None] & src_knn_masks[:, None, :]
    ref_thresh = torch.topk(score_mat, k, dim=2).values[:, :, k - 1 : k]
    ref_corr = score_mat >= ref_thresh
    src_thresh = torch.topk(score_mat.transpose(1, 2), k, dim=2).values[:, :, k - 1 : k].transpose(1, 2)
    src_corr = score_mat >= src_thresh
    conf = score_mat > confidence_threshold
    ref_corr = ref_corr & conf
    src_corr = src_corr & conf
    corr = (ref_corr & src_corr) if mutual else (ref_corr | src_corr)
    return corr & mask_mat


def local_to_global_registration(
    ref_knn_points: torch.Tensor,
    src_knn_points: torch.Tensor,
    ref_knn_masks: torch.Tensor,
    src_knn_masks: torch.Tensor,
    matching_scores: torch.Tensor,
    node_corr_scores: torch.Tensor,
    k: int,
    acceptance_radius: float,
    mutual: bool = True,
    confidence_threshold: float = 0.05,
    use_dustbin: bool = False,
    use_global_score: bool = False,
    correspondence_threshold: int = 3,
    correspondence_limit: int = 8192,
    num_refinement_steps: int = 5,
) -> LGRResult:
    """RANSAC-free registration from patch-local assignment scores.

    Args: patch points (P, K, 3) and masks (P, K) of both clouds;
    matching_scores (P, K+1, K+1) log assignment with dustbin (or (P, K, K));
    node_corr_scores (P,).
    """
    has_dustbin = matching_scores.shape[1] == ref_knn_points.shape[1] + 1
    if use_dustbin and has_dustbin:
        # select with the dustbin row and column present (a point whose best
        # matches include the dustbin is suppressed), then strip them
        # (local_global_registration.py:56-84)
        score_full = torch.exp(matching_scores)
        ones = torch.ones_like(ref_knn_masks[:, :1])
        corr_mat = compute_correspondence_matrix(score_full, torch.cat([ref_knn_masks, ones], dim=1),
                                                 torch.cat([src_knn_masks, ones], dim=1), k, mutual,
                                                 confidence_threshold)[:, :-1, :-1]
        score_mat = score_full[:, :-1, :-1]
    else:
        if has_dustbin:
            matching_scores = matching_scores[:, :-1, :-1]
        score_mat = torch.exp(matching_scores)
        corr_mat = compute_correspondence_matrix(score_mat, ref_knn_masks, src_knn_masks, k, mutual,
                                                 confidence_threshold)
    p, kk, _ = score_mat.shape

    if use_global_score:
        score_mat = score_mat * node_corr_scores[:, None, None]
    score_mat = torch.where(corr_mat, score_mat, 0.0)

    # verification set: global top-C dense correspondences by score
    flat_scores = score_mat.reshape(-1)
    c = min(correspondence_limit, flat_scores.shape[0])
    corr_scores, flat_idx = selection.max_k(flat_scores, c)
    corr_masks = corr_scores > 0.0
    corr_scores = torch.where(corr_masks, corr_scores, 0.0)
    b_idx = flat_idx // (kk * kk)
    r_idx = (flat_idx // kk) % kk
    s_idx = flat_idx % kk
    ref_corr_points = ref_knn_points[b_idx, r_idx]
    src_corr_points = src_knn_points[b_idx, s_idx]

    # local: per-patch weighted Procrustes over all K^2 cells
    ref_cells = ref_knn_points[:, :, None, :].expand(p, kk, kk, 3).reshape(p, kk * kk, 3)
    src_cells = src_knn_points[:, None, :, :].expand(p, kk, kk, 3).reshape(p, kk * kk, 3)
    cell_weights = score_mat.reshape(p, kk * kk)
    patch_valid = corr_mat.reshape(p, kk * kk).sum(dim=1) >= correspondence_threshold
    batch_transforms = weighted_procrustes(src_cells, ref_cells, cell_weights)  # (P, 4, 4)

    aligned = apply_transform(src_corr_points[None, :, :].expand(p, -1, -1), batch_transforms)  # (P, C, 3)
    residuals = torch.linalg.norm(ref_corr_points[None, :, :] - aligned, dim=-1)
    inlier = (residuals < acceptance_radius) & corr_masks[None, :]
    inlier_counts = torch.where(patch_valid, inlier.sum(dim=1), -1)
    best = torch.argmax(inlier_counts)

    # degenerate fallback: fit the whole verification set, keep its inliers
    fallback_transform = weighted_procrustes(src_corr_points, ref_corr_points, corr_scores)
    fb_aligned = apply_transform(src_corr_points, fallback_transform)
    fb_inlier = torch.linalg.norm(ref_corr_points - fb_aligned, dim=-1) < acceptance_radius
    # index_select, not inlier[best]: a 0-dim index tensor is read back to the host
    start_inlier = torch.where(patch_valid.any(), inlier.index_select(0, best.reshape(1))[0], fb_inlier)
    scores_i = corr_scores * start_inlier.to(corr_scores.dtype)

    # global refinement
    transform_i = fallback_transform
    for _ in range(num_refinement_steps):
        transform_i = weighted_procrustes(src_corr_points, ref_corr_points, scores_i)
        resid_i = torch.linalg.norm(ref_corr_points - apply_transform(src_corr_points, transform_i), dim=-1)
        scores_i = corr_scores * (resid_i < acceptance_radius).to(corr_scores.dtype)

    return LGRResult(ref_corr_points, src_corr_points, corr_scores, corr_masks, transform_i)
