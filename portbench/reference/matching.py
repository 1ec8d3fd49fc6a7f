"""Superpoint (coarse) matching: proposals and training targets.

Counterpart of `ref_geotransformer_tpu/models/matching.py`: invalid
rows/cols are zeroed out of the dual-normalization sums and of the global
top-k instead of being removed, which keeps shapes static.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from portbench.reference.pairwise import pairwise_distance


def superpoint_matching(
    ref_feats: torch.Tensor,
    src_feats: torch.Tensor,
    ref_masks: torch.Tensor,
    src_masks: torch.Tensor,
    num_correspondences: int,
    dual_normalization: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k node correspondences by (dual-normalized) Gaussian feature
    similarity of L2-normalized features ref (M, C), src (N, C).

    Returns ref_corr_indices, src_corr_indices (k,) int32 and corr_scores (k,).
    """
    valid = ref_masks[:, None] & src_masks[None, :]
    scores = torch.exp(-pairwise_distance(ref_feats, src_feats, normalized=True))
    scores = torch.where(valid, scores, 0.0)
    if dual_normalization:
        ref_norm = scores / torch.clamp(scores.sum(dim=1, keepdim=True), min=1e-12)
        src_norm = scores / torch.clamp(scores.sum(dim=0, keepdim=True), min=1e-12)
        scores = torch.where(valid, ref_norm * src_norm, 0.0)
    n = scores.shape[1]
    corr_scores, corr_indices = torch.topk(scores.reshape(-1), num_correspondences)
    return (corr_indices // n).to(torch.int32), (corr_indices % n).to(torch.int32), corr_scores


def superpoint_target_sample(
    gt_overlap_map: torch.Tensor,
    num_targets: int,
    overlap_threshold: float,
    generator: Optional[torch.Generator] = None,
    keys: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to `num_targets` ground-truth node pairs with overlap above the
    threshold, drawn without replacement from the dense (M, N) overlap map:
    the top-k of uniform keys over the eligible pairs.

    The keys come from `generator`, or are given as `keys` (M * N,) in
    [0, 1), e.g. the keys of another run. Slots beyond the eligible count
    are invalid (their keys tie at -1, so their indices are arbitrary).

    Returns ref_indices, src_indices (num_targets,) int32, overlaps
    (num_targets,) (0 in invalid slots) and valid (num_targets,) bool.
    """
    m, n = gt_overlap_map.shape
    if keys is None:
        device = generator.device if generator is not None else gt_overlap_map.device
        keys = torch.rand((m * n,), generator=generator, device=device)
    keys = torch.where((gt_overlap_map > overlap_threshold).reshape(-1), keys.to(gt_overlap_map.device), -1.0)
    top_keys, indices = torch.topk(keys, num_targets)
    valid = top_keys >= 0.0
    overlaps = torch.where(valid, gt_overlap_map.reshape(-1)[indices], 0.0)
    return (indices // n).to(torch.int32), (indices % n).to(torch.int32), overlaps, valid
