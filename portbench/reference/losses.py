"""Losses: the weighted circle loss, the coarse and fine matching losses, the
overall loss, and the online evaluator.

Counterpart of `ref_geotransformer_tpu/models/losses.py`: boolean indexing
is replaced by masked means, and the coarse loss reads the dense
ground-truth overlap map directly.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.config import CoarseLossConfig, EvalConfig, FineLossConfig, LossWeights
from portbench.reference.metrics import isotropic_transform_error
from portbench.reference.pairwise import pairwise_distance
from portbench.reference.se3 import apply_transform

_BIG = 1e5


def _masked_mean(values: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    w = masks.to(values.dtype)
    return torch.sum(values * w) / torch.clamp(torch.sum(w), min=1.0)


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero (not infinite) gradient at x == 0.

    Padded coarse nodes carry identical features, so the distance between
    two padded slots is exactly 0, where sqrt' is infinite; the circle
    loss's zero weights would then give 0 * inf = NaN in the gradient, and
    every step would be skipped as non-finite. The double where keeps the
    value exactly sqrt(x) and zeroes the cotangent of those pairs.
    """
    positive = x > 0.0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)), 0.0)


def weighted_circle_loss(
    pos_masks: torch.Tensor,
    neg_masks: torch.Tensor,
    feat_dists: torch.Tensor,
    pos_margin: float,
    neg_margin: float,
    pos_optimal: float,
    neg_optimal: float,
    log_scale: float,
    pos_scales: Optional[torch.Tensor] = None,
    neg_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Margin-based metric-learning loss over a feature-distance matrix;
    rows and columns without a positive or without a negative are left out
    of the mean. The weights are constants (no gradient)."""
    row_masks = pos_masks.any(dim=-1) & neg_masks.any(dim=-1)
    col_masks = pos_masks.any(dim=-2) & neg_masks.any(dim=-2)

    pos_weights = torch.clamp(feat_dists - _BIG * (~pos_masks).to(feat_dists.dtype) - pos_optimal, min=0.0)
    if pos_scales is not None:
        pos_weights = pos_weights * pos_scales
    pos_weights = pos_weights.detach()
    neg_weights = torch.clamp(neg_optimal - (feat_dists + _BIG * (~neg_masks).to(feat_dists.dtype)), min=0.0)
    if neg_scales is not None:
        neg_weights = neg_weights * neg_scales
    neg_weights = neg_weights.detach()

    pos_logits = log_scale * (feat_dists - pos_margin) * pos_weights
    neg_logits = log_scale * (neg_margin - feat_dists) * neg_weights
    loss_row = F.softplus(torch.logsumexp(pos_logits, dim=-1) + torch.logsumexp(neg_logits, dim=-1)) / log_scale
    loss_col = F.softplus(torch.logsumexp(pos_logits, dim=-2) + torch.logsumexp(neg_logits, dim=-2)) / log_scale
    return 0.5 * (_masked_mean(loss_row, row_masks) + _masked_mean(loss_col, col_masks))


def coarse_matching_loss(output: Dict, cfg: CoarseLossConfig) -> torch.Tensor:
    """Overlap-weighted circle loss over the L2-normalized coarse features
    output["ref_feats_c"] (M, C) and ["src_feats_c"] (N, C), labelled by
    ["gt_node_overlap_map"] (M, N); ambiguous pairs are not negatives."""
    feat_dists = _safe_sqrt(pairwise_distance(output["ref_feats_c"], output["src_feats_c"], normalized=True))
    overlaps = output["gt_node_overlap_map"]
    valid = output["ref_node_masks"][:, None] & output["src_node_masks"][None, :]
    pos_masks = (overlaps > cfg.positive_overlap) & valid
    neg_masks = (overlaps == 0.0) & valid
    if "gt_node_ambiguous_map" in output:
        neg_masks = neg_masks & ~output["gt_node_ambiguous_map"]
    pos_scales = torch.sqrt(overlaps * pos_masks.to(overlaps.dtype))
    return weighted_circle_loss(
        pos_masks, neg_masks, feat_dists, cfg.positive_margin, cfg.negative_margin, cfg.positive_optimal,
        cfg.negative_optimal, cfg.log_scale, pos_scales=pos_scales,
    )


def fine_matching_loss(output: Dict, transform: torch.Tensor, cfg: FineLossConfig) -> torch.Tensor:
    """Negative log-likelihood of the ground-truth assignment, dustbin row
    and column included, over the patches output["node_corr_masks"] keeps."""
    ref_knn_points = output["ref_node_corr_knn_points"]  # (P, K, 3)
    src_knn_points = apply_transform(output["src_node_corr_knn_points"], transform)
    ref_knn_masks = output["ref_node_corr_knn_masks"]  # (P, K)
    src_knn_masks = output["src_node_corr_knn_masks"]
    matching_scores = output["matching_scores"]  # (P, K+1, K+1) log assignment

    dists = pairwise_distance(ref_knn_points, src_knn_points)  # (P, K, K)
    gt_corr_map = (dists < cfg.positive_radius**2) & ref_knn_masks[:, :, None] & src_knn_masks[:, None, :]
    slack_row = ~gt_corr_map.any(dim=2) & ref_knn_masks
    slack_col = ~gt_corr_map.any(dim=1) & src_knn_masks

    p, k = ref_knn_masks.shape
    labels = torch.zeros((p, k + 1, k + 1), dtype=torch.bool, device=matching_scores.device)
    labels[:, :k, :k] = gt_corr_map
    labels[:, :k, k] = slack_row
    labels[:, k, :k] = slack_col
    patch_masks = output.get("node_corr_masks")
    if patch_masks is not None:
        labels = labels & patch_masks[:, None, None]
    return -_masked_mean(matching_scores, labels)


def overall_loss(output: Dict, transform: torch.Tensor, coarse_cfg: CoarseLossConfig, fine_cfg: FineLossConfig,
                 weights: LossWeights) -> Dict[str, torch.Tensor]:
    """{"loss", "c_loss", "f_loss"}: the weighted sum and its two terms."""
    c_loss = coarse_matching_loss(output, coarse_cfg)
    f_loss = fine_matching_loss(output, transform, fine_cfg)
    loss = weights.weight_coarse_loss * c_loss + weights.weight_fine_loss * f_loss
    return {"loss": loss, "c_loss": c_loss, "f_loss": f_loss}


def evaluate(output: Dict, transform: torch.Tensor, cfg: EvalConfig) -> Dict[str, torch.Tensor]:
    """Online metrics: PIR, IR, RRE, RTE, RMSE and RR."""
    gt_map = output["gt_node_overlap_map"] > cfg.acceptance_overlap
    ref_idx = output["ref_node_corr_indices"].long()
    src_idx = output["src_node_corr_indices"].long()
    pir = gt_map[ref_idx, src_idx].float().mean()

    src_corr = apply_transform(output["src_corr_points"], transform)
    dist = torch.linalg.norm(output["ref_corr_points"] - src_corr, dim=-1)
    ir = _masked_mean((dist < cfg.acceptance_radius).float(), output["corr_masks"])

    est = output["estimated_transform"]
    rre, rte = isotropic_transform_error(transform, est)
    src_points = output["src_points"]
    realigned = apply_transform(src_points, torch.linalg.inv(transform) @ est)
    rmse = _masked_mean(torch.linalg.norm(realigned - src_points, dim=-1), output["src_point_masks"])
    if cfg.recall_criterion == "rre_rte":
        recall = ((rre < cfg.rre_threshold) & (rte < cfg.rte_threshold)).float()
    else:
        recall = (rmse < cfg.rmse_threshold).float()
    return {"PIR": pir, "IR": ir, "RRE": rre, "RTE": rte, "RMSE": rmse, "RR": recall}
