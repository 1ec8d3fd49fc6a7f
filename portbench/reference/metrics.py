"""Registration metrics, mask-aware. Counterpart of
`ref_geotransformer_tpu/ops/metrics.py` (ref parity:
modules/registration/metrics.py:8-162, utils/registration.py:17-155)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from portbench.reference.pairwise import masked_pairwise_distance
from portbench.reference.se3 import apply_transform, get_rotation_translation_from_transform


def _masked_mean(values: torch.Tensor, masks: Optional[torch.Tensor]) -> torch.Tensor:
    if masks is None:
        return torch.mean(values)
    w = masks.to(values.dtype)
    return torch.sum(values * w) / torch.clamp(torch.sum(w), min=1.0)


def relative_rotation_error(gt_rotation: torch.Tensor, est_rotation: torch.Tensor) -> torch.Tensor:
    """RRE in degrees: arccos((trace(R_gt^T R) - 1) / 2) (metrics.py:47-65)."""
    mat = torch.matmul(gt_rotation.transpose(-1, -2), est_rotation)
    trace = mat[..., 0, 0] + mat[..., 1, 1] + mat[..., 2, 2]
    return torch.rad2deg(torch.arccos(torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)))


def relative_translation_error(gt_translation: torch.Tensor, est_translation: torch.Tensor) -> torch.Tensor:
    """RTE: the distance between the translations (metrics.py:68-81)."""
    return torch.linalg.norm(gt_translation - est_translation, dim=-1)


def isotropic_transform_error(gt_transform: torch.Tensor, transform: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(RRE in degrees, RTE) between (*, 4, 4) transforms (metrics.py:84-111)."""
    gt_rotation, gt_translation = get_rotation_translation_from_transform(gt_transform)
    rotation, translation = get_rotation_translation_from_transform(transform)
    return relative_rotation_error(gt_rotation, rotation), relative_translation_error(gt_translation, translation)


def _euler_xyz_degrees(rot: torch.Tensor) -> torch.Tensor:
    """xyz Euler angles (scipy's extrinsic 'xyz', R = Rz Ry Rx), in degrees."""
    y = torch.arcsin(torch.clamp(-rot[..., 2, 0], -1.0, 1.0))
    x = torch.atan2(rot[..., 2, 1], rot[..., 2, 2])
    z = torch.atan2(rot[..., 1, 0], rot[..., 0, 0])
    return torch.rad2deg(torch.stack([x, y, z], dim=-1))


def anisotropic_transform_error(gt_transform: torch.Tensor, transform: torch.Tensor):
    """Per-axis errors (metrics.py:114-162): (r_mse, r_mae) of the xyz Euler
    angles in degrees and (t_mse, t_mae) of the translations."""
    gt_rotation, gt_translation = get_rotation_translation_from_transform(gt_transform)
    rotation, translation = get_rotation_translation_from_transform(transform)
    r_err = _euler_xyz_degrees(gt_rotation) - _euler_xyz_degrees(rotation)
    t_err = gt_translation - translation
    return (torch.mean(r_err**2, dim=-1), torch.mean(torch.abs(r_err), dim=-1), torch.mean(t_err**2, dim=-1),
            torch.mean(torch.abs(t_err), dim=-1))


def modified_chamfer_distance(raw_points, ref_points, src_points, gt_transform, transform, raw_masks=None,
                              ref_masks=None, src_masks=None) -> torch.Tensor:
    """Modified chamfer distance (metrics.py:8-44): both directions measured
    against the raw (complete) cloud."""
    aligned_src = apply_transform(src_points, transform)
    sq_p = masked_pairwise_distance(aligned_src, raw_points, src_masks, raw_masks)
    chamfer_p = _masked_mean(torch.amin(sq_p, dim=-1), src_masks)
    aligned_raw = apply_transform(raw_points, transform @ torch.linalg.inv(gt_transform))
    sq_q = masked_pairwise_distance(ref_points, aligned_raw, ref_masks, raw_masks)
    chamfer_q = _masked_mean(torch.amin(sq_q, dim=-1), ref_masks)
    return chamfer_p + chamfer_q


def inlier_ratio(ref_corr_points, src_corr_points, transform, positive_radius: float = 0.1,
                 corr_masks=None) -> torch.Tensor:
    """Share of the correspondences within positive_radius after alignment
    (utils/registration.py:141-146)."""
    residuals = torch.linalg.norm(ref_corr_points - apply_transform(src_corr_points, transform), dim=-1)
    return _masked_mean((residuals < positive_radius).float(), corr_masks)


def overlap_ratio(ref_points, src_points, transform, positive_radius: float = 0.1, ref_masks=None,
                  src_masks=None) -> torch.Tensor:
    """Share of the ref points with an aligned src point within radius
    (utils/registration.py:149-155)."""
    aligned = apply_transform(src_points, transform)
    sq = masked_pairwise_distance(ref_points, aligned, ref_masks, src_masks)
    return _masked_mean((torch.amin(sq, dim=-1) < positive_radius**2).float(), ref_masks)


def registration_rmse(src_points, gt_transform, transform, src_masks=None) -> torch.Tensor:
    """Mean realignment residual of the src points, the registration-recall
    statistic (experiment loss.py:147-159)."""
    realigned = apply_transform(src_points, torch.linalg.inv(gt_transform) @ transform)
    return _masked_mean(torch.linalg.norm(realigned - src_points, dim=-1), src_masks)
