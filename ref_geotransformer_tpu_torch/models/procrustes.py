"""Weighted Procrustes (Kabsch) solver, batched, on the device.

Counterpart of `ref_geotransformer_tpu/models/procrustes.py`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ref_geotransformer_tpu_torch.ops.se3 import get_transform_from_rotation_translation
from ref_geotransformer_tpu_torch.ops.svd import svd


def weighted_procrustes(
    src_points: torch.Tensor,
    ref_points: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """(*, 4, 4) rigid transform aligning src (*, N, 3) to ref (*, N, 3);
    rows of zero weight (*, N) do not influence the solution. The 3 x 3 SVD
    is `ops/svd.py::svd`: `torch.linalg.svd`'s results, on the card with no
    read-back to the host."""
    if weights is None:
        weights = torch.ones(src_points.shape[:-1], dtype=src_points.dtype, device=src_points.device)
    weights = torch.clamp(weights, min=0.0)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + eps)
    w = weights[..., None]

    src_centroid = torch.sum(src_points * w, dim=-2, keepdim=True)
    ref_centroid = torch.sum(ref_points * w, dim=-2, keepdim=True)
    src_centered = src_points - src_centroid
    ref_centered = ref_points - ref_centroid

    h = torch.matmul(src_centered.transpose(-1, -2), w * ref_centered)  # (*, 3, 3)
    u, _, vt = svd(h)
    ut = u.transpose(-1, -2)
    v = vt.transpose(-1, -2)
    det = torch.linalg.det(torch.matmul(v, ut))
    diag = torch.ones(src_points.shape[:-2] + (3,), dtype=src_points.dtype, device=src_points.device)
    diag[..., 2] = torch.sign(det)
    rotation = torch.matmul(v * diag[..., None, :], ut)
    translation = ref_centroid[..., 0, :] - torch.matmul(rotation, src_centroid[..., 0, :, None])[..., 0]
    return get_transform_from_rotation_translation(rotation, translation)
