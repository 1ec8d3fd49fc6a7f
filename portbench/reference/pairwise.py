"""Pairwise squared-distance matrices (inner-product form).

Counterpart of `ref_geotransformer_tpu/ops/pairwise.py`.
"""

from __future__ import annotations

from typing import Optional

import torch


def pairwise_distance(x: torch.Tensor, y: torch.Tensor, normalized: bool = False) -> torch.Tensor:
    """(*, N, C) x (*, M, C) -> (*, N, M) squared distances via the
    ||x||^2 - 2 x.y + ||y||^2 expansion, clamped to >= 0. With `normalized`
    (L2-normalized inputs) the cheaper 2 - 2 x.y form."""
    xy = torch.matmul(x, y.transpose(-1, -2))
    if normalized:
        sq = 2.0 - 2.0 * xy
    else:
        xx = torch.sum(x * x, dim=-1)
        yy = torch.sum(y * y, dim=-1)
        sq = xx[..., :, None] - 2.0 * xy + yy[..., None, :]
    return torch.clamp(sq, min=0.0)


def masked_pairwise_distance(x: torch.Tensor, y: torch.Tensor, x_masks: Optional[torch.Tensor] = None,
                             y_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pairwise_distance with invalid rows/cols set to 1e12 (masks are
    validity masks: True = real point; None = all valid), so top-k and
    argmin never pick them."""
    sq = pairwise_distance(x, y)
    if x_masks is not None:
        sq = torch.where(x_masks[..., :, None], sq, 1e12)
    if y_masks is not None:
        sq = torch.where(y_masks[..., None, :], sq, 1e12)
    return sq
