"""Voxel-grid subsampling with a static output capacity.

Counterpart of `ref_geotransformer_tpu/ops/subsample.py`: points are hashed
to voxels of side `voxel_size` anchored at floor(min / voxel) * voxel, and
each occupied voxel emits the centroid of its points. One fused int32 key
(ix + nx * (iy + ny * iz)), one stable sort, one segment mean; voxels come
out in linearized-key order, like the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

_SENTINEL_KEY = 2**31 - 1


def _voxel_keys(points: torch.Tensor, masks: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Linearized int32 voxel id per point; invalid points sort last."""
    valid_points = torch.where(masks[:, None], points, float("inf"))
    min_corner = valid_points.min(dim=0).values
    # divide by a tensor on the points' device: CUDA turns division by a host
    # scalar into a product with its reciprocal, whose rounding moves points
    # that lie on a voxel face into the next voxel (the JAX package and the
    # host C++ kernel divide)
    voxel = torch.full((), voxel_size, dtype=points.dtype, device=points.device)
    origin = torch.floor(min_corner / voxel) * voxel_size
    coords = torch.floor((points - origin) / voxel).to(torch.int32)
    coords = torch.where(masks[:, None], coords, 0)
    max_c = coords.max(dim=0).values
    nx, ny = max_c[0] + 1, max_c[1] + 1
    keys = coords[:, 0] + nx * (coords[:, 1] + ny * coords[:, 2])
    return torch.where(masks, keys, _SENTINEL_KEY)


def grid_subsample(
    points: torch.Tensor,
    masks: torch.Tensor,
    voxel_size: float,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel-grid subsample one padded cloud.

    Args:
        points: (N, 3) float32, padded.
        masks: (N,) bool validity.
        voxel_size: voxel edge length.
        capacity: static output size; voxels beyond it are dropped.

    Returns:
        s_points (capacity, 3) centroids (zeros in empty slots) and
        s_masks (capacity,) bool.
    """
    keys = _voxel_keys(points, masks, voxel_size)
    order = torch.argsort(keys, stable=True)
    keys_sorted = keys[order]
    points_sorted = points[order]
    masks_sorted = masks[order]

    is_new = torch.ones_like(masks_sorted)
    is_new[1:] = keys_sorted[1:] != keys_sorted[:-1]
    is_new = is_new & masks_sorted
    seg_ids = torch.cumsum(is_new.to(torch.int32), dim=0) - 1
    # invalid points and voxels beyond capacity go to the overflow bin
    seg_ids = torch.where(masks_sorted, torch.clamp(seg_ids, max=capacity), capacity).long()

    weights = masks_sorted.to(points.dtype)
    sums = torch.zeros((capacity + 1, 3), dtype=points.dtype, device=points.device)
    sums.index_add_(0, seg_ids, points_sorted * weights[:, None])
    counts = torch.zeros((capacity + 1,), dtype=points.dtype, device=points.device)
    counts.index_add_(0, seg_ids, weights)
    sums, counts = sums[:capacity], counts[:capacity]

    s_masks = counts > 0
    s_points = torch.where(s_masks[:, None], sums / torch.clamp(counts, min=1.0)[:, None], 0.0)
    return s_points, s_masks


def count_voxels(points: torch.Tensor, masks: torch.Tensor, voxel_size: float) -> int:
    """Number of occupied voxels of one padded cloud: the size
    `grid_subsample` needs to drop none (capacity calibration)."""
    keys_sorted = torch.sort(_voxel_keys(points, masks, voxel_size)).values
    is_new = torch.ones_like(masks)
    is_new[1:] = keys_sorted[1:] != keys_sorted[:-1]
    return int((is_new & (keys_sorted != _SENTINEL_KEY)).sum())
