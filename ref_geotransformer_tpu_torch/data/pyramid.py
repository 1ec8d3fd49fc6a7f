"""On-device multi-resolution point pyramid.

Counterpart of `ref_geotransformer_tpu/data/pyramid.py`. Level 0 is the
input cloud; level i >= 1 is the grid subsample of level i-1 at voxel
v * 2^i. Per level i: same-level `neighbors` (radius r * 2^i), the
downsampling table `subsampling[i]` (queries level i+1, supports level i)
and the upsampling table `upsampling[i]` (queries level i, supports level
i+1, radius r * 2^(i+1)).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ref_geotransformer_tpu_torch.ops.neighbors import radius_search
from ref_geotransformer_tpu_torch.ops.subsample import grid_subsample


def pad_points(points: np.ndarray, capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad an (N, 3) numpy cloud to (capacity, 3) plus a bool mask (host-side)."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"cloud with {n} points exceeds capacity {capacity}")
    padded = np.zeros((capacity, 3), np.float32)
    padded[:n] = points
    masks = np.zeros(capacity, bool)
    masks[:n] = True
    return padded, masks


def build_pyramid(
    points: torch.Tensor,
    masks: torch.Tensor,
    num_stages: int,
    voxel_size: float,
    radius: float,
    neighbor_limits: Sequence[int],
    capacities: Sequence[int],
    search_chunk: int = 2048,
) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Pyramid and neighbor tables of ONE padded cloud.

    Returns a dict of tuples: points[i] (C_i, 3), masks[i] (C_i,),
    neighbors[i] (C_i, nl_i), subsampling[i] (C_{i+1}, nl_i),
    upsampling[i] (C_i, nl_{i+1}); tables are int32 with sentinel
    len(support).
    """
    if len(neighbor_limits) != num_stages or len(capacities) != num_stages:
        raise ValueError("need one neighbor limit and one capacity per stage")

    points_list = [points]
    masks_list = [masks]
    v = voxel_size
    for i in range(1, num_stages):
        v *= 2.0
        sub_points, sub_masks = grid_subsample(points_list[-1], masks_list[-1], v, capacities[i])
        points_list.append(sub_points)
        masks_list.append(sub_masks)

    neighbors_list, subsampling_list, upsampling_list = [], [], []
    r = radius
    for i in range(num_stages):
        pts, msk = points_list[i], masks_list[i]
        neighbors_list.append(radius_search(pts, pts, msk, msk, r, neighbor_limits[i], search_chunk))
        if i < num_stages - 1:
            nxt, nxt_m = points_list[i + 1], masks_list[i + 1]
            subsampling_list.append(radius_search(nxt, pts, nxt_m, msk, r, neighbor_limits[i], search_chunk))
            upsampling_list.append(
                radius_search(pts, nxt, msk, nxt_m, r * 2.0, neighbor_limits[i + 1], search_chunk)
            )
        r *= 2.0

    return {
        "points": tuple(points_list),
        "masks": tuple(masks_list),
        "neighbors": tuple(neighbors_list),
        "subsampling": tuple(subsampling_list),
        "upsampling": tuple(upsampling_list),
    }


def build_registration_inputs(
    ref_points: torch.Tensor,
    ref_masks: torch.Tensor,
    src_points: torch.Tensor,
    src_masks: torch.Tensor,
    num_stages: int,
    voxel_size: float,
    radius: float,
    neighbor_limits: Sequence[int],
    capacities: Sequence[int],
    ref_feats: Optional[torch.Tensor] = None,
    src_feats: Optional[torch.Tensor] = None,
    transform: Optional[torch.Tensor] = None,
    search_chunk: int = 2048,
) -> Dict:
    """Model input dict for one (ref, src) pair; default features are
    all-ones (N, 1). A ground-truth `transform` (4, 4), mapping src onto
    ref, goes into the dict as "transform" (the model's training labels)."""
    args = (num_stages, voxel_size, radius, neighbor_limits, capacities, search_chunk)
    ref = build_pyramid(ref_points, ref_masks, *args)
    src = build_pyramid(src_points, src_masks, *args)
    if ref_feats is None:
        ref_feats = torch.ones((ref_points.shape[0], 1), dtype=torch.float32, device=ref_points.device)
    if src_feats is None:
        src_feats = torch.ones((src_points.shape[0], 1), dtype=torch.float32, device=src_points.device)
    data = {"ref": ref, "src": src, "ref_feats": ref_feats, "src_feats": src_feats}
    if transform is not None:
        data["transform"] = transform
    return data
