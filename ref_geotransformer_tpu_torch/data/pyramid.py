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

from ref_geotransformer_tpu_torch.ops.neighbors import radius_search_group
from ref_geotransformer_tpu_torch.ops.subsample import grid_subsample
from ref_geotransformer_tpu_torch.utils.timer import span


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


def _levels(points, masks, num_stages, voxel_size, capacities):
    """Level 0 and its grid subsamples, each at twice the last voxel (the
    span `gt.pyramid.subsample`)."""
    points_list, masks_list = [points], [masks]
    v = voxel_size
    with span("gt.pyramid.subsample"):
        for i in range(1, num_stages):
            v *= 2.0
            sub_points, sub_masks = grid_subsample(points_list[-1], masks_list[-1], v, capacities[i])
            points_list.append(sub_points)
            masks_list.append(sub_masks)
    return points_list, masks_list


def _searches(points_list, masks_list, radius, neighbor_limits):
    """The 3 S - 2 searches of one cloud's pyramid, level by level:
    neighbors[i], then subsampling[i] and upsampling[i] below the last."""
    searches = []
    r = radius
    for i, (pts, msk) in enumerate(zip(points_list, masks_list)):
        searches.append((pts, pts, msk, msk, r, neighbor_limits[i]))
        if i < len(points_list) - 1:
            nxt, nxt_m = points_list[i + 1], masks_list[i + 1]
            searches.append((nxt, pts, nxt_m, msk, r, neighbor_limits[i]))
            searches.append((pts, nxt, msk, nxt_m, r * 2.0, neighbor_limits[i + 1]))
        r *= 2.0
    return searches


def _pyramid(points_list, masks_list, tables):
    return {
        "points": tuple(points_list),
        "masks": tuple(masks_list),
        "neighbors": tuple(tables[0::3]),
        "subsampling": tuple(tables[1::3]),
        "upsampling": tuple(tables[2::3]),
    }


def _check_stages(num_stages, neighbor_limits, capacities):
    if len(neighbor_limits) != num_stages or len(capacities) != num_stages:
        raise ValueError("need one neighbor limit and one capacity per stage")


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
    """Pyramid and neighbor tables of ONE padded cloud: its levels first,
    then its 3 S - 2 searches as one group (`radius_search_group`: one
    search launch on a CUDA device).

    Returns a dict of tuples: points[i] (C_i, 3), masks[i] (C_i,),
    neighbors[i] (C_i, nl_i), subsampling[i] (C_{i+1}, nl_i),
    upsampling[i] (C_i, nl_{i+1}); tables are int32 with sentinel
    len(support). In the span `gt.pyramid`.
    """
    _check_stages(num_stages, neighbor_limits, capacities)
    with span("gt.pyramid"):
        points_list, masks_list = _levels(points, masks, num_stages, voxel_size, capacities)
        tables = radius_search_group(_searches(points_list, masks_list, radius, neighbor_limits), search_chunk)
        return _pyramid(points_list, masks_list, tables)


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
    ref, goes into the dict as "transform" (the model's training labels).
    Both clouds are subsampled first, then the two pyramids' searches run
    as one group (one search launch on a CUDA device). In the span
    `gt.pyramid`."""
    _check_stages(num_stages, neighbor_limits, capacities)
    with span("gt.pyramid"):
        ref_levels = _levels(ref_points, ref_masks, num_stages, voxel_size, capacities)
        src_levels = _levels(src_points, src_masks, num_stages, voxel_size, capacities)
        ref_searches = _searches(*ref_levels, radius, neighbor_limits)
        tables = radius_search_group(ref_searches + _searches(*src_levels, radius, neighbor_limits), search_chunk)
        ref = _pyramid(*ref_levels, tables[: len(ref_searches)])
        src = _pyramid(*src_levels, tables[len(ref_searches):])
        if ref_feats is None:
            ref_feats = torch.ones((ref_points.shape[0], 1), dtype=torch.float32, device=ref_points.device)
        if src_feats is None:
            src_feats = torch.ones((src_points.shape[0], 1), dtype=torch.float32, device=src_points.device)
    data = {"ref": ref, "src": src, "ref_feats": ref_feats, "src_feats": src_feats}
    if transform is not None:
        data["transform"] = transform
    return data
