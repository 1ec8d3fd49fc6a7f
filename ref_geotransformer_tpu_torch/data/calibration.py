"""Calibration of the static-shape contract (capacities, neighbor limits).

Counterpart of `ref_geotransformer_tpu/data/calibration.py`:

  * calibrate_capacities: the largest per-level occupied-voxel count over
    both clouds of sampled pairs (plus headroom), which sizes
    `CapacityConfig.points`;
  * calibrate_neighbor_limits: per level, the neighbor limit covering
    `keep_ratio` of the valid-neighbor-count histogram (the statistic of the
    reference's calibration, utils/data.py:196-221).

Both run the pyramid's own operations (`grid_subsample`, the exact top-k of
the radius search) on the device the caller names, so the numbers are the
ones the runtime sees.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ref_geotransformer_tpu_torch.data.pyramid import pad_points
from ref_geotransformer_tpu_torch.ops.neighbors import topk_neighbor_distances
from ref_geotransformer_tpu_torch.ops.subsample import count_voxels, grid_subsample


def _round_up(x: int, m: int = 256) -> int:
    return ((x + m - 1) // m) * m


def _padded(points: np.ndarray, capacity: int, device: torch.device):
    padded, masks = pad_points(points, capacity)
    return torch.from_numpy(padded).to(device), torch.from_numpy(masks).to(device)


def calibrate_capacities(
    dataset,
    num_stages: int,
    voxel_size: float,
    num_samples: int = 50,
    headroom: float = 1.1,
    align: int = 256,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, ...]:
    """Largest observed per-level point counts over both clouds of the first
    `num_samples` pairs, times `headroom`, rounded up to `align`."""
    device = torch.device(device)
    max_counts = [0] * num_stages
    for i in range(min(num_samples, len(dataset))):
        item = dataset[i]
        for side in ("ref_points", "src_points"):
            pts = np.asarray(item[side], np.float32)
            max_counts[0] = max(max_counts[0], pts.shape[0])
            cur_p, cur_m = _padded(pts, _round_up(pts.shape[0]), device)
            v = voxel_size
            for lvl in range(1, num_stages):
                v *= 2.0
                count = count_voxels(cur_p, cur_m, v)
                max_counts[lvl] = max(max_counts[lvl], count)
                cur_p, cur_m = grid_subsample(cur_p, cur_m, v, _round_up(count + 8, 64))
    return tuple(_round_up(int(c * headroom), align) for c in max_counts)


def calibrate_neighbor_limits(
    dataset,
    num_stages: int,
    voxel_size: float,
    search_radius: float,
    capacities: Sequence[int],
    keep_ratio: float = 0.8,
    num_samples: int = 20,
    max_limit: int = 128,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, ...]:
    """Per-level neighbor limit covering `keep_ratio` of the histogram of
    valid neighbors within the level's radius (counted up to `max_limit`),
    over both clouds of the first `num_samples` pairs, each cut to
    `capacities[0]` points and subsampled at `capacities`."""
    device = torch.device(device)
    hists = np.zeros((num_stages, max_limit + 1), np.int64)
    for i in range(min(num_samples, len(dataset))):
        item = dataset[i]
        for side in ("ref_points", "src_points"):
            pts = np.asarray(item[side], np.float32)[: capacities[0]]
            cur_p, cur_m = _padded(pts, capacities[0], device)
            v, r = voxel_size, search_radius
            for lvl in range(num_stages):
                if lvl > 0:
                    v *= 2.0
                    cur_p, cur_m = grid_subsample(cur_p, cur_m, v, capacities[lvl])
                counts = (topk_neighbor_distances(cur_p, cur_p, cur_m, max_limit) < r * r).sum(dim=1)
                counts = counts[cur_m].cpu().numpy()
                hists[lvl] += np.bincount(np.minimum(counts, max_limit), minlength=max_limit + 1)
                r *= 2.0

    limits = []
    for lvl in range(num_stages):
        cum = np.cumsum(hists[lvl])
        limit = int(np.searchsorted(cum, keep_ratio * cum[-1]) + 1)
        limits.append(min(limit, max_limit))
    return tuple(limits)
