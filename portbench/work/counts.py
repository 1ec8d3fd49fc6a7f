"""The valid counts of one pair, taken from the reference's own pyramid and
partition (never from the program's): valid points per level, valid
(query, neighbor) entries of each table, the radius searches' pairs within
their radius, valid coarse nodes and each node's valid patch size."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from portbench.work import radius


@dataclass
class CloudCounts:
    points: List[int]  # valid points per level
    neighbors: List[int]  # valid entries of neighbors[l] over valid queries
    subsampling: List[int]  # valid entries of subsampling[l] (queries at level l + 1)
    patch_sizes: torch.Tensor  # (nodes,) valid patch entries per coarse node (0 for an invalid node)


@dataclass
class PairCounts:
    clouds: Tuple[CloudCounts, CloudCounts]  # ref, src
    searches: List[Tuple[int, int, int, int]]  # (valid queries, valid supports, pairs within radius, limit)


def _entries(table: torch.Tensor, n_support: int, q_masks: torch.Tensor) -> int:
    return int(((table < n_support) & q_masks[:, None]).sum())


def cloud_counts(pyramid: dict, fine_level: int, patch: int) -> CloudCounts:
    from portbench.reference.partition import point_to_node_partition

    pts, msk = pyramid["points"], pyramid["masks"]
    neighbors = [_entries(t, pts[i].shape[0], msk[i]) for i, t in enumerate(pyramid["neighbors"])]
    subsampling = [_entries(t, pts[i].shape[0], msk[i + 1]) for i, t in enumerate(pyramid["subsampling"])]
    _, node_masks, _, knn_masks = point_to_node_partition(pts[fine_level], pts[-1], patch, msk[fine_level], msk[-1])
    sizes = torch.where(node_masks, knn_masks.sum(dim=1), 0)
    return CloudCounts([int(m.sum()) for m in msk], neighbors, subsampling, sizes.cpu())


def searches(pyramid: dict, radius0: float, limits) -> List[Tuple[int, int, int, int]]:
    """The 3 S - 2 searches of one cloud's pyramid, in the order the pyramid
    makes them: neighbors[i], then subsampling[i] and upsampling[i]."""
    pts, msk = pyramid["points"], pyramid["masks"]
    out, r = [], radius0
    for i in range(len(pts)):
        jobs = [(i, i, r, limits[i])]
        if i < len(pts) - 1:
            jobs += [(i + 1, i, r, limits[i]), (i, i + 1, 2.0 * r, limits[i + 1])]
        for q, s, rad, limit in jobs:
            within = radius.pairs_within(pts[q], pts[s], msk[q], msk[s], rad)
            out.append((int(msk[q].sum()), int(msk[s].sum()), within, limit))
        r *= 2.0
    return out


def pair_counts(ref_pyramid: dict, src_pyramid: dict, cfg) -> PairCounts:
    bb = cfg.backbone
    limits = cfg.capacities.neighbor_limits
    k = cfg.model.num_points_in_patch
    clouds = tuple(cloud_counts(p, bb.fine_level, k) for p in (ref_pyramid, src_pyramid))
    found = searches(ref_pyramid, bb.init_radius, limits) + searches(src_pyramid, bb.init_radius, limits)
    return PairCounts(clouds, found)


def patch_blocks(counts: PairCounts, ref_nodes, src_nodes, valid=None) -> List[Tuple[int, int]]:
    """(valid rows, valid columns) of each matched patch pair: the reference
    partition's patch sizes at the program's node pairs (and only where
    `valid`, the training targets' validity)."""
    ref_sizes, src_sizes = counts.clouds[0].patch_sizes, counts.clouds[1].patch_sizes
    ref_nodes, src_nodes = ref_nodes.long().cpu(), src_nodes.long().cpu()
    keep = torch.ones(ref_nodes.shape[0], dtype=torch.bool) if valid is None else valid.cpu().bool()
    return [(int(ref_sizes[i]), int(src_sizes[j])) for i, j, v in zip(ref_nodes, src_nodes, keep) if v]
