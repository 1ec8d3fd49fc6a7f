"""Point-to-node patch partitions with static shapes.

Counterpart of `ref_geotransformer_tpu/ops/partition.py` (ref parity:
modules/ops/pointcloud_partition.py:9-175). `point_to_node_partition`: each
point belongs to its nearest node, and each node's patch is the
`point_limit` nearest points it owns; `knn_partition` takes each node's k
nearest points, owned or not, and `ball_query_partition` those of them
within a radius. Empty slots hold sentinel N.
"""

from __future__ import annotations

import torch

from portbench.reference import selection
from portbench.reference.pairwise import masked_pairwise_distance

_FILL = 1e12


def get_point_to_node_indices(points: torch.Tensor, nodes: torch.Tensor, point_masks: torch.Tensor,
                              node_masks: torch.Tensor, return_counts: bool = False):
    """Nearest-node index (N,) int32 of every point, M for invalid points
    (pointcloud_partition.py:9-31); with `return_counts` also the (M,)
    number of points of each node."""
    m = nodes.shape[0]
    sq = masked_pairwise_distance(points, nodes, point_masks, node_masks)  # (N, M)
    indices = torch.where(point_masks, torch.argmin(sq, dim=1).to(torch.int32), m)
    if return_counts:
        return indices, torch.bincount(indices.long(), minlength=m + 1)[:m].to(torch.int32)
    return indices


def point_to_node_partition(
    points: torch.Tensor,
    nodes: torch.Tensor,
    point_limit: int,
    point_masks: torch.Tensor,
    node_masks: torch.Tensor,
    return_count: bool = False,
):
    """Args: points (N, 3), nodes (M, 3), point_limit K, validity masks.

    Returns:
        point_to_node (N,) int32 owning node (M for invalid points),
        [node_sizes (M,) int32 points owned, with `return_count`,]
        occupied_node_masks (M,) bool, node_knn_indices (M, K) int32 with
        sentinel N, node_knn_masks (M, K) bool.
    """
    n = points.shape[0]
    m = nodes.shape[0]
    sq = masked_pairwise_distance(nodes, points, node_masks, point_masks)  # (M, N)

    point_to_node = torch.argmin(sq, dim=0).to(torch.int32)
    point_to_node = torch.where(point_masks, point_to_node, m)

    ownership = point_to_node[None, :] == torch.arange(m, dtype=torch.int32, device=points.device)[:, None]
    occupied_node_masks = ownership.any(dim=1)

    owned_sq = torch.where(ownership, sq, _FILL)
    top_sq, node_knn_indices = selection.min_k(owned_sq, point_limit)
    node_knn_masks = top_sq < _FILL
    node_knn_indices = torch.where(node_knn_masks, node_knn_indices.to(torch.int32), n)
    if return_count:
        node_sizes = ownership.sum(dim=1, dtype=torch.int32)
        return point_to_node, node_sizes, occupied_node_masks, node_knn_indices, node_knn_masks
    return point_to_node, occupied_node_masks, node_knn_indices, node_knn_masks


def knn_partition(points: torch.Tensor, nodes: torch.Tensor, k: int, point_masks: torch.Tensor,
                  node_masks: torch.Tensor, return_distance: bool = False):
    """The k nearest valid points of each node (pointcloud_partition.py:34-57):
    (M, k) int32 indices with sentinel N and (M, k) masks; with
    `return_distance` first the (M, k) distances (0 in empty slots)."""
    n = points.shape[0]
    sq = masked_pairwise_distance(nodes, points, node_masks, point_masks)  # (M, N)
    knn_sq, knn_indices = selection.min_k(sq, k)
    knn_masks = knn_sq < _FILL
    knn_indices = torch.where(knn_masks, knn_indices.to(torch.int32), n)
    if return_distance:
        return torch.sqrt(torch.where(knn_masks, knn_sq, 0.0)), knn_indices, knn_masks
    return knn_indices, knn_masks


def ball_query_partition(points: torch.Tensor, nodes: torch.Tensor, radius: float, point_limit: int,
                         point_masks: torch.Tensor, node_masks: torch.Tensor, return_count: bool = False):
    """The `point_limit` nearest points of each node within `radius`
    (pointcloud_partition.py:158-175): (M, K) int32 indices with sentinel N
    and (M, K) masks; with `return_count` also the (M,) counts."""
    n = points.shape[0]
    knn_distances, knn_indices, knn_masks = knn_partition(points, nodes, point_limit, point_masks, node_masks,
                                                          return_distance=True)
    in_ball = knn_masks & (knn_distances < radius)
    knn_indices = torch.where(in_ball, knn_indices, n)
    if return_count:
        return knn_indices, in_ball, in_ball.sum(dim=1, dtype=torch.int32)
    return knn_indices, in_ball
