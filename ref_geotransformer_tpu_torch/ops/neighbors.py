"""Fixed-width radius neighbor search.

Counterpart of the chunked brute method of
`ref_geotransformer_tpu/ops/neighbors.py` (`radius_search`, default
method): masked squared distances for a chunk of queries, then the `limit`
nearest supports by an exact top-k, kept if inside `radius`. Rows come out
distance-sorted (nearest first), with sentinel index N in empty slots.
`topk_neighbor_distances` is the counterpart of `_chunked_topk_neighbors`:
the squared distances themselves, which neighbor-limit calibration counts
against r^2.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from ref_geotransformer_tpu_torch.ops import selection
from ref_geotransformer_tpu_torch.ops.pairwise import pairwise_distance

_FILL = 1e12


def _chunked_min_k(
    q_points: torch.Tensor, s_points: torch.Tensor, s_masks: torch.Tensor, k: int, chunk: int
) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
    """(start, sq_dists, indices) per chunk of queries: the k nearest
    supports of each, ascending, invalid supports pushed to _FILL."""
    s_invalid = ~s_masks
    for start in range(0, q_points.shape[0], chunk):
        sq = pairwise_distance(q_points[start : start + chunk], s_points)
        sq = torch.where(s_invalid[None, :], _FILL, sq)
        d, idx = selection.min_k(sq, k)
        yield start, d, idx


def topk_neighbor_distances(
    q_points: torch.Tensor, s_points: torch.Tensor, s_masks: torch.Tensor, k: int, chunk: int = 1024
) -> torch.Tensor:
    """(M, k) squared distances from each query to its k nearest valid
    supports, ascending; 1e12 where fewer than k supports are valid."""
    return torch.cat([d for _, d, _ in _chunked_min_k(q_points, s_points, s_masks, k, chunk)], dim=0)


def radius_search(
    q_points: torch.Tensor,
    s_points: torch.Tensor,
    q_masks: torch.Tensor,
    s_masks: torch.Tensor,
    radius: float,
    limit: int,
    chunk: int = 2048,
) -> torch.Tensor:
    """(M, limit) int32 neighbor indices into s_points, distance-sorted,
    sentinel == N for empty slots and for every slot of an invalid query.

    Args:
        q_points: (M, 3) padded queries; q_masks (M,) validity.
        s_points: (N, 3) padded supports; s_masks (N,) validity.
        radius: search radius.
        limit: static number of neighbor slots.
        chunk: query rows per step (bounds the (chunk, N) distance block).
    """
    n = s_points.shape[0]
    r2 = radius * radius
    out = []
    for start, d, idx in _chunked_min_k(q_points, s_points, s_masks, limit, chunk):
        valid = (d < r2) & q_masks[start : start + chunk, None]
        out.append(torch.where(valid, idx.to(torch.int32), n))
    return torch.cat(out, dim=0)
