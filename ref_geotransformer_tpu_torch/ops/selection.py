"""Top-k selection along the last axis.

The JAX package selects with `lax.approx_min_k` / `approx_max_k` on a TPU
(`ref_geotransformer_tpu/ops/selection.py`), which lower to an exact sort on
the CPU. The port always selects exactly. `chunked_min_k` is the exact
selection of `_chunked_topk_neighbors` in the JAX package's
`ops/neighbors.py`: the k nearest valid supports of each query, one chunk of
queries at a time.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from ref_geotransformer_tpu_torch.ops.pairwise import pairwise_distance

FILL = 1e12  # the squared distance of an invalid support


def min_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest along the last axis, ascending: (values, int64 indices)."""
    return torch.topk(x, k, dim=-1, largest=False, sorted=True)


def max_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k largest along the last axis, descending: (values, int64 indices)."""
    return torch.topk(x, k, dim=-1, largest=True, sorted=True)


def chunked_min_k(
    q_points: torch.Tensor, s_points: torch.Tensor, s_masks: torch.Tensor, k: int, chunk: int
) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
    """(start, sq_dists, indices) per chunk of queries: the k nearest
    supports of each, ascending, invalid supports pushed to FILL."""
    s_invalid = ~s_masks
    for start in range(0, q_points.shape[0], chunk):
        sq = pairwise_distance(q_points[start : start + chunk], s_points)
        sq = torch.where(s_invalid[None, :], FILL, sq)
        d, idx = min_k(sq, k)
        yield start, d, idx
