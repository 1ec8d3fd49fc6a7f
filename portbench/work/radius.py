"""Work of the pyramid's radius searches (`csrc/radius_search.cu`).

Operations: 8 f32 operations (3 differences, 3 products, 2 sums) for each
(valid query, valid support) pair that lies within the radius: those are
the distances any search must examine, a culled one too, not every valid
pair. Divided by 67 TFLOP/s, the card's f32 rate outside the tensor cores.
Bytes at 3.35 TB/s: the valid queries' and supports' points and masks read
once, the valid queries' rows of the table written once.
"""

import torch

from portbench.work.peaks import FP32_FLOPS, bound_seconds

OPS_PER_PAIR = 8


def pairs_within(q_points, s_points, q_masks, s_masks, radius: float, chunk: int = 2048) -> int:
    """Number of (valid query, valid support) pairs closer than `radius`
    (squared distance below radius^2, as the search keeps them)."""
    r2 = radius * radius
    s = s_points[s_masks].double()
    total = 0
    for start in range(0, q_points.shape[0], chunk):
        q = q_points[start:start + chunk][q_masks[start:start + chunk]].double()
        if q.shape[0] and s.shape[0]:
            total += int((torch.cdist(q, s).square() < r2).sum())
    return total


def work(n_queries: int, n_supports: int, within: int, limit: int):
    """(flops, bytes) of one search."""
    flops = float(OPS_PER_PAIR * within)
    bytes_ = 13.0 * (n_queries + n_supports) + 4.0 * n_queries * limit
    return flops, bytes_


def seconds(flops: float, bytes_: float) -> float:
    return bound_seconds(flops, bytes_, FP32_FLOPS)
