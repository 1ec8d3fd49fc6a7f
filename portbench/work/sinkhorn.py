"""Work of the log-domain Sinkhorn iterations (`csrc/sinkhorn.cu`) over the
valid entries of each patch: an (m + 1) x (n + 1) block with the dustbin,
m and n the patch's valid rows and columns.

Each iteration updates the rows, then the columns; each update reads every
valid entry once for an add, a max, a difference, an exp and a sum (5
operations), and each row or column once more for its log and difference
(2). exp and log are counted as operations at 67 TFLOP/s, the f32 rate
outside the tensor cores, not at the special-function units' rate, so an
implementation that evaluates them on the FMA pipes cannot read over its
roof. Bytes at 3.35 TB/s: the valid scores and marginals read once, the
valid output written once.
"""

from portbench.work.peaks import FP32_FLOPS, bound_seconds


def work(blocks, iterations: int):
    """(flops, bytes) of the Sinkhorn over `blocks`, a list of (m, n) valid
    rows and columns per patch (without the dustbin)."""
    flops, bytes_ = 0.0, 0.0
    for m, n in blocks:
        entries = (m + 1) * (n + 1)
        flops += iterations * (2 * 5 * entries + 2 * 2 * (m + 1 + n + 1))
        bytes_ += 4.0 * (2 * entries + (m + 1) + (n + 1))
    return flops, bytes_


def seconds(flops: float, bytes_: float) -> float:
    return bound_seconds(flops, bytes_, FP32_FLOPS)
