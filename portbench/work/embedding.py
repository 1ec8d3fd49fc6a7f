"""Work of the geometric structure embedding (`csrc/geo_embedding.cu`,
`csrc/geo_embedding_bwd.cu`) over the n valid nodes of one cloud.

Forward: the f32 products of the projections over the valid (i, j) pairs,
2 n^2 C^2 for the distance term and 2 n^2 k C^2 for the k angle terms.
Backward: the weight gradients need one product of the same size for the
distance projection and one for the angle projection that won the max,
4 n^2 C^2. Divided by 495 TFLOP/s, dense TF32, the highest rate at which an
f32-accurate product can run on the card (a split-TF32 kernel needs three
passes for it, so it reads at most a third of this roof); bytes at
3.35 TB/s: the nodes, their k reference vectors and the weights read once,
the (n, n, C) embedding written once (read once, backward).
"""

from portbench.work.peaks import TF32_FLOPS, bound_seconds


def forward(n: int, c: int, k: int):
    """(flops, bytes) of one cloud's embedding forward."""
    flops = 2.0 * n * n * c * c * (1 + k)
    bytes_ = 4.0 * (n * 3 + n * k * 3 + 2 * c * c + 2 * c + c // 2) + 4.0 * n * n * c
    return flops, bytes_


def backward(n: int, c: int):
    """(flops, bytes) of one cloud's embedding backward (weight gradients)."""
    flops = 4.0 * n * n * c * c
    bytes_ = 4.0 * n * n * c + 4.0 * (n * 3 + n * 3 * 3 + c * c) + 4.0 * (2 * c * c + 2 * c)
    return flops, bytes_


def seconds(flops: float, bytes_: float) -> float:
    return bound_seconds(flops, bytes_, TF32_FLOPS)
