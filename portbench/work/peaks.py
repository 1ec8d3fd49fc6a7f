"""Published dense peaks of one NVIDIA H100 SXM (data sheet, no sparsity),
at its full 700 W power limit. A run prints the card's power limit beside
every share of these."""

BF16_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores: the top rate of an f32-accurate product
FP32_FLOPS = 67e12  # float32 outside the tensor cores (FMA pipes)
HBM_BYTES = 3.35e12  # bytes/s

# a contraction's precision class -> its peak
CLASS_PEAK = {"bf16": BF16_FLOPS, "f32": TF32_FLOPS}


def bound_seconds(flops: float, bytes_: float, flops_peak: float) -> float:
    """The least time the chip could take: the larger of operations over
    their peak and bytes over the memory's peak."""
    return max(flops / flops_peak, bytes_ / HBM_BYTES)
