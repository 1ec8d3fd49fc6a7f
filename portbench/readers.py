"""Helpers of the per-layer metric readers in `portbench/metrics/`: device
time by range or by kernel name over the profiled block, and shares of a
roofline. A reader returns None where the trace holds nothing to read."""

from __future__ import annotations

import re
from typing import Callable, Optional

# kernel name pattern -> group, first match wins (the port's profile_steps.py GROUPS)
GROUPS = (
    ("embedding backward kernel", r"geo_embedding_bwd_kernel|sum_chunks_kernel"),
    ("embedding forward kernel", r"geo_embedding_kernel"),
    ("Sinkhorn kernel", r"sinkhorn"),
    ("radius-search kernel", r"radius_search_group_kernel|radius_pack_kernel"),
    ("top-k and sort", r"topk|TopK|sort|Sort|radix|Radix"),
    ("matrix products", r"gemm|Gemm|GEMM|cutlass|xmma|sm90_|sm80_|cublas"),
    ("gather, scatter, index", r"index|Index|gather|Gather|scatter|Scatter"),
    ("reductions", r"reduce|Reduce"),
)


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name):
            return group
    return "elementwise and other"


def device_us(trace, keep: Callable) -> float:
    """Summed device time (us) of the profiled block's kernels that `keep`."""
    return sum(k.end - k.start for k in trace.device_kernels() if keep(k))


def per_step_ms(run, keep: Callable) -> Optional[float]:
    """Device ms per profiled pair or step of the kernels that `keep`; None
    without a trace or where no such kernel ran."""
    if run.trace is None:
        return None
    us = device_us(run.trace, keep)
    return us / 1e3 / run.trace.steps if us > 0 else None


def share(bound_s: float, device_us_: float) -> Optional[float]:
    """Percent of the device time that the least time at the peaks takes."""
    if device_us_ <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / (device_us_ / 1e6)
