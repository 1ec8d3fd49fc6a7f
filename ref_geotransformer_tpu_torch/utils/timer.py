"""Prepare/process time accounting (ref parity: utils/timer.py:4-79), and the
program's spans.

`Timer` is a copy of `ref_geotransformer_tpu/utils/timer.py`'s: only its imports
differ (the port imports nothing of the JAX package).

`span(name)` marks a section of the program (a layer boundary: `gt.register`,
`gt.pyramid`, `gt.forward`, `gt.backbone`, ..., `gt.train_step`, `gt.update`,
`gt.load`) for `torch.profiler`. While a profiler runs, a span is a
`record_function` range: it lands in the profiler's own trace, on the clock of
the device activities there, and is written out with that trace. Spans nest by
containment on one thread; a pair's or a step's spans lie inside its top span
(`gt.register` or `gt.train_step`). With no profiler active a span costs one
check and enters nothing.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


class Timer:
    def __init__(self):
        self.total_prepare_time = 0.0
        self.total_process_time = 0.0
        self.count_prepare_time = 0
        self.count_process_time = 0
        self.last_time = time.time()

    def reset(self) -> None:
        self.__init__()

    def record(self) -> None:
        self.last_time = time.time()

    def add_prepare_time(self) -> None:
        now = time.time()
        self.total_prepare_time += now - self.last_time
        self.count_prepare_time += 1
        self.last_time = now

    def add_process_time(self) -> None:
        now = time.time()
        self.total_process_time += now - self.last_time
        self.count_process_time += 1
        self.last_time = now

    def get_prepare_time(self) -> float:
        return self.total_prepare_time / max(self.count_prepare_time, 1)

    def get_process_time(self) -> float:
        return self.total_process_time / max(self.count_process_time, 1)

    def tostring(self) -> str:
        return f"prepare: {self.get_prepare_time():.3f}s, process: {self.get_process_time():.3f}s"


def span(name: str):
    """A context manager around a named section: `record_function(name)` while
    a profiler runs, a shared no-op context otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return record_function(name)
