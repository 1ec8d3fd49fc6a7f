"""Prepare/process time accounting (ref parity: utils/timer.py:4-79).

A copy of `ref_geotransformer_tpu/utils/timer.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import time
from typing import Dict


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


class TimerDict:
    """Named section timers."""

    def __init__(self):
        self.timers: Dict[str, float] = {}
        self.starts: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def tic(self, key: str) -> None:
        self.starts[key] = time.time()

    def toc(self, key: str) -> None:
        elapsed = time.time() - self.starts[key]
        self.timers[key] = self.timers.get(key, 0.0) + elapsed
        self.counts[key] = self.counts.get(key, 0) + 1

    def get_time(self, key: str) -> float:
        return self.timers.get(key, 0.0) / max(self.counts.get(key, 0), 1)

    def summary(self, keys=None) -> str:
        keys = keys or list(self.timers.keys())
        return ", ".join(f"{k}: {self.get_time(k):.3f}s" for k in keys)
