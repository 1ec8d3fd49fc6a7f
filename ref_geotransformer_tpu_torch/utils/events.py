"""Scalar event logging (ref parity: the reference's rank-0 TensorBoard
SummaryWriter, engine/base_trainer.py:59-61,267-272).

Writes both TensorBoard events (via tensorboardX when available) and an
append-only JSONL mirror that needs no viewer.

A copy of `ref_geotransformer_tpu/utils/events.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class EventWriter:
    def __init__(self, event_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.event_dir = event_dir
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(event_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(event_dir)
        except Exception:
            self._tb = None
        self._jsonl = open(os.path.join(event_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if not self.enabled:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                          "time": time.time()}) + "\n")

    def add_scalars(self, scalars: Dict[str, float], step: int, prefix: str = "") -> None:
        for key, value in scalars.items():
            try:
                self.add_scalar(prefix + key, float(value), step)
            except (TypeError, ValueError):
                continue

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
