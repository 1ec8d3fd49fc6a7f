"""Streaming metric accumulator (ref parity: utils/average_meter.py:4-35).

A copy of `ref_geotransformer_tpu/utils/average_meter.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import List


class AverageMeter:
    def __init__(self, last_n: int | None = None):
        self._records: List[float] = []
        self._last_n = last_n

    def update(self, result) -> None:
        if isinstance(result, (list, tuple)):
            self._records += [float(r) for r in result]
        else:
            self._records.append(float(result))

    def reset(self) -> None:
        self._records.clear()

    @property
    def records(self) -> List[float]:
        if self._last_n is not None:
            return self._records[-self._last_n:]
        return self._records

    def sum(self) -> float:
        return float(sum(self.records))

    def mean(self) -> float:
        r = self.records
        return float(sum(r) / len(r)) if r else 0.0

    def std(self) -> float:
        r = self.records
        if not r:
            return 0.0
        m = self.mean()
        return float((sum((x - m) ** 2 for x in r) / len(r)) ** 0.5)

    def median(self) -> float:
        r = sorted(self.records)
        if not r:
            return 0.0
        n = len(r)
        return float(r[n // 2]) if n % 2 else float(0.5 * (r[n // 2 - 1] + r[n // 2]))
