"""Named collection of AverageMeters (ref parity: utils/summary_board.py:7-93).

A copy of `ref_geotransformer_tpu/utils/summary_board.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ref_geotransformer_tpu_torch.utils.average_meter import AverageMeter


class SummaryBoard:
    """Accumulates named scalar metrics; unknown names are auto-registered
    when `adaptive` is set (the reference's behavior for metric dicts coming
    out of train steps)."""

    def __init__(self, names: Optional[List[str]] = None, last_n: Optional[int] = None, adaptive: bool = False):
        self.meters: Dict[str, AverageMeter] = {}
        self.last_n = last_n
        self.adaptive = adaptive
        if names is not None:
            self.register_all(names)

    def register_meter(self, name: str) -> None:
        self.meters[name] = AverageMeter(last_n=self.last_n)

    def register_all(self, names: List[str]) -> None:
        for name in names:
            self.register_meter(name)

    def reset_meter(self, name: str) -> None:
        self.meters[name].reset()

    def reset_all(self) -> None:
        for meter in self.meters.values():
            meter.reset()

    def check_name(self, name: str) -> None:
        if name not in self.meters:
            if self.adaptive:
                self.register_meter(name)
            else:
                raise KeyError(f"No meter for key '{name}'.")

    def update(self, name: str, value: float) -> None:
        self.check_name(name)
        self.meters[name].update(value)

    def update_from_result_dict(self, result_dict: Dict) -> None:
        for key, value in result_dict.items():
            try:
                self.update(key, float(value))
            except (TypeError, ValueError):
                continue

    def sum(self, name: str) -> float:
        return self.meters[name].sum()

    def mean(self, name: str) -> float:
        return self.meters[name].mean()

    def std(self, name: str) -> float:
        return self.meters[name].std()

    def median(self, name: str) -> float:
        return self.meters[name].median()

    def summary(self, names: Optional[List[str]] = None) -> Dict[str, float]:
        if names is None:
            names = list(self.meters.keys())
        return {name: self.meters[name].mean() for name in names}
