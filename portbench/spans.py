"""The program's own spans as the benchmark reads them, and the device's idle
time split by the span the host was in.

The port marks its layers with `torch.profiler` ranges of its own
(`ref_geotransformer_tpu_torch/utils/timer.py::span`), on while a profiler
runs: a pair's `gt.register` holds `gt.pyramid` and `gt.forward`, whose steps
hold `gt.backbone` and `gt.transformer`; a train step's `gt.train_step` holds
the pyramid, the forward, `gt.loss`, `gt.backward` and `gt.update`. The names
in `LAYERS` are the contract between the program and these readers.

Each idle instant of the traced window (`Trace.idle_gaps`) goes to the first
layer of its mode whose span the main thread (the window range's thread) was
inside then; the last layer takes the rest. So a mode's layers partition the
window's idle time, and their sum over the profiled pairs or steps is
`idle_pct` of the window.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from portbench.trace import WINDOW

Intervals = List[Tuple[float, float]]

# mode -> (its top span, its layers in order: (layer, span), None for the rest of the window)
LAYERS = {
    "infer": ("gt.register", (("pyramid", "gt.pyramid"), ("backbone", "gt.backbone"),
                              ("transformer", "gt.transformer"), ("matching", "gt.register"), ("outside", None))),
    "train": ("gt.train_step", (("backward", "gt.backward"), ("update", "gt.update"), ("forward", "gt.train_step"),
                                ("outside", None))),
}


def union(intervals: Iterable[Tuple[float, float]]) -> Intervals:
    """Sorted, disjoint intervals covering the same points."""
    out: Intervals = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intersect(a: Intervals, b: Intervals) -> Intervals:
    """The common part of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def complement(a: Intervals, lo: float, hi: float) -> Intervals:
    """[lo, hi] less a sorted, disjoint interval list."""
    out, t = [], lo
    for s, e in a:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def length(a: Intervals) -> float:
    return sum(e - s for s, e in a)


def idle_split(trace, mode: str) -> Optional[Dict[str, float]]:
    """Idle microseconds of the traced window by layer of `mode`; None where
    the main thread holds no top span of the mode (a program without spans)."""
    top, layers = LAYERS[mode]
    main = trace.named(WINDOW)[0].tid
    if not any(r.tid == main for r in trace.named(top)):
        return None
    lo, hi = trace.window
    left = trace.idle_gaps()
    split = {}
    for layer, name in layers:
        inside = left if name is None else intersect(left, union((r.start, r.end) for r in trace.named(name)
                                                                 if r.tid == main))
        split[layer] = length(inside)
        left = intersect(left, complement(inside, lo, hi))
    return split


def idle_ms(run, mode: str, layer: str) -> Optional[float]:
    """Device-idle ms per profiled pair or step while the host's main thread
    was in `layer`; None without a trace, in the other mode, or without the
    program's spans."""
    if run.trace is None or run.mode != mode:
        return None
    split = idle_split(run.trace, mode)
    return None if split is None else split[layer] / 1e3 / run.trace.steps
