"""The traced block of a `--trace 1` run and what the per-layer readers see.

The benchmark opens its own ranges around the program's layers (forward
pre/post hooks on the model's modules, `torch.profiler.record_function`),
profiles a fixed number of pairs or steps with `torch.profiler`, and reads
the profiler's Chrome trace back into a `Trace`:

* `ranges`: host intervals of the benchmark's ranges and of the profiler's
  CPU ops (the autograd engine's `evaluate_function` ops among them), each
  with its thread;
* `kernels`: device activities (kernels, copies, sets) with their device
  interval and their launch: the host time and thread of the runtime or
  driver call that the profiler's correlation id ties them to.

A kernel belongs to a range when its launch lies inside the range on the
same thread, so a kernel that a later program splits or renames still
falls where its work is.
"""

from __future__ import annotations

import bisect
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "pb.window"
PAIR = "pb.pair"
PYRAMID = "pb.pyramid"
MODEL = "pb.model"
BACKWARD_PREFIX = "autograd::engine::evaluate_function"

# module path in the model -> range name
MODULE_RANGES = (
    ("backbone", "pb.backbone"),
    ("transformer", "pb.transformer"),
    ("transformer.embedding", "pb.embedding"),
    ("optimal_transport", "pb.optimal_transport"),
)


@dataclass
class Kernel:
    name: str
    kind: str  # "kernel", "gpu_memcpy" or "gpu_memset"
    start: float  # device interval, microseconds
    end: float
    launch: Optional[float]  # host time of the launch, microseconds
    tid: Optional[int]


@dataclass
class Range:
    name: str
    start: float
    end: float
    tid: int


@dataclass
class Trace:
    ranges: List[Range]
    kernels: List[Kernel]
    steps: int
    window: Tuple[float, float]
    _index: Dict[str, Tuple[List[float], List[Range]]] = field(default_factory=dict)

    def named(self, name: str) -> List[Range]:
        return [r for r in self.ranges if r.name == name]

    def _intervals(self, key: str, match) -> Tuple[List[float], List[Range]]:
        if key not in self._index:
            ranges = sorted((r for r in self.ranges if match(r.name)), key=lambda r: r.start)
            self._index[key] = ([r.start for r in ranges], ranges)
        return self._index[key]

    def launched_in(self, kernel: Kernel, name: str, prefix: bool = False) -> bool:
        """Whether `kernel` was launched inside a range called `name` (or
        whose name starts with it) on the launching thread."""
        if kernel.launch is None:
            return False
        starts, ranges = self._intervals(("p:" if prefix else "n:") + name,
                                         (lambda n: n.startswith(name)) if prefix else (lambda n: n == name))
        i = bisect.bisect_right(starts, kernel.launch)
        # ranges of one name may nest (a module called inside itself); look back a little
        for r in ranges[max(0, i - 64):i][::-1]:
            if r.start <= kernel.launch <= r.end and r.tid == kernel.tid:
                return True
        return False

    def device_kernels(self) -> List[Kernel]:
        return [k for k in self.kernels if k.kind == "kernel"]

    def busy_us(self) -> float:
        """Union of the device activities' intervals inside the window."""
        lo, hi = self.window
        spans = sorted((max(k.start, lo), min(k.end, hi)) for k in self.kernels if k.end > lo and k.start < hi)
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The window's intervals in which no device activity runs."""
        lo, hi = self.window
        spans = sorted((k.start, k.end) for k in self.kernels if k.end > lo and k.start < hi)
        gaps, t = [], lo
        for s, e in spans:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def host_activity(self, t: float, tid: int) -> str:
        """What the host thread `tid` was doing at time t: its benchmark
        range and its innermost profiled op there."""
        inner_pb, inner_op = None, None
        for r in self.ranges:
            if r.tid == tid and r.start <= t <= r.end and r.name != WINDOW:
                if r.name.startswith("pb."):
                    if inner_pb is None or r.start >= inner_pb.start:
                        inner_pb = r
                elif inner_op is None or r.start >= inner_op.start:
                    inner_op = r
        parts = [inner_pb.name if inner_pb else "outside the benchmark's ranges",
                 inner_op.name if inner_op else "no profiled op"]
        return " / ".join(parts)


def parse_chrome_trace(path: str, steps: int) -> Trace:
    """A `Trace` from the profiler's exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges, device, launches, externals = [], [], {}, {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        args = ev.get("args") or {}
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))
        if cat in ("cpu_op", "user_annotation"):
            r = Range(ev["name"], start, end, ev.get("tid"))
            ranges.append(r)
            if "External id" in args:
                externals.setdefault(args["External id"], r)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[args["correlation"]] = (start, ev.get("tid"))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((ev["name"], cat, start, end, args.get("correlation"), args.get("External id")))
    kernels = []
    for name, cat, start, end, corr, ext in device:
        launch, tid = launches.get(corr, (None, None))
        if launch is None and ext in externals:
            launch, tid = externals[ext].start, externals[ext].tid
        kernels.append(Kernel(name, cat, start, end, launch, tid))
    window = [r for r in ranges if r.name == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no benchmark window range")
    return Trace(ranges, kernels, steps, (window[0].start, window[0].end))


class LayerRanges:
    """Forward pre/post hooks that open and close a profiler range around
    the model and its layer modules, and the pyramid's range, which runs
    from the start of a pair to the model's forward. Installed only in a
    traced run, removed after it."""

    def __init__(self, model: torch.nn.Module):
        self.handles = []
        self.open: Dict[int, List] = {}
        self.pyramid = None
        modules = [(model, MODEL)] + [(model.get_submodule(path), name) for path, name in MODULE_RANGES]
        for module, name in modules:
            self.handles.append(module.register_forward_pre_hook(self._enter(name, module is model)))
            self.handles.append(module.register_forward_hook(self._exit()))

    def _enter(self, name, is_model):
        def hook(module, args):
            if is_model:
                self.end_pyramid()
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self.open.setdefault(id(module), []).append(rf)
        return hook

    def _exit(self):
        def hook(module, args, output):
            self.open[id(module)].pop().__exit__(None, None, None)
        return hook

    def start_pyramid(self) -> None:
        self.pyramid = torch.profiler.record_function(PYRAMID)
        self.pyramid.__enter__()

    def end_pyramid(self) -> None:
        if self.pyramid is not None:
            self.pyramid.__exit__(None, None, None)
            self.pyramid = None

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def profile_block(step, count: int, model: torch.nn.Module, out_dir: str, tag: str):
    """Run `step(i)` for i in range(count) under the profiler, each step in
    a pair range that starts with the pyramid's range, the whole block in the
    window range closed after a synchronize. Returns (Trace, the step results)."""
    from torch.profiler import ProfilerActivity, profile

    layers = LayerRanges(model)
    results = []
    path = os.path.join(out_dir, f"trace-{tag}.json")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                for i in range(count):
                    with torch.profiler.record_function(PAIR):
                        layers.start_pyramid()
                        results.append(step(i))
                        layers.end_pyramid()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        prof.export_chrome_trace(path)
    finally:
        layers.remove()
    trace = parse_chrome_trace(path, count)
    os.remove(path)
    return trace, results
