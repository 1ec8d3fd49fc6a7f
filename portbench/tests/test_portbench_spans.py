"""The idle split by the program's spans (portbench/spans.py) on hand-made
Chrome traces: a gap is split over time between the spans the main thread
was in, nested spans count once, a mode's metrics sum to the window's idle
time, and every reader returns nothing without a trace, in the other mode or
without the program's spans."""

import json
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.spans import complement, intersect, union
from portbench.trace import parse_chrome_trace

STEPS = 2
INFER = ("pyramid", "backbone", "transformer", "matching", "outside")
TRAIN = ("forward", "backward", "update", "outside")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1, "args": args}


def _kernel(name, ts, dur, correlation):
    return _x("kernel", name, ts, dur, tid=7, correlation=correlation)


def _infer_events():
    """Idle: [0, 10) [22, 40) [55, 62) [70, 92) [95, 100]."""
    return [
        _x("user_annotation", "pb.window", 0, 100),
        _x("user_annotation", "gt.register", 5, 85),
        _x("user_annotation", "gt.pyramid", 5, 25),
        _x("user_annotation", "gt.pyramid.search", 20, 10),
        _x("user_annotation", "gt.forward", 30, 60),
        _x("user_annotation", "pb.backbone", 36, 20),
        _x("user_annotation", "gt.backbone", 35, 25),
        _x("user_annotation", "gt.transformer", 60, 20),
        _x("user_annotation", "gt.embedding", 60, 5),
        _kernel("radius_search_group_kernel", 10, 12, 1),
        _kernel("gemm", 40, 15, 2),
        _kernel("geo_embedding_kernel", 62, 8, 3),
        _x("gpu_memcpy", "Memcpy DtoH", 92, 3, tid=7, correlation=4),
    ]


def _train_events():
    """Idle: [0, 5) [12, 20) [35, 50) [65, 82) [86, 100]; the backward's
    kernels launched from the autograd engine's thread, a stray span on it."""
    return [
        _x("user_annotation", "pb.window", 0, 100),
        _x("user_annotation", "gt.train_step", 2, 88),
        _x("user_annotation", "gt.pyramid", 2, 13),
        _x("user_annotation", "gt.forward", 15, 25),
        _x("user_annotation", "gt.loss", 40, 5),
        _x("user_annotation", "gt.backward", 45, 25),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 50, 15, tid=2),
        _x("user_annotation", "gt.backward", 12, 8, tid=2),
        _x("user_annotation", "gt.update", 70, 18),
        _x("user_annotation", "gt.update.guard", 70, 10),
        _x("cpu_op", "aten::_local_scalar_dense", 72, 8),
        _x("user_annotation", "gt.update.optimizer", 80, 8),
        _kernel("elementwise", 5, 7, 1),
        _kernel("gemm", 20, 15, 2),
        _kernel("indexFuncLargeIndex", 50, 15, 3),
        _kernel("adam", 82, 4, 4),
    ]


def _run(tmp_path, events, mode):
    path = tmp_path / f"{mode}.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(trace=parse_chrome_trace(str(path), steps=STEPS), mode=mode)


def _read(run, mode, layer):
    return harness.load_reader(f"{layer}_idle_ms.{mode}")(run)


def test_interval_arithmetic():
    assert union([(5, 7), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 7)]
    assert intersect([(0, 4), (5, 9)], [(3, 6), (8, 10)]) == [(3, 4), (5, 6), (8, 9)]
    assert complement([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert complement([(0, 5)], 0, 5) == []


def test_infer_gaps_split_by_span(tmp_path):
    run = _run(tmp_path, _infer_events(), "infer")
    per_step = {layer: _read(run, "infer", layer) * 1e3 * STEPS for layer in INFER}
    # [22, 40) crosses the pyramid (8), the forward before the backbone (5) and the backbone (5);
    # the nested search and embedding spans add nothing to their parents
    assert per_step == pytest.approx({"pyramid": 5 + 8, "backbone": 5 + 5, "transformer": 2 + 10,
                                      "matching": 5 + 10, "outside": 5 + 2 + 5})


def test_train_gaps_split_by_span(tmp_path):
    run = _run(tmp_path, _train_events(), "train")
    per_step = {layer: _read(run, "train", layer) * 1e3 * STEPS for layer in TRAIN}
    # [35, 50) crosses the loss (forward, 10) and the backward (5); the span on the engine's thread counts nothing
    assert per_step == pytest.approx({"forward": 3 + 8 + 10 + 2, "backward": 5 + 5, "update": 12 + 2,
                                      "outside": 2 + 10})


@pytest.mark.parametrize("mode, events, layers", [("infer", _infer_events, INFER), ("train", _train_events, TRAIN)])
def test_a_modes_metrics_sum_to_the_windows_idle_time(tmp_path, mode, events, layers):
    run = _run(tmp_path, events(), mode)
    lo, hi = run.trace.window
    idle_pct = harness.load_reader(f"idle_pct.{mode}")(run)
    total = sum(_read(run, mode, layer) for layer in layers)
    assert total == pytest.approx(idle_pct / 100 * (hi - lo) / 1e3 / STEPS, rel=1e-12)
    assert total == pytest.approx((hi - lo - run.trace.busy_us()) / 1e3 / STEPS, rel=1e-12)


@pytest.mark.parametrize("mode, events, layers", [("infer", _infer_events, INFER), ("train", _train_events, TRAIN)])
def test_readers_return_none_where_nothing_is_read(tmp_path, mode, events, layers):
    run = _run(tmp_path, events(), mode)
    other = "train" if mode == "infer" else "infer"
    without_spans = _run(tmp_path, [e for e in events() if not e["name"].startswith("gt.")], mode)
    for layer in layers:
        assert _read(SimpleNamespace(trace=None, mode=mode), mode, layer) is None
        assert _read(SimpleNamespace(trace=run.trace, mode=other), mode, layer) is None
        assert _read(without_spans, mode, layer) is None
        assert _read(run, mode, layer) is not None
