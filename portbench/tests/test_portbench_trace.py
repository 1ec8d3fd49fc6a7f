"""The trace reader on a hand-made Chrome trace: kernels fall into the range
their launch lies in (by the profiler's correlation id, on the launching
thread), busy and idle shares are taken over the window, and the readers
return nothing where the trace holds nothing to read."""

import json

from portbench import readers
from portbench.trace import parse_chrome_trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1, "args": args}


def _trace(tmp_path):
    events = [
        _x("user_annotation", "pb.window", 0, 100),
        _x("user_annotation", "pb.pyramid", 0, 10),
        _x("user_annotation", "pb.model", 10, 80),
        _x("user_annotation", "pb.backbone", 12, 30),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 50, 20, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
        _x("cuda_driver", "cuLaunchKernel", 55, 1, tid=2, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=4),
        _x("kernel", "radius_search_group_kernel", 8, 4, tid=7, correlation=1),
        _x("kernel", "gemm_bf16", 22, 10, tid=7, correlation=2),
        _x("kernel", "indexFuncLargeIndex", 56, 6, tid=7, correlation=3),
        _x("kernel", "elementwise", 61, 4, tid=7, correlation=4),
        _x("gpu_memcpy", "Memcpy HtoD", 80, 5, tid=7, correlation=9),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return parse_chrome_trace(str(path), steps=2)


def test_kernels_fall_into_their_launch_range(tmp_path):
    t = _trace(tmp_path)
    names = {k.name: k for k in t.kernels}
    assert t.launched_in(names["radius_search_group_kernel"], "pb.pyramid")
    assert t.launched_in(names["gemm_bf16"], "pb.backbone") and t.launched_in(names["gemm_bf16"], "pb.model")
    assert not t.launched_in(names["gemm_bf16"], "pb.pyramid")
    # launched by the autograd engine's thread: backward, not the forward's model range
    assert t.launched_in(names["indexFuncLargeIndex"], "autograd::engine::evaluate_function", prefix=True)
    assert not t.launched_in(names["indexFuncLargeIndex"], "pb.model")
    assert t.launched_in(names["elementwise"], "pb.model")
    assert len(t.device_kernels()) == 4  # the copy is device activity, not a kernel


def test_busy_idle_and_per_step_readings(tmp_path):
    t = _trace(tmp_path)
    assert t.window == (0.0, 100.0)
    assert t.busy_us() == 4 + 10 + 6 + 4 + 5 - 1  # the element-wise kernel overlaps the gather by 1 us
    assert sum(e - s for s, e in t.idle_gaps()) == 100 - t.busy_us()
    run = type("R", (), {"trace": t})()
    assert readers.per_step_ms(run, lambda k: t.launched_in(k, "pb.backbone")) == 10 / 1e3 / 2
    assert readers.per_step_ms(run, lambda k: False) is None
    assert readers.group_of("void at::native::indexFuncLargeIndex<float>") == "gather, scatter, index"
    assert readers.share(1e-6, 4.0) == 25.0
    assert readers.share(0.0, 4.0) is None
