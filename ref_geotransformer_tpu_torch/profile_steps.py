"""Where the device time of the port's steps goes, on the card.

    python -m ref_geotransformer_tpu_torch.profile_steps [--full] [--train] [--steps N]

Runs the demo pair through one warm-up step, then N steps under
`torch.profiler` (CPU and CUDA activities): inference steps (pyramid +
forward, as `demo.py` runs them) or, with --train, train steps (as
`train.py` runs them). Prints the host time per step, the device time of
the kernels per step by group and for the largest kernel names, and the
device's busy share: the union of the kernels' intervals over the window
from the first kernel's start to the last one's end.
"""

from __future__ import annotations

import argparse
import re
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ref_geotransformer_tpu_torch.config.threedmatch import make_cfg
from ref_geotransformer_tpu_torch.demo import build_model, load_pair, register
from ref_geotransformer_tpu_torch.engine import train_step
from ref_geotransformer_tpu_torch.train import make_train_run

TOP = 15  # kernel names listed
# kernel name pattern -> group, first match wins
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


def busy_share(intervals) -> float:
    """Union length of the (start, end) intervals over their span."""
    intervals = sorted(intervals)
    covered, cur_start, cur_end = 0.0, intervals[0][0], intervals[0][1]
    last_end = cur_end
    for start, end in intervals[1:]:
        if start > cur_end:
            covered += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
        last_end = max(last_end, end)
    covered += cur_end - cur_start
    return covered / (last_end - intervals[0][0])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--full", action="store_true", help="full 3DMatch capacities (default: demo capacities)")
    parser.add_argument("--train", action="store_true", help="train steps (default: inference steps)")
    parser.add_argument("--steps", type=int, default=3, help="profiled steps after the warm-up step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_steps: CUDA is not available; it measures the card only")

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_cfg(demo=not args.full)
    if args.train:
        model, pair, state, generator = make_train_run(cfg, device)
        step = lambda: train_step(model, state, pair, generator)  # noqa: E731
    else:
        model, pair = build_model(cfg, device), load_pair(cfg, device)
        step = lambda: register(model, cfg, pair)  # noqa: E731
    step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    by_name = defaultdict(float)
    intervals = []
    events = prof.events()
    # device activities only: not the host ranges the profiler mirrors onto the
    # device track (e.g. "Optimizer.step#Adam.step"), which span other kernels
    host_names = {event.name for event in events if event.device_type == torch.autograd.DeviceType.CPU}
    for event in events:
        if (event.device_type == torch.autograd.DeviceType.CUDA and event.name not in host_names
                and event.time_range.end > event.time_range.start):
            by_name[event.name] += event.time_range.elapsed_us() / 1e3 / args.steps
            intervals.append((event.time_range.start, event.time_range.end))
    if not intervals:
        raise SystemExit("profile_steps: the profiler recorded no device kernel")
    by_group = defaultdict(float)
    for name, ms in by_name.items():
        by_group[group_of(name)] += ms
    kind = "train" if args.train else "inference"
    total = sum(by_name.values())
    print(f"{torch.cuda.get_device_name(0)}; {kind} steps at caps {cfg.capacities.points}, {args.steps} profiled")
    print(f"host time {host_ms:.2f} ms/step; kernel time {total:.2f} ms/step over {len(by_name)} kernel names; "
          f"device busy {100 * busy_share(intervals):.1f}% of the kernels' span")
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.2f} ms/step  {100 * ms / total:5.1f}%  {group}")
    print(f"largest {TOP} kernel names:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms:9.2f} ms/step  {name[:110]}")


if __name__ == "__main__":
    main()
