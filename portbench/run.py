"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
With `--trace 0` the result's metrics are the cell's end-to-end metrics;
with `--trace 1` its per-layer metrics, read from a profiled block of
pairs or steps that follows the window. The last line of standard output
is one JSON object: correct, attempted, failed, metrics, device (and
breakdown when traced), then the numbers compared beside their limits,
which also close standard error. Without CUDA, with fewer cards than the
cell asks for, or with a JAX module loaded once the window has closed, it
prints no result and exits with a code other than 0.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True, help="draws the weights, the pairs and their order")
    parser.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: per-layer metrics from a trace")
    args = parser.parse_args(argv)

    from portbench import harness

    harness.cache_environment()
    cell = harness.resolve(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); found {found}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded in the run: {found}", file=sys.stderr)
        return 4
    correct, shown = harness.verdict(result["checks"], cell.limits)
    correct = correct and result["failed"] == 0
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                   "memory_peak_bytes": int(result["memory_peak_bytes"]), "power": harness.power_limit()}
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": result["metrics"], "device": device_info}
    if args.trace:
        device_info["busy_s"] = result["busy_s"]
        device_info["window_s"] = result["window_s"]
        line["breakdown"] = result["breakdown"]
    line["checks"] = shown
    for name, value in sorted(result["checks"].items()):
        if name.startswith("info."):
            print(f"reading {name[5:]}: {value} (not compared)", file=sys.stderr)
    for name, c in shown.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
