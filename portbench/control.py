"""Readings of the comparison that decides `correct`, for setting its limits.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13 [--program] [--control]

`--program` reads the program's own numbers (the lower readings): on the
pairs an inference run of that seed checks, through the program's inference
call, or through its first train steps. `--control` reads the control's
(the upper readings): the plain reference put in the program's place one
precision below the configuration's (the pyramid's coordinates and
distances in bf16, every f32 product in TF32), judged by the same
comparison. One JSON line per seed and side, on a card. The benchmark's
own runs never run this; its numbers go into portbench/limits/<cell>.json.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check, harness


def _infer_pairs(cell, seed, pool, order):
    return [pool[order[i]] for i in harness.checked_indices(seed, cell.traffic)]


def program_infer(cell, seed, device, caps=None):
    spec, cfg, run, pool, order, model, state = harness.setup(cell, seed, device, caps)
    model.eval()
    register = harness._entry(spec["program"]["infer"])
    grab = harness.Grab(model)
    captures = []
    for pair in _infer_pairs(cell, seed, pool, order):
        raw = harness.upload(pair, device)
        out = register(model, cfg, raw)
        data, backbone = grab.take()
        captures.append({"raw": raw, "data": data, "backbone": backbone,
                         "out": {k: out[k] for k in harness.OUT_KEYS if k in out}})
    grab.remove()
    del model
    ref = check.reference_model(spec, state, device)
    return _worst(check.infer_readings(ref, c["raw"], c["data"], c["backbone"], c["out"]) for c in captures)


def control_infer(cell, seed, device, caps=None):
    spec, cfg, run, pool, order, model, state = harness.setup(cell, seed, device, caps)
    del model
    ref = check.reference_model(spec, state, device).eval()
    low = check.reference_model(spec, state, device).eval()
    kept = {}
    handle = low.backbone.register_forward_hook(lambda m, a, o: kept.__setitem__("backbone", o))
    captures = []
    with torch.no_grad():
        for pair in _infer_pairs(cell, seed, pool, order):
            raw = harness.upload(pair, device)
            data = check.control_pyramid(run.cfg, raw)
            with check.tf32(True):
                out = low(data)
            captures.append({"raw": raw, "data": data, "backbone": kept.pop("backbone"),
                             "out": {k: out[k] for k in harness.OUT_KEYS if k in out}})
    handle.remove()
    return _worst(check.infer_readings(ref, c["raw"], c["data"], c["backbone"], c["out"]) for c in captures)


def program_train(cell, seed, device, caps=None):
    spec, cfg, run, pool, order, model, state = harness.setup(cell, seed, device, caps)
    generator = harness.target_generator(seed, device)
    train_step = harness._entry(spec["program"]["train_step"])
    train_state = harness._entry(spec["program"]["train_state"])(model, cfg.optim, spec["steps_per_epoch"])
    grab = harness.Grab(model)
    steps, program = harness.train_setup_steps(model, train_state, train_step, pool, order, generator, grab,
                                               state, cell.traffic["checked"], device)
    grab.remove()
    del model, train_state
    ref = check.reference_model(spec, state, device)
    reference = check.reference_train(ref, state, steps, run.cfg.optim.lr, run.cfg.optim.weight_decay)
    readings = check.train_readings(program, reference)
    _detail(program, reference)
    for s in steps:
        for k, v in check.pyramid_readings(run.cfg, s["raw"], s["data"]).items():
            readings[k] = max(readings.get(k, 0.0), v)
    return readings


def control_train(cell, seed, device, caps=None):
    spec, cfg, run, pool, order, model, state = harness.setup(cell, seed, device, caps)
    generator = harness.target_generator(seed, device)
    del model
    steps = []
    for s in range(cell.traffic["checked"]):
        raw = harness.upload(pool[order[s]], device)
        steps.append({"raw": raw, "data": check.control_pyramid(run.cfg, raw), "generator_device": device})
    steps[0]["generator_state"] = generator.get_state()  # later steps continue its draws
    lr, wd = run.cfg.optim.lr, run.cfg.optim.weight_decay
    with check.tf32(True):
        low = check.reference_train(check.reference_model(spec, state, device), state, steps, lr, wd)
    reference = check.reference_train(check.reference_model(spec, state, device), state, steps, lr, wd)
    readings = check.train_readings(low, reference)
    _detail(low, reference)
    for s in steps:
        for k, v in check.pyramid_readings(run.cfg, s["raw"], s["data"]).items():
            readings[k] = max(readings.get(k, 0.0), v)
    return readings


def _detail(program, reference):
    """The worst leaves of each leaf-wise number and the steps' losses, on
    standard error, for the look behind a reading."""
    keep = check.moved_leaves(reference["grads"])
    for key in ("grads", "changes"):
        med = sorted(reference[key][n] for n in keep)[len(keep) // 2]
        worst = sorted(((abs(program[key].get(n, 0.0) - reference[key][n]) / max(reference[key][n], med), n,
                         program[key].get(n), reference[key][n]) for n in keep), reverse=True)[:5]
        print(json.dumps({"detail": key, "median": med, "worst": worst}), file=sys.stderr)
    left_out = sorted(set(reference["grads"]) - keep)
    print(json.dumps({"detail": "losses", "program": program["losses"], "reference": reference["losses"],
                      "leaves_left_out": left_out}), file=sys.stderr)


def _worst(readings):
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--program", action="store_true", help="the program's readings")
    parser.add_argument("--control", action="store_true", help="the control's readings")
    args = parser.parse_args(argv)
    harness.cache_environment()
    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    train = cell.traffic["mode"] == "train"
    sides = [("program", program_train if train else program_infer)] if args.program else []
    sides += [("control", control_train if train else control_infer)] if args.control else []
    for seed in args.seeds:
        for side, fn in sides:
            t = time.perf_counter()
            readings = fn(cell, seed, device)
            torch.cuda.empty_cache()
            print(json.dumps({"workload": cell.name, "seed": seed, "side": side,
                              "seconds": round(time.perf_counter() - t, 1),
                              "readings": {k: (v if v != float("inf") else "inf") for k, v in readings.items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
