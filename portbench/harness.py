"""One run of one cell: set-up, the measured window, the traced block, the
check against the reference, and the result line.

Everything a cell needs is found by name from `BENCHMARK.json`: its
configuration file (`portbench/configs/`), its traffic mix
(`portbench/traffic/`), the limits of its comparison (`portbench/limits/`)
and one reader per metric (`portbench/metrics/<metric>.py`, a function
`read(run)` that returns a number or None). Adding a cell, a configuration,
a mix or a metric adds files and entries; nothing here changes.

The program is driven through the entry points its configuration file names
(the model class, the inference call and, for training, the train step and
its optimizer state); the benchmark takes from it nothing but those calls,
its outputs and the profiler's view of its kernels.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check, traffic, weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "portbench", "out")
FORBIDDEN = ("jax", "jaxlib", "flax", "ref_geotransformer_tpu")


def cache_environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; no
    library that the program uses may pull in JAX."""
    cache = os.path.join(OUT, "cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _entry(path: str):
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def _json(x):
    return json.loads(json.dumps(x))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    spec: dict  # the configuration file
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


def resolve(workload: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, config["file"])) as f:
        spec = json.load(f)
    limits_path = os.path.join(root, "portbench", "limits", f"{workload}.json")
    limits = {}
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = {k: v for k, v in json.load(f).items() if not k.startswith("_")}

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(workload, cell["chips"], spec, traffic.load(root, cell["traffic"]),
                [m for m in bench["end_to_end"] if here(m)], [m for m in bench["per_layer"] if here(m)], limits)


def load_reader(name: str, root: str = ROOT):
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def program_config(spec: dict):
    """The program's configuration from the entry its file names, held to the
    sizes the file states: a program that departs from them is not the
    configuration this cell measures."""
    cfg = _entry(spec["program"]["config"])(**spec["program"]["kwargs"])
    actual = _json(dataclasses.asdict(cfg))
    if actual != spec["config"]:
        diff = sorted(k for k in set(actual) | set(spec["config"]) if actual.get(k) != spec["config"].get(k))
        raise RuntimeError(f"the program's configuration departs from {spec['name']} in {diff}")
    return cfg


class Grab:
    """Forward hooks that keep the model's input (the pyramid) and the
    backbone's output of the current pair, so a checked pair's stages can be
    compared; cleared after every other pair."""

    def __init__(self, model):
        self.data = None
        self.backbone = None
        self.handles = [
            model.register_forward_pre_hook(lambda m, args: setattr(self, "data", args[0])),
            model.backbone.register_forward_hook(lambda m, args, out: setattr(self, "backbone", out)),
        ]

    def take(self):
        got = (self.data, self.backbone)
        self.data = self.backbone = None
        return got

    def remove(self):
        for h in self.handles:
            h.remove()


def upload(pair: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in pair.items()}


OUT_KEYS = ("ref_feats_c", "src_feats_c", "ref_feats_f", "src_feats_f", "ref_node_corr_indices",
            "src_node_corr_indices", "ref_node_corr_knn_points", "src_node_corr_knn_points",
            "ref_node_corr_knn_masks", "src_node_corr_knn_masks", "matching_scores", "estimated_transform")


class Run:
    """What the metric readers see of one run."""

    def __init__(self, cell: Cell, cfg, seed: int, device):
        self.cell, self.cfg, self.seed, self.device = cell, cfg, seed, device
        self.mode = cell.traffic["mode"]
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.latencies: List[float] = []  # seconds per pair or step in the window
        self.attempted = 0
        self.failed = 0
        self.peak_window_bytes = 0
        self.trace = None  # portbench.trace.Trace of the profiled block
        self.profiled: List[dict] = []  # per profiled pair: raw pair and the program's node pairs
        self._counts = None

    def counts(self):
        """Per profiled pair: (PairCounts, matched patch blocks), from the
        reference's pyramid and partition; computed once, after the window."""
        if self._counts is None:
            from portbench.reference.pyramid import build_registration_inputs
            from portbench.work.counts import pair_counts, patch_blocks

            bb, caps = self.cfg.backbone, self.cfg.capacities
            self._counts, seen = [], {}
            for p in self.profiled:
                if p["pool_index"] not in seen:
                    raw = p["raw"]
                    data = build_registration_inputs(
                        raw["ref_points"], raw["ref_masks"], raw["src_points"], raw["src_masks"], bb.num_stages,
                        bb.init_voxel_size, bb.init_radius, caps.neighbor_limits, caps.points,
                        search_chunk=caps.search_chunk)
                    seen[p["pool_index"]] = pair_counts(data["ref"], data["src"], self.cfg)
                counts = seen[p["pool_index"]]
                self._counts.append((counts, patch_blocks(counts, p["ref_nodes"], p["src_nodes"], p["valid"])))
        return self._counts

    def step_seconds(self) -> float:
        """Mean time of a pair or step outside the profiled block."""
        return self.window_s / max(len(self.latencies), 1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def setup(cell: Cell, seed: int, device, caps=None):
    """The configuration, the pool and its send order, and the program's
    model with the seed's weights (`caps` overrides the capacities of both
    sides, for tests at a small size). Returns (spec, cfg, run, pool, order,
    model, state)."""
    spec = cell.spec
    cfg = program_config(spec)
    if caps is not None:
        spec = json.loads(json.dumps(spec))
        spec["config"]["capacities"].update(caps)
        cfg = dataclasses.replace(cfg, capacities=dataclasses.replace(
            cfg.capacities, **{k: tuple(v) if isinstance(v, list) else v for k, v in caps.items()}))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(spec["tf32"])
    from portbench.reference.config import config_from_dict

    run = Run(cell, config_from_dict(spec["config"]), seed, device)
    pool = traffic.make_pool(ROOT, cell.traffic, seed, cfg.capacities.points[0])
    order = traffic.send_order(seed, len(pool), 1 << 16)
    model = _entry(spec["program"]["model"])(cfg)
    state = weights.make_state([(n, tuple(p.shape)) for n, p in model.named_parameters()], seed, device)
    model = model.to(device)
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or set(missing) - {n for n, _ in model.named_buffers()}:
        raise RuntimeError(f"weights do not fit the program: missing {missing}, unexpected {unexpected}")
    return spec, cfg, run, pool, order, model, state


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float, caps=None) -> dict:
    """Set up, measure and check one run; returns the result's fields."""
    spec, cfg, run, pool, order, model, state = setup(cell, seed, device, caps)
    entries = spec["program"]
    grab = Grab(model)
    if run.mode == "infer":
        model.eval()
        kept, profile_step = _infer(run, cell, cfg, model, pool, order, grab, seconds, device, t0, entries)
        kept["state0"] = state
    elif run.mode == "train":
        kept, profile_step = _train(run, cell, cfg, spec, model, state, pool, order, grab, seconds, device, t0,
                                    entries)
    else:
        raise ValueError(f"unknown traffic mode {run.mode!r}")
    grab.remove()
    memory_peak = max(run.peak_window_bytes, kept.pop("setup_peak"))

    if trace:
        from portbench.trace import profile_block

        os.makedirs(OUT, exist_ok=True)
        run.trace, _ = profile_block(profile_step, cell.traffic["profiled"], model, OUT, cell.name)

    del model, profile_step
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = _check(run, spec, kept, device)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"metrics": metrics, "memory_peak_bytes": memory_peak, "checks": checks,
              "attempted": run.attempted, "failed": run.failed}
    if trace:
        result["busy_s"] = run.trace.busy_us() / 1e6
        result["window_s"] = (run.trace.window[1] - run.trace.window[0]) / 1e6
        result["breakdown"] = breakdown(run.trace)
    return result


def _infer(run, cell, cfg, model, pool, order, grab, seconds, device, t0, entries):
    register = _entry(entries["infer"])
    tr = cell.traffic
    checked = set(checked_indices(run.seed, tr))
    for i in range(tr["warmup"]):
        register(model, cfg, upload(pool[order[-1 - i]], device))
        grab.take()
    _sync(device)
    setup_peak = _peak(device)
    _reset_peak(device)
    kept = {"pairs": [], "setup_peak": setup_peak}
    run.setup_s = time.perf_counter() - t0
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 < seconds:
        start = time.perf_counter()
        pair = pool[order[i]]
        try:
            raw = upload(pair, device)
            out = register(model, cfg, raw)
            transform = out["estimated_transform"].cpu()
            if not bool(torch.isfinite(transform).all()):
                run.failed += 1
        except (RuntimeError, ValueError) as err:
            print(f"pair {i} failed: {err}", file=sys.stderr)
            run.failed += 1
            out = None
        run.latencies.append(time.perf_counter() - start)
        data, backbone = grab.take()
        if i in checked and out is not None:
            kept["pairs"].append({"raw": raw, "data": data, "backbone": backbone,
                                  "out": {k: out[k] for k in OUT_KEYS if k in out}})
        i += 1
    run.window_s = time.perf_counter() - w0
    run.attempted = i
    run.peak_window_bytes = _peak(device)

    def profile_step(j):
        index = order[i + j]
        raw = upload(pool[index], device)
        out = register(model, cfg, raw)
        out["estimated_transform"].cpu()
        run.profiled.append({"pool_index": index, "raw": raw, "ref_nodes": out["ref_node_corr_indices"],
                             "src_nodes": out["src_node_corr_indices"], "valid": None})
        grab.take()

    return kept, profile_step


def _train(run, cell, cfg, spec, model, state, pool, order, grab, seconds, device, t0, entries):
    train_step = _entry(entries["train_step"])
    train_state = _entry(entries["train_state"])(model, cfg.optim, spec["steps_per_epoch"])
    tr = cell.traffic
    generator = target_generator(run.seed, device)
    steps, program = train_setup_steps(model, train_state, train_step, pool, order, generator, grab, state,
                                       tr["checked"], device)
    _sync(device)
    setup_peak = _peak(device)
    _reset_peak(device)
    kept = {"steps": steps, "program": program, "state0": state, "setup_peak": setup_peak}
    run.failed += program["skipped"]
    run.setup_s = time.perf_counter() - t0
    w0 = time.perf_counter()
    i = tr["checked"]
    while time.perf_counter() - w0 < seconds:
        start = time.perf_counter()
        skipped = train_state.skipped
        try:
            out = train_step(model, train_state, upload(pool[order[i]], device), generator)
            if not math.isfinite(float(out["loss"])) or train_state.skipped != skipped:
                run.failed += 1
        except (RuntimeError, ValueError) as err:
            print(f"step {i} failed: {err}", file=sys.stderr)
            run.failed += 1
        run.latencies.append(time.perf_counter() - start)
        grab.take()
        i += 1
    run.window_s = time.perf_counter() - w0
    run.attempted = i - tr["checked"]
    run.peak_window_bytes = _peak(device)

    outputs = {}

    def keep_output(module, args, kwargs, output):
        outputs["out"] = output

    def profile_step(j):
        index = order[i + j]
        raw = upload(pool[index], device)
        handle = model.register_forward_hook(keep_output, with_kwargs=True)
        try:
            out = train_step(model, train_state, raw, generator)
        finally:
            handle.remove()
        float(out["loss"])
        o = outputs.pop("out")
        run.profiled.append({"pool_index": index, "raw": raw, "ref_nodes": o["ref_node_corr_indices"],
                             "src_nodes": o["src_node_corr_indices"], "valid": o["node_corr_masks"]})
        grab.take()

    return kept, profile_step


def target_generator(seed: int, device) -> torch.Generator:
    """The generator of the training targets' draws, from the seed."""
    generator = torch.Generator(device=device)
    generator.manual_seed((seed * 2654435761 + 1) % (2**63))
    return generator


def checked_indices(seed: int, tr: dict) -> List[int]:
    """The window positions whose pairs an inference run checks."""
    rng = np.random.default_rng([seed, 3])
    return sorted(int(i) for i in rng.choice(tr["checked_from"], tr["checked"], replace=False))


def train_setup_steps(model, train_state, train_step, pool, order, generator, grab, state, count, device):
    """The first `count` train steps through the program's own call, on
    distinct pairs: each step's pyramid and target draws kept for the
    reference, and the program's record (each step's loss, the first
    gradient by leaf as the optimizer gets it, the change of each leaf over
    the steps)."""
    first = {}

    def first_grads(optimizer, args, kwargs):
        if not first:
            names = {id(p): n for n, p in model.named_parameters()}
            for group in optimizer.param_groups:
                for p in group["params"]:
                    first[names[id(p)]] = float(p.grad.norm()) if p.grad is not None else 0.0

    hook = train_state.optimizer.register_step_pre_hook(first_grads)
    steps, losses = [], []
    for s in range(count):
        raw = upload(pool[order[s]], device)
        gen_state = generator.get_state()
        out = train_step(model, train_state, raw, generator)
        losses.append(float(out["loss"]))
        data, _ = grab.take()
        steps.append({"raw": raw, "data": data, "generator_state": gen_state, "generator_device": device})
    hook.remove()
    changes = {n: float((p.detach() - state[n]).norm()) for n, p in model.named_parameters()}
    program = {"losses": losses, "grads": first, "changes": changes, "skipped": train_state.skipped}
    if train_state.skipped:
        print(f"{train_state.skipped} of the first {count} updates skipped as non-finite", file=sys.stderr)
    return steps, program


def _check(run: Run, spec: dict, kept: dict, device) -> Dict[str, float]:
    """The numbers compared, each the worst over the pairs or steps checked."""
    readings: Dict[str, float] = {}

    def worst(r):
        for k, v in r.items():
            readings[k] = max(readings.get(k, 0.0), v)

    if run.mode == "infer":
        if not kept["pairs"]:
            return {"checked_pairs": 0.0}
        ref = check.reference_model(spec, kept["state0"], device)
        for p in kept["pairs"]:
            worst(check.infer_readings(ref, p["raw"], p["data"], p["backbone"], p["out"]))
    else:
        ref = check.reference_model(spec, kept["state0"], device)
        lr = run.cfg.optim.lr  # the first epoch's rate, as the program's schedule gives it
        reference = check.reference_train(ref, kept["state0"], kept["steps"], lr, run.cfg.optim.weight_decay)
        worst(check.train_readings(kept["program"], reference))
        for s in kept["steps"]:
            worst(check.pyramid_readings(run.cfg, s["raw"], s["data"]))
    return readings


def breakdown(trace) -> dict:
    """The device operations that took most time in the traced window, and
    the window's longest idle gaps by what the host was doing then."""
    lo, hi = trace.window
    by_name: Dict[str, float] = {}
    for k in trace.kernels:
        if k.end > lo and k.start < hi:
            by_name[k.name] = by_name.get(k.name, 0.0) + (k.end - k.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    main = next((r.tid for r in trace.ranges if r.name == "pb.window"), None)
    gaps = sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
    idle = [[trace.host_activity(g[0], main), (g[1] - g[0]) / 1e6] for g in gaps]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}


def power_limit() -> Optional[str]:
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 and done.stdout.strip() else None


def _num(v: float):
    return v if math.isfinite(v) else str(v)


def verdict(checks: Dict[str, float], limits: Dict[str, float]):
    """correct, and each number compared beside its limit (None where the
    cell states none); readings named "info.*" are shown, not compared."""
    compared = {name: v for name, v in checks.items() if not name.startswith("info.")}
    shown = {name: {"value": _num(v), "limit": limits.get(name)} for name, v in sorted(compared.items())}
    ok = bool(compared) and all(name in limits and v <= limits[name] for name, v in compared.items())
    return ok, shown
