"""Overfit probe: does optimizing the loss make registration metrics rise?

    python -m ref_geotransformer_tpu_torch.tools.overfit_probe [--steps 300] [--scale 0.25] [--pairs 2] \
        [--log_every 20] [--lr LR] [--out trajectory.json] [--device cuda]

Counterpart of `tools/overfit_probe.py` and of `__graft_entry__.py::
_flagship_setup`: the 3DMatch stage-4 model at its published widths, with
the point capacities scaled by `--scale` (at least 128 a level) and the
JAX probe's initial weights (those of `jax.random.key(0)`, drawn with numpy
by `utils/jax_init.py`), trains on a few fixed synthetic pairs (a sine
surface and rigidly moved subsets of it) with one guarded Adam update per
step over all pairs. Every `--log_every` steps it evaluates the pairs (losses, PIR, IR,
RRE, RTE, RMSE, RR, averaged over the pairs) and prints one JSON row with
the last step's train loss and the number of updates the non-finite guard
skipped so far; a closing line sums up the run. If the loss -> metric chain
is sound, a handful of pairs overfit to RR = 1. How many steps that takes
depends on the initial weights: the surface repeats every 2.09 m along x,
and a pair can lock on one period off, its translation 2.1 m out. From
`jax.random.key(0)`, the JAX probe's draw, 4 pairs register within 20 steps
in both packages; from keys 1-5 every run of 30 steps left one or two pairs
off, in both (`PERF.md`, PR 13; `tests/torch_port_probe_draws.py`).

The pieces: `probe_config` and `flagship_setup` (config and model),
`probe_pairs` (the raw numpy draws), `pair_inputs` (pyramids on the device,
built once) and `probe_loop` (the steps and evaluations), which `run_probe`
strings together.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ref_geotransformer_tpu_torch.config import CapacityConfig, GeoTransformerConfig
from ref_geotransformer_tpu_torch.data import pad_points
from ref_geotransformer_tpu_torch.engine.state import TrainState
from ref_geotransformer_tpu_torch.engine.steps import ensure_pyramids, eval_step, to_device, train_pairs
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4.config import make_cfg
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.utils.jax_init import jax_init_parameters


def probe_config(scale: float) -> GeoTransformerConfig:
    """The 3DMatch demo config with its point capacities scaled by `scale`
    (at least 128 a level; the label, correspondence and search sizes
    clipped to what the scaled capacities need; widths as published)."""
    cfg = make_cfg(demo=True)
    if scale == 1.0:
        return cfg
    caps = cfg.capacities
    pts = tuple(max(128, int(p * scale)) for p in caps.points)
    return cfg.replace(capacities=CapacityConfig(
        points=pts,
        neighbor_limits=caps.neighbor_limits,
        gt_candidates=min(caps.gt_candidates, pts[-1] * 4),
        correspondence_limit=min(caps.correspondence_limit, 2048),
        search_chunk=min(caps.search_chunk, 512),
    ))


def flagship_setup(scale: float, device) -> Tuple[GeoTransformerConfig, torch.nn.Module]:
    """(cfg, model): `probe_config(scale)` and the model on `device` with the
    JAX probe's initial weights, those of `jax.random.key(0)`."""
    cfg = probe_config(scale)
    model = jax_init_parameters(GeoTransformer(cfg), 0)
    return cfg, model.to(torch.device(device)).eval()


def _sine_surface(rng: np.random.Generator, n: int) -> np.ndarray:
    points = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    points[:, 2] = 0.3 * np.sin(3 * points[:, 0]) + 0.2 * points[:, 1]
    return points


def probe_pairs(cfg: GeoTransformerConfig, pairs: int) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The probe's raw pairs (ref (n, 3), src (m, 3), transform (4, 4)), f32,
    n = 3/4 of the level-0 capacity: first the sine surface of
    `default_rng(0)` and 80% of its points with the identity transform; then,
    from one `default_rng(99)`, a new surface each, Euler angles within 35
    degrees and a translation within 0.3, and two 90% subsets, the source
    moved by the transform's inverse."""
    from scipy.spatial.transform import Rotation

    n = cfg.capacities.points[0] * 3 // 4
    rng = np.random.default_rng(0)
    ref = _sine_surface(rng, n)
    out = [(ref, ref[rng.permutation(n)[: int(n * 0.8)]], np.eye(4, dtype=np.float32))]
    rng = np.random.default_rng(99)
    for _ in range(pairs - 1):
        base = _sine_surface(rng, n)
        gt = np.eye(4, dtype=np.float32)
        gt[:3, :3] = Rotation.from_euler("xyz", rng.uniform(-35, 35, 3), degrees=True).as_matrix()
        gt[:3, 3] = rng.uniform(-0.3, 0.3, 3)
        ref = base[rng.permutation(n)[: int(n * 0.9)]]
        src_sel = base[rng.permutation(n)[: int(n * 0.9)]]
        out.append((ref, (src_sel - gt[:3, 3]) @ gt[:3, :3], gt))
    return out


def pair_inputs(cfg: GeoTransformerConfig, raw: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], device
                ) -> List[Dict]:
    """Each raw pair padded to the level-0 capacity and its pyramids built on `device`."""
    cap0 = cfg.capacities.points[0]
    inputs = []
    for ref, src, gt in raw:
        ref_p, ref_m = pad_points(ref, cap0)
        src_p, src_m = pad_points(src, cap0)
        packed = {"ref_points": ref_p, "ref_masks": ref_m, "src_points": src_p, "src_masks": src_m, "transform": gt}
        inputs.append(ensure_pyramids(cfg, to_device(packed, device)))
    return inputs


def evaluate_pairs(model, inputs: Sequence[Dict]) -> Dict[str, torch.Tensor]:
    """Losses and online metrics, each the mean over the pairs (the JAX
    eval step's mean over its batch)."""
    per_pair = [eval_step(model, data) for data in inputs]
    return {key: torch.stack([m[key] for m in per_pair]).mean() for key in sorted(per_pair[0])}


def probe_loop(model, state: TrainState, inputs: Sequence[Dict], steps: int, log_every: int,
               generator: torch.Generator) -> List[Dict[str, float]]:
    """`steps` guarded Adam updates, each over all pairs (their mean loss),
    with an evaluation at every multiple of `log_every` up to `steps`.
    Prints each row as JSON (rounded to 4 digits) and returns the rows
    unrounded: the step, the evaluation, the last step's `train_loss` and
    `skipped_steps`, the guard's count of skipped updates so far."""
    rows, losses = [], None
    weights = [1.0] * len(inputs)
    for i in range(steps + 1):
        if i % log_every == 0:
            row = {"step": i, **{key: float(v) for key, v in evaluate_pairs(model, inputs).items()}}
            if losses is not None:
                row["train_loss"] = float(losses["loss"])
            row["skipped_steps"] = state.skipped
            rows.append(row)
            print(json.dumps(rounded(row)), flush=True)
        if i == steps:
            break
        losses = train_pairs(model, state, inputs, weights, generator)
    return rows


def rounded(row: Dict[str, float]) -> Dict[str, float]:
    return {key: round(v, 4) if isinstance(v, float) else v for key, v in row.items()}


def run_probe(steps: int = 300, scale: float = 0.25, pairs: int = 2, log_every: int = 20, lr: Optional[float] = None,
              out: Optional[str] = None, device="cuda") -> dict:
    """Train the flagship model on `pairs` fixed synthetic pairs and return
    the run's summary with its trajectory (rows rounded to 4 digits)."""
    device = torch.device(device)
    cfg, model = flagship_setup(scale, device)
    if lr is not None:
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr=lr))
    inputs = pair_inputs(cfg, probe_pairs(cfg, pairs), device)
    state = TrainState(model, cfg.optim, steps_per_epoch=steps)
    generator = torch.Generator(device=device).manual_seed(1)
    t0 = time.time()
    traj = probe_loop(model, state, inputs, steps, log_every, generator)
    dt = time.time() - t0
    result = {
        "tool": "overfit_probe", "steps": steps, "pairs": pairs, "scale": scale, "lr": lr or cfg.optim.lr,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "seconds": round(dt, 1), "trajectory": [rounded(row) for row in traj],
    }
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "trajectory"}))
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--scale", type=float, default=0.25)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--log_every", type=int, default=20)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--out", default=None, help="write trajectory JSON here")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run_probe(steps=args.steps, scale=args.scale, pairs=args.pairs, log_every=args.log_every, lr=args.lr,
                     out=args.out, device=args.device)


if __name__ == "__main__":
    main()
