"""The overfit probe in the JAX slow test's regime from several initial draws.

    JAX_PLATFORMS=cpu python tests/torch_port_probe_draws.py jax 1,2
    python tests/torch_port_probe_draws.py port 0,1,2 [--device cuda]
    python tests/torch_port_probe_draws.py port-init 0,1,2 [--device cuda]
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python tests/torch_port_probe_draws.py port 0,0 --device cuda --deterministic

Runs `tests/test_overfit_registration.py`'s probe (scale 0.06, 4 pairs, 30
steps, an evaluation every 5, lr 1e-4) once for each key in the list:

* `jax`: the JAX `tools/overfit_probe.py::run_probe` as it stands, with
  `create_train_state` drawing the weights from `jax.random.key(KEY)` in
  place of `key(0)` (nothing else changes);
* `port`: the port's `tools/overfit_probe.py::run_probe` from the same
  draw (`utils/jax_init.py::jax_init_parameters(model, KEY)`);
* `port-init`: the port's `run_probe` from the port's own random weights,
  `utils/weights.py::init_parameters` with a generator seeded with KEY.

A key may repeat: on the card, atomics make two runs from one draw part
after a few steps, unless `--deterministic` (torch's deterministic
algorithms, refusing any operation without one; cuBLAS needs the
`CUBLAS_WORKSPACE_CONFIG` above). The target draws are each package's
own (JAX `key(1)`, a torch generator seeded with 1), so the JAX and port
rows of one key part after a few steps. After each run it prints one JSON line: the source, the key, RR at every
evaluation, RR over the last 3 evaluations, best RMSE, the first and last
logged train loss and whether the slow test's gates hold. `--out FILE`
collects those lines in a JSON list. Only this file imports both packages
in one repository process; each `jax` run imports the JAX tool, which puts
an experiment directory on `sys.path`, so give it a process of its own.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGIME = {"steps": 30, "scale": 0.06, "pairs": 4, "log_every": 5, "lr": 1e-4}


def _jax_run(key):
    import jax

    import ref_geotransformer_tpu.engine as engine
    from tools.overfit_probe import run_probe

    create = engine.create_train_state
    engine.create_train_state = lambda *args, rng=None, **kwargs: create(*args, rng=jax.random.key(key), **kwargs)
    try:
        return run_probe(**REGIME)
    finally:
        engine.create_train_state = create


def _port_run(key, device, own_init, deterministic):
    import torch

    from ref_geotransformer_tpu_torch.tools import overfit_probe as probe
    from ref_geotransformer_tpu_torch.utils.weights import init_parameters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    draw = probe.jax_init_parameters
    if own_init:
        probe.jax_init_parameters = lambda model, seed: init_parameters(model, torch.Generator().manual_seed(key))
    else:
        probe.jax_init_parameters = lambda model, seed: draw(model, key)
    torch.use_deterministic_algorithms(deterministic)
    try:
        return probe.run_probe(**REGIME, device=device)
    finally:
        probe.jax_init_parameters = draw
        torch.use_deterministic_algorithms(False)


def summary(source, key, result, seconds):
    """The slow test's gates on one trajectory (tests/test_overfit_registration.py)."""
    traj = result["trajectory"]
    window = traj[-3:]
    mean_rr = sum(row["RR"] for row in window) / len(window)
    best_rmse = min(row["RMSE"] for row in traj)
    gates = (all(row["skipped_steps"] <= 0 for row in traj) and traj[-1]["train_loss"] < traj[1]["train_loss"]
             and mean_rr >= 0.9 and best_rmse < 0.1)
    return {"source": source, "key": key, "device": result.get("device", "cpu"), "rr": [row["RR"] for row in traj],
            "rr_last3": round(mean_rr, 4), "best_rmse": best_rmse, "train_loss_first": traj[1]["train_loss"],
            "train_loss_last": traj[-1]["train_loss"], "gates_hold": gates, "seconds": round(seconds, 1)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("source", choices=("jax", "port", "port-init"))
    parser.add_argument("keys", help="comma-separated keys or seeds")
    parser.add_argument("--device", default="cpu", help="the port's device (cpu, cuda)")
    parser.add_argument("--deterministic", action="store_true", help="the port with deterministic algorithms")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    rows = []
    for key in (int(k) for k in args.keys.split(",")):
        t0 = time.time()
        if args.source == "jax":
            result = _jax_run(key)
        else:
            result = _port_run(key, args.device, args.source == "port-init", args.deterministic)
        rows.append({**summary(args.source, key, result, time.time() - t0), "deterministic": args.deterministic})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
