"""Convert an upstream GeoTransformer checkpoint (.pth.tar) into a model file
of the port.

Counterpart of `ref_geotransformer_tpu/utils/convert_checkpoint.py`. The
port's modules carry the upstream key names (`utils/weights.py`), so the
state dict keeps its names and layouts; the conversion only
  * strips the DDP prefix `module.` (engine/base_trainer.py:120-121);
  * drops `div_term`, which the sinusoidal embedding recomputes from its
    width (positional_embedding.py:14-17);
  * keeps the group norm's nested `<block>.norm.norm.*` (the JAX converter
    collapses it, as its flax norm is one module; the port's is a wrapper
    around `nn.GroupNorm`, models/norms.py);
  * casts every value to a contiguous f32 CPU tensor.
With an experiment named, the result is checked against that experiment's
model: keys missing from the checkpoint, keys the model lacks, and shapes
that disagree are reported, and nothing is written.

    python -m ref_geotransformer_tpu_torch.utils.convert_checkpoint \\
        geotransformer-3dmatch.pth.tar output/torch/snapshots --name epoch-40 --experiment 3dmatch

writes output/torch/snapshots/epoch-40.pth.tar ({"model": state dict}), which
`demo --snapshot <file>` and the experiments' `test --snapshot epoch-40` load
(from their snapshot directory).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

_PREFIX = "module."

EXPERIMENTS = ("3dmatch", "kitti", "modelnet")


def convert_state_dict(state_dict: Dict[str, object]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Upstream state dict (tensors or arrays) -> (the port's state dict,
    the skipped keys)."""
    state, skipped = {}, []
    for key, value in state_dict.items():
        name = key[len(_PREFIX):] if key.startswith(_PREFIX) else key
        if name.split(".")[-1] == "div_term":
            skipped.append(key)
            continue
        array = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
        state[name] = torch.from_numpy(np.array(array, dtype=np.float32, order="C"))
    return state, skipped


def experiment_model(experiment: str):
    """A GeoTransformer of the experiment's configuration, on the CPU (its
    key names and shapes, not its weights, are what the check reads)."""
    from ref_geotransformer_tpu_torch.config import kitti, modelnet, threedmatch
    from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer

    make_cfg = {"3dmatch": threedmatch.make_cfg, "kitti": kitti.make_cfg, "modelnet": modelnet.make_cfg}[experiment]
    return GeoTransformer(make_cfg())


def structure_problems(state: Dict[str, torch.Tensor], model: torch.nn.Module) -> List[str]:
    """Keys missing from `state`, keys `model` lacks, and mismatched shapes."""
    want = {key: tuple(value.shape) for key, value in model.state_dict().items()}
    problems = [f"missing from checkpoint: {key}" for key in sorted(set(want) - set(state))]
    problems += [f"not in this model: {key}" for key in sorted(set(state) - set(want))]
    problems += [f"shape mismatch at {key}: checkpoint {tuple(state[key].shape)} vs model {want[key]}"
                 for key in sorted(set(want) & set(state)) if tuple(state[key].shape) != want[key]]
    return problems


def load_upstream_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Read an upstream .pth.tar ({"model": state dict} or a bare state dict) and convert it."""
    snapshot = torch.load(path, map_location="cpu", weights_only=False)
    return convert_state_dict(snapshot.get("model", snapshot))


def main(argv=None) -> str:
    """Returns the path written."""
    from ref_geotransformer_tpu_torch.engine.checkpoint import SUFFIX, save_file

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("checkpoint", help="upstream PyTorch .pth.tar")
    parser.add_argument("snapshot_dir", help="output directory")
    parser.add_argument("--name", default=None, help="model file name (default: the checkpoint's, e.g. epoch-40)")
    parser.add_argument("--experiment", choices=EXPERIMENTS, default=None,
                        help="check the keys and shapes against this experiment's model before writing")
    args = parser.parse_args(argv)

    state, skipped = load_upstream_checkpoint(args.checkpoint)
    n_values = sum(int(value.numel()) for value in state.values())
    print(f"converted {len(state)} entries ({n_values:,} values); skipped (recomputed) keys: {skipped}")
    if args.experiment:
        problems = structure_problems(state, experiment_model(args.experiment))
        if problems:
            raise SystemExit(f"checkpoint does not match the '{args.experiment}' experiment model:\n  "
                             + "\n  ".join(problems))
        print(f"structure matches the '{args.experiment}' model")
    os.makedirs(args.snapshot_dir, exist_ok=True)
    name = args.name or os.path.basename(args.checkpoint).split(".")[0]
    path = os.path.join(os.path.abspath(args.snapshot_dir), name + SUFFIX)
    save_file({"model": state}, path)
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
