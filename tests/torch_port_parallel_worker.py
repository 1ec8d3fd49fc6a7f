"""One rank of the 2-process gloo run of tests/test_torch_port_parallel.py.

    python -m tests.torch_port_parallel_worker <spec.pkl> <rank>

Reads the spec the test pickled (the port's tiny config, the path of the
initial state dict, the fixture tree, the uniform target keys of the global
batch, the output directory and the file store), joins a 2-rank gloo group
through the store, runs three scenarios through the port's entry points and
writes what it saw to <out>/rank<r>.pt:

* "step": run_trainval for one epoch on this rank's shard of a 2-pair tree
  (one step of a global batch of 2 pairs; pair r samples its targets with
  keys[r]), validation on the 2 val pairs, log, events and snapshots under a
  directory of this rank's own;
* "skip": one more step, in which rank 1 alone turns its gradients to NaN;
* "resume": 2 epochs straight, against 1 epoch and then --resume for the
  second, in directories both ranks share; targets from the generators.

Imports no JAX.
"""

import os
import pickle
import sys

import pytest
import torch
import torch.distributed as dist

from ref_geotransformer_tpu_torch.data import PairLoader
from ref_geotransformer_tpu_torch.data.datasets import ThreeDMatchPairDataset
from ref_geotransformer_tpu_torch.engine import cli, steps
from ref_geotransformer_tpu_torch.engine import trainer as trainer_mod
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.parallel import multihost
from tests.torch_port_utils import port_target_keys


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, names in os.walk(root) for f in names)


def _params(model):
    return {name: p.detach().clone() for name, p in model.named_parameters()}


def main(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    cfg, out = spec["cfg"], spec["out"]
    multihost.initialize_multihost(device="cpu", init_method=f"file://{spec['store']}", world_size=2, rank=rank)
    state_dict = torch.load(spec["weights"], weights_only=True)

    def model_from_spec(cfg, device, seed=0):
        model = GeoTransformer(cfg)
        model.load_state_dict(state_dict, strict=True)
        return model.to(device).eval()

    def loader(subset):
        dataset = ThreeDMatchPairDataset(spec["root"], subset, point_limit=None, use_augmentation=False, seed=cfg.seed)
        return PairLoader(dataset, cfg, batch_size=1, shuffle=False, seed=cfg.seed)

    def args(*extra):
        return cli.trainval_parser().parse_args(["--log_steps", "1", "--device", "cpu", *extra])

    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "build_model", model_from_spec)
        losses, summaries = [], []
        train_batch, inference_epoch = trainer_mod.train_batch, trainer_mod.EpochBasedTrainer.inference_epoch
        mp.setattr(trainer_mod, "train_batch", lambda *a, **k: losses.append(train_batch(*a, **k)) or losses[-1])
        mp.setattr(trainer_mod.EpochBasedTrainer, "inference_epoch",
                   lambda self: summaries.append(inference_epoch(self)) or summaries[-1])
        step_dir = os.path.join(out, f"step-rank{rank}")
        with port_target_keys(spec["keys"], lambda: rank):
            trainer = cli.run_trainval(cfg, loader("train"), loader("val"), os.path.join(step_dir, "snapshots"),
                                       step_dir, args("--max_epoch", "1"), event_dir=os.path.join(step_dir, "events"))
        results["step"] = {
            "files": _files(step_dir),
            "params": _params(trainer.model),
            "grads": {name: p.grad.clone() for name, p in trainer.model.named_parameters()},
            "losses": [{key: float(v) for key, v in step.items()} for step in losses],
            "val": list(summaries),
            "counts": (trainer.iteration, trainer.state.count, trainer.state.skipped),
            "lr_scale": trainer.state.lr_scale,
            "world": (trainer.world.rank, trainer.world.size),
            "shard": (trainer.train_loader.num_shards, trainer.train_loader.shard_index),
        }

        model, state = trainer.model, trainer.state
        before = _params(model)
        pair = steps.to_device(next(loader("train").iter_single())[0], "cpu")
        hook = None
        if rank == 1:
            hook = next(model.parameters()).register_hook(lambda g: torch.full_like(g, float("nan")))
        steps.train_pairs(model, state, [pair], [1.0], trainer.generator, trainer.world)
        if hook is not None:
            hook.remove()
        after = _params(model)
        results["skip"] = {"counts": (state.count, state.skipped),
                           "unchanged": all(torch.equal(before[name], after[name]) for name in before)}

        resume_dir = os.path.join(out, "resume")
        straight = cli.run_trainval(cfg, loader("train"), None, os.path.join(resume_dir, "a", "snapshots"),
                                    os.path.join(resume_dir, "a"), args("--max_epoch", "2"))
        cli.run_trainval(cfg, loader("train"), None, os.path.join(resume_dir, "b", "snapshots"),
                         os.path.join(resume_dir, "b"), args("--max_epoch", "1"))
        resumed = cli.run_trainval(cfg, loader("train"), None, os.path.join(resume_dir, "b", "snapshots"),
                                   os.path.join(resume_dir, "b"), args("--max_epoch", "2", "--resume"))
        results["resume"] = {
            name: {"params": _params(t.model), "optimizer": t.state.optimizer.state_dict(),
                   "counts": (t.epoch, t.iteration, t.state.count, t.state.skipped),
                   "generator": t.generator.get_state()}
            for name, t in (("straight", straight), ("resumed", resumed))}
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
