"""Shared experiment CLI functions (the reference duplicates trainval/test
boilerplate per experiment dir; here it is factored once).

Counterpart of `ref_geotransformer_tpu/engine/cli.py` (ref parity: the
argparse surface of engine/base_trainer.py:21-29 and base_tester.py:15-21),
plus `--device` (default "cuda"). One process trains on one device. Data
parallelism runs one process per card in a `torch.distributed` group
(`parallel/`): launched by torchrun, or with `--multihost` and the
REF_GT_* variables, one launch per host. `--num_devices`, when given, must
equal the world size. `run_trainval` scales the learning rate by the world
size and reduces gradients over the ranks. The model starts from seeded
random weights (`cfg.seed`); the JAX `run_trainval` draws one batch from the
train loader to initialize its model, which spends one permutation of a
shuffling loader's generator, and the port spends the same, so the two CLIs
train on the same pairs in the same order.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Callable, Optional

import torch

from ref_geotransformer_tpu_torch.demo import build_model
from ref_geotransformer_tpu_torch.engine.state import TrainState
from ref_geotransformer_tpu_torch.engine.tester import SingleTester
from ref_geotransformer_tpu_torch.engine.trainer import EpochBasedTrainer
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.parallel import multihost
from ref_geotransformer_tpu_torch.parallel.mesh import make_world
from ref_geotransformer_tpu_torch.utils.common import ensure_dir


def trainval_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--resume", action="store_true", help="resume from the rolling snapshot")
    parser.add_argument("--batch_size", type=int, default=None, help="pairs per step and process")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel cards; must equal the number of processes (one per card: "
                             "torchrun --nproc_per_node=N)")
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--max_epoch", type=int, default=None, help="override cfg.optim.max_epoch")
    parser.add_argument("--multihost", action="store_true",
                        help="join a torch.distributed process group, coordinator from REF_GT_COORDINATOR / "
                             "REF_GT_NUM_PROCESSES / REF_GT_PROCESS_ID or torchrun's environment; one launch per "
                             "host (a torchrun launch joins without it)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, cuda:1, cpu); cuda is the local rank's card in a process group")
    return parser


def iter_trainval_parser() -> argparse.ArgumentParser:
    """Parser of the iteration-based trainers (ref parity:
    base_trainer.py:21-29 plus the fork's iteration knobs,
    iter_based_trainer.py:41-210)."""
    parser = trainval_parser()
    parser.add_argument("--max_iteration", type=int, default=None)
    parser.add_argument("--snapshot_steps", type=int, default=None)
    parser.add_argument("--use_modelnet", action="store_true", help="train on ModelNet pairs instead of LineMod")
    return parser


def maybe_initialize_multihost(args) -> torch.device:
    """Join the process group if `--multihost` was passed or torchrun started
    this process as one of several (a no-op without a coordinator, and on a
    second call); check `--num_devices` against the world size. Returns the
    device to train on: the local rank's card in a process group."""
    if args.multihost or multihost.torchrun_env_present():
        multihost.initialize_multihost(device=args.device)
    size = multihost.world()[1]
    if args.num_devices is not None and args.num_devices != size:
        raise ValueError(f"--num_devices {args.num_devices} in a world of {size} process(es): the port drives one "
                         f"card per process, so launch one process per card, e.g. "
                         f"torchrun --nproc_per_node={args.num_devices}")
    return multihost.local_device(args.device)


def apply_loader_sharding(*loaders) -> None:
    """DistributedSampler counterpart: point each loader at this rank's
    disjoint dataset shard (reference utils/torch.py:48-77); one shard of
    one without a process group."""
    for loader in loaders:
        if loader is not None and hasattr(loader, "num_shards"):
            multihost.apply_multihost_sharding(loader)


def run_trainval(
    cfg,
    train_loader,
    valid_loader,
    snapshot_dir: str,
    log_dir: str,
    args,
    event_dir: Optional[str] = None,
) -> EpochBasedTrainer:
    """Train `cfg.optim.max_epoch` epochs (or `--max_epoch`) on this rank's
    shards of the loaders, the learning rate times the world size; returns
    the trainer."""
    device = maybe_initialize_multihost(args)
    world = make_world(device)
    apply_loader_sharding(train_loader, valid_loader)
    ensure_dir(snapshot_dir)
    ensure_dir(log_dir)
    if args.max_epoch is not None:
        cfg = cfg.replace(optim=type(cfg.optim)(**{**cfg.optim.__dict__, "max_epoch": args.max_epoch}))
    # the JAX run_trainval draws one batch to initialize its model (its
    # engine/cli.py:100), which spends one permutation of a shuffling loader's
    # generator: spend the same, without loading pairs
    if getattr(train_loader, "shuffle", False):
        train_loader.rng.permutation(len(train_loader.dataset))
    model = build_model(cfg, device, seed=cfg.seed)
    state = TrainState(model, cfg.optim, steps_per_epoch=len(train_loader),
                       lr_scale=1.0 if world is None else float(world.size))
    trainer = EpochBasedTrainer(
        cfg,
        model,
        state,
        train_loader,
        valid_loader,
        snapshot_dir=snapshot_dir,
        log_file=osp.join(log_dir, "train.log"),
        log_steps=args.log_steps,
        seed=cfg.seed,
        event_dir=event_dir,
        world=world,
    )
    trainer.run(resume=args.resume)
    return trainer


def run_test(
    cfg,
    loader,
    snapshot_dir: str,
    snapshot_name: str,
    log_dir: str,
    after_test_step: Optional[Callable] = None,
    log_name: str = "test",
    device: str = "cuda",
) -> dict:
    """Test the epoch snapshot `snapshot_name` over `loader`, one pair at a time."""
    ensure_dir(log_dir)
    model = GeoTransformer(cfg).to(torch.device(device))
    tester = SingleTester.from_snapshot(
        cfg,
        model,
        snapshot_dir,
        snapshot_name,
        loader.iter_single(),
        after_test_step=after_test_step,
        log_file=osp.join(log_dir, f"{log_name}.log"),
    )
    return tester.run()
