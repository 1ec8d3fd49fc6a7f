"""Shared experiment CLI functions (the reference duplicates trainval/test
boilerplate per experiment dir; here it is factored once).

Counterpart of `ref_geotransformer_tpu/engine/cli.py` (ref parity: the
argparse surface of engine/base_trainer.py:21-29 and base_tester.py:15-21),
plus `--device` (default "cuda"). One process trains on one device:
`--num_devices` above 1 and `--multihost` raise NotImplementedError, so
the learning rate's world-size scale is 1. The model starts from seeded
random weights (`cfg.seed`); the JAX `run_trainval` draws one batch from the
train loader to initialize its model, which the port does not need, so the two
trainers' first epochs take the loader's permutations in another order.
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
from ref_geotransformer_tpu_torch.utils.common import ensure_dir


def trainval_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--resume", action="store_true", help="resume from the rolling snapshot")
    parser.add_argument("--batch_size", type=int, default=None, help="pairs per step")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel devices (only 1: data parallelism is not ported)")
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--max_epoch", type=int, default=None, help="override cfg.optim.max_epoch")
    parser.add_argument("--multihost", action="store_true", help="not ported: raises NotImplementedError")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
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


def check_single_device(args) -> None:
    if (args.num_devices or 1) > 1 or args.multihost:
        raise NotImplementedError("data-parallel and multi-host training (--num_devices > 1, --multihost) are not "
                                  "ported yet (ROADMAP, queue 1, item 5: data parallelism)")


def run_trainval(
    cfg,
    train_loader,
    valid_loader,
    snapshot_dir: str,
    log_dir: str,
    args,
    event_dir: Optional[str] = None,
) -> EpochBasedTrainer:
    """Train `cfg.optim.max_epoch` epochs (or `--max_epoch`); returns the trainer."""
    check_single_device(args)
    ensure_dir(snapshot_dir)
    ensure_dir(log_dir)
    if args.max_epoch is not None:
        cfg = cfg.replace(optim=type(cfg.optim)(**{**cfg.optim.__dict__, "max_epoch": args.max_epoch}))
    model = build_model(cfg, torch.device(args.device), seed=cfg.seed)
    state = TrainState(model, cfg.optim, steps_per_epoch=len(train_loader))
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
