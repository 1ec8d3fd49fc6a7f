"""Checkpoints with `torch.save`, in the reference's file layout.

Counterpart of `ref_geotransformer_tpu/engine/checkpoint.py` (orbax there):

    <snapshot_dir>/epoch-<N>.pth.tar : {"model": state_dict}
    <snapshot_dir>/snapshot.pth.tar  : {"model", "optimizer" (Adam or AdamW), "count",
                                        "skipped", "mini_step", "acc", "generator",
                                        "epoch", "iteration"}

The optimizer state is its `state_dict()`, keyed by the position of
each parameter in the state's `params` (the model's parameter order), so it
restores onto a model of the same configuration; "mini_step" and "acc" are
the gradient accumulation's window ("acc" None without one). "generator" is
the list of every rank's state of the trainer's target sampler, gathered to
rank 0, so each rank of a resumed run draws the targets an uninterrupted one
would. Rank 0 writes, every rank reads, and every rank waits at a barrier
after each write, so none reads a file before it is there. Each file is
written to a temporary name and renamed into place, so a reader never sees
a half-written file. Files are loaded with `weights_only=True` onto the
device the caller names.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ref_geotransformer_tpu_torch.parallel.multihost import is_primary, world

SUFFIX = ".pth.tar"


def save_file(payload: dict, path: str) -> None:
    """torch.save to `path` through a temporary file and `os.replace`."""
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_file(path: str, device) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def load_model_file(path: str, model: nn.Module) -> nn.Module:
    """Load the "model" state dict of a checkpoint file into `model` (strict)."""
    model.load_state_dict(load_file(path, model_device(model))["model"], strict=True)
    return model


class CheckpointManager:
    def __init__(self, snapshot_dir: str):
        self.snapshot_dir = os.path.abspath(snapshot_dir)
        os.makedirs(self.snapshot_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.snapshot_dir, name + SUFFIX)

    def _save(self, payload: dict, name: str) -> None:
        """Rank 0 writes; every rank then waits for it."""
        if is_primary():
            save_file(payload, self._path(name))
        if dist.is_initialized():
            dist.barrier()

    def save_epoch(self, name: str, model: nn.Module) -> None:
        """Model-only snapshot (the reference's epoch-N.pth.tar)."""
        self._save({"model": model.state_dict()}, name)

    def save_snapshot(self, model: nn.Module, state, epoch: int, iteration: int,
                      generator: Optional[torch.Generator] = None) -> None:
        """The rolling snapshot (the reference's snapshot.pth.tar). Every rank
        calls it: the generators' states are gathered to rank 0."""
        generators = [None if generator is None else generator.get_state()]
        if dist.is_initialized():
            generators = [None] * world()[1]
            dist.all_gather_object(generators, None if generator is None else generator.get_state())
        self._save({
            "model": model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "count": state.count,
            "skipped": state.skipped,
            "mini_step": state.mini_step,
            "acc": state.acc,
            "generator": generators,
            "epoch": epoch,
            "iteration": iteration,
        }, "snapshot")

    def load_model(self, name: str, model: nn.Module) -> nn.Module:
        """Restore the model's parameters and buffers from an epoch snapshot."""
        return load_model_file(self._path(name), model)

    def load_snapshot(self, model: nn.Module, state, generator: Optional[torch.Generator] = None
                      ) -> Tuple[int, int]:
        """Restore model, optimizer state, counts, the accumulation window and
        this rank's generator in place; returns (epoch, iteration)."""
        payload = load_file(self._path("snapshot"), model_device(model))
        model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.count, state.skipped, state.mini_step = payload["count"], payload["skipped"], payload["mini_step"]
        if state.acc is not None:
            for acc, saved in zip(state.acc, payload["acc"]):
                acc.copy_(saved)
        rank, size = world()
        if len(payload["generator"]) != size:
            raise ValueError(f"the snapshot holds {len(payload['generator'])} ranks' generators, the world has {size}")
        if generator is not None and payload["generator"][rank] is not None:
            generator.set_state(payload["generator"][rank].cpu())
        return payload["epoch"], payload["iteration"]

    def has_snapshot(self) -> bool:
        return os.path.isfile(self._path("snapshot"))

    def list_epochs(self) -> list:
        return sorted(f[: -len(SUFFIX)] for f in os.listdir(self.snapshot_dir)
                      if f.startswith("epoch-") and f.endswith(SUFFIX))
