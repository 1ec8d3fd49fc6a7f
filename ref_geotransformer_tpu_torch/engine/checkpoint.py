"""Checkpoints with `torch.save`, in the reference's file layout.

Counterpart of `ref_geotransformer_tpu/engine/checkpoint.py` (orbax there):

    <snapshot_dir>/epoch-<N>.pth.tar : {"model": state_dict}
    <snapshot_dir>/snapshot.pth.tar  : {"model", "optimizer" (Adam or AdamW), "count",
                                        "skipped", "generator", "epoch",
                                        "iteration"}

The optimizer state is its `state_dict()`, keyed by the position of
each parameter in the state's `params` (the model's parameter order), so it
restores onto a model of the same configuration. "generator" is the state
of the trainer's target sampler, so a resumed run draws the targets an
uninterrupted one would. Each file is written to a temporary name and
renamed into place, so a reader never sees a half-written file. Files are
loaded with `weights_only=True` onto the device the caller names.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
from torch import nn

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

    def save_epoch(self, name: str, model: nn.Module) -> None:
        """Model-only snapshot (the reference's epoch-N.pth.tar)."""
        save_file({"model": model.state_dict()}, self._path(name))

    def save_snapshot(self, model: nn.Module, state, epoch: int, iteration: int,
                      generator: Optional[torch.Generator] = None) -> None:
        """The rolling snapshot (the reference's snapshot.pth.tar)."""
        save_file({
            "model": model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "count": state.count,
            "skipped": state.skipped,
            "generator": None if generator is None else generator.get_state(),
            "epoch": epoch,
            "iteration": iteration,
        }, self._path("snapshot"))

    def load_model(self, name: str, model: nn.Module) -> nn.Module:
        """Restore the model's parameters and buffers from an epoch snapshot."""
        return load_model_file(self._path(name), model)

    def load_snapshot(self, model: nn.Module, state, generator: Optional[torch.Generator] = None
                      ) -> Tuple[int, int]:
        """Restore model, optimizer state, counts and the generator in place;
        returns (epoch, iteration)."""
        payload = load_file(self._path("snapshot"), model_device(model))
        model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.count, state.skipped = payload["count"], payload["skipped"]
        if generator is not None and payload["generator"] is not None:
            generator.set_state(payload["generator"].cpu())
        return payload["epoch"], payload["iteration"]

    def has_snapshot(self) -> bool:
        return os.path.isfile(self._path("snapshot"))

    def list_epochs(self) -> list:
        return sorted(f[: -len(SUFFIX)] for f in os.listdir(self.snapshot_dir)
                      if f.startswith("epoch-") and f.endswith(SUFFIX))
