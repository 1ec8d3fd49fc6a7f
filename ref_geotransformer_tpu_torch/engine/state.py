"""Train state: Adam with coupled L2 decay, a staircase learning-rate
schedule and the non-finite-gradient guard.

Counterpart of `ref_geotransformer_tpu/engine/state.py`. `torch.optim.Adam`
with `weight_decay` adds the decay to the gradient before the moments, as
optax's `add_decayed_weights` followed by `adam` does. A step whose
gradients hold any non-finite value is skipped whole, as under
`optax.apply_if_finite`: parameters, Adam moments and the schedule's count
stay as they were.
"""

from __future__ import annotations

import torch
from torch import nn

from ref_geotransformer_tpu_torch.config import OptimConfig


def lr_at(cfg: OptimConfig, count: int, steps_per_epoch: int) -> float:
    """lr * lr_decay^(count // (lr_decay_steps * steps_per_epoch)): StepLR as
    a staircase over applied updates."""
    return cfg.lr * cfg.lr_decay ** (count // max(1, cfg.lr_decay_steps * steps_per_epoch))


class TrainState:
    """The optimizer of `model`'s parameters and its counts: `count`
    applied updates (the schedule's step) and `skipped` non-finite steps."""

    def __init__(self, model: nn.Module, cfg: OptimConfig, steps_per_epoch: int):
        if cfg.grad_acc_steps > 1:
            raise NotImplementedError("gradient accumulation (grad_acc_steps > 1) is not ported")
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.count = 0
        self.skipped = 0
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(self.params, lr=self.lr(), weight_decay=cfg.weight_decay)

    def lr(self) -> float:
        """The learning rate of the next applied update."""
        return lr_at(self.cfg, self.count, self.steps_per_epoch)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self) -> bool:
        """One Adam update from the parameters' `.grad` (a parameter the loss
        did not reach counts as a zero gradient, as under `jax.grad`), unless
        a gradient is non-finite. Returns whether the update was applied."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        finite = torch.stack([torch.isfinite(p.grad).all() for p in self.params]).all()
        if not bool(finite):
            self.skipped += 1
            self.zero_grad()
            return False
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr()
        self.optimizer.step()
        self.count += 1
        return True
