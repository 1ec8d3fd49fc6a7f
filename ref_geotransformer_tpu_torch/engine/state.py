"""Train states: Adam with coupled L2 decay under a staircase schedule, and
AdamW under any schedule of the step, both behind one non-finite-gradient
guard.

Counterpart of `ref_geotransformer_tpu/engine/state.py` and of the AdamW
state the iteration-based entry points build
(`experiments/geotransformer_modelnet_rpmnet_stage4/trainval_encoder.py:48-50`).
`torch.optim.Adam` with `weight_decay` adds the decay to the gradient before
the moments, as optax's `add_decayed_weights` followed by `adam` does;
`torch.optim.AdamW` subtracts lr * weight_decay * p beside the Adam update,
as `optax.adamw` does (decoupled decay, scaled by the scheduled rate). A
step whose gradients hold any non-finite value is skipped whole, as under
`optax.apply_if_finite`: parameters, moments and the schedule's count stay
as they were. `TrainState`'s `lr_scale` carries the reference's rule of the
learning rate times the world size (`engine/base_trainer.py:210-215`).

`grad_acc_steps` = k > 1 is the counterpart of `optax.MultiSteps(tx,
every_k_schedule=k)` around the guarded chain: mini-steps 1..k-1 fold their
gradient into a running mean (acc + (g - acc) / (n + 1), as optax) and leave
the parameters as they are; mini-step k hands the mean to the guarded
update, which moves the schedule's count only when it applies. The mean is
then reset by multiplying it with 0, as optax does, so a non-finite entry
stays non-finite and the guard skips every later update too (optax 0.2.6).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ref_geotransformer_tpu_torch.config import OptimConfig
from ref_geotransformer_tpu_torch.utils.timer import span


def lr_at(cfg: OptimConfig, count: int, steps_per_epoch: int) -> float:
    """lr * lr_decay^(count // (lr_decay_steps * steps_per_epoch)): StepLR as
    a staircase over applied updates."""
    return cfg.lr * cfg.lr_decay ** (count // max(1, cfg.lr_decay_steps * steps_per_epoch))


class GuardedState:
    """The optimizer of `model`'s parameters and its counts: `count` applied
    updates (the schedule's step) and `skipped` non-finite updates; with
    `cfg.grad_acc_steps` > 1 also `acc`, the running mean of the window's
    gradients, and `mini_step`, its length so far. A subclass gives `lr()`,
    the learning rate at `count`."""

    def __init__(self, model: nn.Module, cfg: OptimConfig, optimizer_cls, **optimizer_kwargs):
        self.cfg = cfg
        self.count = 0
        self.skipped = 0
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if cfg.grad_acc_steps > 1 else None
        self.optimizer = optimizer_cls(self.params, lr=self.lr(), **optimizer_kwargs)

    def lr(self) -> float:
        """The learning rate of the next applied update."""
        raise NotImplementedError

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self) -> bool:
        """One optimizer update from the parameters' `.grad` (a parameter the
        loss did not reach counts as a zero gradient, as under `jax.grad`),
        unless a gradient is non-finite; under gradient accumulation, one
        mini-step, which updates at the end of its window. Returns whether an
        update was applied. In the span `gt.update`: the finite test and its
        read-back in `gt.update.guard`, the optimizer's step in
        `gt.update.optimizer`."""
        with span("gt.update"):
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self.acc is not None:
                for acc, p in zip(self.acc, self.params):
                    acc.add_((p.grad - acc) / (self.mini_step + 1))
                self.mini_step = (self.mini_step + 1) % self.cfg.grad_acc_steps
                if self.mini_step:
                    self.zero_grad()
                    return False
                for acc, p in zip(self.acc, self.params):
                    p.grad = acc.clone()
                    acc.mul_(0.0)
            with span("gt.update.guard"):
                finite = bool(torch.stack([torch.isfinite(p.grad).all() for p in self.params]).all())
            if not finite:
                self.skipped += 1
                self.zero_grad()
                return False
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr()
            with span("gt.update.optimizer"):
                self.optimizer.step()
            self.count += 1
            return True


class TrainState(GuardedState):
    """Adam with coupled L2 decay, its rate a staircase over epochs, times
    `lr_scale` (the world size under data parallelism)."""

    def __init__(self, model: nn.Module, cfg: OptimConfig, steps_per_epoch: int, lr_scale: float = 1.0):
        self.steps_per_epoch = steps_per_epoch
        self.lr_scale = lr_scale
        super().__init__(model, cfg, torch.optim.Adam, weight_decay=cfg.weight_decay)

    def lr(self) -> float:
        return lr_at(self.cfg, self.count, self.steps_per_epoch) * self.lr_scale


class AdamWTrainState(GuardedState):
    """AdamW with decoupled decay, its rate `schedule(count)`."""

    def __init__(self, model: nn.Module, cfg: OptimConfig, schedule: Callable[[int], float]):
        self.schedule = schedule
        super().__init__(model, cfg, torch.optim.AdamW, weight_decay=cfg.weight_decay)

    def lr(self) -> float:
        return self.schedule(self.count)
