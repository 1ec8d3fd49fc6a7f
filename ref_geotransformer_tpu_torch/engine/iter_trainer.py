"""Iteration-based encoder trainer and the warmup-cosine schedule.

Counterpart of `ref_geotransformer_tpu/engine/iter_trainer.py` (ref parity:
engine/iter_based_trainer.py:19-210 and utils/torch.py:153-178):

* `make_warmup_cosine_schedule`: the learning rate warms linearly from
  lr * eta_init to lr over warmup_steps, then anneals by a cosine to
  lr * eta_min at total_steps;
* `cycle`: the train loader, epoch after epoch;
* `IterBasedEncoderTrainer`: the iteration loop, a log line every
  `log_steps`, and every `snapshot_steps` the `iter-N` model file, the
  rolling snapshot and a validation truncated to `val_iters` batches.

One process drives one device. The schedule is the train state's
(`AdamWTrainState.lr()`, at the count of applied updates), and the log
shows the rate of the next update. Targets are sampled from one generator
on the device, seeded with `seed`; its state is part of the snapshot. A
resumed run restarts the train loader's stream, as the JAX trainer does.
The JAX trainer's optional correspondence PLY dump (`corr_dump_dir`) is not
ported.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ref_geotransformer_tpu_torch.engine.checkpoint import CheckpointManager
from ref_geotransformer_tpu_torch.engine.state import GuardedState
from ref_geotransformer_tpu_torch.engine.steps import eval_batch, train_batch
from ref_geotransformer_tpu_torch.engine.trainer import to_floats
from ref_geotransformer_tpu_torch.utils.common import get_log_string
from ref_geotransformer_tpu_torch.utils.logger import Logger
from ref_geotransformer_tpu_torch.utils.summary_board import SummaryBoard
from ref_geotransformer_tpu_torch.utils.timer import Timer


def make_warmup_cosine_schedule(lr: float, total_steps: int, warmup_steps: int, eta_init: float = 0.1,
                                eta_min: float = 0.1):
    """step -> learning rate (utils/torch.py:153-170 parity), evaluated in
    float32 in the JAX package's order of operations (its cosine correctly
    rounded to float32), so the two agree to float32 rounding."""
    f32 = np.float32
    warm_slope = f32((1.0 - eta_init) / warmup_steps)
    span = f32(max(total_steps - warmup_steps, 1))
    half_range = f32(0.5 * (1.0 - eta_min))

    def schedule(step: int) -> float:
        s = f32(step)
        if s < f32(warmup_steps):
            factor = f32(eta_init) + warm_slope * s
        else:
            t = np.clip((s - f32(warmup_steps)) / span, f32(0.0), f32(1.0))
            factor = f32(eta_min) + half_range * (f32(1.0) + f32(math.cos(f32(np.pi) * t)))
        return float(f32(lr) * factor)

    return schedule


def cycle(loader: Iterable):
    """Infinite dataloader (engine/iter_based_trainer.py:19-38)."""
    while True:
        yield from loader


class IterBasedEncoderTrainer:
    """Iteration-based GeoTransformer training (iter_based_trainer.py:41-210)."""

    def __init__(
        self,
        cfg,
        model,
        state: GuardedState,
        train_loader: Iterable,
        val_loader: Optional[Iterable] = None,
        max_iteration: int = 100000,
        snapshot_steps: int = 2000,
        val_iters: int = 100,
        snapshot_dir: str = "snapshots/encoder",
        log_file: Optional[str] = None,
        log_steps: int = 10,
        seed: int = 7351,
    ):
        self.cfg = cfg
        self.model = model
        self.state = state
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.max_iteration = max_iteration
        self.snapshot_steps = snapshot_steps
        self.val_iters = val_iters
        self.log_steps = log_steps
        self.iteration = 0
        self.device = next(model.parameters()).device
        self.logger = Logger(log_file=log_file)
        self.summary_board = SummaryBoard(last_n=log_steps, adaptive=True)
        self.timer = Timer()
        self.ckpt = CheckpointManager(snapshot_dir)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def validate(self) -> Dict:
        if self.val_loader is None:
            return {}
        board = SummaryBoard(adaptive=True)
        for batch in itertools.islice(iter(self.val_loader), self.val_iters):
            board.update_from_result_dict(to_floats(eval_batch(self.model, batch)))
        summary = board.summary()
        self.logger.info("[Val] " + get_log_string(summary, iteration=self.iteration))
        return summary

    def run(self, resume: bool = False) -> None:
        if resume and self.ckpt.has_snapshot():
            _, self.iteration = self.ckpt.load_snapshot(self.model, self.state, self.generator)
            self.logger.info(f"Resumed at iteration {self.iteration}.")
        stream = cycle(self.train_loader)
        self.timer.record()
        while self.iteration < self.max_iteration:
            batch = next(stream)
            self.timer.add_prepare_time()
            losses = to_floats(train_batch(self.model, self.state, batch, self.generator))
            self.timer.add_process_time()
            self.iteration += 1
            self.summary_board.update_from_result_dict(losses)
            if self.iteration % self.log_steps == 0:
                self.logger.info(get_log_string(self.summary_board.summary(), iteration=self.iteration,
                                                max_iteration=self.max_iteration, lr=self.state.lr(),
                                                timer=self.timer))
            if self.iteration % self.snapshot_steps == 0:
                self.ckpt.save_epoch(f"iter-{self.iteration}", self.model)
                self.ckpt.save_snapshot(self.model, self.state, 0, self.iteration, self.generator)
                self.validate()
            self.timer.record()
