"""Epoch-based trainer with the reference's hook surface.

Counterpart of `ref_geotransformer_tpu/engine/trainer.py` (ref parity:
engine/epoch_based_trainer.py:16-181 + base_trainer.py:32-276): before/after
train, epoch and step hooks, SummaryBoard logging every `log_steps`, the
Timer, a per-epoch `epoch-N` snapshot and the rolling `snapshot`, resume,
the validation epoch (thinned by REF_GT_VAL_EVERY; the last epoch always
validates) and scalar events. The learning rate in the log is that of the
next applied update (`TrainState.lr()`). `profile_dir` records the steps
[profile_steps[0], profile_steps[1]) with `torch.profiler` into a Chrome
trace there.

One process drives one device. With a `world` (data parallelism, one
process per card), each rank trains on its loader's shard and the steps
reduce gradients, losses and validation metrics over the ranks; only the
primary process (rank 0) writes the log file, the events and the snapshots.
Targets are sampled from one generator on the device per rank, seeded with
`seed + rank`: rank 0 draws what a single process draws, and every rank
draws its own stream, as the JAX package gives every pair of its global
batch its own key. The generators' states are part of the snapshot.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import torch

from ref_geotransformer_tpu_torch.engine.checkpoint import CheckpointManager
from ref_geotransformer_tpu_torch.engine.state import TrainState
from ref_geotransformer_tpu_torch.engine.steps import eval_batch, train_batch
from ref_geotransformer_tpu_torch.parallel.mesh import World
from ref_geotransformer_tpu_torch.parallel.multihost import is_primary
from ref_geotransformer_tpu_torch.utils.common import get_log_string
from ref_geotransformer_tpu_torch.utils.events import EventWriter
from ref_geotransformer_tpu_torch.utils.logger import Logger
from ref_geotransformer_tpu_torch.utils.summary_board import SummaryBoard
from ref_geotransformer_tpu_torch.utils.timer import Timer


def to_floats(values: dict) -> dict:
    """Device scalars -> Python floats (waits for the device)."""
    return {key: float(value) for key, value in values.items()}


class EpochBasedTrainer:
    def __init__(
        self,
        cfg,
        model,
        state: TrainState,
        train_loader: Iterable,
        val_loader: Optional[Iterable] = None,
        snapshot_dir: str = "snapshots",
        log_file: Optional[str] = None,
        log_steps: int = 10,
        seed: int = 7351,
        profile_dir: Optional[str] = None,
        profile_steps: tuple = (10, 15),
        event_dir: Optional[str] = None,
        world: Optional[World] = None,
    ):
        self.cfg = cfg
        self.model = model
        self.state = state
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.world = world
        self.max_epoch = cfg.optim.max_epoch
        self.log_steps = log_steps
        self.epoch = 0
        self.iteration = 0
        self.device = next(model.parameters()).device

        # host-side side effects belong to rank 0 (engine/logger.py:29-33, base_trainer.py:115)
        self.primary = is_primary()
        self.logger = Logger(log_file=log_file if self.primary else None, local_rank=0 if self.primary else 1)
        self.summary_board = SummaryBoard(last_n=log_steps, adaptive=True)
        self.timer = Timer()
        self.ckpt = CheckpointManager(snapshot_dir)
        rank = 0 if world is None else world.rank
        self.generator = torch.Generator(device=self.device).manual_seed(seed + rank)
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.profiler = None
        self.events = EventWriter(event_dir, enabled=event_dir is not None and self.primary)

        # hook surface (epoch_based_trainer.py:39-70)
        self.before_train_hooks: list = []
        self.after_train_hooks: list = []
        self.before_epoch_hooks: list = []
        self.after_epoch_hooks: list = []
        self.before_step_hooks: list = []
        self.after_step_hooks: list = []

    # -- resume ----------------------------------------------------------
    def maybe_resume(self, resume: bool = False) -> None:
        if resume and self.ckpt.has_snapshot():
            self.epoch, self.iteration = self.ckpt.load_snapshot(self.model, self.state, self.generator)
            self.logger.info(f"Resumed from snapshot at epoch {self.epoch}, iteration {self.iteration}.")

    # -- profiling -------------------------------------------------------
    def _profile(self) -> None:
        if self.profile_dir is None:
            return
        if self.iteration == self.profile_steps[0]:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=activities)
            self.profiler.start()
        elif self.iteration == self.profile_steps[1]:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self.profiler is None:
            return
        self.profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace-{self.iteration}.json")
        self.profiler.export_chrome_trace(path)
        self.profiler = None
        self.logger.info(f"profiler trace written to {path}")

    # -- loops -----------------------------------------------------------
    def train_epoch(self) -> None:
        for hook in self.before_epoch_hooks:
            hook(self)
        self.timer.record()
        for batch in self.train_loader:
            self.timer.add_prepare_time()
            for hook in self.before_step_hooks:
                hook(self, batch)
            self._profile()
            losses = to_floats(train_batch(self.model, self.state, batch, self.generator, self.world))
            self.timer.add_process_time()
            self.iteration += 1
            self.summary_board.update_from_result_dict(losses)
            self.events.add_scalars(losses, self.iteration, prefix="train/")
            for hook in self.after_step_hooks:
                hook(self, losses)
            if self.iteration % self.log_steps == 0:
                message = get_log_string(
                    self.summary_board.summary(),
                    epoch=self.epoch,
                    max_epoch=self.max_epoch,
                    iteration=self.iteration,
                    lr=self.state.lr(),
                    timer=self.timer,
                )
                self.logger.info(message)
            self.timer.record()
        for hook in self.after_epoch_hooks:
            hook(self)

    def inference_epoch(self) -> dict:
        if self.val_loader is None:
            return {}
        board = SummaryBoard(adaptive=True)
        for batch in self.val_loader:
            board.update_from_result_dict(to_floats(eval_batch(self.model, batch, self.world)))
        summary = board.summary()
        self.events.add_scalars(summary, self.iteration, prefix="val/")
        self.events.flush()
        self.logger.info("[Val] " + get_log_string(summary, epoch=self.epoch))
        return summary

    def run(self, resume: bool = False) -> None:
        self.maybe_resume(resume)
        for hook in self.before_train_hooks:
            hook(self)
        val_every = int(os.environ.get("REF_GT_VAL_EVERY", "1"))
        while self.epoch < self.max_epoch:
            self.epoch += 1
            self.train_epoch()
            self.ckpt.save_epoch(f"epoch-{self.epoch}", self.model)
            self.ckpt.save_snapshot(self.model, self.state, self.epoch, self.iteration, self.generator)
            if self.epoch % val_every == 0 or self.epoch == self.max_epoch:
                self.inference_epoch()
        self._stop_profile()
        self.events.close()
        for hook in self.after_train_hooks:
            hook(self)
