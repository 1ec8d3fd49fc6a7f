"""Iteration-based trainers (the encoder's and Cordi's DDPM) and the
warmup-cosine schedule.

Counterpart of `ref_geotransformer_tpu/engine/iter_trainer.py` (ref parity:
engine/iter_based_trainer.py:19-391 and utils/torch.py:153-178):

* `make_warmup_cosine_schedule`: the learning rate warms linearly from
  lr * eta_init to lr over warmup_steps, then anneals by a cosine to
  lr * eta_min at total_steps;
* `cycle`: the train loader, epoch after epoch;
* `IterBasedEncoderTrainer`: the iteration loop, a log line every
  `log_steps`, and every `snapshot_steps` the `iter-N` model file, the
  rolling snapshot and a validation truncated to `val_iters` batches;
* `IterBasedDDPMTrainer`: the same loop over Cordi, fed by a frozen
  encoder: per iteration the encoder's inference forward on
  `ddpm_batch_size` pairs, `cordi_downsample` of each, one epsilon-loss
  AdamW step on the stacked matrices; validation samples by reverse
  diffusion and scores with `evaluate_ddpm` (PIR at top 32/16/8, IIR).

One process drives one device. The schedule is the train state's
(`AdamWTrainState.lr()`, at the count of applied updates), and the log
shows the rate of the next update. Targets (the DDPM trainer's node keys, t,
epsilon and the sampler's noise) are drawn from one generator on the
device, seeded with `seed`; its state is part of the snapshot. A
resumed run restarts the train loader's stream, as the JAX trainer does.
With `corr_dump_dir`, each validation also writes the first pair's coarse
clouds and node correspondences as PLY files there
(`utils/visualization.py::save_corr_pcd`), as the JAX trainer does.

Under `--multihost` (several processes, each on its loader's shard) only
rank 0 writes the log file and the snapshots. Nothing is reduced over the
ranks and the learning rate is not scaled: no mesh reaches the JAX
trainers' steps, so there each process updates its own replica of the
parameters, and the port does the same.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ref_geotransformer_tpu_torch.engine.checkpoint import CheckpointManager
from ref_geotransformer_tpu_torch.engine.state import GuardedState
from ref_geotransformer_tpu_torch.engine.steps import eval_batch, forward, to_device, train_batch
from ref_geotransformer_tpu_torch.engine.trainer import load_spans, to_floats
from ref_geotransformer_tpu_torch.models.cordi import Cordi, cordi_downsample
from ref_geotransformer_tpu_torch.parallel.multihost import is_primary
from ref_geotransformer_tpu_torch.utils.common import get_log_string
from ref_geotransformer_tpu_torch.utils.logger import Logger
from ref_geotransformer_tpu_torch.utils.summary_board import SummaryBoard
from ref_geotransformer_tpu_torch.utils.timer import Timer
from ref_geotransformer_tpu_torch.utils.visualization import save_corr_pcd


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
        corr_dump_dir: Optional[str] = None,
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
        self.primary = is_primary()  # rank 0 writes the log file and the snapshots
        self.logger = Logger(log_file=log_file if self.primary else None, local_rank=0 if self.primary else 1)
        self.summary_board = SummaryBoard(last_n=log_steps, adaptive=True)
        self.timer = Timer()
        self.ckpt = CheckpointManager(snapshot_dir)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.corr_dump_dir = corr_dump_dir  # validation-time correspondence PLYs (iter_based_trainer.py:137-140)

    def _dump_corr_pcd(self, batch: Dict[str, np.ndarray]) -> None:
        """The inference forward of the batch's first pair, its correspondences written as PLYs."""
        pair = to_device({key: value[0] for key, value in batch.items() if key != "_pair_masks"}, self.device)
        ratio = save_corr_pcd(forward(self.model, self.cfg, pair), self.corr_dump_dir,
                              prefix=f"iter{self.iteration}-")
        self.logger.info(f"[Val] saved correspondence PLYs (coarse IR {ratio:.3f}) to {self.corr_dump_dir}")

    def validate(self) -> Dict:
        if self.val_loader is None:
            return {}
        board = SummaryBoard(adaptive=True)
        for i, batch in enumerate(itertools.islice(iter(self.val_loader), self.val_iters)):
            board.update_from_result_dict(to_floats(eval_batch(self.model, batch)))
            if i == 0 and self.corr_dump_dir is not None:
                self._dump_corr_pcd(batch)
        summary = board.summary()
        self.logger.info("[Val] " + get_log_string(summary, iteration=self.iteration))
        return summary

    def run(self, resume: bool = False) -> None:
        if resume and self.ckpt.has_snapshot():
            _, self.iteration = self.ckpt.load_snapshot(self.model, self.state, self.generator)
            self.logger.info(f"Resumed at iteration {self.iteration}.")
        stream = load_spans(cycle(self.train_loader))
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


class GeneratorDraws:
    """The DDPM trainer's random draws, all from one generator, in the JAX
    trainer's order: the uniform node keys of `cordi_downsample`, the
    loss's (t, e_rand), the sampler's zs. The seam through which a test
    replays another run's draws."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def node_keys(self, output: Dict[str, torch.Tensor]):
        """Uniform keys for `cordi_downsample`: one per ref and per src node."""
        return tuple(torch.rand(output[f"{side}_node_masks"].shape, generator=self.generator,
                                device=output[f"{side}_node_masks"].device) for side in ("ref", "src"))

    def loss_noise(self, cordi: Cordi, x_0: torch.Tensor):
        return cordi.draw_loss_noise(x_0, self.generator)

    def sample_noise(self, cordi: Cordi, x_T: torch.Tensor) -> torch.Tensor:
        return cordi.draw_sample_noise(x_T, self.generator)


def encode_and_downsample(encoder, cfg, cordi: Cordi, pair: Dict[str, torch.Tensor], draws
                          ) -> Dict[str, torch.Tensor]:
    """The frozen encoder's inference forward on one pair (with its
    transform, so the output holds the ground-truth overlap map), then
    `cordi_downsample` at keys from `draws`."""
    output = forward(encoder, cfg, pair)
    return cordi_downsample(output, cordi.ref_sample_num, cordi.src_sample_num, *draws.node_keys(output))


def ddpm_train_step(cordi: Cordi, state: GuardedState, x_0: torch.Tensor, ctx: torch.Tensor, draws
                    ) -> torch.Tensor:
    """The epsilon-loss at noise from `draws`, its backward and one guarded
    update; returns the detached loss."""
    state.zero_grad()
    loss = cordi.loss(x_0, ctx, *draws.loss_noise(cordi, x_0))
    loss.backward()
    state.apply_gradients()
    return loss.detach()


@torch.no_grad()
def sample_pair(cordi: Cordi, d: Dict[str, torch.Tensor], draws) -> torch.Tensor:
    """Reverse diffusion of one downsampled pair from its initial matrix -> (R, S)."""
    x_T = d["init_corr_matrix"][None]
    return cordi.reverse(x_T, d["feat_matrix"][None], draws.sample_noise(cordi, x_T))[0]


def evaluate_ddpm(pred_corr_mat: np.ndarray, gt_corr_matrix: np.ndarray, init_corr_matrix: np.ndarray) -> Dict:
    """DDPMEvaluator parity (modelnet experiment loss.py:161-234): PIR at
    top-32/16/8 of the predicted matrix + init-correspondence inlier ratio."""
    gt01 = (gt_corr_matrix + 1.0) / 2.0

    def pir(k):
        r, s = pred_corr_mat.shape
        flat = pred_corr_mat.reshape(-1)
        idx = np.argpartition(-flat, min(k, flat.size) - 1)[:k]
        return float(gt01[idx // s, idx % s].mean())

    init_i, init_j = np.nonzero(init_corr_matrix == 1.0)
    iir = float(gt01[init_i, init_j].mean()) if init_i.size else 0.0
    return {"PIR": pir(32), "PIR_0.5": pir(16), "PIR_0.25": pir(8), "IIR": iir}


def ddpm_metrics(pred: torch.Tensor, d: Dict[str, torch.Tensor]) -> Dict:
    """`evaluate_ddpm` of a sampled matrix against its pair's matrices."""
    return evaluate_ddpm(pred.cpu().numpy(), d["gt_corr_matrix"].cpu().numpy(), d["init_corr_matrix"].cpu().numpy())


class IterBasedDDPMTrainer:
    """Frozen encoder + Cordi DDPM training (iter_based_trainer.py:213-391).

    The encoder is put in eval mode with its gradients off and only runs
    its inference forward; `state` holds Cordi's parameters alone.
    """

    def __init__(
        self,
        cfg,
        encoder,
        cordi: Cordi,
        state: GuardedState,
        train_loader: Iterable,
        val_loader: Optional[Iterable] = None,
        max_iteration: int = 100000,
        snapshot_steps: int = 2000,
        val_iters: int = 20,
        ddpm_batch_size: int = 1,
        snapshot_dir: str = "snapshots/ddpm",
        log_file: Optional[str] = None,
        log_steps: int = 10,
        seed: int = 7351,
    ):
        self.cfg = cfg
        self.encoder = encoder.eval().requires_grad_(False)
        self.cordi = cordi
        self.state = state
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.max_iteration = max_iteration
        self.snapshot_steps = snapshot_steps
        self.val_iters = val_iters
        self.ddpm_batch_size = ddpm_batch_size
        self.log_steps = log_steps
        self.iteration = 0
        self.device = next(cordi.parameters()).device
        self.primary = is_primary()  # rank 0 writes the log file and the snapshots
        self.logger = Logger(log_file=log_file if self.primary else None, local_rank=0 if self.primary else 1)
        self.summary_board = SummaryBoard(last_n=log_steps, adaptive=True)
        self.timer = Timer()
        self.ckpt = CheckpointManager(snapshot_dir)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.draws = GeneratorDraws(self.generator)

    def encode(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The downsampled matrices of a loader batch's first pair (the JAX trainer's x[0])."""
        pair = to_device({key: value[0] for key, value in batch.items() if key != "_pair_masks"}, self.device)
        return encode_and_downsample(self.encoder, self.cfg, self.cordi, pair, self.draws)

    def validate(self) -> Dict:
        """Encoder -> reverse diffusion -> evaluate_ddpm over `val_iters` pairs."""
        if self.val_loader is None:
            return {}
        board = SummaryBoard(adaptive=True)
        for batch in itertools.islice(iter(self.val_loader), self.val_iters):
            d = self.encode(batch)
            board.update_from_result_dict(ddpm_metrics(sample_pair(self.cordi, d, self.draws), d))
        summary = board.summary()
        self.logger.info("[Val] " + get_log_string(summary, iteration=self.iteration))
        return summary

    def run(self, resume: bool = False) -> None:
        if resume and self.ckpt.has_snapshot():
            _, self.iteration = self.ckpt.load_snapshot(self.cordi, self.state, self.generator)
            self.logger.info(f"Resumed at iteration {self.iteration}.")
        stream = load_spans(cycle(self.train_loader))
        self.timer.record()
        while self.iteration < self.max_iteration:
            ds = [self.encode(next(stream)) for _ in range(self.ddpm_batch_size)]
            x_0 = torch.stack([d["gt_corr_matrix"] for d in ds])
            ctx = torch.stack([d["feat_matrix"] for d in ds])
            self.timer.add_prepare_time()
            loss = float(ddpm_train_step(self.cordi, self.state, x_0, ctx, self.draws))
            self.timer.add_process_time()
            self.iteration += 1
            self.summary_board.update_from_result_dict({"loss": loss})
            if self.iteration % self.log_steps == 0:
                self.logger.info(get_log_string(self.summary_board.summary(), iteration=self.iteration,
                                                max_iteration=self.max_iteration, lr=self.state.lr(),
                                                timer=self.timer))
            if self.iteration % self.snapshot_steps == 0:
                # the rolling snapshot after the validation, whose draws it
                # then holds: a resumed run draws what an uninterrupted one would
                self.ckpt.save_epoch(f"iter-{self.iteration}", self.cordi)
                self.validate()
                self.ckpt.save_snapshot(self.cordi, self.state, 0, self.iteration, self.generator)
            self.timer.record()
