"""PyTorch port: the LineMod encoder experiment's trainer, entry points and optimizer.

* `make_warmup_cosine_schedule` against the JAX package's, every step;
* `AdamWTrainState` against `apply_if_finite(optax.adamw(schedule, wd))`,
  a non-finite step included;
* the 3-iteration loss trajectory of `IterBasedEncoderTrainer` against the
  JAX package's, on the same LineMod fixture frames (with augmentation),
  weights and target keys, on a tiny config whose decay and warmup make
  both the decoupled decay and both branches of the schedule count; a port
  with coupled L2 (plain Adam) misses the same bound;
* a resumed iteration run equals an uninterrupted one;
* `trainval_encoder` and `test` in process on the CPU (LineMod and
  ModelNet); a missing `--cordi_snapshot` file and data parallelism raise
  (the Cordi chain is tests/test_torch_port_cordi.py's).

The JAX side runs jitted at `jax.default_matmul_precision("highest")`.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from ref_geotransformer_tpu.data import PairLoader as JaxPairLoader
from ref_geotransformer_tpu.data.datasets.linemod import LMODataset as JaxLMODataset
from ref_geotransformer_tpu.engine.iter_trainer import IterBasedEncoderTrainer as JaxIterTrainer
from ref_geotransformer_tpu.engine.iter_trainer import make_warmup_cosine_schedule as jax_schedule
from ref_geotransformer_tpu.engine.state import TrainState as JaxTrainState
from ref_geotransformer_tpu.engine.state import guard_nonfinite
from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu.models import init_model_variables
from ref_geotransformer_tpu_torch.data import PairLoader
from ref_geotransformer_tpu_torch.data.datasets.linemod import LMODataset
from ref_geotransformer_tpu_torch.engine import iter_trainer
from ref_geotransformer_tpu_torch.engine.steps import ensure_pyramids, unstack_batch
from ref_geotransformer_tpu_torch.engine.iter_trainer import IterBasedEncoderTrainer, make_warmup_cosine_schedule
from ref_geotransformer_tpu_torch.engine.state import AdamWTrainState, GuardedState
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import config as exp_config
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import test as exp_test
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import trainval_encoder
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4.fixture import (
    make_linemod_tree,
    make_modelnet_tree,
)
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.models.losses import overall_loss
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables, init_parameters, load_jax_variables
from tests.test_torch_port_linemod import ENV_KEYS, _jax_experiment_config
from tests.torch_port_utils import assert_close, jax_target_keys, port_config, port_target_keys

LOSS_RTOL = 1e-4  # per-iteration losses of the two trainers, relative
# the schedule, relative: both evaluate it in float32 in the same order; the
# JAX package's float32 cosine (XLA's) is one ulp off the correctly rounded
# value at a few arguments, which moves the rate by up to 0.45 ulp(1) / eta_min
# ~ 2.7e-7 where 1 + cos nears 0 (measured 1.5e-7 over the published 100k
# horizon, 8e-8 over the short ones)
SCHEDULE_RTOL = 1e-7
PUBLISHED_SCHEDULE_RTOL = 3e-7
ITERATIONS = 3
POINTS_LIMIT = 300  # raw points per cloud in the tiny runs
# the tiny trajectory: the published rate under a decay large enough that
# coupled and decoupled decay part within three iterations, and a warmup of
# one step, so that the second and third updates run on the cosine branch
TINY_OPTIM = dict(lr=1e-4, weight_decay=1.0, warmup_steps=1, max_iteration=ITERATIONS, eta_init=0.1, eta_min=0.1)


def tiny_linemod_config(**optim):
    """The JAX experiment config (LineMod geometry: voxel 0.003, 3 stages,
    fine level 0) at tiny widths, its capacities cut for POINTS_LIMIT-point
    clouds (the box's mesh sample fills levels 1 and 2, as the published
    capacities fill with 1000 points); every node pair gets its exact
    overlap (gt_candidates = 128 * 128)."""
    from ref_geotransformer_tpu.config import CapacityConfig

    cfg = _jax_experiment_config().make_cfg()
    return cfg.replace(
        capacities=CapacityConfig(points=(320, 256, 128), neighbor_limits=(32, 32, 32), gt_candidates=128 * 128,
                                  correspondence_limit=512, search_chunk=128),
        backbone=dataclasses.replace(cfg.backbone, init_dim=16, group_norm=8, output_dim=64),
        geotransformer=dataclasses.replace(cfg.geotransformer, input_dim=128, hidden_dim=48, output_dim=64,
                                           blocks=("self", "cross", "self", "cross")),
        model=dataclasses.replace(cfg.model, num_points_in_patch=16, num_sinkhorn_iterations=20),
        coarse_matching=dataclasses.replace(cfg.coarse_matching, num_targets=16, num_correspondences=16),
        optim=dataclasses.replace(cfg.optim, **optim),
    )


# ---------------------------------------------------------------------------
# Schedule and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(1e-4, 100, 10, 0.1, 0.1), (3e-3, 40, 25, 0.05, 0.2), (1e-3, 5, 8, 0.1, 0.0)])
def test_schedule_matches_jax(args):
    """Warmup, the cosine, and past the horizon (clipped); the last case
    has total_steps < warmup_steps."""
    ours, theirs = make_warmup_cosine_schedule(*args), jax_schedule(*args)
    steps = range(0, args[1] + 20)
    got = np.array([ours(s) for s in steps])
    want = np.array([float(theirs(s)) for s in steps])
    nonzero = want != 0
    print(f"schedule {args}: largest relative difference {np.max(np.abs(got - want)[nonzero] / want[nonzero]):.2e}")
    np.testing.assert_allclose(got, want, rtol=SCHEDULE_RTOL, atol=0)
    assert got[0] == pytest.approx(args[0] * args[3])
    assert got[-1] == pytest.approx(args[0] * args[4])


def test_schedule_matches_jax_over_the_published_horizon():
    """lr 1e-4, 10k warmup, 100k iterations: every 37th step from the end of
    the warmup to past the horizon."""
    args = (1e-4, 100000, 10000, 0.1, 0.1)
    ours, theirs = make_warmup_cosine_schedule(*args), jax_schedule(*args)
    steps = range(9990, 100010, 37)
    got = np.array([ours(s) for s in steps])
    want = np.array([float(theirs(s)) for s in steps])
    print(f"schedule {args}: largest relative difference {np.max(np.abs(got - want) / want):.2e}")
    np.testing.assert_allclose(got, want, rtol=PUBLISHED_SCHEDULE_RTOL, atol=0)


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(3, 2)


def test_adamw_matches_optax_adamw():
    """Four updates with gradients given, the second non-finite: skipped
    whole, so the moments and the schedule's count stay; the parameters
    after each step equal optax's, whose decay is decoupled."""
    from ref_geotransformer_tpu.config import OptimConfig as JaxOptimConfig

    rng = np.random.default_rng(4)
    params = {"dense": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                        "bias": rng.normal(size=(2,)).astype(np.float32)}}
    grads = [{"dense": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                        "bias": rng.normal(size=(2,)).astype(np.float32)}} for _ in range(4)]
    grads[1]["dense"]["kernel"][0, 1] = np.inf
    cfg = JaxOptimConfig(lr=1e-2, weight_decay=0.3, warmup_steps=2, max_iteration=5)
    schedule_args = (cfg.lr, cfg.max_iteration, cfg.warmup_steps, cfg.eta_init, cfg.eta_min)
    tx = guard_nonfinite(optax.adamw(jax_schedule(*schedule_args), weight_decay=cfg.weight_decay))
    jax_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jax.tree_util.tree_map(jnp.asarray, params),
                              buffers={}, opt_state=tx.init(params), tx=tx)
    model = _Tiny()
    model.load_state_dict(from_jax_variables({"params": params}), strict=True)
    state = AdamWTrainState(model, port_config(cfg), make_warmup_cosine_schedule(*schedule_args))
    applied = []
    for step_grads in grads:
        jax_state = jax_state.apply_gradients(jax.tree_util.tree_map(jnp.asarray, step_grads))
        for name, g in from_jax_variables({"params": step_grads}).items():
            dict(model.named_parameters())[name].grad = g.clone()
        applied.append(state.apply_gradients())
        want = from_jax_variables({"params": jax.device_get(jax_state.params)})
        for name, p in model.named_parameters():
            assert_close(p.detach(), want[name], name=f"{name} after {len(applied)} steps")
    assert applied == [True, False, True, True]
    assert (state.count, state.skipped) == (3, 1)
    assert state.lr() == pytest.approx(make_warmup_cosine_schedule(*schedule_args)(3))
    assert state.optimizer.param_groups[0]["weight_decay"] == cfg.weight_decay


# ---------------------------------------------------------------------------
# Loss trajectory against the JAX trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def linemod_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm")
    make_linemod_tree(str(root / "linemod"), n_train=3, n_test=2)
    return str(root)


def _lmo(package_dataset, root, cfg, mode="train", augment=True):
    return package_dataset(root, reload_data=True, data_augmentation=augment, points_limit=POINTS_LIMIT, mode=mode,
                           seed=cfg.seed)


def _schedule_args(cfg):
    o = cfg.optim
    return o.lr, o.max_iteration, o.warmup_steps, o.eta_init, o.eta_min


def _jax_trajectory(cfg, root, keys, snapshot_dir):
    """ITERATIONS iterations of the JAX trainer under AdamW; the i-th
    iteration's targets are drawn with keys[i]. Returns (initial variables,
    the parameters each iteration started from, per-iteration losses,
    number of draws, final step)."""
    loader = JaxPairLoader(_lmo(JaxLMODataset, root, cfg), cfg, batch_size=1, shuffle=True, seed=cfg.seed)
    model = JaxGeoTransformer(cfg)
    variables = jax.device_get(init_model_variables(model, cfg, jax.random.key(cfg.seed)))
    schedule = jax_schedule(*_schedule_args(cfg))
    tx = guard_nonfinite(optax.adamw(schedule, weight_decay=cfg.optim.weight_decay))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"], buffers=variables["buffers"],
                          opt_state=tx.init(variables["params"]), tx=tx)
    trainer = JaxIterTrainer(cfg, model, state, schedule, loader, None, max_iteration=ITERATIONS,
                             snapshot_steps=1000, snapshot_dir=snapshot_dir, log_steps=1, seed=cfg.seed)
    params, losses, step = [], [], trainer.train_step

    def recording_step(s, batch, rng):
        params.append(jax.device_get(s.params))  # before the step, which donates s
        s, step_losses = step(s, batch, rng)
        losses.append({key: float(value) for key, value in jax.device_get(step_losses).items()})
        return s, step_losses

    trainer.train_step = recording_step
    with jax_target_keys(keys) as order:
        with jax.default_matmul_precision("highest"):
            trainer.run()
    return variables, params, losses, len(order), int(trainer.state.step)


class CoupledAdamState(GuardedState):
    """Adam with coupled L2 decay under the same schedule: what the port
    would compute had it kept its Adam state for this experiment."""

    def __init__(self, model, cfg, schedule):
        self.schedule = schedule
        super().__init__(model, cfg, torch.optim.Adam, weight_decay=cfg.weight_decay)

    def lr(self):
        return self.schedule(self.count)


def _port_trajectory(cfg, root, keys, variables, snapshot_dir, state_cls=AdamWTrainState, jax_params=()):
    """ITERATIONS iterations of the port's trainer from `variables`; the
    i-th iteration's targets are drawn with keys[i]. Returns (per-iteration
    losses, the learning rate of each update, the losses of the port's
    forward at jax_params[i] on the same pair and keys, the trainer)."""
    loader = PairLoader(_lmo(LMODataset, root, cfg), cfg, batch_size=1, shuffle=True, seed=cfg.seed)
    model = load_jax_variables(GeoTransformer(cfg), variables)
    trainer = IterBasedEncoderTrainer(cfg, model, state_cls(model, cfg.optim, make_warmup_cosine_schedule(
        *_schedule_args(cfg))), loader, None, max_iteration=ITERATIONS, snapshot_steps=1000,
        snapshot_dir=snapshot_dir, log_steps=1, seed=cfg.seed)
    losses, lrs, at_jax_params, train_batch = [], [], [], iter_trainer.train_batch

    def recording_batch(model, state, batch, generator=None):
        lrs.append(state.lr())
        if jax_params:
            shadow = load_jax_variables(GeoTransformer(cfg), {"params": jax_params[trainer.iteration],
                                                              "buffers": variables["buffers"]})
            pairs, _ = unstack_batch(batch, "cpu")
            data = ensure_pyramids(cfg, pairs[0])
            out = overall_loss(shadow(data, training=True), data["transform"], cfg.coarse_loss, cfg.fine_loss,
                               cfg.loss)
            at_jax_params.append({key: float(value.detach()) for key, value in out.items()})
        out = train_batch(model, state, batch, generator)
        losses.append({key: float(value) for key, value in out.items()})
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(iter_trainer, "train_batch", recording_batch)
        with port_target_keys(keys, lambda: trainer.iteration):
            trainer.run()
    return losses, lrs, at_jax_params, trainer


def _relative_loss_errors(got, want):
    return [max(abs(g[key] - w[key]) / abs(w[key]) for key in ("loss", "c_loss", "f_loss"))
            for g, w in zip(got, want)]


def test_loss_trajectory_matches_jax_iter_trainer(linemod_root, tmp_path):
    """The port's trainer from the JAX trainer's initial weights, on the same
    frames (loader order, augmentation) and target keys. Its losses are held
    against the port's forward at the weights the JAX trainer reached after
    the same updates, so the comparison isolates the trainer, the AdamW
    update and the schedule. Against the JAX trainer's own losses the two
    forwards add their difference on LineMod geometry: its clouds lie ~0.75
    m from the origin at 3 mm spacing, where the inner-product squared
    distances of both packages carry ~1e-7 m^2 of rounding, ~1% of a
    spacing's; a point nearly equidistant from two nodes then joins another
    patch in one package than in the other, and its patch overlaps, the
    coarse loss's labels, differ. That difference is printed."""
    jcfg = tiny_linemod_config(**TINY_OPTIM)
    cfg = port_config(jcfg)
    m = n = cfg.capacities.points[-1]
    keys = np.random.default_rng(23).uniform(size=(ITERATIONS, m * n)).astype(np.float32)
    variables, jax_params, want, drawn, jax_step = _jax_trajectory(jcfg, linemod_root, keys, str(tmp_path / "jax"))
    got, lrs, at_jax, trainer = _port_trajectory(cfg, linemod_root, keys, variables, str(tmp_path / "port"),
                                                 jax_params=jax_params)
    assert drawn == ITERATIONS and jax_step == ITERATIONS
    assert len(got) == len(want) == len(at_jax) == ITERATIONS
    assert (trainer.iteration, trainer.state.count, trainer.state.skipped) == (ITERATIONS, ITERATIONS, 0)
    schedule = jax_schedule(*_schedule_args(jcfg))
    np.testing.assert_allclose(lrs, [float(schedule(i)) for i in range(ITERATIONS)], rtol=SCHEDULE_RTOL)
    assert lrs[0] < lrs[1] and lrs[1] > lrs[2]  # a warmup step, then the cosine
    errors = _relative_loss_errors(got, at_jax)
    coupled, _, _, _ = _port_trajectory(cfg, linemod_root, keys, variables, str(tmp_path / "coupled"),
                                        state_cls=CoupledAdamState)
    coupled_errors = _relative_loss_errors(coupled, at_jax)
    print(f"JAX trainer losses {[round(s['loss'], 6) for s in want]}; the port's forward at the JAX trainer's "
          f"weights {[round(s['loss'], 6) for s in at_jax]} (relative difference per iteration "
          f"{[f'{e:.1e}' for e in _relative_loss_errors(at_jax, want)]}); the port's trainer with AdamW "
          f"{[round(s['loss'], 6) for s in got]}: {[f'{e:.1e}' for e in errors]} (bound {LOSS_RTOL:.0e}); "
          f"with coupled Adam {[round(s['loss'], 6) for s in coupled]}: {[f'{e:.1e}' for e in coupled_errors]}")
    for step, a in enumerate(got):
        for key in ("loss", "c_loss", "f_loss"):
            assert np.isfinite(a[key]) and want[step][key] > 0, (step, key)
    assert errors[0] == 0.0  # the same weights, pair and keys
    assert len({round(s["loss"], 6) for s in want}) == ITERATIONS
    assert max(errors) <= LOSS_RTOL
    assert max(coupled_errors) > 10 * LOSS_RTOL


# ---------------------------------------------------------------------------
# Resume, and the entry points in process
# ---------------------------------------------------------------------------

def _resume_run(root, snapshot_dir, max_iteration, resume):
    cfg = port_config(tiny_linemod_config(**{**TINY_OPTIM, "max_iteration": 6, "warmup_steps": 2}))
    loader = PairLoader(_lmo(LMODataset, root, cfg, augment=False), cfg, batch_size=1, shuffle=False)
    model = init_parameters(GeoTransformer(cfg), torch.Generator().manual_seed(5))
    state = AdamWTrainState(model, cfg.optim, make_warmup_cosine_schedule(*_schedule_args(cfg)))
    trainer = IterBasedEncoderTrainer(cfg, model, state, loader, None, max_iteration=max_iteration, snapshot_steps=3,
                                      snapshot_dir=snapshot_dir, log_steps=1, seed=cfg.seed)
    trainer.run(resume=resume)
    return trainer


def test_resumed_run_equals_uninterrupted_run(linemod_root, tmp_path):
    """6 iterations in one run == 3, then a resumed run to 6 (the loader
    unshuffled, no augmentation, 3 frames): parameters, AdamW moments,
    counts and the target generator, bit for bit."""
    straight = _resume_run(linemod_root, str(tmp_path / "a"), 6, False)
    first = _resume_run(linemod_root, str(tmp_path / "b"), 3, False)
    resumed = _resume_run(linemod_root, str(tmp_path / "b"), 6, True)
    assert (straight.iteration, resumed.iteration, first.iteration) == (6, 6, 3)
    assert (resumed.state.count, resumed.state.skipped) == (straight.state.count, straight.state.skipped) == (6, 0)
    moved = 0
    for (name, a), b, c in zip(straight.model.state_dict().items(), resumed.model.state_dict().values(),
                               first.model.state_dict().values()):
        assert torch.equal(a, b), name
        moved += int(not torch.equal(a, c))
    assert moved > 0
    sa, sb = straight.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for index, entry in sa["state"].items():
        for key, value in entry.items():
            assert torch.equal(value, sb["state"][index][key]), (index, key)
    assert torch.equal(straight.generator.get_state(), resumed.generator.get_state())
    assert sorted(os.listdir(tmp_path / "b")) == ["iter-3.pth.tar", "iter-6.pth.tar", "snapshot.pth.tar"]


@pytest.fixture
def experiment_env(linemod_root, tmp_path, monkeypatch):
    """The experiment pointed at the LineMod fixture, a ModelNet fixture and
    an output root, on the tiny config."""
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    make_modelnet_tree(str(tmp_path / "modelnet"), points=1024)
    monkeypatch.setenv("REF_GT_LINEMOD_ROOT", linemod_root)
    monkeypatch.setenv("REF_GT_MODELNET_ROOT", str(tmp_path / "modelnet"))
    monkeypatch.setenv("REF_GT_OUTPUT_ROOT", str(tmp_path / "output"))
    cfg = port_config(tiny_linemod_config(**{**TINY_OPTIM, "max_iteration": 100000, "warmup_steps": 2}))
    monkeypatch.setattr(exp_config, "make_cfg", lambda: cfg)
    monkeypatch.setattr(exp_config, "LMO", {**exp_config.LMO, "points_limit": POINTS_LIMIT, "reload_data": True})
    return cfg


def test_trainval_encoder_and_test_in_process(experiment_env):
    """trainval_encoder for 4 iterations (snapshot and validation over the 2
    test frames every 2), then test on iter-4 over 2 LineMod pairs and 1
    ModelNet pair."""
    trainer = trainval_encoder.main(["--max_iteration", "4", "--snapshot_steps", "2", "--log_steps", "1",
                                     "--device", "cpu"])
    assert (trainer.iteration, trainer.state.count, trainer.state.skipped) == (4, 4, 0)
    assert sorted(os.listdir(exp_config.SNAPSHOT_ENCODER_DIR)) == ["iter-2.pth.tar", "iter-4.pth.tar",
                                                                  "snapshot.pth.tar"]
    with open(os.path.join(exp_config.LOG_DIR, "train_encoder.log")) as f:
        lines = f.read().splitlines()
    logged = [float(re.search(r"lr: ([-\d.e+]+)", line).group(1)) for line in lines if "lr: " in line]
    schedule = make_warmup_cosine_schedule(*_schedule_args(experiment_env.replace(
        optim=dataclasses.replace(experiment_env.optim, max_iteration=4))))
    np.testing.assert_allclose(logged[-4:], [schedule(i) for i in range(1, 5)], rtol=5e-4)
    assert sum("[Val]" in line for line in lines) >= 2

    summary = exp_test.main(["--snapshot", "iter-4", "--num_pairs", "2", "--device", "cpu"])
    assert {"RRE", "RTE", "RR", "IR", "PIR"} <= set(summary)
    assert np.isfinite(summary["RRE"]) and np.isfinite(summary["RTE"]) and 0.0 <= summary["RR"] <= 1.0
    summary = exp_test.main(["--snapshot", "iter-4", "--use_modelnet", "--num_pairs", "1", "--device", "cpu"])
    assert np.isfinite(summary["RRE"]) and 0.0 <= summary["RR"] <= 1.0
    with pytest.raises(FileNotFoundError, match="iter-1.pth.tar"):
        exp_test.main(["--snapshot", "iter-4", "--cordi_snapshot", "iter-1", "--device", "cpu"])


def test_trainval_encoder_on_modelnet(experiment_env):
    """--use_modelnet trains on the ModelNet pairs (validation on its val split)."""
    trainer = trainval_encoder.main(["--use_modelnet", "--max_iteration", "1", "--snapshot_steps", "1",
                                     "--device", "cpu"])
    assert (trainer.iteration, trainer.state.count, trainer.state.skipped) == (1, 1, 0)
    assert len(trainer.train_loader.dataset) == 3
    assert "iter-1.pth.tar" in os.listdir(exp_config.SNAPSHOT_ENCODER_DIR)


def test_data_parallel_options_are_not_ported(experiment_env, monkeypatch):
    """(The name predates the port of data parallelism.) In one process,
    `--num_devices 1` and `--multihost` without a coordinator train one
    iteration as a world of one: no process group, one loader shard, the
    trainer primary, its snapshot written. `--num_devices 2` raises."""
    for key in ("REF_GT_COORDINATOR", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    for extra in (["--num_devices", "1"], ["--multihost"]):
        trainer = trainval_encoder.main(["--max_iteration", "1", "--snapshot_steps", "1", "--device", "cpu", *extra])
        assert (trainer.iteration, trainer.state.count, trainer.state.skipped) == (1, 1, 0)
        assert trainer.primary and not torch.distributed.is_initialized()
        assert (trainer.train_loader.num_shards, trainer.train_loader.shard_index) == (1, 0)
        assert "iter-1.pth.tar" in os.listdir(exp_config.SNAPSHOT_ENCODER_DIR)
        os.remove(os.path.join(exp_config.SNAPSHOT_ENCODER_DIR, "iter-1.pth.tar"))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        trainval_encoder.main(["--max_iteration", "1", "--device", "cpu", "--num_devices", "2"])
