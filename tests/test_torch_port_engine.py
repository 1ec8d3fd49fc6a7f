"""PyTorch port: the epoch trainer, checkpoints, tester, CLI chain and demo snapshot.

* the loss trajectory of 3 train steps of the port's trainer against the
  JAX package's, on the same fixture pairs, weights and target keys, at
  batch sizes 1 and 2 (the latter with a repeat-padded final batch);
* checkpoints: epoch and rolling snapshots restore exactly, and a resumed
  run equals an uninterrupted one bit for bit;
* the chain run_trainval -> run_test -> eval on a fixture tree, in process,
  on the CPU, with the tiny config; the real CLIs in subprocesses at the
  published widths, capacities scaled by 0.04 (~30 s);
* a snapshot of the trainer loads into `demo.py --snapshot`.

The JAX trainer runs at `jax.default_matmul_precision("highest")`.
"""

import ast
import dataclasses
import glob
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from ref_geotransformer_tpu.data import PairLoader as JaxPairLoader
from ref_geotransformer_tpu.data import pack_pair as jax_pack_pair
from ref_geotransformer_tpu.data.datasets import ThreeDMatchPairDataset as JaxDataset
from ref_geotransformer_tpu.engine import EpochBasedTrainer as JaxTrainer
from ref_geotransformer_tpu.engine import create_train_state
from ref_geotransformer_tpu.engine.steps import ensure_pyramids as jax_ensure_pyramids
from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu_torch import demo
from ref_geotransformer_tpu_torch.data import PairLoader
from ref_geotransformer_tpu_torch.data.datasets import ThreeDMatchPairDataset
from ref_geotransformer_tpu_torch.engine import CheckpointManager, EpochBasedTrainer, TrainState, train_step
from ref_geotransformer_tpu_torch.engine.cli import run_test, run_trainval, trainval_parser
from ref_geotransformer_tpu_torch.engine.steps import to_device
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import config as exp_config
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import dataset as exp_dataset
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import eval as exp_eval
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4.fixture import make_fixture_tree
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.utils.feature_dump import dump_registration_npz
from ref_geotransformer_tpu_torch.utils.weights import load_jax_variables
from tests.torch_port_utils import ROOT, demo_crop, jax_target_keys, port_config, port_target_keys, tiny4_config

LOSS_RTOL = 1e-4  # per-step losses of the two trainers, relative
TRAJECTORY_STEPS = 3
# the keys each test dump must hold (tests/test_fixture_cli_e2e.py)
REQUIRED_NPZ_KEYS = {
    "ref_points", "src_points", "ref_points_c", "src_points_c", "ref_feats_c", "src_feats_c",
    "ref_node_corr_indices", "src_node_corr_indices", "ref_corr_points", "src_corr_points", "corr_scores",
    "gt_node_corr_overlaps",
}
ENV_KEYS = ("REF_GT_3DMATCH_ROOT", "REF_GT_OUTPUT_ROOT", "REF_GT_CAPS_SCALE", "REF_GT_NEIGHBOR_LIMITS", "REF_GT_LR",
            "REF_GT_LR_DECAY", "REF_GT_USE_AUG", "REF_GT_VAL_EVERY")


def _tiny(max_epoch=1):
    cfg = tiny4_config()
    return cfg.replace(optim=dataclasses.replace(cfg.optim, max_epoch=max_epoch))


# ---------------------------------------------------------------------------
# Loss trajectory against the JAX trainer
# ---------------------------------------------------------------------------

def _jax_trajectory(cfg, root, batch_size, keys, snapshot_dir):
    """3 steps of the JAX trainer; the target sampler's uniform keys are
    keys[i] for the i-th pair the train step sees (a host callback hands
    them out in order, one per pair key). Returns (initial variables,
    per-step losses, number of pairs that drew keys)."""
    loader = JaxPairLoader(JaxDataset(root, "train", seed=cfg.seed), cfg, batch_size=batch_size, shuffle=True,
                           seed=cfg.seed)
    example = jax_pack_pair(JaxDataset(root, "train")[0], cfg.capacities.points[0])
    model = JaxGeoTransformer(cfg)
    state, schedule = create_train_state(model, jax_ensure_pyramids(cfg, example), cfg.optim,
                                         steps_per_epoch=len(loader), rng=jax.random.key(cfg.seed))
    variables = jax.device_get({"params": state.params, "buffers": state.buffers})
    trainer = JaxTrainer(cfg, model, state, schedule, loader, None, snapshot_dir=snapshot_dir, log_steps=1,
                         seed=cfg.seed)
    losses = []
    trainer.after_step_hooks.append(lambda t, step_losses: losses.append(
        {key: float(value) for key, value in step_losses.items()}))
    with jax_target_keys(keys) as order:
        with jax.default_matmul_precision("highest"):
            trainer.run()
    return variables, losses, len(order)


def _port_trajectory(cfg, root, batch_size, keys, variables, snapshot_dir):
    """3 steps of the port's trainer from the same weights; pair j of step i
    samples its targets with keys[i * batch_size + j]."""
    loader = PairLoader(ThreeDMatchPairDataset(root, "train", seed=cfg.seed), cfg, batch_size=batch_size,
                        shuffle=True, seed=cfg.seed)
    model = load_jax_variables(GeoTransformer(cfg), variables)
    trainer = EpochBasedTrainer(cfg, model, TrainState(model, cfg.optim, len(loader)), loader, None,
                                snapshot_dir=snapshot_dir, log_steps=1, seed=cfg.seed)
    losses, pair_in_step = [], [0]
    trainer.before_step_hooks.append(lambda t, batch: pair_in_step.__setitem__(0, 0))
    trainer.after_step_hooks.append(lambda t, step_losses: losses.append(step_losses))

    def next_index():
        pair_in_step[0] += 1
        return trainer.iteration * batch_size + pair_in_step[0] - 1

    with port_target_keys(keys, next_index):
        trainer.run()
    return losses, trainer


def _relative_loss_errors(got, want):
    return {key: abs(got[key] - want[key]) / abs(want[key]) for key in ("loss", "c_loss", "f_loss")}


@pytest.mark.parametrize("batch_size", [1, 2])
def test_loss_trajectory_matches_jax_trainer(tmp_path, batch_size):
    """batch 1: 3 pairs; batch 2: 5 pairs, so the third batch holds one pair
    and its repeat (weight 0)."""
    cfg = _tiny()
    root = str(tmp_path / "tree")
    make_fixture_tree(root, n_train=2 * batch_size + 1, n_val=1, points=600)
    m, n = cfg.capacities.points[-1], cfg.capacities.points[-1]
    keys = np.random.default_rng(17).uniform(size=(TRAJECTORY_STEPS * batch_size, m * n)).astype(np.float32)
    variables, want, drawn = _jax_trajectory(cfg, root, batch_size, keys, str(tmp_path / "jax"))
    got, trainer = _port_trajectory(port_config(cfg), root, batch_size, keys, variables, str(tmp_path / "port"))
    assert drawn == TRAJECTORY_STEPS * batch_size
    assert len(got) == len(want) == TRAJECTORY_STEPS
    assert trainer.state.count == TRAJECTORY_STEPS and trainer.state.skipped == 0
    errors = [_relative_loss_errors(a, b) for a, b in zip(got, want)]
    print(f"batch {batch_size}: JAX losses {[round(s['loss'], 6) for s in want]}, largest relative error per step "
          f"{[f'{max(e.values()):.2e}' for e in errors]}")
    for step, (a, e) in enumerate(zip(got, errors)):
        for key in ("loss", "c_loss", "f_loss"):
            assert np.isfinite(a[key]) and want[step][key] > 0, (step, key, a[key], want[step][key])
            assert e[key] <= LOSS_RTOL, (step, key, a[key], want[step][key])
    assert len({round(s["loss"], 6) for s in want}) == TRAJECTORY_STEPS  # three different steps
    # the bound tells a wrong target draw apart: each pair given the keys of the one before
    rolled, _ = _port_trajectory(port_config(cfg), root, batch_size, np.roll(keys, 1, axis=0), variables,
                                 str(tmp_path / "rolled"))
    rolled_errors = [max(_relative_loss_errors(a, b).values()) for a, b in zip(rolled, want)]
    print(f"batch {batch_size}, keys rolled by one pair: {[f'{e:.2e}' for e in rolled_errors]}")
    assert max(rolled_errors) > 10 * LOSS_RTOL


# ---------------------------------------------------------------------------
# Checkpoints and resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli") / "tree")
    make_fixture_tree(root, n_train=3, n_val=2, points=600)
    return root


def _loader(root, cfg, subset="train", batch_size=1):
    dataset = ThreeDMatchPairDataset(root, subset, point_limit=None, use_augmentation=False, seed=cfg.seed)
    return PairLoader(dataset, cfg, batch_size=batch_size, shuffle=False, seed=cfg.seed)


def _assert_same_optimizer_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sorted(sa["state"]) == sorted(sb["state"]) and len(sa["state"]) > 0
    for index, entry in sa["state"].items():
        for name, value in entry.items():
            assert torch.equal(value, sb["state"][index][name]), (index, name)


def test_checkpoint_round_trip(tree, tmp_path):
    """epoch-N restores the parameters and buffers; snapshot restores them
    with the Adam moments, count, skipped, epoch, iteration and the target
    generator, exactly."""
    cfg = port_config(_tiny())
    model = demo.build_model(cfg, torch.device("cpu"), seed=1)
    state = TrainState(model, cfg.optim, steps_per_epoch=3)
    generator = torch.Generator().manual_seed(4)
    pair = to_device(next(iter(_loader(tree, cfg).iter_single()))[0], "cpu")
    for _ in range(2):
        train_step(model, state, pair, generator)
    for p in state.params:  # a non-finite step: skipped, counted
        p.grad = torch.full_like(p, float("nan"))
    assert not state.apply_gradients()
    assert (state.count, state.skipped) == (2, 1)

    ckpt = CheckpointManager(str(tmp_path / "snapshots"))
    ckpt.save_epoch("epoch-3", model)
    ckpt.save_snapshot(model, state, epoch=3, iteration=9, generator=generator)
    assert ckpt.has_snapshot() and ckpt.list_epochs() == ["epoch-3"]
    assert sorted(os.listdir(ckpt.snapshot_dir)) == ["epoch-3.pth.tar", "snapshot.pth.tar"]  # no temporary files

    fresh = demo.build_model(cfg, torch.device("cpu"), seed=2)
    ckpt.load_model("epoch-3", fresh)
    for (name, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), name

    restored = demo.build_model(cfg, torch.device("cpu"), seed=2)
    restored_state = TrainState(restored, cfg.optim, steps_per_epoch=3)
    restored_generator = torch.Generator().manual_seed(0)
    epoch, iteration = ckpt.load_snapshot(restored, restored_state, restored_generator)
    assert (epoch, iteration) == (3, 9)
    assert (restored_state.count, restored_state.skipped) == (2, 1)
    for (name, a), b in zip(model.state_dict().items(), restored.state_dict().values()):
        assert torch.equal(a, b), name
    _assert_same_optimizer_state(state.optimizer, restored_state.optimizer)
    assert torch.equal(restored_generator.get_state(), generator.get_state())
    assert restored_state.lr() == state.lr()


def _args(*extra):
    return trainval_parser().parse_args(["--log_steps", "1", "--device", "cpu", *extra])


def test_resumed_run_equals_uninterrupted_run(tree, tmp_path):
    """2 epochs in one run == 1 epoch, then --resume for a second, in every
    parameter, the Adam state and the counts (no shuffle, no augmentation)."""
    cfg = port_config(_tiny())
    straight = run_trainval(cfg, _loader(tree, cfg), None, str(tmp_path / "a" / "snapshots"), str(tmp_path / "a"),
                            _args("--max_epoch", "2"))
    first = run_trainval(cfg, _loader(tree, cfg), None, str(tmp_path / "b" / "snapshots"), str(tmp_path / "b"),
                         _args("--max_epoch", "1"))
    assert (first.epoch, first.iteration, first.state.count) == (1, 3, 3)
    resumed = run_trainval(cfg, _loader(tree, cfg), None, str(tmp_path / "b" / "snapshots"), str(tmp_path / "b"),
                           _args("--max_epoch", "2", "--resume"))
    assert (resumed.epoch, resumed.iteration) == (straight.epoch, straight.iteration) == (2, 6)
    assert (resumed.state.count, resumed.state.skipped) == (straight.state.count, straight.state.skipped) == (6, 0)
    moved = 0
    for (name, a), b, c in zip(straight.model.state_dict().items(), resumed.model.state_dict().values(),
                               first.model.state_dict().values()):
        assert torch.equal(a, b), name
        moved += int(not torch.equal(a, c))
    assert moved > 0  # the second epoch changed the parameters
    _assert_same_optimizer_state(straight.state.optimizer, resumed.state.optimizer)
    assert sorted(os.listdir(tmp_path / "b" / "snapshots")) == ["epoch-1.pth.tar", "epoch-2.pth.tar",
                                                                "snapshot.pth.tar"]


def test_resumed_run_with_gradient_accumulation_equals_uninterrupted_run(tree, tmp_path):
    """grad_acc_steps = 2 over 3 pairs an epoch: the first epoch ends in the
    middle of a window, so the snapshot must carry the running mean and the
    mini-step; 2 epochs in one run == 1 epoch, then --resume, bit for bit."""
    cfg = port_config(_tiny())
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, grad_acc_steps=2))
    straight = run_trainval(cfg, _loader(tree, cfg), None, str(tmp_path / "a" / "snapshots"), str(tmp_path / "a"),
                            _args("--max_epoch", "2"))
    first = run_trainval(cfg, _loader(tree, cfg), None, str(tmp_path / "b" / "snapshots"), str(tmp_path / "b"),
                         _args("--max_epoch", "1"))
    assert (first.iteration, first.state.count, first.state.mini_step) == (3, 1, 1)
    assert any(float(acc.abs().max()) > 0 for acc in first.state.acc)  # a window in flight
    resumed = run_trainval(cfg, _loader(tree, cfg), None, str(tmp_path / "b" / "snapshots"), str(tmp_path / "b"),
                           _args("--max_epoch", "2", "--resume"))
    for trainer in (straight, resumed):
        assert (trainer.iteration, trainer.state.count, trainer.state.skipped, trainer.state.mini_step) == (6, 3, 0, 0)
    for (name, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    _assert_same_optimizer_state(straight.state.optimizer, resumed.state.optimizer)
    assert all(torch.equal(a, b) for a, b in zip(straight.state.acc, resumed.state.acc))


def test_trainer_profile_window_writes_a_chrome_trace(tree, tmp_path):
    """profile_steps=(1, 3): steps 2 and 3 of a 3-step epoch are recorded
    with torch.profiler; the trace is written when the window closes at the
    end of the run."""
    cfg = port_config(_tiny())
    model = demo.build_model(cfg, torch.device("cpu"), seed=3)
    loader = _loader(tree, cfg)
    trainer = EpochBasedTrainer(cfg, model, TrainState(model, cfg.optim, len(loader)), loader, None,
                                snapshot_dir=str(tmp_path / "snapshots"), log_steps=1,
                                profile_dir=str(tmp_path / "trace"), profile_steps=(1, 3))
    trainer.run()
    assert trainer.iteration == 3 and trainer.profiler is None
    assert os.listdir(tmp_path / "trace") == ["trace-3.json"]
    with open(tmp_path / "trace" / "trace-3.json") as f:
        assert '"traceEvents"' in f.read()


def test_data_parallel_options_are_not_ported(tree, tmp_path, monkeypatch):
    """(The name predates the port of data parallelism.) In one process,
    `--num_devices 1` and `--multihost` without a coordinator in the
    environment train as a world of one: no process group, the learning rate
    unscaled, the trainer primary with its log and snapshots, and the
    parameters those of a run without the options, bit for bit.
    `--num_devices 2` asks for a second card that no process drives."""
    for key in ("REF_GT_COORDINATOR", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    cfg = port_config(_tiny())
    runs = {}
    for name, extra in (("plain", []), ("num_devices", ["--num_devices", "1"]), ("multihost", ["--multihost"])):
        trainer = run_trainval(cfg, _loader(tree, cfg), None, str(tmp_path / name / "snapshots"),
                               str(tmp_path / name), _args(*extra))
        assert not torch.distributed.is_initialized()
        assert trainer.world is None and trainer.primary and trainer.state.lr_scale == 1.0
        assert (trainer.epoch, trainer.state.count, trainer.state.skipped) == (1, 3, 0)
        assert trainer.train_loader.num_shards == 1
        assert os.path.isfile(tmp_path / name / "train.log")
        assert sorted(os.listdir(tmp_path / name / "snapshots")) == ["epoch-1.pth.tar", "snapshot.pth.tar"]
        runs[name] = trainer.model.state_dict()
    for name in ("num_devices", "multihost"):
        assert all(torch.equal(v, runs[name][k]) for k, v in runs["plain"].items()), name
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        run_trainval(cfg, _loader(tree, cfg), None, str(tmp_path / "s"), str(tmp_path), _args("--num_devices", "2"))


def test_first_epochs_take_the_jax_cli_pair_order(tmp_path, monkeypatch):
    """The JAX run_trainval draws one batch to initialize its model, which
    spends one permutation of a shuffling loader's generator; the port's
    run_trainval spends the same without loading pairs. With shuffle on, the
    index order of the first two epochs equals the JAX CLI's. The JAX side
    is its own run_trainval, loader and draw, with the model's
    initialization and the trainer's steps stubbed out: the stub iterates
    the train loader once an epoch, as the trainer does. Indices are
    compared, not augmented points: the initial draw's prefetch thread goes
    on loading and augmenting pairs while the JAX epochs run."""
    import ref_geotransformer_tpu.engine as jax_engine
    import ref_geotransformer_tpu.engine.steps as jax_steps
    from ref_geotransformer_tpu.engine import cli as jax_cli

    root = str(tmp_path / "tree")
    make_fixture_tree(root, n_train=5, n_val=1, points=600)
    cfg = _tiny(max_epoch=2)
    orders = {"jax": [], "port": []}
    for key, cls in (("jax", JaxPairLoader), ("port", PairLoader)):
        def recording(self, _indices=cls._indices, _order=orders[key]):
            _order.append(_indices(self))
            return _order[-1]
        monkeypatch.setattr(cls, "_indices", recording)

    class EpochsOnly:
        def __init__(self, cfg, model, state, schedule, train_loader, *args, **kwargs):
            self.cfg, self.train_loader = cfg, train_loader

        def run(self, resume=False):
            for _ in range(self.cfg.optim.max_epoch):
                for _ in self.train_loader:
                    pass

    monkeypatch.setattr(jax_engine, "EpochBasedTrainer", EpochsOnly)
    monkeypatch.setattr(jax_engine, "create_train_state", lambda *args, **kwargs: (None, None))
    monkeypatch.setattr(jax_steps, "ensure_pyramids", lambda cfg, pair: pair)
    jax_loader = JaxPairLoader(JaxDataset(root, "train", seed=cfg.seed), cfg, batch_size=1, shuffle=True,
                               seed=cfg.seed)
    jax_cli.run_trainval(cfg, jax_loader, None, str(tmp_path / "jax" / "snapshots"), str(tmp_path / "jax"),
                         jax_cli.trainval_parser().parse_args([]))
    port_cfg = port_config(cfg)
    port_loader = PairLoader(ThreeDMatchPairDataset(root, "train", seed=cfg.seed), port_cfg, batch_size=1,
                             shuffle=True, seed=cfg.seed)
    trainer = run_trainval(port_cfg, port_loader, None, str(tmp_path / "port" / "snapshots"), str(tmp_path / "port"),
                           _args())
    assert trainer.iteration == 10
    assert len(orders["jax"]) == 3 and len(orders["port"]) == 2  # the JAX draw, then two epochs each
    for epoch in range(2):
        np.testing.assert_array_equal(orders["port"][epoch], orders["jax"][epoch + 1])
    assert not np.array_equal(orders["jax"][0], orders["jax"][1])  # without the draw the first epoch would differ


# ---------------------------------------------------------------------------
# The chain: trainval -> test -> eval, in process
# ---------------------------------------------------------------------------

def _check_eval_summary(summary, method):
    values = {k: v for k, v in summary.items() if k != "scenes"}
    assert {"RR", "IR", "FMR", "PIR"} <= set(values), method
    for key, value in values.items():
        assert np.isfinite(value), (method, key)
    assert 0.0 <= values["RR"] <= 1.0


def test_cli_chain_in_process(tree, tmp_path, monkeypatch):
    """run_trainval (with validation) -> run_test with the feature dump ->
    eval_one_epoch (lgr, svd), with the experiment's loaders and
    directories, on the tiny config on the CPU; the artifacts that
    tests/test_fixture_cli_e2e.py checks."""
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("REF_GT_3DMATCH_ROOT", tree)
    monkeypatch.setenv("REF_GT_OUTPUT_ROOT", str(tmp_path / "output"))
    cfg = port_config(_tiny())
    train_loader, valid_loader = exp_dataset.train_valid_data_loader(cfg)
    trainer = run_trainval(cfg, train_loader, valid_loader, exp_config.SNAPSHOT_DIR, exp_config.LOG_DIR,
                           _args("--max_epoch", "1"), event_dir=exp_config.EVENT_DIR)
    assert trainer.state.count == 3 and trainer.state.skipped == 0
    assert glob.glob(os.path.join(exp_config.SNAPSHOT_DIR, "epoch-1*"))
    with open(os.path.join(exp_config.LOG_DIR, "train.log")) as f:
        assert any("[Val]" in line for line in f), "no validation line in train.log"
    with open(os.path.join(exp_config.EVENT_DIR, "scalars.jsonl")) as f:
        tags = {line.split('"tag": "')[1].split('"')[0] for line in f}
    assert {"train/loss", "val/loss", "val/RR"} <= tags

    feature_dir = os.path.join(exp_config.FEATURE_DIR, "val")
    os.makedirs(feature_dir)
    def dump(i, data, meta, output):
        dump_registration_npz(feature_dir, data, meta, output)

    summary = run_test(cfg, exp_dataset.test_data_loader(cfg, "val"), exp_config.SNAPSHOT_DIR, "epoch-1",
                       exp_config.LOG_DIR, after_test_step=dump, device="cpu")
    assert {"PIR", "IR", "RRE", "RTE", "RMSE", "RR"} <= set(summary)
    npzs = sorted(glob.glob(os.path.join(feature_dir, "*.npz")))
    assert len(npzs) == 2
    with np.load(npzs[0]) as data:
        assert not REQUIRED_NPZ_KEYS - set(data.keys())
    for method in ("lgr", "svd"):
        args = SimpleNamespace(benchmark="val", method=method, num_corr=None, feature_dir=None, verbose=False)
        _check_eval_summary(exp_eval.eval_one_epoch(args, cfg), method)
        assert os.path.isfile(os.path.join(exp_config.REGISTRATION_DIR, "val", method, "7-scenes-fixture", "est.log"))


def test_cli_chain_subprocesses(tmp_path):
    """The real CLIs (python -m ...trainval / test / eval) at the published
    widths on the CPU, capacities scaled by 0.04, as the JAX package's own
    fixture-stack run (tests/test_fixture_cli_e2e.py, slow tier there)."""
    root = str(tmp_path / "tree")
    make_fixture_tree(root, n_train=4, n_val=2)
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(REF_GT_3DMATCH_ROOT=root, REF_GT_OUTPUT_ROOT=str(tmp_path / "output"), REF_GT_CAPS_SCALE="0.04",
               PYTHONPATH=ROOT)
    package = "ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4"

    def run(script, *args):
        proc = subprocess.run([sys.executable, "-m", f"{package}.{script}", *args], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=1800)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return proc.stdout

    run("trainval", "--max_epoch", "1", "--log_steps", "1", "--device", "cpu")
    run("test", "--benchmark", "val", "--snapshot", "epoch-1", "--device", "cpu")
    exp_out = os.path.join(str(tmp_path / "output"), "geotransformer_3dmatch_stage4")
    assert glob.glob(os.path.join(exp_out, "snapshots", "epoch-1*"))
    npzs = sorted(glob.glob(os.path.join(exp_out, "features", "val", "*.npz")))
    assert len(npzs) == 2
    with np.load(npzs[0]) as data:
        assert not REQUIRED_NPZ_KEYS - set(data.keys())
    for method in ("lgr", "svd"):
        lines = [line for line in run("eval", "--benchmark", "val", "--method", method).splitlines()
                 if line.startswith("{")]
        _check_eval_summary(ast.literal_eval(lines[-1]), method)
    with open(os.path.join(exp_out, "logs", "train.log")) as f:
        assert any("[Val]" in line for line in f)


# ---------------------------------------------------------------------------
# demo.py --snapshot
# ---------------------------------------------------------------------------

def test_demo_loads_a_trainer_snapshot(tree, tmp_path, monkeypatch):
    """demo.py with --ref_file/--src_file/--gt_file, --snapshot (an epoch
    snapshot the trainer wrote) and --dump gives the estimated transform of
    the model that wrote the snapshot."""
    cfg = port_config(_tiny())
    trainer = run_trainval(cfg, _loader(tree, cfg), None, str(tmp_path / "snapshots"), str(tmp_path),
                           _args("--max_epoch", "1"))
    files = {}
    for name, cloud in zip(("ref", "src"), demo_crop(400, seed=2)):
        files[name] = str(tmp_path / f"{name}.npy")
        np.save(files[name], cloud)
    files["gt"] = os.path.join(ROOT, "data", "demo", "gt.npy")
    pair = demo.load_pair(cfg, torch.device("cpu"), files["ref"], files["src"], files["gt"])
    want = demo.register(trainer.model.eval(), cfg, pair)["estimated_transform"]

    monkeypatch.setattr(demo, "make_cfg", lambda demo=True: cfg)
    dump = str(tmp_path / "out.npz")
    demo.main(["--device", "cpu", "--iters", "0", "--ref_file", files["ref"], "--src_file", files["src"],
               "--gt_file", files["gt"], "--snapshot", str(tmp_path / "snapshots" / "epoch-1.pth.tar"),
               "--dump", dump])
    with np.load(dump) as out:
        assert {"estimated_transform", "ref_corr_points", "src_corr_points", "corr_scores"} <= set(out.files)
        np.testing.assert_array_equal(out["estimated_transform"], want.numpy())
    random = demo.register(demo.build_model(cfg, torch.device("cpu")), cfg, pair)["estimated_transform"]
    assert not torch.equal(random, want)  # the snapshot's weights, not the seeded ones
