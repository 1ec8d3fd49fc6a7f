"""PyTorch port: data-parallel and multi-process training (`parallel/`).

* shard math against the JAX PairLoader (the DistributedSampler
  counterpart: disjoint, covering, wrap-padded to equal lengths, one common
  permutation under shuffle);
* the single-process no-op of `initialize_multihost`, `--multihost` on all
  four training entry points, `--num_devices` against the world size;
* a real 2-process run on the CPU: two workers
  (`tests/torch_port_parallel_worker.py`) join a gloo group through a
  `file://` store and train the 3DMatch tiny model. After one step both
  ranks hold bit-identical parameters, equal to the JAX package's
  `make_train_step` (no mesh) on the global batch of both ranks' pairs with
  the learning rate times 2, from the same weights and target keys; the
  validation metrics are global means; a non-finite gradient on rank 1 alone
  skips the update on both; only rank 0 writes the log, the events and the
  snapshots; a resumed 2-rank run equals an uninterrupted one; and one
  process accumulating the two pairs' gradients (grad_acc_steps = 2) takes
  the 2-rank step.

The JAX step runs at `jax.default_matmul_precision("highest")`.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ref_geotransformer_tpu.data import PairLoader as JaxPairLoader
from ref_geotransformer_tpu.data import pack_pair as jax_pack_pair
from ref_geotransformer_tpu.data.datasets import ThreeDMatchPairDataset as JaxDataset
from ref_geotransformer_tpu.engine.state import TrainState as JaxTrainState
from ref_geotransformer_tpu.engine.state import make_optimizer
from ref_geotransformer_tpu.engine.steps import make_train_step
from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu.models import init_model_variables
from ref_geotransformer_tpu_torch.data import PairLoader, pack_pair
from ref_geotransformer_tpu_torch.data.datasets import ThreeDMatchPairDataset
from ref_geotransformer_tpu_torch.engine import TrainState, eval_batch
from ref_geotransformer_tpu_torch.engine.steps import to_device, train_pairs
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import trainval as trainval_3dmatch
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4.fixture import make_fixture_tree
from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import trainval as trainval_kitti
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import train_cordi
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import trainval_encoder
from ref_geotransformer_tpu_torch.parallel import make_world, multihost
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables, load_jax_variables
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from tests.test_torch_port_train import STEP_GRAD_TOL
from tests.torch_port_utils import ROOT, jax_target_keys, port_config, port_target_keys, tiny4_config
from tests.utils import tiny_config

WORKER_TIMEOUT_S = 120
LOSS_RTOL = 1e-4  # the step's losses against JAX's, relative (tests/test_torch_port_engine.py)
ENTRY_POINTS = {"3dmatch": trainval_3dmatch, "kitti": trainval_kitti, "encoder": trainval_encoder,
                "cordi": train_cordi}


# ---------------------------------------------------------------------------
# Shard math (tests/test_multihost.py:61-93), the port's loader against JAX's
# ---------------------------------------------------------------------------

class _FakeDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def _shards(loader_cls, cfg, n, num_shards, batch_size=1, shuffle=False, seed=0):
    loaders = [loader_cls(_FakeDataset(n), cfg, batch_size=batch_size, shuffle=shuffle, seed=seed,
                          num_shards=num_shards, shard_index=s) for s in range(num_shards)]
    return [loader._indices() for loader in loaders], [len(loader) for loader in loaders]


@pytest.mark.parametrize("n,num_shards,batch_size,shuffle", [(23, 4, 1, False), (23, 4, 2, False), (40, 8, 1, True),
                                                             (23, 4, 2, True)])
def test_shards_match_the_jax_loader(n, num_shards, batch_size, shuffle):
    """Every shard equals the JAX loader's; together they cover the dataset,
    each of the same (wrap-padded) length, so every rank takes as many steps;
    under shuffle all ranks stride one common permutation (the same seed)."""
    ours, our_lens = _shards(PairLoader, port_config(tiny_config()), n, num_shards, batch_size, shuffle, seed=7)
    theirs, their_lens = _shards(JaxPairLoader, tiny_config(), n, num_shards, batch_size, shuffle, seed=7)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    ceil_len = -(-n // num_shards)
    assert all(len(idx) == ceil_len for idx in ours)
    assert len(set(our_lens)) == 1 and our_lens == their_lens and our_lens[0] == -(-ceil_len // batch_size)
    merged = np.concatenate(ours)
    np.testing.assert_array_equal(np.unique(merged), np.arange(n))
    if n % num_shards == 0:
        np.testing.assert_array_equal(np.sort(merged), np.arange(n))  # an exact partition


def test_sharding_follows_the_process_group():
    """Without a process group: one shard of one, rank 0, primary."""
    loader = PairLoader(_FakeDataset(5), port_config(tiny_config()), num_shards=3, shard_index=2)
    multihost.apply_multihost_sharding(loader)
    assert (loader.num_shards, loader.shard_index) == (1, 0) == multihost.shard_spec()


# ---------------------------------------------------------------------------
# The process group in one process, and the entry points' options
# ---------------------------------------------------------------------------

def test_initialize_multihost_is_a_noop_without_a_coordinator(monkeypatch):
    for key in ("REF_GT_COORDINATOR", "REF_GT_NUM_PROCESSES", "REF_GT_PROCESS_ID", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert not multihost.torchrun_env_present()
    assert multihost.initialize_multihost(device="cpu") == (0, 1)
    assert multihost.initialize_multihost(device="cpu") == (0, 1)  # idempotent
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary() and multihost.world() == (0, 1)
    assert make_world("cpu") is None
    assert multihost.local_device("cuda") == torch.device("cuda")  # no group: no local rank's card
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not multihost.torchrun_env_present()  # torchrun with one process: still a single process
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert multihost.torchrun_env_present()


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_every_training_entry_point_parses_multihost(entry, capsys):
    with pytest.raises(SystemExit) as exit_info:
        ENTRY_POINTS[entry].main(["--help"])
    assert exit_info.value.code == 0
    help_text = capsys.readouterr().out
    assert "--multihost" in help_text and "--num_devices" in help_text


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_num_devices_must_equal_the_world_size(entry, monkeypatch):
    """In one process --num_devices 2 asks for a card no process drives: the
    entry point raises before it reads any data, and names the launcher."""
    for key in ("REF_GT_COORDINATOR", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        ENTRY_POINTS[entry].main(["--num_devices", "2", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Two processes under gloo against the JAX package's step on the global batch
# ---------------------------------------------------------------------------

def _cfg():
    cfg = tiny4_config()
    return cfg.replace(optim=dataclasses.replace(cfg.optim, max_epoch=1))


def _jax_pairs(root, cfg):
    dataset = JaxDataset(root, "train", point_limit=None, use_augmentation=False, seed=cfg.seed)
    return [jax_pack_pair(dataset[i], cfg.capacities.points[0]) for i in range(2)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Runs the two workers while the JAX step on the global batch compiles;
    returns the workers' results, the JAX step's and the shared inputs."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    cfg = _cfg()
    root = str(tmp / "tree")
    make_fixture_tree(root, n_train=2, n_val=2, points=600)
    model = JaxGeoTransformer(cfg)
    variables = jax.device_get(init_model_variables(model, cfg, jax.random.key(0)))
    port_cfg = port_config(cfg)
    weights = str(tmp / "weights.pt")
    torch.save(load_jax_variables(GeoTransformer(port_cfg), variables).state_dict(), weights)
    m = cfg.capacities.points[-1]
    keys = np.random.default_rng(3).uniform(size=(2, m * m)).astype(np.float32)
    spec = {"cfg": port_cfg, "weights": weights, "root": root, "keys": keys, "out": str(tmp),
            "store": str(tmp / "store")}
    spec_path = str(tmp / "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "REF_GT_COORDINATOR")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_port_parallel_worker", spec_path, str(rank)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        tx, _ = make_optimizer(cfg.optim, 1, lr_scale=2.0)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              buffers=variables["buffers"], opt_state=tx.init(variables["params"]), tx=tx)
        pairs = _jax_pairs(root, cfg)
        batch = {key: np.stack([p[key] for p in pairs]) for key in pairs[0]}
        batch["_pair_masks"] = np.ones(2, bool)
        with jax_target_keys(keys) as order, jax.default_matmul_precision("highest"):
            new_state, losses = make_train_step(model, cfg, donate=False)(state, batch, jax.random.key(1))
            new_state = jax.device_get(new_state)
        assert len(order) == 2
        outputs = [proc.communicate(timeout=WORKER_TIMEOUT_S)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, output) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"rank {rank} exited with {proc.returncode}:\n{output[-4000:]}"
    ranks = [torch.load(str(tmp / f"rank{rank}.pt"), weights_only=False) for rank in range(2)]
    return {"ranks": ranks, "cfg": port_cfg, "root": root, "keys": keys, "weights": weights,
            "jax_params": from_jax_variables({"params": new_state.params}),
            "jax_losses": {key: float(v) for key, v in jax.device_get(losses).items()},
            "params_before": from_jax_variables({"params": variables["params"]})}


def _assert_update_matches(got, want, before, grads, lr):
    """The Adam update p_after - p_before against the expected one, entry by
    entry where u = g + weight_decay * p stands above ten times the error the
    gradient test allows (tests/test_torch_port_train.py::
    test_adam_update_matches_apply_gradients): there the first update is
    about -lr * sign(u) in both, and they agree to 1e-2 of lr beyond the f32
    rounding of the parameters."""
    wd = _cfg().optim.weight_decay
    floor = 1e-3 * max(float(g.abs().max()) for g in grads.values())
    compared = total = 0
    for name, p in got.items():
        p0 = before[name].numpy().astype(np.float64)
        g = grads[name].numpy().astype(np.float64)
        err = STEP_GRAD_TOL * max(float(np.abs(g).max()), floor)
        reliable = np.abs(g + wd * p0) > max(10 * err, 1e-6)
        delta_got = p.numpy().astype(np.float64) - p0
        delta_want = want[name].numpy().astype(np.float64) - p0
        assert np.all(np.abs(delta_want[reliable]) > 0.9 * lr), name
        tol = 1e-2 * lr + 2 * np.finfo(np.float32).eps * np.abs(p0)
        assert np.all((np.abs(delta_got - delta_want) <= tol)[reliable]), name
        compared, total = compared + int(reliable.sum()), total + reliable.size
    assert compared > 0.5 * total, (compared, total)


def test_two_ranks_hold_bit_identical_parameters(two_ranks):
    a, b = (r["step"] for r in two_ranks["ranks"])
    assert a["world"] == (0, 2) and b["world"] == (1, 2)
    assert a["shard"] == (2, 0) and b["shard"] == (2, 1)
    for name, p in a["params"].items():
        assert torch.equal(p, b["params"][name]), name
        assert torch.equal(a["grads"][name], b["grads"][name]), name
    assert a["losses"] == b["losses"] and len(a["losses"]) == 1
    assert a["counts"] == b["counts"] == (1, 1, 0)
    assert a["lr_scale"] == b["lr_scale"] == 2.0


def test_two_rank_step_matches_jax_step_on_the_global_batch(two_ranks):
    step = two_ranks["ranks"][0]["step"]
    for key in ("loss", "c_loss", "f_loss"):
        want = two_ranks["jax_losses"][key]
        assert abs(step["losses"][0][key] - want) <= LOSS_RTOL * abs(want), key
    cfg = two_ranks["cfg"]
    _assert_update_matches(step["params"], two_ranks["jax_params"], two_ranks["params_before"], step["grads"],
                           2.0 * cfg.optim.lr)


def test_two_rank_gradients_are_the_global_batch_mean(two_ranks):
    """The ranks' reduced gradients against one process's backward over
    both pairs of the global batch (weights 1/2 each), same weights and keys:
    the sum over ranks divided by the global weight sum, not by a rank's own.
    Scaling a gradient by 1/2 is exact, so they agree to f32 rounding."""
    cfg = two_ranks["cfg"]
    model = GeoTransformer(cfg)
    model.load_state_dict(torch.load(two_ranks["weights"], weights_only=True), strict=True)
    dataset = ThreeDMatchPairDataset(two_ranks["root"], "train", point_limit=None, use_augmentation=False,
                                     seed=cfg.seed)
    pairs = [to_device(pack_pair(dataset[i], cfg.capacities.points[0]), "cpu") for i in range(2)]
    drawn = []
    with port_target_keys(two_ranks["keys"], lambda: drawn.append(None) or len(drawn) - 1):
        train_pairs(model, TrainState(model, cfg.optim, 1, lr_scale=2.0), pairs, [1.0, 1.0])
    assert len(drawn) == 2
    got = two_ranks["ranks"][0]["step"]["grads"]
    scale = max(float(p.grad.abs().max()) for p in model.parameters())
    for name, p in model.named_parameters():
        assert float((got[name] - p.grad).abs().max()) <= 1e-6 * scale, name


def test_two_rank_validation_gives_global_means(two_ranks):
    """Each rank validates its own val pair; both report the mean over the
    two, as one process validating both pairs in one batch does."""
    a, b = (r["step"]["val"] for r in two_ranks["ranks"])
    assert a == b and len(a) == 1
    a = a[0]
    cfg = two_ranks["cfg"]
    model = GeoTransformer(cfg)
    weights = torch.load(two_ranks["weights"], weights_only=True)
    model.load_state_dict({**weights, **two_ranks["ranks"][0]["step"]["params"]}, strict=True)
    dataset = ThreeDMatchPairDataset(two_ranks["root"], "val", point_limit=None, use_augmentation=False, seed=cfg.seed)
    batch = next(iter(PairLoader(dataset, cfg, batch_size=2, shuffle=False, seed=cfg.seed)))
    want = {key: float(v) for key, v in eval_batch(model.eval(), batch).items()}
    assert set(a) == set(want)
    for key, value in want.items():
        assert abs(a[key] - value) <= 1e-5 * max(abs(value), 1.0), (key, a[key], value)


def test_nonfinite_gradient_on_one_rank_skips_both(two_ranks):
    for rank in two_ranks["ranks"]:
        assert rank["skip"]["counts"] == (1, 1)  # one applied update, one skipped
        assert rank["skip"]["unchanged"]


def test_only_rank_zero_writes(two_ranks):
    a, b = (r["step"]["files"] for r in two_ranks["ranks"])
    assert b == []
    assert {"train.log", "snapshots/epoch-1.pth.tar", "snapshots/snapshot.pth.tar", "events/scalars.jsonl"} <= set(a)


def test_resumed_two_rank_run_equals_uninterrupted_run(two_ranks):
    """2 epochs straight against 1 epoch, then --resume: per rank, every
    parameter, the Adam state, the counts and the generator (each rank
    restores its own from the snapshot rank 0 wrote)."""
    generators = []
    for rank in two_ranks["ranks"]:
        straight, resumed = rank["resume"]["straight"], rank["resume"]["resumed"]
        assert straight["counts"] == resumed["counts"] == (2, 2, 2, 0)
        for name, p in straight["params"].items():
            assert torch.equal(p, resumed["params"][name]), name
        sa, sb = straight["optimizer"], resumed["optimizer"]
        assert sa["param_groups"] == sb["param_groups"]
        for index, entry in sa["state"].items():
            for key, value in entry.items():
                assert torch.equal(value, sb["state"][index][key]), (index, key)
        assert torch.equal(straight["generator"], resumed["generator"])
        generators.append(straight["generator"])
    assert not torch.equal(*generators)  # each rank draws its own stream


def test_gradient_accumulation_over_two_pairs_equals_the_two_rank_step(two_ranks):
    """One process, grad_acc_steps = 2, the learning rate times 2: pair 0
    (keys[0]), then pair 1 (keys[1]), against the 2-rank step over both."""
    cfg = two_ranks["cfg"]
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, grad_acc_steps=2))
    model = GeoTransformer(cfg)
    model.load_state_dict(torch.load(two_ranks["weights"], weights_only=True), strict=True)
    state = TrainState(model, cfg.optim, 1, lr_scale=2.0)
    dataset = ThreeDMatchPairDataset(two_ranks["root"], "train", point_limit=None, use_augmentation=False,
                                     seed=cfg.seed)
    for i in range(2):
        pair = to_device(pack_pair(dataset[i], cfg.capacities.points[0]), "cpu")
        with port_target_keys(two_ranks["keys"], lambda: i):
            train_pairs(model, state, [pair], [1.0])
    assert (state.count, state.skipped, state.mini_step) == (1, 0, 0)
    step = two_ranks["ranks"][0]["step"]
    got = {name: p.detach() for name, p in model.named_parameters()}
    _assert_update_matches(got, step["params"], two_ranks["params_before"], step["grads"], 2.0 * cfg.optim.lr)
