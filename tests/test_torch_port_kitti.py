"""PyTorch port vs JAX package: the KITTI stage-5 experiment's model and data.

* the 5-stage model with decoders from level 4 up to level 1 (the KITTI
  model's shape, tiny widths): backbone levels, the whole inference forward
  and one train step's losses and gradients, on shared weights
  (utils/weights.py) and shared target keys;
* the pyramid on a fixture scan at the published voxel and radius, where the
  scans lie metres from the origin: neighbor tables equal up to real ties;
* `OdometryKittiPairDataset` samples bit for bit equal to the JAX
  package's (train with augmentation, val, test, with correspondences), the
  fixture tree against `tools/train_kitti_fixture.py`'s;
* `count_voxels`, the neighbor-distance top-k and both calibration
  functions against the JAX package's on the fixture tree;
* the offline eval's summary against the JAX experiment's `eval.py`;
* the experiment's config and its environment overrides.

The JAX side runs jitted at `jax.default_matmul_precision("highest")`.
"""

import dataclasses
import filecmp
import functools
import importlib
import importlib.util
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ref_geotransformer_tpu_torch.models.geotransformer as port_geotransformer
from ref_geotransformer_tpu.data import calibration as jax_calibration
from ref_geotransformer_tpu.data.datasets.kitti import OdometryKittiPairDataset as JaxKittiDataset
from ref_geotransformer_tpu.data.pyramid import build_registration_inputs as jax_build_inputs
from ref_geotransformer_tpu.data.pyramid import pad_points
from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu.models import init_model_variables
from ref_geotransformer_tpu.models.losses import overall_loss as jax_overall_loss
from ref_geotransformer_tpu.ops.neighbors import _chunked_topk_neighbors
from ref_geotransformer_tpu.ops.subsample import count_voxels as jax_count_voxels
from ref_geotransformer_tpu_torch.config.kitti import make_cfg as make_kitti_cfg
from ref_geotransformer_tpu_torch.data import calibration
from ref_geotransformer_tpu_torch.data.datasets.kitti import OdometryKittiPairDataset
from ref_geotransformer_tpu_torch.data.pyramid import build_registration_inputs
from ref_geotransformer_tpu_torch.engine import train_step
from ref_geotransformer_tpu_torch.engine.state import TrainState
from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import config as exp_config
from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import eval as exp_eval
from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5.fixture import make_fixture_tree
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer, _stack_pair
from ref_geotransformer_tpu_torch.ops.neighbors import topk_neighbor_distances
from ref_geotransformer_tpu_torch.ops.subsample import count_voxels
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables, jax_gradients_by_name, load_jax_variables
from tests.test_torch_port_linemod import assert_identical
from tests.test_torch_port_model import _check_slice, _jax_backbone, _pyramid_args, surface_pair
from tests.test_torch_port_train import STEP_GRAD_TOL, _relative_error
from tests.torch_port_utils import ROOT, assert_close, assert_tables_match, port_config, tiny5_config, to_np, to_torch

ENV_KEYS = ("REF_GT_OUTPUT_ROOT", "REF_GT_KITTI_ROOT", "REF_GT_CAPS_SCALE")
JAX_EXPERIMENT_DIR = os.path.join(ROOT, "experiments", "geotransformer_kitti_stage5")


# ---------------------------------------------------------------------------
# The 5-stage model, decoders from level 4 up to level 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_setup():
    cfg = tiny5_config()
    arrays = surface_pair(cfg)
    with jax.default_matmul_precision("highest"):
        data = jax.jit(lambda *a: jax_build_inputs(*a, *_pyramid_args(cfg), search_chunk=cfg.capacities.search_chunk))(
            *(jnp.array(a) for a in arrays))
        model = JaxGeoTransformer(cfg)
        variables = init_model_variables(model, cfg, jax.random.key(0))
        out = jax.device_get(jax.jit(model.apply)(variables, data))
    return cfg, arrays, jax.device_get(data), jax.device_get(variables), out


def test_decoders_from_level_4_to_level_1(slice_setup):
    """decoder4 and decoder3 are UnaryBlocks with a GroupNorm, decoder2 the
    LastUnaryBlock to output_dim; the bridge maps every JAX variable to one
    of the model's."""
    cfg, _, data, variables, _ = slice_setup
    model = GeoTransformer(port_config(cfg))
    names = {name.split(".")[1] for name, _ in model.backbone.named_parameters(prefix="backbone")
             if name.startswith("backbone.decoder")}
    assert names == {"decoder2", "decoder3", "decoder4"}
    assert type(model.backbone.decoder4).__name__ == type(model.backbone.decoder3).__name__ == "UnaryBlock"
    assert type(model.backbone.decoder2).__name__ == "LastUnaryBlock"
    assert model.backbone.decoder2.mlp.out_features == cfg.backbone.output_dim
    assert model.transformer.in_proj.in_features == cfg.backbone.init_dim * 2**5 == cfg.geotransformer.input_dim
    assert set(from_jax_variables(variables)) == set(model.state_dict())
    assert [int(m.sum()) for m in data["ref"]["masks"]] == [450, 378, 232, 97, 33]


def test_backbone_levels(slice_setup):
    """Backbone outputs at levels 1 to 4 (f32) against the JAX backbone."""
    cfg, _, data, variables, _ = slice_setup
    want = _jax_backbone(cfg, variables, data, "float32")
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    tdata = to_torch(data)
    with torch.no_grad():
        got = model.backbone(torch.stack([tdata["ref_feats"], tdata["src_feats"]]),
                             _stack_pair(tdata["ref"], tdata["src"]))
    assert len(got) == len(want) == 4
    assert got[0].shape[1:] == (cfg.capacities.points[1], cfg.backbone.output_dim)
    assert got[-1].shape[1:] == (cfg.capacities.points[4], cfg.backbone.init_dim * 2**5)
    for level, (g, w) in enumerate(zip(got, want), start=1):
        assert_close(g, w, name=f"level {level}")


def test_slice_on_the_jax_pyramid(slice_setup):
    """The whole inference forward: fine features and patches on level-1
    points (K = 16), matching scores, correspondences and the transform."""
    cfg, _, data, variables, want = slice_setup
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    got = model(to_torch(data))
    assert got["ref_points_f"].shape[0] == cfg.capacities.points[1]
    assert got["ref_feats_c"].shape[0] == cfg.capacities.points[4]
    assert int(got["corr_masks"].sum()) > 0
    _check_slice(got, want)


def test_slice_on_the_port_pyramid(slice_setup):
    """The port builds its own 5-level pyramid: every level's points equal
    to the JAX package's and every table equal up to the order of tied
    neighbors (column 0, which nearest_upsample reads, too), then the same
    forward."""
    cfg, arrays, data, variables, want = slice_setup
    pdata = build_registration_inputs(*(torch.from_numpy(a) for a in arrays), *_pyramid_args(cfg),
                                      search_chunk=cfg.capacities.search_chunk)
    _check_pyramid(pdata, data, 5)
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    _check_slice(model(pdata), want)


def _check_pyramid(ours, theirs, num_stages, tie_tol=1e-6):
    """Both packages' pyramids of one pair: points and masks per level, and
    the neighbor, subsampling and upsampling tables (assert_tables_match)."""
    for side in ("ref", "src"):
        points = theirs[side]["points"]
        assert len(ours[side]["points"]) == len(points) == num_stages
        for level, (g, w) in enumerate(zip(ours[side]["points"], points)):
            assert_close(g, w, name=f"{side} points {level}")
            np.testing.assert_array_equal(to_np(ours[side]["masks"][level]), np.asarray(theirs[side]["masks"][level]))
        for key, queries, supports in (("neighbors", points, points), ("subsampling", points[1:], points),
                                       ("upsampling", points, points[1:])):
            assert len(ours[side][key]) == len(theirs[side][key]) == (num_stages if key == "neighbors"
                                                                     else num_stages - 1)
            for level, (g, w) in enumerate(zip(ours[side][key], theirs[side][key])):
                assert_tables_match(g, w, queries[level], supports[level], name=f"{side} {key} {level}",
                                    tie_tol=tie_tol)


def _surface_pair_transform():
    """The ground truth of surface_pair: ref = base + 1.5, src = base R^T + 0.2
    (R a 0.3 rad turn about z), so ref = R^T (src - 0.2) + 1.5."""
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    transform = np.eye(4, dtype=np.float32)
    transform[:3, :3] = rot.T
    transform[:3, 3] = 1.5 - rot.T @ np.full(3, 0.2, np.float32)
    return transform


@pytest.fixture(scope="module")
def train_setup(slice_setup):
    """One train step of both packages from the same weights, pyramid (with
    its ground truth) and target keys, on the slice's surface pair. (On
    tests/utils.py::synthetic_pair the JAX package's jitted f32 gradient of
    the level-2 blocks lies 3e-2 of their magnitude from its own op-by-op
    gradient, so no f32 evaluation pins it to 1e-3; PERF.md.)"""
    cfg, arrays, _, variables, _ = slice_setup
    with jax.default_matmul_precision("highest"):
        data = jax.device_get(jax.jit(lambda *a: jax_build_inputs(
            *a, *_pyramid_args(cfg), transform=jnp.asarray(_surface_pair_transform()),
            search_chunk=cfg.capacities.search_chunk))(*(jnp.array(a) for a in arrays)))
    model = JaxGeoTransformer(cfg)
    keys = np.random.default_rng(1).uniform(size=cfg.capacities.points[-1] ** 2).astype(np.float32)

    def loss_fn(params):
        out = model.apply({"params": params, "buffers": variables["buffers"]}, data, training=True,
                          rngs={"target": jax.random.key(3)})
        losses = jax_overall_loss(out, data["transform"], cfg.coarse_loss, cfg.fine_loss, cfg.loss)
        return losses["loss"], losses

    with pytest.MonkeyPatch.context() as mp:
        uniform = jax.random.uniform
        mp.setattr(jax.random, "uniform", lambda key, shape=(), *args, **kw: (
            jnp.asarray(keys) if tuple(shape) == keys.shape else uniform(key, shape, *args, **kw)))
        with jax.default_matmul_precision("highest"):
            grads, jax_losses = jax.device_get(jax.jit(jax.grad(loss_fn, has_aux=True))(variables["params"]))
    port = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    state = TrainState(port, port.cfg.optim, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_geotransformer, "superpoint_target_sample",
                   functools.partial(port_geotransformer.superpoint_target_sample, keys=torch.from_numpy(keys)))
        losses = train_step(port, state, to_torch(data))
    return {"jax_losses": jax_losses, "jax_grads": jax_gradients_by_name(grads), "losses": losses, "port": port}


def test_train_step_losses(train_setup):
    for key in ("loss", "c_loss", "f_loss"):
        assert np.isfinite(float(train_setup["losses"][key])) and float(train_setup["jax_losses"][key]) > 0, key
        assert_close(train_setup["losses"][key], train_setup["jax_losses"][key], name=key)


def test_train_step_gradients_by_name(train_setup):
    """Every parameter's gradient, each against max(its largest magnitude,
    1e-3 of the model's largest gradient), as at 3 and 4 stages; the
    gradient reaches all three decoders."""
    want = train_setup["jax_grads"]
    named = dict(train_setup["port"].named_parameters())
    assert set(named) == set(want)
    floor = 1e-3 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in named.items():
        w = want[name].numpy()
        assert p.grad is not None, name
        assert _relative_error(p.grad, w, scale=max(float(np.abs(w).max()), floor)) <= STEP_GRAD_TOL, name
    for name in ("backbone.decoder2.mlp.weight", "backbone.decoder3.mlp.weight", "backbone.decoder4.mlp.weight",
                 "backbone.encoder5_3.unary2.mlp.weight", "transformer.embedding.proj_a.weight"):
        assert float(named[name].grad.abs().max()) > 0.0, f"no gradient reached {name}"


# ---------------------------------------------------------------------------
# The fixture tree and the odometry dataset
# ---------------------------------------------------------------------------

def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_fixture_tree_equals_the_tool_tree(tmp_path):
    """The port's fixture at its defaults against
    tools/train_kitti_fixture.py's: the same files, byte for byte."""
    from tools.train_kitti_fixture import make_fixture_tree as tool_fixture_tree

    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    make_fixture_tree(ours)
    tool_fixture_tree(theirs)
    files = _tree_files(theirs)
    assert _tree_files(ours) == files and len(files) == 3 + 2 * (4 + 2 + 2)
    for name in files:
        assert filecmp.cmp(os.path.join(ours, name), os.path.join(theirs, name), shallow=False), name


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    make_fixture_tree(root)
    return root


@pytest.mark.parametrize("subset,kwargs", [
    ("train", dict(point_limit=1500, use_augmentation=True, augmentation_noise=0.01, seed=7351)),
    ("val", dict(seed=7351)),
    ("test", dict()),
    ("test", dict(return_corr_indices=True, matching_radius=0.6)),
])
def test_dataset_samples_equal_jax(kitti_root, subset, kwargs):
    """Two passes over the items, which continue both generators: bit for
    bit the JAX dataset's."""
    ours = OdometryKittiPairDataset(kitti_root, subset, **kwargs)
    theirs = JaxKittiDataset(kitti_root, subset, **kwargs)
    assert len(ours) == len(theirs) == {"train": 4, "val": 2, "test": 2}[subset]
    for _ in range(2):
        for i in range(len(theirs)):
            assert_identical(ours[i], theirs[i], f"{subset} item {i}")
    item = ours[0]
    assert item["scene_name"] == {"train": "seq00", "val": "seq06", "test": "seq08"}[subset]
    if "return_corr_indices" in kwargs:
        assert item["corr_indices"].shape[1] == 2 and len(item["corr_indices"]) > 100
    if "point_limit" in kwargs:
        assert len(item["ref_points"]) == 1500


def test_falloff_scans_fill_the_published_capacities(tmp_path):
    """The card's fixture size (20000-point scans over 40 m, the ground thinned
    with range): every level of every scan under its published cap, the
    coarse level at least half of its 384 slots."""
    make_fixture_tree(str(tmp_path), points=20000, radius=40.0, falloff=True)
    caps = make_kitti_cfg().capacities.points
    for subset in ("val", "test"):
        dataset = OdometryKittiPairDataset(str(tmp_path), subset)
        for i in range(len(dataset)):
            for side in ("ref_points", "src_points"):
                one = [{"ref_points": dataset[i][side], "src_points": dataset[i][side]}]
                counts = calibration.calibrate_capacities(one, 5, 0.3, headroom=1.0, align=1, device="cpu")
                assert all(n < cap for n, cap in zip(counts, caps)), (subset, i, side, counts)
                assert counts[4] >= caps[4] // 2, (subset, i, side, counts)


# ---------------------------------------------------------------------------
# Voxel counts, neighbor distances and the calibration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_items(kitti_root):
    """The test pairs of the fixture tree (no augmentation)."""
    dataset = OdometryKittiPairDataset(kitti_root, "test")
    return [dataset[i] for i in range(len(dataset))]


def test_count_voxels_equals_jax(kitti_items):
    for item in kitti_items:
        points, masks = pad_points(item["src_points"], 2048)
        for voxel in (0.3, 0.6, 1.2, 2.4, 4.8):
            got = count_voxels(torch.from_numpy(points), torch.from_numpy(masks), voxel)
            assert isinstance(got, int) and got == int(jax_count_voxels(jnp.array(points), jnp.array(masks), voxel))


def test_topk_neighbor_distances_equal_jax(kitti_items):
    """The 128 nearest valid supports' squared distances, ascending (1e12 past
    the valid ones), on a scan up to 10 m from the origin. Both packages
    expand |q|^2 - 2 q.s + |s|^2 in f32, whose rounding grows with |p|^2
    (~1e-5 m^2 at 100 m^2): each distance is held to 4 f32 ulps of
    |q|^2 + |s|^2, the expansion's own error bound."""
    points, masks = pad_points(kitti_items[0]["ref_points"], 2048)
    got = to_np(topk_neighbor_distances(torch.from_numpy(points), torch.from_numpy(points),
                                        torch.from_numpy(masks), 128)).astype(np.float64)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_chunked_topk_neighbors(jnp.array(points), jnp.array(points), jnp.array(masks), 128, 1024)[0])
    assert got.shape == want.shape == (2048, 128)
    assert np.all(np.diff(got, axis=1) >= 0)
    valid = want < 1e11
    np.testing.assert_array_equal(got >= 1e11, ~valid)
    sq = np.sum(points.astype(np.float64) ** 2, axis=1)
    tol = 4 * np.finfo(np.float32).eps * (sq[:, None] + sq[masks].max())
    assert np.all(np.abs(got - want)[valid] <= np.broadcast_to(tol, got.shape)[valid])


def test_calibration_equals_jax(kitti_items):
    """Both functions give the JAX package's integers on the same pairs, at
    the published voxel, radius and (scaled) capacities."""
    bb = make_kitti_cfg().backbone
    # one pair for the capacities: the JAX function runs op by op, ~12 s a pair
    caps = calibration.calibrate_capacities(kitti_items, bb.num_stages, bb.init_voxel_size, num_samples=1,
                                            device="cpu")
    assert caps == jax_calibration.calibrate_capacities(kitti_items, bb.num_stages, bb.init_voxel_size,
                                                        num_samples=1)
    assert caps == (2048, 1536, 768, 256, 256)
    capacities = (2048, 1024, 512, 256, 128)
    limits = calibration.calibrate_neighbor_limits(kitti_items, bb.num_stages, bb.init_voxel_size, bb.init_radius,
                                                   capacities, device="cpu")
    assert limits == jax_calibration.calibrate_neighbor_limits(kitti_items, bb.num_stages, bb.init_voxel_size,
                                                               bb.init_radius, capacities)
    assert limits == (40, 73, 112, 89, 47)


def test_pyramid_on_a_fixture_scan(kitti_items):
    """Both packages' pyramids of a fixture pair at the published voxel,
    radius and neighbor limits (capacities that leave every level room): the
    scans lie up to 10 m from the origin, and a voxel of two points puts its
    centroid midway between them, so rows may order tied neighbors
    differently; every difference must be such a tie."""
    cfg = make_kitti_cfg()
    bb = cfg.backbone
    caps = (2048, 1536, 512, 256, 128)
    args = (bb.num_stages, bb.init_voxel_size, bb.init_radius, cfg.capacities.neighbor_limits, caps)
    item = kitti_items[-1]
    arrays = pad_points(item["ref_points"], caps[0]) + pad_points(item["src_points"], caps[0])
    with jax.default_matmul_precision("highest"):
        theirs = jax.device_get(jax.jit(lambda *a: jax_build_inputs(*a, *args, search_chunk=512))(
            *(jnp.array(a) for a in arrays)))
    ours = build_registration_inputs(*(torch.from_numpy(a) for a in arrays), *args, search_chunk=512)
    for side in ("ref", "src"):
        counts = [int(np.asarray(m).sum()) for m in theirs[side]["masks"]]
        assert all(n < cap for n, cap in zip(counts, caps)), counts
    _check_pyramid(ours, theirs, 5)


# ---------------------------------------------------------------------------
# Offline eval
# ---------------------------------------------------------------------------

def _jax_eval_module():
    """experiments/geotransformer_kitti_stage5/eval.py, which imports its
    sibling `config` from its own directory."""
    sys.path.insert(0, JAX_EXPERIMENT_DIR)
    for name in ("config", "eval"):
        sys.modules.pop(name, None)
    try:
        return importlib.import_module("eval")
    finally:
        sys.path.remove(JAX_EXPERIMENT_DIR)
        for name in ("config", "eval"):
            sys.modules.pop(name, None)


def _write_dumps(feature_dir, noisy):
    """The synthetic dumps of tests/test_offline_eval_e2e.py (perfect
    correspondences and transforms), or with noise on the correspondences,
    an outlier share and a perturbed stored transform, so that no summary
    value sits at 0 or 1 by construction."""
    from scipy.spatial.transform import Rotation

    from tests.test_offline_eval_e2e import _random_transform

    rng = np.random.default_rng(1)
    for i, (a, b) in enumerate([(0, 5), (10, 16), (20, 27)]):
        transform = _random_transform(10 + i)
        n_c, n_corr = 30, 90
        src_corr = rng.uniform(-20, 20, (n_corr, 3)).astype(np.float32)
        ref_corr = src_corr @ transform[:3, :3].T + transform[:3, 3]
        estimated = transform
        scores = np.ones(n_corr, np.float32)
        if noisy:
            ref_corr = ref_corr + rng.normal(0, 0.6, ref_corr.shape).astype(np.float32)
            out = rng.random(n_corr) < 0.3 * i
            ref_corr[out] = rng.uniform(-20, 20, (int(out.sum()), 3))
            scores = rng.uniform(0.1, 1.0, n_corr).astype(np.float32)
            estimated = transform.copy()
            estimated[:3, :3] = Rotation.from_euler("z", 3.0 * i, degrees=True).as_matrix() @ transform[:3, :3]
            estimated[:3, 3] += 0.9 * i
        gt_map = np.zeros((n_c, n_c), np.float32)
        idx, jdx = rng.integers(0, n_c, 20), rng.integers(0, n_c, 20)
        gt_map[idx, jdx] = rng.uniform(0.2, 0.9, 20)
        sel = rng.integers(0, 40 if noisy else 20, 15)
        np.savez_compressed(
            os.path.join(feature_dir, f"seq08_{a}_{b}.npz"),
            ref_points_c=rng.normal(size=(n_c, 3)).astype(np.float32),
            src_points_c=rng.normal(size=(n_c, 3)).astype(np.float32),
            ref_node_corr_indices=np.concatenate([idx, rng.integers(0, n_c, 20)])[sel],
            src_node_corr_indices=np.concatenate([jdx, rng.integers(0, n_c, 20)])[sel],
            ref_corr_points=ref_corr.astype(np.float32),
            src_corr_points=src_corr,
            corr_scores=scores,
            gt_node_corr_overlaps=gt_map,
            estimated_transform=estimated.astype(np.float32),
            transform=transform,
        )


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("method,num_corr", [("lgr", None), ("svd", None), ("svd", 40), ("ransac", 60)])
def test_eval_summary_equals_jax(tmp_path, monkeypatch, noisy, method, num_corr):
    """The offline protocol's summary, key for key, against the JAX
    experiment's eval.py on the same dumps (RANSAC at 200 iterations in
    both, in place of the published 50000)."""
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    _write_dumps(str(tmp_path), noisy)
    jax_eval = _jax_eval_module()
    args = SimpleNamespace(method=method, num_corr=num_corr, feature_dir=str(tmp_path), verbose=False)
    ours_cfg, theirs_cfg = exp_config.make_cfg(), jax_eval.make_cfg()
    ours_cfg = ours_cfg.replace(ransac=dataclasses.replace(ours_cfg.ransac, num_iterations=200))
    theirs_cfg = theirs_cfg.replace(ransac=dataclasses.replace(theirs_cfg.ransac, num_iterations=200))
    ours = exp_eval.eval_one_epoch(args, ours_cfg)
    theirs = jax_eval.eval_one_epoch(args, theirs_cfg)
    assert ours == theirs
    if noisy:
        assert 0.0 < ours["IR"] < 1.0 and 0.0 < ours["PIR"] < 1.0
    else:
        assert ours["RR"] == 1.0 and ours["FMR"] == 1.0


def test_eval_main_prints_the_summary(tmp_path, monkeypatch, capsys):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("REF_GT_OUTPUT_ROOT", str(tmp_path / "out"))
    os.makedirs(exp_config.FEATURE_DIR)
    _write_dumps(exp_config.FEATURE_DIR, noisy=True)
    summary = exp_eval.main(["--method", "svd", "--verbose"])
    out = capsys.readouterr().out
    assert "seq08_0_5: c_PIR" in out and str({k: round(v, 4) for k, v in summary.items()}) in out
    assert 0.0 <= summary["RR"] <= 1.0


# ---------------------------------------------------------------------------
# Experiment config
# ---------------------------------------------------------------------------

def _jax_experiment_config():
    """A fresh import of experiments/geotransformer_kitti_stage5/config.py
    (its constants are read from the environment on import)."""
    spec = importlib.util.spec_from_file_location("jax_experiment_kitti_config",
                                                  os.path.join(JAX_EXPERIMENT_DIR, "config.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("scale", [None, "0.1", "0.3", "0.04"])
def test_experiment_config_matches_jax(monkeypatch, scale):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    if scale is not None:
        monkeypatch.setenv("REF_GT_CAPS_SCALE", scale)
    ours = exp_config.make_cfg()
    theirs = _jax_experiment_config().make_cfg()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours == port_config(theirs)
    assert (ours.backbone.num_stages, ours.backbone.fine_level, ours.model.num_points_in_patch) == (5, 1, 128)
    if scale is None:
        assert ours == make_kitti_cfg()
        assert ours.capacities.points == (30720, 10240, 3072, 1024, 384)
    elif scale == "0.1":
        assert ours.capacities.points == (3072, 1024, 307, 128, 128)
        assert ours.capacities.gt_candidates == 512 and ours.capacities.search_chunk == 512


def test_experiment_directories_follow_the_environment(monkeypatch, tmp_path):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("REF_GT_OUTPUT_ROOT", str(tmp_path / "out"))
    monkeypatch.setenv("REF_GT_KITTI_ROOT", str(tmp_path / "Kitti"))
    theirs = _jax_experiment_config()
    for name in ("OUTPUT_DIR", "SNAPSHOT_DIR", "LOG_DIR", "FEATURE_DIR", "REGISTRATION_DIR", "DATASET_ROOT"):
        assert getattr(exp_config, name) == getattr(theirs, name), name
    monkeypatch.delenv("REF_GT_OUTPUT_ROOT")
    monkeypatch.delenv("REF_GT_KITTI_ROOT")
    assert exp_config.SNAPSHOT_DIR == os.path.join(ROOT, "output", "torch", "geotransformer_kitti_stage5", "snapshots")
    assert exp_config.DATASET_ROOT == os.path.join(ROOT, "data", "Kitti")
    with pytest.raises(AttributeError):
        exp_config.NOT_A_DIRECTORY
