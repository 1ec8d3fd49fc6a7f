"""PyTorch port vs JAX package: the host-side data layer and the experiment config.

* every copied numpy function (transforms, pointcloud, registration, the
  3DMatch benchmark protocol, the feature dump) against the JAX package's
  on the same seeded inputs: integers and booleans exact, floats to 1e-6
  relative;
* the fixture tree of the port against `tools/train_3dmatch_fixture.py`'s;
* `ThreeDMatchPairDataset` and `PairLoader` on a fixture tree: identical
  batches for the same seed, with augmentation on and off;
* the port's 3DMatch experiment config against the JAX experiment's, field
  by field, with no override and under each environment override.
"""

import dataclasses
import filecmp
import importlib.util
import os
import pickle
import types

import numpy as np
import pytest
import torch

from ref_geotransformer_tpu.data import PairLoader as JaxPairLoader
from ref_geotransformer_tpu.data import benchmark_3dmatch as jax_benchmark
from ref_geotransformer_tpu.data import pointcloud as jax_pointcloud
from ref_geotransformer_tpu.data import transforms as jax_transforms
from ref_geotransformer_tpu.data.datasets import ThreeDMatchPairDataset as JaxDataset
from ref_geotransformer_tpu.utils import feature_dump as jax_feature_dump
from ref_geotransformer_tpu.utils import registration as jax_registration
from ref_geotransformer_tpu_torch.data import PairLoader
from ref_geotransformer_tpu_torch.data import benchmark_3dmatch, pointcloud, transforms
from ref_geotransformer_tpu_torch.data.datasets import ThreeDMatchPairDataset
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import config as port_config_module
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4.fixture import make_fixture_tree
from ref_geotransformer_tpu_torch.utils import feature_dump, registration
from tests.torch_port_utils import ROOT, port_config, tiny4_config
from tools.train_3dmatch_fixture import make_fixture_tree as jax_make_fixture_tree

FLOAT_RTOL = 1e-6
JAX = types.SimpleNamespace(transforms=jax_transforms, pointcloud=jax_pointcloud, registration=jax_registration,
                            benchmark=jax_benchmark, feature_dump=jax_feature_dump)
PORT = types.SimpleNamespace(transforms=transforms, pointcloud=pointcloud, registration=registration,
                             benchmark=benchmark_3dmatch, feature_dump=feature_dump)


def assert_same(got, want, path="out"):
    """Recursive equality: integers, booleans and strings exact, floats to FLOAT_RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for key in want:
            assert_same(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


def _inputs():
    rng = np.random.default_rng(20)
    points = rng.normal(size=(300, 3)).astype(np.float32)
    normals = rng.normal(size=(300, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    transform = np.eye(4, dtype=np.float32)
    transform[:3, :3] = jax_pointcloud.random_sample_rotation_v2(rng)
    transform[:3, 3] = rng.normal(size=3)
    src = points[:200]
    ref = src @ transform[:3, :3].T + transform[:3, 3] + rng.normal(0, 0.01, (200, 3)).astype(np.float32)
    ref[150:] = rng.normal(size=(50, 3))  # outliers
    scores = rng.uniform(0.1, 1.0, 200).astype(np.float32)
    return types.SimpleNamespace(points=points, normals=normals, feats=rng.normal(size=(300, 8)).astype(np.float32),
                                 scores300=rng.uniform(0.1, 1.0, 300), transform=transform, ref=ref, src=src,
                                 scores=scores, gt_map=rng.uniform(0, 1, (40, 30)) * (rng.uniform(size=(40, 30)) < 0.2))


X = _inputs()


def _scene(m, rng, tmp):
    """gt.log / gt.info / est.log of a 12-fragment scene; the scene's
    registration result."""
    os.makedirs(tmp, exist_ok=True)
    pairs = [(0, 1), (0, 3), (2, 7), (4, 9), (5, 6), (8, 11)]
    gt, est, info = [], [], []
    for a, b in pairs:
        t = np.eye(4)
        t[:3, :3] = jax_pointcloud.random_sample_rotation_v2(rng)
        t[:3, 3] = rng.normal(size=3)
        e = t.copy()
        e[:3, 3] += rng.normal(0, 0.15, 3)
        gt.append({"test_pair": [a, b], "num_fragments": 12, "transform": t})
        est.append({"test_pair": [a, b], "num_fragments": 12, "transform": e})
        cov = rng.normal(size=(6, 6))
        info.append(cov @ cov.T + 6 * np.eye(6))
    m.benchmark.write_log_file(os.path.join(tmp, "gt.log"), gt)
    m.benchmark.write_log_file(os.path.join(tmp, "est.log"), est)
    with open(os.path.join(tmp, "gt.info"), "w") as f:
        for (a, b), cov in zip(pairs, info):
            f.write(f"{a}\t{b}\t12\n")
            for row in cov:
                f.write("\t".join(repr(float(x)) for x in row) + "\n")
    return m.benchmark.evaluate_registration_one_scene(
        os.path.join(tmp, "gt.log"), os.path.join(tmp, "gt.info"), os.path.join(tmp, "est.log"))


def _dump(m, rng, tmp):
    """A feature dump of a padded output dict: the .npz's arrays."""
    os.makedirs(tmp, exist_ok=True)
    mc, mf, p, n, k = 40, 120, 16, 200, 64
    node_masks = rng.uniform(size=(2, mc)) < 0.8
    data = {"ref_points": rng.normal(size=(n, 3)).astype(np.float32), "ref_masks": rng.uniform(size=n) < 0.9,
            "src_points": rng.normal(size=(n, 3)).astype(np.float32), "src_masks": rng.uniform(size=n) < 0.9,
            "transform": X.transform}
    output = {
        "ref_node_masks": node_masks[0], "src_node_masks": node_masks[1],
        "ref_masks_f": rng.uniform(size=mf) < 0.9, "src_masks_f": rng.uniform(size=mf) < 0.9,
        "corr_masks": rng.uniform(size=k) < 0.5,
        "ref_node_corr_indices": rng.choice(np.flatnonzero(node_masks[0]), p).astype(np.int32),
        "src_node_corr_indices": rng.choice(np.flatnonzero(node_masks[1]), p).astype(np.int32),
        "gt_node_overlap_map": rng.uniform(size=(mc, mc)).astype(np.float32),
        "estimated_transform": X.transform,
    }
    for name, shape in (("ref_points_f", (mf, 3)), ("src_points_f", (mf, 3)), ("ref_points_c", (mc, 3)),
                        ("src_points_c", (mc, 3)), ("ref_feats_c", (mc, 32)), ("src_feats_c", (mc, 32)),
                        ("ref_corr_points", (k, 3)), ("src_corr_points", (k, 3)), ("corr_scores", (k,))):
        output[name] = rng.normal(size=shape).astype(np.float32)
    meta = {"scene_name": "scene", "ref_frame": 3, "src_frame": 8, "overlap": 0.4}
    path = m.feature_dump.dump_registration_npz(str(tmp), data, meta, output)
    assert os.path.basename(path) == "scene_3_8.npz"
    with np.load(path) as f:
        return {key: f[key] for key in f.files}


CASES = {
    "transforms.normalize_points": lambda m, rng, tmp: m.transforms.normalize_points(X.points),
    "transforms.sample_points": lambda m, rng, tmp: m.transforms.sample_points(X.points, 100, X.normals),
    "transforms.random_sample_points": lambda m, rng, tmp: (
        m.transforms.random_sample_points(X.points, 100, X.normals, rng=rng),
        m.transforms.random_sample_points(X.points, 700, rng=rng)),
    "transforms.random_scale_shift_points": lambda m, rng, tmp: m.transforms.random_scale_shift_points(
        X.points, normals=X.normals, rng=rng),
    "transforms.random_rotate_points_along_up_axis": lambda m, rng, tmp: (
        m.transforms.random_rotate_points_along_up_axis(X.points, X.normals, rng=rng)),
    "transforms.random_rescale_points": lambda m, rng, tmp: m.transforms.random_rescale_points(X.points, rng=rng),
    "transforms.random_jitter_points": lambda m, rng, tmp: m.transforms.random_jitter_points(X.points, 0.01, rng=rng),
    "transforms.random_shuffle_points": lambda m, rng, tmp: m.transforms.random_shuffle_points(
        X.points, X.normals, rng=rng),
    "transforms.random_dropout_points": lambda m, rng, tmp: m.transforms.random_dropout_points(X.points, 0.5, rng=rng),
    "transforms.random_jitter_features": lambda m, rng, tmp: [
        m.transforms.random_jitter_features(X.feats, rng=rng) for _ in range(5)],
    "transforms.random_crop_points_with_plane": lambda m, rng, tmp: m.transforms.random_crop_points_with_plane(
        X.points, normals=X.normals, rng=rng),
    "transforms.random_crop_points_from_viewpoint": lambda m, rng, tmp: (
        m.transforms.random_crop_points_from_viewpoint(X.points, normals=X.normals, rng=rng)),
    "pointcloud.transforms": lambda m, rng, tmp: (
        m.pointcloud.np_apply_transform(X.points, X.transform), m.pointcloud.np_inverse_transform(X.transform),
        m.pointcloud.np_get_transform(X.transform[:3, :3], X.transform[:3, 3])),
    "pointcloud.random_sample_rotation": lambda m, rng, tmp: (
        m.pointcloud.random_sample_rotation(1.0, rng), m.pointcloud.random_sample_rotation(4.0, rng),
        m.pointcloud.random_sample_rotation_v2(rng)),
    "pointcloud.random_point_limit": lambda m, rng, tmp: (
        m.pointcloud.random_point_limit(X.points, 120, rng), m.pointcloud.random_point_limit(X.points, None, rng)),
    "pointcloud.get_nearest_correspondences": lambda m, rng, tmp: m.pointcloud.get_nearest_correspondences(
        X.ref, X.src, X.transform, 0.05),
    "pointcloud.keypoints": lambda m, rng, tmp: (
        m.pointcloud.random_sample_keypoints(X.points, X.feats, 50, rng),
        m.pointcloud.sample_keypoints_with_scores(X.points, X.feats, X.scores300, 50),
        m.pointcloud.random_sample_keypoints_with_scores(X.points, X.feats, X.scores300, 50, rng),
        m.pointcloud.sample_keypoints_with_nms(X.points, X.feats, X.scores300, 50, 0.3),
        m.pointcloud.random_sample_keypoints_with_nms(X.points, X.feats, X.scores300, 30, 0.3, rng)),
    "pointcloud.regularize_normals": lambda m, rng, tmp: (
        m.pointcloud.regularize_normals(X.points, X.normals), m.pointcloud.regularize_normals(X.points, X.normals,
                                                                                             False)),
    "registration.errors": lambda m, rng, tmp: (
        m.registration.compute_registration_error(X.transform, m.pointcloud.np_inverse_transform(X.transform)),
        m.registration.compute_inlier_ratio(X.ref, X.src, X.transform),
        m.registration.compute_overlap(X.ref, X.src, X.transform),
        m.registration.compute_registration_rmse(X.src, X.transform, np.eye(4, dtype=np.float32))),
    "registration.weighted_procrustes_np": lambda m, rng, tmp: (
        m.registration.weighted_procrustes_np(X.src, X.ref, X.scores), m.registration.weighted_procrustes_np(
            X.src, X.ref)),
    "registration.ransac_registration_np": lambda m, rng, tmp: m.registration.ransac_registration_np(
        X.ref, X.src, 0.05, 3, 200),
    "registration.evaluate_sparse_correspondences": lambda m, rng, tmp: (
        m.registration.evaluate_sparse_correspondences(X.points[:40], X.points[:30], rng.integers(0, 40, 25),
                                                       rng.integers(0, 30, 25), X.gt_map)),
    "registration.evaluate_correspondences": lambda m, rng, tmp: m.registration.evaluate_correspondences(
        X.ref, X.src, X.transform, 0.1),
    "benchmark_3dmatch.evaluate_registration_one_scene": _scene,
    "benchmark_3dmatch.compute_transform_error": lambda m, rng, tmp: m.benchmark.compute_transform_error(
        X.transform.astype(np.float64), np.eye(6) * 2.0, m.pointcloud.np_inverse_transform(X.transform)),
    "feature_dump.dump_registration_npz": _dump,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_copied_function_matches_jax_package(name, tmp_path):
    """The same call, with a generator of the same seed where it takes one,
    in both packages."""
    want = CASES[name](JAX, np.random.default_rng(3), tmp_path / "jax")
    got = CASES[name](PORT, np.random.default_rng(3), tmp_path / "port")
    assert_same(got, want)


# ---------------------------------------------------------------------------
# Fixture tree, dataset and loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("threedmatch") / "tree")
    jax_make_fixture_tree(root, n_train=5, n_val=2, points=700)
    return root


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("val_from_train", [False, True])
@pytest.mark.parametrize("real_base", [False, True])
def test_port_fixture_tree_equals_the_tool_tree(tmp_path, real_base, val_from_train):
    bases = [os.path.join(ROOT, "data", "demo", f"{n}.npy") for n in ("ref", "src")] if real_base else None
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    kwargs = dict(n_train=3, n_val=2, points=500, real_base=bases, val_from_train=val_from_train)
    make_fixture_tree(ours, **kwargs)
    jax_make_fixture_tree(theirs, **kwargs)
    files = _tree_files(theirs)
    assert _tree_files(ours) == files and len(files) == 3 * 2 + 2 * 2 + 2 + 2
    for name in files:
        if name.endswith(".pth"):
            assert torch.equal(torch.load(os.path.join(ours, name)), torch.load(os.path.join(theirs, name))), name
        elif name.endswith(".pkl"):
            with open(os.path.join(ours, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
                assert_same(pickle.load(a), pickle.load(b), name)
        else:
            assert filecmp.cmp(os.path.join(ours, name), os.path.join(theirs, name), shallow=False), name


@pytest.mark.parametrize("augment", [False, True])
def test_dataset_items_match(fixture_tree, augment):
    kwargs = dict(point_limit=600, use_augmentation=augment, augmentation_noise=0.005, augmentation_rotation=1.0,
                  seed=11)
    ours, theirs = ThreeDMatchPairDataset(fixture_tree, "train", **kwargs), JaxDataset(fixture_tree, "train", **kwargs)
    assert len(ours) == len(theirs) == 5
    for _ in range(2):  # the second pass continues both generators
        for i in range(len(theirs)):
            assert_same(ours[i], theirs[i], f"item {i}")


@pytest.mark.parametrize("augment", [False, True])
def test_loader_batches_match(fixture_tree, augment):
    """Two epochs of shuffled batches of 2 with a repeat-padded final batch
    (5 pairs), through the prefetching worker thread, then the single-pair
    iteration of the tester."""
    cfg = tiny4_config()

    def loader(pkg_loader, pkg_dataset, c):
        dataset = pkg_dataset(fixture_tree, "train", point_limit=600, use_augmentation=augment, seed=11)
        return pkg_loader(dataset, c, batch_size=2, shuffle=True, drop_last=False, seed=5)

    ours, theirs = loader(PairLoader, ThreeDMatchPairDataset, port_config(cfg)), loader(JaxPairLoader, JaxDataset, cfg)
    assert len(ours) == len(theirs) == 3
    for epoch in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"epoch {epoch} batch {i}")
            assert a["ref_points"].shape == (2, cfg.capacities.points[0], 3)
        np.testing.assert_array_equal(got[-1]["_pair_masks"], [True, False])
    for (a, meta_a), (b, meta_b) in zip(ours.iter_single(), theirs.iter_single()):
        assert_same(a, b)
        assert meta_a == meta_b


# ---------------------------------------------------------------------------
# Experiment config
# ---------------------------------------------------------------------------

def _jax_experiment_config():
    """A fresh import of experiments/geotransformer_3dmatch_stage4/config.py
    (its directory constants are read from the environment on import)."""
    path = os.path.join(ROOT, "experiments", "geotransformer_3dmatch_stage4", "config.py")
    spec = importlib.util.spec_from_file_location("jax_experiment_3dmatch_config", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


OVERRIDES = {
    "none": {},
    "caps_scale_0.3": {"REF_GT_CAPS_SCALE": "0.3"},
    "caps_scale_0.04": {"REF_GT_CAPS_SCALE": "0.04"},
    "neighbor_limits": {"REF_GT_NEIGHBOR_LIMITS": "32,28,28,32"},
    "lr_decay_aug": {"REF_GT_LR": "3e-4", "REF_GT_LR_DECAY": "1.0", "REF_GT_USE_AUG": "0"},
    "all": {"REF_GT_CAPS_SCALE": "0.3", "REF_GT_NEIGHBOR_LIMITS": "32,28,28,32", "REF_GT_LR": "2e-4",
            "REF_GT_USE_AUG": "0"},
}


@pytest.mark.parametrize("demo", [False, True])
@pytest.mark.parametrize("override", sorted(OVERRIDES))
def test_experiment_config_matches_jax(monkeypatch, override, demo):
    for key in ("REF_GT_CAPS_SCALE", "REF_GT_NEIGHBOR_LIMITS", "REF_GT_LR", "REF_GT_LR_DECAY", "REF_GT_USE_AUG"):
        monkeypatch.delenv(key, raising=False)
    for key, value in OVERRIDES[override].items():
        monkeypatch.setenv(key, value)
    ours = port_config_module.make_cfg(demo=demo)
    theirs = _jax_experiment_config().make_cfg(demo=demo)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours == port_config(theirs)
    if override == "caps_scale_0.3":
        assert ours.capacities.points[-1] == (153 if demo else 307)


def test_experiment_directories_follow_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("REF_GT_OUTPUT_ROOT", str(tmp_path / "out"))
    monkeypatch.setenv("REF_GT_3DMATCH_ROOT", str(tmp_path / "3DMatch"))
    theirs = _jax_experiment_config()
    for name in ("OUTPUT_DIR", "SNAPSHOT_DIR", "LOG_DIR", "EVENT_DIR", "FEATURE_DIR", "REGISTRATION_DIR",
                 "DATASET_ROOT"):
        assert getattr(port_config_module, name) == getattr(theirs, name), name
    monkeypatch.delenv("REF_GT_OUTPUT_ROOT")
    assert port_config_module.SNAPSHOT_DIR == os.path.join(ROOT, "output", "torch", "geotransformer_3dmatch_stage4",
                                                           "snapshots")
    with pytest.raises(AttributeError):
        port_config_module.NOT_A_DIRECTORY
