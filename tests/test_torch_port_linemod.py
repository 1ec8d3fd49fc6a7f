"""PyTorch port vs JAX package: the LineMod encoder experiment's model and data.

* the 3-stage model with decoders down to level 0 (the LineMod encoder's
  shape, tiny widths): backbone levels, the whole inference forward and one
  train step's losses and gradients, on shared weights (utils/weights.py)
  and shared target keys;
* the PNG reader and writer against PIL;
* the BOP reader: `LMODataset` samples bit for bit equal to the JAX
  package's on the same fixture tree and seed (train with augmentation, and
  test), and its cache file; `ModelNetPairDataset` likewise; the fixture
  trees against the JAX package's generators;
* the experiment's config and its environment overrides.

The JAX side runs jitted at `jax.default_matmul_precision("highest")`.
"""

import dataclasses
import filecmp
import functools
import importlib.util
import json
import os
import pickle
import struct
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ref_geotransformer_tpu_torch.models.geotransformer as port_geotransformer
from ref_geotransformer_tpu.data.datasets.linemod import LMODataset as JaxLMODataset
from ref_geotransformer_tpu.data.datasets.modelnet import ModelNetPairDataset as JaxModelNetPairDataset
from ref_geotransformer_tpu.data.pyramid import build_registration_inputs as jax_build_inputs
from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu.models import init_model_variables
from ref_geotransformer_tpu.models.losses import overall_loss as jax_overall_loss
from ref_geotransformer_tpu_torch.data.datasets import bop_utils
from ref_geotransformer_tpu_torch.data.datasets.linemod import LMODataset
from ref_geotransformer_tpu_torch.data.datasets.modelnet import ModelNetPairDataset
from ref_geotransformer_tpu_torch.data.datasets.png import PNGError, read_png, write_png
from ref_geotransformer_tpu_torch.data.pyramid import build_registration_inputs
from ref_geotransformer_tpu_torch.engine import train_step
from ref_geotransformer_tpu_torch.engine.state import TrainState
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import config as exp_config
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4.fixture import (
    make_linemod_tree,
    make_modelnet_tree,
)
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer, _stack_pair
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables, jax_gradients_by_name, load_jax_variables
from tests.test_torch_port_model import _check_slice, _jax_backbone, _pyramid_args, surface_pair
from tests.test_torch_port_train import STEP_GRAD_TOL, _relative_error
from tests.torch_port_utils import ROOT, assert_close, port_config, tiny3_config, to_torch
from tests.utils import synthetic_pair

ENV_KEYS = ("REF_GT_OUTPUT_ROOT", "REF_GT_LINEMOD_ROOT", "REF_GT_MODELNET_ROOT", "REF_GT_LR", "REF_GT_WARMUP",
            "REF_GT_DDPM_STEPS")


# ---------------------------------------------------------------------------
# The 3-stage, fine-level-0 model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_setup():
    cfg = tiny3_config()
    arrays = surface_pair(cfg)
    with jax.default_matmul_precision("highest"):
        data = jax.jit(lambda *a: jax_build_inputs(*a, *_pyramid_args(cfg), search_chunk=cfg.capacities.search_chunk))(
            *(jnp.array(a) for a in arrays))
        model = JaxGeoTransformer(cfg)
        variables = init_model_variables(model, cfg, jax.random.key(0))
        out = jax.device_get(jax.jit(model.apply)(variables, data))
    return cfg, arrays, jax.device_get(data), jax.device_get(variables), out


def test_decoders_stop_at_level_0(slice_setup):
    """decoder2 is a UnaryBlock with a GroupNorm, decoder1 the LastUnaryBlock
    to output_dim; the bridge maps every JAX variable to one of them."""
    cfg, _, _, variables, _ = slice_setup
    model = GeoTransformer(port_config(cfg))
    names = {name.split(".")[1] for name, _ in model.backbone.named_parameters(prefix="backbone")
             if name.startswith("backbone.decoder")}
    assert names == {"decoder1", "decoder2"}
    assert type(model.backbone.decoder2).__name__ == "UnaryBlock"
    assert type(model.backbone.decoder1).__name__ == "LastUnaryBlock"
    assert model.backbone.decoder1.mlp.out_features == cfg.backbone.output_dim
    assert set(from_jax_variables(variables)) == set(model.state_dict())


def test_backbone_levels(slice_setup):
    """Backbone outputs at levels 0, 1 and 2 (f32) against the JAX backbone."""
    cfg, _, data, variables, _ = slice_setup
    want = _jax_backbone(cfg, variables, data, "float32")
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    tdata = to_torch(data)
    with torch.no_grad():
        got = model.backbone(torch.stack([tdata["ref_feats"], tdata["src_feats"]]),
                             _stack_pair(tdata["ref"], tdata["src"]))
    assert len(got) == len(want) == 3
    assert got[0].shape[-1] == cfg.backbone.output_dim and got[0].shape[1] == cfg.capacities.points[0]
    for level, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, name=f"level {level}")


def test_slice_on_the_jax_pyramid(slice_setup):
    """The whole inference forward: fine features and patches on level-0
    points (K = 16), matching scores, correspondences and the transform."""
    cfg, _, data, variables, want = slice_setup
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    got = model(to_torch(data))
    assert got["ref_points_f"].shape[0] == cfg.capacities.points[0]
    assert got["matching_scores"].shape[1:] == (17, 17)
    assert int(got["corr_masks"].sum()) > 0
    _check_slice(got, want)


def test_slice_on_the_port_pyramid(slice_setup):
    cfg, arrays, _, variables, want = slice_setup
    pdata = build_registration_inputs(*(torch.from_numpy(a) for a in arrays), *_pyramid_args(cfg),
                                      search_chunk=cfg.capacities.search_chunk)
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    _check_slice(model(pdata), want)


@pytest.fixture(scope="module")
def train_setup(slice_setup):
    """One train step of both packages from the same weights, pyramid (with
    its ground truth) and target keys."""
    cfg, _, _, variables, _ = slice_setup
    data, _ = synthetic_pair(cfg, seed=5)
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
    1e-3 of the model's largest gradient), as at 4 stages."""
    want = train_setup["jax_grads"]
    named = dict(train_setup["port"].named_parameters())
    assert set(named) == set(want)
    floor = 1e-3 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in named.items():
        w = want[name].numpy()
        assert p.grad is not None, name
        assert _relative_error(p.grad, w, scale=max(float(np.abs(w).max()), floor)) <= STEP_GRAD_TOL, name
    for name in ("backbone.decoder1.mlp.weight", "backbone.decoder2.mlp.weight",
                 "transformer.embedding.proj_a.weight"):
        assert float(named[name].grad.abs().max()) > 0.0, f"no gradient reached {name}"


# ---------------------------------------------------------------------------
# PNG reader and writer
# ---------------------------------------------------------------------------

def _image(dtype, seed):
    """Noise with flat patches and ramps, so each filter meets runs and steps."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    image = rng.integers(0, top + 1, (29, 41)).astype(dtype)
    image[3:15, 4:30] = image[3, 4]
    image[16:, :] = (np.arange(41) * (top // 40)).astype(dtype)[None, :]
    return image


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_reader_equals_pil(tmp_path, dtype, filter_type):
    """Our writer, one filter type on every row, the data in IDAT chunks of
    100 bytes; decoded by PIL and by `read_png` to the same array."""
    image = pytest.importorskip("PIL.Image")
    want = _image(dtype, filter_type)
    path = str(tmp_path / "img.png")
    write_png(path, want, filter_type=filter_type, idat_size=100)
    with open(path, "rb") as f:
        assert f.read().count(b"IDAT") > 2
    got = read_png(path)
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.array(image.open(path)))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_reader_reads_pil_files(tmp_path, dtype):
    """PNGs PIL wrote (its adaptive filters, its chunking), at the size of a
    LineMod frame."""
    image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(7)
    want = np.zeros((480, 640), dtype)
    want[100:300, 200:420] = rng.integers(0, 2000, (200, 220)).astype(dtype) if dtype == np.uint16 else 255
    path = str(tmp_path / "pil.png")
    image.fromarray(want).save(path)
    np.testing.assert_array_equal(read_png(path), want)


def _png_bytes(width, height, depth, colour, interlace):
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, interlace)
    raw = zlib.compress(bytes(height * (1 + width * max(1, depth // 8) * (3 if colour == 2 else 1))))
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", raw) + chunk(b"IEND", b"")


@pytest.mark.parametrize("case,match", [
    ((4, 3, 8, 2, 0), "colour type 2"),
    ((4, 3, 4, 0, 0), "bit depth 4"),
    ((4, 3, 8, 0, 1), "interlaced"),
])
def test_png_reader_refuses_other_formats(tmp_path, case, match):
    path = str(tmp_path / "other.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(*case))
    with pytest.raises(PNGError, match=match):
        read_png(path)


def test_png_reader_checks_crc(tmp_path):
    path = str(tmp_path / "bad.png")
    write_png(path, _image(np.uint8, 0))
    blob = bytearray(open(path, "rb").read())
    blob[40] ^= 0xFF  # inside the first IDAT's data
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(PNGError, match="CRC"):
        read_png(path)


# ---------------------------------------------------------------------------
# Fixture trees, datasets and the cache
# ---------------------------------------------------------------------------

def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_linemod_tree_equals_the_tool_tree(tmp_path):
    """The port's fixture against tools/train_linemod_twophase.py's: the same
    files, the PLY and JSON byte for byte, the PNGs to the same pixels."""
    image = pytest.importorskip("PIL.Image")
    from tools.train_linemod_twophase import make_synthetic_linemod_tree

    ours, theirs = str(tmp_path / "port" / "linemod"), str(tmp_path / "jax" / "linemod")
    make_linemod_tree(ours, n_train=3, n_test=2)
    make_synthetic_linemod_tree(theirs, n_train=3, n_test=2)
    files = _tree_files(theirs)
    assert _tree_files(ours) == files and len(files) == 1 + (3 + 3 + 2) + (2 + 2 + 2)
    for name in files:
        a, b = os.path.join(ours, name), os.path.join(theirs, name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.array(image.open(a)), np.array(image.open(b)), err_msg=name)
            np.testing.assert_array_equal(read_png(a), np.array(image.open(b)), err_msg=name)
        else:
            assert filecmp.cmp(a, b, shallow=False), name


@pytest.fixture(scope="module")
def linemod_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bop")
    make_linemod_tree(str(root / "linemod"), n_train=3, n_test=2)
    return str(root)


def assert_identical(got, want, path="item"):
    """Exact equality of nested dicts, lists, strings and arrays (dtype too)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for key in want:
            assert_identical(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_identical(a, b, f"{path}[{i}]")
    elif isinstance(want, (str, int, float)):
        assert type(got) is type(want) and got == want, (path, got, want)
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("mode,augment", [("train", True), ("train", False), ("test", False)])
def test_linemod_samples_equal_jax(linemod_root, mode, augment):
    """Built from the PNGs (reload_data), then two passes over the items,
    which continue both generators: bit for bit the JAX dataset's."""
    pytest.importorskip("PIL")
    kwargs = dict(reload_data=True, data_augmentation=augment, points_limit=300, mode=mode, seed=7351)
    theirs = JaxLMODataset(linemod_root, **kwargs)
    ours = LMODataset(linemod_root, **kwargs)
    assert len(ours) == len(theirs) == (3 if mode == "train" else 2)
    assert_identical(ours.data, theirs.data, "data")
    assert ours.data[0]["ref_points"].shape == (300, 3)
    for _ in range(2):
        for i in range(len(theirs)):
            assert_identical(ours[i], theirs[i], f"{mode} item {i}")


def test_linemod_cache_round_trip(tmp_path):
    """The cache file `linemod/cache/lm_{mode}_{limit}.pkl`: written on the
    first build, then read in place of the PNGs, by the port and by the JAX
    dataset alike."""
    make_linemod_tree(str(tmp_path / "linemod"), n_train=3, n_test=2)
    built = LMODataset(str(tmp_path), data_augmentation=False, points_limit=250, mode="test", seed=3)
    cache = tmp_path / "linemod" / "cache" / "lm_test_250.pkl"
    assert cache.is_file()
    for name in os.listdir(tmp_path / "linemod" / "test" / "000001" / "depth"):
        os.remove(tmp_path / "linemod" / "test" / "000001" / "depth" / name)  # the cache alone must do
    cached = LMODataset(str(tmp_path), data_augmentation=False, points_limit=250, mode="test", seed=3)
    assert_identical(cached.data, built.data, "cached")
    jax_cached = JaxLMODataset(str(tmp_path), data_augmentation=False, points_limit=250, mode="test", seed=3)
    assert_identical(jax_cached.data, built.data, "JAX reading the port's cache")
    assert_identical(cached[1], jax_cached[1])


def test_linemod_geometry(linemod_root):
    """The back-projected face lies at the frame's depth (+- the relief),
    and the ground truth maps the mesh sample onto it."""
    ds = LMODataset(linemod_root, reload_data=True, data_augmentation=False, points_limit=300, mode="test", seed=0)
    with open(os.path.join(linemod_root, "linemod", "test", "000001", "scene_gt.json")) as f:
        gts = json.load(f)
    for item in (ds[i] for i in range(len(ds))):
        tz = gts[str(item["frame_id"])][0]["cam_t_m2c"][2] / 1000.0
        ref, src, transform = item["ref_points"], item["src_points"], item["transform"]
        assert np.abs(ref[:, 2] - tz).max() <= 0.0035
        moved = src @ transform[:3, :3].T + transform[:3, 3]
        on_face = np.abs(moved[:, 2] - tz) < 1e-6  # the z = 0 face of the box
        assert on_face.sum() > 0.05 * len(src)


def test_modelnet_tree_equals_the_test_fixture(tmp_path):
    """`make_modelnet_tree` writes tests/test_dataset_fixtures.py's pickles."""
    make_modelnet_tree(str(tmp_path))
    rng = np.random.default_rng(2)
    with open(tmp_path / "val.pkl", "rb") as f:
        items = pickle.load(f)
    assert [x["label"] for x in items] == [0, 2, 4]
    for item in items:
        pts = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
        pts[:, 2] = 0.3 * np.sin(3 * pts[:, 0]) + 0.2 * pts[:, 1]
        normals = rng.normal(size=(2048, 3)).astype(np.float32)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        np.testing.assert_array_equal(item["points"], pts)
        np.testing.assert_array_equal(item["normals"], normals)


@pytest.mark.parametrize("subset", ["train", "test"])
def test_modelnet_samples_equal_jax(tmp_path, subset):
    """The experiment's ModelNet settings (noise on train; test
    deterministic), two passes: bit for bit the JAX dataset's."""
    make_modelnet_tree(str(tmp_path), labels=(0, 1, 5, 2), points=1024)  # class 5 is symmetric: filtered out
    knobs = exp_config.MODELNET
    kwargs = dict(num_points=knobs["num_points"], rotation_magnitude=knobs["rotation_magnitude"],
                  translation_magnitude=knobs["translation_magnitude"],
                  noise_magnitude=knobs["noise_magnitude"] if subset == "train" else None,
                  keep_ratio=knobs["keep_ratio"], crop_method=knobs["crop_method"], asymmetric=knobs["asymmetric"],
                  class_indices=knobs["class_indices"], deterministic=subset != "train",
                  twice_sample=knobs["twice_sample"], twice_transform=knobs["twice_transform"], seed=7351)
    ours = ModelNetPairDataset(str(tmp_path), subset, **kwargs)
    theirs = JaxModelNetPairDataset(str(tmp_path), subset, **kwargs)
    assert len(ours) == len(theirs) == 3
    for _ in range(2):
        for i in range(len(theirs)):
            assert_identical(ours[i], theirs[i], f"{subset} item {i}")
    assert ours[0]["ref_points"].shape == (knobs["num_points"], 3)


def test_bop_utils_match_jax(tmp_path):
    """The mesh sampler, camera and pose readers, bbox snapping and depth
    back-projection on one fixture frame."""
    from ref_geotransformer_tpu.data.datasets import bop_utils as jax_bop

    base = tmp_path / "linemod"
    make_linemod_tree(str(base), n_train=2, n_test=1)
    ply = str(base / "models" / "obj_000001.ply")
    frame = base / "train" / "000001"
    for name, args in (("sample_point_from_mesh", (ply, 500, 3)),
                       ("get_camera_info", (str(frame / "scene_camera.json"), 1)),
                       ("get_gt", (str(frame / "scene_gt.json"), 1)),
                       ("get_bbox", ([17, 23, 61, 45],)),
                       ("read_ply_mesh", (ply,))):
        assert_identical(getattr(bop_utils, name)(*args), getattr(jax_bop, name)(*args), name)
    depth = read_png(str(frame / "depth" / "000001.png"))
    mask = read_png(str(frame / "mask_visib" / "000001_000000.png")) == 255
    assert_identical(bop_utils.mask_to_bbox(mask), jax_bop.mask_to_bbox(mask))
    args = (depth, mask & (depth != 0), 80.0, 60.0, 500.0, 500.0)
    assert_identical(bop_utils.depth_to_pointcloud(*args), jax_bop.depth_to_pointcloud(*args))
    cloud = bop_utils.depth_to_pointcloud(*args)
    assert_identical(bop_utils.resize_pcd(cloud, 100, np.random.default_rng(1)),
                     jax_bop.resize_pcd(cloud, 100, np.random.default_rng(1)))


# ---------------------------------------------------------------------------
# Experiment config
# ---------------------------------------------------------------------------

def _jax_experiment_config():
    """A fresh import of experiments/geotransformer_modelnet_rpmnet_stage4/config.py
    (its constants are read from the environment on import)."""
    path = os.path.join(ROOT, "experiments", "geotransformer_modelnet_rpmnet_stage4", "config.py")
    spec = importlib.util.spec_from_file_location("jax_experiment_modelnet_config", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("override", [{}, {"REF_GT_LR": "3e-4", "REF_GT_WARMUP": "2", "REF_GT_DDPM_STEPS": "5"}])
def test_experiment_config_matches_jax(monkeypatch, override):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in override.items():
        monkeypatch.setenv(key, value)
    theirs = _jax_experiment_config()
    ours = exp_config.make_cfg()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs.make_cfg())
    assert ours == port_config(theirs.make_cfg())
    assert (ours.backbone.num_stages, ours.backbone.fine_level, ours.model.num_points_in_patch) == (3, 0, 128)
    assert exp_config.MODELNET == theirs.MODELNET
    assert exp_config.LMO == theirs.LMO
    assert dataclasses.asdict(exp_config.DDPM) == dataclasses.asdict(theirs.DDPM)


def test_experiment_directories_follow_the_environment(monkeypatch, tmp_path):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("REF_GT_OUTPUT_ROOT", str(tmp_path / "out"))
    monkeypatch.setenv("REF_GT_LINEMOD_ROOT", str(tmp_path / "bop"))
    monkeypatch.setenv("REF_GT_MODELNET_ROOT", str(tmp_path / "modelnet"))
    theirs = _jax_experiment_config()
    for name in ("OUTPUT_DIR", "SNAPSHOT_DIR", "SNAPSHOT_ENCODER_DIR", "SNAPSHOT_DDPM_DIR", "LOG_DIR", "FEATURE_DIR",
                 "LINEMOD_ROOT", "MODELNET_ROOT"):
        assert getattr(exp_config, name) == getattr(theirs, name), name
    assert exp_config.LMO["data_folder"] == str(tmp_path / "bop")
    monkeypatch.delenv("REF_GT_OUTPUT_ROOT")
    monkeypatch.delenv("REF_GT_LINEMOD_ROOT")
    assert exp_config.SNAPSHOT_ENCODER_DIR == os.path.join(ROOT, "output", "torch",
                                                           "geotransformer_modelnet_rpmnet_stage4", "snapshots",
                                                           "encoder")
    assert exp_config.LMO["data_folder"] == os.path.join(ROOT, "data")
    with pytest.raises(AttributeError):
        exp_config.NOT_A_CONSTANT
