"""PyTorch port vs JAX package: the PLY / OBJ exports (utils/visualization.py),
the demo's `--dump` PLYs and the iteration trainer's `corr_dump_dir`.

The same arrays must give byte-identical files in both packages; the port's
writers also take its output dict of torch tensors.
"""

import numpy as np
import pytest
import torch

from ref_geotransformer_tpu.utils import visualization as jax_vis
from ref_geotransformer_tpu_torch import demo
from ref_geotransformer_tpu_torch.engine.iter_trainer import IterBasedEncoderTrainer
from ref_geotransformer_tpu_torch.engine.state import TrainState
from ref_geotransformer_tpu_torch.engine.steps import ensure_pyramids
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.utils import visualization as vis
from ref_geotransformer_tpu_torch.utils.weights import init_parameters
from tests.test_torch_port_model import surface_pair
from tests.torch_port_utils import port_config, tiny4_config


def _same_files(tmp_path, names):
    for name in names:
        got, want = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        assert len(got) > 0 and got == want, name


@pytest.fixture
def dirs(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    return tmp_path


def test_writers_are_byte_identical(dirs):
    rng = np.random.default_rng(0)
    points = rng.normal(size=(50, 3)).astype(np.float32)
    other = rng.normal(size=(50, 3)).astype(np.float32)
    colors = rng.uniform(size=(50, 3))
    edges = rng.integers(0, 50, (30, 2))
    transform = np.eye(4, dtype=np.float32)
    transform[:3, 3] = [0.1, -0.2, 0.3]
    for package, root in ((vis, dirs / "port"), (jax_vis, dirs / "jax")):
        package.write_ply(str(root / "plain.ply"), points)
        package.write_ply(str(root / "colored.ply"), points, colors)
        package.write_ply(str(root / "rgb.ply"), points, colors * 255)
        package.write_obj_lines(str(root / "lines.obj"), points, other)
        package.write_ply_lines(str(root / "lines.ply"), points, edges)
        package.write_ply_lines(str(root / "lines_rgb.ply"), points, edges, np.array([1.0, 0.5, 0.0]))
        package.dump_registration_ply(str(root / "pair"), points, other, transform)
    _same_files(dirs, ["plain.ply", "colored.ply", "rgb.ply", "lines.obj", "lines.ply", "lines_rgb.ply",
                       "pair_ref.ply", "pair_src.ply", "pair_src_aligned.ply"])


def test_colors_match():
    rng = np.random.default_rng(1)
    owners = rng.integers(0, 13, 200)
    np.testing.assert_array_equal(vis.node_color_map(owners, 12, seed=3), jax_vis.node_color_map(owners, 12, seed=3))
    feats = rng.normal(size=(80, 16)).astype(np.float32)
    np.testing.assert_array_equal(vis.feature_tsne_colors(feats), jax_vis.feature_tsne_colors(feats))


def surface_transform():
    """The ground truth of `surface_pair`, which maps src onto ref: src is
    the surface rotated by 0.3 about z and moved by 0.2, ref it moved by 1.5."""
    c, s = np.cos(0.3), np.sin(0.3)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32).T
    gt[:3, 3] = 1.5 - gt[:3, :3] @ np.full(3, 0.2, np.float32)
    return gt


def _model_output(seed=0):
    cfg = port_config(tiny4_config())
    model = init_parameters(GeoTransformer(cfg), torch.Generator().manual_seed(seed))
    pair = {key: torch.from_numpy(a) for key, a in zip(("ref_points", "ref_masks", "src_points", "src_masks"),
                                                      surface_pair(cfg))}
    pair["transform"] = torch.from_numpy(surface_transform())
    with torch.no_grad():
        return cfg, model, pair, model(ensure_pyramids(cfg, pair))


def test_save_corr_pcd_is_byte_identical(dirs):
    _, _, _, out = _model_output()
    assert bool(out["gt_node_overlap_map"].gt(0).any())
    ratio = vis.save_corr_pcd(out, str(dirs / "port"), prefix="x-")
    want = jax_vis.save_corr_pcd({key: value.numpy() for key, value in out.items()}, str(dirs / "jax"), prefix="x-")
    assert ratio == want
    _same_files(dirs, [f"x-{name}.ply" for name in ("pcd_frame", "pcd_model", "line_gt", "line_pred", "line_inlier",
                                                    "line_outlier")])


def test_demo_dump_writes_the_plys(tmp_path, monkeypatch):
    """`demo --dump x.npz` writes x_ref.ply, x_src.ply and x_src_aligned.ply
    beside the .npz, the JAX package's files for the same clouds and
    transform (here the tiny model on CPU, the demo's own config swapped)."""
    cfg = port_config(tiny4_config())
    arrays = surface_pair(cfg)
    ref, src = arrays[0][arrays[1]], arrays[2][arrays[3]]
    for name, a in (("ref", ref), ("src", src), ("gt", np.eye(4, dtype=np.float32))):
        np.save(tmp_path / f"{name}.npy", a)
    monkeypatch.setattr(demo, "make_cfg", lambda demo=True: cfg)
    demo.main(["--device", "cpu", "--iters", "0", "--ref_file", str(tmp_path / "ref.npy"), "--src_file",
               str(tmp_path / "src.npy"), "--gt_file", str(tmp_path / "gt.npy"), "--dump", str(tmp_path / "out.npz")])
    with np.load(tmp_path / "out.npz") as dump:
        transform = dump["estimated_transform"]
    assert np.isfinite(transform).all()
    (tmp_path / "jax").mkdir()
    jax_vis.dump_registration_ply(str(tmp_path / "jax" / "out"), ref, src, transform)
    for suffix in ("ref", "src", "src_aligned"):
        assert (tmp_path / f"out_{suffix}.ply").read_bytes() == (tmp_path / "jax" / f"out_{suffix}.ply").read_bytes()


def test_iter_trainer_corr_dump_dir(tmp_path):
    """A validation with `corr_dump_dir` writes the first pair's PLYs, the
    files `save_corr_pcd` makes of that pair's inference forward."""
    cfg, model, pair, out = _model_output(seed=1)
    batch = {key: value.numpy()[None] for key, value in pair.items()}
    batch["_pair_masks"] = np.ones(1, bool)
    trainer = IterBasedEncoderTrainer(cfg, model, TrainState(model, cfg.optim, 1), [], [batch, batch],
                                      snapshot_dir=str(tmp_path / "snapshots"), corr_dump_dir=str(tmp_path / "corr"))
    trainer.iteration = 6
    trainer.validate()
    names = [f"iter6-{name}.ply" for name in ("pcd_frame", "pcd_model", "line_gt", "line_pred", "line_inlier",
                                               "line_outlier")]
    assert sorted(p.name for p in (tmp_path / "corr").iterdir()) == sorted(names)
    vis.save_corr_pcd(out, str(tmp_path / "want"), prefix="iter6-")
    for name in names:
        assert (tmp_path / "corr" / name).read_bytes() == (tmp_path / "want" / name).read_bytes(), name
