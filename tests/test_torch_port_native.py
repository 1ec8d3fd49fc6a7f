"""PyTorch port: the host C++ geometry kernels (native/) and the KITTI
downsampling tool.

* the port's `grid_subsample_native` and `radius_neighbors_native` give the
  JAX package's output bit for bit (its own loader, building the JAX source
  with the JAX flags into a private directory);
* the port's native kernels against the port's own `ops.subsample.
  grid_subsample` and `ops.neighbors.radius_search` and a cKDTree oracle, as
  tests/test_native.py holds the JAX package's;
* the build: nothing at import, a rebuild when the source is newer, a loud
  failure without g++ or when g++ fails;
* `tools.downsample_kitti` writes .npy files byte-identical to the JAX
  tool's (run in a subprocess) on a 2-sequence x 2-scan tree;
* `utils/neighbor_tables.py`'s tie tolerance, absolute and scaled.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import ref_geotransformer_tpu.native as jax_native
from ref_geotransformer_tpu_torch import native
from ref_geotransformer_tpu_torch.ops.neighbors import radius_search
from ref_geotransformer_tpu_torch.ops.subsample import grid_subsample
from ref_geotransformer_tpu_torch.tools import downsample_kitti
from ref_geotransformer_tpu_torch.utils.neighbor_tables import table_mismatches
from tests.torch_port_utils import ROOT, assert_tables_match


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's native functions, its library built by its own
    loader into a private path (so no other test's build of the package's
    `_geoops.so` can race this one)."""
    path = str(tmp_path_factory.mktemp("jax_native") / "_geoops.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", path)
        mp.setattr(jax_native, "_LIB", None)
        jax_native._load()
        yield jax_native


def _cloud(seed, n, low, high):
    return np.random.default_rng(seed).uniform(low, high, (n, 3)).astype(np.float32)


GRID_CASES = {
    "mixed signs": (_cloud(0, 3000, -2.0, 2.0), 0.1, None),
    "negative coordinates": (_cloud(1, 2000, -7.3, -1.1), 0.25, None),
    "capacity overflow": (_cloud(2, 2000, -1.0, 1.0), 0.08, 300),
    "capacity zero": (_cloud(3, 100, -1.0, 1.0), 0.5, 0),
    "one point": (_cloud(4, 1, -1.0, 1.0), 0.3, None),
    "empty": (np.zeros((0, 3), np.float32), 0.3, None),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_subsample_is_bit_identical_to_jax(jax_lib, case):
    points, voxel, capacity = GRID_CASES[case]
    got, total = native.grid_subsample_native(points, voxel, capacity)
    want, want_total = jax_lib.grid_subsample_native(points, voxel, capacity)
    assert total == want_total
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if capacity is not None and case != "empty":
        assert got.shape[0] == min(capacity, total) and total > capacity  # the true count beyond the capacity


RADIUS_CASES = {
    "mixed signs": (_cloud(5, 400, -1.0, 1.0), _cloud(6, 1500, -1.0, 1.0), 0.2, 24),
    "negative coordinates": (_cloud(7, 300, -9.0, -6.0), _cloud(8, 900, -9.0, -6.0), 0.6, 16),
    "limit above the neighbors found": (_cloud(9, 200, -1.0, 1.0), _cloud(10, 300, -1.0, 1.0), 0.15, 64),
    "queries far from the supports": (_cloud(11, 50, 5.0, 6.0), _cloud(12, 200, -1.0, 1.0), 0.3, 8),
    "empty supports": (_cloud(13, 20, -1.0, 1.0), np.zeros((0, 3), np.float32), 0.3, 8),
    "empty queries": (np.zeros((0, 3), np.float32), _cloud(14, 50, -1.0, 1.0), 0.3, 8),
}


@pytest.mark.parametrize("case", sorted(RADIUS_CASES))
def test_radius_neighbors_is_bit_identical_to_jax(jax_lib, case):
    q, s, radius, limit = RADIUS_CASES[case]
    got = native.radius_neighbors_native(q, s, radius, limit)
    want = jax_lib.radius_neighbors_native(q, s, radius, limit)
    assert got.dtype == np.int32 and got.shape == (q.shape[0], limit)
    np.testing.assert_array_equal(got, want)
    if case == "limit above the neighbors found":
        assert (got == s.shape[0]).any(axis=1).all()  # every row ends in sentinels


def _sort_rows(a):
    return a[np.lexsort((a[:, 0], a[:, 1], a[:, 2]))]


def test_grid_subsample_matches_the_port_op():
    points = _cloud(21, 800, -1.0, 1.0)
    got, total = native.grid_subsample_native(points, 0.08)
    assert got.shape[0] == total
    padded = torch.from_numpy(np.pad(points, ((0, 224), (0, 0))))
    masks = torch.arange(1024) < 800
    dev_points, dev_masks = grid_subsample(padded, masks, 0.08, total + 16)
    assert int(dev_masks.sum()) == total
    np.testing.assert_allclose(_sort_rows(got), _sort_rows(dev_points[dev_masks].numpy()), atol=1e-5)


def test_radius_neighbors_match_the_port_op_and_a_kdtree():
    q, s = _cloud(22, 150, -1.0, 1.0), _cloud(23, 400, -1.0, 1.0)
    radius, limit = 0.3, 20
    got = native.radius_neighbors_native(q, s, radius, limit)
    tree = cKDTree(s)
    for i in range(q.shape[0]):
        idx = np.array(tree.query_ball_point(q[i], radius), np.int64)
        dists = np.linalg.norm(s[idx] - q[i], axis=1)
        expected = idx[np.argsort(dists)][:limit]
        row = got[i][got[i] < s.shape[0]]
        np.testing.assert_array_equal(np.sort(row), np.sort(expected))
        assert np.all(np.diff(np.linalg.norm(s[row] - q[i], axis=1)) >= -1e-6)
    ours = radius_search(torch.from_numpy(q), torch.from_numpy(s), torch.ones(150, dtype=torch.bool),
                         torch.ones(400, dtype=torch.bool), radius, limit)
    assert_tables_match(got, ours.numpy(), q, s, name="native vs radius_search")


def test_table_comparison_scales_its_tie_tolerance():
    """`table_mismatches`, with which chip_smoke.py holds the card's
    radius_search to native: a neighbor 1e-4 beyond the row's edge in d^2,
    40 m out, is a tie within 1e-6 * (1 + |q|^2 + |s|^2) but not within
    1e-6; a column 0 that differs by 0.03 in d^2, or holds the sentinel, is
    never one."""
    q = np.array([[40.0, 0.0, 0.0]])
    s = np.array([[40.0, 0.0, 0.1], [40.0, 0.0, 0.2], [40.0, 0.2, 0.01]])  # d^2 0.01, 0.04, 0.0401
    ours = np.array([[0, 1]])
    for theirs, scaled, n_bad in (([[0, 2]], True, 0), ([[0, 2]], False, 1), ([[2, 1]], True, 1),
                                  ([[3, 1]], True, 1)):
        differ, bad, worst = table_mismatches(ours, np.array(theirs), q, s, 1e-6, scaled=scaled)
        assert differ == 1 and len(bad) == n_bad, (theirs, scaled, bad)
        assert (worst > 1.0) == bool(n_bad)
    with pytest.raises(AssertionError, match="not a tie"):
        assert_tables_match(ours, np.array([[0, 2]]), q, s)


def test_capacity_overflow_is_reported():
    points = _cloud(24, 500, -1.0, 1.0)
    full, total = native.grid_subsample_native(points, 0.2)
    capped, total_capped = native.grid_subsample_native(points, 0.2, capacity=total - 5)
    assert total_capped == total and capped.shape[0] == total - 5
    np.testing.assert_array_equal(capped, full[: total - 5])


def test_bad_shapes_raise():
    with pytest.raises(ValueError):
        native.grid_subsample_native(np.zeros((4, 2), np.float32), 0.1)
    with pytest.raises(ValueError):
        native.radius_neighbors_native(np.zeros((4, 3)), np.zeros((4, 3)), 0.1, -1)


@pytest.fixture
def private_build(tmp_path, monkeypatch):
    """The port's build pointed at a copy of the source in tmp_path."""
    source = tmp_path / "geoops.cpp"
    shutil.copy(native.SOURCE, source)
    monkeypatch.setattr(native, "SOURCE", str(source))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "build" / "libgeoops.so"))
    return source


def test_build_rebuilds_a_stale_library(private_build):
    library = native.build()
    assert os.path.isfile(library) and os.listdir(os.path.dirname(library)) == ["libgeoops.so"]
    built = os.path.getmtime(library)
    assert native.build() == library and os.path.getmtime(library) == built  # fresh: not rebuilt
    os.utime(private_build, (built + 10, built + 10))
    native.build()
    assert os.path.getmtime(library) > built


def test_build_fails_loudly(private_build, monkeypatch):
    private_build.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        native.build()
    assert not os.path.exists(native.LIBRARY) and os.listdir(native.BUILD_DIR) == []
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_import_builds_nothing():
    """In a fresh interpreter, importing the module and the tool that uses
    it runs no compiler and loads no library."""
    code = ("import subprocess\n"
            "calls = []\n"
            "subprocess.run = lambda *a, **k: calls.append(a)\n"
            "import ref_geotransformer_tpu_torch.tools.downsample_kitti\n"
            "import ref_geotransformer_tpu_torch.native as n\n"
            "assert n._LIB is None and not calls, calls\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=60,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _write_kitti_tree(root):
    """2 sequences x 2 scans of float32 (x, y, z, intensity), seeded."""
    rng = np.random.default_rng(31)
    for seq in ("00", "03"):
        vel = root / seq / "velodyne"
        vel.mkdir(parents=True)
        for frame in range(2):
            n = int(rng.integers(3000, 5000))
            scan = np.concatenate([rng.uniform(-20, 20, (n, 2)), rng.normal(-1.7, 0.3, (n, 1)),
                                   rng.uniform(0, 1, (n, 1))], axis=1).astype(np.float32)
            scan.tofile(vel / f"{frame:06d}.bin")


def test_downsample_kitti_writes_the_jax_tools_files(tmp_path):
    _write_kitti_tree(tmp_path / "sequences")
    args = ["--input_root", str(tmp_path / "sequences"), "--voxel_size", "0.3"]
    downsample_kitti.main([*args, "--output_root", str(tmp_path / "port")])
    # the JAX tool in its own interpreter (it puts the repository root on
    # sys.path), its library built into a private path
    code = ("import runpy, sys\n"
            "import ref_geotransformer_tpu.native as n\n"
            f"n._LIB_PATH = {str(tmp_path / '_geoops.so')!r}\n"
            f"sys.argv = ['downsample_kitti.py', *{args!r}, '--output_root', {str(tmp_path / 'jax')!r}]\n"
            f"runpy.run_path({os.path.join(ROOT, 'tools', 'downsample_kitti.py')!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npy"))
    assert [str(f) for f in files] == ["00/000000.npy", "00/000001.npy", "03/000000.npy", "03/000001.npy"]
    assert sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.npy")) == files
    for name in files:
        got, want = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        assert got == want, name
        cloud = np.load(tmp_path / "port" / name)
        assert cloud.dtype == np.float32 and 100 < cloud.shape[0] < 5000
