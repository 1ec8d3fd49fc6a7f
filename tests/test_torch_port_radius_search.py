"""The port's radius search on the CPU: the dispatch of
`ops/neighbors.py::radius_search` (methods "approx" and "brute") against
`cuda_kernels.radius_search_plain`, bit for bit; the plain version against
the JAX package's `radius_search` at the edges that
tests/test_torch_port_ops.py leaves out (fewer valid supports than `limit`,
invalid queries, duplicated points, `limit` at and beyond N); the grouped
search (`radius_search_group`) against single searches, bit for bit, and the
pyramids built through it against the JAX package's; and the build's list of
the kernel's source and entry points. The kernel itself runs on a
card only (tests/test_torch_port_kernels.py, marked `cuda`).

Tables are compared up to ties (tests/torch_port_utils.py): duplicated points
tie exactly, and the two packages may order a tie either way.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ref_geotransformer_tpu.data.pyramid import build_pyramid as jax_build_pyramid
from ref_geotransformer_tpu.ops.neighbors import radius_search as jax_radius_search
from ref_geotransformer_tpu_torch.data import pyramid
from ref_geotransformer_tpu_torch.models import cuda_kernels
from ref_geotransformer_tpu_torch.ops import neighbors
from ref_geotransformer_tpu_torch.ops.neighbors import radius_search
from ref_geotransformer_tpu_torch.utils import build
from tests.torch_port_utils import assert_tables_match, demo_crop


def _cloud(m, n, seed, q_valid=1.0, s_valid=1.0, duplicates=0):
    """Seeded queries (m, 3) and supports (n, 3) in a unit cube with their
    masks; the first `duplicates` supports repeat as the next ones (exact
    ties), and the queries are the first m supports where m <= n."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    s[duplicates : 2 * duplicates] = s[:duplicates]
    q = s[:m].copy() if m <= n else rng.uniform(0.0, 1.0, (m, 3)).astype(np.float32)
    qm = rng.uniform(size=m) < q_valid
    sm = rng.uniform(size=n) < s_valid
    return q, s, qm, sm


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("method", ["approx", "brute"])
@pytest.mark.parametrize("m,n,limit,chunk", [(1, 1, 1, 2048), (300, 700, 16, 128), (257, 130, 38, 64),
                                             (90, 90, 90, 32)])
def test_dispatch_on_cpu_is_the_plain_version(method, m, n, limit, chunk):
    """A CPU tensor takes the plain version, bit for bit, and launches nothing."""
    q, s, qm, sm = _torch(*_cloud(m, n, seed=m + n, q_valid=0.9, s_valid=0.8, duplicates=min(n // 4, 20)))
    launches = cuda_kernels.radius_search_group.launches
    got = radius_search(q, s, qm, sm, 0.3, limit, chunk, method=method)
    want = cuda_kernels.radius_search_plain(q, s, qm, sm, 0.3, limit, chunk)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, limit)
    assert torch.equal(got, want)
    assert cuda_kernels.radius_search_group.launches == launches


EDGES = {
    # name: (m, n, limit, radius, cloud arguments)
    "fewer valid supports than limit": (120, 200, 32, 0.5, {"s_valid": 0.1}),
    "invalid queries": (150, 150, 16, 0.25, {"q_valid": 0.5}),
    "all queries invalid": (64, 100, 8, 0.5, {"q_valid": 0.0}),
    "no valid support": (64, 100, 8, 0.5, {"s_valid": 0.0}),
    "duplicated points": (200, 200, 24, 0.2, {"duplicates": 60}),
    "limit equal to N": (40, 40, 40, 0.6, {"s_valid": 0.7}),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_plain_matches_jax_at_the_edges(case):
    m, n, limit, radius, kwargs = EDGES[case]
    q, s, qm, sm = _cloud(m, n, seed=len(case), **kwargs)
    with jax.default_matmul_precision("highest"):
        want = jax_radius_search(*(jnp.array(x) for x in (q, s, qm, sm)), radius, limit, 64)
    got = cuda_kernels.radius_search_plain(*_torch(q, s, qm, sm), radius, limit, 64)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, limit)
    assert_tables_match(got, want, q, s, name=case)
    assert bool((got[torch.from_numpy(~qm)] == n).all()), "an invalid query's row holds a neighbor"


def test_limit_beyond_n_raises_in_both_packages():
    """More slots than supports: the JAX package's top-k raises, and so does
    the port, on either device, before any work."""
    q, s, qm, sm = _cloud(20, 12, seed=5)
    with pytest.raises(ValueError):
        jax_radius_search(*(jnp.array(x) for x in (q, s, qm, sm)), 0.5, 13, 64)
    with pytest.raises(ValueError, match="limit 13 outside"):
        radius_search(*_torch(q, s, qm, sm), 0.5, 13)


def test_build_lists_the_kernel_and_every_entry_point():
    """Every csrc/*.cu is compiled, and every `extern "C"` function of the
    sources has a signature (ctypes would otherwise pass its pointers as
    32-bit ints)."""
    sources = sorted(f for f in os.listdir(build.CSRC_DIR) if f.endswith(".cu"))
    assert "radius_search.cu" in sources
    assert sorted(build.SOURCES) == sources
    exported = set()
    for name in sources:
        with open(os.path.join(build.CSRC_DIR, name)) as f:
            exported |= set(re.findall(r'extern "C"\s+\w+\s+(\w+)\s*\(', f.read()))
    assert {"gt_radius_search_group", "gt_radius_search_info"} <= exported
    assert exported == set(build._SIGNATURES)


def _ragged_group(seed):
    """Seeded searches over three clouds that share supports: M and N off the
    kernel's 128-query blocks and 256-support tiles, limits 1 to 128,
    invalid queries, duplicated supports (exact ties), a sparse cloud with
    fewer valid supports than the row holds, and a search whose queries are
    its supports."""
    q, s, qm, sm = _torch(*_cloud(301, 777, seed=seed, q_valid=0.8, s_valid=0.9, duplicates=90))
    few = torch.from_numpy(np.random.default_rng(seed + 1).uniform(size=200) < 0.2)
    b, _, bm, _ = _torch(*_cloud(129, 5, seed=seed + 2, q_valid=0.6))
    return [(q, s, qm, sm, 0.25, 128), (q, s, qm, sm, 0.2, 1), (s, s, sm, sm, 0.15, 38),
            (b, s[:200], bm, few, 2.0, 64), (s, q, sm, qm, 0.3, 17), (q[:5], s[:40], qm[:5], sm[:40], 0.5, 40)]


@pytest.mark.parametrize("seed", [0, 1])
def test_group_equals_single_searches_on_cpu(seed):
    """`radius_search_group` returns each search's table, in order, bit for bit
    as the single-search path, and launches nothing on the CPU."""
    group = _ragged_group(seed)
    before = (cuda_kernels.radius_search_group.launches, cuda_kernels.radius_search_group.searches)
    got = neighbors.radius_search_group(group, 64)
    assert len(got) == len(group)
    for table, (q, s, qm, sm, radius, limit) in zip(got, group):
        want = radius_search(q, s, qm, sm, radius, limit, 64)
        assert table.dtype == torch.int32 and tuple(table.shape) == (q.shape[0], limit)
        assert torch.equal(table, want)
        assert bool((table[~qm] == s.shape[0]).all()), "an invalid query's row holds a neighbor"
    after = (cuda_kernels.radius_search_group.launches, cuda_kernels.radius_search_group.searches)
    assert after == before


def test_group_edges():
    """An empty group is an empty list; a limit beyond N raises before any
    work; a device other than the CPU or a card raises instead of falling
    back to the plain version."""
    assert cuda_kernels.radius_search_group([]) == []
    q, s, qm, sm = _torch(*_cloud(20, 12, seed=5))
    with pytest.raises(ValueError, match="radius_search_group: limit 13 outside"):
        cuda_kernels.radius_search_group([(q, s, qm, sm, 0.5, 4), (q, s, qm, sm, 0.5, 13)])
    meta = [tuple(t.to("meta") for t in (q, s, qm, sm)) + (0.5, 4)]
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.radius_search_group(meta)


def _pyramid_args(demo_crop_seed, caps=(1024, 384, 160, 64)):
    from ref_geotransformer_tpu.data.pyramid import pad_points

    ref, _ = demo_crop(1000, seed=demo_crop_seed)
    points, masks = pad_points(ref, caps[0])
    return points, masks, (4, 0.025, 0.0625, (24, 20, 20, 16), caps, 256)


def _assert_pyramid_matches(got, want, name):
    for i in range(len(want["points"])):
        np.testing.assert_array_equal(got["masks"][i].numpy(), np.asarray(want["masks"][i]),
                                      err_msg=f"{name}: masks {i}")
    pts = [np.asarray(p) for p in want["points"]]
    for i in range(len(pts)):
        assert_tables_match(got["neighbors"][i], want["neighbors"][i], pts[i], pts[i], name=f"{name} neighbors {i}")
    for i in range(len(pts) - 1):
        assert_tables_match(got["subsampling"][i], want["subsampling"][i], pts[i + 1], pts[i], name=f"{name} sub {i}")
        assert_tables_match(got["upsampling"][i], want["upsampling"][i], pts[i], pts[i + 1], name=f"{name} up {i}")


def test_pyramid_makes_one_group_per_cloud_and_matches_jax(monkeypatch):
    """`build_pyramid` makes its cloud's 3 S - 2 searches in one group, and
    its tables match the JAX package's `build_pyramid` up to ties."""
    points, masks, args = _pyramid_args(7)
    groups = []

    def recorded(searches, chunk=2048):
        groups.append(len(searches))
        return neighbors.radius_search_group(searches, chunk)

    monkeypatch.setattr(pyramid, "radius_search_group", recorded)
    got = pyramid.build_pyramid(torch.from_numpy(points), torch.from_numpy(masks), *args)
    assert groups == [10]
    with jax.default_matmul_precision("highest"):
        want = jax_build_pyramid(jnp.array(points), jnp.array(masks), *args)
    _assert_pyramid_matches(got, want, "build_pyramid")


def test_registration_inputs_make_one_group_per_pair_and_match_jax(monkeypatch):
    """`build_registration_inputs` subsamples both clouds, then makes the
    pair's 2 (3 S - 2) searches in one group; each pyramid equals
    `build_pyramid`'s bit for bit and matches the JAX package's up to ties."""
    ref, ref_m, args = _pyramid_args(3)
    src, src_m, _ = _pyramid_args(4)
    groups = []

    def recorded(searches, chunk=2048):
        groups.append(len(searches))
        return neighbors.radius_search_group(searches, chunk)

    monkeypatch.setattr(pyramid, "radius_search_group", recorded)
    t = torch.from_numpy
    data = pyramid.build_registration_inputs(t(ref), t(ref_m), t(src), t(src_m), *args[:5], search_chunk=args[5])
    assert groups == [20]
    for cloud, (points, masks) in (("ref", (ref, ref_m)), ("src", (src, src_m))):
        alone = pyramid.build_pyramid(t(points), t(masks), *args)
        for key in ("points", "masks", "neighbors", "subsampling", "upsampling"):
            assert len(data[cloud][key]) == len(alone[key])
            for a, b in zip(data[cloud][key], alone[key]):
                assert torch.equal(a, b), f"{cloud} {key}"
        with jax.default_matmul_precision("highest"):
            want = jax_build_pyramid(jnp.array(points), jnp.array(masks), *args)
        _assert_pyramid_matches(data[cloud], want, f"build_registration_inputs {cloud}")
