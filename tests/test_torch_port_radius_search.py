"""The port's radius search on the CPU: the dispatch of
`ops/neighbors.py::radius_search` (methods "approx" and "brute") against
`cuda_kernels.radius_search_plain`, bit for bit; the plain version against
the JAX package's `radius_search` at the edges that
tests/test_torch_port_ops.py leaves out (fewer valid supports than `limit`,
invalid queries, duplicated points, `limit` at and beyond N); and the build's
list of the kernel's source and entry points. The kernel itself runs on a
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

from ref_geotransformer_tpu.ops.neighbors import radius_search as jax_radius_search
from ref_geotransformer_tpu_torch.models import cuda_kernels
from ref_geotransformer_tpu_torch.ops.neighbors import radius_search
from ref_geotransformer_tpu_torch.utils import build
from tests.torch_port_utils import assert_tables_match


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
    launches = cuda_kernels.radius_search.launches
    got = radius_search(q, s, qm, sm, 0.3, limit, chunk, method=method)
    want = cuda_kernels.radius_search_plain(q, s, qm, sm, 0.3, limit, chunk)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, limit)
    assert torch.equal(got, want)
    assert cuda_kernels.radius_search.launches == launches


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
    assert {"gt_radius_search", "gt_radius_search_slices"} <= exported
    assert exported == set(build._SIGNATURES)
