"""The port's kernel modules: the plain PyTorch versions against the JAX
package (its XLA / lax.scan paths and its Pallas kernels in interpret mode)
on the CPU, and the CUDA kernels (the embedding forward and backward,
Sinkhorn, the radius search) against the plain versions on a card (marked `cuda`: they skip
where CUDA is absent). The embedding backward's CPU parity tests are in
tests/test_torch_port_train.py. JAX is imported inside the
CPU tests only, so the card tests also run where JAX is not installed:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py -m cuda`.

Tolerances: the plain versions repeat the JAX package's arithmetic, so they
are held at the scaled 2e-5 of tests/torch_port_utils.py. Against the
Pallas embedding kernel, which uses a polynomial sin/cos, a polynomial atan2
and direct-difference distances, the band is the 1.06e-3 abs that the JAX
package records between that kernel and its XLA path.
"""

import math
import types

import numpy as np
import pytest
import torch

from ref_geotransformer_tpu_torch.models import cuda_kernels
from ref_geotransformer_tpu_torch.models.embedding import GeometricStructureEmbedding
from ref_geotransformer_tpu_torch.models.sinkhorn import LearnableLogOptimalTransport
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables

PALLAS_EMBEDDING_BAND = 1.06e-3
# the CUDA forward kernel against its plain version: both take precise
# sin/cos and atan2 and f32-accurate products (the kernel's as three TF32
# passes on split operands), so they differ by f32 rounding only; a one-pass
# TF32 kernel reads ~1e-3 (test_kernel_products_within_bound_of_xla_path
# emulates both)
EMBEDDING_KERNEL_BOUND = 1e-4


@pytest.fixture
def jx():
    """The JAX side: jax, jax.numpy and the JAX package's modules under test."""
    import jax
    import jax.numpy as jnp

    from ref_geotransformer_tpu.models import pallas_kernels
    from ref_geotransformer_tpu.models.embedding import GeometricStructureEmbedding
    from ref_geotransformer_tpu.models.sinkhorn import LearnableLogOptimalTransport
    from tests.torch_port_utils import assert_close, to_np

    return types.SimpleNamespace(jax=jax, jnp=jnp, pallas=pallas_kernels, Embedding=GeometricStructureEmbedding,
                                 OT=LearnableLogOptimalTransport, assert_close=assert_close, to_np=to_np)


def _embedding_inputs(n=64, c=32, seed=3, n_valid=None):
    rng = np.random.default_rng(seed)
    points = rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)
    masks = np.zeros((1, n), bool)
    masks[:, : n_valid or n] = True
    return points, masks


def _port_embedding(variables, c, use_kernel=True):
    module = GeometricStructureEmbedding(c, 0.2, 15.0, 3, "max", use_kernel=use_kernel)
    state = from_jax_variables({"params": variables["params"]})
    module.load_state_dict(state, strict=True)
    return module


@pytest.mark.parametrize("n_valid", [64, 50])
def test_embedding_plain_matches_xla_path(jx, n_valid):
    jax, jnp = jx.jax, jx.jnp
    points, masks = _embedding_inputs(n_valid=n_valid)
    jax_mod = jx.Embedding(32, 0.2, 15.0, 3, "max", use_pallas=False)
    variables = jax_mod.init(jax.random.key(0), jnp.array(points), jnp.array(masks))
    with jax.default_matmul_precision("highest"):  # jitted, as the model runs it
        want = jax.jit(jax_mod.apply)(variables, jnp.array(points), jnp.array(masks))
    got = _port_embedding(variables, 32)(torch.from_numpy(points), torch.from_numpy(masks))
    assert got.shape == (1, 64, 64, 32)
    jx.assert_close(got, want, name="embedding")


@pytest.mark.parametrize("n_valid", [80, 70])
def test_embedding_plain_matches_xla_path_at_any_n(jx, n_valid):
    """N = 80, not a multiple of the kernels' tiles (64 pairs forward, 32
    backward): the JAX module takes its XLA path there, as here."""
    jax, jnp = jx.jax, jx.jnp
    points, masks = _embedding_inputs(n=80, seed=4, n_valid=n_valid)
    jax_mod = jx.Embedding(64, 0.2, 15.0, 3, "max")
    variables = jax_mod.init(jax.random.key(1), jnp.array(points), jnp.array(masks))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax_mod.apply)(variables, jnp.array(points), jnp.array(masks))
    got = _port_embedding(variables, 64)(torch.from_numpy(points), torch.from_numpy(masks))
    assert got.shape == (1, 80, 80, 64)
    jx.assert_close(got, want, name="embedding")


def test_embedding_plain_within_pallas_kernel_band(jx):
    """As tests/test_pallas_kernels.py runs the Pallas kernel: nodes in
    [-1, 1]^3, the module's initial weights, interpret mode."""
    jax, jnp = jx.jax, jx.jnp
    points, masks = _embedding_inputs()
    jax_mod = jx.Embedding(32, 0.2, 15.0, 3, "max", use_pallas=False)
    variables = jax_mod.init(jax.random.key(0), jnp.array(points), jnp.array(masks))
    module = _port_embedding(variables, 32)
    got = module(torch.from_numpy(points), torch.from_numpy(masks))[0]

    ref_vectors = module.knn_ref_vectors(torch.from_numpy(points), torch.from_numpy(masks))[0]
    perm = np.concatenate([2 * np.arange(16), 2 * np.arange(16) + 1])
    pd, pa = variables["params"]["proj_d"], variables["params"]["proj_a"]
    div_term = jnp.exp(jnp.arange(0, 32, 2, dtype=jnp.float32) * (-np.log(10000.0) / 32))
    want = jx.pallas.geometric_embedding_pallas(
        jnp.array(points[0]), jnp.array(jx.to_np(ref_vectors)), div_term, pd["kernel"][perm], pd["bias"],
        pa["kernel"][perm], pa["bias"], 0.2, module.factor_a, interpret=True,
    )
    err = float(np.abs(jx.to_np(got) - np.asarray(want)).max())
    assert err <= PALLAS_EMBEDDING_BAND, err


def _tf32(x):
    """x truncated to TF32 (sign, exponent, 10 mantissa bits), as the kernel splits its operands."""
    return (x.view(torch.int32) & -8192).view(torch.float32)  # -8192 = 0xffffe000


def _kernel_product(a, b, split):
    """a @ b as the forward kernel's tensor-core steps compute it: TF32
    operands, products exact, sums at least as precise as f32. With `split`,
    small*big + big*small + big*big on x = big + small; else big*big only."""
    a_big, b_big = _tf32(a), _tf32(b)
    out = a_big.double() @ b_big.double()
    if split:
        a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
        out += a_small.double() @ b_big.double() + a_big.double() @ b_small.double()
    return out.float()


@pytest.mark.parametrize("split", [True, False])
def test_kernel_products_within_bound_of_xla_path(jx, split):
    """Justifies the constant EMBEDDING_KERNEL_BOUND on the CPU; it tests no
    code of the port beyond the `embedding_indices` and `sinusoid` helpers.
    The CUDA forward kernel's arithmetic is emulated here at C = 256 (the
    kernel runs only on the card): with the TF32 split it stays within the
    bound of the JAX package's f32 XLA path; one TF32 pass does not, so the
    bound the card tests and chip_smoke.py hold the kernel to tells a lost
    split apart."""
    jax, jnp = jx.jax, jx.jnp
    c = 256
    points, masks = _embedding_inputs(c=c)
    jax_mod = jx.Embedding(c, 0.2, 15.0, 3, "max", use_pallas=False)
    variables = jax_mod.init(jax.random.key(0), jnp.array(points), jnp.array(masks))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax_mod.apply)(variables, jnp.array(points), jnp.array(masks)))[0]
    module = _port_embedding(variables, c)
    with torch.no_grad():
        (args,) = module.kernel_args(torch.from_numpy(points), torch.from_numpy(masks))
        pts, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, _ = args
        d_idx, a_idx = cuda_kernels.embedding_indices(pts, pts, ref_vectors, sigma_d, factor_a)
        d_emb = _kernel_product(cuda_kernels.sinusoid(d_idx, div_term), wd, split) + bd
        a_emb = _kernel_product(cuda_kernels.sinusoid(a_idx, div_term), wa, split) + ba
        got = (d_emb + torch.amax(a_emb, dim=2)).numpy()
    err = float(np.abs(got - want).max())
    assert (err <= EMBEDDING_KERNEL_BOUND) == split, err


def _sinkhorn_inputs(seed=0, b=5, m=8, n=6):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(b, m, n)).astype(np.float32)
    row_masks = rng.uniform(size=(b, m)) < 0.8
    col_masks = rng.uniform(size=(b, n)) < 0.8
    row_masks[0] = False  # a fully masked patch: only the dustbin pair is valid
    col_masks[0] = False
    return scores, row_masks, col_masks


def test_sinkhorn_plain_matches_scan(jx):
    jnp = jx.jnp
    scores, rm, cm = _sinkhorn_inputs()
    jax_mod = jx.OT(30, use_pallas=False)
    variables = {"params": {"alpha": jnp.asarray(0.7, jnp.float32)}}
    want = jax_mod.apply(variables, jnp.array(scores), jnp.array(rm), jnp.array(cm))
    module = LearnableLogOptimalTransport(30)
    module.load_state_dict(from_jax_variables(variables), strict=True)
    got = module(torch.from_numpy(scores), torch.from_numpy(rm), torch.from_numpy(cm))
    assert got.shape == (5, 9, 7)
    assert np.isfinite(jx.to_np(got)).all()
    jx.assert_close(got, want, name="log assignment")


@pytest.mark.parametrize("b,m1,n1,masked", [(5, 9, 7, 0.0), (3, 129, 129, 0.1), (4, 33, 17, 0.1)])
def test_sinkhorn_plain_matches_pallas_kernel(jx, b, m1, n1, masked):
    """Small, the KITTI / ModelNet patch (128 points + dustbin) and a ragged
    one; the last entry and a `masked` share of the others at -1e12."""
    jnp = jx.jnp
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(b, m1, n1)).astype(np.float32)
    scores[:, -1, -1] = -1e12
    log_mu = rng.normal(size=(b, m1)).astype(np.float32)
    log_nu = rng.normal(size=(b, n1)).astype(np.float32)
    scores[rng.uniform(size=scores.shape) < masked] = -1e12
    want = jx.pallas.sinkhorn_log_norm_pallas(jnp.array(scores), jnp.array(log_mu), jnp.array(log_nu), 30, block_b=2,
                                    interpret=True)
    got = cuda_kernels.sinkhorn_log_norm(torch.from_numpy(scores), torch.from_numpy(log_mu),
                                         torch.from_numpy(log_nu), 30)
    jx.assert_close(got, want, name="sinkhorn")


def _sinkhorn_kernel_arithmetic(scores, log_mu, log_nu, iters):
    """csrc/sinkhorn.cu's arithmetic in f32 numpy: base 2; the patch padded
    to P x P (P = 4 E) with -1e30 and the duals with 0; lane l of a row's
    (column's) group of four holds columns (rows) l + 4 e; a half-sweep
    takes the lanes' maxima, the group's max, each lane's sum of
    exp2(x - max) in order of e and the group's sum in the xor butterfly's
    order, (s0 + s2) + (s1 + s3). np.exp2 / np.log2 stand in for the SFU's
    ex2 / lg2."""
    f = np.float32
    log2e, ln2 = f(1.4426950408889634), f(0.6931471805599453)
    b, m1, n1 = scores.shape
    e = -(-max(m1, n1) // 4)
    p = 4 * e
    s2 = np.full((b, p, p), -1e30, f)
    s2[:, :m1, :n1] = scores * log2e
    mu2, nu2 = np.zeros((b, p), f), np.zeros((b, p), f)
    mu2[:, :m1], nu2[:, :n1] = log_mu * log2e, log_nu * log2e
    u, v = np.zeros((b, p), f), np.zeros((b, p), f)

    def lse2(x):  # (b, p, p) -> (b, p): each row's log2 sum of exp2
        lanes = x.reshape(b, p, e, 4)
        m = lanes.max(axis=(2, 3))
        sums = np.zeros((b, p, 4), f)
        for k in range(e):
            sums += np.exp2(lanes[:, :, k] - m[:, :, None])
        return m + np.log2((sums[..., 0] + sums[..., 2]) + (sums[..., 1] + sums[..., 3]))

    for _ in range(iters):
        u = mu2 - lse2(s2 + v[:, None, :])
        u[:, m1:] = 0.0
        v = nu2 - lse2(s2.transpose(0, 2, 1) + u[:, None, :])
        v[:, n1:] = 0.0
    return ((s2 + u[:, :, None] + v[:, None, :]) * ln2)[:, :m1, :n1]


@pytest.mark.parametrize("b,m1,n1", [(5, 9, 7), (4, 65, 65), (2, 129, 129), (3, 100, 37)])
def test_sinkhorn_kernel_arithmetic_within_bound(b, m1, n1):
    """Justifies the 1e-3 bound that the card tests and chip_smoke.py hold
    the Sinkhorn kernel to, on the CPU; it tests no code of the port beyond
    the plain version. The kernel's arithmetic, emulated at the 3DMatch and
    KITTI / ModelNet patch sizes with 10% of the entries masked, stays
    within a tenth of the bound of the plain version, and masked entries
    stay masked."""
    rng = np.random.default_rng(m1)
    scores = rng.normal(size=(b, m1, n1)).astype(np.float32)
    valid = rng.uniform(size=scores.shape) < 0.9
    scores = np.where(valid, scores, np.float32(-1e12))
    log_mu = rng.normal(size=(b, m1)).astype(np.float32)
    log_nu = rng.normal(size=(b, n1)).astype(np.float32)
    got = _sinkhorn_kernel_arithmetic(scores, log_mu, log_nu, 100)
    want = cuda_kernels.sinkhorn_log_norm_plain(torch.from_numpy(scores), torch.from_numpy(log_mu),
                                                torch.from_numpy(log_nu), 100).numpy()
    assert float(np.abs(got - want)[valid].max()) <= 1e-4
    assert (got[~valid] < -1e11).all()


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and launch nothing."""
    before = (cuda_kernels.geometric_embedding.launches, cuda_kernels.sinkhorn_log_norm.launches)
    scores, _, _ = _sinkhorn_inputs()
    mu = torch.zeros(scores.shape[:2])
    nu = torch.zeros((scores.shape[0], scores.shape[2]))
    s = torch.from_numpy(scores)
    torch.testing.assert_close(cuda_kernels.sinkhorn_log_norm(s, mu, nu, 5),
                               cuda_kernels.sinkhorn_log_norm_plain(s, mu, nu, 5), rtol=0, atol=0)
    after = (cuda_kernels.geometric_embedding.launches, cuda_kernels.sinkhorn_log_norm.launches)
    assert after == before


@pytest.mark.parametrize("masks", ["prefix", "wrong shape", "wrong dtype"])
def test_embedding_wrapper_takes_node_masks_on_the_cpu(masks):
    """On CPU tensors the wrapper runs the plain version, which computes
    every entry whatever the masks say (only the kernel skips padded
    nodes); a mask of another shape or dtype than (N,) bool is refused."""
    rng = np.random.default_rng(5)
    n, c = 40, 32
    points = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    ref_vectors = torch.from_numpy(rng.uniform(-0.3, 0.3, (n, 3, 3)).astype(np.float32))
    div_term = torch.exp(torch.arange(0, c, 2, dtype=torch.float32) * (-math.log(10000.0) / c))
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32) / math.sqrt(c)) for s in ((c, c), (c,), (c, c), (c,))]
    args = (points, ref_vectors, div_term, *w, 0.2, 180.0 / (15.0 * math.pi), "max")
    valid = torch.arange(n) < 25
    if masks == "prefix":
        got = cuda_kernels.geometric_embedding(*args, valid)
        torch.testing.assert_close(got, cuda_kernels.geometric_embedding(*args), rtol=0, atol=0)
        assert float(got[25:].abs().min()) > 0.0
    else:
        bad = valid[:-1] if masks == "wrong shape" else valid.to(torch.uint8)
        with pytest.raises(ValueError, match="masks must be"):
            cuda_kernels.geometric_embedding(*args, bad)


@pytest.mark.parametrize("wrapper", ["geometric_embedding", "geometric_embedding_bwd", "sinkhorn_log_norm",
                                     "radius_search"])
def test_wrappers_raise_off_the_cpu_instead_of_falling_back(wrapper):
    """Only a CPU tensor takes the plain version: any other device launches
    the kernel or raises (here a meta tensor, which no kernel takes)."""
    meta = torch.device("meta")
    if wrapper == "sinkhorn_log_norm":
        args = (torch.zeros(2, 3, 4, device=meta), torch.zeros(2, 3, device=meta), torch.zeros(2, 4, device=meta), 5)
    elif wrapper == "geometric_embedding_bwd":
        c = 64
        args = (torch.zeros(32, 3, device=meta), torch.zeros(32, 3, 3, device=meta), torch.zeros(c // 2, device=meta),
                torch.zeros(c, c, device=meta), torch.zeros(c, device=meta), torch.zeros(32, 32, c, device=meta),
                0.2, 1.0)
    elif wrapper == "radius_search":
        args = (torch.zeros(32, 3, device=meta), torch.zeros(40, 3, device=meta),
                torch.ones(32, dtype=torch.bool, device=meta), torch.ones(40, dtype=torch.bool, device=meta), 0.1, 8)
    else:
        c = 8
        args = (torch.zeros(32, 3, device=meta), torch.zeros(32, 3, 3, device=meta), torch.zeros(c // 2, device=meta),
                torch.zeros(c, c, device=meta), torch.zeros(c, device=meta), torch.zeros(c, c, device=meta),
                torch.zeros(c, device=meta), 0.2, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(cuda_kernels, wrapper)(*args)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,padded", [(64, 32, False), (512, 256, False), (512, 256, True), (1024, 256, False),
                                        (80, 64, False), (307, 256, True), (384, 128, True)])
def test_embedding_kernel_matches_plain_on_card(n, c, padded):
    """N = 80 and 307 (the coarse cap of REF_GT_CAPS_SCALE=0.3) end in a
    ragged tile of the kernel's 64 pairs; (384, 128) is the KITTI model's
    coarse level, which runs the kernel's generic-C instance."""
    dev = _cuda()
    rng = np.random.default_rng(n)
    points = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    if padded:
        points[n - n // 8:] = 0.0  # padded nodes at one location, as the model pads its node clouds
    points = torch.from_numpy(points).to(dev)
    ref_vectors = torch.from_numpy(rng.uniform(-0.3, 0.3, (n, 3, 3)).astype(np.float32)).to(dev)
    div_term = torch.exp(torch.arange(0, c, 2, dtype=torch.float32, device=dev) * (-math.log(10000.0) / c))
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32) / math.sqrt(c)).to(dev)
         for s in ((c, c), (c,), (c, c), (c,))]
    args = (points, ref_vectors, div_term, *w, 0.2, 180.0 / (15.0 * math.pi))
    launches = cuda_kernels.geometric_embedding.launches
    got = cuda_kernels.geometric_embedding(*args)
    torch.cuda.synchronize()
    assert cuda_kernels.geometric_embedding.launches == launches + 1
    want = cuda_kernels.geometric_embedding_plain(*args)
    err = float((got - want).abs().max())
    assert err <= EMBEDDING_KERNEL_BOUND, f"max abs error {err:.3e} against the plain version"


def _masked_embedding_case(dev, n, c, layout):
    """Seeded kernel arguments for a cloud of N nodes and its (N,) masks:
    "prefix<v>" keeps the first v valid and moves the padded nodes to one
    location, as the model pads its node clouds; "scattered" keeps ~30% of
    the nodes anywhere, a whole 64-column tile padded, the last node valid."""
    rng = np.random.default_rng(n + c)
    points = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    if layout == "scattered":
        valid = rng.uniform(size=n) < 0.3
        valid[128:192] = False
        valid[-1] = True
    else:
        valid = np.arange(n) < int(layout[len("prefix"):])
        points[~valid] = 0.0
    points = torch.from_numpy(points).to(dev)
    ref_vectors = torch.from_numpy(rng.uniform(-0.3, 0.3, (n, 3, 3)).astype(np.float32)).to(dev)
    div_term = torch.exp(torch.arange(0, c, 2, dtype=torch.float32, device=dev) * (-math.log(10000.0) / c))
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32) / math.sqrt(c)).to(dev)
         for s in ((c, c), (c,), (c, c), (c,))]
    return (points, ref_vectors, div_term, *w, 0.2, 180.0 / (15.0 * math.pi), "max"), torch.from_numpy(valid).to(dev)


def _computing_blocks(valid):
    """Blocks of the embedding kernel that compute under node masks `valid`:
    per valid row, the 64-column tiles that hold a valid column."""
    tile = cuda_kernels.EMBEDDING_TILE
    n = valid.shape[0]
    tiles = torch.nn.functional.pad(valid, (0, -n % tile)).view(-1, tile).any(dim=1)
    return int(valid.sum()) * int(tiles.sum())


def _embedding_counts():
    fn = cuda_kernels.geometric_embedding
    return fn.launches, fn.launched_blocks, 0 if fn.computed_blocks is None else int(fn.computed_blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,layout", [(1024, 256, "prefix310"), (1024, 256, "prefix350"), (1024, 256, "prefix410"),
                                        (384, 128, "prefix210"), (307, 256, "prefix290"), (307, 256, "prefix250"),
                                        (1024, 256, "scattered"), (384, 128, "scattered"), (1024, 256, "prefix1024"),
                                        (384, 128, "prefix384"), (307, 256, "prefix307")])
def test_masked_embedding_kernel_skips_padded_nodes_on_card(n, c, layout):
    """With node masks the kernel's entries of two valid nodes equal those of
    a launch without masks bit for bit, and lie within the bound of the plain
    version; every entry with a padded node is 0. The computing blocks are
    the valid rows' tiles that hold a valid column, counted on the device.
    The 3DMatch cells' coarse clouds hold 310-410 valid nodes of 1024 (C =
    256), KITTI's 210-318 of 384 (C = 128, the generic-C instance); N = 307
    ends in a ragged tile, partly valid at 290, all padded at 250. With every
    node valid the output is that of a launch without masks, bit for bit,
    and every block computes."""
    dev = _cuda()
    args, valid = _masked_embedding_case(dev, n, c, layout)
    before = _embedding_counts()
    full = cuda_kernels.geometric_embedding(*args)
    got = cuda_kernels.geometric_embedding(*args, valid)
    torch.cuda.synchronize()
    after = _embedding_counts()
    blocks = -(-n // cuda_kernels.EMBEDDING_TILE) * n
    assert after[0] - before[0] == 2 and after[1] - before[1] == 2 * blocks
    assert after[2] - before[2] == blocks + _computing_blocks(valid)
    pair = valid[:, None] & valid[None, :]
    assert torch.equal(got[pair], full[pair]), "valid entries differ from the launch without masks"
    assert not bool(got[~pair].any()), "an entry with a padded node is not 0"
    want = cuda_kernels.geometric_embedding_plain(*args)
    err = float((got - want)[pair].abs().max())
    assert err <= EMBEDDING_KERNEL_BOUND, f"max abs error {err:.3e} against the plain version on valid pairs"


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,layout", [(1024, 256, "prefix350"), (384, 128, "prefix210"), (307, 256, "scattered")])
def test_masked_embedding_function_gradients_on_card(n, c, layout):
    """Through `GeometricEmbeddingFunction`, with a cotangent that is 0 at
    every entry with a padded node (as in the model): the weight gradients
    with masks equal those without bit for bit (the backward kernel ignores
    the masks), and the forward's valid entries too."""
    dev = _cuda()
    args, valid = _masked_embedding_case(dev, n, c, layout)
    pair = valid[:, None] & valid[None, :]
    g = torch.randn((n, n, c), generator=torch.Generator(device=dev).manual_seed(n), device=dev)
    g = torch.where(pair[:, :, None], g, 0.0)
    outs, grads = [], []
    for masks in (None, valid):
        weights = [t.clone().requires_grad_(True) for t in args[3:7]]
        out = cuda_kernels.GeometricEmbeddingFunction.apply(*args[:3], *weights, *args[7:], masks)
        out.backward(g)
        outs.append(out.detach())
        grads.append([t.grad for t in weights])
    torch.cuda.synchronize()
    assert torch.equal(outs[0][pair], outs[1][pair])
    assert not bool(outs[1][~pair].any())
    for name, x, y in zip(("dwd", "dbd", "dwa", "dba"), *grads):
        assert torch.equal(x, y), f"{name}: gradients with masks differ from those without"


@pytest.mark.cuda
@pytest.mark.parametrize("b,m1,n1", [(5, 9, 7), (256, 65, 65), (256, 129, 129), (7, 1, 1), (3, 100, 37),
                                     (4, 144, 133)])
def test_sinkhorn_kernel_matches_plain_on_card(b, m1, n1):
    """The 3DMatch patch (65 x 65) and the KITTI / ModelNet one (129 x 129),
    each in a full batch; sizes that leave lanes and groups empty; and the
    kernel's largest, whose column copy lies in shared memory."""
    dev = _cuda()
    rng = np.random.default_rng(b)
    scores = torch.from_numpy(rng.normal(size=(b, m1, n1)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(b, m1, n1)) < 0.9).to(dev)
    scores = torch.where(valid, scores, -1e12)
    log_mu = torch.from_numpy(rng.normal(size=(b, m1)).astype(np.float32)).to(dev)
    log_nu = torch.from_numpy(rng.normal(size=(b, n1)).astype(np.float32)).to(dev)
    launches = cuda_kernels.sinkhorn_log_norm.launches
    got = cuda_kernels.sinkhorn_log_norm(scores, log_mu, log_nu, 100)
    torch.cuda.synchronize()
    assert cuda_kernels.sinkhorn_log_norm.launches == launches + 1
    want = cuda_kernels.sinkhorn_log_norm_plain(scores, log_mu, log_nu, 100)
    assert float((got - want)[valid].abs().max()) <= 1e-3
    assert bool((got[~valid] < -1e11).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m1,n1", [(cuda_kernels.SINKHORN_MAX_DIM + 1, 5), (5, cuda_kernels.SINKHORN_MAX_DIM + 1)])
def test_sinkhorn_kernel_raises_beyond_its_limit(m1, n1):
    dev = _cuda()
    launches = cuda_kernels.sinkhorn_log_norm.launches
    with pytest.raises(ValueError, match="beyond the kernel's limit"):
        cuda_kernels.sinkhorn_log_norm(torch.zeros(2, m1, n1, device=dev), torch.zeros(2, m1, device=dev),
                                       torch.zeros(2, n1, device=dev), 5)
    assert cuda_kernels.sinkhorn_log_norm.launches == launches


# the backward kernel: f32 sums over N^2 rows, in another order than the
# plain version's (per-chunk partials of 32-row tiles vs chunked GEMMs),
# and f32-accurate products (split TF32 on the tensor cores): held at 1e-4
# of each gradient's largest magnitude, which a copy of the kernel with one
# TF32 pass fails on every case below (4e-4 to 9e-4, PERF.md). The two
# recompute the angle projections in another order too, so a branch within
# rounding of the winner may win in one and lose in the other, moving a
# row's share of dWa: g is zeroed where the two best branches lie within
# NEAR_TIE but do not tie exactly (exact ties, on the diagonal and between
# the padded nodes, stay in).
EMBEDDING_BWD_BOUND = 1e-4
NEAR_TIE = 1e-3


def _embedding_bwd_args(dev, n, c, k, seed, ties_only=False):
    rng = np.random.default_rng(seed)
    points = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    points[n - n // 8:] = 0.0  # padded nodes at one location: exact ties, like the diagonal
    ref_vectors = rng.uniform(-0.3, 0.3, (n, k, 3)).astype(np.float32)
    div_term = np.exp(np.arange(0, c, 2, dtype=np.float32) * (-np.log(10000.0) / c)).astype(np.float32)
    wa = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32)
    ba = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(n, n, c)).astype(np.float32)).to(dev)
    geometry = [torch.from_numpy(a).to(dev) for a in (points, ref_vectors, div_term, wa, ba)]
    constants = [0.2, 180.0 / (15.0 * math.pi)]
    if ties_only:  # g kept where the anchor vector is 0: the diagonal and the pairs of padded nodes
        tie = torch.eye(n, dtype=torch.bool, device=dev)
        tie[n - n // 8:, n - n // 8:] = True
        g = torch.where(tie[:, :, None], g, 0.0)
    else:
        g = torch.where(cuda_kernels.near_ties(*geometry, *constants, NEAR_TIE), 0.0, g)
    return geometry + [g] + constants


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,k,cotangent", [(64, 64, 3, "random"), (128, 128, 2, "random"), (512, 256, 3, "random"),
                                             (1024, 256, 3, "random"), (512, 256, 3, "ties_only"),
                                             (512, 256, 1, "random"), (80, 64, 3, "random"),
                                             (307, 256, 3, "random"), (384, 128, 3, "random")])
def test_embedding_bwd_kernel_matches_plain_on_card(n, c, k, cotangent):
    """The kernel against the plain version, and two launches bit for bit.
    "ties_only" keeps g on the exactly tied pairs only, where all k angles
    are 0 and every branch's sinusoids are [0..., 1...]: the masks must
    split g into k equal shares that sum to 1, so the cosine rows of dWa
    equal db and its sine rows are 0. k = 1 has no routing. N = 80 and 307
    end in a ragged tile of the kernel's 32 pairs; (384, 128, 3) is the
    KITTI model's coarse level."""
    dev = _cuda()
    args = _embedding_bwd_args(dev, n, c, k, seed=n + k, ties_only=cotangent == "ties_only")
    launches = cuda_kernels.geometric_embedding_bwd.launches
    got = cuda_kernels.geometric_embedding_bwd(*args)
    again = cuda_kernels.geometric_embedding_bwd(*args)
    torch.cuda.synchronize()
    assert cuda_kernels.geometric_embedding_bwd.launches == launches + 2
    want = cuda_kernels.geometric_embedding_bwd_plain(*args)
    for name, x, y, z in zip(("dwd", "dbd", "dwa", "dba"), got, again, want):
        assert torch.equal(x, y), f"{name}: two launches differ"
        err = float((x - z).abs().max()) / float(z.abs().max())
        assert err <= EMBEDDING_BWD_BOUND, f"{name}: error {err:.3e} of the largest magnitude against the plain version"
    if cotangent == "ties_only":
        dwa, db = got[2], got[1]
        err = float((dwa[c // 2:] - db[None, :]).abs().max()) / float(db.abs().max())
        assert err <= EMBEDDING_BWD_BOUND, f"tied shares: cosine rows of dwa off db by {err:.3e}"
        assert float(dwa[: c // 2].abs().max()) == 0.0


@pytest.mark.cuda
def test_embedding_module_backward_launches_both_kernels_on_card():
    dev = _cuda()
    rng = np.random.default_rng(0)
    module = GeometricStructureEmbedding(64, 0.2, 15.0, 3, "max").to(dev)
    points = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 3)).astype(np.float32)).to(dev)
    masks = torch.ones((1, 64), dtype=torch.bool, device=dev)
    before = (cuda_kernels.geometric_embedding.launches, cuda_kernels.geometric_embedding_bwd.launches)
    module(points, masks).square().sum().backward()
    torch.cuda.synchronize()
    after = (cuda_kernels.geometric_embedding.launches, cuda_kernels.geometric_embedding_bwd.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    plain = GeometricStructureEmbedding(64, 0.2, 15.0, 3, "max", use_kernel=False).to(dev)
    plain.load_state_dict(module.state_dict())
    plain(points, masks).square().sum().backward()
    for (name, p), q in zip(module.named_parameters(), plain.parameters()):
        assert float((p.grad - q.grad).abs().max()) <= 1e-3 * float(q.grad.abs().max()), name


# ---------------------------------------------------------------------------
# On the card, at the LineMod encoder's shapes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def linemod_path(tmp_path_factory):
    """One inference forward of the LineMod encoder (published widths and
    capacities, seeded random weights) on a fixture frame, on the card: the
    model, the src cloud's coarse nodes (N = 256, the level-2 capacity,
    most of them filled by the box's mesh sample) and the inputs of its
    optimal-transport layer (64 patches of 128 points and the dustbin)."""
    from ref_geotransformer_tpu_torch import demo
    from ref_geotransformer_tpu_torch.config.modelnet import make_cfg
    from ref_geotransformer_tpu_torch.data import PairLoader
    from ref_geotransformer_tpu_torch.data.datasets.linemod import LMODataset
    from ref_geotransformer_tpu_torch.engine.steps import ensure_pyramids, to_device
    from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4.fixture import (
        make_linemod_tree,
    )

    dev = _cuda()
    root = tmp_path_factory.mktemp("lm")
    make_linemod_tree(str(root / "linemod"), n_train=1, n_test=1)
    cfg = make_cfg()
    dataset = LMODataset(str(root), data_augmentation=False, points_limit=1000, mode="test", seed=cfg.seed)
    pair, _ = next(PairLoader(dataset, cfg).iter_single())
    data = ensure_pyramids(cfg, to_device(pair, dev))
    model = demo.build_model(cfg, dev, seed=0)
    captured = {}
    hook = model.optimal_transport.register_forward_pre_hook(lambda module, inputs: captured.update(inputs=inputs))
    model(data)
    hook.remove()
    nodes, node_masks = data["src"]["points"][-1], data["src"]["masks"][-1]
    assert nodes.shape[0] == 256 and int(node_masks.sum()) > 128
    return model, nodes, node_masks, captured["inputs"]


@pytest.mark.cuda
def test_embedding_kernels_match_plain_at_linemod_shapes(linemod_path):
    """Forward and backward at N = 256, C = 256, k = 3 on the LineMod node
    cloud (a ~10 cm object 0.6-0.9 m from the camera; sigma_d 0.2 m), the
    model's own weights and anchor vectors, a seeded cotangent."""
    model, nodes, node_masks, _ = linemod_path
    dev = nodes.device
    with torch.no_grad():
        (args,) = model.transformer.embedding.kernel_args(nodes[None], node_masks[None])
        launches = cuda_kernels.geometric_embedding.launches
        got = cuda_kernels.geometric_embedding(*args)
        torch.cuda.synchronize()
        assert cuda_kernels.geometric_embedding.launches == launches + 1
        want = cuda_kernels.geometric_embedding_plain(*args)
    assert got.shape == (256, 256, 256)
    err = float((got - want).abs().max())
    assert err <= EMBEDDING_KERNEL_BOUND, f"forward: max abs error {err:.3e} against the plain version"

    points, ref_vectors, div_term, _, _, wa, ba, sigma_d, factor_a, _ = args
    geometry = (points, ref_vectors, div_term, wa.detach(), ba.detach())
    g = torch.randn((256, 256, 256), generator=torch.Generator(device=dev).manual_seed(256), device=dev)
    g = torch.where(cuda_kernels.near_ties(*geometry, sigma_d, factor_a, NEAR_TIE), 0.0, g)
    bwd_args = (*geometry, g, sigma_d, factor_a)
    launches = cuda_kernels.geometric_embedding_bwd.launches
    got = cuda_kernels.geometric_embedding_bwd(*bwd_args)
    again = cuda_kernels.geometric_embedding_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert cuda_kernels.geometric_embedding_bwd.launches == launches + 2
    want = cuda_kernels.geometric_embedding_bwd_plain(*bwd_args)
    for name, x, y, z in zip(("dwd", "dbd", "dwa", "dba"), got, again, want):
        assert torch.equal(x, y), f"{name}: two launches differ"
        err = float((x - z).abs().max()) / float(z.abs().max())
        assert err <= EMBEDDING_BWD_BOUND, f"{name}: error {err:.3e} of the largest magnitude against the plain version"


@pytest.mark.cuda
def test_sinkhorn_kernel_matches_plain_at_linemod_shapes(linemod_path):
    """(64, 129, 129), 100 iterations, on the forward's own matching scores
    and patch masks."""
    model, _, _, inputs = linemod_path
    ot = model.optimal_transport
    with torch.no_grad():
        padded, log_mu, log_nu, _ = ot.prepare(*inputs)
        assert tuple(padded.shape) == (64, 129, 129)
        launches = cuda_kernels.sinkhorn_log_norm.launches
        got = cuda_kernels.sinkhorn_log_norm(padded, log_mu, log_nu, ot.num_iterations)
        torch.cuda.synchronize()
        assert cuda_kernels.sinkhorn_log_norm.launches == launches + 1
        want = cuda_kernels.sinkhorn_log_norm_plain(padded, log_mu, log_nu, ot.num_iterations)
    valid = padded > -1e11
    assert float((got - want)[valid].abs().max()) <= 1e-3
    assert bool((got[~valid] < -1e11).all())


@pytest.mark.cuda
def test_grid_subsample_on_card_matches_native():
    """The card's voxel grid against the host C++ kernel on a raw LiDAR scan
    of a KITTI frame's size (120000 points over 40 m) at 0.3 m: the same
    voxels in the same (z, y, x) order, centroids within 1e-5. A voxel index
    computed with the reciprocal of the voxel size moves points on a voxel
    face into the next voxel and shifts two centroids by ~1e-4."""
    from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5.fixture import _scan
    from ref_geotransformer_tpu_torch.native import grid_subsample_native
    from ref_geotransformer_tpu_torch.ops.subsample import grid_subsample

    dev = _cuda()
    scan = _scan(np.random.default_rng(14), 120000, 40.0, True)
    scan[:, 2] -= 1.73
    want, total = grid_subsample_native(scan, 0.3)
    points = torch.from_numpy(scan).to(dev)
    got, masks = grid_subsample(points, torch.ones(len(scan), dtype=torch.bool, device=dev), 0.3, len(scan))
    assert int(masks.sum()) == total and bool(masks[:total].all())
    assert float(np.abs(got[:total].cpu().numpy() - want).max()) <= 1e-5


# the radius search: the kernel and the plain version rank the same f32 form
# |q|^2 - 2 q.s + |s|^2 with the dot product summed in other orders (FMAs in
# the kernel, cuBLAS in the plain version), so their tables may differ where
# two squared distances lie within rounding of each other, which grows with
# the squared norms: a neighbor in only one row must tie with the row's
# farthest within RADIUS_TIE * (1 + |q|^2 + |s|^2)
RADIUS_TIE = 1e-6


def _radius_inputs(dev, m, n, seed, q_valid=0.9, s_valid=0.9, duplicates=0, scale=1.0):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, scale, (n, 3)).astype(np.float32)
    s[duplicates : 2 * duplicates] = s[:duplicates]
    q = s[:m].copy() if m <= n else rng.uniform(0.0, scale, (m, 3)).astype(np.float32)
    qm = rng.uniform(size=m) < q_valid
    sm = rng.uniform(size=n) < s_valid
    return tuple(torch.from_numpy(a).to(dev) for a in (q, s, qm, sm))


def _check_radius_kernel(q, s, qm, sm, radius, limit):
    """The kernel against the plain version up to ties, two launches bit-identical, one count per call."""
    from ref_geotransformer_tpu_torch.utils.neighbor_tables import table_mismatches

    launches = cuda_kernels.radius_search_group.launches
    got = cuda_kernels.radius_search(q, s, qm, sm, radius, limit)
    again = cuda_kernels.radius_search(q, s, qm, sm, radius, limit)
    torch.cuda.synchronize()
    assert cuda_kernels.radius_search_group.launches == launches + 2
    want = cuda_kernels.radius_search_plain(q, s, qm, sm, radius, limit)
    assert got.dtype == torch.int32 and tuple(got.shape) == (q.shape[0], limit)
    assert torch.equal(got, again), "two launches differ"
    n = s.shape[0]
    assert bool(((got >= 0) & (got <= n)).all())
    assert bool((got[~qm] == n).all()), "an invalid query's row holds a neighbor"
    _, bad, _ = table_mismatches(got.cpu().numpy(), want.cpu().numpy(), q.cpu().numpy(), s.cpu().numpy(),
                                 RADIUS_TIE, scaled=True)
    assert not bad, f"{len(bad)} rows differ beyond ties; {bad[0]}"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,limit,radius", [(1, 1, 1, 0.5), (300, 700, 16, 0.15), (2049, 4097, 38, 0.08),
                                              (1000, 1500, 64, 0.2), (512, 512, 128, 0.4)])
def test_radius_search_kernel_matches_plain_on_card(m, n, limit, radius):
    """Random clouds: one point; ragged M and N (not multiples of the
    kernel's 128-query blocks and 256-support tiles); several support slices
    merged in a cluster (2049 x 4097, a group of one); limits 16 to 128 in
    the one shared-memory list, the longest mostly full."""
    dev = _cuda()
    _check_radius_kernel(*_radius_inputs(dev, m, n, seed=m + n), radius, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all queries invalid", "no valid support", "duplicated points"])
def test_radius_search_kernel_edges_on_card(case):
    dev = _cuda()
    kwargs = {"all queries invalid": {"q_valid": 0.0}, "no valid support": {"s_valid": 0.0},
              "duplicated points": {"duplicates": 700}}[case]
    q, s, qm, sm = _radius_inputs(dev, 3000, 3000, seed=7, **kwargs)
    got = _check_radius_kernel(q, s, qm, sm, 0.1, 38)
    n = s.shape[0]
    if case != "duplicated points":
        assert bool((got == n).all())
    else:
        # a duplicate's row starts with the lower index of its pair: (d^2, j) order
        rows = torch.arange(700, 1400, device=dev)
        valid = qm[rows] & sm[rows - 700] & sm[rows]
        assert bool((got[rows[valid], 0] == rows[valid] - 700).all())


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [0, cuda_kernels.RADIUS_SEARCH_MAX_LIMIT + 1])
def test_radius_search_kernel_raises_beyond_its_limit(limit):
    """limit 0 or 129 on a CUDA tensor raises and runs nothing, not the plain version."""
    dev = _cuda()
    q, s, qm, sm = _radius_inputs(dev, 200, 300, seed=1)
    launches = cuda_kernels.radius_search_group.launches
    with pytest.raises(ValueError, match=f"radius_search_group: limit {limit}"):
        cuda_kernels.radius_search(q, s, qm, sm, 0.2, limit)
    assert cuda_kernels.radius_search_group.launches == launches


def _radius_group(dev, seed):
    """Seeded searches over clouds that share supports, as
    tests/test_torch_port_radius_search.py's ragged group, plus a search
    large enough to be cut into several slices."""
    q, s, qm, sm = _radius_inputs(dev, 301, 777, seed=seed, q_valid=0.8, duplicates=90)
    few = torch.from_numpy(np.random.default_rng(seed + 1).uniform(size=200) < 0.2).to(dev)
    b, _, bm, _ = _radius_inputs(dev, 129, 5, seed=seed + 2, q_valid=0.6)
    big_q, big_s, big_qm, big_sm = _radius_inputs(dev, 3001, 5003, seed=seed + 3, duplicates=500)
    return [(q, s, qm, sm, 0.25, 128), (q, s, qm, sm, 0.2, 1), (s, s, sm, sm, 0.15, 38),
            (b, s[:200], bm, few, 2.0, 64), (s, q, sm, qm, 0.3, 17), (q[:5], s[:40], qm[:5], sm[:40], 0.5, 40),
            (big_q, big_s, big_qm, big_sm, 0.1, 38), (big_s, big_s, big_sm, big_sm, 0.12, 128)]


def _check_radius_group(group, tables):
    from ref_geotransformer_tpu_torch.utils.neighbor_tables import table_mismatches

    for k, (table, (q, s, qm, sm, radius, limit)) in enumerate(zip(tables, group)):
        n = s.shape[0]
        assert table.dtype == torch.int32 and tuple(table.shape) == (q.shape[0], limit)
        assert bool(((table >= 0) & (table <= n)).all())
        assert bool((table[~qm] == n).all()), f"search {k}: an invalid query's row holds a neighbor"
        want = cuda_kernels.radius_search_plain(q, s, qm, sm, radius, limit)
        _, bad, _ = table_mismatches(table.cpu().numpy(), want.cpu().numpy(), q.cpu().numpy(), s.cpu().numpy(),
                                     RADIUS_TIE, scaled=True)
        assert not bad, f"search {k}: {len(bad)} rows differ beyond ties; {bad[0]}"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_radius_search_group_matches_plain_on_card(seed):
    """A ragged group in one search launch: every table against the plain
    version up to ties, two launches bit-identical, each equal to the
    search run alone (a group of one), and one count per launch."""
    dev = _cuda()
    group = _radius_group(dev, seed)
    launches, searches = cuda_kernels.radius_search_group.launches, cuda_kernels.radius_search_group.searches
    tables = cuda_kernels.radius_search_group(group)
    again = cuda_kernels.radius_search_group(group)
    torch.cuda.synchronize()
    assert cuda_kernels.radius_search_group.launches == launches + 2
    assert cuda_kernels.radius_search_group.searches == searches + 2 * len(group)
    for a, b in zip(tables, again):
        assert torch.equal(a, b), "two launches differ"
    _check_radius_group(group, tables)
    for table, search in zip(tables, group):
        assert torch.equal(table, cuda_kernels.radius_search(*search)), "a search differs alone and in a group"


@pytest.mark.cuda
def test_radius_search_group_slices_give_the_same_bits():
    """The slice merge keeps (d^2, j) order exactly. A query block over 2, 4
    and 16 support tiles is cut into 2, 4 and 8 slices (as many as the tiles
    allow, the group's work being small); beside a 20000-point self search
    the same searches run unsliced. Each table matches the plain version up
    to ties, two launches give the same bits, and the sliced and unsliced
    tables are equal."""
    dev = _cuda()
    small = []
    for n, limit, seed in ((512, 16, 20), (1024, 128, 21), (4096, 38, 22)):
        q, s, qm, sm = _radius_inputs(dev, 128, n, seed=seed, duplicates=40)
        small.append((q, s, qm, sm, 0.2, limit))
    big = _radius_inputs(dev, 20000, 20000, seed=23)
    sliced = cuda_kernels.radius_search_group(small)
    assert cuda_kernels.radius_search_group.slices == [2, 4, 8]
    again = cuda_kernels.radius_search_group(small)
    whole = cuda_kernels.radius_search_group(small + [big + (0.05, 38)])
    assert cuda_kernels.radius_search_group.slices[:3] == [1, 1, 1], cuda_kernels.radius_search_group.slices
    torch.cuda.synchronize()
    _check_radius_group(small, sliced)
    for k, (a, b, c) in enumerate(zip(sliced, again, whole)):
        assert torch.equal(a, b), f"search {k}: two launches differ"
        assert torch.equal(a, c), f"search {k}: sliced and unsliced tables differ"


@pytest.mark.cuda
def test_radius_search_group_one_launch_for_a_pairs_pyramids():
    """build_registration_inputs makes the pair's 20 searches (4 stages) in
    one search launch; each table equals the search run alone on the same
    levels (build_pyramid's own levels may differ: grid_subsample sums its
    centroids with atomics)."""
    from ref_geotransformer_tpu_torch.data.pyramid import build_registration_inputs, pad_points

    dev = _cuda()
    rng = np.random.default_rng(16)
    clouds = [pad_points(rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32), 4096) for n in (3500, 2900)]
    (ref, ref_m), (src, src_m) = [tuple(torch.from_numpy(a).to(dev) for a in c) for c in clouds]
    limits, radius = (38, 36, 36, 38), 0.0625
    args = (4, 0.025, radius, limits, (4096, 4096, 1024, 512))
    launches, searches = cuda_kernels.radius_search_group.launches, cuda_kernels.radius_search_group.searches
    data = build_registration_inputs(ref, ref_m, src, src_m, *args)
    torch.cuda.synchronize()
    assert cuda_kernels.radius_search_group.launches == launches + 1
    assert cuda_kernels.radius_search_group.searches == searches + 20
    for cloud in ("ref", "src"):
        pts, msk = data[cloud]["points"], data[cloud]["masks"]
        r = radius
        for i in range(4):
            want = cuda_kernels.radius_search(pts[i], pts[i], msk[i], msk[i], r, limits[i])
            assert torch.equal(data[cloud]["neighbors"][i], want), f"{cloud} neighbors {i}"
            if i < 3:
                want = cuda_kernels.radius_search(pts[i + 1], pts[i], msk[i + 1], msk[i], r, limits[i])
                assert torch.equal(data[cloud]["subsampling"][i], want), f"{cloud} subsampling {i}"
                want = cuda_kernels.radius_search(pts[i], pts[i + 1], msk[i], msk[i + 1], 2 * r, limits[i + 1])
                assert torch.equal(data[cloud]["upsampling"][i], want), f"{cloud} upsampling {i}"
            r *= 2


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [1, 38, 128])
def test_radius_search_kernels_use_no_local_memory(limit):
    """No stack and no spills in the search kernel (one instance serves
    every limit, its lists in shared memory) or the packing kernel, and a
    block resides at the longest limit."""
    _cuda()
    info = cuda_kernels.radius_search_info(limit)
    assert info["local_bytes"] == 0 and info["pack_local_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info
    assert info["max_limit"] == cuda_kernels.RADIUS_SEARCH_MAX_LIMIT
