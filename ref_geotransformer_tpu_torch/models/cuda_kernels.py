"""The CUDA kernels of the port, each beside its plain PyTorch version.

Counterpart of `ref_geotransformer_tpu/models/pallas_kernels.py`:

* `geometric_embedding` (kernel `csrc/geo_embedding.cu`) replaces
  `geometric_embedding_pallas`;
* `geometric_embedding_bwd` (kernel `csrc/geo_embedding_bwd.cu`) replaces
  `_geo_embedding_bwd`; `GeometricEmbeddingFunction` joins the two, as
  `make_geometric_embedding_vjp` does;
* `sinkhorn_log_norm` (kernel `csrc/sinkhorn.cu`) replaces
  `sinkhorn_log_norm_pallas`.

Dispatch is by device and nothing else: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel, or raises if the kernel cannot
take it. Each wrapper counts its kernel launches in `.launches`, a plain
integer, incremented only where the kernel is launched.
"""

from __future__ import annotations

import torch

from ref_geotransformer_tpu_torch.utils import build

SINKHORN_MAX_DIM = 144  # largest M1 and N1 the Sinkhorn kernel takes


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_f32_cuda(name: str, device: torch.device, **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        _require(t.device == device, f"{name}: {key} on {t.device}, expected {device}")
        _require(t.dtype == torch.float32, f"{name}: {key} is {t.dtype}, expected float32")
        _require(t.is_contiguous(), f"{name}: {key} is not contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name}: {key} is not 16-byte aligned")


def sinusoid(x: torch.Tensor, div_term: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., C): [sin(x * div_term), cos(x * div_term)], sines first."""
    omegas = x[..., None] * div_term
    return torch.cat([torch.sin(omegas), torch.cos(omegas)], dim=-1)


def embedding_indices(row_points, points, row_ref_vectors, sigma_d, factor_a):
    """Sinusoid arguments of the node pairs (i, j), i over `row_points`
    (R, 3) with their `row_ref_vectors` (R, k, 3), j over `points` (N, 3):
    d / sigma_d (R, N) and the k angles times factor_a (R, N, k).

    Distances are taken from the anchor vectors p_j - p_i, so the diagonal
    is exactly 0, as in the JAX package's jitted forward (XLA fuses the
    inner-product form there and it cancels exactly; evaluated op by op,
    that form leaves sqrt(rounding residual) ~ 1e-3 on the diagonal).
    """
    anc = points[None, :, :] - row_points[:, None, :]  # anc[i, j] = p_j - p_i
    dist = torch.sqrt(torch.sum(anc * anc, dim=-1))  # (R, N)
    ref = row_ref_vectors[:, None, :, :]  # (R, 1, k, 3)
    anc_k = anc[:, :, None, :]  # (R, N, 1, 3)
    sin_v = torch.linalg.norm(torch.linalg.cross(ref, anc_k), dim=-1)  # (R, N, k)
    cos_v = torch.sum(ref * anc_k, dim=-1)
    return dist / sigma_d, torch.atan2(sin_v, cos_v) * factor_a


def geometric_embedding_plain(points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a="max"):
    """Plain PyTorch structure embedding: the XLA path of
    `ref_geotransformer_tpu/models/embedding.py`, with the (N, N, k, C)
    angle projections materialized, then reduced over k. Differentiable in
    the weights: `amax` splits the gradient equally among tied branches,
    as `jnp.max` does (`max(dim).values` would route it to one).

    Args: points (N, 3); ref_vectors (N, k, 3) vectors to each node's k
    nearest nodes; div_term (C/2,); wd, wa (C, C) with rows in
    [sin..., cos...] order; bd, ba (C,). Returns (N, N, C) float32.
    """
    _require(reduction_a == "max", f"geometric_embedding: angle reduction {reduction_a!r}: the kernel takes max only "
             "(the mean is models/embedding.py's own computation)")
    d_idx, a_idx = embedding_indices(points, points, ref_vectors, sigma_d, factor_a)
    d_emb = sinusoid(d_idx, div_term) @ wd + bd
    a_emb = sinusoid(a_idx, div_term) @ wa + ba  # (N, N, k, C)
    return d_emb + torch.amax(a_emb, dim=2)


def geometric_embedding(points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a="max"):
    """(N, N, C) geometric structure embedding of one cloud's nodes; the
    arguments are those of `geometric_embedding_plain`. On a CUDA tensor it
    runs the fused kernel, for any N: precise sin/cos and atan2, products on the tensor
    cores in TF32 with each operand split into two TF32 terms (f32-accurate)."""
    if points.device.type == "cpu":
        return geometric_embedding_plain(points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a)
    _require(points.is_cuda, f"geometric_embedding: unsupported device {points.device}")
    n, k, c = points.shape[0], ref_vectors.shape[1], wd.shape[0]
    _check_f32_cuda("geometric_embedding", points.device, points=points, ref_vectors=ref_vectors,
                    div_term=div_term, wd=wd, bd=bd, wa=wa, ba=ba)
    _require(reduction_a == "max", f"geometric_embedding: angle reduction {reduction_a!r}: the kernel takes max only "
             "(the mean is models/embedding.py's own computation)")
    _require(n >= 1, "geometric_embedding: no nodes")
    _require(c % 32 == 0 and c <= 256, f"geometric_embedding: C={c} must be a multiple of 32 and <= 256")
    _require(tuple(points.shape) == (n, 3) and tuple(ref_vectors.shape) == (n, k, 3),
             "geometric_embedding: points must be (N, 3) and ref_vectors (N, k, 3)")
    _require(tuple(wd.shape) == (c, c) and tuple(wa.shape) == (c, c) and tuple(div_term.shape) == (c // 2,)
             and tuple(bd.shape) == (c,) and tuple(ba.shape) == (c,), "geometric_embedding: weight shapes")
    out = torch.empty((n, n, c), dtype=torch.float32, device=points.device)
    lib = build.load_library()
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = lib.gt_geo_embedding(
        points.data_ptr(), ref_vectors.data_ptr(), div_term.data_ptr(), wd.data_ptr(), bd.data_ptr(),
        wa.data_ptr(), ba.data_ptr(), out.data_ptr(), n, k, c, float(sigma_d), float(factor_a), stream,
    )
    build.check(err, "gt_geo_embedding")
    geometric_embedding.launches += 1
    return out


geometric_embedding.launches = 0

PLAIN_BWD_ELEMENTS = 1 << 26  # rows of a chunk x N x k x C kept under this in the plain backward


def _row_chunks(points, ref_vectors, div_term, wa, ba, sigma_d, factor_a):
    """Per chunk of rows i, so that N = 1024 fits: (i0, i1, the distance
    sinusoids (R, C), the angle arguments (R, k), their sinusoids (R, k, C)
    and projections emb_t @ Wa + ba (R, k, C)), R = (i1 - i0) * N pairs."""
    n, k = ref_vectors.shape[:2]
    c = wa.shape[0]
    rows = max(1, PLAIN_BWD_ELEMENTS // (n * k * c))
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        d_idx, a_idx = embedding_indices(points[i0:i1], points, ref_vectors[i0:i1], sigma_d, factor_a)
        emb = sinusoid(a_idx, div_term).reshape(-1, k, c)
        yield i0, i1, sinusoid(d_idx, div_term).reshape(-1, c), a_idx.reshape(-1, k), emb, emb @ wa + ba


def geometric_embedding_bwd_plain(points, ref_vectors, div_term, wa, ba, g, sigma_d, factor_a):
    """Plain PyTorch backward of the structure embedding with respect to its
    weights: the recompute-and-route math of `_geo_embedding_bwd`, chunked
    over rows i.

    g (N, N, C) is the cotangent of the output. Returns dwd, dbd, dwa, dba:
    dWd = sum emb_d^T g, dbd = dba = sum g, dWa = sum_t emb_t^T (g * mask_t),
    where mask_t routes each channel to the angle branch whose projection
    emb_t @ Wa + ba won the max, ties split equally (the vjp of a max).
    """
    c = wa.shape[0]
    dwd = torch.zeros((c, c), dtype=g.dtype, device=g.device)
    dwa = torch.zeros_like(dwd)
    db = torch.zeros((c,), dtype=g.dtype, device=g.device)
    for i0, i1, emb_d, _, emb, proj in _row_chunks(points, ref_vectors, div_term, wa, ba, sigma_d, factor_a):
        gg = g[i0:i1].reshape(-1, c)
        dwd += emb_d.T @ gg
        db += gg.sum(dim=0)
        ties = (proj == torch.amax(proj, dim=1, keepdim=True)).to(g.dtype)
        mask = ties / torch.clamp(ties.sum(dim=1, keepdim=True), min=1.0)
        dwa += emb.reshape(-1, c).T @ (gg[:, None, :] * mask).reshape(-1, c)
    return dwd, db, dwa, db.clone()


def near_ties(points, ref_vectors, div_term, wa, ba, sigma_d, factor_a, tol):
    """(N, N, C) bool: the pairs and channels whose two best angle
    projections lie within `tol` of each other without tying exactly (an
    exact tie: all k angles equal, on the diagonal and between nodes at one
    location). Two computations of the projections differ in their last
    bits, so there they may route g to different branches; a comparison of
    two backward computations can leave those entries out. It exists for
    such comparisons only (the tests, `chip_smoke.py`): no model path
    calls it."""
    n, k = ref_vectors.shape[:2]
    c = wa.shape[0]
    near = torch.zeros((n, n, c), dtype=torch.bool, device=points.device)
    if k > 1:
        for i0, i1, _, a_idx, _, proj in _row_chunks(points, ref_vectors, div_term, wa, ba, sigma_d, factor_a):
            top2 = torch.topk(proj, 2, dim=1).values
            exact = (a_idx == a_idx[:, :1]).all(dim=1)
            near[i0:i1] = ((top2[:, 0] - top2[:, 1] < tol) & ~exact[:, None]).reshape(i1 - i0, n, c)
    return near


def geometric_embedding_bwd(points, ref_vectors, div_term, wa, ba, g, sigma_d, factor_a):
    """Weight gradients of `geometric_embedding` from the output cotangent
    g (N, N, C); arguments and results as in `geometric_embedding_bwd_plain`.
    On a CUDA tensor it runs the kernel, for any N: precise sin/cos and atan2, the
    projections and weight-gradient products on the tensor cores in TF32
    with each operand split into two TF32 terms (f32-accurate), and a
    deterministic reduction over the N^2 rows (per-chunk partial sums added
    in a fixed order)."""
    if points.device.type == "cpu":
        return geometric_embedding_bwd_plain(points, ref_vectors, div_term, wa, ba, g, sigma_d, factor_a)
    _require(points.is_cuda, f"geometric_embedding_bwd: unsupported device {points.device}")
    n, k, c = points.shape[0], ref_vectors.shape[1], wa.shape[0]
    _check_f32_cuda("geometric_embedding_bwd", points.device, points=points, ref_vectors=ref_vectors,
                    div_term=div_term, wa=wa, ba=ba, g=g)
    _require(n >= 1, "geometric_embedding_bwd: no nodes")
    _require(c % 64 == 0 and c <= 256, f"geometric_embedding_bwd: C={c} must be a multiple of 64 and <= 256")
    _require(1 <= k <= 3, f"geometric_embedding_bwd: k={k} must be 1, 2 or 3")
    _require(tuple(points.shape) == (n, 3) and tuple(ref_vectors.shape) == (n, k, 3),
             "geometric_embedding_bwd: points must be (N, 3) and ref_vectors (N, k, 3)")
    _require(tuple(wa.shape) == (c, c) and tuple(div_term.shape) == (c // 2,) and tuple(ba.shape) == (c,)
             and tuple(g.shape) == (n, n, c), "geometric_embedding_bwd: weight or cotangent shapes")
    lib = build.load_library()
    size = 2 * c * c + c
    partials = torch.empty((lib.gt_geo_embedding_bwd_chunks(), size), dtype=torch.float32, device=points.device)
    out = torch.empty((size,), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = lib.gt_geo_embedding_bwd(
        points.data_ptr(), ref_vectors.data_ptr(), div_term.data_ptr(), wa.data_ptr(), ba.data_ptr(), g.data_ptr(),
        partials.data_ptr(), out.data_ptr(), n, k, c, float(sigma_d), float(factor_a), stream,
    )
    build.check(err, "gt_geo_embedding_bwd")
    geometric_embedding_bwd.launches += 1
    db = out[2 * c * c:]
    return out[: c * c].view(c, c), db, out[c * c: 2 * c * c].view(c, c), db.clone()


geometric_embedding_bwd.launches = 0


class GeometricEmbeddingFunction(torch.autograd.Function):
    """`geometric_embedding` with the gradient of `geometric_embedding_bwd`:
    the kernels for CUDA tensors, the plain versions for CPU tensors.
    Gradients reach wd, bd, wa and ba only; the geometry (points,
    ref_vectors, div_term) is stop-gradient, as in the JAX package."""

    @staticmethod
    def forward(ctx, points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a="max"):
        ctx.save_for_backward(points, ref_vectors, div_term, wa, ba)
        ctx.constants = (sigma_d, factor_a)
        return geometric_embedding(points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a)

    @staticmethod
    def backward(ctx, g):
        points, ref_vectors, div_term, wa, ba = ctx.saved_tensors
        dwd, dbd, dwa, dba = geometric_embedding_bwd(points, ref_vectors, div_term, wa, ba, g.contiguous(),
                                                     *ctx.constants)
        return None, None, None, dwd, dbd, dwa, dba, None, None, None


def sinkhorn_log_norm_plain(scores, log_mu, log_nu, num_iterations):
    """Plain PyTorch Sinkhorn: the `lax.scan` loop of
    `ref_geotransformer_tpu/models/sinkhorn.py`.

    Args: scores (B, M1, N1), log_mu (B, M1), log_nu (B, N1).
    Returns scores + u + v after `num_iterations` row/column updates.
    """
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(num_iterations):
        u = log_mu - torch.logsumexp(scores + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(scores + u[:, :, None], dim=1)
    return scores + u[:, :, None] + v[:, None, :]


def sinkhorn_log_norm(scores, log_mu, log_nu, num_iterations):
    """Log-domain Sinkhorn normalization; arguments as in
    `sinkhorn_log_norm_plain`. On a CUDA tensor one block per patch keeps
    the patch on chip for every iteration and reduces all its rows (then
    all its columns) at once, a group of lanes each (M1, N1 <=
    SINKHORN_MAX_DIM)."""
    if scores.device.type == "cpu":
        return sinkhorn_log_norm_plain(scores, log_mu, log_nu, num_iterations)
    _require(scores.is_cuda, f"sinkhorn_log_norm: unsupported device {scores.device}")
    b, m1, n1 = scores.shape
    _check_f32_cuda("sinkhorn_log_norm", scores.device, scores=scores, log_mu=log_mu, log_nu=log_nu)
    _require(tuple(log_mu.shape) == (b, m1) and tuple(log_nu.shape) == (b, n1),
             "sinkhorn_log_norm: log_mu must be (B, M1) and log_nu (B, N1)")
    _require(0 < m1 <= SINKHORN_MAX_DIM and 0 < n1 <= SINKHORN_MAX_DIM,
             f"sinkhorn_log_norm: M1={m1}, N1={n1} beyond the kernel's limit {SINKHORN_MAX_DIM}")
    out = torch.empty_like(scores)
    if b == 0:
        return out
    lib = build.load_library()
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    err = lib.gt_sinkhorn(
        scores.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(), out.data_ptr(), b, m1, n1,
        int(num_iterations), stream,
    )
    build.check(err, "gt_sinkhorn")
    sinkhorn_log_norm.launches += 1
    return out


sinkhorn_log_norm.launches = 0
