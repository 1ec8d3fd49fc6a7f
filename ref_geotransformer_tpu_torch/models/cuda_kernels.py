"""The CUDA kernels of the port, each beside its plain PyTorch version.

Counterpart of `ref_geotransformer_tpu/models/pallas_kernels.py`:

* `geometric_embedding` (kernel `csrc/geo_embedding.cu`) replaces
  `geometric_embedding_pallas`;
* `geometric_embedding_bwd` (kernel `csrc/geo_embedding_bwd.cu`) replaces
  `_geo_embedding_bwd`; `GeometricEmbeddingFunction` joins the two, as
  `make_geometric_embedding_vjp` does;
* `sinkhorn_log_norm` (kernel `csrc/sinkhorn.cu`) replaces
  `sinkhorn_log_norm_pallas`;
* `radius_search_group` (kernel `csrc/radius_search.cu`, a group of
  searches in one launch; `radius_search` is a group of one) replaces the
  XLA selection `lax.approx_min_k` of `ref_geotransformer_tpu/ops/
  neighbors.py::radius_search_brute`, the pyramid's neighbor search.

Dispatch is by device and nothing else: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel, or raises if the kernel cannot
take it. Each wrapper counts its kernel launches in `.launches`, a plain
integer, incremented only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ref_geotransformer_tpu_torch.ops import selection
from ref_geotransformer_tpu_torch.utils import build

SINKHORN_MAX_DIM = 144  # largest M1 and N1 the Sinkhorn kernel takes
RADIUS_SEARCH_MAX_LIMIT = 128  # longest neighbor row the radius-search kernel takes
EMBEDDING_TILE = 64  # node pairs a block of the embedding kernel owns: row i, 64 columns


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


def _check_node_masks(name, points, masks):
    if masks is not None:
        _require(tuple(masks.shape) == (points.shape[0],) and masks.dtype == torch.bool,
                 f"{name}: masks must be ({points.shape[0]},) bool, got {tuple(masks.shape)} {masks.dtype}")
        _require(masks.device == points.device, f"{name}: masks on {masks.device}, expected {points.device}")


def geometric_embedding_plain(points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a="max",
                              masks=None):
    """Plain PyTorch structure embedding: the XLA path of
    `ref_geotransformer_tpu/models/embedding.py`, with the (N, N, k, C)
    angle projections materialized, then reduced over k. Differentiable in
    the weights: `amax` splits the gradient equally among tied branches,
    as `jnp.max` does (`max(dim).values` would route it to one).

    Args: points (N, 3); ref_vectors (N, k, 3) vectors to each node's k
    nearest nodes; div_term (C/2,); wd, wa (C, C) with rows in
    [sin..., cos...] order; bd, ba (C,); masks (N,) bool, the nodes' validity,
    or None. Returns (N, N, C) float32 with every entry computed, those of a
    padded node too, as the JAX package does; the kernel
    (`geometric_embedding`) leaves those 0, and no caller reads them.
    """
    _require(reduction_a == "max", f"geometric_embedding: angle reduction {reduction_a!r}: the kernel takes max only "
             "(the mean is models/embedding.py's own computation)")
    _check_node_masks("geometric_embedding", points, masks)
    d_idx, a_idx = embedding_indices(points, points, ref_vectors, sigma_d, factor_a)
    d_emb = sinusoid(d_idx, div_term) @ wd + bd
    a_emb = sinusoid(a_idx, div_term) @ wa + ba  # (N, N, k, C)
    return d_emb + torch.amax(a_emb, dim=2)


def geometric_embedding(points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a="max",
                        masks=None):
    """(N, N, C) geometric structure embedding of one cloud's nodes; the
    arguments are those of `geometric_embedding_plain`. On a CUDA tensor it
    runs the fused kernel, for any N: precise sin/cos and atan2, products on the tensor
    cores in TF32 with each operand split into two TF32 terms (f32-accurate).

    With `masks`, the kernel computes the pairs of two valid nodes only and
    writes 0 at every entry with a padded node: no caller reads those (the
    attention masks padded keys; padded queries reach no valid row; matching
    and the losses take node masks), and 0 keeps them finite. Its valid
    entries equal those of a launch without masks bit for bit. The skip is
    decided on the device: nothing is read back. Each computing block adds 1
    to `geometric_embedding.computed_blocks`, an int64 on the launch's device
    (made at the first launch on it); `geometric_embedding.launched_blocks`
    counts the blocks launched on the host. Their ratio is the share of the
    grid that computed."""
    if points.device.type == "cpu":
        return geometric_embedding_plain(points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a,
                                         masks)
    _require(points.is_cuda, f"geometric_embedding: unsupported device {points.device}")
    n, k, c = points.shape[0], ref_vectors.shape[1], wd.shape[0]
    _check_f32_cuda("geometric_embedding", points.device, points=points, ref_vectors=ref_vectors,
                    div_term=div_term, wd=wd, bd=bd, wa=wa, ba=ba)
    _check_node_masks("geometric_embedding", points, masks)
    _require(masks is None or masks.is_contiguous(), "geometric_embedding: masks is not contiguous")
    _require(reduction_a == "max", f"geometric_embedding: angle reduction {reduction_a!r}: the kernel takes max only "
             "(the mean is models/embedding.py's own computation)")
    _require(n >= 1, "geometric_embedding: no nodes")
    _require(c % 32 == 0 and c <= 256, f"geometric_embedding: C={c} must be a multiple of 32 and <= 256")
    _require(tuple(points.shape) == (n, 3) and tuple(ref_vectors.shape) == (n, k, 3),
             "geometric_embedding: points must be (N, 3) and ref_vectors (N, k, 3)")
    _require(tuple(wd.shape) == (c, c) and tuple(wa.shape) == (c, c) and tuple(div_term.shape) == (c // 2,)
             and tuple(bd.shape) == (c,) and tuple(ba.shape) == (c,), "geometric_embedding: weight shapes")
    counter = geometric_embedding.computed_blocks
    if counter is None or counter.device != points.device:
        counter = geometric_embedding.computed_blocks = torch.zeros((), dtype=torch.int64, device=points.device)
    out = torch.empty((n, n, c), dtype=torch.float32, device=points.device)
    lib = build.load_library()
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = lib.gt_geo_embedding(
        points.data_ptr(), ref_vectors.data_ptr(), div_term.data_ptr(), wd.data_ptr(), bd.data_ptr(),
        wa.data_ptr(), ba.data_ptr(), None if masks is None else masks.data_ptr(), out.data_ptr(),
        counter.data_ptr(), n, k, c, float(sigma_d), float(factor_a), stream,
    )
    build.check(err, "gt_geo_embedding")
    geometric_embedding.launches += 1
    geometric_embedding.launched_blocks += -(-n // EMBEDDING_TILE) * n
    return out


geometric_embedding.launches = 0
geometric_embedding.launched_blocks = 0  # blocks launched, over every launch
geometric_embedding.computed_blocks = None  # (device int64) blocks that computed, over every launch on its device

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
    ref_vectors, div_term) is stop-gradient, as in the JAX package.

    The forward takes the node masks (`geometric_embedding`: 0 at entries
    with a padded node) and the backward ignores them: it routes the
    cotangent of every entry, so it is the masked forward's gradient where
    the cotangent is 0 at the entries with a padded node, as it is in the
    model (nothing reads them)."""

    @staticmethod
    def forward(ctx, points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a="max", masks=None):
        ctx.save_for_backward(points, ref_vectors, div_term, wa, ba)
        ctx.constants = (sigma_d, factor_a)
        return geometric_embedding(points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a,
                                   masks)

    @staticmethod
    def backward(ctx, g):
        points, ref_vectors, div_term, wa, ba = ctx.saved_tensors
        dwd, dbd, dwa, dba = geometric_embedding_bwd(points, ref_vectors, div_term, wa, ba, g.contiguous(),
                                                     *ctx.constants)
        return None, None, None, dwd, dbd, dwa, dba, None, None, None, None


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


def radius_search_plain(q_points, s_points, q_masks, s_masks, radius, limit, chunk=2048):
    """Plain PyTorch radius search: for each chunk of `chunk` queries, the
    masked squared distances to every support (`pairwise_distance`'s
    |q|^2 - 2 q.s + |s|^2, clamped at 0), the `limit` nearest by an exact
    top-k, kept if inside `radius`. Rows are distance-sorted; torch.topk
    promises no order among equal distances.

    Args: q_points (M, 3) and q_masks (M,) bool, the queries; s_points
    (N, 3) and s_masks (N,) bool, the supports; 1 <= limit <= N.
    Returns (M, limit) int32 indices into s_points, sentinel N in empty
    slots and in every slot of an invalid query.
    """
    n = s_points.shape[0]
    r2 = radius * radius
    out = []
    for start, d, idx in selection.chunked_min_k(q_points, s_points, s_masks, limit, chunk):
        valid = (d < r2) & q_masks[start : start + chunk, None]
        out.append(torch.where(valid, idx.to(torch.int32), n))
    return torch.cat(out, dim=0)


class _GtCloud(ctypes.Structure):
    _fields_ = [("points", ctypes.c_void_p), ("masks", ctypes.c_void_p), ("n", ctypes.c_int),
                ("tile_offset", ctypes.c_int)]


class _GtSearch(ctypes.Structure):
    _fields_ = [("out", ctypes.c_void_p), ("query_cloud", ctypes.c_int), ("support_cloud", ctypes.c_int),
                ("limit", ctypes.c_int), ("r2", ctypes.c_float)]


def radius_search_info(limit: int) -> dict:
    """The radius-search build's facts on the current card at `limit`: its
    tile, queries a block and caps; the search kernel's registers, local
    (stack and spill) bytes, static and dynamic shared bytes and resident
    blocks an SM; the pack kernel's registers and local bytes."""
    out = (ctypes.c_int * 13)()
    build.check(build.load_library().gt_radius_search_info(int(limit), out), "gt_radius_search_info")
    keys = ("tile", "queries", "max_slices", "max_searches", "max_clouds", "max_limit", "registers", "local_bytes",
            "static_shared", "dynamic_shared", "blocks_per_sm", "pack_registers", "pack_local_bytes")
    return dict(zip(keys, out))


@functools.lru_cache(maxsize=None)
def _radius_caps() -> dict:
    """The radius-search build's fixed sizes (the packing layout's tile,
    the caps of a group), read once from the library."""
    return radius_search_info(1)


def _check_cloud(name, key, points, masks, device):
    n = points.shape[0]
    _require(tuple(points.shape) == (n, 3) and tuple(masks.shape) == (n,),
             f"{name}: {key} points must be (N, 3) and masks (N,)")
    for what, t, dtype in (("points", points, torch.float32), ("masks", masks, torch.bool)):
        _require(t.device == device, f"{name}: {key} {what} on {t.device}, expected {device}")
        _require(t.dtype == dtype, f"{name}: {key} {what} is {t.dtype}, expected {dtype}")
        _require(t.is_contiguous(), f"{name}: {key} {what} is not contiguous")


def radius_search_group(searches, chunk=2048):
    """A list of radius searches, each (q_points, s_points, q_masks,
    s_masks, radius, limit) as in `radius_search_plain`, in one call;
    returns their tables in order. On CPU tensors it runs
    `radius_search_plain` on each (`chunk` bounds its distance blocks). On
    CUDA tensors it makes two launches for the whole group (at most 48
    searches over at most 64 distinct clouds: `radius_search_info`): one
    packs each distinct cloud (points and masks) once, one runs every
    search, 1 <= limit <= RADIUS_SEARCH_MAX_LIMIT, each row in (d^2, index)
    order with ties to the lower index, so two launches give the same bits.
    The kernel cuts a search's supports into 1, 2, 4 or 8 slices, as many as
    the group's work asks for, merged inside a thread-block cluster;
    `radius_search_group.slices` holds the last group's count per search.
    The tables are views of one buffer."""
    searches = list(searches)
    for q, s, _, _, _, limit in searches:
        _require(1 <= limit <= s.shape[0], f"radius_search_group: limit {limit} outside 1..N = {s.shape[0]}")
    if not searches:
        return []
    device = searches[0][0].device
    if device.type == "cpu":
        return [radius_search_plain(q, s, qm, sm, radius, limit, chunk) for q, s, qm, sm, radius, limit in searches]
    _require(device.type == "cuda", f"radius_search_group: unsupported device {device}")
    caps = _radius_caps()
    tile = caps["tile"]
    _require(len(searches) <= caps["max_searches"],
             f"radius_search_group: {len(searches)} searches beyond the kernel's {caps['max_searches']}")
    clouds, index, descs, sizes = [], {}, [], []
    tiles = 0
    for q, s, qm, sm, radius, limit in searches:
        _require(limit <= RADIUS_SEARCH_MAX_LIMIT,
                 f"radius_search_group: limit {limit} beyond the kernel's {RADIUS_SEARCH_MAX_LIMIT}")
        _require(q.shape[0] >= 1, "radius_search_group: no queries")
        ends = []
        for key, points, masks in (("query", q, qm), ("support", s, sm)):
            cloud = (points.data_ptr(), masks.data_ptr(), points.shape[0])
            if cloud not in index:
                _check_cloud("radius_search_group", key, points, masks, device)
                index[cloud] = len(clouds)
                clouds.append(cloud + (tiles,))
                tiles += -(-points.shape[0] // tile)
            ends.append(index[cloud])
        descs.append((ends[0], ends[1], int(limit), float(radius) * float(radius)))
        sizes.append((q.shape[0], limit))
    _require(len(clouds) <= caps["max_clouds"],
             f"radius_search_group: {len(clouds)} clouds beyond the kernel's {caps['max_clouds']}")
    lib = build.load_library()
    packed = torch.empty((tiles * tile, 4), dtype=torch.float32, device=device)
    tile_max = torch.empty(tiles, dtype=torch.float32, device=device)
    flat = torch.empty(sum(m * limit for m, limit in sizes), dtype=torch.int32, device=device)
    tables, at = [], 0
    for m, limit in sizes:
        tables.append(flat[at : at + m * limit].view(m, limit))
        at += m * limit
    c_clouds = (_GtCloud * len(clouds))(*clouds)
    c_searches = (_GtSearch * len(descs))(*((t.data_ptr(),) + d for t, d in zip(tables, descs)))
    used = (ctypes.c_int * len(descs))()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.gt_radius_search_group(c_clouds, len(clouds), c_searches, len(descs), packed.data_ptr(),
                                     tile_max.data_ptr(), used, stream)
    build.check(err, "gt_radius_search_group")
    radius_search_group.launches += 1
    radius_search_group.searches += len(descs)
    radius_search_group.slices = list(used)
    return tables


radius_search_group.launches = 0  # search launches (each after one packing launch)
radius_search_group.searches = 0  # searches over those launches
radius_search_group.slices = []  # the last group's slices per search, as the kernel chose them


def radius_search(q_points, s_points, q_masks, s_masks, radius, limit, chunk=2048):
    """The `limit` nearest valid supports of each valid query inside
    `radius`; arguments and result as in `radius_search_plain` (`chunk`
    bounds the plain version's distance blocks only). A group of one
    (`radius_search_group`): on a CUDA tensor the kernel, distances fused
    with a bounded top-k per query, no distance matrix in device memory,
    each row in (d^2, index) order, ties to the lower index, so two launches
    give the same bits."""
    return radius_search_group([(q_points, s_points, q_masks, s_masks, radius, limit)], chunk)[0]
