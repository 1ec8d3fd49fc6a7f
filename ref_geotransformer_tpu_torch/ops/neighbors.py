"""Fixed-width radius and kNN neighbor search.

Counterpart of `ref_geotransformer_tpu/ops/neighbors.py`. `radius_search`:
for its methods "approx" (the JAX default, approximate selection on a TPU)
and "brute", the `limit` nearest valid supports inside `radius`, exactly,
through `cuda_kernels.radius_search` (the kernel `csrc/radius_search.cu` on
a CUDA tensor, masked distances and a chunked exact top-k on a CPU tensor);
`radius_search_group` runs several such searches in one call (a pyramid's);
its "bucket" method gathers candidates from a grid of radius-sized cells
(`radius_search_bucketed`). Rows come out distance-sorted (nearest first),
with sentinel index N in empty slots. `knn_search` keeps the k nearest
valid supports whatever their distance. `topk_neighbor_distances` is the
counterpart of `_chunked_topk_neighbors`: the squared distances themselves,
which neighbor-limit calibration counts against r^2.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ref_geotransformer_tpu_torch.models import cuda_kernels
from ref_geotransformer_tpu_torch.ops import selection
from ref_geotransformer_tpu_torch.utils.timer import span


def topk_neighbor_distances(
    q_points: torch.Tensor, s_points: torch.Tensor, s_masks: torch.Tensor, k: int, chunk: int = 1024
) -> torch.Tensor:
    """(M, k) squared distances from each query to its k nearest valid
    supports, ascending; 1e12 where fewer than k supports are valid."""
    return torch.cat([d for _, d, _ in selection.chunked_min_k(q_points, s_points, s_masks, k, chunk)], dim=0)


def radius_search_bucketed(
    q_points: torch.Tensor,
    s_points: torch.Tensor,
    q_masks: torch.Tensor,
    s_masks: torch.Tensor,
    radius: float,
    limit: int,
    chunk: int = 2048,
    cell_capacity: Optional[int] = None,
) -> torch.Tensor:
    """Radius neighbors through a grid of cells of edge `radius`: supports
    sorted by cell key; each query's candidates are the first
    `cell_capacity` supports (default max(32, 2 * limit)) of each of its 27
    neighboring cells, found by a sorted search; then distances and an
    exact top-k over those candidates only. A cell holding more supports
    offers only its first `cell_capacity` (in key order), as in the JAX
    package. Same output as `radius_search`."""
    n, m = s_points.shape[0], q_points.shape[0]
    dev = s_points.device
    cap = cell_capacity or max(32, 2 * limit)
    inf = torch.tensor(float("inf"), dtype=s_points.dtype, device=dev)
    min_corner = torch.where(s_masks[:, None], s_points, inf).amin(dim=0)
    max_corner = torch.where(s_masks[:, None], s_points, -inf).amax(dim=0)
    dims = (torch.clamp(max_corner - min_corner, min=0.0) / radius).to(torch.int32) + 1  # (nx, ny, nz)

    def cell_coords(pts):
        return torch.floor((pts - min_corner) / radius).to(torch.int32)

    def fuse(cells, valid, sentinel):
        # invalid supports sort last (int32 max); out-of-grid query cells get
        # -1, which matches no support key
        key = cells[..., 0] + dims[0] * (cells[..., 1] + dims[1] * cells[..., 2])
        return torch.where(valid, key, sentinel)

    s_keys = fuse(cell_coords(s_points), s_masks, 2**31 - 1)
    order = torch.argsort(s_keys, stable=True)
    keys_sorted = s_keys[order].contiguous()
    s_sorted = s_points[order]
    steps = torch.tensor([-1, 0, 1], dtype=torch.int32, device=dev)
    offsets = torch.cartesian_prod(steps, steps, steps)  # (27, 3), dz fastest as in the JAX package
    slots = torch.arange(cap, device=dev)

    out = []
    for start in range(0, m, chunk):
        q = q_points[start:start + chunk]
        cells = cell_coords(q)[:, None, :] + offsets  # (chunk, 27, 3)
        in_grid = ((cells >= 0) & (cells < dims)).all(dim=-1)
        nkeys = fuse(cells, in_grid, -1).reshape(-1)  # (chunk * 27,)
        starts = torch.searchsorted(keys_sorted, nkeys, side="left")
        cand = torch.clamp(starts[:, None] + slots, max=n - 1)  # (chunk * 27, cap)
        cand_ok = (keys_sorted[cand] == nkeys[:, None]).reshape(q.shape[0], -1)
        cand = cand.reshape(q.shape[0], -1)
        sq = torch.sum((q[:, None, :] - s_sorted[cand]) ** 2, dim=-1)
        top_sq, pos = selection.min_k(torch.where(cand_ok, sq, selection.FILL), limit)
        idx = order[torch.gather(cand, 1, pos)].to(torch.int32)
        out.append(torch.where(top_sq < radius * radius, idx, n))
    return torch.where(q_masks[:, None], torch.cat(out, dim=0), n)


def radius_search(
    q_points: torch.Tensor,
    s_points: torch.Tensor,
    q_masks: torch.Tensor,
    s_masks: torch.Tensor,
    radius: float,
    limit: int,
    chunk: int = 2048,
    method: str = "approx",
) -> torch.Tensor:
    """(M, limit) int32 neighbor indices into s_points, distance-sorted,
    sentinel == N for empty slots and for every slot of an invalid query.

    Args:
        q_points: (M, 3) padded queries; q_masks (M,) validity.
        s_points: (N, 3) padded supports; s_masks (N,) validity.
        radius: search radius.
        limit: static number of neighbor slots.
        chunk: query rows per step of the plain version and of "bucket"
            (bounds their (chunk, N) distance block); the kernel keeps no
            such block and does not read it.
        method: "approx" or "brute" (both exact here), or "bucket"
            (`radius_search_bucketed`).
    """
    if method == "bucket":
        return radius_search_bucketed(q_points, s_points, q_masks, s_masks, radius, limit, chunk)
    if method not in ("approx", "brute"):
        raise ValueError(f"unknown radius_search method {method!r}")
    return cuda_kernels.radius_search(q_points, s_points, q_masks, s_masks, radius, limit, chunk)


def radius_search_group(searches: Sequence[Tuple], chunk: int = 2048) -> List[torch.Tensor]:
    """Several searches of `radius_search` (methods "approx" / "brute"), each
    (q_points, s_points, q_masks, s_masks, radius, limit), in one call; their
    tables in order. Through `cuda_kernels.radius_search_group`: on a CUDA
    device two launches for the whole group (a pyramid's, or a pair's), on
    the CPU the plain version per search. In the span `gt.pyramid.search`."""
    with span("gt.pyramid.search"):
        return cuda_kernels.radius_search_group(searches, chunk)


def knn_search(
    q_points: torch.Tensor,
    s_points: torch.Tensor,
    q_masks: torch.Tensor,
    s_masks: torch.Tensor,
    k: int,
    chunk: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest valid supports of each query: (M, k) int32 indices,
    sentinel N where fewer than k supports are valid or the query is
    invalid, and (M, k) squared distances (1e12 where no valid support)."""
    n = s_points.shape[0]
    dists, indices = [], []
    for start, d, idx in selection.chunked_min_k(q_points, s_points, s_masks, k, chunk):
        valid = (d < selection.FILL) & q_masks[start : start + chunk, None]
        dists.append(d)
        indices.append(torch.where(valid, idx.to(torch.int32), n))
    return torch.cat(indices, dim=0), torch.cat(dists, dim=0)
