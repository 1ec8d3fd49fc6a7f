"""The plain PyTorch versions of the program's CUDA kernels, and nothing else.

Copied from `ref_geotransformer_tpu_torch/models/cuda_kernels.py`: the
structure embedding, the Sinkhorn loop and the radius search, on any device.
"""

from __future__ import annotations

import torch

from portbench.reference import selection


def sinusoid(x: torch.Tensor, div_term: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., C): [sin(x * div_term), cos(x * div_term)], sines first."""
    omegas = x[..., None] * div_term
    return torch.cat([torch.sin(omegas), torch.cos(omegas)], dim=-1)


def embedding_indices(row_points, points, row_ref_vectors, sigma_d, factor_a):
    """Sinusoid arguments of the node pairs (i, j): d / sigma_d (R, N) and
    the k angles times factor_a (R, N, k), from the anchor vectors p_j - p_i."""
    anc = points[None, :, :] - row_points[:, None, :]
    dist = torch.sqrt(torch.sum(anc * anc, dim=-1))
    ref = row_ref_vectors[:, None, :, :]
    anc_k = anc[:, :, None, :]
    sin_v = torch.linalg.norm(torch.linalg.cross(ref, anc_k), dim=-1)
    cos_v = torch.sum(ref * anc_k, dim=-1)
    return dist / sigma_d, torch.atan2(sin_v, cos_v) * factor_a


def geometric_embedding_plain(points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a="max"):
    """(N, N, C) structure embedding with the (N, N, k, C) angle projections
    materialized, then reduced over k by `amax` (which splits the gradient
    among tied branches)."""
    if reduction_a != "max":
        raise ValueError(f"geometric_embedding_plain: angle reduction {reduction_a!r}")
    d_idx, a_idx = embedding_indices(points, points, ref_vectors, sigma_d, factor_a)
    d_emb = sinusoid(d_idx, div_term) @ wd + bd
    a_emb = sinusoid(a_idx, div_term) @ wa + ba
    return d_emb + torch.amax(a_emb, dim=2)


def sinkhorn_log_norm_plain(scores, log_mu, log_nu, num_iterations):
    """scores (B, M1, N1), log_mu (B, M1), log_nu (B, N1) -> scores + u + v
    after `num_iterations` row/column updates."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(num_iterations):
        u = log_mu - torch.logsumexp(scores + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(scores + u[:, :, None], dim=1)
    return scores + u[:, :, None] + v[:, None, :]


def radius_search_plain(q_points, s_points, q_masks, s_masks, radius, limit, chunk=2048):
    """(M, limit) int32 indices of the `limit` nearest valid supports inside
    `radius`, by masked squared distances and an exact top-k per chunk of
    queries; sentinel N in empty slots and in every slot of an invalid query."""
    n = s_points.shape[0]
    r2 = radius * radius
    out = []
    for start, d, idx in selection.chunked_min_k(q_points, s_points, s_masks, limit, chunk):
        valid = (d < r2) & q_masks[start : start + chunk, None]
        out.append(torch.where(valid, idx.to(torch.int32), n))
    return torch.cat(out, dim=0)


def radius_search_group(searches, chunk=2048):
    """Each search (q_points, s_points, q_masks, s_masks, radius, limit) in
    turn through `radius_search_plain`; their tables in order."""
    return [radius_search_plain(q, s, qm, sm, r, limit, chunk) for q, s, qm, sm, r, limit in searches]
