"""Positional and geometric structure embeddings.

Counterpart of `ref_geotransformer_tpu/models/embedding.py`.
`GeometricStructureEmbedding`: a sinusoidal embedding of the pair distance
and of the k triplet angles, each projected by a Linear (`proj_d`,
`proj_a`), the angle projections reduced over k (max or mean), and the two
summed into (B, N, N, C).

The upstream sinusoid layout interleaves [sin0, cos0, sin1, ...]; the
computation here (plain version and kernel alike) emits [sin..., cos...], so
the projection rows are permuted to match: emb_concat @ W[perm] ==
emb_interleaved @ W.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from portbench.reference import plain_kernels
from portbench.reference.pairwise import pairwise_distance


class LearnablePositionalEmbedding(nn.Module):
    """A table of `num_embeddings` learned vectors, then LayerNorm (eps 1e-6,
    flax's); indices above the table are clamped to its last row."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embeddings = nn.Embedding(num_embeddings, embedding_dim)
        self.norm = nn.LayerNorm(embedding_dim, eps=1e-6)

    def forward(self, emb_indices: torch.Tensor) -> torch.Tensor:
        return self.norm(self.embeddings(torch.clamp(emb_indices.long(), max=self.num_embeddings - 1)))


# the mean reduction's sinusoids are made in row chunks of at most this many
# (R, N, k, C) f32 entries (512 MiB)
_MEAN_CHUNK_ENTRIES = 1 << 27


class GeometricStructureEmbedding(nn.Module):
    """(B, N, 3) node clouds with (B, N) validity masks -> (B, N, N, C).

    The plain forward always runs (`use_kernel` is kept for the signature)
    and autograd differentiates it; gradients reach `proj_d` and `proj_a`
    through the permuted-row gather of their weights; the geometry is stop-gradient, as in the JAX package.

    `reduction_a="mean"` has no kernel, as in the JAX package, whose Pallas
    kernel is max-only: the module computes it in torch ops
    (`_mean_embedding`), on every device.
    """

    def __init__(self, hidden_dim, sigma_d, sigma_a, angle_k, reduction_a="max", use_kernel=True):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.sigma_d = sigma_d
        self.factor_a = 180.0 / (sigma_a * math.pi)
        self.angle_k = angle_k
        self.reduction_a = reduction_a
        self.use_kernel = use_kernel
        self.proj_d = nn.Linear(hidden_dim, hidden_dim)
        self.proj_a = nn.Linear(hidden_dim, hidden_dim)

    def knn_ref_vectors(self, points: torch.Tensor, masks: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, N, k, 3) vectors from each node to its k nearest valid nodes
        (the k+1 nearest, column 0 dropped)."""
        dist = torch.sqrt(pairwise_distance(points, points))
        if masks is not None:
            dist = torch.where(masks[:, None, :], dist, 1e12)
        knn_indices = torch.topk(dist, self.angle_k + 1, dim=-1, largest=False, sorted=True).indices[:, :, 1:]
        knn_points = torch.gather(
            points[:, None, :, :].expand(-1, points.shape[1], -1, -1), 2,
            knn_indices[..., None].expand(-1, -1, -1, 3),
        )
        return knn_points - points[:, :, None, :]

    def kernel_args(self, points: torch.Tensor, masks: Optional[torch.Tensor] = None):
        """Per cloud b of the batch, the arguments of
        `plain_kernels.geometric_embedding`: (points, ref_vectors, div_term,
        wd, bd, wa, ba, sigma_d, factor_a, reduction_a)."""
        c = self.hidden_dim
        half = c // 2
        dev = points.device
        points = points.detach()
        div_term = torch.exp(torch.arange(0, c, 2, dtype=torch.float32, device=dev) * (-math.log(10000.0) / c))
        perm = torch.cat([2 * torch.arange(half, device=dev), 2 * torch.arange(half, device=dev) + 1])
        # Linear stores (out, in); the kernel takes (in, out) with permuted rows
        wd = self.proj_d.weight.T[perm].contiguous()
        wa = self.proj_a.weight.T[perm].contiguous()
        ref_vectors = self.knn_ref_vectors(points, masks)
        return [
            (points[b].contiguous(), ref_vectors[b].contiguous(), div_term, wd, self.proj_d.bias, wa,
             self.proj_a.bias, self.sigma_d, self.factor_a, self.reduction_a)
            for b in range(points.shape[0])
        ]

    def _mean_embedding(self, points, ref_vectors, div_term, wd, bd, wa, ba, sigma_d, factor_a, reduction_a):
        """(N, N, C) with the angle projections averaged over k, from the
        arguments of `kernel_args`. The projection is affine, so the mean of
        the k projections is the projection of the mean sinusoid: the angle
        sinusoids are averaged first (no gradient reaches them), in row
        chunks, and projected once, so no (N, N, k, C) tensor is held."""
        n, k, c = points.shape[0], ref_vectors.shape[1], wd.shape[0]
        rows = max(1, _MEAN_CHUNK_ENTRIES // (n * k * c))
        d_parts, a_parts = [], []
        with torch.no_grad():
            for start in range(0, n, rows):
                d_idx, a_idx = plain_kernels.embedding_indices(points[start:start + rows], points,
                                                              ref_vectors[start:start + rows], sigma_d, factor_a)
                d_parts.append(plain_kernels.sinusoid(d_idx, div_term))
                a_parts.append(plain_kernels.sinusoid(a_idx, div_term).mean(dim=2))
        return (torch.cat(d_parts) @ wd + bd) + (torch.cat(a_parts) @ wa + ba)

    def forward(self, points: torch.Tensor, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.reduction_a not in ("max", "mean"):
            raise ValueError(f"Unsupported reduction mode: {self.reduction_a}.")
        fn = plain_kernels.geometric_embedding_plain
        if self.reduction_a == "mean":
            fn = self._mean_embedding
        outs = [fn(*args) for args in self.kernel_args(points, masks)]
        return outs[0][None] if len(outs) == 1 else torch.stack(outs, dim=0)
