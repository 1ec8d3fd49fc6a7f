"""Geometric structure embedding over superpoints.

Counterpart of `ref_geotransformer_tpu/models/embedding.py::GeometricStructureEmbedding`:
a sinusoidal embedding of the pair distance and of the k triplet angles,
each projected by a Linear (`proj_d`, `proj_a`), the angle projections
reduced over k, and the two summed into (B, N, N, C).

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

from ref_geotransformer_tpu_torch.models import cuda_kernels
from ref_geotransformer_tpu_torch.ops.pairwise import pairwise_distance


class GeometricStructureEmbedding(nn.Module):
    """(B, N, 3) node clouds with (B, N) validity masks -> (B, N, N, C).

    `use_kernel=True` routes through `cuda_kernels.GeometricEmbeddingFunction`
    (the CUDA kernels, forward and backward, for CUDA tensors; their plain
    versions for CPU tensors); `use_kernel=False` always runs the plain
    forward and lets autograd differentiate it. Either way gradients reach
    `proj_d` and `proj_a` through the permuted-row gather of their weights;
    the geometry is stop-gradient, as in the JAX package.
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
        `cuda_kernels.geometric_embedding`: (points, ref_vectors, div_term,
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

    def forward(self, points: torch.Tensor, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        fn = cuda_kernels.geometric_embedding_plain
        if self.use_kernel:
            fn = cuda_kernels.GeometricEmbeddingFunction.apply
        outs = [fn(*args) for args in self.kernel_args(points, masks)]
        return outs[0][None] if len(outs) == 1 else torch.stack(outs, dim=0)
