"""Kernel-point convolution (KPConv) and its blocks.

Counterpart of `ref_geotransformer_tpu/models/kpconv.py`. Every tensor
carries a leading batch axis (the (2, N, ...) ref/src pair): the backbone
runs both clouds at once, and the gathers fold that axis into one flat
gather (`masked_gather_batched`).

Per query: gather the neighbors' coordinates and features (sentinel slots
read zeros and get zero influence), kernel-point influence
max(0, 1 - |n - k| / sigma) in the expanded |n|^2 - 2 n.k + |k|^2 form, then
(M, K, H) x (M, H, C) -> (M, K, C) and (M, K*C) x (K*C, O), divided by the
number of neighbors whose feature sum is positive.

Two bf16 modes, as in the JAX package:
* `compute_dtype=torch.bfloat16` with f32 activations (the 3DMatch config's
  `dtype`): the features, influences and kernel weights of the two
  contractions are rounded to bf16 and the products accumulate in f32, in
  f32 arithmetic (the f32 result of the JAX package's bf16 einsums);
* bf16 activations (the backbone's `act_dtype`): the blocks take and return
  bf16 tensors. The Linear layers and, with a bf16 `compute_dtype`, both
  contractions run as bf16 products with f32 accumulation (on the card the
  tensor cores' bf16 rate); the (M, K, C) sum is rounded to bf16, as the
  JAX package casts it, and the output is divided and biased in f32, then
  rounded. Norm statistics stay f64 (models/norms.py). The f32 coordinates
  ride in the bf16 gather table bit for bit, each as two bf16 lanes (the
  JAX package's `_pack_points_feats`), so one gather still serves both and
  the coordinates are never rounded.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.kernel_points import load_kernels
from portbench.reference.norms import ChannelLayerNorm, MaskedGroupNorm
from portbench.reference.index import masked_gather, masked_gather_batched


def _round(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """An f32 tensor rounded to `dtype` and back to f32 (identity when dtype
    is None or x already has it)."""
    return x if dtype is None or x.dtype == dtype else x.to(dtype).float()


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """layer(x) in x's dtype: for a bf16 x a bf16 product (f32 accumulation)
    with the f32 weight rounded to bf16, then the bias added in bf16, as a
    flax Dense with dtype=bf16 does; the parameters stay f32."""
    if x.dtype == layer.weight.dtype:
        return layer(x)
    out = F.linear(x, layer.weight.to(x.dtype))
    return out if layer.bias is None else out + layer.bias.to(x.dtype)


def _gather_points_feats(s_points, feats, neighbor_indices, q_points):
    """ONE gather of [coords, feats] rows: relative coords (B, M, H, 3) in
    f32, features (B, M, H, C) in feats' dtype, validity (B, M, H). Narrow
    features carry the f32 coordinates as their bit patterns."""
    valid = neighbor_indices < s_points.shape[1]
    if feats.dtype == s_points.dtype:
        table, width = torch.cat([s_points, feats], dim=-1), 3
    else:
        table, width = torch.cat([s_points.contiguous().view(feats.dtype), feats], dim=-1), 6
    gathered = masked_gather_batched(table, neighbor_indices, 0.0)
    coords = gathered[..., :3] if width == 3 else gathered[..., :6].contiguous().view(s_points.dtype)
    return coords - q_points[..., None, :], gathered[..., width:], valid


class KPConv(nn.Module):
    """Rigid kernel-point convolution: (s_feats (B, N, Cin), q_points
    (B, M, 3), s_points (B, N, 3), neighbor_indices (B, M, H) with sentinel
    N) -> (B, M, Cout)."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, bias=True, compute_dtype=None):
        super().__init__()
        self.sigma = sigma
        self.compute_dtype = compute_dtype
        self.weights = nn.Parameter(torch.zeros(kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.register_buffer("kernel_points", torch.from_numpy(load_kernels(radius, kernel_size)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # kaiming_uniform_(a=sqrt(5)) with fan_in = K * Cin, like the JAX init
        fan_in = self.weights.shape[0] * self.weights.shape[1]
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
        with torch.no_grad():
            self.weights.copy_((torch.rand(self.weights.shape, generator=generator) * 2 - 1) * bound)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, s_feats, q_points, s_points, neighbor_indices):
        neighbors, feats, valid = _gather_points_feats(
            s_points, _round(s_feats, self.compute_dtype), neighbor_indices, q_points
        )
        return self.aggregate(neighbors, feats, valid)

    def aggregate(self, neighbors, neighbor_feats, valid):
        """KPConv math on gathered neighborhoods: relative coords
        (..., M, H, 3), features (..., M, H, C), validity (..., M, H).
        The output has the features' dtype."""
        kp = self.kernel_points
        n_sq = torch.sum(neighbors * neighbors, dim=-1)
        k_sq = torch.sum(kp * kp, dim=-1)
        nk = torch.matmul(neighbors, kp.T)  # (..., M, H, K)
        sq = torch.clamp(n_sq[..., None] - 2.0 * nk + k_sq, min=0.0)
        nw = torch.clamp(1.0 - torch.sqrt(sq) / self.sigma, min=0.0)
        nw = torch.where(valid[..., None], nw, 0.0)

        cd = self.compute_dtype
        k, c, o = self.weights.shape
        if cd is not None and neighbor_feats.dtype == cd:
            # narrow activations: bf16 products, f32 accumulation; the
            # (M, K, C) sum comes out rounded to bf16
            weighted = torch.matmul(nw.to(cd).transpose(-1, -2), neighbor_feats)
            out = torch.matmul(weighted.reshape(weighted.shape[:-2] + (k * c,)),
                               self.weights.to(cd).reshape(k * c, o)).float()
        else:
            feats = _round(neighbor_feats.float(), cd)
            weighted = torch.matmul(_round(nw, cd).transpose(-1, -2), feats)  # (..., M, K, C)
            out = torch.matmul(_round(weighted, cd).reshape(weighted.shape[:-2] + (k * c,)),
                               _round(self.weights, cd).reshape(k * c, o))

        neighbor_num = torch.sum((torch.sum(neighbor_feats.float(), dim=-1) > 0.0).float(), dim=-1)
        out = out / torch.clamp(neighbor_num, min=1.0)[..., None]
        if self.bias is not None:
            out = out + self.bias
        return out.to(neighbor_feats.dtype)


def nearest_upsample(x: torch.Tensor, upsample_indices: torch.Tensor) -> torch.Tensor:
    """Feature of each query's nearest support (column 0 of the
    distance-sorted table): x (B, N, C), indices (B, M, H) -> (B, M, C)."""
    return masked_gather_batched(x, upsample_indices[..., 0], 0.0)


def knn_interpolate(s_feats: torch.Tensor, q_points: torch.Tensor, s_points: torch.Tensor,
                    neighbor_indices: torch.Tensor, k: int, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-squared-distance weighted mean of each query's first k
    neighbors' features (functional.py:25-51): s_feats (N, C), q_points
    (M, 3), s_points (N, 3), neighbor_indices (M, H) with sentinel N ->
    (M, C)."""
    n = s_points.shape[0]
    knn_indices = neighbor_indices[:, :k]
    knn_points = masked_gather(s_points, knn_indices, 0.0)
    knn_feats = masked_gather(s_feats, knn_indices, 0.0)
    knn_sq = torch.sum((q_points[:, None, :] - knn_points) ** 2, dim=-1)
    knn_weights = (knn_indices < n).to(s_feats.dtype) / (knn_sq + eps)
    knn_weights = knn_weights / (torch.sum(knn_weights, dim=1, keepdim=True) + eps)
    return torch.sum(knn_feats * knn_weights[:, :, None], dim=1)


def global_avgpool(x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Mean of the valid rows of one cloud (functional.py:70-90): x (N, C),
    masks (N,) -> (C,)."""
    w = masks.to(x.dtype)[:, None]
    return torch.sum(x * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)


def _norm(group_norm: int, channels: int, layer_norm: bool) -> nn.Module:
    return ChannelLayerNorm(channels) if layer_norm else MaskedGroupNorm(group_norm, channels)


class UnaryBlock(nn.Module):
    """Linear -> MaskedGroupNorm (or LayerNorm) -> LeakyReLU(0.1)."""

    def __init__(self, in_channels, out_channels, group_norm, has_relu=True, bias=True, layer_norm=False):
        super().__init__()
        self.mlp = nn.Linear(in_channels, out_channels, bias=bias)
        self.norm = _norm(group_norm, out_channels, layer_norm)
        self.has_relu = has_relu

    def forward(self, x, masks=None):
        x = self.norm(linear(self.mlp, x), masks)
        return F.leaky_relu(x, 0.1) if self.has_relu else x


class LastUnaryBlock(nn.Module):
    """Plain linear head."""

    def __init__(self, in_channels, out_channels, bias=True):
        super().__init__()
        self.mlp = nn.Linear(in_channels, out_channels, bias=bias)

    def forward(self, x):
        return linear(self.mlp, x)


class ConvBlock(nn.Module):
    """KPConv -> MaskedGroupNorm (or LayerNorm) -> LeakyReLU."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, group_norm, compute_dtype=None,
                 layer_norm=False):
        super().__init__()
        self.KPConv = KPConv(in_channels, out_channels, kernel_size, radius, sigma, compute_dtype=compute_dtype)
        self.norm = _norm(group_norm, out_channels, layer_norm)

    def forward(self, s_feats, q_points, s_points, neighbor_indices, q_masks=None):
        x = self.KPConv(s_feats, q_points, s_points, neighbor_indices)
        return F.leaky_relu(self.norm(x, q_masks), 0.1)


class ResidualBlock(nn.Module):
    """Bottleneck around KPConv; the strided variant's shortcut is a maxpool
    over the subsampling table, sharing the conv's gather."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, group_norm, strided=False,
                 compute_dtype=None, layer_norm=False):
        super().__init__()
        mid = out_channels // 4
        self.strided = strided
        self.compute_dtype = compute_dtype
        unary = dict(group_norm=group_norm, layer_norm=layer_norm)
        self.unary1 = UnaryBlock(in_channels, mid, **unary) if in_channels != mid else None
        self.KPConv = KPConv(mid, mid, kernel_size, radius, sigma, compute_dtype=compute_dtype)
        self.norm_conv = _norm(group_norm, mid, layer_norm)
        self.unary2 = UnaryBlock(mid, out_channels, has_relu=False, **unary)
        self.unary_shortcut = (
            UnaryBlock(in_channels, out_channels, has_relu=False, **unary) if in_channels != out_channels else None
        )

    def forward(self, s_feats, q_points, s_points, neighbor_indices, q_masks=None, s_masks=None):
        if s_masks is None:
            s_masks = q_masks
        x = self.unary1(s_feats, s_masks) if self.unary1 is not None else s_feats
        if self.strided:
            cd = self.compute_dtype
            mid = x.shape[-1]
            neighbors, gathered, valid = _gather_points_feats(
                s_points, torch.cat([_round(x, cd), _round(s_feats, cd)], dim=-1), neighbor_indices, q_points
            )
            x = self.KPConv.aggregate(neighbors, gathered[..., :mid], valid)
            shortcut = gathered[..., mid:].max(dim=-2).values
        else:
            x = self.KPConv(x, q_points, s_points, neighbor_indices)
            shortcut = s_feats
        x = F.leaky_relu(self.norm_conv(x, q_masks), 0.1)
        x = self.unary2(x, q_masks)
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, q_masks)
        return F.leaky_relu(x + shortcut, 0.1)
