"""Mask-aware group normalization over whole clouds.

Counterpart of `ref_geotransformer_tpu/models/norms.py::MaskedGroupNorm`.
The upstream GroupNorm normalizes the stacked ref+src cloud as one tensor,
so its moments are joint over both clouds; the JAX package gets the same by
summing the moments across its `pair_norm` vmap axis. Here the pair is a
leading axis of the input and the moments are summed over it directly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class _GroupNormFunction(torch.autograd.Function):
    """(x - mean) * rsqrt(var + eps) * scale + bias of f32 rows x (R, G, D),
    the moments per group over the rows weighted by w (R, 1, 1) (1 for a
    valid row, 0 for padding; `count` valid entries per group), two-pass.

    The arithmetic runs in f64 and the result is rounded to f32 once, in
    both directions. In f32, eager torch rounds every step apart and sums
    the rows (a strided axis) in order on the CPU: a 5-stage model's
    gradients then moved by up to 4e-3 of their magnitude from an f64
    evaluation, where the JAX package's fused f32 stays within 2e-4 and
    this function within 1.5e-4. On an H100 no end-to-end cost shows above
    the run-to-run spread (PERF.md). Saved for the backward: x in f32 and
    the per-group moments."""

    @staticmethod
    def forward(ctx, x, w, count, scale, bias, eps):
        xd, wd = x.double(), w.double()
        mean = torch.sum(xd * wd, dim=(0, 2), keepdim=True) / count
        xc = xd - mean
        rstd = torch.rsqrt(torch.sum(wd * xc * xc, dim=(0, 2), keepdim=True) / count + eps)
        ctx.save_for_backward(x, w, count, mean, rstd, scale)
        return (xc * rstd * scale.double() + bias.double()).float()

    @staticmethod
    def backward(ctx, grad):
        x, w, count, mean, rstd, scale = ctx.saved_tensors
        wd = w.double()
        xhat = (x.double() - mean) * rstd
        grad = grad.double() * wd
        grad_scale = torch.sum(grad * xhat, dim=0).float()
        grad_bias = torch.sum(grad, dim=0).float()
        g = grad * scale.double()
        shift = torch.sum(g, dim=(0, 2), keepdim=True) / count
        tilt = torch.sum(g * xhat, dim=(0, 2), keepdim=True) / count
        grad_x = (rstd * (g - wd * (shift + xhat * tilt))).float()
        return grad_x, None, None, grad_scale, grad_bias, None


class MaskedGroupNorm(nn.Module):
    """GroupNorm of x (..., N, C) with statistics per group over every valid
    row of every leading index (padded rows excluded, then zeroed).

    The affine parameters live in a child `norm` (an `nn.GroupNorm`), which
    gives the upstream names `<block>.norm.norm.weight` / `.bias`.
    """

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups != 0:
            raise ValueError(f"channels {num_channels} not divisible by groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.norm = nn.GroupNorm(num_groups, num_channels, eps)

    def forward(self, x: torch.Tensor, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = x.shape[-1]
        g = self.num_groups
        xg = x.float().reshape(-1, g, c // g)
        if masks is None:
            w = torch.ones((xg.shape[0], 1, 1), dtype=torch.float32, device=x.device)
        else:
            w = masks.reshape(-1).float()[:, None, None]
        count = torch.clamp(w.sum(dtype=torch.float64) * (c // g), min=1.0)
        scale, bias = (p.reshape(g, c // g) for p in (self.norm.weight, self.norm.bias))
        out = _GroupNormFunction.apply(xg, w, count, scale, bias, self.eps).reshape(x.shape)
        if masks is not None:
            out = torch.where(masks[..., None], out, 0.0)
        return out.to(x.dtype)
