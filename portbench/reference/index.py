"""Gathers with the sentinel-row convention.

Index == N (one past the last row, or anything larger) marks an empty slot
and reads `fill_value`. Counterpart of `ref_geotransformer_tpu/ops/index.py`:
its `custom_vmap` rule, which folds every batch axis into the row axis so
that a batched gather stays one flat gather, becomes the explicit fold of
`masked_gather_batched`.
"""

from __future__ import annotations

import torch


def masked_gather(data: torch.Tensor, indices: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
    """Rows of `data` (N, C...) at `indices` (...); index >= N reads
    `fill_value`. Result: indices.shape + data.shape[1:]."""
    n = data.shape[0]
    pad_row = torch.full((1,) + tuple(data.shape[1:]), fill_value, dtype=data.dtype, device=data.device)
    padded = torch.cat([data, pad_row], dim=0)
    flat = torch.clamp(indices.reshape(-1), max=n).long()
    return padded.index_select(0, flat).reshape(tuple(indices.shape) + tuple(data.shape[1:]))


def masked_gather_batched(data: torch.Tensor, indices: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
    """Per-batch masked gather, folded into ONE flat gather: data (B, N, C...)
    and indices (B, ...) with per-batch sentinel N. Batch b's rows are offset
    by b * N and every sentinel becomes the flat sentinel B * N."""
    b, n = data.shape[:2]
    flat = data.reshape((b * n,) + tuple(data.shape[2:]))
    offsets = (torch.arange(b, device=indices.device, dtype=indices.dtype) * n).reshape(
        (b,) + (1,) * (indices.dim() - 1)
    )
    flat_idx = torch.where(indices < n, indices + offsets, b * n)
    return masked_gather(flat, flat_idx, fill_value)
