"""Angle utilities. Counterpart of `ref_geotransformer_tpu/ops/vector_angle.py`
(ref parity: modules/ops/vector_angle.py:17-34)."""

from __future__ import annotations

import math

import torch


def rad2deg(rad: torch.Tensor) -> torch.Tensor:
    return rad * (180.0 / math.pi)


def deg2rad(deg: torch.Tensor) -> torch.Tensor:
    return deg * (math.pi / 180.0)


def vector_angle(x: torch.Tensor, y: torch.Tensor, degrees: bool = False) -> torch.Tensor:
    """Angle between broadcastable (*, 3) vectors as atan2(|x cross y|, x . y),
    accurate near 0 and pi (unlike arccos of the dot product)."""
    x, y = torch.broadcast_tensors(x, y)
    angle = torch.atan2(torch.linalg.norm(torch.linalg.cross(x, y), dim=-1), torch.sum(x * y, dim=-1))
    return rad2deg(angle) if degrees else angle
