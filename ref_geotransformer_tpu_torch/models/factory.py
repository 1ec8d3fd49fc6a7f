"""Layer factories and the generic pointwise conv block.

Counterpart of `ref_geotransformer_tpu/models/factory.py` (ref parity:
modules/layers/factory.py:6-87, modules/layers/conv_block.py:9-107): an
activation by name, a norm by name (the mask-aware group norm or a
LayerNorm, both called as `norm(x, masks)`), dropout by rate, and
`ConvBlock1d`. No shipped model uses them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ref_geotransformer_tpu_torch.models.attention import dropout
from ref_geotransformer_tpu_torch.models.norms import ChannelLayerNorm, MaskedGroupNorm

_ACT_REGISTRY = {
    "ReLU": F.relu,
    # the factory's LeakyReLU slope is 0.2 (factory.py:77-79); the KPConv
    # blocks do not use the registry and take 0.1 (modules.py:115)
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.2),
    "ELU": F.elu,
    "GELU": lambda x: F.gelu(x, approximate="tanh"),  # flax's gelu is the tanh form
    "Sigmoid": torch.sigmoid,
    "Softplus": F.softplus,
    "Tanh": torch.tanh,
    "Identity": lambda x: x,
}


class _NoNorm(nn.Module):
    def forward(self, x, masks=None):
        return x


def build_act_layer(act_cfg: Optional[str]) -> Callable:
    """Activation by name (factory.py:41-56); None is the identity."""
    if act_cfg is None:
        return _ACT_REGISTRY["Identity"]
    if act_cfg not in _ACT_REGISTRY:
        raise ValueError(f"Unsupported activation: {act_cfg}")
    return _ACT_REGISTRY[act_cfg]


def build_norm_layer(norm_cfg: Optional[str], num_features: int, group_norm: int = 32) -> nn.Module:
    """Norm module by name (factory.py:6-38), called as `norm(x, masks)`."""
    if norm_cfg is None:
        return _NoNorm()
    if norm_cfg == "LayerNorm":
        return ChannelLayerNorm(num_features)
    if norm_cfg == "GroupNorm":
        return MaskedGroupNorm(group_norm, num_features)
    raise ValueError(f"Unsupported norm: {norm_cfg}")


def build_dropout_layer(p: Optional[float]) -> Callable:
    """Dropout by rate (factory.py:59-68), called as `drop(x, generator)`:
    the identity for p None or 0, or without a generator (inference)."""
    return lambda x, generator=None: dropout(x, p, generator)


class ConvBlock1d(nn.Module):
    """Pointwise conv (a Linear over the channels of (N, C)) -> norm ->
    activation (layers/conv_block.py:9-107)."""

    def __init__(self, in_channels: int, out_channels: int, norm: Optional[str] = "GroupNorm",
                 act: Optional[str] = "LeakyReLU", group_norm: int = 32):
        super().__init__()
        self.conv = nn.Linear(in_channels, out_channels)
        self.norm = build_norm_layer(norm, out_channels, group_norm)
        self.act = build_act_layer(act)

    def forward(self, x, masks=None):
        return self.act(self.norm(self.conv(x), masks))
