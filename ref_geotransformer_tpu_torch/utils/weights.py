"""Weights: seeded initialization and the bridge from the JAX package's variables.

`from_jax_variables` is the inverse of
`ref_geotransformer_tpu/utils/convert_checkpoint.py` (upstream state dict ->
flax tree): it turns a JAX `{"params", "buffers"}` tree into a state dict
with the upstream key names that the port's modules carry.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ref_geotransformer_tpu_torch.models.kpconv import KPConv
from ref_geotransformer_tpu_torch.models.sinkhorn import LearnableLogOptimalTransport


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from `generator` (a CPU generator; initialize before
    moving the model to its device): Linear weights N(0, 1/fan_in) with zero
    bias, KPConv weights kaiming-uniform, norms at identity, Sinkhorn alpha 1."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator)
                                    / math.sqrt(module.in_features))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, KPConv):
                module.reset_parameters(generator)
            elif isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, LearnableLogOptimalTransport):
                module.alpha.fill_(1.0)
    return model


def _flat(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            yield from _flat(value, path)
        else:
            yield path, value


def _torch_entry(path: Tuple[str, ...], value: np.ndarray):
    """One flax leaf -> (upstream key, array)."""
    modules = []
    for part in path[:-1]:
        m = re.fullmatch(r"layers_(\d+)", part)
        modules += ["layers", m.group(1)] if m else [part]
    name = path[-1]
    if name in ("kernel_points", "alpha", "weights"):  # KPConv buffer / Sinkhorn scalar / KPConv kernel
        return modules + [name], value
    if name == "proj_p_kernel":  # RPE q-side rewrite keeps the Linear's (in, out) kernel
        return modules + ["proj_p", "weight"], value.T
    if name == "proj_p_bias":
        return modules + ["proj_p", "bias"], value
    if name == "kernel":  # Dense (in, out) -> Linear (out, in)
        return modules + ["weight"], value.T
    is_norm = modules and modules[-1] in ("norm", "norm_conv")
    if is_norm and name in ("scale", "bias"):
        if modules[0] == "backbone":
            modules = modules + ["norm"]  # GroupNorm wrapper nests the torch GroupNorm one level deeper
        return modules + ["weight" if name == "scale" else "bias"], value
    if name == "bias":
        return modules + ["bias"], value
    raise KeyError("no torch counterpart for JAX variable " + "/".join(path))


def from_jax_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX `{"params": ..., "buffers": ...}` tree (numpy or jax arrays) ->
    torch state dict. Norms in the backbone are GroupNorms (upstream
    `<block>.norm.norm.weight`); the rest are LayerNorms (`<block>.norm.weight`)."""
    state = {}
    for collection in ("params", "buffers"):
        for path, value in _flat(variables.get(collection, {})):
            parts, arr = _torch_entry(path, np.asarray(value, dtype=np.float32))
            state[".".join(parts)] = torch.from_numpy(np.array(arr, order="C"))  # a writable copy
    return state


def load_jax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Load a JAX variables tree into `model` (strict: every key must match)."""
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def jax_gradients_by_name(grads: Dict) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree, which has the structure of the params tree, ->
    {port parameter name: gradient} in the port's layout (Dense kernels
    transposed), to compare with `model.named_parameters()`' `.grad`."""
    return from_jax_variables({"params": grads})
