"""Weights: seeded initialization and the bridge from the JAX package's variables.

`from_jax_variables` is the inverse of
`ref_geotransformer_tpu/utils/convert_checkpoint.py` (upstream state dict ->
flax tree): it turns a JAX `{"params", "buffers"}` tree into a state dict
with the upstream key names that the port's modules carry. The same mapping
takes a Cordi tree (`models/cordi.py`), whose flax attention kernels are
(D, H, Dh) for q, k, v and (H, Dh, D) for the output: they flatten to the
port's (D, D) Linear weights, heads major.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Iterator, Optional, Tuple

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
            elif isinstance(module, nn.Embedding):
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator))
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
    if name == "kernel" and value.ndim == 3:  # flax attention: q/k/v (D, H, Dh), out (H, Dh, D) -> Linear
        flat = value.reshape(-1, value.shape[-1]) if modules[-1] == "out" else value.reshape(value.shape[0], -1)
        return modules + ["weight"], flat.T
    if name == "kernel":  # Dense (in, out) -> Linear (out, in)
        return modules + ["weight"], value.T
    if name == "embedding":  # nn.Embed table (num_embeddings, dim) -> nn.Embedding weight, same layout
        return modules + ["weight"], value
    is_norm = modules and modules[-1] in ("norm", "norm_conv")
    if is_norm and name in ("scale", "bias"):
        if modules[0] == "backbone":
            modules = modules + ["norm"]  # GroupNorm wrapper nests the torch GroupNorm one level deeper
        return modules + ["weight" if name == "scale" else "bias"], value
    if name == "scale":  # a LayerNorm outside the matching blocks (Cordi's norm1, norm2, out_norm)
        return modules + ["weight"], value
    if name == "bias":  # an attention q/k/v bias (H, Dh) flattens as its kernel's columns do
        return modules + ["bias"], value.reshape(-1) if value.ndim == 2 else value
    raise KeyError("no torch counterpart for JAX variable " + "/".join(path))


def _norm_alternative(key: str) -> Optional[str]:
    """The other nesting of a norm's affine key: `<block>.norm.norm.weight`
    <-> `<block>.norm.weight` (also for `norm_conv`)."""
    parts = key.split(".")
    if len(parts) >= 3 and parts[-2] == "norm" and parts[-3] in ("norm", "norm_conv"):
        return ".".join(parts[:-2] + parts[-1:])
    if len(parts) >= 2 and parts[-2] in ("norm", "norm_conv"):
        return ".".join(parts[:-1] + ["norm", parts[-1]])
    return None


def from_jax_variables(variables: Dict, keys: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """JAX `{"params": ..., "buffers": ...}` tree (numpy or jax arrays) ->
    torch state dict. Norms in the backbone are taken for GroupNorms
    (upstream `<block>.norm.norm.weight`), the rest for LayerNorms
    (`<block>.norm.weight`); a flax tree does not tell the two apart. With
    the target's state-dict `keys`, a norm key the target lacks takes the
    other nesting where the target has that (the backbone's LayerNorm
    blocks, a group norm outside it)."""
    keys = None if keys is None else set(keys)
    state = {}
    for collection in ("params", "buffers"):
        for path, value in _flat(variables.get(collection, {})):
            parts, arr = _torch_entry(path, np.asarray(value, dtype=np.float32))
            key = ".".join(parts)
            if keys is not None and key not in keys and _norm_alternative(key) in keys:
                key = _norm_alternative(key)
            state[key] = torch.from_numpy(np.array(arr, order="C"))  # a writable copy
    return state


def load_jax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Load a JAX variables tree into `model` (strict: every key must match)."""
    model.load_state_dict(from_jax_variables(variables, model.state_dict().keys()), strict=True)
    return model


def jax_gradients_by_name(grads: Dict) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree, which has the structure of the params tree, ->
    {port parameter name: gradient} in the port's layout (Dense kernels
    transposed), to compare with `model.named_parameters()`' `.grad`."""
    return from_jax_variables({"params": grads})
