"""The JAX package's initial weights, drawn with numpy.

`jax_init_parameters(model, seed)` gives a port model the weights that the
JAX package's `create_train_state(..., rng=jax.random.key(seed))` (and
`init_model_variables(model, cfg, jax.random.key(seed))`) draws for the same
configuration, without JAX: the threefry-2x32 generator in its partitionable
form (JAX's default), the parameter keys flax folds from each module path and
the module's count of drawn parameters, `lecun_normal` (a normal truncated to
two deviations) for the Dense kernels and the attention's `proj_p_kernel`,
and the JAX package's kaiming-uniform KPConv weights. Biases, norms and the
Sinkhorn alpha are constants, as in `utils/weights.py::init_parameters`.
Every weight agrees with JAX's up to its last bit: XLA's jitted init rounds the
uniform's scale and shift once (an FMA) where numpy rounds twice, and its
f32 erf_inv and log1p round their own way (1e-6 of a tensor's largest
magnitude at most, `tests/test_torch_port_weights.py`).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
from torch import nn

from ref_geotransformer_tpu_torch.models.kpconv import KPConv
from ref_geotransformer_tpu_torch.utils.weights import init_parameters

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# erf(-2 / sqrt 2) and erf(2 / sqrt 2) in f32 as XLA computes them: the
# uniform range of a normal truncated to two deviations
_ERF_LOWER, _ERF_UPPER = np.uint32(3212073496).view(np.float32), np.uint32(1064589848).view(np.float32)
# XLA's f32 erf_inv (Giles' approximation), the branch for w < 5, which every
# |u| <= erf(sqrt 2) takes
_ERF_INV = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087, -0.00125372503,
            -0.00417768164, 0.246640727, 1.50140941)


def _threefry(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counters (x0, x1) under the key pair."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, _U32(k0 ^ k1 ^ _U32(0x1BD11BDA)))
    x0, x1 = np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << _U32(r)) | (x1 >> _U32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3]  # array + scalar: wraps modulo 2^32
        x1 = x1 + _U32(i + 1)
    return x0, x1


def _split(key):
    """jax.random.split(key)[0] (the partitionable form)."""
    a, b = _threefry(key, np.zeros(2, _U32), np.arange(2, dtype=_U32))
    return int(a[0]), int(b[0])


def _fold_in(key, data: int):
    a, b = _threefry(key, np.array([0], _U32), np.array([data], _U32))
    return int(a[0]), int(b[0])


def _param_key(params_key, path, count: int):
    """flax's key for the `count`-th drawn parameter of the module at `path`:
    one fold-in of the first 4 bytes of SHA-1 over the path and the count."""
    digest = hashlib.sha1()
    for part in path:
        digest.update(part.encode("utf-8"))
    digest.update(count.to_bytes((count.bit_length() + 7) // 8, byteorder="big"))
    return _fold_in(params_key, int.from_bytes(digest.digest()[:4], byteorder="big"))


def _uniform(key, shape, low, high):
    """jax.random.uniform in f32."""
    n = math.prod(shape)
    b0, b1 = _threefry(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    floats = ((b0 ^ b1) >> _U32(9) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    low, high = np.float32(low), np.float32(high)
    return np.maximum(low, floats * (high - low) + low).reshape(shape)


def _truncated_normal(key, shape):
    """jax.random.truncated_normal(key, -2, 2, shape) in f32."""
    u = _uniform(key, shape, _ERF_LOWER, _ERF_UPPER)
    w = -np.log1p(-u * u) - np.float32(2.5)
    p = np.full(shape, np.float32(_ERF_INV[0]))
    for c in _ERF_INV[1:]:
        p = np.float32(c) + p * w
    out = np.float32(math.sqrt(2)) * (p * u)
    return np.clip(out, np.nextafter(np.float32(-2), np.float32(np.inf)),
                   np.nextafter(np.float32(2), np.float32(-np.inf)))


def _lecun_normal(key, shape):
    stddev = np.sqrt(np.float32(1.0 / shape[-2])) / np.float32(0.87962566103423978)
    return _truncated_normal(key, shape) * stddev


def jax_init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """`model`'s weights as the JAX package draws them from `jax.random.key(seed)`
    (its `params` stream: the first key of the split). Returns the model."""
    init_parameters(model, torch.Generator().manual_seed(0))  # the constants; every drawn tensor is replaced
    params_key = _split((0, seed))
    with torch.no_grad():
        for name, module in model.named_modules():
            path = []
            for part in name.split("."):
                if part.isdigit() and path and path[-1] == "layers":
                    path[-1] = f"layers_{part}"
                else:
                    path.append(part)
            if isinstance(module, KPConv):
                fan_in = module.weights.shape[0] * module.weights.shape[1]
                bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
                value = _uniform(_param_key(params_key, path, 1), tuple(module.weights.shape), -bound, bound)
                module.weights.copy_(torch.from_numpy(value))
            elif isinstance(module, nn.Linear):
                # a Dense kernel (in, out) is its module's first draw; the RPE
                # attention's `proj_p_kernel` is the attention module's first
                shape = (module.in_features, module.out_features)
                scope = path[:-1] if path[-1] == "proj_p" else path
                module.weight.copy_(torch.from_numpy(_lecun_normal(_param_key(params_key, scope, 1), shape).T.copy()))
            elif isinstance(module, nn.Embedding):
                raise NotImplementedError(f"{name}: no JAX draw of an embedding table")
    return model
