"""Weights from the seed, made on the device in a few large draws.

The same state dict goes to the program and to the reference. The laws are
those of the port's `utils/weights.py` and of upstream: a Linear weight
(out, in) is N(0, 1/in) with a zero bias, a KPConv weight (K, Cin, Cout) is
kaiming-uniform with fan_in K * Cin (bound sqrt(2/6) * sqrt(3/fan_in)),
norms start at identity, Sinkhorn's alpha at 1. A parameter is told apart
by its shape and name alone, so no module of the program is read.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def _law(name: str, shape: Tuple[int, ...]) -> str:
    if name.endswith("alpha"):
        return "one"
    if len(shape) == 3:
        return "kpconv"
    if len(shape) == 2:
        return "linear"
    if name.endswith("weight"):
        return "one"  # GroupNorm / LayerNorm scale
    return "zero"  # biases


def make_state(params: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on `device`} for the (name, shape) of every parameter:
    one normal draw for all Linear weights and one uniform draw for all
    KPConv weights, from a generator on `device` seeded with `seed`."""
    params = sorted(params)  # draws in name order, whatever order the model lists them in
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    laws = [(name, tuple(shape), _law(name, tuple(shape))) for name, shape in params]
    total = {kind: sum(math.prod(s) for _, s, k in laws if k == kind) for kind in ("linear", "kpconv")}
    normal = torch.randn(total["linear"], generator=gen, device=device)
    uniform = torch.rand(total["kpconv"], generator=gen, device=device) * 2.0 - 1.0
    offsets = {"linear": 0, "kpconv": 0}
    state = {}
    for name, shape, kind in laws:
        size = math.prod(shape)
        if kind == "linear":
            chunk = normal[offsets[kind]:offsets[kind] + size]
            state[name] = (chunk / math.sqrt(shape[1])).reshape(shape)
        elif kind == "kpconv":
            chunk = uniform[offsets[kind]:offsets[kind] + size]
            bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / (shape[0] * shape[1]))
            state[name] = (chunk * bound).reshape(shape)
        elif kind == "one":
            state[name] = torch.ones(shape, device=device)
        else:
            state[name] = torch.zeros(shape, device=device)
        offsets[kind] = offsets.get(kind, 0) + size
    return state
