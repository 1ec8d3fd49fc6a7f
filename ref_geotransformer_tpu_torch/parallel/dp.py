"""Data-parallel reductions: gradients and weighted metric means over the ranks.

Counterpart of `ref_geotransformer_tpu/parallel/dp.py`. There the global
batch is one array sharded over the mesh, and the jitted step's weighted
means over it are global by construction. Here each rank holds its own
shard of the global batch (its loader's), runs its pairs' backward, and
these functions make the sums global: each rank passes its weighted sums
and its weight sum, and gets back the global sums over the global weight
sum. So an update equals a single process's update over the global batch
with the weights w_i / max(sum w, 1). `shard_batch` has no counterpart: each
rank's loader already yields its own shard.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist


def all_reduce_gradients(params: Sequence[torch.Tensor], weight_sum: float) -> None:
    """`params`' gradients, each this rank's sum of w_i * grad(loss_i),
    become the global weighted mean: one all-reduce (SUM) over a flat buffer
    of every gradient with `weight_sum` (this rank's sum of w) at its end,
    then a division by max(global sum of w, 1). A parameter without a
    gradient counts as a zero one, as under `jax.grad`."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    # a fill on the device, not a copy from a host list (which waits for the stream to drain)
    weight = torch.full((1,), weight_sum, dtype=grads[0].dtype, device=grads[0].device)
    flat = torch.cat([g.reshape(-1) for g in grads] + [weight])
    dist.all_reduce(flat)
    flat[:-1].div_(flat[-1:].clamp(min=1.0))
    pieces = flat.split([g.numel() for g in grads] + [1])
    torch._foreach_copy_(grads, [piece.view_as(g) for piece, g in zip(pieces, grads)])


def all_reduce_mean_dict(sums: Dict[str, torch.Tensor], weight_sum: float) -> Dict[str, torch.Tensor]:
    """{key: sum of w_i * value_i} on each rank -> {key: global sum / max(global
    sum of w, 1)}, with the weight sums reduced in the same all-reduce."""
    keys = sorted(sums)
    device = sums[keys[0]].device
    flat = torch.stack([torch.as_tensor(sums[key], dtype=torch.float32, device=device) for key in keys]
                       + [torch.full((), weight_sum, dtype=torch.float32, device=device)])
    dist.all_reduce(flat)
    return dict(zip(keys, (flat[:-1] / flat[-1].clamp(min=1.0)).unbind()))
