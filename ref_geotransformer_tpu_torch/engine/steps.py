"""Train and eval steps, and the inference forward.

Counterpart of `ref_geotransformer_tpu/engine/steps.py`: `pair` is either
a raw padded pair (points, masks and "transform") or the input dict of
`data.build_registration_inputs`; the pyramid is built on the pair's device.

A batch from `data.loader.PairLoader` is a dict of (B, ...) numpy arrays
plus "_pair_masks" (B,), False for the repeats that pad a final batch.
On one card a batch is a loop over its pairs: pair i's loss is scaled by
w_i / max(sum(w), 1) and backpropagated, then one guarded optimizer update
follows; eval metrics are weighted the same way. This is the JAX
package's vmap-then-weighted-mean for any batch size. A pair of weight 0
adds nothing and is not run. The arrays move to the device here, in the
caller's thread: the loader's worker thread makes numpy arrays only.

With a `world` (`parallel.mesh.World`), each rank's batch is its shard of
the global batch (the JAX package's batch sharded over its mesh): pair i's
loss is scaled by w_i, and `parallel.dp` sums the gradients, the losses and
the metrics over the ranks and divides them by max(global sum of w, 1).
The non-finite guard then reads the reduced gradients, so every rank
skips together, as the one `apply_if_finite` under the mesh does. The
reductions are explicit collectives, not `DistributedDataParallel`: the
backward runs once per pair, a parameter may get no gradient from a pair,
and the denominator is global.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ref_geotransformer_tpu_torch.config import GeoTransformerConfig
from ref_geotransformer_tpu_torch.data.pyramid import build_registration_inputs
from ref_geotransformer_tpu_torch.engine.state import GuardedState
from ref_geotransformer_tpu_torch.models.losses import evaluate, overall_loss
from ref_geotransformer_tpu_torch.parallel import dp
from ref_geotransformer_tpu_torch.parallel.mesh import World


def ensure_pyramids(cfg: GeoTransformerConfig, pair: Dict) -> Dict:
    """The model's input dict: built from a raw padded pair, passed through
    if `pair` already holds the pyramids."""
    if "ref" in pair:
        return pair
    bb, caps = cfg.backbone, cfg.capacities
    return build_registration_inputs(
        pair["ref_points"], pair["ref_masks"], pair["src_points"], pair["src_masks"], bb.num_stages,
        bb.init_voxel_size, bb.init_radius, caps.neighbor_limits, caps.points, transform=pair.get("transform"),
        search_chunk=caps.search_chunk,
    )


def to_device(pair: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A packed numpy pair -> tensors on `device`."""
    return {key: torch.from_numpy(np.ascontiguousarray(value)).to(device) for key, value in pair.items()}


def unstack_batch(batch: Dict[str, np.ndarray], device) -> Tuple[List[Dict[str, torch.Tensor]], List[float]]:
    """A loader batch -> its pairs with weight > 0, on `device`, and their
    weights w_i (w = "_pair_masks", all ones without it)."""
    batch = dict(batch)
    masks = batch.pop("_pair_masks", None)
    size = len(next(iter(batch.values())))
    w = np.ones(size, np.float32) if masks is None else np.asarray(masks, np.float32)
    pairs, weights = [], []
    for i in np.flatnonzero(w):
        pairs.append(to_device({key: value[i] for key, value in batch.items()}, device))
        weights.append(float(w[i]))
    return pairs, weights


def pair_scales(weights: Sequence[float], world: Optional[World]) -> List[float]:
    """What each pair's loss or metric is scaled by: w_i / max(sum(w), 1) in
    one process; w_i with a world, whose reductions divide by the global sum."""
    if world is not None:
        return list(weights)
    denom = max(sum(weights), 1.0)
    return [w / denom for w in weights]


def train_pairs(model, state: GuardedState, pairs: Sequence[Dict], weights: Sequence[float],
                generator: Optional[torch.Generator] = None, world: Optional[World] = None
                ) -> Dict[str, torch.Tensor]:
    """Forward with sampled targets, overall loss and backward of each pair
    of weight w_i, its loss scaled by `pair_scales`; with a world, the
    gradients' all-reduce; then one guarded optimizer update. Returns the
    weighted means of the detached losses {"loss", "c_loss", "f_loss"}, over
    all ranks' pairs with a world."""
    cfg = model.cfg
    state.zero_grad()
    totals: Dict[str, torch.Tensor] = {}
    for pair, scale in zip(pairs, pair_scales(weights, world)):
        data = ensure_pyramids(cfg, pair)
        out = model(data, training=True, generator=generator)
        losses = overall_loss(out, data["transform"], cfg.coarse_loss, cfg.fine_loss, cfg.loss)
        (losses["loss"] * scale).backward()
        for key, value in losses.items():
            totals[key] = totals.get(key, 0.0) + value.detach() * scale
    if world is not None:
        dp.all_reduce_gradients(state.params, sum(weights))
        totals = dp.all_reduce_mean_dict(totals, sum(weights))
    state.apply_gradients()
    return totals


def train_step(model, state: GuardedState, pair: Dict, generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One pair (tensors on the model's device): forward with sampled
    targets, overall loss, backward and one guarded optimizer update. Returns the
    detached losses; `state.skipped` counts the steps the non-finite guard
    dropped."""
    return train_pairs(model, state, [pair], [1.0], generator)


def train_batch(model, state: GuardedState, batch: Dict[str, np.ndarray],
                generator: Optional[torch.Generator] = None, world: Optional[World] = None
                ) -> Dict[str, torch.Tensor]:
    """One loader batch (this rank's shard of the global batch with a
    world): its pairs' weighted losses, one guarded optimizer update."""
    pairs, weights = unstack_batch(batch, next(model.parameters()).device)
    return train_pairs(model, state, pairs, weights, generator, world)


@torch.no_grad()
def eval_step(model, pair: Dict) -> Dict[str, torch.Tensor]:
    """Inference forward, losses and the online metrics of one pair."""
    cfg = model.cfg
    data = ensure_pyramids(cfg, pair)
    out = model(data)
    metrics = evaluate(out, data["transform"], cfg.eval)
    losses = overall_loss(out, data["transform"], cfg.coarse_loss, cfg.fine_loss, cfg.loss)
    return {**losses, **metrics}


def eval_batch(model, batch: Dict[str, np.ndarray], world: Optional[World] = None) -> Dict[str, torch.Tensor]:
    """One loader batch: the weighted means of its pairs' losses and metrics,
    over all ranks' pairs with a world."""
    pairs, weights = unstack_batch(batch, next(model.parameters()).device)
    totals: Dict[str, torch.Tensor] = {}
    for pair, scale in zip(pairs, pair_scales(weights, world)):
        for key, value in eval_step(model, pair).items():
            totals[key] = totals.get(key, 0.0) + value * scale
    if world is not None:
        totals = dp.all_reduce_mean_dict(totals, sum(weights))
    return totals


@torch.no_grad()
def forward(model, cfg: GeoTransformerConfig, pair: Dict) -> Dict[str, torch.Tensor]:
    """The inference forward of one pair (raw padded pair or prebuilt
    inputs), the counterpart of `make_forward_fn(model, cfg)`."""
    return model(ensure_pyramids(cfg, pair))
