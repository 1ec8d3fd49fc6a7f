"""Train and eval steps for one (ref, src) pair, the reference's batch size.

Counterpart of `ref_geotransformer_tpu/engine/steps.py`: `pair` is either
a raw padded pair (points, masks and "transform") or the input dict of
`data.build_registration_inputs`; the pyramid is built on the pair's device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ref_geotransformer_tpu_torch.config import GeoTransformerConfig
from ref_geotransformer_tpu_torch.data.pyramid import build_registration_inputs
from ref_geotransformer_tpu_torch.engine.state import TrainState
from ref_geotransformer_tpu_torch.models.losses import evaluate, overall_loss


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


def train_step(model, state: TrainState, pair: Dict, generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """Forward with sampled targets, overall loss, backward and one guarded
    Adam update. Returns the detached losses {"loss", "c_loss", "f_loss"};
    `state.skipped` counts the steps the non-finite guard dropped."""
    cfg = model.cfg
    data = ensure_pyramids(cfg, pair)
    state.zero_grad()
    out = model(data, training=True, generator=generator)
    losses = overall_loss(out, data["transform"], cfg.coarse_loss, cfg.fine_loss, cfg.loss)
    losses["loss"].backward()
    state.apply_gradients()
    return {key: value.detach() for key, value in losses.items()}


@torch.no_grad()
def eval_step(model, pair: Dict) -> Dict[str, torch.Tensor]:
    """Inference forward, losses and the online metrics of one pair."""
    cfg = model.cfg
    data = ensure_pyramids(cfg, pair)
    out = model(data)
    metrics = evaluate(out, data["transform"], cfg.eval)
    losses = overall_loss(out, data["transform"], cfg.coarse_loss, cfg.fine_loss, cfg.loss)
    return {**losses, **metrics}
