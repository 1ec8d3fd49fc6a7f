"""KPConv-FPN backbone, generic over the stage count.

Counterpart of `ref_geotransformer_tpu/models/backbone.py::KPConvFPN`, with
the upstream module names. Stage 1: ConvBlock(in -> d), Residual(d -> 2d);
stage s >= 2: strided Residual, then Residual(-> 2^s d) twice. Decoders go
top-down to `fine_level`: concat(upsampled, skip) -> UnaryBlock, the last
one a LastUnaryBlock to `output_dim`. Returns features fine-to-coarse.

`act_dtype=torch.bfloat16` (the config's `backbone.act_dtype`) keeps the
activations bf16 from the input features to the last decoder: the blocks'
tensors, the gather tables, the Linear layers' products and the norms'
outputs (models/kpconv.py). The features leave the backbone as f32, so the
transformer, matching and losses are unchanged.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from portbench.reference.kpconv import (
    ConvBlock,
    LastUnaryBlock,
    ResidualBlock,
    UnaryBlock,
    nearest_upsample,
)


class KPConvFPN(nn.Module):
    def __init__(self, input_dim, output_dim, init_dim, kernel_size, init_radius, init_sigma, group_norm,
                 num_stages=4, fine_level=1, compute_dtype=None, act_dtype=None):
        super().__init__()
        self.act_dtype = act_dtype
        self.num_stages = num_stages
        self.fine_level = fine_level
        d, r, sig, k, gn, cd = init_dim, init_radius, init_sigma, kernel_size, group_norm, compute_dtype
        self.encoder1_1 = ConvBlock(input_dim, d, k, r, sig, gn, compute_dtype=cd)
        self.encoder1_2 = ResidualBlock(d, 2 * d, k, r, sig, gn, compute_dtype=cd)
        for stage in range(2, num_stages + 1):
            cin, cout = d * 2 ** (stage - 1), d * 2**stage
            setattr(self, f"encoder{stage}_1", ResidualBlock(cin, cin, k, r, sig, gn, strided=True, compute_dtype=cd))
            r, sig = r * 2.0, sig * 2.0
            setattr(self, f"encoder{stage}_2", ResidualBlock(cin, cout, k, r, sig, gn, compute_dtype=cd))
            setattr(self, f"encoder{stage}_3", ResidualBlock(cout, cout, k, r, sig, gn, compute_dtype=cd))
        for lvl in range(num_stages - 2, fine_level - 1, -1):
            cat_dim = d * 2 ** (lvl + 2) + d * 2 ** (lvl + 1)
            if lvl == fine_level:
                block = LastUnaryBlock(cat_dim, output_dim)
            else:
                block = UnaryBlock(cat_dim, d * 2 ** (lvl + 1), gn)
            setattr(self, f"decoder{lvl + 1}", block)

    def forward(self, feats: torch.Tensor, data: Dict) -> List[torch.Tensor]:
        """feats (B, N0, input_dim); data: the pyramid dict with every
        tensor stacked over the leading B axis. Returns [(B, C_fine,
        output_dim), ..., (B, C_{S-1}, init_dim * 2^S)], fine-to-coarse."""
        points, masks = data["points"], data["masks"]
        neighbors, subsampling, upsampling = data["neighbors"], data["subsampling"], data["upsampling"]
        if self.act_dtype is not None:
            feats = feats.to(self.act_dtype)

        x = self.encoder1_1(feats, points[0], points[0], neighbors[0], masks[0])
        x = self.encoder1_2(x, points[0], points[0], neighbors[0], masks[0])
        skip_feats = [x]
        for stage in range(2, self.num_stages + 1):
            lvl = stage - 1
            x = getattr(self, f"encoder{stage}_1")(
                x, points[lvl], points[lvl - 1], subsampling[lvl - 1], masks[lvl], masks[lvl - 1]
            )
            x = getattr(self, f"encoder{stage}_2")(x, points[lvl], points[lvl], neighbors[lvl], masks[lvl])
            x = getattr(self, f"encoder{stage}_3")(x, points[lvl], points[lvl], neighbors[lvl], masks[lvl])
            skip_feats.append(x)

        feats_list = [skip_feats[-1]]
        latent = skip_feats[-1]
        for lvl in range(self.num_stages - 2, self.fine_level - 1, -1):
            latent = torch.cat([nearest_upsample(latent, upsampling[lvl]), skip_feats[lvl]], dim=-1)
            block = getattr(self, f"decoder{lvl + 1}")
            latent = block(latent) if lvl == self.fine_level else block(latent, masks[lvl])
            feats_list.append(latent)
        feats_list.reverse()
        return [f.float() for f in feats_list]
