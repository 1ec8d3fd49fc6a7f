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

With `use_graphs=True` (the model's `use_kernels`), an inference call on
CUDA tensors (grad disabled, no capture under way) replays the backbone as
one CUDA graph, so the host launches it in one call instead of op by op and
runs ahead of the card. One graph per input key (the device, the dtype and
shape of `feats` and of every pyramid tensor the backbone reads, and the
matmul precision settings): a configuration's caps fix the shapes, so every
pair of a configuration replays one graph. The first call on a key runs
eagerly (cuBLAS and the allocator warm up), the second captures and replays,
later calls replay. The graph keeps its input buffers and its outputs in
tensors of its own, and its inputs hold only what the backbone reads (of the
upsampling tables, column 0 of the levels the decoders upsample to).
`stack_inputs` stacks a pair straight into the input buffers (other inputs
are copied in), and each call returns copies of the outputs, so a later
replay changes nothing an earlier call returned. The graph reads the
parameters' storage, so in-place updates (an optimizer step) are seen, and
moving, converting or loading the module drops its graphs. While a submodule
holds a forward hook, which a replay would not call, calls run eagerly.
Training keeps the eager path.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ref_geotransformer_tpu_torch.models.kpconv import (
    ConvBlock,
    LastUnaryBlock,
    ResidualBlock,
    UnaryBlock,
    nearest_upsample,
)
from ref_geotransformer_tpu_torch.utils.timer import span

MAX_GRAPHS = 4  # input keys kept, least recently used dropped first


def stack_pair(ref: Dict, src: Dict, out: Optional[Dict] = None) -> Dict:
    """The two clouds' pyramids stacked over a leading axis of 2, every key
    of `ref`; with `out`, stacked into its tensors, key by key (a None in
    `out` skips its level)."""
    if out is None:
        return {key: tuple(torch.stack([r, s], dim=0) for r, s in zip(ref[key], src[key])) for key in ref}
    for key, bufs in out.items():
        for buf, r, s in zip(bufs, ref[key], src[key]):
            if buf is not None:
                torch.stack([r, s], dim=0, out=buf)
    return out


class _Graph:
    """The replay of one input key: once captured, the graph, its input
    buffers and the outputs it writes."""

    def __init__(self):
        self.warm = False
        self.graph = None
        self.feats: Optional[torch.Tensor] = None
        self.data: Optional[Dict] = None
        self.outputs: List[torch.Tensor] = []


class KPConvFPN(nn.Module):
    def __init__(self, input_dim, output_dim, init_dim, kernel_size, init_radius, init_sigma, group_norm,
                 num_stages=4, fine_level=1, compute_dtype=None, act_dtype=None, use_graphs=False):
        super().__init__()
        self.act_dtype = act_dtype
        self.use_graphs = use_graphs
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._last: Optional[_Graph] = None
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
        self._submodules = tuple(m for m in self.modules() if m is not self)  # a plain tuple: not registered

    def forward(self, feats: torch.Tensor, data: Dict) -> List[torch.Tensor]:
        """feats (B, N0, input_dim); data: the pyramid dict with every
        tensor stacked over the leading B axis. Returns [(B, C_fine,
        output_dim), ..., (B, C_{S-1}, init_dim * 2^S)], fine-to-coarse."""
        if not self._graphs_engage(feats):
            return self._forward(feats, data)
        entry = self._last
        if entry is None or feats is not entry.feats or data is not entry.data:
            entry = self._entry(feats, data)
            if entry.graph is None:
                if not entry.warm:
                    entry.warm = True
                    return self._forward(feats, data)
                self._capture(entry, feats, data)
            entry.feats.copy_(feats)
            for key, bufs in entry.data.items():
                for buf, t in zip(bufs, self._read(data)[key]):
                    if buf is not None:
                        buf.copy_(t)
        with span("gt.backbone.replay"):
            entry.graph.replay()
            return [t.clone() for t in entry.outputs]

    def stack_inputs(self, ref_feats: torch.Tensor, src_feats: torch.Tensor, ref: Dict, src: Dict):
        """`forward`'s inputs for a pair: feats (2, N0, input_dim) and the two
        pyramids stacked; once a graph replays the backbone, what it reads of
        them stacked straight into its input buffers."""
        if self._graphs_engage(ref_feats):
            entry = self._entry(ref_feats, ref, lead=(2,))
            if entry.graph is not None:
                torch.stack([ref_feats, src_feats], dim=0, out=entry.feats)
                return entry.feats, stack_pair(self._read(ref), self._read(src), out=entry.data)
        return torch.stack([ref_feats, src_feats], dim=0), stack_pair(ref, src)

    def _read(self, data: Dict) -> Dict:
        """What the backbone reads of the pyramid `data` (stacked or one
        cloud's), by key; of the upsampling tables column 0 (the nearest
        support) of the levels the decoders upsample to, None for the others."""
        upsampling = tuple(t[..., :1] if self.fine_level <= i <= self.num_stages - 2 else None
                           for i, t in enumerate(data["upsampling"]))
        return {**{key: tuple(data[key]) for key in ("points", "masks", "neighbors", "subsampling")},
                "upsampling": upsampling}

    def _capture(self, entry: _Graph, feats: torch.Tensor, data: Dict) -> None:
        """Capture the backbone on input buffers of what it reads of `data`."""
        entry.feats = torch.empty_like(feats)
        entry.data = {key: tuple(None if t is None else torch.empty_like(t) for t in ts)
                      for key, ts in self._read(data).items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            entry.outputs = self._forward(entry.feats, entry.data)
        entry.graph = graph

    def _graphs_engage(self, feats: torch.Tensor) -> bool:
        return (self.use_graphs and feats.is_cuda and not torch.is_grad_enabled()
                and not torch.cuda.is_current_stream_capturing() and not self._submodule_hooks())

    def _submodule_hooks(self) -> bool:
        return any(m._forward_hooks or m._forward_pre_hooks for m in self._submodules)

    def _entry(self, feats: torch.Tensor, data: Dict, lead: Tuple = ()) -> _Graph:
        """The entry of the input key of `forward(feats, data)`; with lead=(2,)
        feats and data are one cloud's, and the key is the stacked pair's."""
        matmul = torch.backends.cuda.matmul  # a graph keeps the kernels its capture chose
        read = [t for ts in self._read(data).values() for t in ts if t is not None]
        key = (feats.device, tuple((t.dtype, lead + tuple(t.shape)) for t in read),
               feats.dtype, lead + tuple(feats.shape), matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction,
               matmul.allow_fp16_reduced_precision_reduction, torch.is_inference_mode_enabled())
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = _Graph()
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        self._graphs.move_to_end(key)
        self._last = entry
        return entry

    def drop_graphs(self) -> None:
        """Forget every captured graph and its buffers."""
        self._graphs.clear()
        self._last = None

    def _apply(self, fn, *args, **kwargs):
        self.drop_graphs()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.drop_graphs()
        return super()._load_from_state_dict(*args, **kwargs)

    def _forward(self, feats: torch.Tensor, data: Dict) -> List[torch.Tensor]:
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
