"""Contraction operations of a whole inference pair or train step, by
precision class, for `mfu`: KPConv, the Linear layers, the attention
products, the embedding projections and the matching products, over valid
points, entries and nodes only, and in training their backward.

Classes: a KPConv contraction of a configuration whose backbone declares
`dtype = "bfloat16"` is bf16 work (989 TFLOP/s); every other contraction is
f32 work, held against 495 TFLOP/s (dense TF32, the most an f32-accurate
product can reach). Geometry (the kernel-point distances, the pairwise
distances of the partition and the kNN of the embedding) is counted as f32
work; it takes no gradient. Backward: a product with a learned weight costs
twice its forward (the input's and the weight's gradients) where its input
takes a gradient and once where it does not (the first KPConv's constant
features, the embedding's sinusoids); a product of two activations costs
twice; geometry nothing. Left out as too small to move the share: local-to-
global registration's 3 x 3 products, the ground-truth overlap of training.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from portbench.work.counts import PairCounts
from portbench.work.peaks import CLASS_PEAK


class Tally:
    def __init__(self, train: bool):
        self.train = train
        self.flops: Dict[str, float] = defaultdict(float)

    def add(self, cls: str, fwd: float, bwd_factor: float = 0.0) -> None:
        self.flops[cls] += fwd + (bwd_factor * fwd if self.train else 0.0)

    def seconds(self) -> float:
        """Least time at each class's peak, summed over the classes."""
        return sum(f / CLASS_PEAK[c] for c, f in self.flops.items())


def _kpconv(t: Tally, cls: str, n_q: int, entries: int, k: int, cin: int, cout: int, first: bool) -> None:
    t.add("f32", 2.0 * entries * k * 3)  # kernel-point distances: geometry
    t.add(cls, 2.0 * entries * k * cin, 0.0 if first else 1.0)  # influence-weighted neighbor sum
    t.add(cls, 2.0 * n_q * k * cin * cout, 1.0 if first else 2.0)  # the weights


def _linear(t: Tally, cls: str, n: int, cin: int, cout: int) -> None:
    t.add(cls, 2.0 * n * cin * cout, 2.0)


def _residual(t, kcls, lcls, n_s, n_q, entries, k, cin, cout, strided):
    mid = cout // 4 if not strided else cin // 4
    out = cin if strided else cout
    if cin != mid:
        _linear(t, lcls, n_s, cin, mid)
    _kpconv(t, kcls, n_q, entries, k, mid, mid, False)
    _linear(t, lcls, n_q, mid, out)
    if cin != out:
        _linear(t, lcls, n_q, cin, out)


def backbone(t: Tally, cfg, cloud) -> None:
    """One cloud's KPConv-FPN (models/backbone.py's block layout)."""
    bb = cfg.backbone
    kcls = "bf16" if bb.dtype == "bfloat16" else "f32"
    lcls = "bf16" if bb.act_dtype == "bfloat16" else "f32"
    d, k, n = bb.init_dim, bb.kernel_size, cloud.points
    _kpconv(t, kcls, n[0], cloud.neighbors[0], k, bb.input_dim, d, True)
    _residual(t, kcls, lcls, n[0], n[0], cloud.neighbors[0], k, d, 2 * d, False)
    for stage in range(2, bb.num_stages + 1):
        lvl = stage - 1
        cin, cout = d * 2 ** (stage - 1), d * 2**stage
        _residual(t, kcls, lcls, n[lvl - 1], n[lvl], cloud.subsampling[lvl - 1], k, cin, cin, True)
        _residual(t, kcls, lcls, n[lvl], n[lvl], cloud.neighbors[lvl], k, cin, cout, False)
        _residual(t, kcls, lcls, n[lvl], n[lvl], cloud.neighbors[lvl], k, cout, cout, False)
    for lvl in range(bb.num_stages - 2, bb.fine_level - 1, -1):
        cat = d * 2 ** (lvl + 2) + d * 2 ** (lvl + 1)
        _linear(t, lcls, n[lvl], cat, bb.output_dim if lvl == bb.fine_level else d * 2 ** (lvl + 1))


def transformer(t: Tally, cfg, n_ref: int, n_src: int) -> None:
    gt = cfg.geotransformer
    c, h, k = gt.hidden_dim, gt.num_heads, gt.angle_k
    for n in (n_ref, n_src):
        t.add("f32", 2.0 * n * n * 3)  # the kNN's pairwise distances: geometry
        t.add("f32", 2.0 * n * n * c * c * (1 + k), 1.0)  # the embedding's projections (weight gradient only)
        _linear(t, "f32", n, gt.input_dim, c)  # in_proj
        _linear(t, "f32", n, c, gt.output_dim)  # out_proj
    for block in gt.blocks:
        if block == "self":
            for n in (n_ref, n_src):
                for _ in range(3):
                    _linear(t, "f32", n, c, c)  # q, k, v
                t.add("f32", 2.0 * n * c * c, 2.0)  # q through proj_p, per head
                t.add("f32", 2.0 * n * n * c, 2.0)  # q . k
                t.add("f32", 2.0 * h * n * n * c, 2.0)  # (q W_p) . embedding
                t.add("f32", 2.0 * n * n * c, 2.0)  # attention . v
                _linear(t, "f32", n, c, c)
                _linear(t, "f32", n, c, 2 * c)
                _linear(t, "f32", n, 2 * c, c)
        else:
            for n_q, n_kv in ((n_ref, n_src), (n_src, n_ref)):
                _linear(t, "f32", n_q, c, c)
                _linear(t, "f32", n_kv, c, c)
                _linear(t, "f32", n_kv, c, c)
                t.add("f32", 2.0 * n_q * n_kv * c, 2.0)
                t.add("f32", 2.0 * n_q * n_kv * c, 2.0)
                _linear(t, "f32", n_q, c, c)
                _linear(t, "f32", n_q, c, 2 * c)
                _linear(t, "f32", n_q, 2 * c, c)


def step_tally(cfg, counts: PairCounts, blocks: List[Tuple[int, int]], train: bool) -> Tally:
    """The contraction work of one pair: `blocks` are the matched patches'
    (valid rows, valid columns), as `counts.patch_blocks` gives them."""
    t = Tally(train)
    for cloud in counts.clouds:
        backbone(t, cfg, cloud)
        n_f = cloud.points[cfg.backbone.fine_level]
        t.add("f32", 2.0 * n_f * cloud.points[-1] * 3)  # partition distances: geometry
    n_ref, n_src = counts.clouds[0].points[-1], counts.clouds[1].points[-1]
    transformer(t, cfg, n_ref, n_src)
    c_out = cfg.geotransformer.output_dim
    t.add("f32", 2.0 * n_ref * n_src * c_out)  # coarse matching (detached features)
    if train:
        t.add("f32", 2.0 * n_ref * n_src * c_out, 2.0)  # the coarse loss's feature distances
    c_fine = cfg.backbone.output_dim
    for m, n in blocks:
        t.add("f32", 2.0 * m * n * c_fine, 2.0)  # fine matching scores
    return t
