"""Attention layers: vanilla, RPE (pairwise embedding), PE (absolute) and
the conditional transformers built from them.

Counterpart of `ref_geotransformer_tpu/models/attention.py` (ref parity:
modules/transformer/vanilla_transformer.py, rpe_transformer.py,
pe_transformer.py, lrpe_transformer.py, output_layer.py,
conditional_transformer.py), with the upstream module names, so
`utils/weights.py::from_jax_variables` and the checkpoint converter carry
their weights. Masks are validity masks (True = attend); masked keys score
-1e9 before the softmax, so fully masked rows stay finite. LayerNorms use
eps 1e-6 and GELU its tanh form, as flax's do.

Dropout sits at the JAX package's three sites of a layer: the softmaxed
attention scores, the output of the post-attention `linear`, and the FFN's
`squeeze` output. It is drawn only where the caller passes a
`torch.Generator` (the GeoTransformer passes its training generator, and
none in inference); `dropout=None` (every shipped configuration) draws
nothing. Kept entries are scaled by 1 / (1 - rate), as flax's
`nn.Dropout` does. The keep masks come from `draw_keep`, which a test
replaces to replay another run's masks. Returned attention scores are the
ones before dropout.

The (B, H, N, M) score tensors are summed, scaled and masked in place, and
where autograd does not record (inference) also softmaxed in place, so an
attention holds one of them at a time (two in training, where the backward
keeps the softmax); the transformers drop each layer's returned scores at
once. The values are those of the out-of-place expressions bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ref_geotransformer_tpu_torch.models.embedding import LearnablePositionalEmbedding

_NEG = -1e9
_LN_EPS = 1e-6

_ACTIVATIONS = {
    "ReLU": F.relu,
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
}


def draw_keep(shape, keep_prob: float, generator: torch.Generator, device) -> torch.Tensor:
    """Bernoulli(keep_prob) keep mask of `shape`, drawn from `generator`."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x: torch.Tensor, rate: Optional[float], generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout of `x` at `rate`; the identity without a rate or a generator."""
    if not rate or generator is None:
        return x
    keep_prob = 1.0 - rate
    return torch.where(draw_keep(x.shape, keep_prob, generator, x.device), x / keep_prob, 0.0)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)  # (B, H, N, c)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, c = x.shape
    return x.transpose(1, 2).reshape(b, n, h * c)


def _finish_attention(scores, v, key_weights, key_masks, attention_factors, rate, generator):
    if attention_factors is not None:
        scores = attention_factors[:, None, :, :] * scores
    if key_weights is not None:
        scores = scores * key_weights[:, None, None, :]
    if key_masks is not None:
        scores = scores.masked_fill_(~key_masks[:, None, None, :], _NEG)
    if torch.is_grad_enabled() and scores.requires_grad:
        scores = torch.softmax(scores, dim=-1)
    else:
        scores = torch.ops.aten._softmax.out(scores, -1, False, out=scores)
    hidden = torch.matmul(dropout(scores, rate, generator), v)
    return _merge_heads(hidden), scores


class MultiHeadAttention(nn.Module):
    """Scaled dot-product multi-head attention (vanilla_transformer.py:15-76)."""

    def __init__(self, d_model: int, num_heads: int, dropout: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)

    def forward(self, input_q, input_k, input_v, key_weights=None, key_masks=None, attention_factors=None,
                generator=None):
        h = self.num_heads
        q = _split_heads(self.proj_q(input_q), h)
        k = _split_heads(self.proj_k(input_k), h)
        v = _split_heads(self.proj_v(input_v), h)
        scores = torch.matmul(q, k.transpose(-1, -2)).div_(q.shape[-1] ** 0.5)
        return _finish_attention(scores, v, key_weights, key_masks, attention_factors, self.dropout, generator)


class RPEMultiHeadAttention(nn.Module):
    """Multi-head attention with a pairwise-embedding score term
    (rpe_transformer.py:18-75): score = (q.k + q.proj_p(embed)) / sqrt(d).

    As in the JAX package, proj_p is applied to q rather than to the
    (B, N, M, C) embedding: q . (W_p e + b_p) == (W_p^T q) . e + q . b_p,
    which costs O(N C^2) + O(N^2 C) instead of O(N^2 C^2).
    """

    def __init__(self, d_model: int, num_heads: int, dropout: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.proj_p = nn.Linear(d_model, d_model)

    def forward(self, input_q, input_k, input_v, embed_qk, key_weights=None, key_masks=None,
                attention_factors=None, generator=None):
        h = self.num_heads
        q = _split_heads(self.proj_q(input_q), h)  # (B, H, N, c)
        k = _split_heads(self.proj_k(input_k), h)
        v = _split_heads(self.proj_v(input_v), h)
        d = q.shape[-1]
        # proj_p.weight is (C_out, C_in) with output channel = head * d + c
        w = self.proj_p.weight.reshape(h, d, -1)  # (H, c, C)
        qp = torch.einsum("bhnc,hcd->bhnd", q, w)  # (B, H, N, C)
        qb = torch.einsum("bhnc,hc->bhn", q, self.proj_p.bias.reshape(h, d))
        # (B, N, H, C) @ (B, N, C, M) -> (B, N, H, M): one product per query node
        scores_p = torch.matmul(qp.transpose(1, 2), embed_qk.transpose(-1, -2)).transpose(1, 2)
        del qp
        scores = torch.matmul(q, k.transpose(-1, -2))
        scores.add_(scores_p.add_(qb[..., None])).div_(d**0.5)  # (scores_e + (scores_p + qb)) / sqrt(d)
        del scores_p
        return _finish_attention(scores, v, key_weights, key_masks, attention_factors, self.dropout, generator)


class PEMultiHeadAttention(nn.Module):
    """Absolute-PE attention: q and k each add a projection of their
    positional embedding (pe_transformer.py:15-132)."""

    def __init__(self, d_model: int, num_heads: int, dropout: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.proj_p_q = nn.Linear(d_model, d_model)
        self.proj_p_k = nn.Linear(d_model, d_model)

    def forward(self, input_q, input_k, input_v, embed_q, embed_k, key_weights=None, key_masks=None,
                attention_factors=None, generator=None):
        h = self.num_heads
        q = _split_heads(self.proj_q(input_q) + self.proj_p_q(embed_q), h)
        k = _split_heads(self.proj_k(input_k) + self.proj_p_k(embed_k), h)
        v = _split_heads(self.proj_v(input_v), h)
        scores = torch.matmul(q, k.transpose(-1, -2)).div_(q.shape[-1] ** 0.5)
        return _finish_attention(scores, v, key_weights, key_masks, attention_factors, self.dropout, generator)


class AttentionOutput(nn.Module):
    """FFN (expand, activation, squeeze) with residual and LayerNorm (output_layer.py:6-21)."""

    def __init__(self, d_model: int, activation_fn: str = "ReLU", dropout: Optional[float] = None):
        super().__init__()
        if activation_fn not in _ACTIVATIONS:
            raise ValueError(f"Unsupported activation: {activation_fn}")
        self.activation = _ACTIVATIONS[activation_fn]
        self.dropout = dropout
        self.expand = nn.Linear(d_model, 2 * d_model)
        self.squeeze = nn.Linear(2 * d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=_LN_EPS)

    def forward(self, input_states, generator=None):
        x = dropout(self.squeeze(self.activation(self.expand(input_states))), self.dropout, generator)
        return self.norm(input_states + x)


class AttentionLayer(nn.Module):
    """Vanilla attention -> linear -> residual + LayerNorm (vanilla_transformer.py:79-113)."""

    def __init__(self, d_model: int, num_heads: int, dropout: Optional[float] = None):
        super().__init__()
        self.dropout = dropout
        self.attention = MultiHeadAttention(d_model, num_heads, dropout)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=_LN_EPS)

    def forward(self, input_states, memory_states, memory_weights=None, memory_masks=None, attention_factors=None,
                generator=None):
        hidden, scores = self.attention(input_states, memory_states, memory_states, key_weights=memory_weights,
                                        key_masks=memory_masks, attention_factors=attention_factors,
                                        generator=generator)
        hidden = dropout(self.linear(hidden), self.dropout, generator)
        return self.norm(hidden + input_states), scores


class RPEAttentionLayer(nn.Module):
    """RPE attention -> linear -> residual + LayerNorm (rpe_transformer.py:78-105)."""

    def __init__(self, d_model: int, num_heads: int, dropout: Optional[float] = None):
        super().__init__()
        self.dropout = dropout
        self.attention = RPEMultiHeadAttention(d_model, num_heads, dropout)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=_LN_EPS)

    def forward(self, input_states, memory_states, position_states, memory_weights=None, memory_masks=None,
                attention_factors=None, generator=None):
        hidden, scores = self.attention(input_states, memory_states, memory_states, position_states,
                                        key_weights=memory_weights, key_masks=memory_masks,
                                        attention_factors=attention_factors, generator=generator)
        hidden = dropout(self.linear(hidden), self.dropout, generator)
        return self.norm(hidden + input_states), scores


class TransformerLayer(nn.Module):
    """AttentionLayer + AttentionOutput (vanilla_transformer.py:116-146)."""

    def __init__(self, d_model: int, num_heads: int, activation_fn: str = "ReLU", dropout: Optional[float] = None):
        super().__init__()
        self.attention = AttentionLayer(d_model, num_heads, dropout)
        self.output = AttentionOutput(d_model, activation_fn, dropout)

    def forward(self, input_states, memory_states, memory_weights=None, memory_masks=None, attention_factors=None,
                generator=None):
        hidden, scores = self.attention(input_states, memory_states, memory_weights=memory_weights,
                                        memory_masks=memory_masks, attention_factors=attention_factors,
                                        generator=generator)
        return self.output(hidden, generator), scores


class RPETransformerLayer(nn.Module):
    """RPEAttentionLayer + AttentionOutput (rpe_transformer.py:108-131)."""

    def __init__(self, d_model: int, num_heads: int, activation_fn: str = "ReLU", dropout: Optional[float] = None):
        super().__init__()
        self.attention = RPEAttentionLayer(d_model, num_heads, dropout)
        self.output = AttentionOutput(d_model, activation_fn, dropout)

    def forward(self, input_states, memory_states, position_states, memory_weights=None, memory_masks=None,
                attention_factors=None, generator=None):
        hidden, scores = self.attention(input_states, memory_states, position_states, memory_weights=memory_weights,
                                        memory_masks=memory_masks, attention_factors=attention_factors,
                                        generator=generator)
        return self.output(hidden, generator), scores


class PETransformerLayer(nn.Module):
    """Absolute-PE attention -> linear -> residual + LayerNorm, then the FFN
    block (pe_transformer.py:75-132)."""

    def __init__(self, d_model: int, num_heads: int, activation_fn: str = "ReLU", dropout: Optional[float] = None):
        super().__init__()
        self.dropout = dropout
        self.attention = PEMultiHeadAttention(d_model, num_heads, dropout)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.output = AttentionOutput(d_model, activation_fn, dropout)

    def forward(self, input_states, memory_states, position_states, memory_position_states, memory_weights=None,
                memory_masks=None, attention_factors=None, generator=None):
        hidden, scores = self.attention(input_states, memory_states, memory_states, position_states,
                                        memory_position_states, key_weights=memory_weights, key_masks=memory_masks,
                                        attention_factors=attention_factors, generator=generator)
        hidden = dropout(self.linear(hidden), self.dropout, generator)
        hidden = self.norm(hidden + input_states)
        return self.output(hidden, generator), scores


class TransformerEncoderLayer(nn.Module):
    """Self-attention encoder layer (vanilla_transformer.py:149-171)."""

    def __init__(self, d_model: int, num_heads: int, activation_fn: str = "ReLU", dropout: Optional[float] = None):
        super().__init__()
        self.layer = TransformerLayer(d_model, num_heads, activation_fn, dropout)

    def forward(self, feats, masks=None, generator=None):
        return self.layer(feats, feats, memory_masks=masks, generator=generator)[0]


class TransformerDecoderLayer(nn.Module):
    """Self- then cross-attention decoder layer (vanilla_transformer.py:160-183)."""

    def __init__(self, d_model: int, num_heads: int, activation_fn: str = "ReLU", dropout: Optional[float] = None):
        super().__init__()
        self.self_attention = TransformerLayer(d_model, num_heads, activation_fn, dropout)
        self.cross_attention = TransformerLayer(d_model, num_heads, activation_fn, dropout)

    def forward(self, q_feats, s_feats, q_masks=None, s_masks=None, generator=None):
        q_feats = self.self_attention(q_feats, q_feats, memory_masks=q_masks, generator=generator)[0]
        return self.cross_attention(q_feats, s_feats, memory_masks=s_masks, generator=generator)[0]


class TransformerEncoder(nn.Module):
    """Stack of encoder layers (vanilla_transformer.py:186-193)."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int, activation_fn: str = "ReLU",
                 dropout: Optional[float] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerEncoderLayer(d_model, num_heads, activation_fn, dropout) for _ in range(num_layers)])

    def forward(self, feats, masks=None, generator=None):
        for layer in self.layers:
            feats = layer(feats, masks, generator=generator)
        return feats


class TransformerDecoder(nn.Module):
    """Stack of decoder layers (vanilla_transformer.py:196-201)."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int, activation_fn: str = "ReLU",
                 dropout: Optional[float] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerDecoderLayer(d_model, num_heads, activation_fn, dropout) for _ in range(num_layers)])

    def forward(self, q_feats, s_feats, q_masks=None, s_masks=None, generator=None):
        for layer in self.layers:
            q_feats = layer(q_feats, s_feats, q_masks, s_masks, generator=generator)
        return q_feats


def _check_blocks(blocks: Sequence[str]) -> tuple:
    for block in blocks:
        if block not in ("self", "cross"):
            raise ValueError(f'Unsupported block type "{block}".')
    return tuple(blocks)


class RPEConditionalTransformer(nn.Module):
    """Interleaved self (RPE, with the geometric embedding) and cross
    (vanilla) blocks over the two clouds (conditional_transformer.py:73-117).
    Cross blocks are sequential (the second cloud attends to the first
    cloud's updated features) unless `parallel`."""

    def __init__(self, blocks: Sequence[str], d_model: int, num_heads: int, activation_fn: str = "ReLU",
                 parallel: bool = False, dropout: Optional[float] = None):
        super().__init__()
        self.blocks = _check_blocks(blocks)
        self.parallel = parallel
        self.layers = nn.ModuleList([
            RPETransformerLayer(d_model, num_heads, activation_fn, dropout) if block == "self"
            else TransformerLayer(d_model, num_heads, activation_fn, dropout) for block in self.blocks])

    def forward(self, feats0, feats1, embeddings0, embeddings1, masks0: Optional[torch.Tensor] = None,
                masks1: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                feats0 = layer(feats0, feats0, embeddings0, memory_masks=masks0, generator=generator)[0]
                feats1 = layer(feats1, feats1, embeddings1, memory_masks=masks1, generator=generator)[0]
            else:
                new_feats0 = layer(feats0, feats1, memory_masks=masks1, generator=generator)[0]
                memory = feats0 if self.parallel else new_feats0
                feats1 = layer(feats1, memory, memory_masks=masks0, generator=generator)[0]
                feats0 = new_feats0
        return feats0, feats1


class PEConditionalTransformer(nn.Module):
    """Self blocks with absolute positional embeddings, cross blocks vanilla
    (conditional_transformer.py:42-70)."""

    def __init__(self, blocks: Sequence[str], d_model: int, num_heads: int, activation_fn: str = "ReLU"):
        super().__init__()
        self.blocks = _check_blocks(blocks)
        self.layers = nn.ModuleList([
            PETransformerLayer(d_model, num_heads, activation_fn) if block == "self"
            else TransformerLayer(d_model, num_heads, activation_fn) for block in self.blocks])

    def forward(self, feats0, feats1, embeddings0, embeddings1, masks0=None, masks1=None):
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                feats0 = layer(feats0, feats0, embeddings0, embeddings0, memory_masks=masks0)[0]
                feats1 = layer(feats1, feats1, embeddings1, embeddings1, memory_masks=masks1)[0]
            else:
                feats0 = layer(feats0, feats1, memory_masks=masks1)[0]
                feats1 = layer(feats1, feats0, memory_masks=masks0)[0]
        return feats0, feats1


class LRPEConditionalTransformer(nn.Module):
    """Self blocks with learnable relative positional embeddings over
    quantized indices, cross blocks vanilla (conditional_transformer.py:120-161,
    lrpe_transformer.py:19-148). `emb_indices` are integer relative-position
    bins (B, N, N)."""

    def __init__(self, blocks: Sequence[str], d_model: int, num_heads: int, num_embeddings: int,
                 activation_fn: str = "ReLU"):
        super().__init__()
        self.blocks = _check_blocks(blocks)
        self.embedding = LearnablePositionalEmbedding(num_embeddings, d_model)
        self.layers = nn.ModuleList([
            RPETransformerLayer(d_model, num_heads, activation_fn) if block == "self"
            else TransformerLayer(d_model, num_heads, activation_fn) for block in self.blocks])

    def forward(self, feats0, feats1, emb_indices0, emb_indices1, masks0=None, masks1=None):
        e0, e1 = self.embedding(emb_indices0), self.embedding(emb_indices1)
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                feats0 = layer(feats0, feats0, e0, memory_masks=masks0)[0]
                feats1 = layer(feats1, feats1, e1, memory_masks=masks1)[0]
            else:
                feats0 = layer(feats0, feats1, memory_masks=masks1)[0]
                feats1 = layer(feats1, feats0, memory_masks=masks0)[0]
        return feats0, feats1


class VanillaConditionalTransformer(nn.Module):
    """Self and cross blocks without positional embeddings
    (conditional_transformer.py:14-39); cross blocks sequential."""

    def __init__(self, blocks: Sequence[str], d_model: int, num_heads: int, activation_fn: str = "ReLU"):
        super().__init__()
        self.blocks = _check_blocks(blocks)
        self.layers = nn.ModuleList([TransformerLayer(d_model, num_heads, activation_fn) for _ in self.blocks])

    def forward(self, feats0, feats1, masks0=None, masks1=None):
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                feats0 = layer(feats0, feats0, memory_masks=masks0)[0]
                feats1 = layer(feats1, feats1, memory_masks=masks1)[0]
            else:
                feats0 = layer(feats0, feats1, memory_masks=masks1)[0]
                feats1 = layer(feats1, feats0, memory_masks=masks0)[0]
        return feats0, feats1
