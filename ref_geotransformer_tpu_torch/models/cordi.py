"""Cordi: correspondence diffusion, a DDPM over superpoint correspondence
matrices.

Counterpart of `ref_geotransformer_tpu/models/cordi.py` (ref parity:
modules/cordi/cordi.py:8-165, ddpm.py:13-154, transformer.py:5-47), with the
flax parameter tree's names (`utils/weights.py` bridges the two):

* `VarianceSchedule`: the linear beta schedule, computed in numpy float32
  as the JAX package does, held as non-persistent buffers (they move with
  the module and stay out of its state dict).
* `ddpm_loss` and `ddpm_sample` take their noise as arguments (`t`,
  `e_rand`; the (num_steps, B, R, S) sequence `zs`, whose t = 1 entry is
  zeroed); `Cordi.get_loss` and `Cordi.sample` draw it from a generator.
* The denoiser runs post-LN encoder layers over the R * S cells plus one
  time token, batch first (the intended semantics: the upstream module fed
  (B, S, E) tensors to a sequence-first encoder). Its attention is the flax
  formulation: q scaled by 1/sqrt(head_dim) before the product, explicit
  matmuls and an f32 softmax. The flax defaults hold: tanh-approximated
  GELU, LayerNorm eps 1e-6.
* `cordi_downsample` takes the uniform node keys as arguments and selects
  the top-k of them as `lax.top_k` does: ties (the -1 of every invalid
  node) go to the lower index, which a stable descending sort gives and
  `torch.topk` does not.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_LN_EPS = 1e-6  # flax nn.LayerNorm's default


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last axis, ties to the lower
    index (`jax.lax.top_k`'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class VarianceSchedule(nn.Module):
    """Linear beta schedule with a zero step 0 (ddpm.py:13-53)."""

    def __init__(self, num_steps: int, beta_1: float, beta_T: float, mode: str = "linear"):
        super().__init__()
        assert mode == "linear"
        self.num_steps = num_steps
        betas = np.concatenate([[0.0], np.linspace(beta_1, beta_T, num_steps)]).astype(np.float32)
        alphas = 1.0 - betas
        alpha_bars = np.exp(np.cumsum(np.log(alphas)))
        sigmas_flex = np.sqrt(betas)
        sigmas_inflex = np.zeros_like(sigmas_flex)
        sigmas_inflex[1:] = np.sqrt(((1.0 - alpha_bars[:-1]) / (1.0 - alpha_bars[1:])) * betas[1:])
        for name, value in (("betas", betas), ("alphas", alphas), ("alpha_bars", alpha_bars),
                            ("sigmas_flex", sigmas_flex), ("sigmas_inflex", sigmas_inflex)):
            self.register_buffer(name, torch.from_numpy(np.asarray(value, np.float32)), persistent=False)

    def get_sigmas(self, t, flexibility: float = 0.0) -> torch.Tensor:
        return self.sigmas_flex[t] * flexibility + self.sigmas_inflex[t] * (1.0 - flexibility)


NetFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddpm_loss(var_sched: VarianceSchedule, net_fn: NetFn, x_0: torch.Tensor, t: torch.Tensor,
              e_rand: torch.Tensor) -> torch.Tensor:
    """Epsilon-prediction MSE at explicit (t, e_rand) (ddpm.py:80-110):
    e_theta = net(sqrt(a_bar_t) x_0 + sqrt(1 - a_bar_t) e, t)."""
    alpha_bar = var_sched.alpha_bars[t]
    c0 = torch.sqrt(alpha_bar)[:, None, None]
    c1 = torch.sqrt(1.0 - alpha_bar)[:, None, None]
    e_theta = net_fn(c0 * x_0 + c1 * e_rand, t)
    return torch.mean((e_theta - e_rand) ** 2)


def ddpm_sample(var_sched: VarianceSchedule, net_fn: NetFn, x_T: torch.Tensor, zs: torch.Tensor,
                flexibility: float = 0.0) -> torch.Tensor:
    """Reverse diffusion t = num_steps..1 (ddpm.py:127-154); zs[i] is the
    noise of step t = num_steps - i, and the t = 1 entry is taken as zero."""
    b = x_T.shape[0]
    x_t = x_T
    for i, t in enumerate(range(var_sched.num_steps, 0, -1)):
        z = zs[i] if t > 1 else torch.zeros_like(zs[i])
        alpha, alpha_bar = var_sched.alphas[t], var_sched.alpha_bars[t]
        sigma = var_sched.get_sigmas(t, flexibility)
        c0 = 1.0 / torch.sqrt(alpha)
        c1 = (1.0 - alpha) / torch.sqrt(1.0 - alpha_bar)
        e_theta = net_fn(x_t, torch.full((b,), t, dtype=torch.long, device=x_T.device))
        x_t = c0 * (x_t - c1 * e_theta) + sigma * z
    return x_t


class SinusoidalTimeEmbedding(nn.Module):
    """Timestep embedding (ddpm.py:56-69); the frequencies divide by half - 1."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, time: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=time.device)
                          * np.float32(-math.log(10000.0) / (half - 1)))
        args = time.to(torch.float32)[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class SelfAttention(nn.Module):
    """flax `MultiHeadDotProductAttention(x, x)`: per-head q, k, v
    projections, q / sqrt(head_dim), softmax(q k^T) v in f32, the output
    projection."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        q, k, v = (proj(x).reshape(b, n, h, d // h).transpose(1, 2) for proj in (self.query, self.key, self.value))
        q = q / math.sqrt(d // h)
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(), dim=-1)
        return self.out(torch.matmul(probs, v).transpose(1, 2).reshape(b, n, d))


class EncoderLayer(nn.Module):
    """Post-LN transformer encoder layer: attention, add and norm, FFN, add
    and norm."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, activation: str = "gelu"):
        super().__init__()
        self.self_attn = SelfAttention(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.act = {"gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu}[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(self.act(self.linear1(x))))


class DenoisingTransformer(nn.Module):
    """The epsilon predictor over the flattened correspondence matrix
    (transformer.py:5-47): tokens x_t[i, j] + ctx[i, j] and one time token;
    an output MLP d_model -> 64 -> 32 -> 1 per cell."""

    def __init__(self, n_layers: int = 8, n_heads: int = 8, query_dimensions: int = 64,
                 feed_forward_dimensions: int = 2048, activation: str = "gelu"):
        super().__init__()
        self.d_model = n_heads * query_dimensions
        self.layers = nn.ModuleList(EncoderLayer(self.d_model, n_heads, feed_forward_dimensions, activation)
                                    for _ in range(n_layers))
        self.out_norm = nn.LayerNorm(self.d_model, eps=_LN_EPS)
        self.out_fc1 = nn.Linear(self.d_model, 64)
        self.out_fc2 = nn.Linear(64, 32)
        self.out_fc3 = nn.Linear(32, 1)

    def forward(self, x_t: torch.Tensor, t_emb: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """x_t (B, R, S), t_emb (B, D), ctx (B, R, S, D) -> eps (B, R, S)."""
        b, r, s = x_t.shape
        d = self.d_model
        assert ctx.shape[-1] == d, (f"context width {ctx.shape[-1]} must equal the denoiser d_model {d} "
                                    f"(= n_heads * query_dimensions; the encoder context is 2 * coarse output_dim)")
        tokens = (x_t[..., None] + ctx).reshape(b, r * s, d)
        tokens = torch.cat([tokens, t_emb[:, None, :]], dim=1)  # (B, R * S + 1, D)
        for layer in self.layers:
            tokens = layer(tokens)
        out = self.out_fc1(self.out_norm(tokens))
        out = self.out_fc3(F.relu(self.out_fc2(F.relu(out))))
        return out[:, :-1, 0].reshape(b, r, s)  # the time token dropped


class Cordi(nn.Module):
    """The diffusion model over a frozen GeoTransformer's coarse outputs
    (cordi.py:8-165)."""

    def __init__(self, ref_sample_num: int = 40, src_sample_num: int = 80, num_steps: int = 100,
                 beta_1: float = 1e-4, beta_T: float = 0.02, time_emb_dim: int = 512, n_layers: int = 8,
                 n_heads: int = 8, query_dimensions: int = 64, feed_forward_dimensions: int = 2048,
                 activation: str = "gelu"):
        super().__init__()
        self.ref_sample_num = ref_sample_num
        self.src_sample_num = src_sample_num
        self.num_steps = num_steps
        self.var_sched = VarianceSchedule(num_steps, beta_1, beta_T)
        self.net = DenoisingTransformer(n_layers, n_heads, query_dimensions, feed_forward_dimensions, activation)
        self.time_mlp = nn.Linear(time_emb_dim, self.net.d_model)
        self.time_embed = SinusoidalTimeEmbedding(time_emb_dim)

    @classmethod
    def from_config(cls, ddpm) -> "Cordi":
        """The model of a `DDPMConfig`."""
        return cls(ddpm.ref_sample_num, ddpm.src_sample_num, ddpm.num_steps, ddpm.beta_1, ddpm.beta_T,
                   ddpm.time_emb_dim, ddpm.n_layers, ddpm.n_heads, ddpm.query_dimensions,
                   ddpm.feed_forward_dimensions, ddpm.activation)

    def denoise(self, x_t: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """One denoiser application: eps_theta(x_t, t | ctx)."""
        return self.net(x_t, F.relu(self.time_mlp(self.time_embed(t))), ctx)

    def loss(self, x_0: torch.Tensor, ctx: torch.Tensor, t: torch.Tensor, e_rand: torch.Tensor) -> torch.Tensor:
        return ddpm_loss(self.var_sched, lambda x, tt: self.denoise(x, tt, ctx), x_0, t, e_rand)

    def reverse(self, x_T: torch.Tensor, ctx: torch.Tensor, zs: torch.Tensor, flexibility: float = 0.0
                ) -> torch.Tensor:
        return ddpm_sample(self.var_sched, lambda x, t: self.denoise(x, t, ctx), x_T, zs, flexibility)

    def draw_loss_noise(self, x_0: torch.Tensor, generator: Optional[torch.Generator]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """t ~ U{0, ..., num_steps - 1} per matrix, e_rand ~ N(0, 1) per cell."""
        t = torch.randint(0, self.num_steps, (x_0.shape[0],), generator=generator, device=x_0.device)
        return t, torch.randn(x_0.shape, generator=generator, device=x_0.device)

    def draw_sample_noise(self, x_T: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return torch.randn((self.num_steps,) + tuple(x_T.shape), generator=generator, device=x_T.device)

    def get_loss(self, x_0: torch.Tensor, ctx: torch.Tensor, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """The DDPM epsilon-loss (ddpm.py:80-110) at noise drawn from `generator`."""
        return self.loss(x_0, ctx, *self.draw_loss_noise(x_0, generator))

    def sample(self, x_T: torch.Tensor, ctx: torch.Tensor, generator: Optional[torch.Generator] = None,
               flexibility: float = 0.0) -> torch.Tensor:
        """Reverse diffusion from x_T (the initial correspondence matrix) at
        noise drawn from `generator`."""
        return self.reverse(x_T, ctx, self.draw_sample_noise(x_T, generator), flexibility)

    def forward(self, x_0: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """One denoiser application at t = 0."""
        return self.denoise(x_0, torch.zeros((x_0.shape[0],), dtype=torch.long, device=x_0.device), ctx)


def cordi_downsample(output: Dict[str, torch.Tensor], ref_sample_num: int, src_sample_num: int,
                     ref_keys: torch.Tensor, src_keys: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Cordi.downsample (cordi.py:40-128) on one encoder output dict: a
    sample without replacement of valid nodes (the top-k of their uniform
    keys, every invalid node keyed -1), the (R, S) +-1 ground-truth and
    initial correspondence matrices (the initial one from all proposals,
    padded ones included), the (R, S, 2C) feature context and the sampled
    points."""
    ref_idx = top_k_indices(torch.where(output["ref_node_masks"], ref_keys, -1.0), ref_sample_num)
    src_idx = top_k_indices(torch.where(output["src_node_masks"], src_keys, -1.0), src_sample_num)

    def signed(mask: torch.Tensor) -> torch.Tensor:
        return torch.where(mask[ref_idx][:, src_idx], 1.0, -1.0)

    gt_map = output["gt_node_overlap_map"] > 0.0
    init_map = torch.zeros_like(gt_map)
    init_map[output["ref_node_corr_indices"].long(), output["src_node_corr_indices"].long()] = True
    ref_feats = output["ref_feats_c"][ref_idx]
    src_feats = output["src_feats_c"][src_idx]
    feat_matrix = torch.cat([ref_feats[:, None, :].expand(-1, src_sample_num, -1),
                             src_feats[None, :, :].expand(ref_sample_num, -1, -1)], dim=-1)
    return {
        "ref_points": output["ref_points_c"][ref_idx],
        "src_points": output["src_points_c"][src_idx],
        "ref_feats": ref_feats,
        "src_feats": src_feats,
        "gt_corr_matrix": signed(gt_map),
        "init_corr_matrix": signed(init_map),
        "feat_matrix": feat_matrix,
    }


def get_corr_from_matrix_topk(corr_matrix: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest cells of a (..., R, S) correspondence matrix, ties to
    the lower flat index -> (..., k) ref and src indices (bop_utils.py:238-249)."""
    s = corr_matrix.shape[-1]
    idx = top_k_indices(corr_matrix.reshape(corr_matrix.shape[:-2] + (-1,)), k)
    return (idx // s).to(torch.int32), (idx % s).to(torch.int32)
