"""PyTorch port vs JAX package: the transformer surface of
models/attention.py (the RPE conditional transformer's activation, parallel
cross blocks and attention dropout; the vanilla layer, encoder and decoder;
PE attention; the PE, LRPE and vanilla conditional transformers),
LearnablePositionalEmbedding and models/factory.py, with the JAX weights
bridged into the port (strict loads).

Dropout: both packages draw their keep masks from one numpy-seeded sequence,
in call order (the JAX package's `jax.random.bernoulli` and the port's
`attention.draw_keep` each replaced for the test), and every draw's shape
must agree. Tolerance: the f32 scaled error 2e-5 (tests/torch_port_utils.py)
for outputs and gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ref_geotransformer_tpu.models import attention as jax_attention
from ref_geotransformer_tpu.models import factory as jax_factory
from ref_geotransformer_tpu.models.embedding import LearnablePositionalEmbedding as JaxLearnablePE
from ref_geotransformer_tpu_torch.models import attention, factory
from ref_geotransformer_tpu_torch.models.embedding import LearnablePositionalEmbedding
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables, load_jax_variables
from tests.torch_port_utils import assert_close

D, HEADS, N0, N1 = 32, 4, 24, 20
BLOCKS = ("self", "cross", "self", "cross")
RATE = 0.1


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats0 = rng.normal(size=(1, N0, D)).astype(np.float32)
    feats1 = rng.normal(size=(1, N1, D)).astype(np.float32)
    emb0 = rng.normal(size=(1, N0, N0, D)).astype(np.float32)
    emb1 = rng.normal(size=(1, N1, N1, D)).astype(np.float32)
    masks0 = np.arange(N0)[None] < 21
    masks1 = np.arange(N1)[None] < 17
    return feats0, feats1, emb0, emb1, masks0, masks1


class MaskReplay:
    """One numpy-seeded sequence of keep masks, handed out in call order to
    the JAX package (as `jax.random.bernoulli`) and to the port (as
    `attention.draw_keep`); records the shapes each side asked for."""

    def __init__(self, seed, keep_prob):
        self.rng = np.random.default_rng(seed)
        self.keep_prob = keep_prob
        self.masks, self.jax_shapes, self.port_shapes = [], [], []

    def jax_bernoulli(self, key, p=0.5, shape=None):
        assert abs(float(p) - self.keep_prob) < 1e-7
        mask = self.rng.uniform(size=tuple(shape)) < self.keep_prob
        self.masks.append(mask)
        self.jax_shapes.append(tuple(shape))
        return jnp.asarray(mask)

    def port_draw_keep(self, shape, keep_prob, generator, device):
        assert abs(keep_prob - self.keep_prob) < 1e-7 and isinstance(generator, torch.Generator)
        i = len(self.port_shapes)
        self.port_shapes.append(tuple(shape))
        return torch.from_numpy(self.masks[i]).to(device)


def _jax_grads_and_out(module, variables, args, cotangents, replay, deterministic):
    """JAX outputs and parameter gradients of sum(out_i * cotangent_i)."""
    rngs = {"dropout": jax.random.key(3)}

    def loss(params):
        outs = module.apply({"params": params}, *args, deterministic=deterministic, rngs=rngs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cotangents)), outs

    with pytest.MonkeyPatch.context() as mp:
        if replay is not None:
            mp.setattr(jax.random, "bernoulli", replay.jax_bernoulli)
        (_, outs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return outs, grads


def _port_grads_and_out(model, args, cotangents, replay, generator):
    with pytest.MonkeyPatch.context() as mp:
        if replay is not None:
            mp.setattr(attention, "draw_keep", replay.port_draw_keep)
        kwargs = {} if generator is None else {"generator": generator}
        outs = model(*(torch.from_numpy(a) for a in args), **kwargs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o * torch.from_numpy(np.asarray(c))).sum() for o, c in zip(outs, cotangents)).backward()
    return outs, {name: p.grad for name, p in model.named_parameters()}


def _compare(jax_module, port_model, args, seed, dropout):
    variables = jax.jit(jax_module.init)({"params": jax.random.key(seed), "dropout": jax.random.key(1)},
                                         *(jnp.asarray(a) for a in args))
    load_jax_variables(port_model, variables)
    rng = np.random.default_rng(seed + 100)
    probe = jax.eval_shape(lambda v: jax_module.apply(v, *(jnp.asarray(a) for a in args)), variables)
    probe = probe if isinstance(probe, tuple) else (probe,)
    cotangents = [rng.normal(size=np.shape(o)).astype(np.float32) for o in probe]
    replay = MaskReplay(seed + 200, 1.0 - RATE) if dropout else None
    want, want_grads = _jax_grads_and_out(jax_module, variables, [jnp.asarray(a) for a in args], cotangents,
                                          replay, deterministic=not dropout)
    generator = torch.Generator().manual_seed(0) if dropout else None
    got, got_grads = _port_grads_and_out(port_model, args, cotangents, replay, generator)
    if dropout:
        assert replay.port_shapes == replay.jax_shapes and len(replay.masks) > 0
        assert any(not m.all() for m in replay.masks)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, name=f"output {i}")
    for name, grad in from_jax_variables({"params": want_grads}, got_grads.keys()).items():
        assert_close(got_grads[name], grad, name=f"grad {name}")
    return replay


@pytest.mark.parametrize("activation_fn,parallel,dropout", [
    ("ReLU", False, False), ("GELU", True, False), ("LeakyReLU", False, True), ("ReLU", True, True)])
def test_rpe_conditional_transformer(activation_fn, parallel, dropout):
    args = _inputs()
    rate = RATE if dropout else None
    jax_module = jax_attention.RPEConditionalTransformer(BLOCKS, D, HEADS, activation_fn, parallel, rate)
    port = attention.RPEConditionalTransformer(BLOCKS, D, HEADS, activation_fn, parallel, rate)
    replay = _compare(jax_module, port, args, seed=1, dropout=dropout)
    if dropout:  # three sites a layer, two clouds, four layers
        assert len(replay.port_shapes) == 3 * 2 * len(BLOCKS)


def test_dropout_draws_only_with_a_generator():
    feats0, feats1, emb0, emb1, masks0, masks1 = (torch.from_numpy(a) for a in _inputs())
    port = attention.RPEConditionalTransformer(BLOCKS, D, HEADS, dropout=RATE)
    plain = attention.RPEConditionalTransformer(BLOCKS, D, HEADS)
    plain.load_state_dict(port.state_dict())
    with torch.no_grad():
        a = port(feats0, feats1, emb0, emb1, masks0, masks1)
        b = plain(feats0, feats1, emb0, emb1, masks0, masks1)
        c = port(feats0, feats1, emb0, emb1, masks0, masks1, generator=torch.Generator().manual_seed(0))
        d = port(feats0, feats1, emb0, emb1, masks0, masks1, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    assert not torch.allclose(a[0], c[0])


@pytest.mark.parametrize("dropout", [False, True])
def test_transformer_encoder_and_decoder(dropout):
    feats0, feats1, _, _, masks0, masks1 = _inputs(2)
    rate = RATE if dropout else None
    _compare(jax_attention.TransformerEncoder(2, D, HEADS, "ReLU", rate),
             attention.TransformerEncoder(2, D, HEADS, "ReLU", rate), (feats0, masks0), seed=2, dropout=dropout)
    _compare(jax_attention.TransformerDecoder(2, D, HEADS, "GELU", rate),
             attention.TransformerDecoder(2, D, HEADS, "GELU", rate), (feats0, feats1, masks0, masks1), seed=3,
             dropout=dropout)


def test_attention_with_key_weights_and_factors():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 12, D)).astype(np.float32)
    k = rng.normal(size=(2, 15, D)).astype(np.float32)
    weights = rng.uniform(0.2, 1.0, (2, 15)).astype(np.float32)
    factors = rng.uniform(0.5, 1.5, (2, 12, 15)).astype(np.float32)
    masks = rng.uniform(size=(2, 15)) < 0.8
    args = (q, k, k, weights, masks, factors)
    jax_mod = jax_attention.MultiHeadAttention(D, HEADS)
    variables = jax_mod.init(jax.random.key(4), *(jnp.asarray(a) for a in args))
    want = jax_mod.apply(variables, *(jnp.asarray(a) for a in args))
    port = load_jax_variables(attention.MultiHeadAttention(D, HEADS), variables)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    for g, w, name in zip(got, want, ("hidden", "scores")):
        assert_close(g, w, name=name)


def test_pe_conditional_transformer():
    feats0, feats1, _, _, masks0, masks1 = _inputs(5)
    rng = np.random.default_rng(5)
    pe0 = rng.normal(size=(1, N0, D)).astype(np.float32)
    pe1 = rng.normal(size=(1, N1, D)).astype(np.float32)
    jax_module = jax_attention.PEConditionalTransformer(BLOCKS, D, HEADS, "GELU")
    _compare(_Deterministic(jax_module), attention.PEConditionalTransformer(BLOCKS, D, HEADS, "GELU"),
             (feats0, feats1, pe0, pe1, masks0, masks1), seed=5, dropout=False)


def test_lrpe_conditional_transformer():
    feats0, feats1, _, _, masks0, masks1 = _inputs(6)
    rng = np.random.default_rng(6)
    # bins past the table's end are clamped to its last row
    idx0 = rng.integers(0, 40, (1, N0, N0)).astype(np.int32)
    idx1 = rng.integers(0, 40, (1, N1, N1)).astype(np.int32)
    jax_module = jax_attention.LRPEConditionalTransformer(BLOCKS, D, HEADS, 32)
    _compare(_Deterministic(jax_module), attention.LRPEConditionalTransformer(BLOCKS, D, HEADS, 32),
             (feats0, feats1, idx0, idx1, masks0, masks1), seed=6, dropout=False)


def test_vanilla_conditional_transformer():
    feats0, feats1, _, _, masks0, masks1 = _inputs(7)
    _compare(_Deterministic(jax_attention.VanillaConditionalTransformer(BLOCKS, D, HEADS)),
             attention.VanillaConditionalTransformer(BLOCKS, D, HEADS), (feats0, feats1, masks0, masks1), seed=7,
             dropout=False)


def test_unknown_block_type_raises():
    with pytest.raises(ValueError):
        attention.RPEConditionalTransformer(("self", "sideways"), D, HEADS)


def test_learnable_positional_embedding():
    idx = np.random.default_rng(8).integers(0, 20, (3, 7)).astype(np.int32)
    jax_mod = JaxLearnablePE(16, D)
    variables = jax_mod.init(jax.random.key(8), jnp.asarray(idx))
    port = load_jax_variables(LearnablePositionalEmbedding(16, D), variables)
    assert_close(port(torch.from_numpy(idx)), jax_mod.apply(variables, jnp.asarray(idx)), name="embedding")


class _Deterministic:
    """A JAX module without a `deterministic` argument, called with one."""

    def __init__(self, module):
        self.module = module

    def init(self, rngs, *args):
        return self.module.init(rngs, *args)

    def apply(self, variables, *args, deterministic=True, rngs=None):
        return self.module.apply(variables, *args)


@pytest.mark.parametrize("name", sorted(jax_factory._ACT_REGISTRY))
def test_activation_registry(name):
    x = np.linspace(-4.0, 4.0, 101, dtype=np.float32)
    assert_close(factory.build_act_layer(name)(torch.from_numpy(x)), jax_factory.build_act_layer(name)(jnp.asarray(x)),
                 name=name)


@pytest.mark.parametrize("norm", ["GroupNorm", "LayerNorm", None])
def test_conv_block_1d(norm):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(40, 24)).astype(np.float32)
    masks = np.arange(40) < 33
    jax_mod = jax_factory.ConvBlock1d(32, norm=norm, act="LeakyReLU", group_norm=8)
    variables = jax_mod.init(jax.random.key(9), jnp.asarray(x), jnp.asarray(masks))
    want = np.asarray(jax_mod.apply(variables, jnp.asarray(x), jnp.asarray(masks)))
    port = load_jax_variables(factory.ConvBlock1d(24, 32, norm=norm, act="LeakyReLU", group_norm=8), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(masks))
    assert_close(got, want, name=str(norm))


def test_dropout_layer_factory():
    x = torch.ones(1000)
    assert torch.equal(factory.build_dropout_layer(None)(x, torch.Generator()), x)
    assert torch.equal(factory.build_dropout_layer(0.5)(x), x)
    y = factory.build_dropout_layer(0.5)(x, torch.Generator().manual_seed(0))
    assert set(y.unique().tolist()) == {0.0, 2.0} and 400 < int((y == 0).sum()) < 600
