"""PyTorch port vs JAX package: the model options no shipped configuration
sets, and the upstream-checkpoint converter.

* `reduction_a="mean"` (the structure embedding's own torch computation,
  no kernel) and `use_dustbin=True` (local-to-global registration), each
  alone and in the whole inference slice of a model that sets both,
  against the JAX package at the f32 scaled error 2e-5;
* `act_dtype="bfloat16"` in the backbone, against the JAX package's bf16
  activation path: each output level within 3e-2 of its largest magnitude
  and every valid row's cosine above 0.998 (both packages round to bf16 at
  their own places; one bf16 step is 2^-8 relative, and measured the two
  differ by up to 1.6e-2 and 0.9994, as close as the JAX bf16 path is to
  its own f32 path); one bf16 train step finite;
* attention dropout in a train step of the model (finite, a generator
  required);
* `utils/convert_checkpoint.py`: a whole tiny model's synthetic upstream
  state dict (with the DDP prefix and the recomputed `div_term` entries)
  converted by the port equals, key for key and bit for bit, the JAX
  converter's output carried into the port's names by `from_jax_variables`;
  the port model loaded from it agrees with the JAX model on the converted
  variables; the CLI checks the result against an experiment's model.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ref_geotransformer_tpu.data.pyramid import build_registration_inputs as jax_build_inputs
from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu.models import init_model_variables
from ref_geotransformer_tpu.models.embedding import GeometricStructureEmbedding as JaxEmbedding
from ref_geotransformer_tpu.models.registration import local_to_global_registration as jax_lgr
from ref_geotransformer_tpu.utils.convert_checkpoint import convert_state_dict as jax_convert_state_dict
from ref_geotransformer_tpu_torch.config.threedmatch import make_cfg as make_3dmatch_cfg
from ref_geotransformer_tpu_torch.demo import build_model
from ref_geotransformer_tpu_torch.engine.steps import train_step
from ref_geotransformer_tpu_torch.engine.state import TrainState
from ref_geotransformer_tpu_torch.models import embedding as port_embedding
from ref_geotransformer_tpu_torch.models.embedding import GeometricStructureEmbedding
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer, _stack_pair
from ref_geotransformer_tpu_torch.models.registration import local_to_global_registration
from ref_geotransformer_tpu_torch.utils import convert_checkpoint
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables, init_parameters, load_jax_variables
from tests.test_torch_port_model import _check_slice, _jax_backbone, _pyramid_args, surface_pair
from tests.test_torch_port_tools import surface_transform
from tests.torch_port_utils import assert_close, port_config, tiny4_config, to_np, to_torch

# the projections' gradients, relative to each one's largest magnitude: f32
# sums over 2 N^2 = 3200 entries in other orders (the JAX package averages
# k = 3 projections, the port projects one average); measured 1.6e-6
GRAD_BOUND = 1e-5
BF16_LEVEL_BOUND = 3e-2
BF16_COSINE_BOUND = 0.998


def variant_config(**backbone):
    cfg = tiny4_config()
    return cfg.replace(
        geotransformer=dataclasses.replace(cfg.geotransformer, reduction_a="mean"),
        fine_matching=dataclasses.replace(cfg.fine_matching, use_dustbin=True),
        backbone=dataclasses.replace(cfg.backbone, **backbone),
    )


@pytest.fixture(scope="module")
def variant_setup():
    """The JAX package's pyramid, variables and inference output of the
    variant model (mean angle reduction, dustbin LGR)."""
    cfg = variant_config()
    arrays = surface_pair(cfg)
    with jax.default_matmul_precision("highest"):
        data = jax.jit(lambda *a: jax_build_inputs(*a, *_pyramid_args(cfg), search_chunk=cfg.capacities.search_chunk))(
            *(jnp.array(a) for a in arrays))
        model = JaxGeoTransformer(cfg)
        variables = init_model_variables(model, cfg, jax.random.key(0))
        out = jax.device_get(jax.jit(model.apply)(variables, data))
    return cfg, jax.device_get(data), jax.device_get(variables), out


def upstream_state_dict(variables):
    """A synthetic upstream checkpoint of the model: upstream key names (the
    port's), the DDP prefix, and the sinusoidal embedding's div_term."""
    state = {"module." + key: value.numpy() for key, value in from_jax_variables(variables).items()}
    state["module.transformer.embedding.embedding.div_term"] = np.exp(
        np.arange(0, 48, 2, dtype=np.float32) * (-np.log(10000.0) / 48))
    return state


def test_converter_equals_the_jax_converter_bit_for_bit(variant_setup):
    _, _, variables, _ = variant_setup
    upstream = upstream_state_dict(variables)
    got, skipped = convert_checkpoint.convert_state_dict(upstream)
    want = from_jax_variables(jax_convert_state_dict(upstream))
    assert skipped == ["module.transformer.embedding.embedding.div_term"]
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == torch.float32, key
        assert torch.equal(got[key], want[key]), key
    assert "backbone.encoder1_1.norm.norm.weight" in got


def test_converted_variant_model_matches_jax(variant_setup):
    """The whole inference slice of the variant model, its weights from the
    port's converter, against the JAX model on the JAX converter's variables."""
    cfg, data, variables, want = variant_setup
    state, _ = convert_checkpoint.convert_state_dict(upstream_state_dict(variables))
    model = GeoTransformer(port_config(cfg))
    model.load_state_dict(state, strict=True)
    got = model(to_torch(data))
    assert got["matching_scores"].shape[1] == cfg.model.num_points_in_patch + 1  # the dustbin row
    assert int(to_np(got["corr_masks"]).sum()) > 0
    _check_slice(got, want)


def test_converter_cli_checks_the_experiment_model(tmp_path):
    cfg = make_3dmatch_cfg()
    source = init_parameters(GeoTransformer(cfg), torch.Generator().manual_seed(1))
    upstream = {"module." + key: value for key, value in source.state_dict().items()}
    upstream["module.transformer.embedding.embedding.div_term"] = torch.zeros(128)
    torch.save({"model": upstream}, tmp_path / "epoch-7.pth.tar")
    path = convert_checkpoint.main([str(tmp_path / "epoch-7.pth.tar"), str(tmp_path / "out"), "--experiment",
                                    "3dmatch"])
    assert path == str(tmp_path / "out" / "epoch-7.pth.tar")
    loaded = build_model(cfg, torch.device("cpu"), seed=2, snapshot=path)
    assert all(torch.equal(value, source.state_dict()[key]) for key, value in loaded.state_dict().items())

    del upstream["module.transformer.in_proj.bias"]
    upstream["module.transformer.out_proj.weight"] = torch.zeros(3, 3)
    upstream["module.backbone.extra.weight"] = torch.zeros(1)
    torch.save({"model": upstream}, tmp_path / "bad.pth.tar")
    with pytest.raises(SystemExit) as info:
        convert_checkpoint.main([str(tmp_path / "bad.pth.tar"), str(tmp_path / "out"), "--experiment", "3dmatch"])
    message = str(info.value)
    for needle in ("missing from checkpoint: transformer.in_proj.bias", "not in this model: backbone.extra.weight",
                   "shape mismatch at transformer.out_proj.weight"):
        assert needle in message
    assert not (tmp_path / "out" / "bad.pth.tar").exists()


@pytest.mark.parametrize("chunk_entries", [None, 5000])
def test_mean_embedding_and_its_gradients(chunk_entries, monkeypatch):
    """The mean-reduced embedding and the gradients of its projections; with
    a small chunk the rows are made in many chunks (the last one ragged).
    The cotangent is zero on the diagonal (i == j): there the JAX package's
    distance sqrt(|p|^2 - 2 p.p + |p|^2) is exactly 0 only where XLA fuses
    the form (its jitted forward), and the gradient program fuses it
    otherwise, leaving sqrt(rounding residual) ~ 1e-3 (the port takes the
    distance of p_j - p_i, models/cuda_kernels.py::embedding_indices)."""
    if chunk_entries is not None:
        monkeypatch.setattr(port_embedding, "_MEAN_CHUNK_ENTRIES", chunk_entries)
    rng = np.random.default_rng(11)
    n, c = 40, 32
    points = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    masks = np.arange(n)[None].repeat(2, 0) < np.array([[33], [40]])
    cot = rng.normal(size=(2, n, n, c)).astype(np.float32)
    cot[:, np.arange(n), np.arange(n)] = 0.0
    jax_mod = JaxEmbedding(c, 0.2, 15.0, 3, "mean", use_pallas=False)
    variables = jax_mod.init(jax.random.key(11), jnp.asarray(points), jnp.asarray(masks))

    def loss(params):
        out = jax_mod.apply({"params": params}, jnp.asarray(points), jnp.asarray(masks))
        return jnp.sum(out * cot), out

    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax_mod.apply)(variables, jnp.asarray(points), jnp.asarray(masks))
        grads = jax.jit(jax.grad(lambda p: loss(p)[0]))(variables["params"])
    module = GeometricStructureEmbedding(c, 0.2, 15.0, 3, "mean")
    module.load_state_dict(from_jax_variables({"params": variables["params"]}), strict=True)
    got = module(torch.from_numpy(points), torch.from_numpy(masks))
    (got * torch.from_numpy(cot)).sum().backward()
    assert_close(got, want, name="embedding")
    for key, grad in from_jax_variables({"params": grads}).items():
        err = float((dict(module.named_parameters())[key].grad - grad).abs().max() / grad.abs().max())
        assert err <= GRAD_BOUND, f"{key}: {err:.3e} of the largest magnitude"


def test_unknown_angle_reduction_raises():
    with pytest.raises(ValueError):
        GeometricStructureEmbedding(32, 0.2, 15.0, 3, "median")(torch.zeros(1, 8, 3))


@pytest.mark.parametrize("mutual", [True, False])
def test_dustbin_local_to_global_registration(mutual):
    rng = np.random.default_rng(12)
    p, k = 24, 16
    ref_pts = rng.uniform(-1, 1, (p, k, 3)).astype(np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    src_pts = ((ref_pts - 0.1) @ rot + rng.normal(0, 0.01, ref_pts.shape)).astype(np.float32)
    ref_m = rng.uniform(size=(p, k)) < 0.9
    src_m = rng.uniform(size=(p, k)) < 0.9
    # a heavy dustbin column on some rows, so selecting with it present
    # suppresses cells that selecting without it would keep
    logits = rng.normal(size=(p, k + 1, k + 1)).astype(np.float32) + 6.0 * np.pad(np.eye(k), ((0, 1), (0, 1)))
    logits[:, : k // 2, k] += 7.0
    scores = (logits - np.log(np.exp(logits).sum(axis=(1, 2), keepdims=True))).astype(np.float32)
    node_scores = rng.uniform(size=(p,)).astype(np.float32)
    args = (ref_pts, src_pts, ref_m, src_m, scores, node_scores)
    kw = dict(k=1, acceptance_radius=0.1, mutual=mutual, confidence_threshold=0.001, correspondence_limit=600,
              num_refinement_steps=5)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda *a: jax_lgr(*a, use_dustbin=True, **kw))(*(jnp.array(a) for a in args))
        without = jax.jit(lambda *a: jax_lgr(*a, use_dustbin=False, **kw))(*(jnp.array(a) for a in args))
    got = local_to_global_registration(*(torch.from_numpy(a) for a in args), use_dustbin=True, **kw)
    valid = np.asarray(want.corr_masks)
    assert valid.sum() > 20
    if mutual:  # the dustbin suppressed cells (without mutuality the column picks keep as many)
        assert valid.sum() < np.asarray(without.corr_masks).sum()
    np.testing.assert_array_equal(to_np(got.corr_masks), valid)
    assert_close(got.corr_scores, want.corr_scores, name="corr_scores")
    assert_close(to_np(got.ref_corr_points)[valid], np.asarray(want.ref_corr_points)[valid], name="ref_corr_points")
    assert_close(to_np(got.src_corr_points)[valid], np.asarray(want.src_corr_points)[valid], name="src_corr_points")
    assert float(np.abs(to_np(got.estimated_transform) - np.asarray(want.estimated_transform)).max()) <= 1e-4


def _cosines(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    norms = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    keep = norms > 0
    return np.sum(a * b, axis=1)[keep] / norms[keep]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bf16_activation_backbone(variant_setup, dtype):
    """act_dtype bf16 with bf16 contractions (dtype bf16) or f32 ones."""
    cfg, data, variables, _ = variant_setup
    cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone, dtype=dtype, act_dtype="bfloat16"))
    want = _jax_backbone(cfg, variables, data, dtype, act_dtype="bfloat16")
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    inner = []
    hooks = [model.backbone.get_submodule(name).register_forward_hook(lambda m, i, o: inner.append(o.dtype))
             for name in ("encoder1_1", "encoder2_1", "encoder4_3", "decoder3", "decoder2")]
    tdata = to_torch(data)
    with torch.no_grad():
        got = model.backbone(torch.stack([tdata["ref_feats"], tdata["src_feats"]]), _stack_pair(tdata["ref"], tdata["src"]))
    for hook in hooks:
        hook.remove()
    assert inner == [torch.bfloat16] * 5
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        g, w = to_np(g).astype(np.float64), np.asarray(w, np.float64)
        err = float(np.abs(g - w).max() / np.abs(w).max())
        cos = float(_cosines(g, w).min())
        assert err <= BF16_LEVEL_BOUND, f"level {level}: {err:.3e} of the largest magnitude"
        assert cos >= BF16_COSINE_BOUND, f"level {level}: cosine {cos:.5f}"


def _train_pair(cfg):
    arrays = surface_pair(cfg)
    pair = {key: torch.from_numpy(a) for key, a in zip(("ref_points", "ref_masks", "src_points", "src_masks"), arrays)}
    pair["transform"] = torch.from_numpy(surface_transform())
    return pair


@pytest.mark.parametrize("act_dtype,dropout", [("bfloat16", None), ("float32", 0.1)])
def test_variant_train_step(act_dtype, dropout):
    """One train step of the variant model: bf16 activations, or attention
    dropout drawn from the step's generator; finite and applied."""
    cfg = port_config(variant_config(dtype="bfloat16", act_dtype=act_dtype))
    model = init_parameters(GeoTransformer(cfg, dropout=dropout), torch.Generator().manual_seed(3))
    state = TrainState(model, cfg.optim, 1)
    pair = _train_pair(cfg)
    losses = train_step(model, state, pair, torch.Generator().manual_seed(4))
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert state.count == 1 and state.skipped == 0
    if dropout:
        with pytest.raises(ValueError):
            model(build_inputs(cfg, pair), training=True)


def build_inputs(cfg, pair):
    from ref_geotransformer_tpu_torch.engine.steps import ensure_pyramids

    return ensure_pyramids(cfg, pair)
