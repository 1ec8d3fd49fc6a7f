"""PyTorch port: Cordi (models/cordi.py), its DDPM trainer, `train_cordi` and
the Cordi half of the LineMod test, against the JAX package.

* the model at tests/test_cordi.py's tiny size, weights through the bridge
  (perturbed, so no bias or norm sits at its initial value): the variance
  schedule exactly, the time embedding, one denoiser application, the
  epsilon-loss at the (t, e_rand) that `Cordi.get_loss` draws from its key,
  every parameter's gradient and a 10-step reverse diffusion on pinned zs;
* `cordi_downsample` on a JAX encoder output with JAX's uniform keys,
  exactly, once with fewer valid nodes than samples (the -1 ties);
  `get_corr_from_matrix_topk` on tied cells; the two numpy helpers of
  `bop_utils` and `evaluate_ddpm`;
* the DDPM trainer's 3 iterations against `IterBasedDDPMTrainer` on the tiny
  LineMod encoder, the same frames, weights and replayed draws; a resumed
  run against an uninterrupted one; `train_cordi` then `test
  --cordi_snapshot` in process.

The JAX side runs at `jax.default_matmul_precision("highest")`.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ref_geotransformer_tpu.data import PairLoader as JaxPairLoader
from ref_geotransformer_tpu.data.datasets import bop_utils as jax_bop_utils
from ref_geotransformer_tpu.data.datasets.linemod import LMODataset as JaxLMODataset
from ref_geotransformer_tpu.engine import iter_trainer as jax_iter_trainer
from ref_geotransformer_tpu.engine.state import TrainState as JaxTrainState
from ref_geotransformer_tpu.engine.state import guard_nonfinite
from ref_geotransformer_tpu.engine.steps import make_forward_fn
from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu.models import cordi as jax_cordi
from ref_geotransformer_tpu.models import init_model_variables
from ref_geotransformer_tpu_torch.config import DDPMConfig
from ref_geotransformer_tpu_torch.data import PairLoader
from ref_geotransformer_tpu_torch.data.datasets import bop_utils
from ref_geotransformer_tpu_torch.data.datasets.linemod import LMODataset
from ref_geotransformer_tpu_torch.engine import iter_trainer
from ref_geotransformer_tpu_torch.engine.iter_trainer import IterBasedDDPMTrainer, make_warmup_cosine_schedule
from ref_geotransformer_tpu_torch.engine.state import AdamWTrainState
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import config as exp_config
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import test as exp_test
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import train_cordi
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import trainval_encoder
from ref_geotransformer_tpu_torch.models import cordi
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.utils.weights import init_parameters, jax_gradients_by_name, load_jax_variables
from tests.test_torch_port_iter_trainer import (  # noqa: F401 (fixtures)
    TINY_OPTIM,
    _lmo,
    _schedule_args,
    experiment_env,
    linemod_root,
    tiny_linemod_config,
)
from tests.torch_port_utils import port_config, scaled_error, to_torch

TINY = dict(ref_sample_num=8, src_sample_num=12, num_steps=10, time_emb_dim=32, n_layers=2, n_heads=2,
            query_dimensions=8, feed_forward_dimensions=32)  # tests/test_cordi.py:16-26
BATCH = 2
EMBED_ATOL = 1e-6
DENOISER_BOUND = 2e-5  # scaled error (tests/torch_port_utils.py)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3  # of each gradient's largest magnitude
SAMPLE_BOUND = 1e-4  # scaled error after 10 reverse steps
TRAINER_LOSS_RTOL = 1e-4
ITERATIONS = 3
# the trainer's Cordi: the tiny widths, d_model 2 * 64 = 128 to take the tiny
# encoder's (output_dim 64) context
TRAINER_DDPM = dict(TINY, query_dimensions=64)


def _perturbed(variables, seed):
    """Flax variables with every leaf moved by N(0, 0.05^2): biases and norms
    leave their initial 0 and 1, so the bridge's mapping of each shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: (np.asarray(p) + 0.05 * rng.normal(size=p.shape)).astype(np.float32),
                                  jax.device_get(variables))


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    x0 = rng.choice([-1.0, 1.0], size=(BATCH, TINY["ref_sample_num"], TINY["src_sample_num"])).astype(np.float32)
    ctx = rng.normal(size=x0.shape + (2 * TINY["query_dimensions"],)).astype(np.float32)
    model = jax_cordi.Cordi(**TINY)
    variables = _perturbed(model.init(jax.random.key(0), x0, ctx), 1)
    port = load_jax_variables(cordi.Cordi(**TINY), variables)
    return model, variables, port, x0, ctx


def _jax_apply(model, variables, fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.device_get(model.apply(variables, *args, method=fn))


@pytest.mark.parametrize("num_steps", [10, 100])
def test_variance_schedule_equals_jax(num_steps):
    ours, theirs = cordi.VarianceSchedule(num_steps, 1e-4, 0.02), jax_cordi.VarianceSchedule(num_steps, 1e-4, 0.02)
    for name in ("betas", "alphas", "alpha_bars", "sigmas_flex", "sigmas_inflex"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)), err_msg=name)
    for flexibility in (0.0, 0.3):
        t = torch.arange(num_steps + 1)
        np.testing.assert_array_equal(ours.get_sigmas(t, flexibility).numpy(),
                                      np.asarray(theirs.get_sigmas(jnp.arange(num_steps + 1), flexibility)))


def test_time_embedding_matches_jax():
    """dim 32 (frequencies over half - 1 = 15), every step of the tiny chain."""
    t = np.arange(TINY["num_steps"], dtype=np.int32)
    want = jax.device_get(jax_cordi.SinusoidalTimeEmbedding(TINY["time_emb_dim"]).apply({}, t))
    got = cordi.SinusoidalTimeEmbedding(TINY["time_emb_dim"])(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_ATOL)


def test_bridge_loads_every_cordi_variable(tiny):
    """The strict load succeeded; the attention kernels (D, H, Dh) and
    (H, Dh, D) became (D, D) weights whose rows run heads major."""
    _, variables, port, _, _ = tiny
    attn = variables["params"]["net"]["layers_0"]["self_attn"]
    d = port.net.d_model
    assert attn["query"]["kernel"].shape == (d, TINY["n_heads"], TINY["query_dimensions"])
    assert attn["out"]["kernel"].shape == (TINY["n_heads"], TINY["query_dimensions"], d)
    layer = port.net.layers[0].self_attn
    np.testing.assert_array_equal(layer.query.weight.detach().numpy()[9], attn["query"]["kernel"][:, 1, 1])
    np.testing.assert_array_equal(layer.query.bias.detach().numpy()[9], attn["query"]["bias"][1, 1])
    np.testing.assert_array_equal(layer.out.weight.detach().numpy()[:, 9], attn["out"]["kernel"][1, 1])
    assert not any(name.startswith("var_sched") for name in port.state_dict())


@pytest.mark.parametrize("steps", [(0, 0), (3, 7)])
def test_denoiser_matches_jax(tiny, steps):
    """One application of the denoiser (time MLP, 2 post-LN layers, output
    MLP) at the given steps, x_t a noised matrix."""
    model, variables, port, x0, ctx = tiny
    x_t = (0.8 * x0 + 0.6 * np.random.default_rng(2).normal(size=x0.shape)).astype(np.float32)
    t = np.asarray(steps, np.int32)
    want = _jax_apply(model, variables, lambda m, x, tt, c: m.net(x, m._time_token(tt), c), x_t, t, ctx)
    got = port.denoise(torch.from_numpy(x_t), torch.from_numpy(t).long(), torch.from_numpy(ctx))
    err = scaled_error(got, want)
    print(f"denoiser at t = {steps}: scaled error {err:.2e} (bound {DENOISER_BOUND:.0e})")
    assert err <= DENOISER_BOUND
    if steps == (0, 0):
        assert scaled_error(port(torch.from_numpy(x_t), torch.from_numpy(ctx)), want) <= DENOISER_BOUND


def _loss_noise(key, x0, num_steps):
    """The (t, e_rand) that `Cordi.get_loss` draws from `key`."""
    t_rng, e_rng = jax.random.split(key)
    return (jax.random.randint(t_rng, (x0.shape[0],), 0, num_steps), jax.random.normal(e_rng, x0.shape))


def test_loss_matches_jax(tiny):
    model, variables, port, x0, ctx = tiny
    key = jax.random.key(1)
    t, e_rand = _loss_noise(key, x0, TINY["num_steps"])
    want = float(_jax_apply(model, variables, jax_cordi.Cordi.get_loss, x0, ctx, key))
    pinned = float(_jax_apply(model, variables, lambda m, x, c: jax_cordi.ddpm_loss(
        m.var_sched, lambda xx, tt: m.net(xx, m._time_token(tt), c), x, t, e_rand), x0, ctx))
    assert pinned == want  # the noise drawn here is get_loss's own
    with torch.no_grad():
        got = float(port.loss(torch.from_numpy(x0), torch.from_numpy(ctx), torch.from_numpy(np.array(t)).long(),
                              torch.from_numpy(np.array(e_rand))))
    print(f"loss {got:.7f} vs JAX {want:.7f}: relative {abs(got - want) / want:.2e} (bound {LOSS_RTOL:.0e})")
    assert abs(got - want) <= LOSS_RTOL * abs(want)


def test_gradients_match_jax(tiny):
    """Every parameter's gradient of the loss at get_loss's noise, to 1e-3 of
    its largest magnitude. The key biases' gradients are analytically zero
    (a constant added to every key shifts each query's scores by one
    constant, which the softmax cancels) and hold rounding noise only: they
    are held to 1e-3 of their layer's key-weight gradient."""
    model, variables, port, x0, ctx = tiny
    key = jax.random.key(1)
    with jax.default_matmul_precision("highest"):
        grads = jax.device_get(jax.grad(lambda p: model.apply({"params": p}, x0, ctx, key,
                                                              method=jax_cordi.Cordi.get_loss))(variables["params"]))
    t, e_rand = _loss_noise(key, x0, TINY["num_steps"])
    port.zero_grad()
    port.loss(torch.from_numpy(x0), torch.from_numpy(ctx), torch.from_numpy(np.array(t)).long(),
              torch.from_numpy(np.array(e_rand))).backward()
    want = jax_gradients_by_name(grads)
    worst = 0.0
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        scale = float(want[name.replace("key.bias", "key.weight")].abs().max())
        assert scale > 0, name
        err = float((p.grad - want[name]).abs().max()) / scale
        worst = max(worst, err)
        assert err <= GRAD_RTOL, f"{name}: {err:.2e} of its magnitude"
    print(f"{len(named)} gradients, largest error {worst:.2e} of the magnitude (bound {GRAD_RTOL:.0e})")


def test_sample_matches_jax(tiny):
    """10 reverse steps from the +-1 matrix on the zs that Cordi.sample draws."""
    model, variables, port, x0, ctx = tiny
    key = jax.random.key(2)
    want = _jax_apply(model, variables, jax_cordi.Cordi.sample, x0, ctx, key)
    zs = np.array(jax.random.normal(key, (TINY["num_steps"],) + x0.shape))
    with torch.no_grad():
        got = port.reverse(torch.from_numpy(x0), torch.from_numpy(ctx), torch.from_numpy(zs))
    err = scaled_error(got, want)
    print(f"10-step sample: scaled error {err:.2e} (bound {SAMPLE_BOUND:.0e}); |x_0| up to {np.abs(want).max():.2f}")
    assert err <= SAMPLE_BOUND
    # the last step adds no noise: its zs entry is ignored
    zs[-1] = 1e3
    with torch.no_grad():
        assert torch.equal(port.reverse(torch.from_numpy(x0), torch.from_numpy(ctx), torch.from_numpy(zs)), got)


def test_draws_come_from_the_generator(tiny):
    _, _, port, x0, ctx = tiny
    x0, ctx = torch.from_numpy(x0), torch.from_numpy(ctx)
    with torch.no_grad():
        losses = [float(port.get_loss(x0, ctx, torch.Generator().manual_seed(s))) for s in (4, 4, 5)]
    assert losses[0] == losses[1] != losses[2] and np.isfinite(losses).all()
    with torch.no_grad():
        out = port.sample(x0, ctx, torch.Generator().manual_seed(4))
    assert out.shape == x0.shape and bool(torch.isfinite(out).all())


def test_init_parameters_seeds_cordi():
    """Linear weights N(0, 1/fan_in) from the generator, biases zero, norms
    at identity, as for the encoder; the same seed, the same weights."""
    a, b, c = (init_parameters(cordi.Cordi(**TINY), torch.Generator().manual_seed(s)).state_dict() for s in (3, 3, 4))
    assert set(a) == set(dict(cordi.Cordi(**TINY).named_parameters()))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["net.layers.0.self_attn.query.weight"], c["net.layers.0.self_attn.query.weight"])
    assert float(a["net.layers.1.linear1.bias"].abs().max()) == 0.0
    assert torch.equal(a["net.out_norm.weight"], torch.ones(2 * TINY["query_dimensions"]))
    std = float(a["net.layers.0.linear1.weight"].std())
    assert abs(std * np.sqrt(2 * TINY["query_dimensions"]) - 1.0) < 0.2


# ---------------------------------------------------------------------------
# Downsampling, selection and the numpy helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoder_setup(linemod_root):
    """The tiny LineMod encoder (JAX weights), the JAX trainer's frames and
    the JAX inference forward of the first one."""
    jcfg = tiny_linemod_config(**{**TINY_OPTIM, "lr": 1e-3})
    variables = jax.device_get(init_model_variables(JaxGeoTransformer(jcfg), jcfg, jax.random.key(jcfg.seed)))
    pair, _ = next(JaxPairLoader(_lmo(JaxLMODataset, linemod_root, jcfg), jcfg).iter_single())
    with jax.default_matmul_precision("highest"):
        output = jax.device_get(make_forward_fn(JaxGeoTransformer(jcfg), jcfg)(variables["params"],
                                                                             variables["buffers"], pair))
    return jcfg, variables, output


def _downsample_case(output, case):
    """The encoder output, or (`few_valid`) the same with 3 ref and 5 src
    nodes left valid, fewer than the 8 and 12 sampled: ref nodes with a
    ground-truth overlap and src nodes they overlap."""
    output = dict(output)
    if case == "few_valid":
        gt = np.asarray(output["gt_node_overlap_map"]) > 0
        rows = np.flatnonzero(gt.any(1) & np.asarray(output["ref_node_masks"]))[:3]
        cols = np.flatnonzero(gt[rows].any(0) & np.asarray(output["src_node_masks"]))[:5]
        for side, keep in (("ref", rows), ("src", cols)):
            masks = np.zeros_like(np.asarray(output[f"{side}_node_masks"]))
            masks[keep] = True
            output[f"{side}_node_masks"] = masks
    return output


@pytest.mark.parametrize("case", ["encoder", "few_valid"])
def test_cordi_downsample_equals_jax(encoder_setup, case):
    """Same encoder output and uniform keys: the sampled points, features,
    +-1 matrices and context, exactly."""
    _, _, output = encoder_setup
    output = _downsample_case(output, case)
    r, s = TINY["ref_sample_num"], TINY["src_sample_num"]
    key = jax.random.key(9)
    want = jax.device_get(jax_cordi.cordi_downsample(key, jax.tree_util.tree_map(jnp.asarray, output), r, s))
    ref_rng, src_rng = jax.random.split(key)
    m, n = len(output["ref_node_masks"]), len(output["src_node_masks"])
    keys = [torch.from_numpy(np.array(jax.random.uniform(k, (size,)))) for k, size in ((ref_rng, m), (src_rng, n))]
    got = cordi.cordi_downsample(to_torch(output), r, s, *keys)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
    valid = int(np.asarray(output["ref_node_masks"]).sum())
    print(f"{case}: {valid} valid ref nodes of {m}, {int((want['gt_corr_matrix'] == 1).sum())} gt and "
          f"{int((want['init_corr_matrix'] == 1).sum())} init cells of {r * s}")
    if case == "few_valid":
        assert valid < r and (want["gt_corr_matrix"] == 1).sum() > 0


def test_top_k_breaks_ties_as_lax_top_k():
    """On 256 keys, -1 except at 3 nodes, `torch.topk` orders the tied tail
    otherwise; the port's selection gives lax.top_k's indices."""
    keys = -np.ones(256, np.float32)
    keys[[90, 5, 200]] = [0.9, 0.8, 0.7]
    want = np.asarray(jax.lax.top_k(jnp.asarray(keys), 80)[1])
    np.testing.assert_array_equal(cordi.top_k_indices(torch.from_numpy(keys), 80).numpy(), want)
    np.testing.assert_array_equal(want[:6], [90, 5, 200, 0, 1, 2])


@pytest.mark.parametrize("kind", ["signed", "scores"])
def test_get_corr_from_matrix_topk_equals_jax(kind):
    rng = np.random.default_rng(3)
    matrix = (rng.choice([-1.0, 1.0], size=(8, 12)) if kind == "signed" else rng.normal(size=(8, 12)))
    matrix = matrix.astype(np.float32)
    want = jax.device_get(jax_cordi.get_corr_from_matrix_topk(jnp.asarray(matrix), 16))
    got = cordi.get_corr_from_matrix_topk(torch.from_numpy(matrix), 16)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)


def test_bop_corr_helpers_equal_jax():
    rng = np.random.default_rng(5)
    ref = rng.uniform(size=(40, 3))
    src = rng.uniform(size=(50, 3))
    transform = np.eye(4)
    transform[:3, 3] = [0.01, -0.02, 0.03]
    want = jax_bop_utils.build_corr_matrix(ref, src, transform, 0.15)
    got = bop_utils.build_corr_matrix(ref, src, transform, 0.15)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and 0 < (got == 1).sum() < got.size
    for a, b in zip(bop_utils.get_corr_from_matrix_topk_np(got, 12), jax_bop_utils.get_corr_from_matrix_topk_np(want, 12)):
        np.testing.assert_array_equal(a, b)


def test_evaluate_ddpm_equals_jax():
    rng = np.random.default_rng(6)
    pred = rng.normal(size=(40, 80)).astype(np.float32)
    gt = rng.choice([-1.0, 1.0], size=(40, 80)).astype(np.float32)
    init = rng.choice([-1.0, 1.0], p=[0.98, 0.02], size=(40, 80)).astype(np.float32)
    assert iter_trainer.evaluate_ddpm(pred, gt, init) == jax_iter_trainer.evaluate_ddpm(pred, gt, init)
    assert iter_trainer.evaluate_ddpm(pred, gt, -np.ones_like(init))["IIR"] == 0.0


# ---------------------------------------------------------------------------
# The DDPM trainer against the JAX trainer
# ---------------------------------------------------------------------------

class JaxDraws:
    """The JAX DDPM trainer's draws, replayed through the port trainer's
    seam: its key chain from key(seed), split as the JAX trainer splits it
    for each pair's node keys and each step's (t, e_rand)."""

    def __init__(self, seed: int, num_steps: int):
        self.rng = jax.random.key(seed)
        self.num_steps = num_steps

    def node_keys(self, output):
        self.rng, d_rng = jax.random.split(self.rng)
        keys = zip(jax.random.split(d_rng), (output["ref_node_masks"], output["src_node_masks"]))
        return tuple(torch.from_numpy(np.array(jax.random.uniform(k, masks.shape))) for k, masks in keys)

    def loss_noise(self, model, x_0):
        self.rng, step_rng = jax.random.split(self.rng)
        t, e_rand = _loss_noise(step_rng, np.zeros(tuple(x_0.shape), np.float32), self.num_steps)
        return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(e_rand))


def _jax_ddpm_run(jcfg, root, encoder_vars, cordi_vars, snapshot_dir):
    """ITERATIONS iterations of the JAX DDPM trainer; returns its losses and
    the downsampled dicts it trained on."""
    loader = JaxPairLoader(_lmo(JaxLMODataset, root, jcfg), jcfg, batch_size=1, shuffle=True, seed=jcfg.seed)
    model = jax_cordi.Cordi(**TRAINER_DDPM)
    schedule = jax_iter_trainer.make_warmup_cosine_schedule(*_schedule_args(jcfg))
    tx = guard_nonfinite(optax.adamw(schedule, weight_decay=jcfg.optim.weight_decay))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=cordi_vars["params"], buffers={},
                          opt_state=tx.init(cordi_vars["params"]), tx=tx)
    trainer = jax_iter_trainer.IterBasedDDPMTrainer(
        jcfg, JaxGeoTransformer(jcfg), encoder_vars["params"], encoder_vars["buffers"], model, state, schedule,
        loader, None, max_iteration=ITERATIONS, snapshot_steps=1000, snapshot_dir=snapshot_dir, log_steps=1,
        seed=jcfg.seed)
    losses, latents, encode, step = [], [], trainer._encode, trainer._step

    def recording_encode(pair, rng):
        d = encode(pair, rng)
        latents.append(jax.device_get(d))
        return d

    def recording_step(s, x0, ctx, rng):
        s, loss = step(s, x0, ctx, rng)
        losses.append(float(loss))
        return s, loss

    trainer._encode, trainer._step = recording_encode, recording_step
    with jax.default_matmul_precision("highest"):
        trainer.run()
    return losses, latents, int(trainer.state.step)


def test_ddpm_trainer_matches_jax(encoder_setup, linemod_root, tmp_path):
    """The port's trainer from the JAX trainer's encoder and Cordi weights, on
    the same frames, with the JAX trainer's draws replayed: the same
    downsampled matrices, and losses within 1e-4 relative (the second and
    third after AdamW updates at lr 1e-3 under decay 1.0). The context
    features are printed: on one of these frames the two encoders' forwards
    differ by ~1e-4, the LineMod near-tie of patch membership that
    tests/test_torch_port_iter_trainer.py describes."""
    jcfg, encoder_vars, _ = encoder_setup
    cfg = port_config(jcfg)
    d = 2 * jcfg.geotransformer.output_dim
    x0 = np.zeros((1, TRAINER_DDPM["ref_sample_num"], TRAINER_DDPM["src_sample_num"]), np.float32)
    cordi_vars = _perturbed(jax_cordi.Cordi(**TRAINER_DDPM).init(jax.random.key(3), x0, np.zeros(x0.shape + (d,),
                                                                                                np.float32)), 4)
    want, jax_latents, jax_step = _jax_ddpm_run(jcfg, linemod_root, encoder_vars, cordi_vars, str(tmp_path / "jax"))

    loader = PairLoader(_lmo(LMODataset, linemod_root, cfg), cfg, batch_size=1, shuffle=True, seed=cfg.seed)
    model = load_jax_variables(cordi.Cordi(**TRAINER_DDPM), cordi_vars)
    trainer = IterBasedDDPMTrainer(
        cfg, load_jax_variables(GeoTransformer(cfg), encoder_vars), model,
        AdamWTrainState(model, cfg.optim, make_warmup_cosine_schedule(*_schedule_args(cfg))), loader,
        max_iteration=ITERATIONS, snapshot_steps=1000, snapshot_dir=str(tmp_path / "port"), log_steps=1,
        seed=cfg.seed)
    trainer.draws = JaxDraws(cfg.seed, TRAINER_DDPM["num_steps"])
    encoder_before = {k: v.clone() for k, v in trainer.encoder.state_dict().items()}
    got, latents = [], []
    encode, step = iter_trainer.encode_and_downsample, iter_trainer.ddpm_train_step

    def recording_encode(*args):
        out = encode(*args)
        latents.append(out)
        return out

    def recording_step(*args):
        loss = step(*args)
        got.append(float(loss))
        return loss

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(iter_trainer, "encode_and_downsample", recording_encode)
        mp.setattr(iter_trainer, "ddpm_train_step", recording_step)
        trainer.run()
    assert jax_step == ITERATIONS and (trainer.state.count, trainer.state.skipped) == (ITERATIONS, 0)
    assert len(latents) == len(jax_latents) == ITERATIONS
    feat_errors = []
    for ours, theirs in zip(latents, jax_latents):
        for name in ("gt_corr_matrix", "init_corr_matrix", "ref_points", "src_points"):
            np.testing.assert_array_equal(ours[name].numpy(), theirs[name], err_msg=name)
        feat_errors.append(scaled_error(ours["feat_matrix"], theirs["feat_matrix"]))
    print(f"context features, scaled error per pair: {[f'{e:.1e}' for e in feat_errors]}")
    errors = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"JAX DDPM trainer losses {want}; the port's {got}: relative {[f'{e:.1e}' for e in errors]} "
          f"(bound {TRAINER_LOSS_RTOL:.0e}); gt cells per pair "
          f"{[int((x['gt_corr_matrix'] == 1).sum()) for x in jax_latents]}")
    assert len(set(want)) == ITERATIONS
    assert max(errors) <= TRAINER_LOSS_RTOL
    assert all(torch.equal(v, encoder_before[k]) for k, v in trainer.encoder.state_dict().items())
    assert not any(p.requires_grad for p in trainer.encoder.parameters()) and not trainer.encoder.training


# ---------------------------------------------------------------------------
# Resume, and the entry points in process
# ---------------------------------------------------------------------------

def _ddpm_resume_run(root, snapshot_dir, max_iteration, resume):
    cfg = port_config(tiny_linemod_config(**{**TINY_OPTIM, "max_iteration": 6, "warmup_steps": 2}))
    train = PairLoader(_lmo(LMODataset, root, cfg, augment=False), cfg, batch_size=1, shuffle=False)
    val = PairLoader(_lmo(LMODataset, root, cfg, mode="test", augment=False), cfg, batch_size=1)
    encoder = init_parameters(GeoTransformer(cfg), torch.Generator().manual_seed(5))
    model = init_parameters(cordi.Cordi(**TRAINER_DDPM), torch.Generator().manual_seed(6))
    state = AdamWTrainState(model, cfg.optim, make_warmup_cosine_schedule(*_schedule_args(cfg)))
    trainer = IterBasedDDPMTrainer(cfg, encoder, model, state, train, val, max_iteration=max_iteration,
                                   snapshot_steps=3, val_iters=1, snapshot_dir=snapshot_dir, log_steps=1,
                                   seed=cfg.seed)
    trainer.run(resume=resume)
    return trainer


def test_ddpm_resumed_run_equals_uninterrupted_run(linemod_root, tmp_path):
    """6 iterations in one run == 3, then a resumed run to 6 (the loader
    unshuffled, no augmentation, 3 frames: a resumed run restarts the
    loader's stream), with a validation (which draws from the trainer's
    generator) at each snapshot: Cordi's parameters, the AdamW moments, the
    counts and the generator, bit for bit."""
    straight = _ddpm_resume_run(linemod_root, str(tmp_path / "a"), 6, False)
    first = _ddpm_resume_run(linemod_root, str(tmp_path / "b"), 3, False)
    resumed = _ddpm_resume_run(linemod_root, str(tmp_path / "b"), 6, True)
    assert (straight.iteration, first.iteration, resumed.iteration) == (6, 3, 6)
    assert (resumed.state.count, resumed.state.skipped) == (straight.state.count, straight.state.skipped) == (6, 0)
    moved = 0
    for (name, a), b, c in zip(straight.cordi.state_dict().items(), resumed.cordi.state_dict().values(),
                               first.cordi.state_dict().values()):
        assert torch.equal(a, b), name
        moved += int(not torch.equal(a, c))
    assert moved > 0
    sa, sb = straight.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for index, entry in sa["state"].items():
        for key, value in entry.items():
            assert torch.equal(value, sb["state"][index][key]), (index, key)
    assert torch.equal(straight.generator.get_state(), resumed.generator.get_state())
    assert sorted(os.listdir(tmp_path / "b")) == ["iter-3.pth.tar", "iter-6.pth.tar", "snapshot.pth.tar"]


def test_train_cordi_and_test_in_process(experiment_env, monkeypatch):
    """trainval_encoder for 1 iteration, train_cordi on its iter-1 for 4
    iterations (snapshot and validation on the 2 test frames every 2), then
    test of both snapshots over 2 pairs; Cordi at the tiny widths and a
    2-step chain (REF_GT_DDPM_STEPS)."""
    monkeypatch.setenv("REF_GT_DDPM_STEPS", "2")
    ddpm = dataclasses.replace(exp_config.DDPM, **{k: v for k, v in TRAINER_DDPM.items() if k != "num_steps"})
    assert ddpm.num_steps == 2 and isinstance(ddpm, DDPMConfig)
    monkeypatch.setattr(exp_config, "DDPM", ddpm)
    trainval_encoder.main(["--max_iteration", "1", "--snapshot_steps", "1", "--device", "cpu"])
    trainer = train_cordi.main(["--encoder_snapshot", "iter-1", "--max_iteration", "4", "--snapshot_steps", "2",
                                "--log_steps", "1", "--device", "cpu"])
    assert (trainer.iteration, trainer.state.count, trainer.state.skipped) == (4, 4, 0)
    assert trainer.cordi.num_steps == 2
    assert sorted(os.listdir(exp_config.SNAPSHOT_DDPM_DIR)) == ["iter-2.pth.tar", "iter-4.pth.tar", "snapshot.pth.tar"]
    encoder_file = torch.load(os.path.join(exp_config.SNAPSHOT_ENCODER_DIR, "iter-1.pth.tar"), weights_only=True)
    assert all(torch.equal(v, encoder_file["model"][k]) for k, v in trainer.encoder.state_dict().items())
    with open(os.path.join(exp_config.LOG_DIR, "train_cordi.log")) as f:
        log = f.read()
    assert log.count("[Val]") == 2 and "PIR" in log and "IIR" in log

    summary = exp_test.main(["--snapshot", "iter-1", "--cordi_snapshot", "iter-4", "--num_pairs", "2",
                             "--device", "cpu"])
    ddpm_keys = {"ddpm_PIR", "ddpm_PIR_0.5", "ddpm_PIR_0.25", "ddpm_IIR"}
    assert ddpm_keys | {"RRE", "RTE", "RR"} <= set(summary)
    assert all(0.0 <= summary[k] <= 1.0 for k in ddpm_keys)
    assert np.isfinite(summary["RRE"])


def test_train_cordi_data_parallel_options_are_not_ported(experiment_env, monkeypatch):
    """(The name predates the port of data parallelism.) In one process,
    `--num_devices 1` and `--multihost` without a coordinator train Cordi
    one iteration as a world of one (tiny widths, a 2-step chain): no
    process group, one loader shard, the trainer primary, its snapshot
    written. `--num_devices 2` raises."""
    for key in ("REF_GT_COORDINATOR", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("REF_GT_DDPM_STEPS", "2")
    monkeypatch.setattr(exp_config, "DDPM", dataclasses.replace(
        exp_config.DDPM, **{k: v for k, v in TRAINER_DDPM.items() if k != "num_steps"}))
    for extra in (["--num_devices", "1"], ["--multihost"]):
        trainer = train_cordi.main(["--max_iteration", "1", "--snapshot_steps", "1", "--device", "cpu", *extra])
        assert (trainer.iteration, trainer.state.count, trainer.state.skipped) == (1, 1, 0)
        assert trainer.primary and not torch.distributed.is_initialized()
        assert (trainer.train_loader.num_shards, trainer.train_loader.shard_index) == (1, 0)
        assert "iter-1.pth.tar" in os.listdir(exp_config.SNAPSHOT_DDPM_DIR)
        os.remove(os.path.join(exp_config.SNAPSHOT_DDPM_DIR, "iter-1.pth.tar"))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        train_cordi.main(["--max_iteration", "1", "--device", "cpu", "--num_devices", "2"])
