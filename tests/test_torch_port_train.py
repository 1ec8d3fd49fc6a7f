"""PyTorch port vs JAX package: the train step.

* the plain backward of the structure embedding against the JAX package's
  Pallas backward (interpret mode, precise sin/cos, as its own tests run
  it), and the autograd Function against `jax.grad` of the XLA path;
* one whole train step of the 4-stage tiny model (f32): losses and every
  parameter gradient by name, with both packages fed the same uniform
  target keys; then the Adam update against `TrainState.apply_gradients`;
* the non-finite-gradient skip against `optax.apply_if_finite`.

The JAX side runs jitted at `jax.default_matmul_precision("highest")`.
"""

import functools
import math

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import ref_geotransformer_tpu_torch.models.geotransformer as port_geotransformer
from ref_geotransformer_tpu.engine.state import TrainState as JaxTrainState
from ref_geotransformer_tpu.engine.state import make_optimizer
from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu.models import init_model_variables
from ref_geotransformer_tpu.models.embedding import GeometricStructureEmbedding as JaxEmbedding
from ref_geotransformer_tpu.models.losses import overall_loss as jax_overall_loss
from ref_geotransformer_tpu.models.pallas_kernels import _geo_embedding_bwd
from ref_geotransformer_tpu_torch.engine import TrainState, lr_at, train_step
from ref_geotransformer_tpu_torch.models import cuda_kernels
from ref_geotransformer_tpu_torch.models.embedding import GeometricStructureEmbedding
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables, jax_gradients_by_name, load_jax_variables
from tests.torch_port_utils import assert_close, port_config, tiny4_config, to_np, to_torch
from tests.utils import synthetic_pair

SIGMA_D, FACTOR_A = 0.2, 180.0 / (15.0 * math.pi)
# Against the Pallas backward: its atan2 is a polynomial (|err| ~ 1e-5 rad,
# times factor_a 3.8 in the sinusoid argument) and its distances are direct
# differences; the gradients, sums over N^2 = 4096 rows, are held at 1e-4 of
# each gradient's largest magnitude. The angle error can flip the winner of
# a near tie (two branches' projections within ~1e-4), which moves a whole
# row's share of dWa; the test zeroes g where the two best branches are
# within NEAR_TIE but not equal, so only the exact ties are left to route.
PALLAS_BWD_TOL = 1e-4
NEAR_TIE = 1e-3
# Against jax.grad of the XLA path, the same arithmetic summed in another
# order: 1e-5 of each gradient's largest magnitude (measured ~1e-6). Except
# dWd: under jax.grad the XLA path's inner-product distances leave
# sqrt(rounding residual) ~ 3e-4 on the diagonal, where the port's anchor
# differences give exactly 0, so JAX's sine features there are ~1e-3, not 0
# (measured 2.6e-4 of dWd's magnitude when g lies on the diagonal only).
XLA_GRAD_TOL = 1e-5
XLA_DISTANCE_GRAD_TOL = 5e-4
# Whole train step: each gradient's error over max(its largest magnitude,
# 1e-3 of the largest gradient of the model). The floor is for the
# gradients that are analytically zero (biases before a normalization, key
# biases under a softmax), which hold only rounding noise; the others agree
# to ~1e-4 of their magnitude.
STEP_GRAD_TOL = 1e-3


def _relative_error(got, want, scale=None):
    got, want = to_np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30) if scale is None else scale
    return float(np.abs(got - want).max() / scale)


def _embedding_inputs(seed, n=64, c=32, k=3, n_valid=50):
    """Nodes in [-1, 1]^3 whose padded tail sits at one location (the
    origin), so the padded pairs tie like the diagonal does."""
    rng = np.random.default_rng(seed)
    points = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    points[n_valid:] = 0.0
    ref_vectors = rng.uniform(-0.3, 0.3, (n, k, 3)).astype(np.float32)
    div_term = np.exp(np.arange(0, c, 2, dtype=np.float32) * (-np.log(10000.0) / c)).astype(np.float32)
    wa = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32)
    ba = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(n, n, c)).astype(np.float32)
    return points, ref_vectors, div_term, wa, ba, g


def _without_near_ties(points, ref_vectors, div_term, wa, ba, g):
    """g with the entries of near-tied (not exactly tied) branches zeroed."""
    near = cuda_kernels.near_ties(*(torch.from_numpy(a) for a in (points, ref_vectors, div_term, wa, ba)),
                                  SIGMA_D, FACTOR_A, NEAR_TIE).numpy()
    assert 0 < near.mean() < 1e-2
    return np.where(near, 0.0, g).astype(np.float32)


def test_plain_backward_matches_pallas_backward():
    points, ref_vectors, div_term, wa, ba, g = _embedding_inputs(0)
    g = _without_near_ties(points, ref_vectors, div_term, wa, ba, g)
    want = _geo_embedding_bwd(*(jnp.asarray(a) for a in (points, ref_vectors, div_term, wa, ba, g)), SIGMA_D,
                              FACTOR_A, 64, interpret=True, fast_sincos=False)
    got = cuda_kernels.geometric_embedding_bwd(*(torch.from_numpy(a) for a in (points, ref_vectors, div_term, wa, ba,
                                                                             g)), SIGMA_D, FACTOR_A)
    for name, x, y in zip(("dwd", "dbd", "dwa", "dba"), got, want):
        assert _relative_error(x, y) <= PALLAS_BWD_TOL, name


def _diagonal_only(g, n_valid):
    """g kept only where the anchor vector is 0: the diagonal and the pairs
    of padded nodes (all at the origin), where all k angles tie at 0."""
    n = g.shape[0]
    tie = np.eye(n, dtype=bool)
    tie[n_valid:, n_valid:] = True
    return np.where(tie[:, :, None], g, 0.0).astype(np.float32)


def _assert_autograd_matches_jax_grad(points, g, n_valid):
    """The gradients of sum(out * g) with respect to proj_d and proj_a: the
    port's module (CPU tensors: the plain forward and backward) against
    jax.grad of the JAX module's XLA path."""
    n, c = g.shape[1:]
    masks = np.arange(n)[None] < n_valid
    jax_mod = JaxEmbedding(c, SIGMA_D, 15.0, 3, "max", use_pallas=False)
    variables = jax_mod.init(jax.random.key(0), jnp.asarray(points[None]), jnp.asarray(masks))

    def loss(params):
        out = jax_mod.apply({"params": params}, jnp.asarray(points[None]), jnp.asarray(masks))
        return jnp.sum(out * jnp.asarray(g[None]))

    with jax.default_matmul_precision("highest"):
        want = jax_gradients_by_name(jax.device_get(jax.jit(jax.grad(loss))(variables["params"])))
    module = GeometricStructureEmbedding(c, SIGMA_D, 15.0, 3, "max", use_kernel=True)
    module.load_state_dict(from_jax_variables({"params": variables["params"]}), strict=True)
    launches = cuda_kernels.geometric_embedding_bwd.launches
    out = module(torch.from_numpy(points[None]), torch.from_numpy(masks))
    torch.sum(out * torch.from_numpy(g[None])).backward()
    assert cuda_kernels.geometric_embedding_bwd.launches == launches  # CPU tensors: the plain backward
    for name, p in module.named_parameters():
        tol = XLA_DISTANCE_GRAD_TOL if name == "proj_d.weight" else XLA_GRAD_TOL
        assert _relative_error(p.grad, want[name]) <= tol, name


@pytest.mark.parametrize("cotangent", ["random", "ties_only"])
def test_autograd_function_matches_jax_grad(cotangent):
    """After tests/test_pallas_kernels.py. "ties_only" keeps g only on the
    diagonal and the padded pairs, where the k branches tie exactly: dWa
    must split g among them (dividing by the tie count), as jnp.max's vjp
    does."""
    n, c, n_valid = 64, 32, 50
    points, _, _, _, _, g = _embedding_inputs(1, n=n, c=c, n_valid=n_valid)
    if cotangent == "ties_only":
        g = _diagonal_only(g, n_valid)
    _assert_autograd_matches_jax_grad(points, g, n_valid)


def test_autograd_function_matches_jax_grad_at_any_n():
    """N = 80, not a multiple of the kernels' tiles (64 pairs forward, 32
    backward), C = 64: the plain forward and backward against the JAX
    module, which takes its XLA path there."""
    n, c, n_valid = 80, 64, 70
    points, _, _, _, _, g = _embedding_inputs(5, n=n, c=c, n_valid=n_valid)
    _assert_autograd_matches_jax_grad(points, g, n_valid)


def test_ties_split_the_gradient():
    """On the diagonal all k = 3 branches tie, so dWa there is one branch's
    share: sum_diag emb(0)^T g, not three times it."""
    n, c = 64, 32
    points, ref_vectors, div_term, wa, ba, g = _embedding_inputs(2, n=n, c=c, n_valid=n)
    g = _diagonal_only(g, n)
    _, _, dwa, _ = cuda_kernels.geometric_embedding_bwd_plain(
        *(torch.from_numpy(a) for a in (points, ref_vectors, div_term, wa, ba, g)), SIGMA_D, FACTOR_A)
    emb0 = cuda_kernels.sinusoid(torch.zeros(()), torch.from_numpy(div_term))  # the sinusoid of angle 0
    want = emb0[:, None] * torch.from_numpy(g[np.arange(n), np.arange(n)]).sum(0)[None, :]
    assert _relative_error(dwa, want.numpy()) <= 1e-6


# ---------------------------------------------------------------------------
# One whole train step, then the Adam update
# ---------------------------------------------------------------------------

STEPS_PER_EPOCH = 1


@pytest.fixture(scope="module")
def train_setup():
    cfg = tiny4_config()
    data, _ = synthetic_pair(cfg, seed=5)
    model = JaxGeoTransformer(cfg)
    variables = jax.device_get(init_model_variables(model, cfg, jax.random.key(0)))
    overlap = jax.device_get(jax.jit(lambda v, d: model.apply(v, d)["gt_node_overlap_map"])(variables, data))
    keys = np.random.default_rng(1).uniform(size=overlap.size).astype(np.float32)

    def loss_fn(params):
        out = model.apply({"params": params, "buffers": variables["buffers"]}, data, training=True,
                          rngs={"target": jax.random.key(3)})
        losses = jax_overall_loss(out, data["transform"], cfg.coarse_loss, cfg.fine_loss, cfg.loss)
        return losses["loss"], losses

    with pytest.MonkeyPatch.context() as mp:
        # the JAX sampler draws its keys with jax.random.uniform: hand it ours
        uniform = jax.random.uniform
        mp.setattr(jax.random, "uniform", lambda key, shape=(), *args, **kw: (
            jnp.asarray(keys) if tuple(shape) == keys.shape else uniform(key, shape, *args, **kw)))
        with jax.default_matmul_precision("highest"):
            grads, jax_losses = jax.device_get(jax.jit(jax.grad(loss_fn, has_aux=True))(variables["params"]))
    tx, _ = make_optimizer(cfg.optim, STEPS_PER_EPOCH)
    jax_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              buffers=variables["buffers"], opt_state=tx.init(variables["params"]), tx=tx)
    jax_params = jax.device_get(jax_state.apply_gradients(grads).params)

    params_before = {name: p.clone() for name, p in from_jax_variables({"params": variables["params"]}).items()}
    port = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    state = TrainState(port, port.cfg.optim, STEPS_PER_EPOCH)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_geotransformer, "superpoint_target_sample",
                   functools.partial(port_geotransformer.superpoint_target_sample, keys=torch.from_numpy(keys)))
        losses = train_step(port, state, to_torch(data))
    return {
        "jax_losses": jax_losses, "jax_grads": jax_gradients_by_name(grads), "losses": losses, "state": state,
        "jax_params": from_jax_variables({"params": jax_params}), "port": port,
        "params_before": params_before,
    }


def test_train_step_losses(train_setup):
    for key in ("loss", "c_loss", "f_loss"):
        assert np.isfinite(float(train_setup["losses"][key])), key
        assert_close(train_setup["losses"][key], train_setup["jax_losses"][key], name=key)


def test_train_step_gradients_by_name(train_setup):
    want = train_setup["jax_grads"]
    named = dict(train_setup["port"].named_parameters())
    assert set(named) == set(want)
    floor = 1e-3 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in named.items():
        w = want[name].numpy()
        assert p.grad is not None, name
        assert _relative_error(p.grad, w, scale=max(float(np.abs(w).max()), floor)) <= STEP_GRAD_TOL, name
    for name in ("transformer.embedding.proj_d.weight", "transformer.embedding.proj_a.weight"):
        assert float(named[name].grad.abs().max()) > 0.0, f"no gradient reached {name}"


def test_adam_update_matches_apply_gradients(train_setup):
    """The step's Adam update (coupled L2, lr 1e-4), p_after - p_before,
    against the JAX package's update from its own gradients. The first
    update is -lr * u / (|u| + eps) with u = g + weight_decay * p: about
    -lr * sign(u). It is compared entry by entry where u stands above ten
    times the error the gradient test allows (and 100 eps), so its sign is
    the same in both packages; there the two updates agree to 1e-2 of lr,
    beyond the f32 rounding of the parameters. A skipped or sign-flipped
    update misses by lr or 2 lr."""
    state, after, grads = train_setup["state"], train_setup["jax_params"], train_setup["jax_grads"]
    before = train_setup["params_before"]
    assert state.count == 1 and state.skipped == 0
    lr, wd = state.cfg.lr, state.cfg.weight_decay
    floor = 1e-3 * max(float(np.abs(g.numpy()).max()) for g in grads.values())
    compared = total = 0
    for name, p in train_setup["port"].named_parameters():
        p0 = before[name].numpy().astype(np.float64)
        u = grads[name].numpy().astype(np.float64) + wd * p0
        err = STEP_GRAD_TOL * max(float(np.abs(grads[name].numpy()).max()), floor)
        reliable = np.abs(u) > max(10 * err, 1e-6)
        got = to_np(p).astype(np.float64) - p0
        want = after[name].numpy().astype(np.float64) - p0
        assert np.all(np.abs(want[reliable]) > 0.9 * lr), name  # the JAX update moved them by ~lr
        tol = 1e-2 * lr + 2 * np.finfo(np.float32).eps * np.abs(p0)
        assert np.all((np.abs(got - want) <= tol)[reliable]), name
        compared, total = compared + int(reliable.sum()), total + reliable.size
    assert compared > 0.5 * total, (compared, total)


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(3, 2)


def test_nonfinite_gradients_skip_the_step():
    """A step with a NaN gradient leaves the parameters, the Adam moments and
    the schedule's count untouched (optax.apply_if_finite); the next finite
    step is then the first update, as in the JAX package, whose schedule
    decays after every step here (steps_per_epoch 1)."""
    from ref_geotransformer_tpu.config import OptimConfig as JaxOptimConfig

    rng = np.random.default_rng(9)
    params = {"dense": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                        "bias": rng.normal(size=(2,)).astype(np.float32)}}
    grads = [{"dense": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                        "bias": rng.normal(size=(2,)).astype(np.float32)}} for _ in range(3)]
    grads[1]["dense"]["bias"][0] = np.nan
    cfg = JaxOptimConfig(lr=1e-2, lr_decay=0.5, lr_decay_steps=1, weight_decay=1e-3)
    tx, schedule = make_optimizer(cfg, 1)
    jax_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jax.tree_util.tree_map(jnp.asarray, params),
                              buffers={}, opt_state=tx.init(params), tx=tx)

    model = _Tiny()
    model.load_state_dict(from_jax_variables({"params": params}), strict=True)
    state = TrainState(model, port_config(cfg), 1)
    applied = []
    for step_grads in grads:
        jax_state = jax_state.apply_gradients(jax.tree_util.tree_map(jnp.asarray, step_grads))
        for name, g in jax_gradients_by_name(step_grads).items():
            dict(model.named_parameters())[name].grad = g.clone()
        before = {name: p.detach().clone() for name, p in model.named_parameters()}
        applied.append(state.apply_gradients())
        if not applied[-1]:
            for name, p in model.named_parameters():
                assert torch.equal(p.detach(), before[name]), name
                assert p.grad is None, name
        want = from_jax_variables({"params": jax.device_get(jax_state.params)})
        for name, p in model.named_parameters():
            assert_close(p.detach(), want[name], name=f"{name} after {len(applied)} steps")
    assert applied == [True, False, True]
    assert (state.count, state.skipped) == (2, 1)
    assert state.lr() == pytest.approx(float(schedule(2)))
    assert lr_at(port_config(cfg), 2, 1) == pytest.approx(1e-2 * 0.25)


def test_gradient_accumulation_is_not_ported():
    """grad_acc_steps = 2 (the name predates the port of gradient
    accumulation) against optax.MultiSteps around the JAX package's guarded
    chain, over 4 windows of 2 mini-steps with a NaN in mini-step 3: after
    every mini-step the parameters, and the counts read from optax's state:
    the mini-step, Adam's count of applied updates, and the guard's count of
    skipped ones. optax resets its running mean by multiplying it with 0, so
    the NaN stays and every later window is skipped too; the port follows."""
    from ref_geotransformer_tpu.config import OptimConfig as JaxOptimConfig

    rng = np.random.default_rng(10)
    params = {"dense": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                        "bias": rng.normal(size=(2,)).astype(np.float32)}}
    grads = [{"dense": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                        "bias": rng.normal(size=(2,)).astype(np.float32)}} for _ in range(8)]
    grads[2]["dense"]["kernel"][1, 0] = np.nan
    cfg = JaxOptimConfig(lr=1e-2, lr_decay=0.5, lr_decay_steps=1, weight_decay=1e-3, grad_acc_steps=2)
    tx, schedule = make_optimizer(cfg, 1)
    jax_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jax.tree_util.tree_map(jnp.asarray, params),
                              buffers={}, opt_state=tx.init(params), tx=tx)

    model = _Tiny()
    model.load_state_dict(from_jax_variables({"params": params}), strict=True)
    state = TrainState(model, port_config(cfg), 1)
    applied = []
    for step, step_grads in enumerate(grads):
        jax_state = jax_state.apply_gradients(jax.tree_util.tree_map(jnp.asarray, step_grads))
        for name, g in jax_gradients_by_name(step_grads).items():
            dict(model.named_parameters())[name].grad = g.clone()
        applied.append(state.apply_gradients())
        want = from_jax_variables({"params": jax.device_get(jax_state.params)})
        for name, p in model.named_parameters():
            assert_close(p.detach(), want[name], name=f"{name} after mini-step {step + 1}")
        opt_state = jax_state.opt_state
        guard = opt_state.inner_opt_state
        adam_count = int(guard.inner_state[1][0].count)
        assert (state.mini_step, state.count, state.skipped) == (
            int(opt_state.mini_step), adam_count, int(guard.total_notfinite)), step
    assert applied == [False, True, False, False, False, False, False, False]
    assert (state.count, state.skipped) == (1, 3)
    assert state.lr() == pytest.approx(float(schedule(1)))


def test_eval_step_builds_the_pyramid_from_a_raw_pair():
    """eval_step on a raw padded pair (points, masks, transform) equals
    eval_step on the input dict built beforehand: ensure_pyramids passes the
    transform on, so the overlap labels, losses and metrics exist."""
    from ref_geotransformer_tpu_torch.data.pyramid import build_registration_inputs
    from ref_geotransformer_tpu_torch.engine import eval_step

    cfg = port_config(tiny4_config())
    rng = np.random.default_rng(11)
    base = rng.uniform(-0.5, 0.5, (400, 3)).astype(np.float32)
    base[:, 2] = 0.2 * np.sin(4 * base[:, 0])
    transform = np.eye(4, dtype=np.float32)
    transform[:3, 3] = [0.05, -0.02, 0.01]
    pair = {"transform": torch.from_numpy(transform)}
    for name, pts in (("ref", base[:380] + transform[:3, 3]), ("src", base[20:])):
        padded = np.zeros((cfg.capacities.points[0], 3), np.float32)
        padded[: len(pts)] = pts
        pair[f"{name}_points"] = torch.from_numpy(padded)
        pair[f"{name}_masks"] = torch.arange(cfg.capacities.points[0]) < len(pts)
    model = GeoTransformer(cfg)
    bb, caps = cfg.backbone, cfg.capacities
    data = build_registration_inputs(pair["ref_points"], pair["ref_masks"], pair["src_points"], pair["src_masks"],
                                     bb.num_stages, bb.init_voxel_size, bb.init_radius, caps.neighbor_limits,
                                     caps.points, transform=pair["transform"], search_chunk=caps.search_chunk)
    from_raw, from_data = eval_step(model, pair), eval_step(model, data)
    assert set(from_raw) == {"loss", "c_loss", "f_loss", "PIR", "IR", "RRE", "RTE", "RMSE", "RR"}
    for key, value in from_raw.items():
        assert bool(torch.isfinite(value)), key
        assert torch.equal(value, from_data[key]), key
