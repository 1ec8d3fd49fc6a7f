"""PyTorch port vs JAX package: the training labels (node correspondences,
target sampling), the losses with their gradients, the evaluator, and the
gradient of the Sinkhorn loop.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs jitted at `jax.default_matmul_precision("highest")`.
Tolerances: values and gradients are held at the scaled 2e-5 of
tests/torch_port_utils.py (the same f32 arithmetic, summed in another
order), except where a test states otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ref_geotransformer_tpu.config import CoarseLossConfig, EvalConfig, FineLossConfig, LossWeights
from ref_geotransformer_tpu.models import losses as jax_losses
from ref_geotransformer_tpu.models.matching import superpoint_target_sample as jax_target_sample
from ref_geotransformer_tpu.models.registration import get_node_correspondences as jax_node_corr
from ref_geotransformer_tpu.models.sinkhorn import LearnableLogOptimalTransport as JaxOT
from ref_geotransformer_tpu_torch.models import losses
from ref_geotransformer_tpu_torch.models.matching import superpoint_target_sample
from ref_geotransformer_tpu_torch.models.registration import get_node_correspondences
from ref_geotransformer_tpu_torch.models.sinkhorn import LearnableLogOptimalTransport
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables
from tests.torch_port_utils import assert_close, port_config, to_np


def _jit(fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.device_get(jax.jit(fn)(*(jnp.asarray(a) for a in args)))


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]], np.float32)


def _node_inputs(seed=0, m=40, n=36, k=12):
    """Patches of a shared random scene seen from two frames, with padded
    nodes and padded patch slots; transform maps src onto ref."""
    rng = np.random.default_rng(seed)
    rot = _rotation(rng)
    trans = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    transform = np.eye(4, dtype=np.float32)
    transform[:3, :3], transform[:3, 3] = rot, trans
    ref_nodes = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    ref_knn = (ref_nodes[:, None, :] + rng.normal(0, 0.06, (m, k, 3))).astype(np.float32)
    src_world = (rng.uniform(0, 1, (n, 3))).astype(np.float32)
    src_world[: n // 2] = ref_nodes[: n // 2] + rng.normal(0, 0.03, (n // 2, 3))
    src_knn_world = src_world[:, None, :] + rng.normal(0, 0.06, (n, k, 3))
    to_src = lambda p: ((p - trans) @ rot).astype(np.float32)  # inverse of x -> x R^T + t
    ref_masks = np.arange(m) < m - 4
    src_masks = np.arange(n) < n - 3
    ref_knn_masks = rng.uniform(size=(m, k)) < 0.85
    src_knn_masks = rng.uniform(size=(n, k)) < 0.85
    return (ref_nodes, to_src(src_world), ref_knn, to_src(src_knn_world), transform, ref_masks, src_masks,
            ref_knn_masks, src_knn_masks)


@pytest.mark.parametrize("candidate_limit", [1440, 120])
def test_node_correspondences(candidate_limit):
    """All pairs evaluated (1440 = M * N), and a cap that leaves
    intersecting pairs ambiguous."""
    ref_nodes, src_nodes, ref_knn, src_knn, transform, rm, sm, rkm, skm = _node_inputs()
    want = _jit(lambda a, b, c, d, e, f, g, h, i: jax_node_corr(a, b, c, d, e, 0.05, f, g, h, i, candidate_limit),
                ref_nodes, src_nodes, ref_knn, src_knn, transform, rm, sm, rkm, skm)
    got = get_node_correspondences(*(torch.from_numpy(a) for a in (ref_nodes, src_nodes, ref_knn, src_knn, transform)),
                                   0.05, *(torch.from_numpy(a) for a in (rm, sm, rkm, skm)),
                                   candidate_limit=candidate_limit)
    assert (want[0] > 0).sum() >= 10, "the scene should give positive overlaps"
    assert_close(got[0], want[0], name="overlap map")
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
    assert to_np(got[1]).any() == (candidate_limit == 120)


def _overlap_map(seed=1, m=12, n=10):
    rng = np.random.default_rng(seed)
    overlap = rng.uniform(size=(m, n)).astype(np.float32)
    overlap[overlap < 0.5] = 0.0
    return overlap


def test_target_sample_with_shared_keys(monkeypatch):
    """The same uniform keys in both (the JAX function draws them with
    `jax.random.uniform`, replaced here): the valid slots agree exactly (the
    invalid slots' keys tie at -1, so their indices are arbitrary)."""
    overlap = _overlap_map()
    keys = np.random.default_rng(2).uniform(size=overlap.size).astype(np.float32)
    eligible = int((overlap > 0.1).sum())
    num_targets = eligible + 7
    monkeypatch.setattr(jax.random, "uniform", lambda rng, shape: jnp.asarray(keys))
    want = jax.device_get(jax_target_sample(jax.random.key(0), jnp.asarray(overlap), num_targets, 0.1))
    got = superpoint_target_sample(torch.from_numpy(overlap), num_targets, 0.1, keys=torch.from_numpy(keys))
    valid = np.asarray(want[3])
    np.testing.assert_array_equal(to_np(got[3]), valid)
    assert valid.sum() == eligible
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(to_np(g)[valid], np.asarray(w)[valid])
    assert (to_np(got[2])[~valid] == 0).all()


def test_target_sample_from_a_generator():
    overlap = torch.from_numpy(_overlap_map())
    a = superpoint_target_sample(overlap, 20, 0.1, generator=torch.Generator().manual_seed(3))
    b = superpoint_target_sample(overlap, 20, 0.1, generator=torch.Generator().manual_seed(3))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    valid = a[3]
    assert bool((overlap[a[0][valid].long(), a[1][valid].long()] > 0.1).all())
    assert len(set(zip(a[0][valid].tolist(), a[1][valid].tolist()))) == int(valid.sum())


def _coarse_output(seed=4, m=20, n=18, c=16, pad=(4, 3)):
    """Normalized coarse features whose padded nodes all carry one feature
    (as they do in the model), an overlap map and an ambiguous map."""
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(m, c)).astype(np.float32)
    src = rng.normal(size=(n, c)).astype(np.float32)
    ref[m - pad[0]:] = ref[-1]
    src[n - pad[1]:] = ref[-1]
    ref /= np.linalg.norm(ref, axis=1, keepdims=True)
    src /= np.linalg.norm(src, axis=1, keepdims=True)
    overlap = rng.uniform(size=(m, n)).astype(np.float32)
    overlap[overlap < 0.6] = 0.0
    return {
        "ref_feats_c": ref, "src_feats_c": src, "gt_node_overlap_map": overlap,
        "gt_node_ambiguous_map": rng.uniform(size=(m, n)) < 0.1,
        "ref_node_masks": np.arange(m) < m - pad[0], "src_node_masks": np.arange(n) < n - pad[1],
    }


def test_coarse_loss_and_gradient_with_padded_nodes():
    """Padded nodes share one feature: their pairwise distance is exactly 0.
    The loss and its gradient with respect to the features agree with JAX,
    and the gradient is finite (the double-where sqrt)."""
    out = _coarse_output()
    cfg = CoarseLossConfig()

    def jax_loss(ref, src):
        return jax_losses.coarse_matching_loss({**{k: jnp.asarray(v) for k, v in out.items()},
                                                "ref_feats_c": ref, "src_feats_c": src}, cfg)

    want, want_grads = _jit(jax.value_and_grad(jax_loss, argnums=(0, 1)), out["ref_feats_c"], out["src_feats_c"])
    t_out = {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}
    ref = t_out["ref_feats_c"].requires_grad_()
    src = t_out["src_feats_c"].requires_grad_()
    got = losses.coarse_matching_loss(t_out, port_config(cfg))
    got.backward()
    assert_close(got, want, name="c_loss")
    for name, g, w in (("ref", ref.grad, want_grads[0]), ("src", src.grad, want_grads[1])):
        assert np.isfinite(to_np(g)).all(), name
        assert_close(g, w, name=f"d c_loss / d {name}_feats_c")


def test_circle_loss_matches_jax():
    rng = np.random.default_rng(5)
    dists = rng.uniform(0, 2, (9, 7)).astype(np.float32)
    pos = rng.uniform(size=(9, 7)) < 0.3
    neg = ~pos & (rng.uniform(size=(9, 7)) < 0.8)
    scales = rng.uniform(size=(9, 7)).astype(np.float32)
    args = (0.1, 1.4, 0.1, 1.4, 24.0)
    want = _jit(lambda d, p, n, s: jax_losses.weighted_circle_loss(p, n, d, *args, pos_scales=s, neg_scales=s),
                dists, pos, neg, scales)
    t = [torch.from_numpy(a) for a in (pos, neg, dists)]
    t_scales = torch.from_numpy(scales)
    got = losses.weighted_circle_loss(*t, *args, pos_scales=t_scales, neg_scales=t_scales)
    assert_close(got, want, name="circle loss")


def _fine_output(seed=6, p=6, k=8):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 0.3, (p, k, 3)).astype(np.float32)
    src = (ref + rng.normal(0, 0.03, (p, k, 3))).astype(np.float32)
    logits = rng.normal(size=(p, k + 1, k + 1)).astype(np.float32)
    scores = (logits - np.log(np.exp(logits).sum(axis=(1, 2), keepdims=True))).astype(np.float32)
    return {
        "ref_node_corr_knn_points": ref, "src_node_corr_knn_points": src,
        "ref_node_corr_knn_masks": rng.uniform(size=(p, k)) < 0.8,
        "src_node_corr_knn_masks": rng.uniform(size=(p, k)) < 0.8,
        "matching_scores": scores, "node_corr_masks": np.arange(p) < p - 2,
    }


def test_fine_loss_and_gradient():
    out = _fine_output()
    transform = np.eye(4, dtype=np.float32)
    cfg = FineLossConfig(positive_radius=0.05)

    def jax_loss(scores):
        return jax_losses.fine_matching_loss({**{k: jnp.asarray(v) for k, v in out.items()},
                                              "matching_scores": scores}, jnp.asarray(transform), cfg)

    want, want_grad = _jit(jax.value_and_grad(jax_loss), out["matching_scores"])
    t_out = {k: torch.from_numpy(v) for k, v in out.items()}
    scores = t_out["matching_scores"].requires_grad_()
    got = losses.fine_matching_loss(t_out, torch.from_numpy(transform), port_config(cfg))
    got.backward()
    assert_close(got, want, name="f_loss")
    assert_close(scores.grad, want_grad, name="d f_loss / d matching_scores")


def test_overall_loss_weights_its_terms():
    coarse, fine = _coarse_output(), _fine_output()
    out = {**coarse, **fine}
    transform = np.eye(4, dtype=np.float32)
    weights = LossWeights(weight_coarse_loss=0.7, weight_fine_loss=1.3)
    want = _jit(lambda t: jax_losses.overall_loss({k: jnp.asarray(v) for k, v in out.items()}, t, CoarseLossConfig(),
                                                  FineLossConfig(), weights), transform)
    got = losses.overall_loss({k: torch.from_numpy(np.asarray(v)) for k, v in out.items()},
                              torch.from_numpy(transform),
                              *(port_config(c) for c in (CoarseLossConfig(), FineLossConfig(), weights)))
    for key in ("loss", "c_loss", "f_loss"):
        assert_close(got[key], want[key], name=key)


@pytest.mark.parametrize("criterion", ["rmse", "rre_rte"])
def test_evaluate(criterion):
    rng = np.random.default_rng(7)
    rot = _rotation(rng)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3], gt[:3, 3] = rot, [0.1, -0.2, 0.05]
    est = gt.copy()
    est[:3, 3] += 0.02
    src_corr = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    ref_corr = (src_corr @ rot.T + gt[:3, 3] + rng.normal(0, 0.08, (50, 3))).astype(np.float32)
    out = {
        "gt_node_overlap_map": _overlap_map(), "ref_node_corr_indices": rng.integers(0, 12, 30).astype(np.int32),
        "src_node_corr_indices": rng.integers(0, 10, 30).astype(np.int32), "ref_corr_points": ref_corr,
        "src_corr_points": src_corr, "corr_masks": rng.uniform(size=50) < 0.9, "estimated_transform": est,
        "src_points": rng.uniform(0, 1, (80, 3)).astype(np.float32), "src_point_masks": np.arange(80) < 70,
    }
    cfg = EvalConfig(recall_criterion=criterion)
    want = _jit(lambda t: jax_losses.evaluate({k: jnp.asarray(v) for k, v in out.items()}, t, cfg), gt)
    got = losses.evaluate({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(gt), port_config(cfg))
    assert set(got) == set(want)
    for key in want:
        # RRE is an arccos near 1: its f32 rounding is amplified, held at 1e-3 deg
        tol = 1e-3 if key == "RRE" else 2e-5
        assert_close(got[key], want[key], atol=tol, rtol=tol, name=key)


def test_sinkhorn_gradient_of_the_plain_loop_matches_scan():
    """Training differentiates the plain loop; the JAX package its lax.scan.
    Gradients of a weighted sum of the log assignment with respect to the
    scores and to alpha. 30 dependent rounds: held at 1e-4 scaled."""
    rng = np.random.default_rng(8)
    b, m, n = 4, 7, 6
    scores = rng.normal(size=(b, m, n)).astype(np.float32)
    rm = rng.uniform(size=(b, m)) < 0.8
    cm = rng.uniform(size=(b, n)) < 0.8
    rm[0] = False
    cm[0] = False
    weights = rng.normal(size=(b, m + 1, n + 1)).astype(np.float32)
    module = JaxOT(30, use_pallas=False)

    def jax_fn(params, s):
        out = module.apply({"params": params}, s, jnp.asarray(rm), jnp.asarray(cm))
        return jnp.sum(jnp.where(out > -1e11, out, 0.0) * jnp.asarray(weights))

    params = {"alpha": jnp.asarray(0.7, jnp.float32)}
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax.jit(jax.grad(jax_fn, argnums=(0, 1)))(params, jnp.asarray(scores)))
    ot = LearnableLogOptimalTransport(30)
    ot.load_state_dict(from_jax_variables({"params": params}), strict=True)
    s = torch.from_numpy(scores).requires_grad_()
    out = ot(s, torch.from_numpy(rm), torch.from_numpy(cm), training=True)
    torch.sum(torch.where(out > -1e11, out, 0.0) * torch.from_numpy(weights)).backward()
    assert_close(s.grad, want[1], atol=1e-4, rtol=1e-4, name="d / d scores")
    assert_close(ot.alpha.grad, want[0]["alpha"], atol=1e-4, rtol=1e-4, name="d / d alpha")


def test_training_takes_the_plain_sinkhorn_loop(monkeypatch):
    """With training=True the module never calls the kernel wrapper, even
    with use_kernel set (the kernel has no backward)."""
    from ref_geotransformer_tpu_torch.models import cuda_kernels

    def refuse(*args):
        raise AssertionError("the kernel wrapper was called in training")

    monkeypatch.setattr(cuda_kernels, "sinkhorn_log_norm", refuse)
    ot = LearnableLogOptimalTransport(5, use_kernel=True)
    out = ot(torch.zeros(2, 3, 4), training=True)
    assert out.shape == (2, 4, 5) and out.requires_grad
    with pytest.raises(AssertionError, match="kernel wrapper"):
        ot(torch.zeros(2, 3, 4))

