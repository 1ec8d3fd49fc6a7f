"""PyTorch port vs JAX package: backbone, geometric transformer, matching,
local-to-global registration and the whole inference slice, with the JAX
weights bridged into the port (utils/weights.py, strict load).

The JAX side runs jitted with `jax.default_matmul_precision("highest")`: at
the default precision XLA's CPU backend may compute jitted f32 products in
reduced precision, which alone moves the backbone by ~3e-4.

The slice runs on a continuous synthetic surface pair, so no selection meets
an exact tie; the 3DMatch crop (voxelized, full of equal distances) is used
by tests/test_torch_port_ops.py, which checks that its ties are real.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from ref_geotransformer_tpu.data.pyramid import build_registration_inputs as jax_build_inputs
from ref_geotransformer_tpu.data.pyramid import pad_points
from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu.models import init_model_variables
from ref_geotransformer_tpu.models.backbone import KPConvFPN as JaxKPConvFPN
from ref_geotransformer_tpu.models.geotransformer import GeometricTransformer as JaxGeometricTransformer
from ref_geotransformer_tpu.models.matching import superpoint_matching as jax_superpoint_matching
from ref_geotransformer_tpu.models.registration import local_to_global_registration as jax_lgr
from ref_geotransformer_tpu_torch.data.pyramid import build_registration_inputs
from ref_geotransformer_tpu_torch.models.geotransformer import GeometricTransformer, GeoTransformer, _stack_pair
from ref_geotransformer_tpu_torch.models.matching import superpoint_matching
from ref_geotransformer_tpu_torch.models.registration import local_to_global_registration
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables, load_jax_variables
from tests.torch_port_utils import assert_close, port_config, scaled_error, tiny4_config, to_np, to_torch

# estimated_transform: a product of 3x3 SVDs and refits; f32 differences of
# the scores (~1e-6) move it by ~1e-6, held well inside 1e-4
TRANSFORM_ATOL = 1e-4
# bf16 backbone: the KPConv contractions round their f32 operands to bf16
# (8 bits of mantissa). Operands that differ in the last f32 bit round apart
# now and then (one bf16 step, 2^-8 relative), and the steps propagate
# through 13 blocks: the measured scaled error is ~1e-2; held at 3e-2.
BF16_BACKBONE_TOL = 3e-2


def surface_pair(cfg, seed=0, n_ref=450, n_src=430):
    """A continuous random surface seen twice, the second view rigidly moved."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.6, 0.6, (900, 3)).astype(np.float32)
    base[:, 2] = 0.15 * np.sin(5 * base[:, 0]) + 0.1 * base[:, 1] ** 2
    ref = base[rng.choice(900, n_ref, replace=False)] + np.float32(1.5)
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = (base[rng.choice(900, n_src, replace=False)] @ rot.T + np.float32(0.2)).astype(np.float32)
    cap0 = cfg.capacities.points[0]
    return pad_points(ref, cap0) + pad_points(src, cap0)


def _pyramid_args(cfg):
    return (cfg.backbone.num_stages, cfg.backbone.init_voxel_size, cfg.backbone.init_radius,
            cfg.capacities.neighbor_limits, cfg.capacities.points)


@pytest.fixture(scope="module")
def slice_setup():
    cfg = tiny4_config()
    arrays = surface_pair(cfg)
    with jax.default_matmul_precision("highest"):
        data = jax.jit(lambda *a: jax_build_inputs(*a, *_pyramid_args(cfg), search_chunk=cfg.capacities.search_chunk))(
            *(jnp.array(a) for a in arrays))
        model = JaxGeoTransformer(cfg)
        variables = init_model_variables(model, cfg, jax.random.key(0))
        out = jax.device_get(jax.jit(model.apply)(variables, data))
    return cfg, arrays, jax.device_get(data), jax.device_get(variables), out


def _jax_backbone(cfg, variables, data, dtype, act_dtype=None):
    b = cfg.backbone
    vmapped = fnn.vmap(JaxKPConvFPN, in_axes=0, out_axes=0, variable_axes={"params": None, "buffers": None},
                       split_rngs={"params": False}, axis_name="pair_norm")(
        b.input_dim, b.output_dim, b.init_dim, b.kernel_size, b.init_radius, b.init_sigma, b.group_norm,
        b.num_stages, b.fine_level, jnp.bfloat16 if dtype == "bfloat16" else None, norm_axis_name="pair_norm",
        activation_dtype=jnp.bfloat16 if act_dtype == "bfloat16" else None)
    stacked = jax.tree_util.tree_map(lambda r, s: jnp.stack([r, s]), data["ref"], data["src"])
    feats = jnp.stack([data["ref_feats"], data["src_feats"]])
    bb_vars = {"params": variables["params"]["backbone"], "buffers": variables["buffers"]["backbone"]}
    with jax.default_matmul_precision("highest"):
        return jax.device_get(jax.jit(vmapped.apply)(bb_vars, feats, stacked))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", BF16_BACKBONE_TOL)])
def test_backbone(slice_setup, dtype, tol):
    cfg, _, data, variables, _ = slice_setup
    cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone, dtype=dtype))
    want = _jax_backbone(cfg, variables, data, dtype)
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    tdata = to_torch(data)
    with torch.no_grad():
        got = model.backbone(torch.stack([tdata["ref_feats"], tdata["src_feats"]]), _stack_pair(tdata["ref"], tdata["src"]))
    assert len(got) == len(want) == 3
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        assert_close(g, w, atol=tol, rtol=tol, name=f"{dtype} level {level}")


def test_geometric_transformer():
    rng = np.random.default_rng(5)
    n, c_in, hidden = 64, 40, 48
    points = rng.uniform(-1, 1, (2, 1, n, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 1, n, c_in)).astype(np.float32)
    masks = np.ones((2, 1, n), bool)
    masks[0, :, 50:] = False
    masks[1, :, 57:] = False
    jax_mod = JaxGeometricTransformer(c_in, 32, hidden, 4, ("self", "cross", "self", "cross"), 0.2, 15.0, 3,
                                      use_pallas_embedding=False)
    args = (points[0], points[1], feats[0], feats[1], masks[0], masks[1])
    variables = jax_mod.init(jax.random.key(1), *(jnp.array(a) for a in args))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax_mod.apply)(variables, *(jnp.array(a) for a in args))
    module = GeometricTransformer(c_in, 32, hidden, 4, ("self", "cross", "self", "cross"), 0.2, 15.0, 3)
    module.load_state_dict(from_jax_variables({"params": variables["params"]}), strict=True)
    with torch.no_grad():
        got = module(*(torch.from_numpy(a) for a in args))
    for name, g, w, m in zip(("ref", "src"), got, want, masks):
        assert_close(g[m], np.asarray(w)[m], name=name)


def test_superpoint_matching():
    rng = np.random.default_rng(6)
    ref = rng.normal(size=(40, 16)).astype(np.float32)
    src = rng.normal(size=(36, 16)).astype(np.float32)
    ref /= np.linalg.norm(ref, axis=1, keepdims=True)
    src /= np.linalg.norm(src, axis=1, keepdims=True)
    rm, sm = np.arange(40) < 33, np.arange(36) < 30
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda *a: jax_superpoint_matching(*a, 50, True))(*(jnp.array(a) for a in (ref, src, rm, sm)))
    got = superpoint_matching(*(torch.from_numpy(a) for a in (ref, src, rm, sm)), 50, True)
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
    assert_close(got[2], want[2], name="scores")


def test_local_to_global_registration():
    rng = np.random.default_rng(7)
    p, k = 24, 16
    ref_pts = rng.uniform(-1, 1, (p, k, 3)).astype(np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    src_pts = ((ref_pts - 0.1) @ rot + rng.normal(0, 0.01, ref_pts.shape)).astype(np.float32)
    ref_m = rng.uniform(size=(p, k)) < 0.9
    src_m = rng.uniform(size=(p, k)) < 0.9
    logits = rng.normal(size=(p, k + 1, k + 1)).astype(np.float32) + 6.0 * np.pad(np.eye(k), ((0, 1), (0, 1)))
    scores = (logits - np.log(np.exp(logits).sum(axis=(1, 2), keepdims=True))).astype(np.float32)
    node_scores = rng.uniform(size=(p,)).astype(np.float32)
    args = (ref_pts, src_pts, ref_m, src_m, scores, node_scores)
    kw = dict(k=3, acceptance_radius=0.1, mutual=True, confidence_threshold=0.001, correspondence_limit=200,
              num_refinement_steps=5)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda *a: jax_lgr(*a, **kw))(*(jnp.array(a) for a in args))
    got = local_to_global_registration(*(torch.from_numpy(a) for a in args), **kw)
    valid = np.asarray(want.corr_masks)
    np.testing.assert_array_equal(to_np(got.corr_masks), valid)
    assert valid.sum() > 50
    assert_close(got.corr_scores, want.corr_scores, name="corr_scores")
    assert_close(to_np(got.ref_corr_points)[valid], np.asarray(want.ref_corr_points)[valid], name="ref_corr_points")
    assert_close(to_np(got.src_corr_points)[valid], np.asarray(want.src_corr_points)[valid], name="src_corr_points")
    err = float(np.abs(to_np(got.estimated_transform) - np.asarray(want.estimated_transform)).max())
    assert err <= TRANSFORM_ATOL, err


def _check_slice(got, want):
    for key in ("ref_feats_f", "src_feats_f", "ref_feats_c", "src_feats_c"):
        assert_close(got[key], want[key], name=key)
    for key in ("ref_node_masks", "src_node_masks", "ref_node_corr_indices", "src_node_corr_indices",
                "ref_node_corr_knn_masks", "src_node_corr_knn_masks", "corr_masks"):
        np.testing.assert_array_equal(to_np(got[key]), np.asarray(want[key]), err_msg=key)
    assert_close(got["ref_node_corr_knn_points"], want["ref_node_corr_knn_points"], name="patch points")
    assert_close(got["matching_scores"], want["matching_scores"], name="matching_scores")
    assert_close(got["corr_scores"], want["corr_scores"], name="corr_scores")
    assert np.isfinite(to_np(got["estimated_transform"])).all()
    err = float(np.abs(to_np(got["estimated_transform"]) - np.asarray(want["estimated_transform"])).max())
    assert err <= TRANSFORM_ATOL, err


def test_slice_on_the_jax_pyramid(slice_setup):
    """The whole inference slice on the pyramid the JAX package built."""
    cfg, _, data, variables, want = slice_setup
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    got = model(to_torch(data))
    assert int(to_np(got["corr_masks"]).sum()) > 0
    _check_slice(got, want)


def test_slice_on_the_port_pyramid(slice_setup):
    """The whole slice with the port building its own pyramid."""
    cfg, arrays, data, variables, want = slice_setup
    pdata = build_registration_inputs(*(torch.from_numpy(a) for a in arrays), *_pyramid_args(cfg),
                                      search_chunk=cfg.capacities.search_chunk)
    for side in ("ref", "src"):
        for key in ("neighbors", "subsampling", "upsampling"):
            for level, (g, w) in enumerate(zip(pdata[side][key], data[side][key])):
                np.testing.assert_array_equal(np.sort(to_np(g), 1), np.sort(np.asarray(w), 1),
                                              err_msg=f"{side} {key} {level}")
        for level, (g, w) in enumerate(zip(pdata[side]["points"], data[side]["points"])):
            assert scaled_error(g, w) <= 2e-5, f"{side} points {level}"
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    _check_slice(model(pdata), want)


@pytest.mark.parametrize("batch", [(5,), (2, 3)], ids=["batch", "nested batch"])
def test_svd_marks_failed_matrices_nan(batch):
    """A matrix that cuSOLVER's `info` reports failed or not converged, or
    that holds a value that is not finite, gets NaN in U, S and Vh, set in
    place with no read-back by `ops/svd.py`; every other matrix is left as
    it was."""
    from ref_geotransformer_tpu_torch.ops.svd import _fail_nan, _failed

    a = torch.from_numpy(np.random.default_rng(7).normal(size=batch + (3, 3)).astype(np.float32))
    want = torch.linalg.svd(a)
    u, s, vh = (t.clone() for t in want)
    n = a.numel() // 9
    info = torch.zeros(n, dtype=torch.int32)
    info[1], info[-1] = 4, -3
    a.view(n, 3, 3)[2, 0, 1] = float("inf")
    failed = _failed(info, a)
    expected = torch.zeros(n, dtype=torch.bool)
    expected[[1, 2, n - 1]] = True
    assert torch.equal(failed, expected.reshape(batch))
    _fail_nan(u, s, vh, failed)
    for got, w in zip((u, s, vh), want):
        assert bool(torch.isnan(got[failed]).all())
        assert torch.equal(got[~failed], w[~failed])


@pytest.mark.parametrize("case", ["cpu batch", "cpu matrix", "cpu float64", "requires grad, off the cpu"])
def test_read_back_free_svd_takes_torch_off_the_card(case):
    """`ops/svd.py::svd` calls cuSOLVER itself only for CUDA tensors that do
    not require grad: CPU tensors get `torch.linalg.svd`'s results bit for
    bit, and an input that requires grad keeps its graph (here a meta
    tensor, which only torch's own operator takes)."""
    from ref_geotransformer_tpu_torch.ops.svd import svd

    a = torch.from_numpy(np.random.default_rng(13).normal(size=(6, 3, 3)).astype(np.float32))
    if case == "requires grad, off the cpu":
        u, s, vh = svd(a.to("meta").requires_grad_())
        assert u.shape == (6, 3, 3) and s.shape == (6, 3) and vh.requires_grad
        return
    a = {"cpu batch": a, "cpu matrix": a[0], "cpu float64": a.double()}[case]
    for got, want in zip(svd(a), torch.linalg.svd(a)):
        assert torch.equal(got, want) and got.stride() == want.stride()
