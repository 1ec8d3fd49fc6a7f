"""PyTorch port vs JAX package: the rest of ops/ (vector_angle, metrics, se3,
knn_search, radius_search's methods, the kNN and ball-query partitions),
models/correspondence.py, and models/kpconv.py's knn_interpolate,
global_avgpool and LayerNorm blocks.

Inputs are numpy-seeded and continuous, so no selection meets a tie, except
where stated. Tolerance: the f32 scaled error 2e-5 (tests/torch_port_utils.py);
index outputs equal; neighbor tables equal as per-row sets with column 0
equal (`assert_tables_match`).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from ref_geotransformer_tpu.models import correspondence as jax_corr
from ref_geotransformer_tpu.models import kpconv as jax_kpconv
from ref_geotransformer_tpu.ops import metrics as jax_metrics
from ref_geotransformer_tpu.ops import neighbors as jax_neighbors
from ref_geotransformer_tpu.ops import partition as jax_partition
from ref_geotransformer_tpu.ops import se3 as jax_se3
from ref_geotransformer_tpu_torch.models import correspondence, kpconv
from ref_geotransformer_tpu_torch.ops import metrics, neighbors, partition, se3, vector_angle
from ref_geotransformer_tpu_torch.utils.weights import load_jax_variables
from tests.torch_port_utils import assert_close, assert_tables_match, to_np

# the module: the JAX ops package re-exports its function under the same name
jax_angle = importlib.import_module("ref_geotransformer_tpu.ops.vector_angle")


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _transforms(rng, b):
    rot = Rotation.from_euler("xyz", rng.uniform(-60, 60, (b, 3)), degrees=True).as_matrix().astype(np.float32)
    out = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    out[:, :3, :3] = rot
    out[:, :3, 3] = rng.uniform(-1, 1, (b, 3))
    return out


def test_vector_angle():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    y = rng.normal(size=(1, 3)).astype(np.float32)
    x[0], x[1] = y[0], -y[0]  # angles 0 and pi
    for degrees in (False, True):
        assert_close(vector_angle.vector_angle(*_t(x, y), degrees=degrees),
                     jax_angle.vector_angle(*_j(x, y), degrees=degrees), name=f"degrees={degrees}")
    assert_close(vector_angle.deg2rad(torch.tensor(90.0)), jax_angle.deg2rad(90.0))
    assert_close(vector_angle.rad2deg(torch.tensor(1.0)), jax_angle.rad2deg(1.0))


def test_se3():
    rng = np.random.default_rng(1)
    t = _transforms(rng, 5)
    points = rng.normal(size=(5, 20, 3)).astype(np.float32)
    assert_close(se3.inverse_transform(*_t(t)), jax_se3.inverse_transform(*_j(t)), name="inverse")
    assert_close(se3.compose_transforms(*_t(t[0], t[1], t[2])), jax_se3.compose_transforms(*_j(t[0], t[1], t[2])),
                 name="compose")
    assert_close(se3.apply_rotation(*_t(points, t[:, :3, :3])), jax_se3.apply_rotation(*_j(points, t[:, :3, :3])),
                 name="apply_rotation batched")
    assert_close(se3.apply_rotation(*_t(points, t[0, :3, :3])), jax_se3.apply_rotation(*_j(points, t[0, :3, :3])),
                 name="apply_rotation")
    vec = rng.normal(size=(6, 3)).astype(np.float32)
    angle = rng.uniform(-3, 3, 6).astype(np.float32)
    assert_close(se3.skew_symmetric_matrix(*_t(vec)), jax_se3.skew_symmetric_matrix(*_j(vec)), name="skew")
    assert_close(se3.rodrigues_rotation_matrix(*_t(vec, angle)), jax_se3.rodrigues_rotation_matrix(*_j(vec, angle)),
                 name="rodrigues")
    tgt = rng.normal(size=(6, 3)).astype(np.float32)
    tgt[0], tgt[1] = 2 * vec[0], -3 * vec[1]  # parallel and anti-parallel
    assert_close(se3.rodrigues_alignment_matrix(*_t(vec, tgt)), jax_se3.rodrigues_alignment_matrix(*_j(vec, tgt)),
                 name="alignment")


def test_metrics():
    rng = np.random.default_rng(2)
    gt = _transforms(rng, 4)
    est = gt @ _transforms(np.random.default_rng(3), 4)
    for name in ("isotropic_transform_error", "anisotropic_transform_error"):
        for g, w in zip(getattr(metrics, name)(*_t(gt, est)), getattr(jax_metrics, name)(*_j(gt, est))):
            assert_close(g, w, name=name)
    raw = rng.normal(size=(60, 3)).astype(np.float32)
    ref, src = raw[:40] + 0.01, raw[20:] - 0.02
    raw_m, ref_m, src_m = np.arange(60) < 55, np.arange(40) < 37, np.arange(40) < 33
    t0, t1 = gt[0], est[0]
    assert_close(metrics.modified_chamfer_distance(*_t(raw, ref, src, t0, t1, raw_m, ref_m, src_m)),
                 jax_metrics.modified_chamfer_distance(*_j(raw, ref, src, t0, t1, raw_m, ref_m, src_m)), name="mcd")
    assert_close(metrics.modified_chamfer_distance(*_t(raw, ref, src, t0, t1)),
                 jax_metrics.modified_chamfer_distance(*_j(raw, ref, src, t0, t1)), name="mcd unmasked")
    corr_m = np.arange(40) < 30
    assert_close(metrics.inlier_ratio(*_t(ref, src, t0), 0.5, *_t(corr_m)),
                 jax_metrics.inlier_ratio(*_j(ref, src, t0), 0.5, *_j(corr_m)), name="inlier_ratio")
    assert_close(metrics.overlap_ratio(*_t(ref, src, t0), 0.7, *_t(ref_m, src_m)),
                 jax_metrics.overlap_ratio(*_j(ref, src, t0), 0.7, *_j(ref_m, src_m)), name="overlap_ratio")
    assert_close(metrics.registration_rmse(*_t(src, t0, t1, src_m)),
                 jax_metrics.registration_rmse(*_j(src, t0, t1, src_m)), name="rmse")


def _cloud(seed, n, m):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    q = np.concatenate([s[: m // 2], rng.uniform(0, 1, (m - m // 2, 3)).astype(np.float32)])
    s_m = rng.uniform(size=n) < 0.9
    q_m = rng.uniform(size=m) < 0.9
    return q, s, q_m, s_m


@pytest.mark.parametrize("method", ["approx", "brute", "bucket"])
def test_radius_search_methods(method):
    q, s, q_m, s_m = _cloud(4, 400, 150)
    got = neighbors.radius_search(*_t(q, s, q_m, s_m), 0.12, 24, 64, method=method)
    want = jax_neighbors.radius_search(*_j(q, s, q_m, s_m), 0.12, 24, 64, method=method)
    assert got.dtype == torch.int32
    assert_tables_match(got, want, q, s, name=method)
    assert (to_np(got) < 400).sum() > 300


def test_radius_search_bucketed_cell_capacity():
    """A cell capacity below the cells' counts: both packages offer the same
    first supports of each cell, in key order."""
    q, s, q_m, s_m = _cloud(5, 500, 100)
    got = neighbors.radius_search_bucketed(*_t(q, s, q_m, s_m), 0.2, 16, 32, cell_capacity=8)
    want = jax_neighbors.radius_search_bucketed(*_j(q, s, q_m, s_m), 0.2, 16, 32, cell_capacity=8)
    assert_tables_match(got, want, q, s, name="capacity 8")


def test_knn_search():
    q, s, q_m, s_m = _cloud(6, 120, 50)
    s_m[:] = False
    s_m[:7] = True  # fewer valid supports than k: sentinel slots
    got_idx, got_sq = neighbors.knn_search(*_t(q, s, q_m, s_m), 10, 16)
    want_idx, want_sq = jax_neighbors.knn_search(*_j(q, s, q_m, s_m), 10, 16)
    np.testing.assert_array_equal(to_np(got_idx), np.asarray(want_idx))
    assert_close(got_sq, want_sq, name="sq_dists")


def test_partitions():
    q, s, q_m, s_m = _cloud(7, 300, 40)
    nodes, node_m, points, point_m = q, q_m, s, s_m
    got = partition.get_point_to_node_indices(*_t(points, nodes, point_m, node_m), return_counts=True)
    want = jax_partition.get_point_to_node_indices(*_j(points, nodes, point_m, node_m), return_counts=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    got = partition.point_to_node_partition(*_t(points, nodes), 12, *_t(point_m, node_m), return_count=True)
    want = jax_partition.point_to_node_partition(*_j(points, nodes), 12, *_j(point_m, node_m), return_count=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    got = partition.knn_partition(*_t(points, nodes), 9, *_t(point_m, node_m), return_distance=True)
    want = jax_partition.knn_partition(*_j(points, nodes), 9, *_j(point_m, node_m), return_distance=True)
    assert_close(got[0], want[0], name="knn distances")
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(want[2]))
    got = partition.ball_query_partition(*_t(points, nodes), 0.1, 9, *_t(point_m, node_m), return_count=True)
    want = jax_partition.ball_query_partition(*_j(points, nodes), 0.1, 9, *_j(point_m, node_m), return_count=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    assert 0 < int(to_np(got[2]).sum()) < 9 * int(node_m.sum())


def test_correspondence_extractors():
    rng = np.random.default_rng(8)
    score = rng.normal(size=(30, 25)).astype(np.float32)
    for mutual, threshold, limit in ((False, 0.0, 16), (True, 0.5, 40)):
        got = correspondence.extract_correspondences_from_scores(*_t(score), mutual, threshold, limit)
        want = jax_corr.extract_correspondences_from_scores(*_j(score), mutual, threshold, limit)
        masks = np.asarray(want[3])
        np.testing.assert_array_equal(to_np(got[3]), masks)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(to_np(g)[masks], np.asarray(w)[masks])
    got = correspondence.extract_correspondences_topk(*_t(score), 12)
    want = jax_corr.extract_correspondences_topk(*_j(score), 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def _patches(seed, p=10, k=8, n=60):
    rng = np.random.default_rng(seed)
    ref_knn = rng.integers(0, n + 1, (30, k)).astype(np.int32)
    src_knn = rng.integers(0, n + 1, (30, k)).astype(np.int32)
    ref_corr = rng.integers(0, 30, p).astype(np.int32)
    src_corr = rng.integers(0, 30, p).astype(np.int32)
    ref_pts = rng.uniform(-1, 1, (p, k, 3)).astype(np.float32)
    src_pts = (ref_pts + rng.normal(0, 0.05, ref_pts.shape)).astype(np.float32)
    ref_m, src_m = rng.uniform(size=(p, k)) < 0.85, rng.uniform(size=(p, k)) < 0.85
    logits = rng.normal(size=(p, k + 1, k + 1)).astype(np.float32) + 4.0 * np.pad(np.eye(k), ((0, 1), (0, 1)))
    scores = (logits - np.log(np.exp(logits).sum(axis=(1, 2), keepdims=True))).astype(np.float32)
    return ref_knn, src_knn, ref_corr, src_corr, ref_pts, src_pts, ref_m, src_m, scores


def test_node_correspondences_to_dense_and_overlaps():
    ref_knn, src_knn, ref_corr, src_corr, ref_pts, src_pts, ref_m, src_m, scores = _patches(9)
    rng = np.random.default_rng(10)
    corr_mat = rng.uniform(size=(10, 8, 8)) < 0.3
    score_mat = rng.uniform(size=(10, 8, 8)).astype(np.float32)
    args = (ref_corr, src_corr, ref_knn, src_knn, ref_knn < 60, src_knn < 60, corr_mat, score_mat)
    got = correspondence.node_correspondences_to_dense(*_t(*args), 50)
    want = jax_corr.node_correspondences_to_dense(*_j(*args), 50)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    t = _transforms(rng, 1)[0]
    t[:3, :3], t[:3, 3] = np.eye(3), 0.01
    got = correspondence.patch_overlap_ratios(*_t(ref_pts, src_pts, ref_m, src_m, t), 0.08)
    want = jax_corr.patch_overlap_ratios(*_j(ref_pts, src_pts, ref_m, src_m, t), 0.08)
    for g, w in zip(got, want):
        assert_close(g, w, name="overlap ratios")


@pytest.mark.parametrize("use_global_score", [False, True])
def test_point_matching(use_global_score):
    *_, ref_pts, src_pts, ref_m, src_m, scores = _patches(11)
    node_scores = np.random.default_rng(12).uniform(size=10).astype(np.float32)
    args = (ref_pts, src_pts, ref_m, src_m, scores, node_scores)
    kw = dict(k=2, mutual=True, confidence_threshold=0.01, use_global_score=use_global_score, correspondence_limit=90)
    got = correspondence.point_matching(*_t(*args), **kw)
    want = jax_corr.point_matching(*_j(*args), **kw)
    masks = np.asarray(want.corr_masks)
    np.testing.assert_array_equal(to_np(got.corr_masks), masks)
    assert 10 < masks.sum() < 90
    assert_close(got.corr_scores, want.corr_scores, name="scores")
    assert_close(to_np(got.ref_corr_points)[masks], np.asarray(want.ref_corr_points)[masks], name="ref points")
    assert_close(to_np(got.src_corr_points)[masks], np.asarray(want.src_corr_points)[masks], name="src points")


def test_knn_interpolate_and_global_avgpool():
    q, s, q_m, s_m = _cloud(13, 200, 60)
    feats = np.random.default_rng(13).normal(size=(200, 8)).astype(np.float32)
    table = jax_neighbors.radius_search(*_j(q, s, q_m, s_m), 0.15, 10, 64)
    got = kpconv.knn_interpolate(*_t(feats, q, s, np.asarray(table)), 4)
    want = jax_kpconv.knn_interpolate(*_j(feats, q, s), table, 4)
    assert_close(got, want, name="knn_interpolate")
    assert_close(kpconv.global_avgpool(*_t(feats, s_m)), jax_kpconv.global_avgpool(*_j(feats, s_m)), name="avgpool")


@pytest.mark.parametrize("strided", [False, True])
def test_layer_norm_blocks(strided):
    """The layer_norm=True ResidualBlock (its UnaryBlocks and norm_conv
    LayerNorms; upstream names `<block>.norm.weight`) and ConvBlock."""
    q, s, q_m, s_m = _cloud(14, 160, 60 if strided else 160)
    if not strided:
        q, q_m = s, s_m
    feats = np.random.default_rng(14).normal(size=(160, 16)).astype(np.float32)
    table = np.asarray(jax_neighbors.radius_search(*_j(q, s, q_m, s_m), 0.2, 20, 64))
    block = jax_kpconv.ResidualBlock(16, 32, 15, 0.2, 0.15, 4, strided=strided, layer_norm=True)
    args = (feats, q, s, table, q_m, s_m)
    variables = block.init(jax.random.key(14), *_j(*args))
    want = block.apply(variables, *_j(*args))
    port = load_jax_variables(kpconv.ResidualBlock(16, 32, 15, 0.2, 0.15, 4, strided=strided, layer_norm=True),
                              variables)
    assert "norm_conv.weight" in port.state_dict() and "unary2.norm.weight" in port.state_dict()
    with torch.no_grad():
        got = port(*_t(*(a[None] for a in args)))[0]
    assert_close(got, want, name="ResidualBlock")
    conv = jax_kpconv.ConvBlock(16, 8, 15, 0.2, 0.15, 4, layer_norm=True)
    variables = conv.init(jax.random.key(15), *_j(*args[:5]))
    want = conv.apply(variables, *_j(*args[:5]))
    port = load_jax_variables(kpconv.ConvBlock(16, 8, 15, 0.2, 0.15, 4, layer_norm=True), variables)
    with torch.no_grad():
        got = port(*_t(*(a[None] for a in args[:5])))[0]
    assert_close(got, want, name="ConvBlock")
