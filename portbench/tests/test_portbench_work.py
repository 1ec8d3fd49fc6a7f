"""The work counters against hand counts at tiny shapes: valid work only,
the radius search on the pairs within the radius, Sinkhorn over valid
entries, MFU's split between bf16 and f32 contractions."""

import dataclasses

import pytest
import torch

from portbench.reference.config import config_from_dict
from portbench.work import counts as counts_mod
from portbench.work import embedding, peaks, radius, sinkhorn, step


def test_embedding_counts_the_valid_nodes_only():
    f, b = embedding.forward(n=2, c=4, k=3)
    assert f == 2 * 2 * 2 * 4 * 4 * (1 + 3)  # 2 n^2 C^2 (1 + k)
    assert b == 4 * (2 * 3 + 2 * 3 * 3 + 2 * 16 + 2 * 4 + 2) + 4 * 2 * 2 * 4
    fb, bb = embedding.backward(n=2, c=4)
    assert fb == 4 * 2 * 2 * 4 * 4
    # at full caps with half the nodes valid the count is a quarter of the padded one
    assert embedding.forward(512, 256, 3)[0] * 4 == embedding.forward(1024, 256, 3)[0]
    assert embedding.seconds(495e12, 0.0) == pytest.approx(1.0)  # divided by dense TF32


def test_radius_counts_pairs_within_the_radius_not_all_pairs():
    q = torch.tensor([[0.0, 0, 0], [5.0, 0, 0], [0.0, 0, 0]])
    s = torch.tensor([[0.1, 0, 0], [0.0, 0.5, 0], [3.0, 0, 0], [0.2, 0, 0]])
    qm = torch.tensor([True, True, False])
    sm = torch.tensor([True, True, True, False])
    # query 0 reaches supports 0 and 1 (support 3 is invalid); query 1 none; query 2 is invalid
    assert radius.pairs_within(q, s, qm, sm, 1.0) == 2
    assert radius.pairs_within(q, s, qm, sm, 1.0, chunk=1) == 2
    flops, bytes_ = radius.work(2, 3, 2, 4)
    assert flops == 8 * 2 and bytes_ == 13 * 5 + 4 * 2 * 4
    assert radius.seconds(67e12, 0.0) == pytest.approx(1.0)  # f32 outside the tensor cores


def test_sinkhorn_counts_valid_entries_and_no_sfu_rate():
    flops, bytes_ = sinkhorn.work([(2, 3)], iterations=10)
    entries = 3 * 4  # (m + 1)(n + 1) with the dustbin
    assert flops == 10 * (2 * 5 * entries + 2 * 2 * (3 + 4))
    assert bytes_ == 4 * (2 * entries + 3 + 4)
    assert sinkhorn.work([(0, 0), (2, 3)], 10)[0] == flops + 10 * (10 * 1 + 4 * 2)
    assert sinkhorn.seconds(67e12, 0.0) == pytest.approx(1.0)


def _cloud(points, neighbors, subsampling, nodes=4):
    return counts_mod.CloudCounts(points, neighbors, subsampling, torch.full((nodes,), 3))


def test_mfu_splits_bf16_kpconv_from_f32():
    cfg = config_from_dict(__import__("json").load(open(__import__("os").path.join(
        __import__("portbench.harness").harness.ROOT, "portbench/configs/3dmatch-stage4.json")))["config"])
    pc = counts_mod.PairCounts((_cloud([100, 50, 20, 8], [900, 400, 150, 40], [300, 100, 30]),) * 2, [])
    t = step.step_tally(cfg, pc, [(3, 4)], train=False)
    assert set(t.flops) == {"bf16", "f32"}
    f32_cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, dtype="float32"))
    t32 = step.step_tally(f32_cfg, pc, [(3, 4)], train=False)
    assert set(t32.flops) == {"f32"}
    assert t32.flops["f32"] == pytest.approx(t.flops["f32"] + t.flops["bf16"])
    assert t.seconds() == pytest.approx(t.flops["bf16"] / peaks.BF16_FLOPS + t.flops["f32"] / peaks.TF32_FLOPS)
    # the first KPConv by hand: geometry 2 E K 3 (f32), neighbor sum 2 E K Cin and weights 2 n K Cin Cout (bf16)
    one = step.Tally(train=False)
    step._kpconv(one, "bf16", 100, 900, 15, 1, 64, True)
    assert one.flops == {"f32": 2 * 900 * 15 * 3, "bf16": 2 * 900 * 15 + 2 * 100 * 15 * 64}
    trained = step.Tally(train=True)
    step._kpconv(trained, "bf16", 100, 900, 15, 1, 64, True)
    assert trained.flops["bf16"] == 2 * 900 * 15 + 2 * (2 * 100 * 15 * 64)  # first layer: weight gradient only
    assert step.step_tally(cfg, pc, [(3, 4)], train=True).seconds() > t.seconds()


def test_pair_counts_come_from_the_reference_pyramid():
    from portbench.reference.pyramid import build_registration_inputs

    g = torch.Generator().manual_seed(0)
    pts = torch.rand((300, 3), generator=g) * 0.5
    masks = torch.arange(300) < 250
    data = build_registration_inputs(pts, masks, pts, masks, 3, 0.05, 0.125, (20, 20, 20), (300, 120, 40))
    cfg = type("C", (), {})()
    cfg.backbone = type("B", (), {"fine_level": 1, "init_radius": 0.125})()
    cfg.capacities = type("P", (), {"neighbor_limits": (20, 20, 20)})()
    cfg.model = type("M", (), {"num_points_in_patch": 8})()
    pc = counts_mod.pair_counts(data["ref"], data["src"], cfg)
    cloud = pc.clouds[0]
    assert cloud.points[0] == 250
    table = data["ref"]["neighbors"][0]
    assert cloud.neighbors[0] == int(((table < 300) & masks[:, None]).sum())
    assert len(pc.searches) == 2 * (3 * 3 - 2)
    nq, ns, within, limit = pc.searches[0]
    assert (nq, ns, limit) == (250, 250, 20)
    assert within >= cloud.neighbors[0]  # the limit caps the table, not the pairs within the radius
    assert int(cloud.patch_sizes.max()) <= 8


def test_tables_tie_at_the_radius():
    """A point at the radius itself may be in one search's row and not in
    another's that rounds d^2 the other way: a tie, not a mismatch; a point
    well inside the radius missing from a row is a mismatch."""
    import numpy as np

    from portbench.tables import table_mismatches

    q = np.array([[0.0, 0.0, 0.0]])
    s = np.array([[1.0, 0.0, 0.0], [0.5, 0.0, 0.0]])
    n = 2
    at_radius_ours, at_radius_theirs = np.array([[0, n]]), np.array([[n, n]])
    _, bad, _ = table_mismatches(at_radius_ours, at_radius_theirs, q, s, scaled=True, radius=1.0)
    assert bad == []
    _, bad, _ = table_mismatches(at_radius_ours, at_radius_theirs, q, s, scaled=True)
    assert len(bad) == 1  # without the radius the copied rule calls it a mismatch
    inside_ours, inside_theirs = np.array([[1, n]]), np.array([[n, n]])
    _, bad, _ = table_mismatches(inside_ours, inside_theirs, q, s, scaled=True, radius=1.0)
    assert len(bad) == 1
