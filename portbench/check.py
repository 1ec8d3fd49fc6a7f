"""How `correct` is decided: the program's outputs against the plain reference.

Inference follows the program stage by stage from the program's own state:
the pyramid's segment sums use float atomics, so two runs of one pyramid,
the program's own included, differ in the last bit of some centroids, and
through the 3DMatch backbone's bf16 contractions such a bit reaches the
features at the size of a precision step. So each stage is recomputed by
the reference from the program's inputs to that stage, and the stage's
output is compared:

* pyramid: each level re-subsampled from the program's level below (level 0
  against the raw cloud sent), and every radius search rerun on the
  program's points; tables compared up to ties;
* backbone: the reference's KPConv-FPN on the program's pyramid;
* transformer: the reference's on the program's coarse backbone features;
* proposals: the program's node pairs must be a top-k of the reference's
  scores on the program's coarse features;
* matching: the reference's partition, patch scores and Sinkhorn loop on
  the program's fine features and node pairs;
* registration: the reference's local-to-global registration on the
  program's patches and matching scores.

Training follows the set-up's first three steps, on the program's
pyramids (checked as above), from the same weights and target draws:
each step's loss, the first gradient by leaf, the change of the
parameters over the three steps by leaf.

The control puts the reference in the program's place at the precision
below the configuration's: the pyramid's coordinates and distances in
bf16, every f32 product in TF32.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Dict, List

import numpy as np
import torch

from portbench import tables
from portbench.reference import plain_kernels, pyramid as ref_pyramid
from portbench.reference.config import config_from_dict
from portbench.reference.geotransformer import GeoTransformer
from portbench.reference.losses import overall_loss
from portbench.reference.registration import local_to_global_registration
from portbench.reference.subsample import grid_subsample

INF = float("inf")
BAD_ROWS_ENOUGH = 50  # a table comparison stops once this many rows differ beyond ties


@contextlib.contextmanager
def tf32(enabled: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference_model(spec: dict, state: Dict[str, torch.Tensor], device) -> GeoTransformer:
    """The reference at the configuration's sizes, with the run's weights;
    its buffers (kernel points) are its own."""
    model = GeoTransformer(config_from_dict(spec["config"])).to(device)
    missing, unexpected = model.load_state_dict(state, strict=False)
    buffers = {name for name, _ in model.named_buffers()}
    if unexpected or set(missing) - buffers:
        raise RuntimeError(f"weights do not fit the reference: missing {missing}, unexpected {unexpected}")
    return model


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))


def _max_abs(x: torch.Tensor) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def _table_rows(ours, theirs, q, s, radius) -> int:
    """Rows of two tables that differ beyond ties (`tables.table_mismatches`,
    scaled ties, ties at the radius), counted up to `BAD_ROWS_ENOUGH`."""
    differ = ((torch.sort(ours, 1).values != torch.sort(theirs, 1).values).any(1) | (ours[:, 0] != theirs[:, 0]))
    rows = torch.nonzero(differ).flatten()
    if rows.numel() == 0:
        return 0
    bad = 0
    q_np, s_np = q.double().cpu().numpy(), s.double().cpu().numpy()
    for chunk in torch.split(rows, 256):
        idx = chunk.cpu().numpy()
        _, found, _ = tables.table_mismatches(ours[chunk].cpu().numpy(), theirs[chunk].cpu().numpy(),
                                              q_np[idx], s_np, scaled=True, radius=radius)
        if found and not bad:
            print(f"table row beyond ties (query rows {len(q_np)}, supports {len(s_np)}, chunk offset "
                  f"{int(chunk[0])}): {found[0]}", file=sys.stderr)
        bad += len(found)
        if bad >= BAD_ROWS_ENOUGH:
            break
    return bad


def _program_tables(pyr: dict) -> List[torch.Tensor]:
    out = []
    for i in range(len(pyr["points"])):
        out.append(pyr["neighbors"][i])
        if i < len(pyr["points"]) - 1:
            out += [pyr["subsampling"][i], pyr["upsampling"][i]]
    return out


def pyramid_readings(cfg, raw: dict, data: dict) -> Dict[str, float]:
    """pyramid_points: the largest coordinate gap (m) of any level against
    the reference's subsample of the program's level below (level 0 against
    the raw cloud), inf where the valid points differ; pyramid_tables: rows
    differing beyond ties from the reference's searches on the program's
    points."""
    bb, caps = cfg.backbone, cfg.capacities
    gap, rows = 0.0, 0
    for side in ("ref", "src"):
        pts, msk = data[side]["points"], data[side]["masks"]
        if not torch.equal(msk[0], raw[f"{side}_masks"]):
            return {"pyramid_points": INF, "pyramid_tables": INF}
        gap = max(gap, float((pts[0] - raw[f"{side}_points"]).abs().max()))
        v = bb.init_voxel_size
        for i in range(1, bb.num_stages):
            v *= 2.0
            sub, sub_m = grid_subsample(pts[i - 1], msk[i - 1], v, caps.points[i])
            if not torch.equal(sub_m, msk[i]):
                return {"pyramid_points": INF, "pyramid_tables": INF}
            gap = max(gap, float((sub - pts[i]).abs().max()))
        searches = ref_pyramid._searches(list(pts), list(msk), bb.init_radius, caps.neighbor_limits)
        theirs = plain_kernels.radius_search_group(searches, caps.search_chunk)
        for (q, s, _, _, radius, _), a, b in zip(searches, _program_tables(data[side]), theirs):
            rows += _table_rows(a, b, q, s, radius)
    return {"pyramid_points": gap, "pyramid_tables": float(rows)}


def _stack_pair(ref: Dict, src: Dict) -> Dict:
    return {key: tuple(torch.stack([r, s], dim=0) for r, s in zip(ref[key], src[key])) for key in ref}


def _score_matrix(ref_feats, src_feats, ref_masks, src_masks, dual: bool) -> torch.Tensor:
    """The dense coarse scores of `superpoint_matching` (dual-normalized)."""
    from portbench.reference.pairwise import pairwise_distance

    valid = ref_masks[:, None] & src_masks[None, :]
    scores = torch.where(valid, torch.exp(-pairwise_distance(ref_feats, src_feats, normalized=True)), 0.0)
    if dual:
        ref_norm = scores / torch.clamp(scores.sum(dim=1, keepdim=True), min=1e-12)
        src_norm = scores / torch.clamp(scores.sum(dim=0, keepdim=True), min=1e-12)
        scores = torch.where(valid, ref_norm * src_norm, 0.0)
    return scores


@torch.no_grad()
def infer_readings(ref: GeoTransformer, raw: dict, data: dict, backbone: List[torch.Tensor], out: dict
                   ) -> Dict[str, float]:
    """The numbers compared for one inference pair (see the module's doc)."""
    from portbench.reference.index import masked_gather
    from portbench.reference.partition import point_to_node_partition

    cfg = ref.cfg
    r = pyramid_readings(cfg, raw, data)
    fine, k_patch = cfg.backbone.fine_level, cfg.model.num_points_in_patch
    ref_pyr, src_pyr = data["ref"], data["src"]

    feats = torch.stack([data["ref_feats"], data["src_feats"]], dim=0)
    theirs = ref.backbone(feats, _stack_pair(ref_pyr, src_pyr))
    r["backbone"] = max(_rel(a, b) for a, b in zip(backbone, theirs))

    pts_c = (ref_pyr["points"][-1], src_pyr["points"][-1])
    msk_c = (ref_pyr["masks"][-1], src_pyr["masks"][-1])
    h0, h1 = ref.transformer(pts_c[0][None], pts_c[1][None], backbone[-1][0][None], backbone[-1][1][None],
                             msk_c[0][None], msk_c[1][None])
    gap = 0.0
    for h, key, m in ((h0[0], "ref_feats_c", msk_c[0]), (h1[0], "src_feats_c", msk_c[1])):
        h = h / torch.clamp(torch.linalg.norm(h, dim=1, keepdim=True), min=1e-12)
        gap = max(gap, float((h - out[key])[m].abs().max()))
    r["transformer"] = gap

    # partition: the reference's, on the program's fine and coarse levels
    knn = []
    for pyr in (ref_pyr, src_pyr):
        _, node_masks, idx, kmask = point_to_node_partition(pyr["points"][fine], pyr["points"][-1], k_patch,
                                                            pyr["masks"][fine], pyr["masks"][-1])
        knn.append((node_masks, idx, kmask))

    # proposals: the program's node pairs must be a top-k of the reference's scores
    scores = _score_matrix(out["ref_feats_c"], out["src_feats_c"], knn[0][0], knn[1][0],
                           cfg.coarse_matching.dual_normalization)
    k = cfg.coarse_matching.num_correspondences
    ri, si = out["ref_node_corr_indices"].long(), out["src_node_corr_indices"].long()
    kth = torch.topk(scores.reshape(-1), k).values[-1]
    picked = scores[ri, si]
    distinct = torch.unique(ri * scores.shape[1] + si).numel() == k
    r["proposals"] = float(torch.clamp(kth - picked.min(), min=0.0) / kth) if distinct else INF

    # the matched patches: points and validity against the reference's partition
    ref_idx, src_idx = knn[0][1][ri], knn[1][1][si]
    ref_knn_masks, src_knn_masks = knn[0][2][ri], knn[1][2][si]
    ref_pts = masked_gather(ref_pyr["points"][fine], ref_idx, 0.0)
    src_pts = masked_gather(src_pyr["points"][fine], src_idx, 0.0)
    same = ((ref_knn_masks == out["ref_node_corr_knn_masks"]).all(1) & (src_knn_masks == out["src_node_corr_knn_masks"]).all(1)
            & (ref_pts == out["ref_node_corr_knn_points"]).all(2).all(1)
            & (src_pts == out["src_node_corr_knn_points"]).all(2).all(1))
    r["patches"] = float((~same).sum())

    # matching: patch scores and the Sinkhorn loop on the program's fine features, over the patches that agree
    if not bool(same.any()):
        r["matching"] = INF
    else:
        ref_f = masked_gather(out["ref_feats_f"], ref_idx, 0.0)
        src_f = masked_gather(out["src_feats_f"], src_idx, 0.0)
        ms = torch.matmul(ref_f, src_f.transpose(1, 2)) / out["ref_feats_f"].shape[1] ** 0.5
        ms = ref.optimal_transport(ms, ref_knn_masks, src_knn_masks)
        ones = torch.ones_like(ref_knn_masks[:, :1])
        valid = torch.cat([ref_knn_masks, ones], 1)[:, :, None] & torch.cat([src_knn_masks, ones], 1)[:, None, :]
        valid = valid & same[:, None, None]
        r["matching"] = float((ms.exp() - out["matching_scores"].exp())[valid].abs().max())
        r["info.matching_log"] = float((ms - out["matching_scores"])[valid].abs().max())

    # registration on the program's patches and matching scores
    fm = cfg.fine_matching
    lgr = local_to_global_registration(
        out["ref_node_corr_knn_points"], out["src_node_corr_knn_points"], out["ref_node_corr_knn_masks"],
        out["src_node_corr_knn_masks"], out["matching_scores"], picked, k=fm.topk,
        acceptance_radius=fm.acceptance_radius, mutual=fm.mutual, confidence_threshold=fm.confidence_threshold,
        use_dustbin=fm.use_dustbin, use_global_score=fm.use_global_score,
        correspondence_threshold=fm.correspondence_threshold,
        correspondence_limit=cfg.capacities.correspondence_limit, num_refinement_steps=fm.num_refinement_steps,
    )
    r["transform"] = float((lgr.estimated_transform - out["estimated_transform"]).abs().max())
    return r


# ---------------------------------------------------------------- training


def leaf_gap(program: Dict[str, float], reference: Dict[str, float], keep) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference leaf's norm and the median leaf's."""
    names = [n for n in reference if n in keep]
    median = float(np.median([reference[n] for n in names]))
    return max(abs(program.get(n, INF) - reference[n]) / max(reference[n], median) for n in names)


def moved_leaves(grads: Dict[str, float]) -> set:
    """Leaves whose reference gradient is not nought to rounding: at least a
    thousandth of the median leaf's (a key's bias under softmax moves under
    Adam by round-off alone)."""
    median = float(np.median(list(grads.values())))
    return {n for n, g in grads.items() if g >= 1e-3 * median}


def train_readings(program: dict, reference: dict) -> Dict[str, float]:
    """program / reference: {"losses": [per step], "grads": {leaf: norm of the
    first gradient}, "changes": {leaf: norm of the change over the steps}}.
    The loss compared is the first step's: the later steps' losses move with
    the round-off that Adam's normalisation lifts to a full step on leaves
    of near-nought gradient (bf16-rounded gradients, atomic sums), and are
    reported beside it (`info.`), not compared."""
    keep = moved_leaves(reference["grads"])
    losses = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(program["losses"], reference["losses"])]
    if len(losses) != len(reference["losses"]) or not all(map(math.isfinite, losses)):
        losses = [INF] * len(reference["losses"])
    readings = {
        "loss": losses[0],
        "first_grad": leaf_gap(program["grads"], reference["grads"], keep),
        "change": leaf_gap(program["changes"], reference["changes"], keep),
    }
    for i, gap in enumerate(losses[1:], 2):
        readings[f"info.loss_step{i}"] = gap
    return readings


def reference_train(model: GeoTransformer, state0: Dict[str, torch.Tensor], steps: List[dict], lr: float,
                    weight_decay: float) -> dict:
    """The reference's own steps from `state0`: forward with sampled targets
    (from the generator state a step gives, or the draws continued from the
    last one given), overall loss, backward, Adam with
    coupled decay; a leaf the loss does not reach gets a zero gradient."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    opt = torch.optim.Adam(params.values(), lr=lr, weight_decay=weight_decay)
    record = {"losses": [], "grads": {}, "changes": {}}
    gen = None
    for i, step in enumerate(steps):
        opt.zero_grad(set_to_none=True)
        if "generator_state" in step:
            gen = torch.Generator(device=step["generator_device"])
            gen.set_state(step["generator_state"])
        out = model(step["data"], training=True, generator=gen)
        loss = overall_loss(out, step["data"]["transform"], cfg.coarse_loss, cfg.fine_loss, cfg.loss)["loss"]
        loss.backward()
        record["losses"].append(float(loss.detach()))
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if i == 0:
            record["grads"] = {n: float(p.grad.norm()) for n, p in params.items()}
        opt.step()
    record["changes"] = {n: float((p.detach() - state0[n]).norm()) for n, p in params.items()}
    return record


# ----------------------------------------------------------------- control


def control_pyramid(cfg, raw: dict) -> dict:
    """The pyramid one precision below f32: each level's centroids stored in
    bf16 (the voxels are the f32 ones, so the levels keep their points) and
    every radius search's distances computed in bf16."""
    bb, caps = cfg.backbone, cfg.capacities
    levels = {}
    for side in ("ref", "src"):
        pts, msk = [raw[f"{side}_points"]], [raw[f"{side}_masks"]]
        v = bb.init_voxel_size
        for i in range(1, bb.num_stages):
            v *= 2.0
            sub, sub_m = grid_subsample(pts[-1], msk[-1], v, caps.points[i])
            pts.append(sub.bfloat16().float())
            msk.append(sub_m)
        levels[side] = (pts, msk)
    searches = []
    for side in ("ref", "src"):
        pts, msk = levels[side]
        searches += ref_pyramid._searches([p.bfloat16() for p in pts], msk, bb.init_radius, caps.neighbor_limits)
    found = plain_kernels.radius_search_group(searches, caps.search_chunk)
    n_ref = 3 * bb.num_stages - 2
    data = {"ref": ref_pyramid._pyramid(*levels["ref"], found[:n_ref]),
            "src": ref_pyramid._pyramid(*levels["src"], found[n_ref:])}
    for side in ("ref", "src"):
        data[f"{side}_feats"] = torch.ones((raw[f"{side}_points"].shape[0], 1), device=raw["ref_points"].device)
    if "transform" in raw:
        data["transform"] = raw["transform"]
    return data
