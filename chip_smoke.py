#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ref_geotransformer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi) and
     its largest SM clock (for the SFU's rate);
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a, one process per source);
     hold LGR's read-back-free SVD (ops/svd.py) against torch.linalg.svd on
     its probe batch, bit for bit, for the installed torch;
  3. each kernel against its plain PyTorch version on the card, on the
     inputs the main paths give it: the structure embedding and its
     backward on the demo pair's node clouds (N = 512 and 1024, C = 256,
     k = 3; a seeded cotangent for the backward, whose two launches must
     agree bit for bit) and on the first 307 nodes of the N = 512 cloud
     (the coarse cap of REF_GT_CAPS_SCALE=0.3, a ragged last tile),
     Sinkhorn on the matching scores and masks of a demo-pair forward
     (B = 256, 65 x 65, 100 iterations) and on the KITTI / ModelNet patch
     size (B = 256, 129 x 129: seeded scores, ~5% of the rows and columns
     masked, so ~10% of the entries); error against the stated bound, and
     the time of each beside its bound (the embedding's products at the
     f32-accurate tensor-core rate; Sinkhorn's exps at the SFU's rate);
     and the embedding forward under the benchmark cells' prefix node masks
     (310, 350 and 410 of 1024 nodes at C = 256; 210 and 318 of 384 at
     C = 128; seeded clouds): its valid entries bit for bit those of a launch
     without masks and the rest 0, its time beside the full grid's, the
     bound of the valid work and the share of the grid's blocks computed;
  4. the inference path (pyramid + forward, 3DMatch stage-4 at published
     widths, bf16 backbone, seeded random weights) at demo and at full
     capacities: kernel launches of one forward (one radius-search launch
     for the 20 searches of the pair's pyramids), finite transform, ms/pair,
     pairs/s, peak memory;
  5. the inference path in f32 at demo capacities, kernels against the
     plain versions, same weights and inputs;
  6. one f32 train step at demo capacities, kernels against plain, same
     weights, pyramid and target keys: the losses and the gradients of the
     embedding's projections;
  7. the train path at full capacities (the model of phase 4, Adam,
     sampled targets, one pair per step): a warm-up step, then timed steps,
     each with finite losses, no step skipped by the non-finite guard, and
     2 forward and 2 backward embedding launches and no Sinkhorn launch;
     ms/step and peak memory;
  8. the 3DMatch CLI chain on the card, through its entry points' main(argv):
     a fixture tree in a temporary directory (4 train and 2 val pairs of
     15000 points drawn from the demo scans, no augmentation), trainval for
     one epoch at full capacities (every step: finite losses, none skipped,
     2 forward and 2 backward embedding launches, no Sinkhorn launch; each
     validation pair: 2 forward embedding and 1 Sinkhorn launch; epoch-1 and
     snapshot written), test of epoch-1 over the val benchmark (one .npz
     with the full key set per pair, 1 Sinkhorn launch per pair), and the
     offline eval with lgr and svd (finite summaries, RR in [0, 1]); the
     trainer's ms/step over its warm steps beside phase 7's, the host gap
     before each step, the first step on its own, the tester's pairs/s,
     peak memory;
  9. the LineMod encoder experiment (ModelNet rpmnet stage 4: 3 stages,
     fine level 0, published widths and capacities 1024/640/256, 1000-point
     clouds, f32) on a fixture BOP tree and a ModelNet fixture in a temporary
     directory: each kernel against its plain version on one forward's own
     inputs (the embedding forward and backward at N = 256, Sinkhorn at
     64 x 129 x 129), with times and bounds; the f32 forward and one f32
     AdamW train step, kernels against plain; trainval_encoder for 6
     iterations (snapshot and validation on the 2 test frames every 3, a
     2-iteration warmup: every step finite and applied, 2 + 2 embedding
     launches a step, 1 Sinkhorn launch per validation pair, iter-3, iter-6
     and the rolling snapshot written, the learning rate of every update and
     of every log line the schedule's); test of iter-6 on 2 LineMod pairs
     and 1 ModelNet pair (finite RRE/RTE, RR in [0, 1], 1 Sinkhorn launch a
     pair); ms per training iteration and the host gap, the tester's
     pairs/s, peak memory;
 10. the KITTI stage-5 experiment (5 stages, fine level 1, published widths
     and capacities 30720/10240/3072/1024/384, f32) on a fixture odometry
     tree in a temporary directory (2 + 2 train, 2 val and 2 test pairs of
     20000-point scans over 40 m, the ground thinned with range as a
     LiDAR's rings are): every level of every val and test scan under its
     cap, the coarse level at least half full; each kernel against its
     plain version on one forward's own inputs (the embedding forward and
     backward at N = 384, C = 128, k = 3, Sinkhorn at 256 x 129 x 129),
     with times and bounds; the f32 forward and one f32 Adam train step,
     kernels against plain; trainval for one epoch, test of epoch-1 and
     eval lgr / svd with phase 8's checks, every pyramid the chain built
     (augmented train pairs too) under its caps; the calibrated capacities
     and neighbor limits of the train pairs beside the config's; ms/step
     over the warm steps, the host gap, the tester's pairs/s, peak memory;
 11. Cordi's DDPM (published widths: 40 x 80 sampled nodes, 100 steps, 8
     layers x 8 heads x 64, FFN 2048) on phase 9's fixture tree and its
     iter-6 encoder: one denoiser application, the epsilon-loss at pinned
     (t, e_rand) and a 3-step reverse diffusion on pinned zs, each on the
     card and on the CPU at the same weights and inputs (bound CORDI_BOUND,
     which TF32 products miss); the time of one application against its
     f32 bound, and one layer's attention core as explicit matmuls beside
     scaled_dot_product_attention; train_cordi for 4 iterations (snapshot
     and validation on the 2 test frames every 2: every loss finite and
     every update applied, 2 forward embedding, 0 backward and 1 Sinkhorn
     launch per encoded pair, the encoder's weights bit-identical to its
     file, iter-2, iter-4 and the snapshot written); test of iter-6 with
     Cordi's iter-4 on 2 pairs (each sampled (40, 80) matrix finite, PIR
     and IIR in [0, 1]); ms per warm DDPM iteration, the host gap, s per
     100-step sample, peak memory;
 12. data parallelism: (a) the 3DMatch epoch trainer at full capacities
     (run_trainval, one epoch over a fixture tree of 4 pairs) on the plain
     path, then through the data-parallel path in a 1-rank NCCL group
     (gradients all-reduced, losses reduced), twice, then plain again: every
     step finite, applied, 2 + 2 embedding launches, ms/step over the warm
     steps and peak memory of each, and the parameters after each step
     against the first plain run's; with deterministic algorithms, 2 steps
     of each path on a 2-pair tree, whose parameters must agree bit for
     bit; the NCCL all-reduce's own time over the gradient buffer and its
     bytes, and the whole reduction of a step; (c) trainval_encoder
     --multihost for 2 iterations in that group (rank 0 writes iter-2 and
     the snapshot; 2 + 2 launches an iteration, 2 + 1 a validation pair);
     (b) two processes spawned on the one card, a gloo group (NCCL refuses
     two ranks on one device), 2 steps each at demo capacities on their
     shards of the 4-pair tree with deterministic algorithms and pinned
     target keys: the two ranks' parameters bit-identical, and bit-identical
     to one process's 2 steps over the same global batches of 2 pairs with
     the learning rate times 2; a rank that fails fails the phase;
 13. the rest of the model surface, on the 3DMatch stage-4 model at full
     capacities and published widths: (a) act_dtype bfloat16 (bf16
     activations in the backbone): one forward with kernels against the
     plain path (2 + 0 + 1 launches, bf16 inside the backbone, f32 out),
     then the f32 and the bf16 activation paths in turns (f32, bf16, bf16,
     f32): ms/pair and peak memory over 10 forwards, ms/step and peak memory
     over 3 train steps (finite, unskipped, 2 + 2 + 0 launches each); (b) a
     seeded model saved in the upstream layout (the DDP prefix, div_term),
     converted by `python -m ref_geotransformer_tpu_torch.utils.convert_checkpoint
     --experiment 3dmatch`, then `demo --full --snapshot --dump` with
     deterministic algorithms: its transform bit-identical to the source
     model's, the .npz and the three PLYs written; (c) a variant model
     (reduction_a mean, use_dustbin, attention dropout 0.1): one train step
     with a generator (finite, applied, no kernel launch: the mean has no
     kernel), one forward (1 Sinkhorn launch, the dustbin's (K+1)^2 scores)
     with the Sinkhorn kernel against plain on its inputs, the mean
     embedding's ms at N = 1024 and the step's peak memory; (d) a LineMod
     encoder validation with corr_dump_dir on phase 9's tree: the 6 PLYs of
     its first pair written, 2 + 0 + 1 launches per pair and for the dump;
 14. the scripts and the host C++: (a) `native` built with g++ (seconds
     printed); on a raw LiDAR scan of a KITTI frame's size (120000 points
     over 40 m) `grid_subsample_native` at 0.3 m against the card's
     `grid_subsample` (same count, centroids within 1e-5 in voxel order) and
     `radius_neighbors_native` against the card's `radius_search` at KITTI
     level 0 (radius 1.275 m, limit 40; per-row sets, ties within NATIVE_TIE),
     host ms beside card ms; (b) `tools.downsample_kitti` over a tree of 2 x 2
     such scans: .npy files equal to native's, one pair's pyramid under
     KITTI's caps at every level; (c) `eval_dgr --benchmark val --epochs 1 1`
     over phase 8's dumps copied to features/val-epoch-1: best epoch 1 with
     the RR of `eval --method lgr`; (d) the wrappers `eval.sh epoch-1 val` on
     phase 8's tree and KITTI's `eval.sh epoch-1` on phase 10's, run by bash
     from outside the repository: exit 0, one .npz per pair, a finite summary
     with RR in [0, 1]; (e) the overfit probe through `run_probe`, from the
     JAX probe's initial weights (`jax.random.key(0)`, drawn with numpy): (i)
     the JAX slow test's regime (scale 0.06, 4 pairs, 30 steps, an evaluation
     every 5, lr 1e-4) with its gates unchanged (no step skipped, the train
     loss falling, RR over the last 3 evaluations >= 0.9, best RMSE < 0.1),
     (ii) OVERFIT_PROBE_r03.json's (scale 0.25, 2 pairs, 200 steps, every
     20): every row finite and unskipped, the train loss falling; for both,
     2P + 2P + 0 launches a step and 2P + 0 + P an evaluation of P pairs,
     ms/step, peak memory, the trajectory written to chiprun_out/, and after
     each run the embedding kernels (forward and backward) on the trained
     model and the coarse nodes of its last pair, and Sinkhorn on the scores
     of that pair's evaluation, against their plain versions;
 15. the radius-search kernel (csrc/radius_search.cu): its build at limits
     1, 38 and 128 (registers, local memory, which must be none, shared
     memory, blocks an SM); then the grouped search against its plain
     version on the groups the main paths give it, recorded as the pyramids
     are built: the demo pair's one group of 2 x 10 at demo and at full caps,
     the KITTI pyramid (5 stages) of phase 14's raw scan downsampled on the
     card, a LineMod fixture pair's 2 x 7, a probe (i) pair's 2 x 10 (caps
     scaled by 0.06), and seeded ragged clouds (M and N off the kernel's
     tiles, invalid queries, duplicated supports, limits 1 to 128, fewer
     valid supports than the row holds): no row beyond ties (RADIUS_TIE),
     rows differing at ties counted, two launches bit-identical, each search
     as it is alone, int32 with the sentinel N, the slices of each search;
     the kernel's time beside its bound and the plain version's for each
     full-caps level-0 search alone and for the 20 searches of a pair's
     pyramids in one launch; build_registration_inputs and the inference
     path per pair at demo and full caps, and probe (i)'s pyramids, the
     plain version and the kernel in turns (plain, kernel, kernel, plain),
     one radius-search launch of 20 searches a pair with the kernel.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
TIMED_ITERS = 10
TRAIN_STEPS = 3
# phase 8: the fixture tree of the CLI chain
FIXTURE_TRAIN_PAIRS, FIXTURE_VAL_PAIRS, FIXTURE_POINTS = 4, 2, 15000
# phase 9: the LineMod encoder experiment
LINEMOD_TRAIN_FRAMES, LINEMOD_TEST_FRAMES = 4, 2
LINEMOD_ITERATIONS, LINEMOD_SNAPSHOT_STEPS, LINEMOD_WARMUP = 6, 3, 2
VAL_ITERS = 100  # the trainer's cap on a validation's batches: the 2 test frames all run
# phase 11: Cordi's DDPM on phase 9's encoder (its validation takes at most
# 20 pairs: the 2 test frames all run)
CORDI_ITERATIONS, CORDI_SNAPSHOT_STEPS, CORDI_CHECK_STEPS = 4, 2, 3
# the card against the CPU, over the CPU result's largest magnitude: f32
# products and sums in other orders through 8 layers, each renormalized by
# its LayerNorms (an f32 step reads ~1e-6 alone); a product in TF32 (10-bit
# mantissa) reads ~1e-3, so the bound tells TF32 turned on apart
CORDI_BOUND = 1e-4
# phase 12: data parallelism. (a) DP_STEPS full-caps steps per run, one epoch
# over a fixture tree of DP_STEPS pairs; (b) DP_GLOO_RANKS processes of
# DP_GLOO_STEPS steps each at demo caps on the same tree; (c) trainval_encoder
# for DP_ENCODER_ITERATIONS iterations. DP_BOUND holds the parameters after
# each step against the plain path's, bit for bit.
DP_STEPS, DP_GLOO_RANKS, DP_GLOO_STEPS, DP_ENCODER_ITERATIONS = 4, 2, 2, 2
# the comparisons run with deterministic algorithms (~8x slower a step), over
# DP_DET_STEPS steps in (a): two runs of the plain path differ otherwise by
# 2 lr after one step, Adam's first update flipping its sign on a parameter
# whose gradient is rounding noise (PERF.md, data parallelism), so no bound short of the
# update's own size holds; deterministic, the paths agree bit for bit
DP_DET_STEPS = 2
DP_TIMEOUT_S = 300
# phase 13 (c): the attention dropout of the variant model
VARIANT_DROPOUT = 0.1
# phase 10: the KITTI odometry fixture (pairs per sequence: 2 train
# sequences, 1 val, 1 test), scans sized like 0.3 m-downsampled ones
KITTI_PAIRS_PER_SEQUENCE, KITTI_POINTS, KITTI_RADIUS = 2, 20000, 40.0
# phase 14: raw LiDAR scans of one KITTI frame's size (a Velodyne HDL-64
# sweep, ~120k points) over phase 10's 40 m disc, the ground 1.73 m below the
# sensor (KITTI's mount height), for the host C++ kernels and the downsampling
# tool (a tree of 2 sequences x 2 frames)
RAW_SCAN_POINTS, SENSOR_HEIGHT, RAW_SEQUENCES, RAW_FRAMES = 120000, 1.73, ("00", "01"), 2
# native against the card's radius_search: the card ranks by the f32 form
# |q|^2 - 2 q.s + |s|^2, whose rounding grows with the squared norms (~1e-4 in
# d^2 at 40 m), so a neighbor in only one row must tie with the row's farthest
# within 1e-6 of 1 + |q|^2 + |s|^2
NATIVE_TIE = 1e-6
# phase 14 (e), the overfit probe: (i) the JAX slow test's regime and gates
# (tests/test_overfit_registration.py:28-53); (ii) OVERFIT_PROBE_r03.json's
PROBE_GATED = {"steps": 30, "scale": 0.06, "pairs": 4, "log_every": 5, "lr": 1e-4}
PROBE_LONG = {"steps": 200, "scale": 0.25, "pairs": 2, "log_every": 20, "lr": None}
WRAPPER_TIMEOUT_S = 300
# phase 15: the radius-search kernel against its plain version. Both rank the
# f32 form |q|^2 - 2 q.s + |s|^2, the dot product summed in other orders (FMAs
# in the kernel, cuBLAS in the plain version), so a neighbor in only one row
# must tie with the row's farthest within RADIUS_TIE of 1 + |q|^2 + |s|^2
# (NATIVE_TIE's reasoning); the seeded ragged cloud (RAGGED_QUERIES x
# RAGGED_SUPPORTS in a unit cube, its first RAGGED_DUPLICATES supports
# repeated) takes the kernel's longest rows
RADIUS_TIE = 1e-6
RAGGED_QUERIES, RAGGED_SUPPORTS, RAGGED_DUPLICATES = 3001, 5003, 500
# the keys each test dump must hold (tests/test_fixture_cli_e2e.py)
REQUIRED_NPZ_KEYS = {
    "ref_points", "src_points", "ref_points_c", "src_points_c", "ref_feats_c", "src_feats_c",
    "ref_node_corr_indices", "src_node_corr_indices", "ref_corr_points", "src_corr_points", "corr_scores",
    "gt_node_corr_overlaps",
}
# forward, abs: kernel and plain version both take precise sin/cos and atan2
# and f32-accurate products (the kernel's as three TF32 tensor-core passes on
# split operands), so they differ by f32 rounding (~1e-5); a one-pass TF32
# kernel reads ~1e-3 here, so the bound tells a lost split apart
EMBEDDING_BOUND = 1e-4
# backward, relative to each gradient's largest magnitude: f32 sums over N^2
# (up to 10^6) rows, in another order than the plain version's, and
# f32-accurate products (split TF32 on the tensor cores; a copy with one
# TF32 pass reads ~4e-4 to 9e-4 here, PERF.md, so the bound tells a lost
# split apart). The two also recompute the angle projections in another
# order, so a branch within rounding of the winner may win in one and lose
# in the other; the cotangent is zeroed where the two best branches lie
# within NEAR_TIE without tying exactly (exact ties, all k angles equal,
# stay in; the error with the near ties left in is printed too).
EMBEDDING_BWD_BOUND = 1e-4
NEAR_TIE = 1e-3
RAGGED_NODES = 307  # the coarse cap of REF_GT_CAPS_SCALE=0.3: max(128, int(1024 * 0.3))
SINKHORN_BOUND = 1e-3  # abs on valid entries; 100 dependent f32 log-sum-exp rounds, summed in another order
PATH_FEATS_BOUND = 1e-3  # abs on the normalized coarse features of valid nodes, kernels vs plain, f32 path
# f32 train step, kernels vs plain: the losses to 1e-4 relative (the
# forwards differ by ~2e-5 on the coarse features); the projection gradients
# to 1e-2 of the largest magnitude among the four: besides the f32
# differences of the whole path, near-tied angle branches may route a
# pair's cotangent differently in the kernel's recomputation and in the
# plain forward's max. (The bias gradients are analytically zero, holding
# rounding noise only: a per-channel constant added to every pair's
# embedding shifts each query's attention scores by one constant, which the
# softmax cancels; so no gradient is measured against its own magnitude.)
TRAIN_LOSS_BOUND = 1e-4
TRAIN_GRAD_BOUND = 1e-2
# H100 SXM data-sheet peaks: f32 outside the tensor cores, TF32 on the
# tensor cores (an f32-accurate product there takes three TF32 products), HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_PRODUCT_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES_PER_S = 3.35e12
# exp2 / log2 on the special function units: 16 a clock per SM (times the
# SM count and the SM clock that the card reports)
SFU_PER_CLOCK_PER_SM = 16


def cuda_ms(fn, iters=TIMED_ITERS, warmup=2):
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def coarse_feats_gaps(a, b, data):
    """(valid, padded): the largest gaps of ref_feats_c between two forwards
    on `data`, over the rows of valid and of padded coarse nodes. The
    embedding kernel leaves its entries of padded nodes 0 where the plain
    version computes them, and no caller reads them, so the padded rows of a
    kernel run and a plain run differ by design: only the valid rows are
    held to PATH_FEATS_BOUND."""
    valid = data["ref"]["masks"][-1]
    gap = (a["ref_feats_c"] - b["ref_feats_c"]).abs()
    return float(gap[valid].max()), float(gap[~valid].max()) if bool((~valid).any()) else 0.0


def roofline(flops, nbytes, peak_flops):
    """(bound_ms, bound_by): the larger of the operations over `peak_flops`
    and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def embedding_work(n, k, c, backward):
    """FMA operations (2 per multiply-add) of the products, and bytes: each
    input read once, each output written once. Forward: k + 1 projections
    per pair; the (N, N, C) output written. Backward: k projections
    recomputed and k + 1 weight-gradient products per pair; the (N, N, C)
    cotangent read. Sines, cosines and atan2 are not counted."""
    products = (2 * k + 1) if backward else (k + 1)
    flops = products * 2.0 * n * n * c * c
    small = 4 * (n * 3 + n * k * 3 + c // 2 + 2 * (c * c + c))
    return flops, 4.0 * n * n * c + small


# (N, C, valid node counts) of the masked embedding rows of phase 3: the
# coarse clouds of the 3DMatch cells (C = 256) and of the KITTI cells (C = 128)
MASKED_EMBEDDING_CASES = ((1024, 256, (310, 350, 410)), (384, 128, (210, 318)))


def masked_embedding_rows(ck, dev):
    """The forward kernel under prefix node masks (MASKED_EMBEDDING_CASES)
    on seeded clouds, k = 3: checked against a launch without masks (valid
    entries bit for bit, the rest 0), timed beside the full grid, with the
    bound of the valid work and the share of blocks that computed."""
    import torch

    rows = []
    for n, c, counts in MASKED_EMBEDDING_CASES:
        gen = torch.Generator(device=dev).manual_seed(n + c)
        points = torch.rand((n, 3), generator=gen, device=dev) * 4.0 - 2.0
        ref_vectors = (torch.rand((n, 3, 3), generator=gen, device=dev) - 0.5) * 0.6
        div_term = torch.exp(torch.arange(0, c, 2, dtype=torch.float32, device=dev) * (-math.log(10000.0) / c))
        w = [torch.randn(s, generator=gen, device=dev) / math.sqrt(c) for s in ((c, c), (c,), (c, c), (c,))]
        args = (points, ref_vectors, div_term, *w, 0.2, 180.0 / (15.0 * math.pi), "max")
        with torch.no_grad():
            full = ck.geometric_embedding(*args)
            full_ms = cuda_ms(lambda: ck.geometric_embedding(*args))
            for valid in counts:
                masks = torch.arange(n, device=dev) < valid
                got = ck.geometric_embedding(*args, masks)
                pair = masks[:, None] & masks[None, :]
                exact = torch.equal(got[pair], full[pair]) and not bool(got[~pair].any())
                del got, pair
                launched, computed = ck.geometric_embedding.launched_blocks, int(ck.geometric_embedding.computed_blocks)
                ms = cuda_ms(lambda: ck.geometric_embedding(*args, masks))
                share = (int(ck.geometric_embedding.computed_blocks) - computed) / (
                    ck.geometric_embedding.launched_blocks - launched)
                bound_ms, bound_by = roofline(*embedding_work(valid, 3, c, backward=False), PEAK_F32_PRODUCT_FLOPS)
                print(f"[kernel] geo_embedding N={n} C={c}, {valid} valid nodes (a prefix): {ms:.4f} ms against "
                      f"{full_ms:.4f} ms without masks; bound of the valid work {bound_ms:.4f} ms ({bound_by}), "
                      f"{100 * bound_ms / ms:.1f}% of it; {100 * share:.2f}% of the blocks computed; valid entries "
                      f"bit for bit, the rest 0: {exact}")
                check(exact, f"geo_embedding N={n} with {valid} valid nodes: valid entries differ from the launch "
                             "without masks, or an entry with a padded node is not 0")
                rows.append({"n": n, "c": c, "valid": valid, "ms": ms, "full_ms": full_ms, "bound_ms": bound_ms,
                             "blocks_computed": share})
            del full
    return rows


def sinkhorn_work(b, m1, n1, iters):
    """Per iteration a row and a column log-sum-exp pass over B x M1 x N1:
    ~5 operations per entry each (add, max, subtract, exp, sum); bytes: the
    scores read and the result written, and the marginals read; exps and
    logs (on the SFU): one exp per entry and pass, one log per row and
    column."""
    flops = 10.0 * b * m1 * n1 * iters
    nbytes = 4.0 * (2 * b * m1 * n1 + b * m1 + b * n1)
    sfu = (2.0 * b * m1 * n1 + b * (m1 + n1)) * iters
    return flops, nbytes, sfu


def sinkhorn_bound(b, m1, n1, iters, sfu_per_s):
    """(bound_ms, bound_by, term): the largest of the operations over the
    f32 rate, the bytes over the memory rate and the exps and logs over the
    SFU rate; bound_by is "operations" for the exps too, term names which."""
    flops, nbytes, sfu = sinkhorn_work(b, m1, n1, iters)
    terms = {"operations (f32)": flops / PEAK_F32_FLOPS, "bytes": nbytes / PEAK_BYTES_PER_S,
             "operations (exps and logs on the SFU)": sfu / sfu_per_s}
    term = max(terms, key=terms.get)
    return 1e3 * terms[term], "bytes" if term == "bytes" else "operations", term


def reset_counts(ck):
    ck.geometric_embedding.launches = 0
    ck.geometric_embedding_bwd.launches = 0
    ck.sinkhorn_log_norm.launches = 0
    ck.radius_search_group.launches = 0
    ck.radius_search_group.searches = 0


def read_counts(ck):
    return (ck.geometric_embedding.launches, ck.geometric_embedding_bwd.launches, ck.sinkhorn_log_norm.launches)


def epoch_chain(ck, dev, tag, exp, n_train, n_val, test_argv, eval_argv, dump_dir, bare_ms=None):
    """trainval for one epoch at the config's capacities, test of epoch-1 and
    the offline eval with lgr and svd, through the entry points' main(argv)
    (`exp` holds the experiment's config, trainval, test and eval modules);
    every train step finite, applied, with 2 forward and 2 backward
    embedding launches and no Sinkhorn launch; 2 forward embedding and 1
    Sinkhorn launch per validation and test pair; epoch-1 and the snapshot
    written; one .npz with the full key set per test pair under `dump_dir`;
    finite summaries with RR in [0, 1]. Returns the kernel launches of its
    train, validation and test passes."""
    import glob
    import math
    import time

    import numpy as np
    import torch

    from ref_geotransformer_tpu_torch.engine import tester as tester_mod
    from ref_geotransformer_tpu_torch.engine import trainer as trainer_mod

    records = {"train": [], "val": [], "test": []}

    def counted(kind, fn):
        """fn, recording for each call its start (host clock), its time to a
        synchronize, its kernel launches and its result."""
        def wrapper(*args, **kwargs):
            before = read_counts(ck)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            records[kind].append({"start": t0, "ms": 1e3 * (time.perf_counter() - t0), "out": out,
                                  "launches": tuple(x - y for x, y in zip(read_counts(ck), before))})
            return out
        return wrapper

    patched = [(trainer_mod, "train_batch"), (trainer_mod, "eval_batch"), (tester_mod, "forward")]
    originals = [getattr(module, name) for module, name in patched]
    for (module, name), kind in zip(patched, ("train", "val", "test")):
        setattr(module, name, counted(kind, getattr(module, name)))
    try:
        reset_counts(ck)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer = exp.trainval.main(["--max_epoch", "1", "--log_steps", "1", "--device", "cuda"])
        train_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        steps, vals = records["train"], records["val"]
        check(len(steps) == n_train, f"{tag} trainval: {len(steps)} train steps, expected {n_train}")
        for i, r in enumerate(steps):
            values = {key: float(v) for key, v in r["out"].items()}
            print(f"[{tag}:train] step {i + 1}: loss {values['loss']:.6f}, c_loss {values['c_loss']:.6f}, "
                  f"f_loss {values['f_loss']:.6f}; {r['ms']:.2f} ms to a synchronize; launches: geo_embedding "
                  f"{r['launches'][0]}, geo_embedding_bwd {r['launches'][1]}, sinkhorn {r['launches'][2]}")
            check(all(math.isfinite(v) for v in values.values()), f"{tag} trainval step {i + 1}: non-finite loss")
            check(r["launches"] == (2, 2, 0), f"{tag} trainval step {i + 1}: expected 2 forward, 2 backward "
                                              f"embedding launches and no Sinkhorn launch, got {r['launches']}")
        check(trainer.state.skipped == 0 and trainer.state.count == n_train,
              f"{tag} trainval: {trainer.state.skipped} steps skipped, {trainer.state.count} applied")
        check(len(vals) == n_val, f"{tag} trainval: {len(vals)} validation pairs, expected {n_val}")
        for i, r in enumerate(vals):
            check(r["launches"] == (2, 0, 1), f"{tag} validation pair {i + 1}: expected 2 forward embedding and 1 "
                                              f"Sinkhorn launch, got {r['launches']}")
            check(all(math.isfinite(float(v)) for v in r["out"].values()), f"{tag} validation pair {i + 1}: non-finite")
        for name in ("epoch-1.pth.tar", "snapshot.pth.tar"):
            check(os.path.isfile(os.path.join(exp.config.SNAPSHOT_DIR, name)), f"{tag} trainval wrote no {name}")
        # the trainer's warm cycles, steps 2 on: from the previous step's
        # end to this one's (loader, copies, log and event writes, step);
        # the host gap is the part before the step starts. The first
        # step, of a newly built model, is reported on its own.
        ends = [r["start"] + r["ms"] / 1e3 for r in steps]
        cycle = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
        gap = [1e3 * (r["start"] - a) for a, r in zip(ends, steps[1:])]
        trainer_ms, gap_ms = sum(cycle) / len(cycle), sum(gap) / len(gap)
        bare = "" if bare_ms is None else f", against {bare_ms:.2f} ms/step for phase 7's bare train_step"
        print(f"[{tag}:train] one epoch in {train_s:.2f} s (model init, {n_train} steps, validation, snapshots); "
              f"trainer {trainer_ms:.2f} ms/step over the warm steps 2-{n_train} "
              f"({', '.join('%.2f' % t for t in cycle)} ms, each from the previous step's end){bare}; host gap "
              f"before a step {gap_ms:.2f} ms ({', '.join('%.2f' % t for t in gap)}); first step "
              f"{steps[0]['ms']:.2f} ms; validation {', '.join('%.2f' % r['ms'] for r in vals)} ms/pair; no step "
              f"skipped; peak memory {train_peak:.2f} GiB")

        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        exp.test.main([*test_argv, "--snapshot", "epoch-1", "--device", "cuda"])
        test_s = time.perf_counter() - t0
        tests = records["test"]
        check(len(tests) == n_val, f"{tag} test: {len(tests)} pairs, expected {n_val}")
        for i, r in enumerate(tests):
            check(r["launches"] == (2, 0, 1), f"{tag} test pair {i + 1}: expected 2 forward embedding and 1 "
                                              f"Sinkhorn launch, got {r['launches']}")
        dumps = sorted(glob.glob(os.path.join(dump_dir, "*.npz")))
        check(len(dumps) == n_val, f"{tag} test wrote {len(dumps)} .npz dumps")
        for path in dumps:
            with np.load(path) as data:
                missing = REQUIRED_NPZ_KEYS - set(data.keys())
                check(not missing, f"{os.path.basename(path)}: missing keys {missing}")
                check(np.isfinite(data["estimated_transform"]).all(), f"{path}: non-finite transform")
        forward_s = sum(r["ms"] for r in tests) / 1e3
        print(f"[{tag}:test] {len(tests)} pairs: {len(tests) / forward_s:.2f} pairs/s in the forward "
              f"({', '.join('%.2f' % r['ms'] for r in tests)} ms/pair); {test_s:.2f} s in all (model, snapshot, "
              f"loader, dumps); peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              f"{len(dumps)} .npz dumps with the full key set")

        for method in ("lgr", "svd"):
            summary = exp.eval.main([*eval_argv, "--method", method])
            values = {k: v for k, v in summary.items() if k != "scenes"}
            check(all(math.isfinite(v) for v in values.values()), f"{tag} eval {method}: non-finite summary {values}")
            check(0.0 <= values["RR"] <= 1.0, f"{tag} eval {method}: RR {values['RR']} outside [0, 1]")
            print(f"[{tag}:eval] {method}: " + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
    finally:
        for (module, name), fn in zip(patched, originals):
            setattr(module, name, fn)
    return tuple(sum(r["launches"][i] for kind in records.values() for r in kind) for i in range(3))


@contextlib.contextmanager
def scoped_env(keys, **values):
    """`keys` cleared from the environment and `values` set, all restored after."""
    saved = {key: os.environ.get(key) for key in keys}
    try:
        for key in keys:
            os.environ.pop(key, None)
        os.environ.update(values)
        yield
    finally:
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value


def cli_chain(ck, dev, bare_ms, tmp):
    """Phase 8 on the card, its tree and outputs under `tmp` (kept for phase
    14); returns the kernel launches of its train, validation and test
    passes."""
    from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import config, fixture, test, trainval
    from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import eval as offline_eval

    exp = types.SimpleNamespace(config=config, trainval=trainval, test=test, eval=offline_eval)

    root = os.path.join(tmp, "3DMatch")
    scans = [os.path.join(ROOT, "data", "demo", f"{name}.npy") for name in ("ref", "src")]
    fixture.make_fixture_tree(root, n_train=FIXTURE_TRAIN_PAIRS, n_val=FIXTURE_VAL_PAIRS, points=FIXTURE_POINTS,
                              real_base=scans)
    keys = ("REF_GT_3DMATCH_ROOT", "REF_GT_OUTPUT_ROOT", "REF_GT_USE_AUG", "REF_GT_CAPS_SCALE",
            "REF_GT_NEIGHBOR_LIMITS", "REF_GT_VAL_EVERY")
    with scoped_env(keys, REF_GT_3DMATCH_ROOT=root, REF_GT_OUTPUT_ROOT=os.path.join(tmp, "output"),
                    REF_GT_USE_AUG="0"):
        print(f"[cli] fixture tree: {FIXTURE_TRAIN_PAIRS} train and {FIXTURE_VAL_PAIRS} val pairs of "
              f"{FIXTURE_POINTS} points from the demo scans; caps {config.make_cfg().capacities.points}")
        return epoch_chain(ck, dev, "cli", exp, FIXTURE_TRAIN_PAIRS, FIXTURE_VAL_PAIRS, ["--benchmark", "val"],
                           ["--benchmark", "val"], os.path.join(config.FEATURE_DIR, "val"), bare_ms=bare_ms)


def expected_lr(optim, total, step):
    """The warmup-cosine rate of update `step`, in float64 from its definition
    (utils/torch.py:153-170 of the reference), to hold the port's against."""
    import math

    if step < optim.warmup_steps:
        return optim.lr * (optim.eta_init + (1.0 - optim.eta_init) / optim.warmup_steps * step)
    t = min(max((step - optim.warmup_steps) / max(total - optim.warmup_steps, 1), 0.0), 1.0)
    return optim.lr * (optim.eta_min + 0.5 * (1.0 - optim.eta_min) * (1.0 + math.cos(math.pi * t)))


LINEMOD_ENV_KEYS = ("REF_GT_LINEMOD_ROOT", "REF_GT_MODELNET_ROOT", "REF_GT_OUTPUT_ROOT", "REF_GT_WARMUP", "REF_GT_LR",
                    "REF_GT_DDPM_STEPS")


def linemod_env(tmp):
    """The LineMod experiment of phases 9 and 11 pointed at the trees and
    outputs under `tmp`, with a warmup of LINEMOD_WARMUP iterations."""
    return scoped_env(LINEMOD_ENV_KEYS, REF_GT_LINEMOD_ROOT=os.path.join(tmp, "bop"),
                      REF_GT_MODELNET_ROOT=os.path.join(tmp, "modelnet"), REF_GT_OUTPUT_ROOT=os.path.join(tmp, "output"),
                      REF_GT_WARMUP=str(LINEMOD_WARMUP))


def linemod_chain(ck, dev, card, kc, tmp):
    """Phase 9 on the card, its trees and outputs under `tmp`; returns the
    kernel launches of its train, validation and test passes. `kc` holds
    main's kernel checks."""
    import math
    import re
    import time

    import torch

    from ref_geotransformer_tpu_torch import demo
    from ref_geotransformer_tpu_torch.data import PairLoader
    from ref_geotransformer_tpu_torch.data.datasets.linemod import LMODataset
    from ref_geotransformer_tpu_torch.engine import iter_trainer
    from ref_geotransformer_tpu_torch.engine.iter_trainer import make_warmup_cosine_schedule
    from ref_geotransformer_tpu_torch.engine.state import AdamWTrainState
    from ref_geotransformer_tpu_torch.engine.steps import ensure_pyramids, to_device, train_step
    from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import (
        config,
        fixture,
        test,
        trainval_encoder,
    )

    records = {"train": [], "val": [], "test": []}

    def counted(kind, fn):
        """fn, recording for each call its start (host clock), its time to a
        synchronize, its kernel launches, its result and, for a train step,
        the optimizer's count before and after and the rate it applied."""
        def wrapper(*args, **kwargs):
            state = args[1] if kind == "train" else None
            count = state.count if state is not None else None
            before = read_counts(ck)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record = {"start": t0, "ms": 1e3 * (time.perf_counter() - t0), "out": out,
                      "launches": tuple(x - y for x, y in zip(read_counts(ck), before))}
            if state is not None:
                record.update(count=(count, state.count), lr=state.optimizer.param_groups[0]["lr"])
            records[kind].append(record)
            return out
        return wrapper

    patched = [(iter_trainer, "train_batch"), (iter_trainer, "eval_batch"), (test, "forward")]
    originals = [getattr(module, name) for module, name in patched]
    for (module, name), kind in zip(patched, ("train", "val", "test")):
        setattr(module, name, counted(kind, getattr(module, name)))
    try:
        with linemod_env(tmp):
            lm_root, mn_root = os.path.join(tmp, "bop"), os.path.join(tmp, "modelnet")
            fixture.make_linemod_tree(os.path.join(lm_root, "linemod"), n_train=LINEMOD_TRAIN_FRAMES,
                                      n_test=LINEMOD_TEST_FRAMES)
            fixture.make_modelnet_tree(mn_root)
            cfg = config.make_cfg()
            print(f"[linemod] {card}: fixture BOP tree of {LINEMOD_TRAIN_FRAMES} train and {LINEMOD_TEST_FRAMES} "
                  f"test frames (one box object), a ModelNet fixture of 3 shapes; caps {cfg.capacities.points}, "
                  f"{config.LMO['points_limit']}-point clouds, K = {cfg.model.num_points_in_patch}, "
                  f"{cfg.coarse_matching.num_correspondences} correspondences")

            # 9.1 the kernels on one forward's own inputs
            dataset = LMODataset(lm_root, data_augmentation=False, points_limit=config.LMO["points_limit"],
                                 mode="test", seed=cfg.seed)
            pair, _ = next(PairLoader(dataset, cfg).iter_single())
            data = ensure_pyramids(cfg, to_device(pair, dev))
            model = demo.build_model(cfg, dev, seed=0)
            captured = {}
            hook = model.optimal_transport.register_forward_pre_hook(
                lambda module, inputs: captured.update(inputs=inputs))
            model(data)
            hook.remove()
            nodes, node_masks = data["src"]["points"][-1], data["src"]["masks"][-1]
            check(nodes.shape[0] == 256, f"linemod: {nodes.shape[0]} src nodes, expected 256")
            kc.check_embedding(model, nodes, node_masks)
            ot = model.optimal_transport
            with torch.no_grad():
                padded, log_mu, log_nu, _ = ot.prepare(*captured["inputs"])
            check(tuple(padded.shape) == (64, 129, 129), f"linemod: Sinkhorn batch {tuple(padded.shape)}")
            sinkhorn = kc.check_sinkhorn("LineMod path", padded, log_mu, log_nu, ot.num_iterations)
            gt = cfg.geotransformer
            rows = {"geo_embedding": (kc.emb_rows[-1][2], kc.roofline(*kc.embedding_work(256, gt.angle_k,
                                      gt.hidden_dim, backward=False), kc.peak_product)[0]),
                    "geo_embedding_bwd": (kc.bwd_rows[-1][3], kc.roofline(*kc.embedding_work(256, gt.angle_k,
                                          gt.hidden_dim, backward=True), kc.peak_product)[0]),
                    "sinkhorn": (sinkhorn["ms"], sinkhorn["bound_ms"])}
            for name, (ms, bound_ms) in rows.items():
                print(f"[linemod:kernel] {card}: {name} at the LineMod shapes: {ms:.4f} ms against a bound of "
                      f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of it")
            del model, captured, padded, log_mu, log_nu

            # 9.2 the f32 forward and one f32 AdamW train step, kernels against plain
            with_kernels = demo.build_model(cfg, dev, seed=1)
            plain = demo.build_model(cfg, dev, seed=1, use_kernels=False)
            a, b = with_kernels(data), plain(data)
            torch.cuda.synchronize()
            feats_err, padded_err = coarse_feats_gaps(a, b, data)
            print(f"[linemod:f32] {card}: forward, kernels vs plain: ref_feats_c {feats_err:.3e} on valid nodes "
                  f"(bound {PATH_FEATS_BOUND:.0e}; padded nodes {padded_err:.3e}, not compared)")
            check(feats_err <= PATH_FEATS_BOUND, f"linemod forward: ref_feats_c differs by {feats_err}")
            check(bool(torch.isfinite(a["estimated_transform"]).all()), "linemod forward: non-finite transform")
            del a, b
            schedule = make_warmup_cosine_schedule(cfg.optim.lr, LINEMOD_ITERATIONS, cfg.optim.warmup_steps,
                                                   cfg.optim.eta_init, cfg.optim.eta_min)
            grads, step_losses = [], []
            for model in (with_kernels, plain):
                state = AdamWTrainState(model, cfg.optim, schedule)
                losses = train_step(model, state, data, torch.Generator(device=dev).manual_seed(5))
                check(state.count == 1 and state.skipped == 0, "linemod f32 train step: the update was skipped")
                step_losses.append({key: float(v) for key, v in losses.items()})
                emb = model.transformer.embedding
                grads.append({f"{proj}.{leaf}": getattr(getattr(emb, proj), leaf).grad
                              for proj in ("proj_d", "proj_a") for leaf in ("weight", "bias")})
            loss_err = max(abs(step_losses[0][key] - step_losses[1][key]) / abs(step_losses[1][key])
                           for key in ("loss", "c_loss", "f_loss"))
            grad_scale = max(float(g.abs().max()) for g in grads[1].values())
            grad_errs = {name: float((g - grads[1][name]).abs().max()) / grad_scale for name, g in grads[0].items()}
            print(f"[linemod:f32] {card}: AdamW train step, kernels vs plain: loss {step_losses[0]['loss']:.6f} vs "
                  f"{step_losses[1]['loss']:.6f}; losses within {loss_err:.3e} relative (bound "
                  f"{TRAIN_LOSS_BOUND:.0e}); embedding gradients (largest magnitude {grad_scale:.3e}), error over it: "
                  + ", ".join(f"{name} {e:.3e}" for name, e in grad_errs.items()) + f" (bound {TRAIN_GRAD_BOUND:.0e})")
            check(all(math.isfinite(v) for s in step_losses for v in s.values()), "linemod f32 train: non-finite loss")
            check(loss_err <= TRAIN_LOSS_BOUND, f"linemod f32 train: losses differ by {loss_err}")
            check(all(e <= TRAIN_GRAD_BOUND for e in grad_errs.values()),
                  f"linemod f32 train: gradients differ: {grad_errs}")
            del with_kernels, plain, grads, data
            torch.cuda.empty_cache()

            # 9.3 trainval_encoder
            reset_counts(ck)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            trainer = trainval_encoder.main(["--max_iteration", str(LINEMOD_ITERATIONS), "--snapshot_steps",
                                             str(LINEMOD_SNAPSHOT_STEPS), "--log_steps", "1", "--device", "cuda"])
            train_s = time.perf_counter() - t0
            train_peak = torch.cuda.max_memory_allocated(dev) / 2**30
            steps, vals = records["train"], records["val"]
            check(len(steps) == LINEMOD_ITERATIONS, f"trainval_encoder: {len(steps)} steps, expected "
                                                    f"{LINEMOD_ITERATIONS}")
            for i, r in enumerate(steps):
                values = {key: float(v) for key, v in r["out"].items()}
                want_lr = expected_lr(cfg.optim, LINEMOD_ITERATIONS, i)
                print(f"[linemod:train] iteration {i + 1}: loss {values['loss']:.6f}, c_loss {values['c_loss']:.6f}, "
                      f"f_loss {values['f_loss']:.6f}; lr {r['lr']:.6e} (schedule {want_lr:.6e}); {r['ms']:.2f} ms "
                      f"to a synchronize; launches: geo_embedding {r['launches'][0]}, geo_embedding_bwd "
                      f"{r['launches'][1]}, sinkhorn {r['launches'][2]}")
                check(all(math.isfinite(v) for v in values.values()), f"iteration {i + 1}: non-finite loss")
                check(r["count"] == (i, i + 1), f"iteration {i + 1}: update not applied (count {r['count']})")
                check(abs(r["lr"] - want_lr) <= 1e-6 * want_lr, f"iteration {i + 1}: lr {r['lr']}, schedule {want_lr}")
                check(r["launches"] == (2, 2, 0), f"iteration {i + 1}: expected 2 forward, 2 backward embedding "
                                                  f"launches and no Sinkhorn launch, got {r['launches']}")
            check(trainer.state.skipped == 0 and trainer.state.count == LINEMOD_ITERATIONS,
                  f"trainval_encoder: {trainer.state.skipped} skipped, {trainer.state.count} applied")
            expected_vals = LINEMOD_ITERATIONS // LINEMOD_SNAPSHOT_STEPS * min(VAL_ITERS, LINEMOD_TEST_FRAMES)
            check(len(vals) == expected_vals, f"trainval_encoder: {len(vals)} validation pairs, expected {expected_vals}")
            for i, r in enumerate(vals):
                check(r["launches"] == (2, 0, 1), f"validation pair {i + 1}: expected 2 forward embedding and 1 "
                                                  f"Sinkhorn launch, got {r['launches']}")
                check(all(math.isfinite(float(v)) for v in r["out"].values()), f"validation pair {i + 1}: non-finite")
            for name in ("iter-3.pth.tar", "iter-6.pth.tar", "snapshot.pth.tar"):
                check(os.path.isfile(os.path.join(config.SNAPSHOT_ENCODER_DIR, name)), f"trainval wrote no {name}")
            with open(os.path.join(config.LOG_DIR, "train_encoder.log")) as f:
                logged = [float(m.group(1)) for m in re.finditer(r"iter: \d+/\d+,.* lr: ([-\d.e+]+)", f.read())]
            want_logged = [expected_lr(cfg.optim, LINEMOD_ITERATIONS, i) for i in range(1, LINEMOD_ITERATIONS + 1)]
            check(len(logged) == LINEMOD_ITERATIONS and all(abs(x - y) <= 5e-4 * y for x, y in
                                                            zip(logged, want_logged)),
                  f"train_encoder.log: logged rates {logged}, schedule {want_logged}")
            ends = [r["start"] + r["ms"] / 1e3 for r in steps]
            gap = [1e3 * (r["start"] - e) for e, r in zip(ends, steps[1:])]
            snap = {LINEMOD_SNAPSHOT_STEPS * k for k in range(1, LINEMOD_ITERATIONS // LINEMOD_SNAPSHOT_STEPS + 1)}
            plain_gaps = [g for i, g in enumerate(gap, start=1) if i not in snap]
            warm_ms = [r["ms"] for r in steps[1:]]
            val_ms = ", ".join("%.2f" % r["ms"] for r in vals)
            print(f"[linemod:train] {card}: {LINEMOD_ITERATIONS} iterations in {train_s:.2f} s (model init, "
                  f"snapshots, validation); {sum(warm_ms) / len(warm_ms):.2f} ms per training iteration over the warm "
                  f"iterations 2-{LINEMOD_ITERATIONS} ({', '.join('%.2f' % t for t in warm_ms)} ms to a "
                  f"synchronize); host gap before an iteration {sum(plain_gaps) / len(plain_gaps):.2f} ms "
                  f"({', '.join('%.2f' % t for t in plain_gaps)}; after a snapshot and validation: "
                  f"{', '.join('%.2f' % gap[i - 1] for i in sorted(snap) if i <= len(gap))}); first iteration "
                  f"{steps[0]['ms']:.2f} ms; validation {val_ms} ms/pair; logged rates {logged}; "
                  f"peak memory {train_peak:.2f} GiB")

            # 9.4 test on LineMod and on ModelNet
            torch.cuda.reset_peak_memory_stats(dev)
            summaries = {}
            for name, extra, pairs in (("LineMod", [], 2), ("ModelNet", ["--use_modelnet"], 1)):
                first = len(records["test"])
                t0 = time.perf_counter()
                summary = test.main(["--snapshot", f"iter-{LINEMOD_ITERATIONS}", "--num_pairs", str(pairs),
                                     "--device", "cuda", *extra])
                test_s = time.perf_counter() - t0
                tests = records["test"][first:]
                check(len(tests) == pairs, f"test {name}: {len(tests)} pairs, expected {pairs}")
                for i, r in enumerate(tests):
                    check(r["launches"] == (2, 0, 1), f"test {name} pair {i + 1}: expected 2 forward embedding and "
                                                      f"1 Sinkhorn launch, got {r['launches']}")
                check(math.isfinite(summary["RRE"]) and math.isfinite(summary["RTE"]),
                      f"test {name}: non-finite RRE/RTE {summary}")
                check(0.0 <= summary["RR"] <= 1.0, f"test {name}: RR {summary['RR']} outside [0, 1]")
                forward_s = sum(r["ms"] for r in tests) / 1e3
                summaries[name] = summary
                print(f"[linemod:test] {card}: {name}, {pairs} pairs: {pairs / forward_s:.2f} pairs/s in the forward "
                      f"({', '.join('%.2f' % r['ms'] for r in tests)} ms/pair), {test_s:.2f} s in all (model, "
                      f"snapshot, dataset); RRE {summary['RRE']:.3f} deg, RTE {summary['RTE']:.4f}, RR "
                      f"{summary['RR']:.2f} (random weights, 6 iterations: not a quality figure)")
            print(f"[linemod:test] {card}: peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    finally:
        for (module, name), fn in zip(patched, originals):
            setattr(module, name, fn)
    return tuple(sum(r["launches"][i] for kind in records.values() for r in kind) for i in range(3))


def kitti_chain(ck, dev, card, kc, tmp):
    """Phase 10 on the card, its tree and outputs under `tmp` (kept for
    phase 14); returns the kernel launches of its train, validation and
    test passes. `kc` holds main's kernel checks."""
    import math
    import time

    import torch

    from ref_geotransformer_tpu_torch import demo
    from ref_geotransformer_tpu_torch.data import PairLoader
    from ref_geotransformer_tpu_torch.data.calibration import calibrate_capacities, calibrate_neighbor_limits
    from ref_geotransformer_tpu_torch.data.datasets.kitti import OdometryKittiPairDataset
    from ref_geotransformer_tpu_torch.engine import steps as steps_mod
    from ref_geotransformer_tpu_torch.engine.state import TrainState
    from ref_geotransformer_tpu_torch.engine.steps import ensure_pyramids, to_device, train_step
    from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import config, fixture, test, trainval
    from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import eval as offline_eval

    exp = types.SimpleNamespace(config=config, trainval=trainval, test=test, eval=offline_eval)
    n_train, n_val = 2 * KITTI_PAIRS_PER_SEQUENCE, KITTI_PAIRS_PER_SEQUENCE
    splits = ((("00", KITTI_PAIRS_PER_SEQUENCE), ("01", KITTI_PAIRS_PER_SEQUENCE)), (("06", n_val),), (("08", n_val),))
    root = os.path.join(tmp, "Kitti")
    fixture.make_fixture_tree(root, splits, points=KITTI_POINTS, radius=KITTI_RADIUS, falloff=True)
    with scoped_env(("REF_GT_KITTI_ROOT", "REF_GT_OUTPUT_ROOT", "REF_GT_CAPS_SCALE"), REF_GT_KITTI_ROOT=root,
                    REF_GT_OUTPUT_ROOT=os.path.join(tmp, "output")):
        cfg = config.make_cfg()
        caps = cfg.capacities.points
        gt = cfg.geotransformer
        print(f"[kitti] {card}: fixture odometry tree of {n_train} train, {n_val} val and {n_val} test pairs, "
              f"scans of {KITTI_POINTS} points over {KITTI_RADIUS:.0f} m (the ground thinned with range); caps "
              f"{caps}, neighbor limits {cfg.capacities.neighbor_limits}, K = {cfg.model.num_points_in_patch}, "
              f"{cfg.coarse_matching.num_correspondences} correspondences, hidden {gt.hidden_dim}")

        # 10.1 every level of every unaugmented scan under its cap; the
        # coarse level at least half full
        for subset in ("val", "test"):
            for pair, meta in PairLoader(OdometryKittiPairDataset(root, subset), cfg).iter_single():
                data = ensure_pyramids(cfg, to_device(pair, dev))
                for side in ("ref", "src"):
                    counts = [int(m.sum()) for m in data[side]["masks"]]
                    print(f"[kitti:levels] {subset} {meta['scene_name']} {meta['ref_frame']}-{meta['src_frame']} "
                          f"{side}: " + ", ".join(f"{n}/{c}" for n, c in zip(counts, caps)))
                    check(all(n < c for n, c in zip(counts, caps)), f"kitti {subset} {side}: a level is full "
                                                                     f"(voxels may have been dropped): {counts}")
                    check(counts[-1] >= caps[-1] // 2, f"kitti {subset} {side}: coarse level {counts[-1]} of "
                                                       f"{caps[-1]}, under half")

        # 10.2 the kernels on one forward's own inputs (the last test pair)
        model = demo.build_model(cfg, dev, seed=0)
        captured = {}
        hook = model.optimal_transport.register_forward_pre_hook(
            lambda module, inputs: captured.update(inputs=inputs))
        out = model(data)
        hook.remove()
        nodes, node_masks = data["src"]["points"][-1], data["src"]["masks"][-1]
        check(nodes.shape[0] == caps[-1], f"kitti: {nodes.shape[0]} src nodes, expected {caps[-1]}")
        kc.check_embedding(model, nodes, node_masks)
        ot = model.optimal_transport
        with torch.no_grad():
            padded, log_mu, log_nu, _ = ot.prepare(*captured["inputs"])
        k1 = cfg.model.num_points_in_patch + 1
        check(tuple(padded.shape) == (cfg.coarse_matching.num_correspondences, k1, k1),
              f"kitti: Sinkhorn batch {tuple(padded.shape)}")
        sinkhorn = kc.check_sinkhorn("KITTI path", padded, log_mu, log_nu, ot.num_iterations)
        rows = {"geo_embedding": (kc.emb_rows[-1][2], kc.roofline(*kc.embedding_work(
                    caps[-1], gt.angle_k, gt.hidden_dim, backward=False), kc.peak_product)[0]),
                "geo_embedding_bwd": (kc.bwd_rows[-1][3], kc.roofline(*kc.embedding_work(
                    caps[-1], gt.angle_k, gt.hidden_dim, backward=True), kc.peak_product)[0]),
                "sinkhorn": (sinkhorn["ms"], sinkhorn["bound_ms"])}
        for name, (ms, bound_ms) in rows.items():
            print(f"[kitti:kernel] {card}: {name} at the KITTI shapes: {ms:.4f} ms against a bound of "
                  f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of it")
        check(bool(torch.isfinite(out["estimated_transform"]).all()), "kitti forward: non-finite transform")
        del model, out, captured, padded, log_mu, log_nu

        # 10.3 the f32 forward and one f32 Adam train step, kernels against plain
        with_kernels = demo.build_model(cfg, dev, seed=1)
        plain = demo.build_model(cfg, dev, seed=1, use_kernels=False)
        a, b = with_kernels(data), plain(data)
        torch.cuda.synchronize()
        feats_err, padded_err = coarse_feats_gaps(a, b, data)
        print(f"[kitti:f32] {card}: forward, kernels vs plain: ref_feats_c {feats_err:.3e} on valid nodes "
              f"(bound {PATH_FEATS_BOUND:.0e}; padded nodes {padded_err:.3e}, not compared)")
        check(feats_err <= PATH_FEATS_BOUND, f"kitti forward: ref_feats_c differs by {feats_err}")
        del a, b
        grads, step_losses = [], []
        for model in (with_kernels, plain):
            state = TrainState(model, cfg.optim, steps_per_epoch=1)
            losses = train_step(model, state, data, torch.Generator(device=dev).manual_seed(5))
            check(state.count == 1 and state.skipped == 0, "kitti f32 train step: the update was skipped")
            step_losses.append({key: float(v) for key, v in losses.items()})
            emb = model.transformer.embedding
            grads.append({f"{proj}.{leaf}": getattr(getattr(emb, proj), leaf).grad
                          for proj in ("proj_d", "proj_a") for leaf in ("weight", "bias")})
        loss_err = max(abs(step_losses[0][key] - step_losses[1][key]) / abs(step_losses[1][key])
                       for key in ("loss", "c_loss", "f_loss"))
        grad_scale = max(float(g.abs().max()) for g in grads[1].values())
        grad_errs = {name: float((g - grads[1][name]).abs().max()) / grad_scale for name, g in grads[0].items()}
        print(f"[kitti:f32] {card}: Adam train step, kernels vs plain: loss {step_losses[0]['loss']:.6f} vs "
              f"{step_losses[1]['loss']:.6f}; losses within {loss_err:.3e} relative (bound "
              f"{TRAIN_LOSS_BOUND:.0e}); embedding gradients (largest magnitude {grad_scale:.3e}), error over it: "
              + ", ".join(f"{name} {e:.3e}" for name, e in grad_errs.items()) + f" (bound {TRAIN_GRAD_BOUND:.0e})")
        check(all(math.isfinite(v) for s in step_losses for v in s.values()), "kitti f32 train: non-finite loss")
        check(loss_err <= TRAIN_LOSS_BOUND, f"kitti f32 train: losses differ by {loss_err}")
        check(all(e <= TRAIN_GRAD_BOUND for e in grad_errs.values()), f"kitti f32 train: gradients differ: {grad_errs}")
        del with_kernels, plain, grads, data, state
        torch.cuda.empty_cache()

        # 10.4 trainval -> test -> eval; every pyramid the chain builds
        # (augmented train pairs too) is held under its caps
        level_counts = []

        def recorded(*args, **kwargs):
            out = build_inputs(*args, **kwargs)
            level_counts.append(torch.stack([m.sum() for side in ("ref", "src") for m in out[side]["masks"]]))
            return out

        build_inputs = steps_mod.build_registration_inputs
        steps_mod.build_registration_inputs = recorded
        try:
            launches = epoch_chain(ck, dev, "kitti", exp, n_train, n_val, [], [], config.FEATURE_DIR)
        finally:
            steps_mod.build_registration_inputs = build_inputs
        counts = torch.stack(level_counts).view(len(level_counts), 2, len(caps)).amax(dim=(0, 1)).tolist()
        print(f"[kitti:levels] {card}: largest valid count per level over the {len(level_counts)} pairs the chain "
              "built: " + ", ".join(f"{n}/{c}" for n, c in zip(counts, caps)))
        check(len(level_counts) == n_train + 2 * n_val and all(n < c for n, c in zip(counts, caps)),
              f"kitti chain: {len(level_counts)} pyramids, largest counts {counts} against caps {caps}")

        # 10.5 calibration on the tree's train pairs, beside the config
        t0 = time.perf_counter()
        train_set = OdometryKittiPairDataset(root, "train")
        bb = cfg.backbone
        cal_caps = calibrate_capacities(train_set, bb.num_stages, bb.init_voxel_size, device=dev)
        cal_limits = calibrate_neighbor_limits(train_set, bb.num_stages, bb.init_voxel_size, bb.init_radius, caps,
                                               device=dev)
        print(f"[kitti:calibration] {card}: capacities {cal_caps} (config {caps}), neighbor limits {cal_limits} "
              f"(config {cfg.capacities.neighbor_limits}) over the {len(train_set)} unaugmented train pairs, "
              f"{time.perf_counter() - t0:.2f} s")
        check(all(x > 0 for x in cal_caps + cal_limits), "kitti calibration: a zero capacity or limit")
    return launches


def denoiser_flops(tokens, d_model, ffn, layers):
    """Operations (2 per multiply-add) of one denoiser application over
    `tokens` tokens: per layer the q, k, v and output projections, the FFN,
    q k^T and the probabilities times v; the output MLP (d -> 64 -> 32 -> 1).
    Norms, the softmax and the activations are not counted."""
    per_layer = 4 * 2.0 * tokens * d_model ** 2 + 2 * 2.0 * tokens * d_model * ffn + 2 * 2.0 * tokens ** 2 * d_model
    return layers * per_layer + 2.0 * tokens * (d_model * 64 + 64 * 32 + 32)


def cordi_chain(ck, dev, card, tmp):
    """Phase 11 on the card, on phase 9's trees and encoder snapshot under
    `tmp`; returns the kernel launches of its encoded pairs."""
    import copy
    import math
    import time

    import torch
    import torch.nn.functional as F

    from ref_geotransformer_tpu_torch.data import PairLoader
    from ref_geotransformer_tpu_torch.data.datasets.linemod import LMODataset
    from ref_geotransformer_tpu_torch.engine import iter_trainer
    from ref_geotransformer_tpu_torch.engine.checkpoint import CheckpointManager, load_file
    from ref_geotransformer_tpu_torch.engine.steps import forward, to_device
    from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import (
        config,
        test,
        train_cordi,
    )
    from ref_geotransformer_tpu_torch.models.cordi import VarianceSchedule, cordi_downsample, ddpm_sample
    from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer

    phase_t0 = time.perf_counter()
    records = {"encode": [], "step": [], "sample": [], "test": []}

    def counted(kind, fn):
        """fn, recording for each call its start (host clock), its time to a
        synchronize, its kernel launches and its result."""
        def wrapper(*args, **kwargs):
            before = read_counts(ck)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            records[kind].append({"start": t0, "ms": 1e3 * (time.perf_counter() - t0), "out": out,
                                  "launches": tuple(x - y for x, y in zip(read_counts(ck), before))})
            return out
        return wrapper

    patched = [(iter_trainer, "forward", "encode"), (iter_trainer, "ddpm_train_step", "step"),
               (iter_trainer, "sample_pair", "sample"), (test, "sample_pair", "sample"), (test, "forward", "test")]
    originals = [getattr(module, name) for module, name, _ in patched]
    try:
        with linemod_env(tmp):
            cfg, ddpm = config.make_cfg(), config.DDPM
            d_model = ddpm.n_heads * ddpm.query_dimensions
            tokens = ddpm.ref_sample_num * ddpm.src_sample_num + 1
            encoder_name = f"iter-{LINEMOD_ITERATIONS}"
            encoder_file = os.path.join(config.SNAPSHOT_ENCODER_DIR, encoder_name + ".pth.tar")
            print(f"[cordi] {card}: Cordi at the published widths: R = {ddpm.ref_sample_num}, S = "
                  f"{ddpm.src_sample_num} ({tokens} tokens with the time token), {ddpm.num_steps} steps, "
                  f"{ddpm.n_layers} layers x {ddpm.n_heads} heads x {ddpm.query_dimensions}, FFN "
                  f"{ddpm.feed_forward_dimensions}; the encoder of phase 9 ({encoder_name}), context width "
                  f"{2 * cfg.geotransformer.output_dim}")

            # 11.1 the card against the CPU: one application, the loss, a 3-step chain
            encoder = GeoTransformer(cfg).to(dev)
            CheckpointManager(config.SNAPSHOT_ENCODER_DIR).load_model(encoder_name, encoder)
            dataset = LMODataset(os.path.join(tmp, "bop"), data_augmentation=False,
                                 points_limit=config.LMO["points_limit"], mode="test", seed=cfg.seed)
            pair, _ = next(PairLoader(dataset, cfg).iter_single())
            output = forward(encoder, cfg, to_device(pair, dev))
            gen = torch.Generator(device=dev).manual_seed(11)
            d = cordi_downsample(output, ddpm.ref_sample_num, ddpm.src_sample_num,
                                 *(torch.rand(output[f"{side}_node_masks"].shape, generator=gen, device=dev)
                                   for side in ("ref", "src")))
            valid = [int(output[f"{side}_node_masks"].sum()) for side in ("ref", "src")]
            del encoder, output
            on_card = train_cordi.build_cordi(ddpm, dev, cfg.seed + 1)
            on_cpu = copy.deepcopy(on_card).cpu()
            cpu_gen = torch.Generator().manual_seed(12)
            x_0, x_T, ctx = d["gt_corr_matrix"][None], d["init_corr_matrix"][None], d["feat_matrix"][None]
            t = torch.tensor([ddpm.num_steps * 3 // 8])
            t_dev = t.to(dev)
            e_rand = torch.randn(x_0.shape, generator=cpu_gen)
            zs = torch.randn((CORDI_CHECK_STEPS,) + tuple(x_T.shape), generator=cpu_gen)
            short = VarianceSchedule(CORDI_CHECK_STEPS, ddpm.beta_1, ddpm.beta_T)
            x_t = (x_0 + 0.5 * e_rand.to(dev)).contiguous()
            errors, values = {}, {}
            with torch.no_grad():
                for name, run in (
                        ("denoiser", lambda m, dv: m.denoise(x_t.to(dv), t.to(dv), ctx.to(dv))),
                        ("loss", lambda m, dv: m.loss(x_0.to(dv), ctx.to(dv), t.to(dv), e_rand.to(dv))),
                        (f"{CORDI_CHECK_STEPS}-step sample", lambda m, dv: ddpm_sample(
                            short.to(dv), lambda x, tt: m.denoise(x, tt, ctx.to(dv)), x_T.to(dv), zs.to(dv)))):
                    got, want = run(on_card, dev).cpu(), run(on_cpu, torch.device("cpu"))
                    check(bool(torch.isfinite(got).all()), f"cordi {name}: non-finite on the card")
                    errors[name] = float((got - want).abs().max() / want.abs().max())
                    values[name] = (float(got.flatten()[0]), float(want.flatten()[0]))
            print(f"[cordi:check] {card}: the card against the CPU at the same weights and inputs ({valid[0]} and "
                  f"{valid[1]} valid coarse nodes of the first test frame), error over the CPU result's largest "
                  f"magnitude: " + ", ".join(f"{name} {e:.3e}" for name, e in errors.items())
                  + f" (bound {CORDI_BOUND:.0e}; TF32 products would read ~1e-3); first entries, card / CPU: "
                  + ", ".join(f"{name} {a:.8f} / {b:.8f}" for name, (a, b) in values.items()))
            check(all(e <= CORDI_BOUND for e in errors.values()), f"cordi: the card and the CPU differ: {errors}")
            del on_cpu

            # the denoiser's time against its bound, and its attention core beside a fused call
            with torch.no_grad():
                apply_ms = cuda_ms(lambda: on_card.denoise(x_t, t_dev, ctx), iters=10)
                layer = on_card.net.layers[0].self_attn
                tok = torch.cat([(x_t[..., None] + ctx).reshape(1, tokens - 1, d_model),
                                 torch.zeros((1, 1, d_model), device=dev)], dim=1)
                q, k, v = (proj(tok).reshape(1, tokens, ddpm.n_heads, -1).transpose(1, 2)
                           for proj in (layer.query, layer.key, layer.value))
                scale = 1.0 / math.sqrt(ddpm.query_dimensions)
                explicit_ms = cuda_ms(lambda: torch.matmul(torch.softmax(torch.matmul(q * scale, k.transpose(-1, -2)),
                                                                         dim=-1), v))
                sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            flops = denoiser_flops(tokens, d_model, ddpm.feed_forward_dimensions, ddpm.n_layers)
            bound_ms = 1e3 * flops / PEAK_F32_FLOPS
            print(f"[cordi:denoiser] {card}: {apply_ms:.3f} ms per denoiser application (T = {tokens}, batch 1), "
                  f"against {flops / 1e9:.1f} GFLOP / {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s = {bound_ms:.3f} ms: "
                  f"{100 * bound_ms / apply_ms:.1f}% of the f32 bound; one layer's attention core (q k^T, softmax, "
                  f"times v): {explicit_ms:.3f} ms as explicit matmuls, {sdpa_ms:.3f} ms as "
                  f"scaled_dot_product_attention (not used by the port)")
            del on_card, q, k, v, tok
            torch.cuda.empty_cache()

            # 11.2 train_cordi on the frozen encoder
            for (module, name, kind) in patched:
                setattr(module, name, counted(kind, getattr(module, name)))
            reset_counts(ck)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            trainer = train_cordi.main(["--encoder_snapshot", encoder_name, "--max_iteration", str(CORDI_ITERATIONS),
                                        "--snapshot_steps", str(CORDI_SNAPSHOT_STEPS), "--log_steps", "1",
                                        "--device", "cuda"])
            train_s = time.perf_counter() - t0
            train_counts = read_counts(ck)
            train_peak = torch.cuda.max_memory_allocated(dev) / 2**30
            steps, encodes, samples = records["step"], records["encode"], records["sample"]
            n_val = CORDI_ITERATIONS // CORDI_SNAPSHOT_STEPS * min(trainer.val_iters, LINEMOD_TEST_FRAMES)
            check(len(steps) == CORDI_ITERATIONS, f"train_cordi: {len(steps)} steps, expected {CORDI_ITERATIONS}")
            check(len(encodes) == CORDI_ITERATIONS * ddpm.batch_size + n_val,
                  f"train_cordi: {len(encodes)} encoded pairs, expected {CORDI_ITERATIONS} + {n_val}")
            check(len(samples) == n_val, f"train_cordi: {len(samples)} validation samples, expected {n_val}")
            for i, r in enumerate(encodes):
                check(r["launches"] == (2, 0, 1), f"train_cordi encoded pair {i + 1}: expected 2 forward embedding, "
                                                  f"0 backward and 1 Sinkhorn launch, got {r['launches']}")
            for i, r in enumerate(steps):
                check(r["launches"] == (0, 0, 0), f"DDPM step {i + 1}: launched {r['launches']}")
                check(math.isfinite(float(r["out"])), f"DDPM step {i + 1}: non-finite loss")
            check(trainer.state.count == CORDI_ITERATIONS and trainer.state.skipped == 0,
                  f"train_cordi: {trainer.state.skipped} skipped, {trainer.state.count} applied")
            check(train_counts == (len(encodes) * 2, 0, len(encodes)), f"train_cordi: launches {train_counts}")
            for r in samples:
                check(tuple(r["out"].shape) == (ddpm.ref_sample_num, ddpm.src_sample_num)
                      and bool(torch.isfinite(r["out"]).all()), "train_cordi: a bad validation sample")
            saved = load_file(encoder_file, dev)["model"]
            check(all(torch.equal(v, saved[k]) for k, v in trainer.encoder.state_dict().items()),
                  "train_cordi: the frozen encoder's weights moved")
            for name in (f"iter-{CORDI_SNAPSHOT_STEPS}", f"iter-{CORDI_ITERATIONS}", "snapshot"):
                check(os.path.isfile(os.path.join(config.SNAPSHOT_DDPM_DIR, name + ".pth.tar")),
                      f"train_cordi wrote no {name}")
            # each step's pairs: the batch_size encodes just before it
            train_encodes = [[r for r in encodes if r["start"] < step["start"]][-ddpm.batch_size] for step in steps]
            iteration_ms, gaps = [], []
            for i, (step, first) in enumerate(zip(steps, train_encodes)):
                iteration_ms.append(1e3 * (step["start"] - first["start"]) + step["ms"])
                if i and i % CORDI_SNAPSHOT_STEPS:
                    gaps.append(1e3 * (first["start"] - steps[i - 1]["start"]) - steps[i - 1]["ms"])
            warm = iteration_ms[1:]
            losses = [float(r["out"]) for r in steps]
            print(f"[cordi:train] {card}: {CORDI_ITERATIONS} iterations in {train_s:.2f} s (models, snapshots, "
                  f"validation); losses {', '.join('%.6f' % x for x in losses)}; {sum(warm) / len(warm):.2f} ms per "
                  f"warm DDPM iteration ({', '.join('%.2f' % x for x in warm)}: encoder forward, downsample, "
                  f"epsilon-loss step, each to a synchronize; the step alone "
                  f"{', '.join('%.2f' % r['ms'] for r in steps[1:])} ms, the encoder forward "
                  f"{', '.join('%.2f' % r['ms'] for r in train_encodes[1:])} ms); first iteration "
                  f"{iteration_ms[0]:.2f} ms; host gap before an iteration "
                  f"{', '.join('%.2f' % g for g in gaps)} ms; validation sample "
                  f"{', '.join('%.3f' % (r['ms'] / 1e3) for r in samples)} s per pair ({ddpm.num_steps} steps); "
                  f"peak memory {train_peak:.2f} GiB; launches per encoded pair (2, 0, 1), {len(encodes)} pairs")

            # 11.3 test with the encoder and the Cordi snapshot
            first_test = len(records["sample"])
            reset_counts(ck)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            summary = test.main(["--snapshot", encoder_name, "--cordi_snapshot", f"iter-{CORDI_ITERATIONS}",
                                 "--num_pairs", str(LINEMOD_TEST_FRAMES), "--device", "cuda"])
            test_s = time.perf_counter() - t0
            test_counts = read_counts(ck)
            tests, test_samples = records["test"], records["sample"][first_test:]
            check(len(tests) == len(test_samples) == LINEMOD_TEST_FRAMES,
                  f"test: {len(tests)} pairs, {len(test_samples)} samples")
            for i, r in enumerate(tests):
                check(r["launches"] == (2, 0, 1), f"test pair {i + 1}: expected 2 forward embedding and 1 Sinkhorn "
                                                  f"launch, got {r['launches']}")
            check(test_counts == (2 * len(tests), 0, len(tests)), f"test: launches {test_counts}")
            for r in test_samples:
                check(tuple(r["out"].shape) == (ddpm.ref_sample_num, ddpm.src_sample_num)
                      and bool(torch.isfinite(r["out"]).all()), "test: a bad sampled matrix")
            for key in ("ddpm_PIR", "ddpm_PIR_0.5", "ddpm_PIR_0.25", "ddpm_IIR"):
                check(0.0 <= summary[key] <= 1.0, f"test: {key} {summary.get(key)} outside [0, 1]")
            check(math.isfinite(summary["RRE"]), f"test: RRE {summary['RRE']}")
            print(f"[cordi:test] {card}: {len(tests)} pairs in {test_s:.2f} s (models, snapshots, dataset); "
                  f"encoder forward {', '.join('%.2f' % r['ms'] for r in tests)} ms, {ddpm.num_steps}-step sample "
                  f"{', '.join('%.3f' % (r['ms'] / 1e3) for r in test_samples)} s per pair; ddpm_PIR "
                  f"{summary['ddpm_PIR']:.3f}, ddpm_IIR {summary['ddpm_IIR']:.3f} (random weights, "
                  f"{CORDI_ITERATIONS} iterations: not a quality figure); peak memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
            print(f"[cordi] {card}: phase 11 took {time.perf_counter() - phase_t0:.1f} s")
    finally:
        for (module, name, _), fn in zip(patched, originals):
            setattr(module, name, fn)
    return tuple(x + y for x, y in zip(train_counts, test_counts))


def target_keys_patch(keys, index):
    """(the port's target sampler, the same sampler taking keys[index()] for
    its uniform keys): the seam through which two runs sample the same
    targets for the same pair."""
    from ref_geotransformer_tpu_torch.models import geotransformer

    sample = geotransformer.superpoint_target_sample

    def sample_with_keys(*args, generator=None):
        return sample(*args, keys=keys[index()])

    return sample, sample_with_keys


def params_error(got, want):
    """max |a - b| over every parameter, over the largest |b| of the model
    (the Cordi chain's measure, phase 11)."""
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale


def gloo_keys(cfg, dev):
    """Uniform target keys for the DP_GLOO_RANKS * DP_GLOO_STEPS pairs of
    phase 12 (b), the same in every process."""
    import torch

    m = cfg.capacities.points[-1]
    return torch.rand((DP_GLOO_RANKS * DP_GLOO_STEPS, m * m), generator=torch.Generator(device=dev).manual_seed(11),
                      device=dev)


def gloo_rank(rank, spec):
    """One of phase 12 (b)'s ranks, in a process of its own on the one card:
    joins the gloo group through the file store and trains one epoch of
    DP_GLOO_STEPS steps at demo caps on its shard through run_trainval, with
    deterministic algorithms (pair j of the tree samples its targets with
    gloo_keys[j]); saves its parameters, losses, launches and step times.
    Any failure exits non-zero."""
    sys.path.insert(0, ROOT)
    import time

    import torch
    import torch.distributed as dist

    from ref_geotransformer_tpu_torch.config.threedmatch import make_cfg
    from ref_geotransformer_tpu_torch.data import PairLoader
    from ref_geotransformer_tpu_torch.data.datasets import ThreeDMatchPairDataset
    from ref_geotransformer_tpu_torch.engine import cli
    from ref_geotransformer_tpu_torch.engine import trainer as trainer_mod
    from ref_geotransformer_tpu_torch.models import cuda_kernels as ck
    from ref_geotransformer_tpu_torch.models import geotransformer
    from ref_geotransformer_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda:0")
    multihost.initialize_multihost(device=dev, backend="gloo", init_method=f"file://{spec['store']}",
                                   world_size=DP_GLOO_RANKS, rank=rank)
    cfg = make_cfg(demo=True)
    steps = []
    _, sample_with_keys = target_keys_patch(gloo_keys(cfg, dev), lambda: DP_GLOO_RANKS * (len(steps) - 1) + rank)
    records = []
    train_batch = trainer_mod.train_batch

    def recorded(*args):
        steps.append(None)
        before = read_counts(ck)
        t0 = time.perf_counter()
        out = train_batch(*args)
        torch.cuda.synchronize()
        records.append({"ms": 1e3 * (time.perf_counter() - t0), "losses": {k: float(v) for k, v in out.items()},
                        "launches": tuple(x - y for x, y in zip(read_counts(ck), before))})
        return out

    geotransformer.superpoint_target_sample, trainer_mod.train_batch = sample_with_keys, recorded
    dataset = ThreeDMatchPairDataset(spec["root"], "train", point_limit=None, use_augmentation=False, seed=cfg.seed)
    args = cli.trainval_parser().parse_args(["--max_epoch", "1", "--log_steps", "1", "--device", "cuda:0"])
    trainer = cli.run_trainval(cfg, PairLoader(dataset, cfg, batch_size=1, shuffle=False, seed=cfg.seed), None,
                               os.path.join(spec["out"], "snapshots"), spec["out"], args)
    torch.save({"params": [p.detach().cpu() for p in trainer.state.params], "records": records,
                "counts": (trainer.state.count, trainer.state.skipped), "lr_scale": trainer.state.lr_scale,
                "world": (trainer.world.rank, trainer.world.size), "peak": torch.cuda.max_memory_allocated(dev) / 2**30},
               os.path.join(spec["out"], f"rank{rank}.pt"))
    dist.destroy_process_group()


def data_parallel_chain(ck, dev, card, tmp):
    """Phase 12 on the card; `tmp` holds phase 9's LineMod trees. Returns the
    kernel launches of the data-parallel runs of (a), the ranks of (b) and
    the iterations and validation of (c)."""
    import math
    import multiprocessing
    import tempfile
    import time

    import torch
    import torch.distributed as dist

    from ref_geotransformer_tpu_torch.config.threedmatch import make_cfg
    from ref_geotransformer_tpu_torch.data import PairLoader
    from ref_geotransformer_tpu_torch.data.datasets import ThreeDMatchPairDataset
    from ref_geotransformer_tpu_torch.demo import build_model
    from ref_geotransformer_tpu_torch.engine import cli
    from ref_geotransformer_tpu_torch.engine import trainer as trainer_mod
    from ref_geotransformer_tpu_torch.engine.state import TrainState
    from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import fixture
    from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import config as lm_config
    from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import trainval_encoder
    from ref_geotransformer_tpu_torch.models import geotransformer
    from ref_geotransformer_tpu_torch.parallel import dp, multihost

    phase_t0 = time.perf_counter()
    launches = [0, 0, 0]
    scans = [os.path.join(ROOT, "data", "demo", f"{name}.npy") for name in ("ref", "src")]
    root, det_root = os.path.join(tmp, "dp-3dmatch"), os.path.join(tmp, "dp-3dmatch-deterministic")
    for tree, n_train in ((root, DP_STEPS), (det_root, DP_DET_STEPS)):
        fixture.make_fixture_tree(tree, n_train=n_train, n_val=1, points=FIXTURE_POINTS, real_base=scans)
    cfg = make_cfg(demo=False)

    # (a) the epoch trainer at full caps: timed plain, data-parallel (1-rank NCCL),
    # data-parallel, plain; and, with deterministic algorithms, plain against data-parallel
    records = []
    train_batch = trainer_mod.train_batch

    def recorded(model, state, batch, generator=None, world=None):
        before = read_counts(ck)
        t0 = time.perf_counter()
        out = train_batch(model, state, batch, generator, world)
        torch.cuda.synchronize()
        records.append({"ms": 1e3 * (time.perf_counter() - t0), "loss": float(out["loss"]),
                        "params": [p.detach().clone() for p in state.params],
                        "launches": tuple(x - y for x, y in zip(read_counts(ck), before))})
        return out

    def run(label, deterministic=False):
        records.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        n_steps = DP_DET_STEPS if deterministic else DP_STEPS
        dataset = ThreeDMatchPairDataset(det_root if deterministic else root, "train", point_limit=None,
                                         use_augmentation=False, seed=cfg.seed)
        loader = PairLoader(dataset, cfg, batch_size=1, shuffle=True, seed=cfg.seed)
        args = cli.trainval_parser().parse_args(["--max_epoch", "1", "--log_steps", str(DP_STEPS), "--device", "cuda"])
        out_dir = os.path.join(tmp, "dp-out", label.replace(" ", "-"))
        try:
            trainer = cli.run_trainval(cfg, loader, None, os.path.join(out_dir, "snapshots"), out_dir, args)
        finally:
            torch.use_deterministic_algorithms(False)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check(len(records) == n_steps, f"dp {label}: {len(records)} steps, expected {n_steps}")
        for i, r in enumerate(records):
            check(math.isfinite(r["loss"]), f"dp {label} step {i + 1}: non-finite loss")
            check(r["launches"] == (2, 2, 0), f"dp {label} step {i + 1}: expected 2 forward, 2 backward embedding "
                                              f"launches and no Sinkhorn launch, got {r['launches']}")
        check((trainer.state.count, trainer.state.skipped, trainer.state.lr_scale) == (n_steps, 0, 1.0),
              f"dp {label}: {trainer.state.count} updates applied, {trainer.state.skipped} skipped, "
              f"lr_scale {trainer.state.lr_scale}")
        check((trainer.world is None) == label.startswith("plain"), f"dp {label}: world {trainer.world}")
        warm = [r["ms"] for r in records[1:]]
        print(f"[dp:a] {card}: {label}: {sum(warm) / len(warm):.2f} ms/step over the warm steps 2-{n_steps} "
              f"({', '.join('%.2f' % t for t in warm)} ms to a synchronize), first step {records[0]['ms']:.2f} ms; "
              f"losses {', '.join('%.6f' % r['loss'] for r in records)}; peak memory {peak:.2f} GiB")
        return trainer, [dict(r) for r in records]

    trainer_mod.train_batch = recorded
    try:
        _, plain = run("plain-1")
        _, det_plain = run("plain, deterministic", deterministic=True)
        multihost.initialize_multihost(device="cuda", init_method=f"file://{os.path.join(tmp, 'dp-nccl-store')}",
                                       world_size=1, rank=0)
        check(dist.get_backend() == "nccl" and multihost.world() == (0, 1), "dp: no 1-rank NCCL group")
        reset_counts(ck)
        _, det_dp = run("data-parallel, deterministic", deterministic=True)
        errors = {}
        for label in ("data-parallel-1", "data-parallel-2"):
            trainer, steps = run(label)
            errors[label] = [params_error(r["params"], p["params"]) for r, p in zip(steps, plain)]
        launches = [x + y for x, y in zip(launches, read_counts(ck))]
        det_errors = [params_error(r["params"], p["params"]) for r, p in zip(det_dp, det_plain)]
        identical = all(torch.equal(a, b) for r, p in zip(det_dp, det_plain) for a, b in zip(r["params"], p["params"]))
        del det_dp, det_plain
        # the all-reduce alone over the gradient buffer, and the whole reduction of a step
        params = trainer.state.params
        numel = sum(p.numel() for p in params)
        flat = torch.zeros(numel + 1, device=dev)
        reduce_ms = cuda_ms(lambda: dist.all_reduce(flat))
        step_reduce_ms = cuda_ms(lambda: dp.all_reduce_gradients(params, 1.0))
        print(f"[dp:a] {card}: gradient buffer {numel} parameters + the weight sum, {4 * (numel + 1)} bytes (f32); "
              f"NCCL all-reduce over it at 1 rank {reduce_ms:.4f} ms; all_reduce_gradients (concatenate, "
              f"all-reduce, divide, copy back) {step_reduce_ms:.4f} ms")
        del trainer, flat, params

        # (c) trainval_encoder --multihost in the 1-rank NCCL group
        with scoped_env(LINEMOD_ENV_KEYS, REF_GT_LINEMOD_ROOT=os.path.join(tmp, "bop"),
                        REF_GT_MODELNET_ROOT=os.path.join(tmp, "modelnet"),
                        REF_GT_OUTPUT_ROOT=os.path.join(tmp, "dp-output"), REF_GT_WARMUP=str(LINEMOD_WARMUP)):
            reset_counts(ck)
            t0 = time.perf_counter()
            encoder = trainval_encoder.main(["--multihost", "--max_iteration", str(DP_ENCODER_ITERATIONS),
                                             "--snapshot_steps", str(DP_ENCODER_ITERATIONS), "--log_steps", "1",
                                             "--device", "cuda"])
            torch.cuda.synchronize()
            encoder_s = time.perf_counter() - t0
            counts = read_counts(ck)
            written = sorted(os.listdir(lm_config.SNAPSHOT_ENCODER_DIR))
        launches = [x + y for x, y in zip(launches, counts)]
        n_val = min(VAL_ITERS, LINEMOD_TEST_FRAMES)
        want = (2 * DP_ENCODER_ITERATIONS + 2 * n_val, 2 * DP_ENCODER_ITERATIONS, n_val)
        print(f"[dp:c] {card}: trainval_encoder --multihost in the 1-rank NCCL group: {DP_ENCODER_ITERATIONS} "
              f"iterations and a validation in {encoder_s:.2f} s; primary {encoder.primary}; rank 0 wrote "
              f"{written}; launches {counts} (expected {want})")
        check(encoder.primary and (encoder.iteration, encoder.state.count, encoder.state.skipped)
              == (DP_ENCODER_ITERATIONS, DP_ENCODER_ITERATIONS, 0), "dp trainval_encoder: wrong counts")
        check(written == [f"iter-{DP_ENCODER_ITERATIONS}.pth.tar", "snapshot.pth.tar"],
              f"dp trainval_encoder wrote {written}")
        check(counts == want, f"dp trainval_encoder: launches {counts}, expected {want}")
        del encoder
        dist.destroy_process_group()

        _, plain_again = run("plain-2")
        errors["plain-2"] = [params_error(r["params"], p["params"]) for r, p in zip(plain_again, plain)]
    finally:
        trainer_mod.train_batch = train_batch
        if dist.is_initialized():
            dist.destroy_process_group()
    for label, errs in errors.items():
        print(f"[dp:a] {card}: {label} against plain-1, parameters after each step: "
              + ", ".join(f"{e:.3e}" for e in errs) + " of their largest magnitude")
    print(f"[dp:a] {card}: with deterministic algorithms, data-parallel against plain after each step: "
          + ", ".join(f"{e:.3e}" for e in det_errors) + f"; bit-identical: {identical}")
    check(identical, f"dp: with deterministic algorithms the data-parallel path's parameters differ from the "
                     f"plain path's by {max(det_errors)}")
    del plain, plain_again
    torch.cuda.empty_cache()

    # (b) two ranks on the one card under gloo, against one process over the same global batches
    out = tempfile.mkdtemp(dir=tmp)
    demo_cfg = make_cfg(demo=True)
    demo_cfg = demo_cfg.replace(optim=type(demo_cfg.optim)(**{**demo_cfg.optim.__dict__, "max_epoch": 1}))
    spec = {"root": root, "out": out, "store": os.path.join(out, "gloo-store")}
    context = multiprocessing.get_context("spawn")
    procs = [context.Process(target=gloo_rank, args=(rank, spec)) for rank in range(DP_GLOO_RANKS)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(DP_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    for rank, proc in enumerate(procs):
        if proc.is_alive():
            proc.terminate()
            proc.join()
        check(proc.exitcode == 0, f"dp gloo rank {rank} exited with {proc.exitcode}")
    ranks = [torch.load(os.path.join(out, f"rank{rank}.pt"), weights_only=False) for rank in range(DP_GLOO_RANKS)]
    for rank, r in enumerate(ranks):
        check(r["world"] == (rank, DP_GLOO_RANKS) and r["counts"] == (DP_GLOO_STEPS, 0)
              and r["lr_scale"] == float(DP_GLOO_RANKS),
              f"dp gloo rank {rank}: world {r['world']}, counts {r['counts']}, lr_scale {r['lr_scale']}")
        for i, s in enumerate(r["records"]):
            check(s["launches"] == (2, 2, 0), f"dp gloo rank {rank} step {i + 1}: launches {s['launches']}")
            launches = [x + y for x, y in zip(launches, s["launches"])]
        print(f"[dp:b] {card}: gloo rank {rank} of {DP_GLOO_RANKS} on the one card, demo caps, deterministic "
              f"algorithms: steps {', '.join('%.2f' % s['ms'] for s in r['records'])} ms to a synchronize; losses "
              f"{', '.join('%.6f' % s['losses']['loss'] for s in r['records'])}; peak memory {r['peak']:.2f} GiB")
    ranks_identical = all(torch.equal(a, b) for a, b in zip(ranks[0]["params"], ranks[1]["params"]))
    check(ranks_identical, "dp gloo: the two ranks' parameters differ")
    check([s["losses"] for s in ranks[0]["records"]] == [s["losses"] for s in ranks[1]["records"]],
          "dp gloo: the ranks' losses differ")

    calls = []
    sample, sample_with_keys = target_keys_patch(gloo_keys(demo_cfg, dev), lambda: len(calls) - 1)
    dataset = ThreeDMatchPairDataset(root, "train", point_limit=None, use_augmentation=False, seed=demo_cfg.seed)
    loader = PairLoader(dataset, demo_cfg, batch_size=DP_GLOO_RANKS, shuffle=False, seed=demo_cfg.seed)
    model = build_model(demo_cfg, dev, seed=demo_cfg.seed)
    state = TrainState(model, demo_cfg.optim, len(loader), lr_scale=float(DP_GLOO_RANKS))
    trainer = trainer_mod.EpochBasedTrainer(demo_cfg, model, state, loader, None,
                                            snapshot_dir=os.path.join(out, "single"), log_steps=DP_GLOO_STEPS,
                                            seed=demo_cfg.seed)
    ends, losses = [], []
    trainer.after_step_hooks.append(lambda t, step_losses: (torch.cuda.synchronize(), ends.append(time.perf_counter()),
                                                            losses.append(step_losses)))
    geotransformer.superpoint_target_sample = lambda *args, generator=None: calls.append(None) or sample_with_keys(*args)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        trainer.run()
    finally:
        torch.use_deterministic_algorithms(False)
        geotransformer.superpoint_target_sample = sample
    check((state.count, state.skipped) == (DP_GLOO_STEPS, 0) and len(calls) == DP_GLOO_RANKS * DP_GLOO_STEPS,
          f"dp gloo: the single process applied {state.count} updates, skipped {state.skipped}, sampled {len(calls)}")
    single = [p.detach().cpu() for p in state.params]
    gloo_err = params_error(ranks[0]["params"], single)
    gloo_identical = all(torch.equal(a, b) for a, b in zip(ranks[0]["params"], single))
    single_ms = [1e3 * (b - a) for a, b in zip([t0] + ends, ends)]
    print(f"[dp:b] {card}: {DP_GLOO_RANKS} ranks in {gloo_s:.1f} s (spawn, CUDA init, {DP_GLOO_STEPS} steps); the "
          f"ranks' parameters bit-identical: {ranks_identical}; one process over the same global batches of "
          f"{DP_GLOO_RANKS} pairs: {', '.join('%.2f' % t for t in single_ms)} ms/step, losses "
          f"{', '.join('%.6f' % s['loss'] for s in losses)}; its parameters against the ranks': {gloo_err:.3e} of "
          f"the largest magnitude, bit-identical: {gloo_identical}")
    check(gloo_identical, f"dp gloo: parameters {gloo_err} from one process's")
    del model, state, trainer
    torch.cuda.empty_cache()
    print(f"[dp] {card}: phase 12 took {time.perf_counter() - phase_t0:.1f} s")
    return tuple(launches)


def surface_chain(ck, dev, card, kc, tmp):
    """Phase 13 on the card; `tmp` holds phase 9's LineMod trees. Returns the
    kernel launches of its main paths: (a) the bf16-activation inference
    forward and train steps, (b) the converted model's demo forward, (c) the
    variant model's train step and forward, (d) the LineMod validation with
    its correspondence dump."""
    import dataclasses
    import glob
    import math
    import time

    import numpy as np
    import torch

    from ref_geotransformer_tpu_torch import demo
    from ref_geotransformer_tpu_torch.config.threedmatch import make_cfg
    from ref_geotransformer_tpu_torch.data import build_pyramid, build_registration_inputs
    from ref_geotransformer_tpu_torch.engine.iter_trainer import IterBasedEncoderTrainer, make_warmup_cosine_schedule
    from ref_geotransformer_tpu_torch.engine.state import AdamWTrainState, TrainState
    from ref_geotransformer_tpu_torch.engine.steps import train_step
    from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import config as lm_config
    from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4.dataset import (
        train_valid_data_loader,
    )
    from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
    from ref_geotransformer_tpu_torch.train import STEPS_PER_EPOCH, make_train_run
    from ref_geotransformer_tpu_torch.utils.weights import init_parameters

    phase_t0 = time.perf_counter()
    launches = [0, 0, 0]

    def add(counts):
        for i, count in enumerate(counts):
            launches[i] += count

    cfg32 = make_cfg(demo=False)
    cfg16 = cfg32.replace(backbone=dataclasses.replace(cfg32.backbone, act_dtype="bfloat16"))

    # (a.1) the bf16-activation inference forward, kernels against plain, one pyramid
    pair = demo.load_pair(cfg16, dev)
    bb, caps = cfg16.backbone, cfg16.capacities
    data = build_registration_inputs(pair["ref_points"], pair["ref_masks"], pair["src_points"], pair["src_masks"],
                                     bb.num_stages, bb.init_voxel_size, bb.init_radius, caps.neighbor_limits,
                                     caps.points, transform=pair["transform"], search_chunk=caps.search_chunk)
    with_kernels = demo.build_model(cfg16, dev, seed=1)
    plain = demo.build_model(cfg16, dev, seed=1, use_kernels=False)
    inner = []
    hook = with_kernels.backbone.encoder2_2.register_forward_hook(lambda m, i, o: inner.append(o.dtype))
    reset_counts(ck)
    a = with_kernels(data)
    torch.cuda.synchronize()
    counts = read_counts(ck)
    hook.remove()
    add(counts)
    b = plain(data)
    torch.cuda.synchronize()
    feats_err, padded_err = coarse_feats_gaps(a, b, data)
    feats_f_err = float((a["ref_feats_f"] - b["ref_feats_f"]).abs().max())
    n_src = a["src_feats_c"].shape[0]
    key_a = a["ref_node_corr_indices"].long() * n_src + a["src_node_corr_indices"].long()
    key_b = b["ref_node_corr_indices"].long() * n_src + b["src_node_corr_indices"].long()
    ia, ib = torch.nonzero(key_a[:, None] == key_b[None, :], as_tuple=True)
    ms_a, ms_b = a["matching_scores"][ia], b["matching_scores"][ib]
    ms_err = float((ms_a - ms_b)[ms_a > -1e11].abs().max()) if len(ia) else float("nan")
    print(f"[surface:bf16] {card}: act_dtype bfloat16 at full caps, one forward: launches {counts}; the backbone's "
          f"block outputs {inner[0]}, its features out {a['ref_feats_f'].dtype}; kernels vs plain: ref_feats_f "
          f"{feats_f_err:.3e}, ref_feats_c {feats_err:.3e} on valid nodes (bound {PATH_FEATS_BOUND:.0e}; padded "
          f"nodes {padded_err:.3e}, not compared); {len(ia)} of "
          f"{len(key_a)} proposals shared, matching_scores on them {ms_err:.3e}")
    check(counts == (2, 0, 1), f"bf16 forward: expected 2 + 0 + 1 launches, got {counts}")
    check(inner == [torch.bfloat16] and a["ref_feats_f"].dtype == torch.float32, f"bf16 forward: dtypes {inner}")
    check(feats_err <= PATH_FEATS_BOUND, f"bf16 forward: ref_feats_c differs by {feats_err}")
    check(bool(torch.isfinite(a["estimated_transform"]).all() and torch.isfinite(b["estimated_transform"]).all()),
          "bf16 forward: non-finite transform")
    del a, b, with_kernels, plain, data
    torch.cuda.empty_cache()

    # (a.2) f32 and bf16 activations in turns: ms/pair, ms/step, peak memory
    turns = []
    for label, cfg in (("f32", cfg32), ("bf16", cfg16), ("bf16", cfg16), ("f32", cfg32)):
        model = demo.build_model(cfg, dev, seed=0)
        pair = demo.load_pair(cfg, dev)
        demo.register(model, cfg, pair)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(TIMED_ITERS):
            out = demo.register(model, cfg, pair)
        torch.cuda.synchronize()
        pair_ms = 1e3 * (time.perf_counter() - t0) / TIMED_ITERS
        infer_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check(bool(torch.isfinite(out["estimated_transform"]).all()), f"{label}: non-finite transform")
        del model, out
        torch.cuda.empty_cache()
        model, pair, state, generator = make_train_run(cfg, dev)
        train_step(model, state, pair, generator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = []
        for step in range(TRAIN_STEPS):
            reset_counts(ck)
            t0 = time.perf_counter()
            losses = train_step(model, state, pair, generator)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            counts = read_counts(ck)
            add(counts)
            check(all(math.isfinite(float(v)) for v in losses.values()), f"{label} train step {step}: non-finite")
            check(counts == (2, 2, 0), f"{label} train step {step}: expected 2 + 2 + 0 launches, got {counts}")
        train_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check(state.skipped == 0 and state.count == TRAIN_STEPS + 1, f"{label} train: {state.skipped} skipped")
        turns.append((label, pair_ms, infer_peak, sum(step_ms) / len(step_ms), step_ms, train_peak))
        print(f"[surface:turns] {card}: act {label}: {pair_ms:.2f} ms/pair over {TIMED_ITERS} forwards, peak "
              f"{infer_peak:.2f} GiB; train {sum(step_ms) / len(step_ms):.2f} ms/step (steps "
              f"{', '.join('%.2f' % t for t in step_ms)}; loss {float(losses['loss']):.6f}), peak {train_peak:.2f} GiB; "
              f"no step skipped")
        del model, state, pair
        torch.cuda.empty_cache()

    # (b) the converter round trip: a seeded model in the upstream layout, the
    # CLI, then `demo --full --snapshot --dump`; deterministic algorithms
    # (the pyramid's segment sums), so the two forwards must agree bit for bit
    source = demo.build_model(cfg32, dev, seed=5)
    upstream = {"module." + key: value.cpu() for key, value in source.state_dict().items()}
    c = cfg32.geotransformer.hidden_dim
    upstream["module.transformer.embedding.embedding.div_term"] = torch.exp(
        torch.arange(0, c, 2, dtype=torch.float32) * (-math.log(10000.0) / c))
    conv_dir = os.path.join(tmp, "convert")
    os.makedirs(conv_dir, exist_ok=True)
    torch.save({"model": upstream, "epoch": 40}, os.path.join(conv_dir, "geotransformer-3dmatch.pth.tar"))
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "ref_geotransformer_tpu_torch.utils.convert_checkpoint",
                          os.path.join(conv_dir, "geotransformer-3dmatch.pth.tar"), os.path.join(conv_dir, "snapshots"),
                          "--name", "epoch-40", "--experiment", "3dmatch"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    print(f"[surface:convert] {card}: the converter CLI in {time.perf_counter() - t0:.1f} s, exit {cli.returncode}: "
          + " | ".join(cli.stdout.strip().splitlines()))
    check(cli.returncode == 0, f"convert_checkpoint failed: {cli.stderr[-2000:]}")
    snapshot = os.path.join(conv_dir, "snapshots", "epoch-40.pth.tar")
    dump = os.path.join(conv_dir, "demo.npz")
    pair = demo.load_pair(cfg32, dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            want = demo.register(source, cfg32, pair)["estimated_transform"].cpu().numpy()
        reset_counts(ck)
        demo.main(["--full", "--snapshot", snapshot, "--dump", dump, "--iters", "0", "--device", "cuda"])
        torch.cuda.synchronize()
        counts = read_counts(ck)
    finally:
        torch.use_deterministic_algorithms(False)
    add(counts)
    with np.load(dump) as data:
        got = data["estimated_transform"]
    plys = [dump[:-4] + f"_{suffix}.ply" for suffix in ("ref", "src", "src_aligned")]
    sizes = [os.path.getsize(path) if os.path.isfile(path) else 0 for path in plys]
    print(f"[surface:convert] {card}: demo --full --snapshot epoch-40 --dump: launches {counts}; transform "
          f"bit-identical to the source model's: {np.array_equal(got, want)} (max difference "
          f"{float(np.abs(got - want).max()):.3e}); PLYs {', '.join(f'{os.path.basename(p)} {n} bytes' for p, n in zip(plys, sizes))}")
    check(counts == (2, 0, 1), f"converted demo: expected 2 + 0 + 1 launches, got {counts}")
    check(np.array_equal(got, want), "converted demo: the transform differs from the source model's")
    check(all(n > 0 for n in sizes), f"converted demo: PLYs missing: {sizes}")
    del source, upstream
    torch.cuda.empty_cache()

    # (c) the variant model: mean angle reduction, dustbin LGR, attention dropout
    cfgv = cfg32.replace(geotransformer=dataclasses.replace(cfg32.geotransformer, reduction_a="mean"),
                         fine_matching=dataclasses.replace(cfg32.fine_matching, use_dustbin=True))
    model = init_parameters(GeoTransformer(cfgv, dropout=VARIANT_DROPOUT), torch.Generator().manual_seed(0)).to(dev)
    pair = demo.load_pair(cfgv, dev)
    state = TrainState(model, cfgv.optim, STEPS_PER_EPOCH)
    generator = torch.Generator(device=dev).manual_seed(0)
    train_step(model, state, pair, generator)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(ck)
    t0 = time.perf_counter()
    losses = train_step(model, state, pair, generator)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts(ck)
    add(counts)
    variant_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    values = {key: float(v) for key, v in losses.items()}
    print(f"[surface:variant] {card}: reduction_a mean, use_dustbin, attention dropout {VARIANT_DROPOUT}: train step "
          f"{step_ms:.2f} ms, loss {values['loss']:.6f} (c {values['c_loss']:.6f}, f {values['f_loss']:.6f}); launches "
          f"{counts}; peak memory {variant_peak:.2f} GiB")
    check(all(math.isfinite(v) for v in values.values()), "variant train step: non-finite loss")
    check(state.skipped == 0 and state.count == 2, f"variant train: {state.skipped} skipped")
    check(counts == (0, 0, 0), f"variant train step: expected no kernel launch, got {counts}")
    model.eval()
    captured = {}
    hook = model.optimal_transport.register_forward_pre_hook(lambda module, inputs: captured.update(inputs=inputs))
    reset_counts(ck)
    out = demo.register(model, cfgv, pair)
    torch.cuda.synchronize()
    counts = read_counts(ck)
    hook.remove()
    add(counts)
    k1 = cfgv.model.num_points_in_patch + 1
    check(counts == (0, 0, 1), f"variant forward: expected 0 + 0 + 1 launches, got {counts}")
    check(tuple(out["matching_scores"].shape[1:]) == (k1, k1), "variant forward: matching_scores shape")
    check(bool(torch.isfinite(out["estimated_transform"]).all()), "variant forward: non-finite transform")
    ot = model.optimal_transport
    with torch.no_grad():
        padded, log_mu, log_nu, _ = ot.prepare(*captured["inputs"])
    kc.check_sinkhorn("variant model", padded, log_mu, log_nu, ot.num_iterations)
    bb, caps = cfgv.backbone, cfgv.capacities
    pyr = build_pyramid(pair["ref_points"], pair["ref_masks"], bb.num_stages, bb.init_voxel_size, bb.init_radius,
                        caps.neighbor_limits, caps.points, caps.search_chunk)
    nodes, node_masks = pyr["points"][-1][None], pyr["masks"][-1][None]
    emb = model.transformer.embedding
    with torch.no_grad():
        mean_ms = cuda_ms(lambda: emb(nodes, node_masks), iters=5, warmup=1)
    grad_ms = cuda_ms(lambda: emb(nodes, node_masks).sum().backward(), iters=3, warmup=1)
    print(f"[surface:variant] {card}: the mean embedding at N = {nodes.shape[1]}, C = {emb.hidden_dim}, k = "
          f"{emb.angle_k}: {mean_ms:.3f} ms forward, {grad_ms:.3f} ms forward and backward (torch ops, no kernel; "
          f"the max kernel: {next(r[2] for r in kc.emb_rows if r[0] == nodes.shape[1]):.3f} ms); forward {counts}; "
          f"Sinkhorn above")
    del model, state, out, captured, padded
    torch.cuda.empty_cache()

    # (d) a LineMod encoder validation with corr_dump_dir
    with linemod_env(tmp):
        cfg = lm_config.make_cfg()
        _, valid_loader = train_valid_data_loader(cfg, batch_size=1)
        model = demo.build_model(cfg, dev, seed=cfg.seed)
        schedule = make_warmup_cosine_schedule(cfg.optim.lr, 1, cfg.optim.warmup_steps, cfg.optim.eta_init,
                                               cfg.optim.eta_min)
        corr_dir = os.path.join(tmp, "corr")
        trainer = IterBasedEncoderTrainer(cfg, model, AdamWTrainState(model, cfg.optim, schedule), [], valid_loader,
                                          snapshot_dir=os.path.join(tmp, "corr-snapshots"), corr_dump_dir=corr_dir)
        reset_counts(ck)
        summary = trainer.validate()
        torch.cuda.synchronize()
        counts = read_counts(ck)
        add(counts)
    plys = sorted(glob.glob(os.path.join(corr_dir, "*.ply")))
    want_counts = tuple(x * (LINEMOD_TEST_FRAMES + 1) for x in (2, 0, 1))
    print(f"[surface:corr] {card}: LineMod validation over {LINEMOD_TEST_FRAMES} pairs with corr_dump_dir: launches "
          f"{counts}; {len(plys)} PLYs ({', '.join(os.path.basename(p) for p in plys)}); PIR "
          f"{summary.get('PIR', float('nan')):.3f}")
    check(counts == want_counts, f"corr dump: expected {want_counts} launches, got {counts}")
    check(len(plys) == 6 and all(os.path.getsize(p) > 0 for p in plys), f"corr dump: PLYs {plys}")
    print(f"[surface] {card}: phase 13 took {time.perf_counter() - phase_t0:.1f} s; act f32 / bf16 in turns: "
          + "; ".join(f"{t[0]} {t[1]:.2f} ms/pair {t[2]:.2f} GiB, {t[3]:.2f} ms/step {t[5]:.2f} GiB" for t in turns))
    return tuple(launches)


def scripts_chain(ck, dev, card, kc, cli_tmp, kitti_tmp):
    """Phase 14 on the card; returns the kernel launches of the two probe
    runs. `kc` holds main's kernel checks."""
    import ast
    import glob
    import math
    import shutil
    import tempfile
    import time

    import numpy as np
    import torch

    from ref_geotransformer_tpu_torch import native
    from ref_geotransformer_tpu_torch.data import build_pyramid, pad_points
    from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import config as m_config
    from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import eval as m_eval
    from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import eval_dgr
    from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import config as k_config
    from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import fixture as k_fixture
    from ref_geotransformer_tpu_torch.ops.neighbors import radius_search
    from ref_geotransformer_tpu_torch.ops.subsample import grid_subsample
    from ref_geotransformer_tpu_torch.tools import downsample_kitti
    from ref_geotransformer_tpu_torch.tools import overfit_probe as probe
    from ref_geotransformer_tpu_torch.utils.neighbor_tables import table_mismatches

    phase_t0 = time.perf_counter()
    rng = np.random.default_rng(14)

    def raw_scan():
        xyz = k_fixture._scan(rng, RAW_SCAN_POINTS, KITTI_RADIUS, True)
        xyz[:, 2] -= SENSOR_HEIGHT
        return xyz

    def host_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return out, min(times)

    # (a) the host C++ kernels against the card's pyramid ops on one raw scan
    t0 = time.perf_counter()
    native.build()
    print(f"[native] {card}: g++ build {time.perf_counter() - t0:.2f} s ({native.LIBRARY}; a library newer than its "
          f"source is reused)")
    kcfg = k_config.make_cfg()
    bb, kcaps = kcfg.backbone, kcfg.capacities
    voxel, radius, limit = bb.init_voxel_size, bb.init_radius, kcaps.neighbor_limits[0]
    scan = raw_scan()
    (down, total), grid_host_ms = host_ms(lambda: native.grid_subsample_native(scan, voxel))
    points = torch.from_numpy(scan).to(dev)
    masks = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
    card_points, card_masks = grid_subsample(points, masks, voxel, points.shape[0])
    grid_card_ms = cuda_ms(lambda: grid_subsample(points, masks, voxel, points.shape[0]))
    count = int(card_masks.sum())
    # both emit voxels in (z, y, x) index order: compare row by row
    grid_err = float(np.abs(card_points[:count].cpu().numpy() - down).max()) if count == total else float("inf")
    print(f"[native] {card}: grid_subsample of a {RAW_SCAN_POINTS}-point scan at {voxel} m: {total} voxels on the "
          f"host, {count} on the card; centroids within {grid_err:.3e} (bound 1e-5); host {grid_host_ms:.2f} ms, "
          f"card {grid_card_ms:.3f} ms")
    check(count == total, f"native grid_subsample: {total} voxels, the card's grid_subsample {count}")
    check(bool(card_masks[:count].all()), "card grid_subsample: its valid voxels are not first")
    check(grid_err <= 1e-5, f"native grid_subsample: centroids differ from the card's by {grid_err}")
    host_table, radius_host_ms = host_ms(lambda: native.radius_neighbors_native(down, down, radius, limit))
    q = torch.from_numpy(down).to(dev)
    qm = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    card_table = radius_search(q, q, qm, qm, radius, limit, kcaps.search_chunk)
    radius_card_ms = cuda_ms(lambda: radius_search(q, q, qm, qm, radius, limit, kcaps.search_chunk), iters=3, warmup=1)
    differ, bad, worst = table_mismatches(host_table, card_table.cpu().numpy(), down, down, NATIVE_TIE, scaled=True)
    filled = float((host_table < down.shape[0]).sum(1).mean())
    print(f"[native] {card}: radius_neighbors over the {total} voxels, radius {radius} m, limit {limit} (KITTI level "
          f"0; {filled:.1f} neighbors a row): {differ} rows differ as sets or in column 0, {len(bad)} beyond ties "
          f"(largest gap {worst:.3f} of its tolerance); host {radius_host_ms:.2f} ms, card {radius_card_ms:.3f} ms")
    check(not bad, f"native radius_neighbors: {len(bad)} rows differ from the card's radius_search beyond ties: "
                   f"{bad[:5]}")
    del points, masks, card_points, card_masks, q, qm, card_table

    # (b) downsample_kitti over a tree of raw scans; one pair's pyramid under KITTI's caps
    with tempfile.TemporaryDirectory() as raw_tmp:
        scans = {}
        for seq in RAW_SEQUENCES:
            velodyne = os.path.join(raw_tmp, "sequences", seq, "velodyne")
            os.makedirs(velodyne)
            for frame in range(RAW_FRAMES):
                xyz = raw_scan()
                scans[(seq, frame)] = xyz
                np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)], 1).tofile(
                    os.path.join(velodyne, f"{frame:06d}.bin"))
        t0 = time.perf_counter()
        downsample_kitti.main(["--input_root", os.path.join(raw_tmp, "sequences"), "--output_root",
                               os.path.join(raw_tmp, "downsampled"), "--voxel_size", str(voxel)])
        tool_s = time.perf_counter() - t0
        clouds = {}
        for (seq, frame), xyz in scans.items():
            path = os.path.join(raw_tmp, "downsampled", seq, f"{frame:06d}.npy")
            clouds[(seq, frame)] = np.load(path)
            want = native.grid_subsample_native(xyz, voxel)[0]
            check(clouds[(seq, frame)].tobytes() == want.tobytes(), f"downsample_kitti: {path} differs from native's")
        sizes = [len(c) for c in clouds.values()]
        counts = []
        for xyz in (clouds[(RAW_SEQUENCES[0], 0)], clouds[(RAW_SEQUENCES[0], 1)]):
            padded, pad_masks = pad_points(xyz, kcaps.points[0])
            pyr = build_pyramid(torch.from_numpy(padded).to(dev), torch.from_numpy(pad_masks).to(dev), bb.num_stages,
                                voxel, radius, kcaps.neighbor_limits, kcaps.points, kcaps.search_chunk)
            counts.append([int(m.sum()) for m in pyr["masks"]])
        print(f"[downsample_kitti] {card}: {len(scans)} scans of {RAW_SCAN_POINTS} points in {tool_s:.2f} s, "
              f".npy files equal to native's ({', '.join(map(str, sizes))} points); one pair's levels: "
              + "; ".join(", ".join(f"{n}/{c}" for n, c in zip(cnt, kcaps.points)) for cnt in counts))
        check(all(n < c for cnt in counts for n, c in zip(cnt, kcaps.points)), f"downsample_kitti: a level is full: "
                                                                               f"{counts} against {kcaps.points}")

    # (c) eval_dgr over phase 8's dumps, copied to the per-epoch directory
    # that eval_dgr reads (test.py writes FEATURE_DIR/<benchmark>)
    env_3dmatch = {"REF_GT_3DMATCH_ROOT": os.path.join(cli_tmp, "3DMatch"),
                   "REF_GT_OUTPUT_ROOT": os.path.join(cli_tmp, "output"), "REF_GT_USE_AUG": "0"}
    keys = ("REF_GT_3DMATCH_ROOT", "REF_GT_OUTPUT_ROOT", "REF_GT_USE_AUG", "REF_GT_CAPS_SCALE",
            "REF_GT_NEIGHBOR_LIMITS", "REF_GT_VAL_EVERY", "REF_GT_KITTI_ROOT")
    with scoped_env(keys, **env_3dmatch):
        val_dir = os.path.join(m_config.FEATURE_DIR, "val")
        lgr = m_eval.main(["--benchmark", "val", "--method", "lgr"])
        shutil.copytree(val_dir, val_dir + "-epoch-1")
        best = eval_dgr.main(["--benchmark", "val", "--epochs", "1", "1"])
        check(best is not None and best[0] == 1, f"eval_dgr: best epoch {best and best[0]}, expected 1")
        check(best[1]["RR"] == lgr["RR"], f"eval_dgr: RR {best[1]['RR']}, eval --method lgr {lgr['RR']}")
        print(f"[eval_dgr] {card}: best epoch 1, RR {best[1]['RR']:.4f} (eval --method lgr on phase 8's dumps: "
              f"{lgr['RR']:.4f})")
        shutil.rmtree(val_dir)

    # (d) the wrappers, each a shell running test then eval as subprocesses,
    # from a directory outside the repository
    def wrapper(exp, args, env, feature_dir, n_pairs, tag):
        script = os.path.join(ROOT, "ref_geotransformer_tpu_torch", "experiments", exp, "eval.sh")
        env = {**{k: v for k, v in os.environ.items() if k not in keys and k != "PYTHONPATH"}, **env}
        t0 = time.perf_counter()
        proc = subprocess.run(["bash", script, *args], capture_output=True, text=True, env=env, cwd=os.path.dirname(
            feature_dir), timeout=WRAPPER_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"{tag} eval.sh exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                                    f"{proc.stderr[-3000:]}")
        dumps = sorted(glob.glob(os.path.join(feature_dir, "*.npz")))
        check(len(dumps) == n_pairs, f"{tag} eval.sh wrote {len(dumps)} .npz dumps, expected {n_pairs}")
        # test prints its online summary, then eval its offline one: a dict a line each
        summaries = [ast.literal_eval(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        check(len(summaries) == 2 and all("RR" in s for s in summaries),
              f"{tag} eval.sh: expected the test's and the eval's summary lines in\n{proc.stdout[-3000:]}")
        for summary in summaries:
            check(all(math.isfinite(v) for v in summary.values()), f"{tag} eval.sh: non-finite summary {summary}")
            check(0.0 <= summary["RR"] <= 1.0, f"{tag} eval.sh: RR {summary['RR']} outside [0, 1]")
        summary = summaries[-1]
        print(f"[wrapper:{tag}] {card}: bash eval.sh {' '.join(args)}: exit 0 in {seconds:.1f} s, {len(dumps)} .npz "
              f"dumps; " + ", ".join(f"{k} {v}" for k, v in summary.items()))

    with scoped_env(keys, **env_3dmatch):
        feature_dir = os.path.join(m_config.FEATURE_DIR, "val")
    wrapper("geotransformer_3dmatch_stage4", ["epoch-1", "val"], env_3dmatch, feature_dir, FIXTURE_VAL_PAIRS, "3dmatch")
    env_kitti = {"REF_GT_KITTI_ROOT": os.path.join(kitti_tmp, "Kitti"),
                 "REF_GT_OUTPUT_ROOT": os.path.join(kitti_tmp, "output")}
    with scoped_env(keys, **env_kitti):
        feature_dir = k_config.FEATURE_DIR
    shutil.rmtree(feature_dir)
    wrapper("geotransformer_kitti_stage5", ["epoch-1"], env_kitti, feature_dir, KITTI_PAIRS_PER_SEQUENCE, "kitti")

    # (e) the overfit probe through run_probe; each train step and evaluation
    # timed to a synchronize and its launches counted, and the model and pairs
    # of the last evaluation kept
    records = {"train": [], "eval": []}
    last_eval = {}

    def counted(kind, fn):
        def wrapped(*args, **kwargs):
            before = read_counts(ck)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            records[kind].append((1e3 * (time.perf_counter() - t0),
                                  tuple(x - y for x, y in zip(read_counts(ck), before))))
            if kind == "eval":
                last_eval["args"] = args
            return out
        return wrapped

    originals = probe.train_pairs, probe.evaluate_pairs
    probe.train_pairs, probe.evaluate_pairs = counted("train", probe.train_pairs), counted("eval", probe.evaluate_pairs)
    totals = [0, 0, 0]
    try:
        for tag, regime in (("i", PROBE_GATED), ("ii", PROBE_LONG)):
            records["train"].clear()
            records["eval"].clear()
            p = regime["pairs"]
            out = os.path.join(ROOT, "chiprun_out", f"overfit_probe_{tag}.json")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts(ck)
            t0 = time.perf_counter()
            result = probe.run_probe(**regime, out=out, device="cuda")
            seconds = time.perf_counter() - t0
            counts = read_counts(ck)
            totals = [a + b for a, b in zip(totals, counts)]
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            traj = result["trajectory"]
            steps, evals = records["train"], records["eval"]
            check(len(steps) == regime["steps"] and len(evals) == len(traj),
                  f"probe ({tag}): {len(steps)} train steps and {len(evals)} evaluations timed")
            check(all(r[1] == (2 * p, 2 * p, 0) for r in steps),
                  f"probe ({tag}): a train step's launches differ from {(2 * p, 2 * p, 0)}: "
                  f"{sorted({r[1] for r in steps})}")
            check(all(r[1] == (2 * p, 0, p) for r in evals),
                  f"probe ({tag}): an evaluation's launches differ from {(2 * p, 0, p)}: {sorted({r[1] for r in evals})}")
            check(counts == tuple(sum(r[1][i] for r in steps + evals) for i in range(3)),
                  f"probe ({tag}): {counts} launches in all, not the steps' and evaluations'")
            warm = [ms for ms, _ in steps[1:]]
            check(all(math.isfinite(v) for row in traj for v in row.values()), f"probe ({tag}): a non-finite row")
            check(all(row["skipped_steps"] == 0 for row in traj), f"probe ({tag}): skipped steps "
                                                                   f"{[row['skipped_steps'] for row in traj]}")
            check(len(traj) > 2 and traj[-1]["train_loss"] < traj[1]["train_loss"],
                  f"probe ({tag}): train loss {traj[1]['train_loss']} -> {traj[-1]['train_loss']}, not falling")
            window = traj[-3:]
            mean_rr = sum(row["RR"] for row in window) / len(window)
            best_rmse = min(row["RMSE"] for row in traj)
            print(f"[probe:{tag}] {card}: scale {regime['scale']}, {p} pairs, {regime['steps']} steps, caps "
                  f"{probe.probe_config(regime['scale']).capacities.points}: {seconds:.1f} s in all; "
                  f"{sum(warm) / len(warm):.2f} ms/step over steps 2-{len(steps)} (first {steps[0][0]:.2f} ms), "
                  f"{sum(ms for ms, _ in evals) / len(evals):.2f} ms per evaluation of {p} pairs; peak memory "
                  f"{peak:.2f} GiB; launches per step {steps[0][1]}, per evaluation {evals[0][1]}, in all {counts}; "
                  f"train loss {traj[1]['train_loss']} -> {traj[-1]['train_loss']}, RR over the last 3 evaluations "
                  f"{mean_rr:.4f}, best RMSE {best_rmse}; trajectory in {os.path.relpath(out, ROOT)}")
            # the three kernels against their plain versions on the probe's own
            # inputs: the trained model, the coarse nodes of its last pair and
            # the Sinkhorn scores of that pair's evaluation (these launches come
            # after the count)
            model, inputs = last_eval.pop("args")
            data = inputs[-1]
            print(f"[probe:{tag}] the kernels on the trained model and pair {len(inputs) - 1}'s inputs:")
            kc.check_embedding(model, data["src"]["points"][-1], data["src"]["masks"][-1])
            captured = {}
            hook = model.optimal_transport.register_forward_pre_hook(
                lambda module, inputs: captured.update(inputs=inputs))
            with torch.no_grad():
                model(data)
            hook.remove()
            ot = model.optimal_transport
            with torch.no_grad():
                padded, log_mu, log_nu, _ = ot.prepare(*captured["inputs"])
            kc.check_sinkhorn(f"probe ({tag})", padded, log_mu, log_nu, ot.num_iterations)
            del model, inputs, data, captured, padded, log_mu, log_nu
            if regime is PROBE_GATED:  # tests/test_overfit_registration.py's gates, unchanged
                check(mean_rr >= 0.9, f"probe (i): RR over the last 3 evaluations {mean_rr} < 0.9: "
                                      f"{[(row['step'], row['RR']) for row in traj]}")
                check(best_rmse < 0.1, f"probe (i): RMSE never dropped below 0.1 (best {best_rmse})")
    finally:
        probe.train_pairs, probe.evaluate_pairs = originals
    print(f"[scripts] {card}: phase 14 took {time.perf_counter() - phase_t0:.1f} s")
    return tuple(totals)


@contextlib.contextmanager
def searches_through(group_fn):
    """`ops/neighbors.py::radius_search_group`, and so every pyramid built in
    the block, calls group_fn(searches, chunk) in place of the kernel's
    grouped wrapper."""
    from ref_geotransformer_tpu_torch.ops import neighbors

    original = neighbors.cuda_kernels
    neighbors.cuda_kernels = types.SimpleNamespace(radius_search_group=group_fn, radius_search=original.radius_search)
    try:
        yield
    finally:
        neighbors.cuda_kernels = original


def plain_searches(ck):
    """A group's searches through the plain version, one by one."""
    def run(searches, chunk=2048):
        return [ck.radius_search_plain(*search, chunk) for search in searches]
    return run


def recorded_searches(ck, groups):
    """The kernel's grouped wrapper, each group's searches appended to
    `groups` as one list."""
    def record(searches, chunk=2048):
        searches = list(searches)
        groups.append(searches)
        return ck.radius_search_group(searches, chunk)
    return searches_through(record)


def radius_work(q_masks, s_masks, limit):
    """8 f32 operations per (valid query, valid support) pair (a 3-term dot
    product and two adds); bytes: points and masks read once, the int32
    table written once."""
    m, n = q_masks.shape[0], s_masks.shape[0]
    flops = 8.0 * float(q_masks.sum()) * float(s_masks.sum())
    return flops, 13.0 * (m + n) + 4.0 * m * limit


def slot_error(got, want, q, s, radius):
    """Largest |d^2| difference slot by slot between two tables (float64
    squared distances; an empty slot counts as r^2): 0 where they differ
    only by the order of exact ties."""
    import numpy as np

    q64 = q.astype(np.float64)
    s64 = np.concatenate([s.astype(np.float64), np.zeros((1, 3))])

    def d2(table):
        d = np.sum((q64[:, None, :] - s64[table]) ** 2, axis=-1)
        return np.where(table == s.shape[0], radius * radius, d)

    return float(np.abs(d2(got) - d2(want)).max())


def radius_chain(ck, dev, card, seen=None):
    """Phase 15 on the card. Returns (the kernel's result row for the
    `kernels` line, its launches in the pyramids built through
    build_registration_inputs). Each group it holds to the plain version is
    appended to `seen`, if given, as (label, searches, tables)."""
    import tempfile
    import time

    import numpy as np
    import torch

    from ref_geotransformer_tpu_torch import demo
    from ref_geotransformer_tpu_torch.config.modelnet import make_cfg as linemod_cfg
    from ref_geotransformer_tpu_torch.config.threedmatch import make_cfg
    from ref_geotransformer_tpu_torch.data import PairLoader, build_pyramid, build_registration_inputs, pad_points
    from ref_geotransformer_tpu_torch.data.datasets.linemod import LMODataset
    from ref_geotransformer_tpu_torch.engine.steps import ensure_pyramids, to_device
    from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import config as k_config
    from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import fixture as k_fixture
    from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import fixture as lm_fixture
    from ref_geotransformer_tpu_torch.ops.subsample import grid_subsample
    from ref_geotransformer_tpu_torch.tools.overfit_probe import probe_config, probe_pairs
    from ref_geotransformer_tpu_torch.utils.neighbor_tables import table_mismatches

    phase_t0 = time.perf_counter()
    errs = []

    # the build: one search instance for every limit, its lists in shared memory
    for limit in (1, 38, 128):
        info = ck.radius_search_info(limit)
        print(f"[radius:build] {card}: limit {limit}: search kernel {info['registers']} registers, "
              f"{info['local_bytes']} bytes of local memory (stack and spills), {info['static_shared']} + "
              f"{info['dynamic_shared']} bytes of shared memory, {info['blocks_per_sm']} blocks of "
              f"{info['queries']} queries an SM; pack kernel {info['pack_registers']} registers, "
              f"{info['pack_local_bytes']} bytes local; tiles of {info['tile']} supports, at most "
              f"{info['max_slices']} slices a search (the cluster size)")
        check(info["local_bytes"] == 0 and info["pack_local_bytes"] == 0,
              f"radius search at limit {limit}: local memory in use: {info}")

    def check_group(label, searches):
        """The kernel against the plain version on one group: two launches
        bit-identical, each table equal to its search run alone (a group of
        one) and to the plain version up to ties. Prints and returns the
        rows that differ at ties, the slot error and the mean neighbors of
        a valid query, per search."""
        got = ck.radius_search_group(searches)
        slices = list(ck.radius_search_group.slices)
        if seen is not None:
            seen.append((label, searches, got))
        again = ck.radius_search_group(searches)
        torch.cuda.synchronize()
        rows = []
        for k, (table, twice, (q, s, qm, sm, radius, limit)) in enumerate(zip(got, again, searches)):
            m, n = q.shape[0], s.shape[0]
            what = f"{label}, search {k}: {m} x {n}, r {radius:g}, limit {limit}"
            check(table.dtype == torch.int32 and tuple(table.shape) == (m, limit),
                  f"radius_search_group {what}: {table.dtype} {tuple(table.shape)}")
            check(torch.equal(table, twice), f"radius_search_group {what}: two launches differ")
            check(torch.equal(table, ck.radius_search(q, s, qm, sm, radius, limit)),
                  f"radius_search_group {what}: differs from the search alone")
            check(bool(((table >= 0) & (table <= n)).all()), f"radius_search_group {what}: an index outside 0..N")
            check(bool((table[~qm] == n).all()), f"radius_search_group {what}: an invalid query's row holds a neighbor")
            want = ck.radius_search_plain(q, s, qm, sm, radius, limit)
            g, w, qn, sn = (x.cpu().numpy() for x in (table, want, q, s))
            differ, bad, _ = table_mismatches(g, w, qn, sn, RADIUS_TIE, scaled=True)
            check(not bad, f"radius_search_group {what}: {len(bad)} rows differ from the plain version beyond ties: "
                           f"{bad[:3]}")
            err = slot_error(g, w, qn, sn, radius)
            errs.append(err)
            valid = qm.cpu().numpy()
            rows.append((differ, err, float((g[valid] < n).sum(1).mean()) if valid.any() else 0.0))
        print(f"[radius] {card}: {label}: {len(searches)} searches in one launch ("
              + ", ".join(f"{c[0].shape[0]}x{c[1].shape[0]}/{c[5]}" for c in searches) + f"); slices {slices}; "
              f"rows differing at ties {', '.join(str(r[0]) for r in rows)}, none beyond; slot error "
              f"{max(r[1] for r in rows):.3e}; neighbors a valid query {', '.join('%.1f' % r[2] for r in rows)}; two "
              f"launches bit-identical, each search as alone")
        return rows

    def one_group(groups, label, count):
        check(len(groups) == 1 and len(groups[0]) == count,
              f"{label}: {[len(g) for g in groups]} searches in {len(groups)} groups, expected one group of {count}")
        return groups[0]

    # (a.1) the 3DMatch demo pair's pyramids at demo and full caps, one group a pair
    pyramids = {}
    for demo_caps in (True, False):
        regime = "demo" if demo_caps else "full"
        cfg = make_cfg(demo=demo_caps)
        bb, caps = cfg.backbone, cfg.capacities
        pair = demo.load_pair(cfg, dev)
        groups = []
        with recorded_searches(ck, groups):
            build_registration_inputs(pair["ref_points"], pair["ref_masks"], pair["src_points"], pair["src_masks"],
                                      bb.num_stages, bb.init_voxel_size, bb.init_radius, caps.neighbor_limits,
                                      caps.points, search_chunk=caps.search_chunk)
        searches = one_group(groups, f"3DMatch {regime}", 20)
        check_group(f"3DMatch {regime} caps {caps.points}, limits {caps.neighbor_limits}", searches)
        pyramids[regime] = (cfg, pair, searches)

    # (a.2) the KITTI pyramid of phase 14's raw scan, downsampled at 0.3 m on the card
    kcfg = k_config.make_cfg()
    kbb, kcaps = kcfg.backbone, kcfg.capacities
    scan = k_fixture._scan(np.random.default_rng(14), RAW_SCAN_POINTS, KITTI_RADIUS, True)
    scan[:, 2] -= SENSOR_HEIGHT
    points = torch.from_numpy(scan).to(dev)
    down, down_m = grid_subsample(points, torch.ones(len(scan), dtype=torch.bool, device=dev), kbb.init_voxel_size,
                                  kcaps.points[0])
    groups = []
    with recorded_searches(ck, groups):
        build_pyramid(down, down_m, kbb.num_stages, kbb.init_voxel_size, kbb.init_radius, kcaps.neighbor_limits,
                      kcaps.points, kcaps.search_chunk)
    check_group(f"KITTI scan of {RAW_SCAN_POINTS} points, {int(down_m.sum())} voxels, caps {kcaps.points}, limits "
                f"{kcaps.neighbor_limits}", one_group(groups, "KITTI", 13))
    del points, down, down_m, groups

    # (a.3) a LineMod pair's pyramids (fixture frame, published caps)
    with tempfile.TemporaryDirectory() as lm_tmp:
        lm_fixture.make_linemod_tree(os.path.join(lm_tmp, "linemod"), n_train=1, n_test=1)
        lcfg = linemod_cfg()
        dataset = LMODataset(lm_tmp, data_augmentation=False, points_limit=1000, mode="test", seed=lcfg.seed)
        pair, _ = next(PairLoader(dataset, lcfg).iter_single())
        groups = []
        with recorded_searches(ck, groups):
            ensure_pyramids(lcfg, to_device(pair, dev))
    check_group(f"LineMod pair, caps {lcfg.capacities.points}, limits {lcfg.capacities.neighbor_limits}",
                one_group(groups, "LineMod", 14))

    # (a.4) probe (i)'s pairs (phase 14: the JAX slow test's regime, caps scaled by 0.06)
    pcfg = probe_config(PROBE_GATED["scale"])
    pbb, pcaps = pcfg.backbone, pcfg.capacities
    probe = []
    for ref, src, _ in probe_pairs(pcfg, PROBE_GATED["pairs"]):
        padded = [pad_points(cloud, pcaps.points[0]) for cloud in (ref, src)]
        probe.append([torch.from_numpy(a).to(dev) for cloud in padded for a in cloud])
    groups = []
    with recorded_searches(ck, groups):
        for ref_p, ref_m, src_p, src_m in probe:
            build_registration_inputs(ref_p, ref_m, src_p, src_m, pbb.num_stages, pbb.init_voxel_size,
                                      pbb.init_radius, pcaps.neighbor_limits, pcaps.points,
                                      search_chunk=pcaps.search_chunk)
    check(len(groups) == len(probe) and all(len(g) == 20 for g in groups),
          f"probe (i): {[len(g) for g in groups]} searches, expected one group of 20 a pair")
    check_group(f"probe (i) pair, caps {pcaps.points}, limits {pcaps.neighbor_limits}", groups[0])

    # (a.5) seeded ragged clouds: M and N off the tiles, invalid queries,
    # duplicated supports (exact ties), the shortest and longest rows, and
    # fewer valid supports than the row holds, in one group
    rng = np.random.default_rng(15)
    s = rng.uniform(0.0, 1.0, (RAGGED_SUPPORTS, 3)).astype(np.float32)
    s[RAGGED_DUPLICATES: 2 * RAGGED_DUPLICATES] = s[:RAGGED_DUPLICATES]
    q = s[:RAGGED_QUERIES]
    qm = rng.uniform(size=RAGGED_QUERIES) < 0.9
    sm = rng.uniform(size=RAGGED_SUPPORTS) < 0.9
    few = rng.uniform(size=200) < 0.3
    q, s, qm, sm, few = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (q, s, qm, sm, few))
    ragged = [(q, s, qm, sm, 0.25, 128), (q, s, qm, sm, 0.25, 1), (q, s, qm, sm, 0.1, 38),
              (q[:1000], s[:200], qm[:1000], few, 2.0, 128), (s, q, sm, qm, 0.15, 64)]
    check_group(f"seeded ragged clouds ({RAGGED_DUPLICATES} duplicated supports)", ragged)
    got = ck.radius_search(*ragged[3])
    check(bool(((got < 200).sum(1)[qm[:1000]] == int(few.sum())).all()),
          "radius_search: a valid query does not hold every valid support of the sparse cloud")

    # (b) times: each full-caps level-0 search alone, then a pair's 20 searches as one group
    cfg, pair, searches = pyramids["full"]
    rows = []
    for call, label in zip(searches[:3], ("neighbors[0]", "subsampling[0]", "upsampling[0]")):
        ms = cuda_ms(lambda: ck.radius_search(*call))
        slices = ck.radius_search_group.slices
        plain_ms = cuda_ms(lambda: ck.radius_search_plain(*call), iters=3, warmup=1)
        bound_ms, bound_by = roofline(*radius_work(call[2], call[3], call[5]), PEAK_F32_FLOPS)
        rows.append({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"[radius:time] {card}: full caps {label} ({call[0].shape[0]} x {call[1].shape[0]}, "
              f"{int(call[2].sum())} x {int(call[3].sum())} valid, limit {call[5]}, {slices[0]} slices): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms ({plain_ms / ms:.1f}x); bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of it")
    for regime in ("demo", "full"):
        cfg, pair, searches = pyramids[regime]
        ms = cuda_ms(lambda: ck.radius_search_group(searches))
        plain_ms = cuda_ms(lambda: [ck.radius_search_plain(*c) for c in searches], iters=3, warmup=1)
        bound_ms = sum(roofline(*radius_work(c[2], c[3], c[5]), PEAK_F32_FLOPS)[0] for c in searches)
        print(f"[radius:time] {card}: the 20 searches of a pair's pyramids at {regime} caps in one launch (slices "
              f"{ck.radius_search_group.slices}): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
              f"({plain_ms / ms:.1f}x); bound {bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of it")

    # (c) build_registration_inputs and the inference path per pair, and
    # probe (i)'s pyramids, the kernel against the plain version in turns
    # (plain, kernel, kernel, plain); each kernel turn launches it once a
    # pair, for 20 searches
    def timed(step, kernel, pairs=1):
        """ms per pair over TIMED_ITERS calls of step (each over `pairs`
        pairs) after a warm-up, with the kernel or with the plain version in
        its place, and the kernel's launches and searches in those calls."""
        def searches():
            return contextlib.nullcontext() if kernel else searches_through(plain_searches(ck))

        with searches():
            step()
            torch.cuda.synchronize()
        reset_counts(ck)
        with searches():
            t0 = time.perf_counter()
            for _ in range(TIMED_ITERS):
                step()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / (TIMED_ITERS * pairs)
        return ms, ck.radius_search_group.launches, ck.radius_search_group.searches

    def in_turns(name, step, pairs=1):
        turns, launched = [], 0
        for kernel in (False, True, True, False):
            ms, groups, count = timed(step, kernel, pairs)
            want = (TIMED_ITERS * pairs, 20 * TIMED_ITERS * pairs) if kernel else (0, 0)
            check((groups, count) == want, f"{name}: {groups} radius-search launches for {count} searches over "
                                           f"{TIMED_ITERS * pairs} pairs, expected {want}")
            launched += groups
            turns.append(f"{'kernel' if kernel else 'plain'} {ms:.2f}")
        print(f"[radius:turns] {card}: {name}, ms/pair in turns: {', '.join(turns)} (one radius-search launch of 20 "
              f"searches a pair with the kernel)")
        return launched

    launches = 0
    for regime in ("demo", "full"):
        cfg, pair, _ = pyramids[regime]
        bb, caps = cfg.backbone, cfg.capacities
        model = demo.build_model(cfg, dev, seed=0)
        launches += in_turns(f"build_registration_inputs at {regime} caps", lambda: build_registration_inputs(
            pair["ref_points"], pair["ref_masks"], pair["src_points"], pair["src_masks"], bb.num_stages,
            bb.init_voxel_size, bb.init_radius, caps.neighbor_limits, caps.points, search_chunk=caps.search_chunk))
        launches += in_turns(f"inference at {regime} caps", lambda: demo.register(model, cfg, pair))
        del model
        torch.cuda.empty_cache()

    def probe_pyramids():
        for ref_p, ref_m, src_p, src_m in probe:
            build_registration_inputs(ref_p, ref_m, src_p, src_m, pbb.num_stages, pbb.init_voxel_size,
                                      pbb.init_radius, pcaps.neighbor_limits, pcaps.points,
                                      search_chunk=pcaps.search_chunk)

    launches += in_turns(f"probe (i)'s pyramids (build_registration_inputs over its {len(probe)} pairs, caps "
                         f"{pcaps.points})", probe_pyramids, pairs=len(probe))
    print(f"[radius] {card}: phase 15 took {time.perf_counter() - phase_t0:.1f} s")
    result = dict(rows[0], max_abs_err=max(errs), library_ms=None)
    return result, launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing was run")
    sys.path.insert(0, ROOT)
    import dataclasses
    import tempfile
    import time

    from ref_geotransformer_tpu_torch import demo
    from ref_geotransformer_tpu_torch.config.threedmatch import make_cfg
    from ref_geotransformer_tpu_torch.data import build_pyramid, build_registration_inputs
    from ref_geotransformer_tpu_torch.engine import train_step
    from ref_geotransformer_tpu_torch.models import cuda_kernels as ck
    from ref_geotransformer_tpu_torch.models.losses import overall_loss
    from ref_geotransformer_tpu_torch.ops.metrics import isotropic_transform_error
    from ref_geotransformer_tpu_torch.train import make_train_run
    from ref_geotransformer_tpu_torch.utils import build

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_per_s = SFU_PER_CLOCK_PER_SM * sms * float(clock.stdout.split()[0]) * 1e6
    print(f"{sms} SMs, largest SM clock {clock.stdout.split()[0]} MHz: SFU rate {sfu_per_s:.4g} a second")

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s ({build.LIBRARY})")
    with open(build.BUILD_LOG) as f:
        for line in f:
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                print("[build] " + line.strip())
    from ref_geotransformer_tpu_torch.ops import svd as svd_ops

    check(svd_ops.matches_torch(dev), f"ops/svd.py's cuSOLVER call differs from torch {torch.__version__}'s linalg.svd")
    print(f"[build] ops/svd.py's cuSOLVER call is torch {torch.__version__}'s linalg.svd bit for bit on the probe batch")

    # 3. kernels against their plain versions, at main-path shapes
    results = {}
    emb_rows, bwd_rows, sinkhorn_errs = [], [], []

    def check_embedding(model, nodes, node_masks):
        """The forward and backward kernels on one node cloud, against their plain versions."""
        n, c, k = nodes.shape[0], model.transformer.embedding.hidden_dim, model.transformer.embedding.angle_k
        with torch.no_grad():
            (args,) = model.transformer.embedding.kernel_args(nodes[None], node_masks[None])
            got = ck.geometric_embedding(*args)
            want = ck.geometric_embedding_plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            del got, want
            ms = cuda_ms(lambda: ck.geometric_embedding(*args))
            plain_ms = cuda_ms(lambda: ck.geometric_embedding_plain(*args))
        print(f"[kernel] geo_embedding N={n} ({int(node_masks.sum())} valid nodes) C={c} k={k}: "
              f"max_abs_err {err:.3e} (bound {EMBEDDING_BOUND:.2e}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(err <= EMBEDDING_BOUND, f"geo_embedding N={n}: error {err} above {EMBEDDING_BOUND}")
        emb_rows.append((n, err, ms, plain_ms))

        # the backward, on a seeded cotangent
        points, ref_vectors, div_term, _, _, wa, ba, sigma_d, factor_a, _ = args
        geometry = (points, ref_vectors, div_term, wa.detach(), ba.detach())
        g_full = torch.randn((n, n, c), generator=torch.Generator(device=dev).manual_seed(n), device=dev)
        near = ck.near_ties(*geometry, sigma_d, factor_a, NEAR_TIE)
        near_share = float(near.float().mean())
        g = torch.where(near, 0.0, g_full)
        del near
        bwd_args = (*geometry, g, sigma_d, factor_a)
        got = ck.geometric_embedding_bwd(*bwd_args)
        again = ck.geometric_embedding_bwd(*bwd_args)
        want = ck.geometric_embedding_bwd_plain(*bwd_args)
        torch.cuda.synchronize()
        identical = all(torch.equal(x, y) for x, y in zip(got, again))
        abs_err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        rel_err = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(got, want))
        full_args = (*geometry, g_full, sigma_d, factor_a)
        rel_err_full = max(float((x - y).abs().max() / y.abs().max()) for x, y in
                           zip(ck.geometric_embedding_bwd(*full_args), ck.geometric_embedding_bwd_plain(*full_args)))
        del got, again, want, g_full, full_args
        ms = cuda_ms(lambda: ck.geometric_embedding_bwd(*bwd_args))
        plain_ms = cuda_ms(lambda: ck.geometric_embedding_bwd_plain(*bwd_args), iters=3, warmup=1)
        print(f"[kernel] geo_embedding_bwd N={n} C={c} k={k}: max error {rel_err:.3e} of the gradients' magnitude "
              f"(bound {EMBEDDING_BWD_BOUND:.0e}; {abs_err:.3e} abs) with {near_share * 100:.4f}% near-tied "
              f"entries of g zeroed; {rel_err_full:.3e} with them in; "
              f"two launches bit-identical: {identical}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(identical, f"geo_embedding_bwd N={n}: two launches on the same inputs differ")
        check(rel_err <= EMBEDDING_BWD_BOUND, f"geo_embedding_bwd N={n}: error {rel_err} above {EMBEDDING_BWD_BOUND}")
        bwd_rows.append((n, abs_err, rel_err, ms, plain_ms))

    def check_sinkhorn(label, padded, log_mu, log_nu, iters):
        """The Sinkhorn kernel against its plain version on one batch of patches."""
        with torch.no_grad():
            got = ck.sinkhorn_log_norm(padded, log_mu, log_nu, iters)
            want = ck.sinkhorn_log_norm_plain(padded, log_mu, log_nu, iters)
            torch.cuda.synchronize()
            valid = padded > -1e11
            err = float((got - want)[valid].abs().max())
            masked_ok = bool((got[~valid] < -1e11).all() and (want[~valid] < -1e11).all())
            ms = cuda_ms(lambda: ck.sinkhorn_log_norm(padded, log_mu, log_nu, iters))
            plain_ms = cuda_ms(lambda: ck.sinkhorn_log_norm_plain(padded, log_mu, log_nu, iters))
        b, m1, n1 = padded.shape
        bound_ms, bound_by, term = sinkhorn_bound(b, m1, n1, iters, sfu_per_s)
        print(f"[kernel] sinkhorn ({label}) B={b} {m1}x{n1} iters={iters} "
              f"({float(valid.float().mean()) * 100:.1f}% valid entries): max_abs_err {err:.3e} on valid "
              f"entries (bound {SINKHORN_BOUND:.0e}), kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
              f"{bound_ms:.4f} ms, set by the {term}: {100 * bound_ms / ms:.1f}% of it")
        check(err <= SINKHORN_BOUND, f"sinkhorn {m1}x{n1}: error {err} above {SINKHORN_BOUND}")
        sinkhorn_errs.append(err)
        check(masked_ok, f"sinkhorn {m1}x{n1}: a masked entry came out above -1e11")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}

    for demo_caps in (True, False):
        cfg = make_cfg(demo=demo_caps)
        model = demo.build_model(cfg, dev, seed=0)
        pair = demo.load_pair(cfg, dev)
        bb, caps = cfg.backbone, cfg.capacities
        pyr = build_pyramid(pair["ref_points"], pair["ref_masks"], bb.num_stages, bb.init_voxel_size,
                            bb.init_radius, caps.neighbor_limits, caps.points, caps.search_chunk)
        nodes, node_masks = pyr["points"][-1], pyr["masks"][-1]
        check_embedding(model, nodes, node_masks)
        if demo_caps:
            check_embedding(model, nodes[:RAGGED_NODES].contiguous(), node_masks[:RAGGED_NODES].contiguous())

            captured = {}

            def capture(module, inputs):
                captured["inputs"] = inputs

            hook = model.optimal_transport.register_forward_pre_hook(capture)
            demo.register(model, cfg, pair)
            hook.remove()
            ot = model.optimal_transport
            with torch.no_grad():
                padded, log_mu, log_nu, _ = ot.prepare(*captured["inputs"])
                results["sinkhorn"] = check_sinkhorn("main path", padded, log_mu, log_nu, ot.num_iterations)
                # the KITTI / ModelNet patch: 128 points and the dustbin
                gen = torch.Generator(device=dev).manual_seed(129)
                b, k1 = padded.shape[0], 128
                scores = torch.randn((b, k1, k1), generator=gen, device=dev)
                row_masks = torch.rand((b, k1), generator=gen, device=dev) < 0.95
                col_masks = torch.rand((b, k1), generator=gen, device=dev) < 0.95
                check_sinkhorn("seeded", *ot.prepare(scores, row_masks, col_masks)[:3], ot.num_iterations)
        del model
        torch.cuda.empty_cache()
    masked_rows = masked_embedding_rows(ck, dev)
    k, c = make_cfg().geotransformer.angle_k, make_cfg().geotransformer.hidden_dim
    # the embedding's products against the f32-accurate tensor-core rate; the
    # bound on the CUDA cores' f32 rate is printed beside it, not recorded
    works = {"geo_embedding": embedding_work(emb_rows[-1][0], k, c, backward=False),  # full caps, N = 1024
             "geo_embedding_bwd": embedding_work(bwd_rows[-1][0], k, c, backward=True)}
    n, _, ms, plain_ms = emb_rows[-1]
    bound_ms, bound_by = roofline(*works["geo_embedding"], PEAK_F32_PRODUCT_FLOPS)
    results["geo_embedding"] = {"max_abs_err": max(r[1] for r in emb_rows), "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "masked": masked_rows}
    n, _, _, ms, plain_ms = bwd_rows[-1]
    bound_ms, bound_by = roofline(*works["geo_embedding_bwd"], PEAK_F32_PRODUCT_FLOPS)
    results["geo_embedding_bwd"] = {"max_abs_err": max(r[1] for r in bwd_rows),
                                    "max_rel_err": max(r[2] for r in bwd_rows), "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    for name, r in results.items():
        core = ""
        if name in works:
            core = f"; on the CUDA cores' f32 rate {roofline(*works[name], PEAK_F32_FLOPS)[0]:.3f} ms"
        print(f"[kernel] {name}: {r['ms']:.3f} ms against a bound of {r['bound_ms']:.3f} ms ({r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of the roofline{core}")

    # 4. the inference path at demo and full capacities
    # phases 7-14 add the model's three kernels (read_counts); phases 4 and 15
    # count the pyramid's radius-search launches (one group a pair)
    launches = {"geo_embedding": 0, "geo_embedding_bwd": 0, "sinkhorn": 0, "radius_search": 0}
    for demo_caps in (True, False):
        regime = "demo" if demo_caps else "full"
        cfg = make_cfg(demo=demo_caps)
        model = demo.build_model(cfg, dev, seed=0)
        pair = demo.load_pair(cfg, dev)
        demo.register(model, cfg, pair)  # warm-up: allocator, library load
        torch.cuda.synchronize()
        reset_counts(ck)
        out = demo.register(model, cfg, pair)
        torch.cuda.synchronize()
        counts = read_counts(ck)
        groups, searches = ck.radius_search_group.launches, ck.radius_search_group.searches
        print(f"[path:{regime}] kernel launches in one forward: geo_embedding {counts[0]}, "
              f"geo_embedding_bwd {counts[1]}, sinkhorn {counts[2]}, radius_search {groups} (the pair's pyramids: "
              f"{searches} searches in one group)")
        check(counts == (2, 0, 1), f"{regime}: expected 2 geo_embedding, 0 backward and 1 sinkhorn launches, "
                                   f"got {counts}")
        check(groups == 1 and searches == 20, f"{regime}: expected one radius_search_group launch of 20 searches (10 "
                                              f"a cloud), got {groups} launches of {searches}")
        for name, count in zip(launches, counts):
            launches[name] += count
        launches["radius_search"] += groups
        est = out["estimated_transform"]
        check(tuple(est.shape) == (4, 4) and bool(torch.isfinite(est).all()), f"{regime}: bad transform {est}")
        p = cfg.coarse_matching.num_correspondences
        k1 = cfg.model.num_points_in_patch + 1
        check(tuple(out["matching_scores"].shape) == (p, k1, k1), f"{regime}: matching_scores shape")
        check(bool(torch.isfinite(out["ref_feats_c"]).all()), f"{regime}: non-finite coarse features")

        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_ITERS):
            out = demo.register(model, cfg, pair)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / TIMED_ITERS
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        rre, rte = isotropic_transform_error(pair["transform"], out["estimated_transform"])
        print(f"[path:{regime}] caps {cfg.capacities.points}: {dt * 1e3:.2f} ms/pair, {1.0 / dt:.2f} pairs/s, "
              f"peak memory {peak:.2f} GiB; RRE {float(rre):.2f} deg, RTE {float(rte):.3f} m "
              f"(random weights: not a quality figure)")
        del model, out
        torch.cuda.empty_cache()

    # 5. the inference path in f32, kernels against plain
    cfg = make_cfg(demo=True)
    cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone, dtype="float32"))
    pair = demo.load_pair(cfg, dev)
    with_kernels = demo.build_model(cfg, dev, seed=1)
    plain = demo.build_model(cfg, dev, seed=1, use_kernels=False)
    # one pyramid for both: its segment sums use atomics, whose order varies
    bb, caps = cfg.backbone, cfg.capacities
    data = build_registration_inputs(pair["ref_points"], pair["ref_masks"], pair["src_points"], pair["src_masks"],
                                     bb.num_stages, bb.init_voxel_size, bb.init_radius, caps.neighbor_limits,
                                     caps.points, transform=pair["transform"], search_chunk=caps.search_chunk)
    a = with_kernels(data)
    b = plain(data)
    torch.cuda.synchronize()
    feats_err, padded_err = coarse_feats_gaps(a, b, data)
    # random weights make the coarse scores nearly flat, so the top-256
    # proposals of the two runs can differ in near-tied pairs: compare the
    # Sinkhorn output on the proposals both runs made, matched by node pair
    n_src = a["src_feats_c"].shape[0]
    key_a = a["ref_node_corr_indices"].long() * n_src + a["src_node_corr_indices"].long()
    key_b = b["ref_node_corr_indices"].long() * n_src + b["src_node_corr_indices"].long()
    match = key_a[:, None] == key_b[None, :]
    ia, ib = torch.nonzero(match, as_tuple=True)
    ms_a, ms_b = a["matching_scores"][ia], b["matching_scores"][ib]
    ms_valid = ms_a > -1e11
    ms_err = float((ms_a - ms_b)[ms_valid].abs().max()) if len(ia) else float("nan")
    t_err = float((a["estimated_transform"] - b["estimated_transform"]).abs().max())
    print(f"[path:f32] kernels vs plain: ref_feats_c {feats_err:.3e} on valid nodes (bound {PATH_FEATS_BOUND:.0e}; "
          f"padded nodes {padded_err:.3e}, not compared); "
          f"{len(ia)} of {len(key_a)} node proposals shared, matching_scores on them {ms_err:.3e} "
          f"(valid entries); estimated_transform {t_err:.3e}")
    check(feats_err <= PATH_FEATS_BOUND, f"f32 path: ref_feats_c differs by {feats_err}")
    check(bool(torch.isfinite(a["estimated_transform"]).all() and torch.isfinite(b["estimated_transform"]).all()),
          "f32 path: non-finite transform")

    # 6. one f32 train step, kernels against plain: same weights, same
    # pyramid, same target keys
    grads, step_losses = [], []
    for model in (with_kernels, plain):
        model.zero_grad(set_to_none=True)
        out = model(data, training=True, generator=torch.Generator(device=dev).manual_seed(5))
        losses = overall_loss(out, data["transform"], cfg.coarse_loss, cfg.fine_loss, cfg.loss)
        losses["loss"].backward()
        step_losses.append({key: float(v.detach()) for key, v in losses.items()})
        emb = model.transformer.embedding
        grads.append({f"{proj}.{leaf}": getattr(getattr(emb, proj), leaf).grad
                      for proj in ("proj_d", "proj_a") for leaf in ("weight", "bias")})
    del a, b, out, losses, with_kernels, plain
    torch.cuda.synchronize()
    loss_err = max(abs(step_losses[0][key] - step_losses[1][key]) / abs(step_losses[1][key])
                   for key in ("loss", "c_loss", "f_loss"))
    grad_scale = max(float(g.abs().max()) for g in grads[1].values())
    grad_errs = {name: float((g - grads[1][name]).abs().max()) / grad_scale for name, g in grads[0].items()}
    print(f"[train:f32] kernels vs plain, demo caps: loss {step_losses[0]['loss']:.6f} vs {step_losses[1]['loss']:.6f} "
          f"(c_loss {step_losses[0]['c_loss']:.6f}, f_loss {step_losses[0]['f_loss']:.6f}); losses within "
          f"{loss_err:.3e} relative (bound {TRAIN_LOSS_BOUND:.0e}); embedding gradients (largest magnitude "
          f"{grad_scale:.3e}), error over it: "
          + ", ".join(f"{name} {e:.3e}" for name, e in grad_errs.items()) + f" (bound {TRAIN_GRAD_BOUND:.0e})")
    check(all(v == v and abs(v) != float("inf") for s in step_losses for v in s.values()), "f32 train: non-finite loss")
    check(loss_err <= TRAIN_LOSS_BOUND, f"f32 train: losses differ by {loss_err}")
    check(all(e <= TRAIN_GRAD_BOUND for e in grad_errs.values()), f"f32 train: gradients differ: {grad_errs}")
    del grads
    torch.cuda.empty_cache()

    # 7. the train path at full capacities
    cfg = make_cfg(demo=False)
    model, pair, state, generator = make_train_run(cfg, dev)
    losses = train_step(model, state, pair, generator)  # warm-up
    torch.cuda.synchronize()
    print(f"[train:full] warm-up step: loss {float(losses['loss']):.6f}")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(ck)
    step_ms = []
    for step in range(TRAIN_STEPS):
        before = read_counts(ck)
        t0 = time.perf_counter()
        losses = train_step(model, state, pair, generator)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        counts = tuple(x - y for x, y in zip(read_counts(ck), before))
        values = {key: float(v) for key, v in losses.items()}
        print(f"[train:full] step {step}: loss {values['loss']:.6f}, c_loss {values['c_loss']:.6f}, "
              f"f_loss {values['f_loss']:.6f}; {step_ms[-1]:.2f} ms; launches: geo_embedding {counts[0]}, "
              f"geo_embedding_bwd {counts[1]}, sinkhorn {counts[2]}")
        check(all(v == v and abs(v) != float("inf") for v in values.values()), f"train step {step}: non-finite loss")
        check(counts == (2, 2, 0), f"train step {step}: expected 2 forward, 2 backward embedding launches and no "
                                   f"Sinkhorn launch, got {counts}")
    counts = read_counts(ck)
    for name, count in zip(launches, counts):
        launches[name] += count
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(state.skipped == 0 and state.count == TRAIN_STEPS + 1,
          f"train: {state.skipped} steps skipped by the non-finite guard, {state.count} applied")
    mean_ms = sum(step_ms) / len(step_ms)
    print(f"[train:full] caps {cfg.capacities.points}: {mean_ms:.2f} ms/step ({1e3 / mean_ms:.2f} pairs/s) over "
          f"{TRAIN_STEPS} steps, steps {', '.join(f'{t:.2f}' for t in step_ms)} ms; peak memory {peak:.2f} GiB; "
          f"no step skipped")
    del model, state
    torch.cuda.empty_cache()

    # phases 8 and 10 keep their trees and outputs in chain_tmp, which phase 14 reads
    with tempfile.TemporaryDirectory() as chain_tmp:
        cli_tmp, kitti_tmp = os.path.join(chain_tmp, "3dmatch"), os.path.join(chain_tmp, "kitti")
        # 8. the CLI chain: trainval -> test -> eval on a fixture tree
        for name, count in zip(launches, cli_chain(ck, dev, mean_ms, cli_tmp)):
            launches[name] += count

        # 9. the LineMod encoder experiment: trainval_encoder -> test, its trees
        # and snapshots kept for phase 11
        kc = types.SimpleNamespace(check_embedding=check_embedding, check_sinkhorn=check_sinkhorn, emb_rows=emb_rows,
                                   bwd_rows=bwd_rows, roofline=roofline, embedding_work=embedding_work,
                                   peak_product=PEAK_F32_PRODUCT_FLOPS)
        with tempfile.TemporaryDirectory() as linemod_tmp:
            for name, count in zip(launches, linemod_chain(ck, dev, card, kc, linemod_tmp)):
                launches[name] += count

            # 10. the KITTI stage-5 experiment: trainval -> test -> eval, calibration
            for name, count in zip(launches, kitti_chain(ck, dev, card, kc, kitti_tmp)):
                launches[name] += count

            # 11. Cordi's DDPM on phase 9's encoder: train_cordi -> test --cordi_snapshot
            for name, count in zip(launches, cordi_chain(ck, dev, card, linemod_tmp)):
                launches[name] += count

            # 12. data parallelism: the 3DMatch trainer under a 1-rank NCCL group against
            # the plain path, 2 gloo ranks on the card, trainval_encoder --multihost
            for name, count in zip(launches, data_parallel_chain(ck, dev, card, linemod_tmp)):
                launches[name] += count

            # 13. the rest of the model surface: bf16 activations, the converter round
            # trip, the mean / dustbin / dropout variant, the LineMod correspondence dump
            for name, count in zip(launches, surface_chain(ck, dev, card, kc, linemod_tmp)):
                launches[name] += count

        # 14. the scripts and the host C++: native against the card's pyramid ops,
        # downsample_kitti, eval_dgr and the wrappers on phases 8 and 10's trees,
        # and the overfit probe in two regimes
        for name, count in zip(launches, scripts_chain(ck, dev, card, kc, cli_tmp, kitti_tmp)):
            launches[name] += count

    # 15. the radius-search kernel against its plain version on every pyramid's
    # searches, its times, and the pyramid and inference per pair in turns
    results["radius_search"], count = radius_chain(ck, dev, card)
    launches["radius_search"] += count
    # each kernel's largest error over every shape it was held at, phases 9 and 10 included
    results["geo_embedding"]["max_abs_err"] = max(r[1] for r in emb_rows)
    results["geo_embedding_bwd"]["max_abs_err"] = max(r[1] for r in bwd_rows)
    results["geo_embedding_bwd"]["max_rel_err"] = max(r[2] for r in bwd_rows)
    results["sinkhorn"]["max_abs_err"] = max(sinkhorn_errs)

    sources = {"geo_embedding": ("geo_embedding.cu", "ref_geotransformer_tpu/models/pallas_kernels.py:197"),
               "geo_embedding_bwd": ("geo_embedding_bwd.cu", "ref_geotransformer_tpu/models/pallas_kernels.py:318"),
               "sinkhorn": ("sinkhorn.cu", "ref_geotransformer_tpu/models/pallas_kernels.py:52"),
               "radius_search": ("radius_search.cu", "ref_geotransformer_tpu/ops/neighbors.py:72")}
    kernels = [{"name": name, "route": "cuda", "source": f"ref_geotransformer_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name], **results[name]}
               for name, (src, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
