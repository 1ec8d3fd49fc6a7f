#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ref_geotransformer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi) and
     its largest SM clock (for the SFU's rate);
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a, one process per source);
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
  4. the inference path (pyramid + forward, 3DMatch stage-4 at published
     widths, bf16 backbone, seeded random weights) at demo and at full
     capacities: kernel launches of one forward, finite transform, ms/pair,
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
     over the warm steps, the host gap, the tester's pairs/s, peak memory.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

import contextlib
import json
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
# phase 10: the KITTI odometry fixture (pairs per sequence: 2 train
# sequences, 1 val, 1 test), scans sized like 0.3 m-downsampled ones
KITTI_PAIRS_PER_SEQUENCE, KITTI_POINTS, KITTI_RADIUS = 2, 20000, 40.0
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
PATH_FEATS_BOUND = 1e-3  # abs on the normalized coarse features, kernels vs plain, f32 path
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


def cli_chain(ck, dev, bare_ms):
    """Phase 8 on the card; returns the kernel launches of its train,
    validation and test passes."""
    import tempfile

    from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import config, fixture, test, trainval
    from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import eval as offline_eval

    exp = types.SimpleNamespace(config=config, trainval=trainval, test=test, eval=offline_eval)

    with tempfile.TemporaryDirectory() as tmp:
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


def linemod_chain(ck, dev, card, kc):
    """Phase 9 on the card; returns the kernel launches of its train,
    validation and test passes. `kc` holds main's kernel checks."""
    import math
    import re
    import tempfile
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
    keys = ("REF_GT_LINEMOD_ROOT", "REF_GT_MODELNET_ROOT", "REF_GT_OUTPUT_ROOT", "REF_GT_WARMUP", "REF_GT_LR")
    try:
        with tempfile.TemporaryDirectory() as tmp, scoped_env(
                keys, REF_GT_LINEMOD_ROOT=os.path.join(tmp, "bop"), REF_GT_MODELNET_ROOT=os.path.join(tmp, "modelnet"),
                REF_GT_OUTPUT_ROOT=os.path.join(tmp, "output"), REF_GT_WARMUP=str(LINEMOD_WARMUP)):
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
            feats_err = float((a["ref_feats_c"] - b["ref_feats_c"]).abs().max())
            print(f"[linemod:f32] {card}: forward, kernels vs plain: ref_feats_c {feats_err:.3e} "
                  f"(bound {PATH_FEATS_BOUND:.0e})")
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


def kitti_chain(ck, dev, card, kc):
    """Phase 10 on the card; returns the kernel launches of its train,
    validation and test passes. `kc` holds main's kernel checks."""
    import math
    import tempfile
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
    with tempfile.TemporaryDirectory() as tmp:
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
            feats_err = float((a["ref_feats_c"] - b["ref_feats_c"]).abs().max())
            print(f"[kitti:f32] {card}: forward, kernels vs plain: ref_feats_c {feats_err:.3e} "
                  f"(bound {PATH_FEATS_BOUND:.0e})")
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


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing was run")
    sys.path.insert(0, ROOT)
    import dataclasses
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
            if "registers" in line or "spill" in line:
                print("[build] " + line.strip())

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
    k, c = make_cfg().geotransformer.angle_k, make_cfg().geotransformer.hidden_dim
    # the embedding's products against the f32-accurate tensor-core rate; the
    # bound on the CUDA cores' f32 rate is printed beside it, not recorded
    works = {"geo_embedding": embedding_work(emb_rows[-1][0], k, c, backward=False),  # full caps, N = 1024
             "geo_embedding_bwd": embedding_work(bwd_rows[-1][0], k, c, backward=True)}
    n, _, ms, plain_ms = emb_rows[-1]
    bound_ms, bound_by = roofline(*works["geo_embedding"], PEAK_F32_PRODUCT_FLOPS)
    results["geo_embedding"] = {"max_abs_err": max(r[1] for r in emb_rows), "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
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
    launches = {"geo_embedding": 0, "geo_embedding_bwd": 0, "sinkhorn": 0}
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
        print(f"[path:{regime}] kernel launches in one forward: geo_embedding {counts[0]}, "
              f"geo_embedding_bwd {counts[1]}, sinkhorn {counts[2]}")
        check(counts == (2, 0, 1), f"{regime}: expected 2 geo_embedding, 0 backward and 1 sinkhorn launches, "
                                   f"got {counts}")
        for name, count in zip(launches, counts):
            launches[name] += count
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
    feats_err = float((a["ref_feats_c"] - b["ref_feats_c"]).abs().max())
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
    print(f"[path:f32] kernels vs plain: ref_feats_c {feats_err:.3e} (bound {PATH_FEATS_BOUND:.0e}); "
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

    # 8. the CLI chain: trainval -> test -> eval on a fixture tree
    for name, count in zip(launches, cli_chain(ck, dev, mean_ms)):
        launches[name] += count

    # 9. the LineMod encoder experiment: trainval_encoder -> test
    kc = types.SimpleNamespace(check_embedding=check_embedding, check_sinkhorn=check_sinkhorn, emb_rows=emb_rows,
                               bwd_rows=bwd_rows, roofline=roofline, embedding_work=embedding_work,
                               peak_product=PEAK_F32_PRODUCT_FLOPS)
    for name, count in zip(launches, linemod_chain(ck, dev, card, kc)):
        launches[name] += count

    # 10. the KITTI stage-5 experiment: trainval -> test -> eval, calibration
    for name, count in zip(launches, kitti_chain(ck, dev, card, kc)):
        launches[name] += count
    # each kernel's largest error over every shape it was held at, phases 9 and 10 included
    results["geo_embedding"]["max_abs_err"] = max(r[1] for r in emb_rows)
    results["geo_embedding_bwd"]["max_abs_err"] = max(r[1] for r in bwd_rows)
    results["geo_embedding_bwd"]["max_rel_err"] = max(r[2] for r in bwd_rows)
    results["sinkhorn"]["max_abs_err"] = max(sinkhorn_errs)

    sources = {"geo_embedding": ("geo_embedding.cu", "ref_geotransformer_tpu/models/pallas_kernels.py:197"),
               "geo_embedding_bwd": ("geo_embedding_bwd.cu", "ref_geotransformer_tpu/models/pallas_kernels.py:318"),
               "sinkhorn": ("sinkhorn.cu", "ref_geotransformer_tpu/models/pallas_kernels.py:52")}
    kernels = [{"name": name, "route": "cuda", "source": f"ref_geotransformer_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name], **results[name]}
               for name, (src, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
