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
     ms/step and peak memory.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
TIMED_ITERS = 10
TRAIN_STEPS = 3
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
    print(smi.stdout.strip().splitlines()[0])
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
    emb_rows, bwd_rows = [], []

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
