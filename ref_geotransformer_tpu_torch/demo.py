"""Register the demo pair with the PyTorch port.

    python -m ref_geotransformer_tpu_torch.demo [--full] [--iters N] [--device cuda]
        [--ref_file F] [--src_file F] [--gt_file F] [--snapshot epoch-N.pth.tar] [--dump out.npz]

Loads a pair (default data/demo/{ref,src,gt}.npy), builds the point pyramid
and runs the forward on the device, and prints the estimated transform,
RRE/RTE against the ground truth and the steady-state time per pair. The
counterpart of experiments/geotransformer_3dmatch_stage4/demo.py. Without
--snapshot (an epoch snapshot the port's trainer wrote) the weights are
random (seeded): no trained checkpoint ships with the repository, so RRE/RTE
are then meaningless; the run shows that the pipeline works end to end.
--dump writes the estimated transform and the correspondences to a .npz,
and beside it the clouds before and after registration as PLY files
(<prefix>_ref.ply, _src.ply, _src_aligned.ply), as the JAX demo does.
--snapshot also takes a file that utils/convert_checkpoint.py converted from
an upstream checkpoint.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ref_geotransformer_tpu_torch.config import GeoTransformerConfig
from ref_geotransformer_tpu_torch.config.threedmatch import make_cfg
from ref_geotransformer_tpu_torch.data import build_registration_inputs, pad_points
from ref_geotransformer_tpu_torch.engine.checkpoint import load_model_file
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.ops.metrics import isotropic_transform_error
from ref_geotransformer_tpu_torch.utils.visualization import dump_registration_ply
from ref_geotransformer_tpu_torch.utils.weights import init_parameters

DEMO_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "demo")


def load_pair(cfg: GeoTransformerConfig, device: torch.device, ref_file: Optional[str] = None,
              src_file: Optional[str] = None, gt_file: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A pair of .npy clouds (default: the demo pair) padded to the level-0
    capacity, with its ground-truth transform, on `device`."""
    files = {"ref": ref_file or os.path.join(DEMO_DIR, "ref.npy"), "src": src_file or os.path.join(DEMO_DIR, "src.npy")}
    cap0 = cfg.capacities.points[0]
    pair = {}
    for name, path in files.items():
        points, masks = pad_points(np.load(path).astype(np.float32), cap0)
        pair[f"{name}_points"] = torch.from_numpy(points).to(device)
        pair[f"{name}_masks"] = torch.from_numpy(masks).to(device)
    gt = np.load(gt_file or os.path.join(DEMO_DIR, "gt.npy")).astype(np.float32)
    pair["transform"] = torch.from_numpy(gt).to(device)
    return pair


def build_model(cfg: GeoTransformerConfig, device: torch.device, seed: int = 0, use_kernels: bool = True,
                snapshot: Optional[str] = None):
    """GeoTransformer on `device`: the weights of `snapshot` (an epoch-N.pth.tar
    file), or random ones from a seeded generator."""
    model = init_parameters(GeoTransformer(cfg, use_kernels=use_kernels), torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    return model if snapshot is None else load_model_file(snapshot, model)


def register(model: GeoTransformer, cfg: GeoTransformerConfig, pair: Dict[str, torch.Tensor]) -> Dict:
    """Pyramid + forward for one pair: the main inference path."""
    bb, caps = cfg.backbone, cfg.capacities
    data = build_registration_inputs(
        pair["ref_points"], pair["ref_masks"], pair["src_points"], pair["src_masks"],
        bb.num_stages, bb.init_voxel_size, bb.init_radius, caps.neighbor_limits, caps.points,
        search_chunk=caps.search_chunk,
    )
    return model(data)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--full", action="store_true", help="full 3DMatch capacities (default: demo capacities)")
    parser.add_argument("--iters", type=int, default=1, help="timed iterations")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    parser.add_argument("--ref_file", default=None, help="reference cloud .npy (default: data/demo/ref.npy)")
    parser.add_argument("--src_file", default=None, help="source cloud .npy (default: data/demo/src.npy)")
    parser.add_argument("--gt_file", default=None, help="ground-truth 4x4 transform .npy (default: data/demo/gt.npy)")
    parser.add_argument("--snapshot", default=None, help="epoch snapshot (epoch-N.pth.tar) to load")
    parser.add_argument("--dump", default=None, help="dump the outputs to this .npz")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_cfg(demo=not args.full)
    pair = load_pair(cfg, device, args.ref_file, args.src_file, args.gt_file)
    model = build_model(cfg, device, snapshot=args.snapshot)
    if args.snapshot:
        print(f"loaded snapshot {args.snapshot}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    out = register(model, cfg, pair)
    sync()
    print(f"first pair: {time.perf_counter() - t0:.2f} s (includes building the kernels on first use)")
    if args.iters > 0:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = register(model, cfg, pair)
        sync()
        dt = (time.perf_counter() - t0) / args.iters
        print(f"steady state: {dt * 1e3:.2f} ms/pair ({1.0 / dt:.2f} pairs/s) on {device}")
    est = out["estimated_transform"]
    rre, rte = isotropic_transform_error(pair["transform"], est)
    print("estimated transform:\n", est.cpu().numpy())
    print("gt transform:\n", pair["transform"].cpu().numpy())
    weights = args.snapshot or "random weights: not a quality figure"
    print(f"RRE {float(rre):.3f} deg, RTE {float(rte):.4f} m ({weights})")
    if args.dump:
        np.savez_compressed(args.dump, **{key: out[key].cpu().numpy() for key in (
            "estimated_transform", "ref_corr_points", "src_corr_points", "corr_scores")})
        prefix = args.dump[:-4] if args.dump.endswith(".npz") else args.dump
        raw = [pair[f"{side}_points"][pair[f"{side}_masks"]].cpu().numpy() for side in ("ref", "src")]
        dump_registration_ply(prefix, *raw, est.cpu().numpy())
        print(f"dumped outputs to {args.dump} (+ {prefix}_*.ply)")


if __name__ == "__main__":
    main()
