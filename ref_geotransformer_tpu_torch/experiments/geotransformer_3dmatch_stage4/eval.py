"""Offline 3DMatch/3DLoMatch evaluation over test.py's .npz dumps (numpy).

    python -m ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4.eval \
        [--benchmark 3DMatch|3DLoMatch|val] [--method lgr|svd|ransac] [--num_corr K]

Counterpart of `experiments/geotransformer_3dmatch_stage4/eval.py` (ref
parity: experiments/geotransformer.3dmatch.../eval.py:41-365): per-pair
coarse (PIR) and fine (IR/FMR) metrics, transform estimation by method
(lgr = stored transform | svd = numpy weighted Procrustes | ransac = numpy
correspondence RANSAC), scene-level registration recall via the redwood
gt.log/gt.info covariance error.
"""

import argparse
import glob
import os.path as osp

import numpy as np

from ref_geotransformer_tpu_torch.data.benchmark_3dmatch import (
    evaluate_registration_one_scene,
    get_num_fragments,
    get_scene_abbr,
    write_log_file,
)
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import config
from ref_geotransformer_tpu_torch.utils.common import ensure_dir
from ref_geotransformer_tpu_torch.utils.registration import (
    evaluate_correspondences,
    evaluate_sparse_correspondences,
    ransac_registration_np,
    weighted_procrustes_np,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--benchmark", choices=["3DMatch", "3DLoMatch", "val"], default="3DMatch")
    parser.add_argument("--method", choices=["lgr", "svd", "ransac"], default="lgr")
    parser.add_argument("--num_corr", type=int, default=None, help="top-k correspondences to keep")
    parser.add_argument("--feature_dir", default=None, help="override feature dir (default FEATURE_DIR/<benchmark>)")
    parser.add_argument("--verbose", action="store_true")
    return parser.parse_args(argv)


def eval_one_epoch(args, cfg):
    """Scene-wise evaluation protocol (reference eval.py:41-365): per-pair
    coarse PIR + fine IR/OV/residual, scene-level PMR buckets and means,
    covariance-based registration recall with mean/median RRE/RTE; global
    numbers are means over scenes (the paper's table protocol)."""
    feature_dir = getattr(args, "feature_dir", None) or osp.join(config.FEATURE_DIR, args.benchmark)
    benchmark_dir = osp.join(config.DATASET_ROOT, "metadata", "benchmarks", args.benchmark)

    scene_pairs = {}
    file_names = sorted(glob.glob(osp.join(feature_dir, "*.npz")))
    for file_name in file_names:
        base = osp.basename(file_name)[: -len(".npz")]
        scene_name, ref_id, src_id = base.rsplit("_", 2)
        scene_pairs.setdefault(scene_name, []).append((int(ref_id), int(src_id), file_name))

    scene_coarse, scene_fine, scene_reg = {}, {}, {}
    for scene_name in sorted(scene_pairs):
        precisions, irs, overlaps, fmrs = [], [], [], []
        est_logs = []
        for ref_id, src_id, file_name in sorted(scene_pairs[scene_name]):
            data = np.load(file_name)

            coarse = evaluate_sparse_correspondences(
                data["ref_points_c"],
                data["src_points_c"],
                data["ref_node_corr_indices"],
                data["src_node_corr_indices"],
                data["gt_node_corr_overlaps"],
            )
            precisions.append(coarse["PIR"])

            ref_corr = data["ref_corr_points"]
            src_corr = data["src_corr_points"]
            scores = data["corr_scores"]
            if args.num_corr is not None and ref_corr.shape[0] > args.num_corr:
                sel = np.argsort(-scores)[: args.num_corr]
                ref_corr, src_corr, scores = ref_corr[sel], src_corr[sel], scores[sel]
            transform = data["transform"]
            fine = evaluate_correspondences(
                ref_corr, src_corr, transform, positive_radius=cfg.eval.acceptance_radius
            )
            irs.append(fine["IR"])
            overlaps.append(fine["overlap"])
            fmrs.append(float(fine["IR"] >= cfg.eval.inlier_ratio_threshold))
            if args.verbose:
                print(
                    f"{get_scene_abbr(scene_name)}, id0: {ref_id}, id1: {src_id}"
                    f", c_PIR: {coarse['PIR']:.3f}, f_IR: {fine['IR']:.3f}"
                    f", f_OV: {fine['overlap']:.3f}, f_RS: {fine['residual']:.3f}"
                    f", f_NU: {fine['num_corr']}"
                )

            if args.method == "lgr":
                est = data["estimated_transform"]
            elif args.method == "svd":
                est = weighted_procrustes_np(src_corr, ref_corr, scores)
            else:
                est = ransac_registration_np(
                    ref_corr,
                    src_corr,
                    distance_threshold=cfg.ransac.distance_threshold,
                    num_points=cfg.ransac.num_points,
                    num_iterations=cfg.ransac.num_iterations,
                )
            est_logs.append(
                {
                    "test_pair": [ref_id, src_id],
                    "num_fragments": get_num_fragments(
                        scene_name, osp.join(benchmark_dir, scene_name, "gt.log")
                    ),
                    "transform": est,
                }
            )

        precisions = np.asarray(precisions)
        scene_coarse[scene_name] = {
            "PIR": float(np.mean(precisions)),
            "PMR>0": float(np.mean(precisions > 0)),
            "PMR>=0.1": float(np.mean(precisions >= 0.1)),
            "PMR>=0.3": float(np.mean(precisions >= 0.3)),
            "PMR>=0.5": float(np.mean(precisions >= 0.5)),
        }
        scene_fine[scene_name] = {
            "FMR": float(np.mean(fmrs)),
            "IR": float(np.mean(irs)),
            "OV": float(np.mean(overlaps)),
        }

        est_log_dir = osp.join(config.REGISTRATION_DIR, args.benchmark, args.method, scene_name)
        ensure_dir(est_log_dir)
        result_file = osp.join(est_log_dir, "est.log")
        write_log_file(result_file, est_logs)
        result = evaluate_registration_one_scene(
            osp.join(benchmark_dir, scene_name, "gt.log"),
            osp.join(benchmark_dir, scene_name, "gt.info"),
            result_file,
            positive_threshold=cfg.eval.rmse_threshold,
        )
        scene_reg[scene_name] = {
            "RR": result["recall"],
            "mean_rre": result["mean_rre"],
            "mean_rte": result["mean_rte"],
            "median_rre": result["median_rre"],
            "median_rte": result["median_rte"],
        }
        if args.verbose:
            print(
                f"{get_scene_abbr(scene_name)}: "
                + ", ".join(f"{k}: {v:.4f}" for k, v in scene_coarse[scene_name].items())
                + ", "
                + ", ".join(f"{k}: {v:.4f}" for k, v in scene_fine[scene_name].items())
                + ", "
                + ", ".join(f"{k}: {v:.4f}" for k, v in scene_reg[scene_name].items())
            )

    def scene_mean(per_scene, key):
        return float(np.mean([v[key] for v in per_scene.values()])) if per_scene else 0.0

    def scene_std(per_scene, key):
        return float(np.std([v[key] for v in per_scene.values()])) if per_scene else 0.0

    summary = {
        "PIR": scene_mean(scene_coarse, "PIR"),
        "PMR>0": scene_mean(scene_coarse, "PMR>0"),
        "PMR>=0.1": scene_mean(scene_coarse, "PMR>=0.1"),
        "PMR>=0.3": scene_mean(scene_coarse, "PMR>=0.3"),
        "PMR>=0.5": scene_mean(scene_coarse, "PMR>=0.5"),
        "IR": scene_mean(scene_fine, "IR"),
        "OV": scene_mean(scene_fine, "OV"),
        "FMR": scene_mean(scene_fine, "FMR"),
        "FMR_std": scene_std(scene_fine, "FMR"),
        "RR": scene_mean(scene_reg, "RR"),
        "mean_rre": scene_mean(scene_reg, "mean_rre"),
        "mean_rte": scene_mean(scene_reg, "mean_rte"),
        "median_rre": scene_mean(scene_reg, "median_rre"),
        "median_rte": scene_mean(scene_reg, "median_rte"),
    }
    summary["scenes"] = {
        get_scene_abbr(s): {**scene_coarse[s], **scene_fine[s], **scene_reg[s]}
        for s in scene_coarse
    }
    return summary


def main(argv=None):
    """Returns the summary (scene means, and "scenes": per-scene results)."""
    args = parse_args(argv)
    summary = eval_one_epoch(args, config.make_cfg())
    print({k: round(v, 4) for k, v in summary.items() if k != "scenes"})
    for abbr, result in summary["scenes"].items():
        print(f"  {abbr}: " + ", ".join(f"{k}: {v:.4f}" for k, v in result.items()))
    return summary


if __name__ == "__main__":
    main()
