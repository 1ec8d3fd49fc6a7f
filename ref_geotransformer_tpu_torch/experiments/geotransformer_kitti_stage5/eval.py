"""Offline KITTI evaluation over test.py's .npz dumps (numpy).

    python -m ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5.eval \
        [--method lgr|svd|ransac] [--num_corr K] [--feature_dir DIR] [--verbose]

Counterpart of `experiments/geotransformer_kitti_stage5/eval.py` (ref
parity: experiments/geotransformer.kitti.../eval.py:35-180): coarse matching
(PIR and PMR > 0 / >= 0.1 / >= 0.3 / >= 0.5), fine matching (FMR +- std, IR,
OV), registration (RR at RRE < 5 deg and RTE < 2 m; mean RRE / RTE over the
accepted pairs) with the transform by method (lgr = the stored one | svd =
numpy weighted Procrustes | ransac = numpy correspondence RANSAC). Means
are over pairs.
"""

import argparse
import glob
import os.path as osp

import numpy as np

from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import config
from ref_geotransformer_tpu_torch.utils.registration import (
    compute_registration_error,
    evaluate_correspondences,
    evaluate_sparse_correspondences,
    ransac_registration_np,
    weighted_procrustes_np,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--method", choices=["lgr", "svd", "ransac"], default="lgr")
    parser.add_argument("--num_corr", type=int, default=None, help="top-k correspondences to keep")
    parser.add_argument("--feature_dir", default=None, help="override feature dir (default FEATURE_DIR)")
    parser.add_argument("--verbose", action="store_true")
    return parser.parse_args(argv)


def eval_one_epoch(args, cfg):
    feature_dir = args.feature_dir or config.FEATURE_DIR
    precisions, irs, overlaps, fmrs = [], [], [], []
    recalls, rres, rtes = [], [], []
    for file_name in sorted(glob.glob(osp.join(feature_dir, "*.npz"))):
        data = np.load(file_name)

        coarse = evaluate_sparse_correspondences(
            data["ref_points_c"],
            data["src_points_c"],
            data["ref_node_corr_indices"],
            data["src_node_corr_indices"],
            data["gt_node_corr_overlaps"],
        )
        precisions.append(coarse["PIR"])

        ref_corr, src_corr, scores = data["ref_corr_points"], data["src_corr_points"], data["corr_scores"]
        if args.num_corr is not None and ref_corr.shape[0] > args.num_corr:
            sel = np.argsort(-scores)[: args.num_corr]
            ref_corr, src_corr, scores = ref_corr[sel], src_corr[sel], scores[sel]
        transform = data["transform"]

        fine = evaluate_correspondences(ref_corr, src_corr, transform, positive_radius=cfg.eval.acceptance_radius)
        irs.append(fine["IR"])
        overlaps.append(fine["overlap"])
        fmrs.append(float(fine["IR"] >= cfg.eval.inlier_ratio_threshold))

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
        rre, rte = compute_registration_error(transform, est)
        accepted = rre < cfg.eval.rre_threshold and rte < cfg.eval.rte_threshold
        recalls.append(float(accepted))
        if accepted:
            rres.append(rre)
            rtes.append(rte)
        if args.verbose:
            print(
                f"{osp.basename(file_name)[:-4]}: c_PIR: {coarse['PIR']:.3f}"
                f", f_IR: {fine['IR']:.3f}, f_OV: {fine['overlap']:.3f}"
                f", f_RS: {fine['residual']:.3f}, f_NU: {fine['num_corr']}"
                f", r_RRE: {rre:.3f}, r_RTE: {rte:.3f}"
            )

    def mean(values):
        return float(np.mean(values)) if len(values) else 0.0

    precisions = np.asarray(precisions)
    return {
        "PIR": mean(precisions),
        "PMR>0": mean(precisions > 0),
        "PMR>=0.1": mean(precisions >= 0.1),
        "PMR>=0.3": mean(precisions >= 0.3),
        "PMR>=0.5": mean(precisions >= 0.5),
        "FMR": mean(fmrs),
        "FMR_std": float(np.std(fmrs)) if fmrs else 0.0,
        "IR": mean(irs),
        "OV": mean(overlaps),
        "RR": mean(recalls),
        "RRE": mean(rres),
        "RTE": mean(rtes),
    }


def main(argv=None):
    """Returns the summary."""
    args = parse_args(argv)
    summary = eval_one_epoch(args, config.make_cfg())
    print({k: round(v, 4) for k, v in summary.items()})
    return summary


if __name__ == "__main__":
    main()
