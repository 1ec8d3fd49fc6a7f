"""Per-epoch feature-directory evaluation sweep.

    python -m ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4.eval_dgr \
        [--benchmark 3DMatch|3DLoMatch|val] [--method lgr|svd|ransac] [--epochs 20 40] [--num_corr K]

Counterpart of `experiments/geotransformer_3dmatch_stage4/eval_dgr.py`: runs
the offline evaluation (`eval.eval_one_epoch`) over `FEATURE_DIR/<benchmark>-
epoch-N` for each N of the inclusive `--epochs` range that exists, prints
each epoch's summary and reports the epoch of the best RR. `test.py` writes
its dumps to `FEATURE_DIR/<benchmark>`, as the JAX package's does: move
them to the per-epoch directory after each test.
"""

import argparse
import os.path as osp
from types import SimpleNamespace

from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import config
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4.eval import eval_one_epoch


def main(argv=None):
    """Returns (best epoch, its summary), or None when no epoch directory exists."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--benchmark", choices=["3DMatch", "3DLoMatch", "val"], default="3DMatch")
    parser.add_argument("--method", choices=["lgr", "svd", "ransac"], default="lgr")
    parser.add_argument("--epochs", type=int, nargs=2, default=[20, 40], help="inclusive epoch range")
    parser.add_argument("--num_corr", type=int, default=None)
    args = parser.parse_args(argv)
    cfg = config.make_cfg()

    best = None
    for epoch in range(args.epochs[0], args.epochs[1] + 1):
        feature_dir = osp.join(config.FEATURE_DIR, f"{args.benchmark}-epoch-{epoch}")
        if not osp.isdir(feature_dir):
            continue
        sub_args = SimpleNamespace(
            benchmark=args.benchmark, feature_dir=feature_dir, method=args.method,
            num_corr=args.num_corr, verbose=False,
        )
        summary = eval_one_epoch(sub_args, cfg)
        # the summary's "scenes" entry is a dict of per-scene results: print the scalars
        print(f"epoch {epoch}: " + str({k: round(v, 4) for k, v in summary.items() if k != "scenes"}))
        if best is None or summary["RR"] > best[1]["RR"]:
            best = (epoch, summary)
    if best is not None:
        print(f"best epoch {best[0]}: RR {best[1]['RR']:.4f}")
    else:
        print("no per-epoch feature dirs found; run test.py with --snapshot epoch-N first")
    return best


if __name__ == "__main__":
    main()
