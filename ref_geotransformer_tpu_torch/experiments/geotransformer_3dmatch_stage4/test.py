"""3DMatch/3DLoMatch test: run the model over the benchmark split and dump
per-pair .npz feature/correspondence files for offline eval.

    python -m ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4.test \
        --snapshot epoch-40 [--benchmark 3DMatch|3DLoMatch|val] [--rotated] [--device cuda]

Counterpart of `experiments/geotransformer_3dmatch_stage4/test.py` (ref
parity: experiments/geotransformer.3dmatch.../test.py:65-102; eval.py
consumes the dumps). Padded slots are stripped before dumping, so the .npz
contents look like the reference's.
"""

import argparse
import os.path as osp

from ref_geotransformer_tpu_torch.engine.cli import run_test
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import config
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4.dataset import test_data_loader
from ref_geotransformer_tpu_torch.utils.common import ensure_dir
from ref_geotransformer_tpu_torch.utils.feature_dump import dump_registration_npz


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--benchmark", choices=["3DMatch", "3DLoMatch", "val"], default="3DMatch")
    parser.add_argument("--snapshot", required=True, help="epoch snapshot name (e.g. epoch-40)")
    parser.add_argument("--rotated", action="store_true", help="rotated benchmark variant (dataset.py:114-122)")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the test summary (means of the online metrics)."""
    args = parse_args(argv)
    cfg = config.make_cfg()
    feature_dir = osp.join(config.FEATURE_DIR, args.benchmark)
    ensure_dir(feature_dir)

    def after_test_step(i, data, meta, output):
        dump_registration_npz(feature_dir, data, meta, output)

    summary = run_test(cfg, test_data_loader(cfg, args.benchmark, rotated=args.rotated), config.SNAPSHOT_DIR,
                       args.snapshot, config.LOG_DIR, after_test_step=after_test_step,
                       log_name=f"test-{args.benchmark}", device=args.device)
    print({k: round(v, 4) for k, v in summary.items()})
    return summary


if __name__ == "__main__":
    main()
