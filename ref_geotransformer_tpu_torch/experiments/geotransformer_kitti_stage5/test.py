"""KITTI test: run the model over the test sequences (08-10) and dump
per-pair .npz files for offline eval.

    python -m ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5.test \
        --snapshot epoch-160 [--device cuda]

Counterpart of `experiments/geotransformer_kitti_stage5/test.py`: the online
evaluator applies the RR criterion RRE < 5 deg and RTE < 2 m
(`cfg.eval.recall_criterion="rre_rte"`); the dumps carry the full key set
of the reference's test.py:65-80, so eval.py scores coarse matching too.
"""

import argparse

from ref_geotransformer_tpu_torch.engine.cli import run_test
from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import config
from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5.dataset import test_data_loader
from ref_geotransformer_tpu_torch.utils.common import ensure_dir
from ref_geotransformer_tpu_torch.utils.feature_dump import dump_registration_npz


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--snapshot", required=True, help="epoch snapshot name (e.g. epoch-160)")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the test summary (means of the online metrics)."""
    args = parse_args(argv)
    cfg = config.make_cfg()
    feature_dir = config.FEATURE_DIR
    ensure_dir(feature_dir)

    def after_test_step(i, data, meta, output):
        dump_registration_npz(feature_dir, data, meta, output)

    summary = run_test(cfg, test_data_loader(cfg), config.SNAPSHOT_DIR, args.snapshot, config.LOG_DIR,
                       after_test_step=after_test_step, log_name="test", device=args.device)
    print({k: round(v, 4) for k, v in summary.items()})
    return summary


if __name__ == "__main__":
    main()
