"""KITTI training entry point.

    python -m ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5.trainval \
        [--max_epoch N] [--batch_size B] [--log_steps K] [--resume] [--device cuda] [--multihost]

Counterpart of `experiments/geotransformer_kitti_stage5/trainval.py` (ref
parity: experiments/geotransformer.kitti.../trainval.py): Adam +
StepLR(0.95 every 4 epochs) over 160 epochs, per-epoch snapshots, a
validation epoch after each, --resume. Reads the odometry tree under
REF_GT_KITTI_ROOT and writes snapshots, logs and events under
REF_GT_OUTPUT_ROOT (config.py).
"""

from ref_geotransformer_tpu_torch.engine.cli import maybe_initialize_multihost, run_trainval, trainval_parser
from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import config
from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5.dataset import train_valid_data_loader
from ref_geotransformer_tpu_torch.parallel.multihost import world


def main(argv=None):
    """Returns the trainer after its last epoch."""
    args = trainval_parser().parse_args(argv)
    maybe_initialize_multihost(args)
    cfg = config.make_cfg()
    # pairs per step and process: at least one per card (the JAX entry point's rule)
    batch_size = args.batch_size or max(cfg.train.batch_size, world()[1])
    train_loader, valid_loader = train_valid_data_loader(cfg, batch_size=batch_size)
    return run_trainval(cfg, train_loader, valid_loader, config.SNAPSHOT_DIR, config.LOG_DIR, args,
                        event_dir=config.EVENT_DIR)


if __name__ == "__main__":
    main()
