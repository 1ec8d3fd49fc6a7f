"""Phase-1 training: the GeoTransformer encoder on LineMod, iteration-based.

    python -m ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4.trainval_encoder \
        [--max_iteration N] [--snapshot_steps S] [--use_modelnet] [--log_steps K] \
        [--resume] [--device cuda] [--multihost]

Counterpart of `experiments/geotransformer_modelnet_rpmnet_stage4/
trainval_encoder.py` (ref parity: experiments/geotransformer.modelnet.../
trainval_encoder.py:21-67): AdamW under the warmup-cosine schedule (10k
warmup over 100k iterations), the `iter-N` model file, the rolling snapshot
and a validation truncated to 100 batches every `snapshot_steps`,
--resume. Reads LineMod under REF_GT_LINEMOD_ROOT (ModelNet under
REF_GT_MODELNET_ROOT with --use_modelnet) and writes snapshots and logs
under REF_GT_OUTPUT_ROOT (config.py). Under --multihost (or torchrun) each
process trains its own replica on its loader shard, and rank 0 writes the
log and the snapshots, as the JAX entry point does.
"""

import os.path as osp

from ref_geotransformer_tpu_torch.demo import build_model
from ref_geotransformer_tpu_torch.engine.cli import (
    apply_loader_sharding,
    iter_trainval_parser,
    maybe_initialize_multihost,
)
from ref_geotransformer_tpu_torch.engine.iter_trainer import IterBasedEncoderTrainer, make_warmup_cosine_schedule
from ref_geotransformer_tpu_torch.engine.state import AdamWTrainState
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import config
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4.dataset import (
    train_valid_data_loader,
)
from ref_geotransformer_tpu_torch.utils.common import ensure_dir


def main(argv=None):
    """Returns the trainer after its last iteration."""
    args = iter_trainval_parser().parse_args(argv)
    device = maybe_initialize_multihost(args)
    cfg = config.make_cfg()
    snapshot_dir, log_dir = config.SNAPSHOT_ENCODER_DIR, config.LOG_DIR
    ensure_dir(snapshot_dir)
    ensure_dir(log_dir)

    max_iteration = args.max_iteration or cfg.optim.max_iteration
    train_loader, valid_loader = train_valid_data_loader(cfg, batch_size=args.batch_size or 1,
                                                         use_modelnet=args.use_modelnet)
    apply_loader_sharding(train_loader, valid_loader)
    model = build_model(cfg, device, seed=cfg.seed)
    optim = cfg.optim
    schedule = make_warmup_cosine_schedule(optim.lr, max_iteration, optim.warmup_steps, optim.eta_init,
                                           optim.eta_min)
    trainer = IterBasedEncoderTrainer(
        cfg,
        model,
        AdamWTrainState(model, optim, schedule),
        train_loader,
        valid_loader,
        max_iteration=max_iteration,
        snapshot_steps=args.snapshot_steps or optim.snapshot_steps,
        snapshot_dir=snapshot_dir,
        log_file=osp.join(log_dir, "train_encoder.log"),
        log_steps=args.log_steps,
        seed=cfg.seed,
    )
    trainer.run(resume=args.resume)
    return trainer


if __name__ == "__main__":
    main()
