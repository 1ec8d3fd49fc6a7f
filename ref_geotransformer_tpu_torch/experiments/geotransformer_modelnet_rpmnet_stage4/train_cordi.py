"""Phase-2 training: Cordi's DDPM over the frozen encoder, iteration-based.

    python -m ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4.train_cordi \
        [--encoder_snapshot iter-N] [--max_iteration N] [--snapshot_steps S] [--use_modelnet] \
        [--log_steps K] [--resume] [--device cuda] [--multihost]

Counterpart of `experiments/geotransformer_modelnet_rpmnet_stage4/
train_cordi.py` (ref parity: experiments/geotransformer.modelnet.../
train_cordi.py:22-74): the encoder from an `iter-N` file of the encoder
snapshots (seeded random weights without one), frozen; Cordi at `config.DDPM`
from seeded random weights, trained with AdamW under the warmup-cosine
schedule; per iteration the encoder's forward on DDPM.batch_size pairs and
one epsilon-loss step; every `snapshot_steps` the `iter-N` file, the rolling
snapshot (SNAPSHOT_DDPM_DIR) and a validation by reverse diffusion (PIR at
top 32/16/8, IIR); --resume. Paths and environment overrides as in
`trainval_encoder` (config.py); REF_GT_DDPM_STEPS shortens the chain. Under
--multihost (or torchrun) each process trains its own replica on its loader
shard, and rank 0 writes the log and the snapshots, as the JAX entry point does.
"""

import os.path as osp

import torch

from ref_geotransformer_tpu_torch.demo import build_model
from ref_geotransformer_tpu_torch.engine.checkpoint import CheckpointManager
from ref_geotransformer_tpu_torch.engine.cli import (
    apply_loader_sharding,
    iter_trainval_parser,
    maybe_initialize_multihost,
)
from ref_geotransformer_tpu_torch.engine.iter_trainer import IterBasedDDPMTrainer, make_warmup_cosine_schedule
from ref_geotransformer_tpu_torch.engine.state import AdamWTrainState
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import config
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4.dataset import (
    train_valid_data_loader,
)
from ref_geotransformer_tpu_torch.models.cordi import Cordi
from ref_geotransformer_tpu_torch.utils.common import ensure_dir
from ref_geotransformer_tpu_torch.utils.weights import init_parameters


def build_cordi(ddpm, device: torch.device, seed: int) -> Cordi:
    """Cordi at the `DDPMConfig` `ddpm`, seeded random weights, on `device`."""
    return init_parameters(Cordi.from_config(ddpm), torch.Generator().manual_seed(seed)).to(device)


def main(argv=None):
    """Returns the trainer after its last iteration."""
    parser = iter_trainval_parser()
    parser.add_argument("--encoder_snapshot", default=None, help="encoder snapshot name (e.g. iter-100000)")
    args = parser.parse_args(argv)
    device = maybe_initialize_multihost(args)
    cfg = config.make_cfg()
    ddpm = config.DDPM
    snapshot_dir, log_dir = config.SNAPSHOT_DDPM_DIR, config.LOG_DIR
    ensure_dir(snapshot_dir)
    ensure_dir(log_dir)

    max_iteration = args.max_iteration or cfg.optim.max_iteration
    train_loader, valid_loader = train_valid_data_loader(cfg, batch_size=1, use_modelnet=args.use_modelnet)
    apply_loader_sharding(train_loader, valid_loader)
    encoder = build_model(cfg, device, seed=cfg.seed)
    if args.encoder_snapshot:
        CheckpointManager(config.SNAPSHOT_ENCODER_DIR).load_model(args.encoder_snapshot, encoder)
        print(f"loaded encoder snapshot {args.encoder_snapshot}")
    cordi = build_cordi(ddpm, device, cfg.seed + 1)
    optim = cfg.optim
    schedule = make_warmup_cosine_schedule(optim.lr, max_iteration, optim.warmup_steps, optim.eta_init,
                                           optim.eta_min)
    trainer = IterBasedDDPMTrainer(
        cfg,
        encoder,
        cordi,
        AdamWTrainState(cordi, optim, schedule),
        train_loader,
        valid_loader,
        max_iteration=max_iteration,
        snapshot_steps=args.snapshot_steps or optim.snapshot_steps,
        ddpm_batch_size=ddpm.batch_size,
        snapshot_dir=snapshot_dir,
        log_file=osp.join(log_dir, "train_cordi.log"),
        log_steps=args.log_steps,
        seed=cfg.seed,
    )
    trainer.run(resume=args.resume)
    return trainer


if __name__ == "__main__":
    main()
