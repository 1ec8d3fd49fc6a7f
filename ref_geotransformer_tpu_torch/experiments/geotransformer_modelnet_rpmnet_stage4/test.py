"""LineMod/ModelNet test: the encoder's RRE, RTE and RR (RRE < 1 deg and
RTE < 0.1) over the test pairs, and optionally Cordi's sampling metrics.

    python -m ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4.test \
        --snapshot iter-N [--cordi_snapshot iter-M] [--num_pairs P] [--use_modelnet] [--device cuda]

Counterpart of `experiments/geotransformer_modelnet_rpmnet_stage4/test.py`
(ref parity: experiments/geotransformer.modelnet.../test.py and the DDPM
validation of engine/iter_based_trainer.py:284-320): per pair the inference
forward, then `evaluate` with the experiment's `recall_criterion="rre_rte"`;
prints the means. `--snapshot` names an `iter-N` file of the encoder
snapshots (SNAPSHOT_ENCODER_DIR). With `--cordi_snapshot` (an `iter-M` file
of SNAPSHOT_DDPM_DIR, Cordi at `config.DDPM`) each pair's forward is also
downsampled and sampled by reverse diffusion from its initial matrix, at
draws from one generator seeded 123; `evaluate_ddpm` adds ddpm_PIR,
ddpm_PIR_0.5, ddpm_PIR_0.25 and ddpm_IIR.
"""

import argparse
import itertools

import torch

from ref_geotransformer_tpu_torch.engine.checkpoint import CheckpointManager
from ref_geotransformer_tpu_torch.engine.iter_trainer import GeneratorDraws, ddpm_metrics, sample_pair
from ref_geotransformer_tpu_torch.engine.steps import forward, to_device
from ref_geotransformer_tpu_torch.engine.trainer import to_floats
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import config
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4.dataset import test_data_loader
from ref_geotransformer_tpu_torch.models.cordi import Cordi, cordi_downsample
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.models.losses import evaluate
from ref_geotransformer_tpu_torch.utils.summary_board import SummaryBoard


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--snapshot", required=True, help="encoder snapshot (e.g. iter-100000)")
    parser.add_argument("--cordi_snapshot", default=None, help="cordi snapshot to also evaluate")
    parser.add_argument("--use_modelnet", action="store_true")
    parser.add_argument("--num_pairs", type=int, default=None, help="cap evaluated pairs")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the summary (means of the per-pair metrics)."""
    args = parse_args(argv)
    cfg = config.make_cfg()
    device = torch.device(args.device)
    model = GeoTransformer(cfg).to(device)
    CheckpointManager(config.SNAPSHOT_ENCODER_DIR).load_model(args.snapshot, model)
    cordi = None
    if args.cordi_snapshot:
        cordi = Cordi.from_config(config.DDPM).to(device)
        CheckpointManager(config.SNAPSHOT_DDPM_DIR).load_model(args.cordi_snapshot, cordi)
        draws = GeneratorDraws(torch.Generator(device=device).manual_seed(123))

    board = SummaryBoard(adaptive=True)
    pairs = test_data_loader(cfg, use_modelnet=args.use_modelnet).iter_single()
    if args.num_pairs:
        pairs = itertools.islice(pairs, args.num_pairs)
    for data, _ in pairs:
        pair = to_device(data, device)
        output = forward(model, cfg, pair)
        board.update_from_result_dict(to_floats(evaluate(output, pair["transform"], cfg.eval)))
        if cordi is not None:
            d = cordi_downsample(output, cordi.ref_sample_num, cordi.src_sample_num, *draws.node_keys(output))
            metrics = ddpm_metrics(sample_pair(cordi, d, draws), d)
            board.update_from_result_dict({f"ddpm_{k}": v for k, v in metrics.items()})
    summary = board.summary()
    print({k: round(v, 4) for k, v in summary.items()})
    return summary


if __name__ == "__main__":
    main()
