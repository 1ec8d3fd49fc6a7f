from ref_geotransformer_tpu_torch.engine.state import AdamWTrainState, TrainState, lr_at
from ref_geotransformer_tpu_torch.engine.steps import (
    ensure_pyramids,
    eval_batch,
    eval_step,
    forward,
    train_batch,
    train_step,
)
from ref_geotransformer_tpu_torch.engine.checkpoint import CheckpointManager
from ref_geotransformer_tpu_torch.engine.trainer import EpochBasedTrainer
from ref_geotransformer_tpu_torch.engine.tester import SingleTester
from ref_geotransformer_tpu_torch.engine.iter_trainer import (
    IterBasedDDPMTrainer,
    IterBasedEncoderTrainer,
    evaluate_ddpm,
    make_warmup_cosine_schedule,
)
