from ref_geotransformer_tpu_torch.engine.state import TrainState, lr_at
from ref_geotransformer_tpu_torch.engine.steps import ensure_pyramids, eval_step, train_step
