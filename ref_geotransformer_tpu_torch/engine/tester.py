"""Single-pair tester: resolve a snapshot, loop the test set, collect
metrics, and hand each pair's outputs to a callback (the experiment's
after_test_step, e.g. the .npz feature dump for offline eval).

Counterpart of `ref_geotransformer_tpu/engine/tester.py` (ref parity:
engine/base_tester.py:24-85 + single_tester.py:14-74). The loader yields
numpy pairs; each moves to the model's device, and the callback receives
the outputs as numpy arrays on the host.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from ref_geotransformer_tpu_torch.engine.checkpoint import CheckpointManager
from ref_geotransformer_tpu_torch.engine.steps import forward, to_device
from ref_geotransformer_tpu_torch.engine.trainer import to_floats
from ref_geotransformer_tpu_torch.models.losses import evaluate
from ref_geotransformer_tpu_torch.utils.common import get_log_string
from ref_geotransformer_tpu_torch.utils.logger import Logger
from ref_geotransformer_tpu_torch.utils.summary_board import SummaryBoard
from ref_geotransformer_tpu_torch.utils.timer import Timer


def to_numpy(output: dict) -> dict:
    """The tensors of an output dict -> numpy arrays on the host (bf16 as f32)."""
    return {key: (value.float() if value.dtype == torch.bfloat16 else value).detach().cpu().numpy()
            for key, value in output.items() if isinstance(value, torch.Tensor)}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SingleTester:
    def __init__(
        self,
        cfg,
        model,
        test_loader: Iterable,
        after_test_step: Optional[Callable] = None,
        log_file: Optional[str] = None,
    ):
        self.cfg = cfg
        self.model = model
        self.test_loader = test_loader
        self.after_test_step = after_test_step
        self.logger = Logger(log_file=log_file)
        self.device = next(model.parameters()).device

    @classmethod
    def from_snapshot(cls, cfg, model, snapshot_dir, snapshot_name, test_loader, **kwargs):
        CheckpointManager(snapshot_dir).load_model(snapshot_name, model)
        return cls(cfg, model, test_loader, **kwargs)

    def run(self) -> dict:
        board = SummaryBoard(adaptive=True)
        timer = Timer()
        timer.record()
        for i, (data, meta) in enumerate(self.test_loader):
            timer.add_prepare_time()
            pair = to_device(data, self.device)
            output = forward(self.model, self.cfg, pair)
            synchronize(self.device)
            timer.add_process_time()
            if "transform" in data:
                board.update_from_result_dict(to_floats(evaluate(output, pair["transform"], self.cfg.eval)))
            if self.after_test_step is not None:
                self.after_test_step(i, data, meta, to_numpy(output))
            timer.record()
        summary = board.summary()
        self.logger.info("[Test] " + get_log_string(summary, timer=timer))
        return summary
