"""PyTorch port: the program's spans (`utils/timer.py::span`).

* under `torch.profiler`, `demo.register` records each span of a pair once a
  pair (the subsampling once a cloud), nested as the layers are: the pyramid
  and the forward in `gt.register`, the forward's steps in `gt.forward`;
* `engine.steps.train_step` records `gt.train_step` around the pyramid, the
  forward (with its ground truth), the loss, the backward and the guarded
  update, whose guard and optimizer step lie in `gt.update`;
* with no profiler active no span enters `record_function`;
* the epoch trainer's profile window writes `gt.train_step` and `gt.load`
  into its Chrome trace.

On the CPU, at tests/torch_port_utils.py::tiny4_config.
"""

import collections
import dataclasses
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ref_geotransformer_tpu_torch import demo
from ref_geotransformer_tpu_torch.data import PairLoader
from ref_geotransformer_tpu_torch.data.datasets import ThreeDMatchPairDataset
from ref_geotransformer_tpu_torch.engine import EpochBasedTrainer, TrainState, train_step
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4.fixture import make_fixture_tree
from ref_geotransformer_tpu_torch.utils import timer
from tests.torch_port_utils import port_config, tiny4_config, to_torch
from tests.utils import synthetic_pair

PYRAMID = {("gt.pyramid.subsample", "gt.pyramid"): 2, ("gt.pyramid.search", "gt.pyramid"): 1}
FORWARD_STEPS = ("gt.partition", "gt.backbone", "gt.transformer", "gt.coarse_matching", "gt.patch_gather",
                 "gt.optimal_transport", "gt.lgr")
# (span, the nearest span around it) -> count a pair
REGISTER = {
    ("gt.register", None): 1, ("gt.pyramid", "gt.register"): 1, **PYRAMID, ("gt.forward", "gt.register"): 1,
    **{(name, "gt.forward"): 1 for name in FORWARD_STEPS}, ("gt.embedding", "gt.transformer"): 1,
}
TRAIN_STEP = {
    ("gt.train_step", None): 1, ("gt.pyramid", "gt.train_step"): 1, **PYRAMID, ("gt.forward", "gt.train_step"): 1,
    **{(name, "gt.forward"): 1 for name in FORWARD_STEPS + ("gt.ground_truth",)},
    ("gt.embedding", "gt.transformer"): 1, ("gt.loss", "gt.train_step"): 1, ("gt.backward", "gt.train_step"): 1,
    ("gt.update", "gt.train_step"): 1, ("gt.update.guard", "gt.update"): 1, ("gt.update.optimizer", "gt.update"): 1,
}


@pytest.fixture(scope="module")
def setup():
    cfg = port_config(tiny4_config())
    data, _ = synthetic_pair(tiny4_config(), seed=5)
    data = to_torch(data)
    pair = {f"{side}_{key}": data[side][key][0] for side in ("ref", "src") for key in ("points", "masks")}
    pair["transform"] = data["transform"]
    return cfg, demo.build_model(cfg, torch.device("cpu"), seed=3), pair


def _spans(prof):
    """(name, name of the nearest enclosing gt.* span) of each gt.* span recorded, counted."""
    found = collections.Counter()
    for event in prof.events():
        if event.name.startswith("gt."):
            parent = event.cpu_parent
            while parent is not None and not parent.name.startswith("gt."):
                parent = parent.cpu_parent
            found[(event.name, parent.name if parent is not None else None)] += 1
    return found


def test_register_records_each_span_once_a_pair(setup):
    cfg, model, pair = setup
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            demo.register(model, cfg, pair)
    assert _spans(prof) == {key: 2 * count for key, count in REGISTER.items()}


def test_train_step_records_its_spans(setup):
    cfg, _, pair = setup
    model = demo.build_model(cfg, torch.device("cpu"), seed=3).train()
    state = TrainState(model, cfg.optim, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(model, state, pair, torch.Generator().manual_seed(0))
    assert state.count == 1
    assert _spans(prof) == TRAIN_STEP


def test_no_span_enters_record_function_without_a_profiler(setup, monkeypatch):
    cfg, model, pair = setup
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(timer, "record_function", Counting)
    demo.register(model, cfg, pair)
    train_model = demo.build_model(cfg, torch.device("cpu"), seed=3).train()
    train_step(train_model, TrainState(train_model, cfg.optim, 1), pair, torch.Generator().manual_seed(0))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        demo.register(model, cfg, pair)
    assert collections.Counter(entered) == collections.Counter(
        {name: count for (name, _), count in REGISTER.items()})


def test_trainer_profile_window_holds_train_step_and_load_spans(tmp_path):
    """profile_steps=(1, 3) over a 3-step epoch: steps 2 and 3, and the fetches
    after the window opened (the third batch's and the one that ends the epoch)."""
    root = str(tmp_path / "tree")
    make_fixture_tree(root, n_train=3, n_val=0, points=600)
    cfg = tiny4_config()
    cfg = port_config(cfg.replace(optim=dataclasses.replace(cfg.optim, max_epoch=1)))
    loader = PairLoader(ThreeDMatchPairDataset(root, "train", point_limit=None, use_augmentation=False,
                                               seed=cfg.seed), cfg, batch_size=1, shuffle=False, seed=cfg.seed)
    model = demo.build_model(cfg, torch.device("cpu"), seed=3)
    trainer = EpochBasedTrainer(cfg, model, TrainState(model, cfg.optim, len(loader)), loader, None,
                                snapshot_dir=str(tmp_path / "snapshots"), log_steps=1,
                                profile_dir=str(tmp_path / "trace"), profile_steps=(1, 3))
    trainer.run()
    with open(os.path.join(tmp_path, "trace", "trace-3.json")) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    assert names["gt.train_step"] == 2
    assert names["gt.load"] == 2
