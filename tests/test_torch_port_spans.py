"""PyTorch port: the program's spans (`utils/timer.py::span`).

* under `torch.profiler`, `demo.register` records each span of a pair once a
  pair (the subsampling once a cloud), nested as the layers are: the pyramid
  and the forward in `gt.register`, the forward's steps in `gt.forward`;
* `engine.steps.train_step` records `gt.train_step` around the pyramid, the
  forward (with its ground truth), the loss, the backward and the guarded
  update, whose guard and optimizer step lie in `gt.update`;
* with no profiler active no span enters `record_function`;
* the epoch trainer's profile window writes `gt.train_step` and `gt.load`
  into its Chrome trace;
* on CPU tensors the model built with kernels takes the plain paths (no
  backbone graph, torch's SVD in LGR), grad off or on;
* what the backbone's graph reads of a pair gives the eager features;
* the benchmark's readers of the backbone's graph replays and of LGR's
  read-backs, on hand-made traces.

On the CPU, at tests/torch_port_utils.py::tiny4_config.
"""

import collections
import dataclasses
import json
import os
import types

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


@pytest.mark.parametrize("training", [False, True])
def test_kernel_model_takes_the_plain_paths_on_the_cpu(setup, training):
    """On CPU tensors, with grad off (inference) or on (a training forward),
    the model built with kernels captures no backbone graph, and LGR's SVDs
    are `torch.linalg.svd`'s: its outputs are the plain model's bit for bit."""
    from ref_geotransformer_tpu_torch.data.pyramid import build_registration_inputs

    cfg, model, pair = setup
    plain = demo.build_model(cfg, torch.device("cpu"), seed=3, use_kernels=False)
    bb, caps = cfg.backbone, cfg.capacities
    data = build_registration_inputs(pair["ref_points"], pair["ref_masks"], pair["src_points"], pair["src_masks"],
                                     bb.num_stages, bb.init_voxel_size, bb.init_radius, caps.neighbor_limits,
                                     caps.points, transform=pair["transform"], search_chunk=caps.search_chunk)
    got = model(data, training=training, generator=torch.Generator().manual_seed(4))
    want = plain(data, training=training, generator=torch.Generator().manual_seed(4))
    assert model.backbone._graphs == {}
    assert got.keys() == want.keys()
    for key in got:
        assert torch.equal(got[key], want[key]), key
    assert got["estimated_transform"].requires_grad is False



def test_backbone_graph_inputs_give_the_eager_features(setup):
    """What the backbone's CUDA graph reads of a pair (`_read`: every level's
    points, masks, neighbors and subsampling, column 0 of the upsampling
    tables the decoders use, nothing of the others), stacked into buffers as
    `stack_inputs` stacks it, gives the eager backbone's features bit for
    bit."""
    from ref_geotransformer_tpu_torch.data.pyramid import build_registration_inputs
    from ref_geotransformer_tpu_torch.models.backbone import stack_pair

    cfg, model, pair = setup
    bb, caps = cfg.backbone, cfg.capacities
    data = build_registration_inputs(pair["ref_points"], pair["ref_masks"], pair["src_points"], pair["src_masks"],
                                     bb.num_stages, bb.init_voxel_size, bb.init_radius, caps.neighbor_limits,
                                     caps.points, search_chunk=caps.search_chunk)
    backbone, ref, src = model.backbone, data["ref"], data["src"]
    read = backbone._read(ref)
    used = [backbone.fine_level <= i <= backbone.num_stages - 2 for i in range(len(ref["upsampling"]))]
    assert [t is not None for t in read["upsampling"]] == used and any(used) and not all(used)
    assert all(t.shape[-1] == 1 for t in read["upsampling"] if t is not None)
    bufs = {key: tuple(None if t is None else torch.empty((2,) + t.shape, dtype=t.dtype) for t in ts)
            for key, ts in read.items()}
    assert stack_pair(backbone._read(ref), backbone._read(src), out=bufs) is bufs
    feats = torch.stack([data["ref_feats"], data["src_feats"]], dim=0)
    with torch.no_grad():
        got = backbone._forward(feats, bufs)
        want = backbone(feats, stack_pair(ref, src))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

def _reader_run(events, mode="infer"):
    import tempfile

    from portbench.trace import parse_chrome_trace

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        return types.SimpleNamespace(trace=parse_chrome_trace(path, 2), mode=mode)


def _ev(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1, "args": {}}


def _pairs(replay: bool, readbacks: int):
    """Two pairs' spans in a window; `readbacks` read-backs inside each pair's
    `gt.lgr`, one before it and one on another thread inside it."""
    events = [_ev("pb.window", 0, 200)]
    for at in (0, 100):
        events += [_ev("gt.register", at + 1, 98), _ev("gt.backbone", at + 10, 20), _ev("gt.lgr", at + 60, 30),
                   _ev("aten::_local_scalar_dense", at + 50, 1, cat="cpu_op"),
                   _ev("aten::_local_scalar_dense", at + 70, 1, tid=2, cat="cpu_op")]
        events += [_ev("aten::_local_scalar_dense", at + 61 + 3 * i, 1, cat="cpu_op") for i in range(readbacks)]
        if replay:
            events.append(_ev("gt.backbone.replay", at + 12, 5))
    return events


@pytest.mark.parametrize("case", ["eager backbone, LGR reading back", "graph replay, LGR without reads",
                                  "no program spans", "training"])
def test_graph_and_readback_readers(case):
    """`backbone_graph_share.infer` reads 0 on a trace without the replay span
    and 1 with it; `lgr_readbacks_per_pair.infer` counts the main thread's
    read-backs inside `gt.lgr` per pair (0 without any); both read None
    without the program's spans and in training."""
    from portbench import harness

    share, reads = (harness.load_reader(n) for n in ("backbone_graph_share.infer", "lgr_readbacks_per_pair.infer"))
    if case == "eager backbone, LGR reading back":
        run = _reader_run(_pairs(replay=False, readbacks=9))
        assert (share(run), reads(run)) == (0.0, 9.0)
    elif case == "graph replay, LGR without reads":
        run = _reader_run(_pairs(replay=True, readbacks=0))
        assert (share(run), reads(run)) == (1.0, 0.0)
    elif case == "no program spans":
        run = _reader_run([e for e in _pairs(replay=False, readbacks=9) if not e["name"].startswith("gt.")])
        assert (share(run), reads(run)) == (None, None)
    else:
        run = _reader_run(_pairs(replay=True, readbacks=9), mode="train")
        assert (share(run), reads(run)) == (None, None)
        assert share(types.SimpleNamespace(trace=None, mode="infer")) is None
