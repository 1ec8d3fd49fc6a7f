"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU, at a size a test can hold, through the program's plain paths:
a sound run reads within the cell's limits, and each fault that the cell
can have reads outside them. One pair per step and one chip leave two of
the faults nothing to act on: no batch to halve, no exchange between chips.
"""

import time

import pytest
import torch

from portbench import harness
from portbench.tests.small import caps_of, small_cell

CPU = torch.device("cpu")


def _run(name, seed=2**31 + 7):
    cell = small_cell(name)
    result = harness.run_cell(cell, seed, 0.3, False, CPU, time.perf_counter(), caps=caps_of(cell))
    correct, shown = harness.verdict(result["checks"], cell.limits)
    return correct and result["failed"] == 0, shown


@pytest.mark.parametrize("name", ["3dmatch-infer", "kitti-infer", "3dmatch-train", "kitti-train"])
def test_sound_run_is_correct(name):
    correct, shown = _run(name)
    assert correct, shown


@pytest.mark.parametrize("name", ["3dmatch-infer", "kitti-infer"])
def test_altered_transform_is_caught(name, monkeypatch):
    """An answer altered where it is produced: the estimated transform moved
    by a centimetre."""
    import ref_geotransformer_tpu_torch.demo as demo

    register = demo.register

    def altered(model, cfg, pair):
        out = register(model, cfg, pair)
        out["estimated_transform"] = out["estimated_transform"] + torch.tensor(
            [[0, 0, 0, 1e-2]] + [[0, 0, 0, 0]] * 3, device=out["estimated_transform"].device)
        return out

    monkeypatch.setattr(demo, "register", altered)
    correct, shown = _run(name)
    assert not correct and shown["transform"]["value"] > shown["transform"]["limit"], shown


@pytest.mark.parametrize("name", ["3dmatch-train", "kitti-train"])
def test_step_that_leaves_the_state_unchanged_is_caught(name, monkeypatch):
    from ref_geotransformer_tpu_torch.engine.state import GuardedState

    monkeypatch.setattr(GuardedState, "apply_gradients", lambda self: self.zero_grad() or False)
    correct, shown = _run(name)
    assert not correct and shown["change"]["value"] >= 0.99, shown


@pytest.mark.parametrize("name", ["3dmatch-train", "kitti-train"])
def test_altered_loss_is_caught(name, monkeypatch):
    """An answer altered where it is produced: the loss scaled by 1.01."""
    import ref_geotransformer_tpu_torch.engine.steps as steps

    overall = steps.overall_loss

    def altered(*args, **kwargs):
        losses = overall(*args, **kwargs)
        losses["loss"] = losses["loss"] * 1.01
        return losses

    monkeypatch.setattr(steps, "overall_loss", altered)
    correct, shown = _run(name)
    assert not correct and shown["loss"]["value"] > shown["loss"]["limit"], shown
