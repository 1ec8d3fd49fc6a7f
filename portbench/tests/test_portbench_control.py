"""The control, the plain reference put in the program's place one
precision below the configuration's, comes out not correct; the program
at the same size comes out correct. On a card only (TF32 exists there
alone), at capacities a test run can hold."""

import pytest

from portbench import control, harness
from portbench.tests.small import caps_of, small_cell

CARD_CAPS = {"fragments": {"points": [8192, 3072, 1024, 384]}, "scans": {"points": [8192, 4096, 1536, 512, 192]}}


def _cell(name):
    cell = small_cell(name)
    pool = dict(cell.traffic["pool"])
    if pool["kind"] == "fragments":
        pool["keep"] = [0.3, 0.4]
    else:
        pool.update(points=6000, radius=20.0)
    return harness.dataclasses.replace(cell, traffic=dict(cell.traffic, pool=pool))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["3dmatch-infer", "kitti-infer", "3dmatch-train", "kitti-train"])
@pytest.mark.parametrize("seed", [11, 2**31 + 3, 4049])
def test_control_fails_and_program_passes(name, seed, cuda_device):
    cell = _cell(name)
    caps = CARD_CAPS[cell.traffic["pool"]["kind"]]
    train = cell.traffic["mode"] == "train"
    low = (control.control_train if train else control.control_infer)(cell, seed, cuda_device, caps)
    ok, shown = harness.verdict(low, cell.limits)
    assert not ok, shown
    sound = (control.program_train if train else control.program_infer)(cell, seed, cuda_device, caps)
    ok, shown = harness.verdict(sound, cell.limits)
    assert ok, {k: v for k, v in shown.items() if v["limit"] is None or float(v["value"]) > v["limit"]}


def test_small_cells_use_the_small_caps():
    assert caps_of(small_cell("kitti-infer"))["points"][0] == 2048
