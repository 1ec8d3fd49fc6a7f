"""Cells cut to a size the CPU tests can hold: a few hundred points per
cloud and small capacities, a window of a fraction of a second."""

import dataclasses

from portbench import harness

CAPS = {"fragments": {"points": [1024, 512, 256, 128]}, "scans": {"points": [2048, 1024, 512, 256, 128]}}


def small_cell(name: str) -> harness.Cell:
    cell = harness.resolve(name)
    tr = dict(cell.traffic, pool=dict(cell.traffic["pool"]), profiled=2)
    if tr["pool"]["kind"] == "fragments":
        tr["pool"]["keep"] = [0.02, 0.03]
    else:
        tr["pool"].update(points=1500, radius=10.0)
    if tr["mode"] == "infer":
        tr.update(checked=2, checked_from=2)
    return dataclasses.replace(cell, traffic=tr)


def caps_of(cell: harness.Cell) -> dict:
    return CAPS[cell.traffic["pool"]["kind"]]
