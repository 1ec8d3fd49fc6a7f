"""Two neighbor tables compared up to ties: the port's
`utils/neighbor_tables.py::table_mismatches` (numpy in, no torch), copied,
with ties at the radius added. Radius searches that rank the same squared
distances in another order keep different indices where distances tie, and
two that round d^2 differently disagree on a point at the radius itself; a
row differs only if an index in one set lies off both the farthest distance
of the two sets and the radius, or column 0 differs between two indices at
different distances.
"""

from __future__ import annotations

import numpy as np


def table_mismatches(ours, theirs, q_points, s_points, tie_tol=1e-6, scaled=False, radius=None):
    """Where two neighbor/patch tables (M, H), sentinel = len(s_points),
    differ beyond ties. Column 0 (the nearest neighbor, which
    nearest_upsample reads) must hold the same index or two at the same
    squared distance (e.g. a voxel of two points has its centroid exactly
    between them), and an index in only one of a row's sets must lie at the
    squared distance of the farthest index of the two sets, so that the two
    top-k selections only ordered equal distances differently. Squared
    distances are float64; a tie is a gap within `tie_tol`, or with
    `scaled` within tie_tol * (1 + |q|^2 + the row's largest |s|^2), for a
    table ranked by the f32 form |q|^2 - 2 q.s + |s|^2, whose rounding grows
    with the squared norms. With the search's `radius`, an index in one set
    only, or a column 0 that is empty in one table, is also a tie where its
    d^2 lies within the tolerance of radius^2. Returns (the number of rows that differ, a
    description of each row that differs beyond ties, the largest gap over
    its tolerance)."""
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    q = np.asarray(q_points, np.float64)
    s = np.asarray(s_points, np.float64)
    n = s.shape[0]
    if ours.shape != theirs.shape:
        raise ValueError(f"tables of shape {ours.shape} and {theirs.shape}")
    differ = np.where((np.sort(ours, 1) != np.sort(theirs, 1)).any(1) | (ours[:, 0] != theirs[:, 0]))[0]
    bad, worst = [], 0.0
    r2 = float("inf") if radius is None else float(radius) ** 2
    for i in differ:
        a, b = set(ours[i].tolist()) - {n}, set(theirs[i].tolist()) - {n}
        d2 = {x: float(np.sum((q[i] - s[x]) ** 2)) for x in a | b}
        tol = tie_tol
        if scaled:
            tol *= 1.0 + float(np.sum(q[i] ** 2)) + max((float(np.sum(s[x] ** 2)) for x in a | b), default=0.0)
        edge = max(d2.values(), default=0.0)
        gaps = {f"{x} only in one set (d^2 {d2[x]:.9f}, {edge - d2[x]:.3e} inside the row's farthest)":
                min(abs(d2[x] - edge), abs(d2[x] - r2)) for x in a ^ b}
        x, y = ours[i, 0], theirs[i, 0]
        if x != y:
            if x < n and y < n:
                gap = abs(d2[x] - d2[y])
            else:
                gap = abs(d2[min(x, y)] - r2) if min(x, y) < n else 0.0
            gaps[f"column 0 {x} vs {y}"] = gap
        what, gap = max(gaps.items(), key=lambda item: item[1], default=("", 0.0))
        worst = max(worst, gap / tol)
        if gap > tol:
            bad.append(f"row {i}: {what}: not a tie")
    return len(differ), bad, worst
