"""lgr_readbacks_per_pair.infer: host read-backs a profiled pair inside
local-to-global registration: `aten::_local_scalar_dense` ops (a device
scalar copied to the host: `.item()`, `bool()`, a 0-dim index) that start
inside a `gt.lgr` range on the main thread (the window range's thread).
Each makes the host wait until the card has run everything queued. None
without a trace, in training, or without the program's `gt.lgr` span
(partition, matching, Sinkhorn and LGR)."""

import bisect

from portbench.spans import union
from portbench.trace import WINDOW

READBACK = "aten::_local_scalar_dense"


def read(run):
    if run.trace is None or run.mode != "infer":
        return None
    main = run.trace.named(WINDOW)[0].tid
    lgr = union((r.start, r.end) for r in run.trace.named("gt.lgr") if r.tid == main)
    if not lgr:
        return None
    starts = [s for s, _ in lgr]
    count = 0
    for r in run.trace.named(READBACK):
        i = bisect.bisect_right(starts, r.start) - 1
        if r.tid == main and i >= 0 and r.start <= lgr[i][1]:
            count += 1
    return count / run.trace.steps
