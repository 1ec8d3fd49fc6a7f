"""backbone_graph_share.infer: the share of the profiled block's backbone
calls that replayed a CUDA graph: `gt.backbone.replay` ranges over
`gt.backbone` ranges on the main thread (the window range's thread). 0 for a
program that runs the backbone op by op; None without a trace, in training,
or without the program's `gt.backbone` span (backbone)."""

from portbench.trace import WINDOW


def read(run):
    if run.trace is None or run.mode != "infer":
        return None
    main = run.trace.named(WINDOW)[0].tid
    calls = sum(1 for r in run.trace.named("gt.backbone") if r.tid == main)
    if calls == 0:
        return None
    return sum(1 for r in run.trace.named("gt.backbone.replay") if r.tid == main) / calls
