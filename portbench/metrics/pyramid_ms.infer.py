"""pyramid_ms.infer: wall ms of the pyramid (upload, data/pyramid.py and the
radius-search kernels), from the start of a pair to the model's forward,
taken to the end of the last kernel launched in it where that ends later
(the range as if synchronised at its end); mean over the profiled pairs."""

from portbench.trace import PYRAMID


def read(run):
    if run.trace is None or run.mode != "infer":
        return None
    spans = []
    kernels = run.trace.kernels
    for r in run.trace.named(PYRAMID):
        end = max([r.end] + [k.end for k in kernels if k.launch is not None and k.tid == r.tid
                             and r.start <= k.launch <= r.end])
        spans.append(end - r.start)
    return sum(spans) / len(spans) / 1e3 if spans else None
