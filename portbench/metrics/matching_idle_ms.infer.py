"""matching_idle_ms.infer: device-idle ms per profiled pair while the host's
main thread was inside `gt.register` but none of `gt.pyramid`, `gt.backbone`
and `gt.transformer`: the partition, the coarse matching, the patch gather,
Sinkhorn and LGR (portbench/spans.py)."""

from portbench.spans import idle_ms


def read(run):
    return idle_ms(run, "infer", "matching")
