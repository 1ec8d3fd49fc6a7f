"""outside_idle_ms.infer: device-idle ms per profiled pair while the host's
main thread was outside `gt.register`: the caller's upload and read-back of
the transform (portbench/spans.py)."""

from portbench.spans import idle_ms


def read(run):
    return idle_ms(run, "infer", "outside")
