"""pyramid_idle_ms.infer: device-idle ms per profiled pair while the host's
main thread was inside the program's `gt.pyramid` span (data/pyramid.py: the
subsampling and the radius search's host packing and launches)
(portbench/spans.py)."""

from portbench.spans import idle_ms


def read(run):
    return idle_ms(run, "infer", "pyramid")
