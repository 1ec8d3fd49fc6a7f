"""backward_idle_ms.train: device-idle ms per profiled train step while the
host's main thread was inside `gt.backward` (the `.backward()` call, while
the autograd engine runs) (portbench/spans.py)."""

from portbench.spans import idle_ms


def read(run):
    return idle_ms(run, "train", "backward")
