"""update_idle_ms.train: device-idle ms per profiled train step while the
host's main thread was inside `gt.update` (the guarded update: the finite
test's read-back and the optimizer's step) (portbench/spans.py)."""

from portbench.spans import idle_ms


def read(run):
    return idle_ms(run, "train", "update")
