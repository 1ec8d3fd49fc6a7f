"""outside_idle_ms.train: device-idle ms per profiled train step while the
host's main thread was outside `gt.train_step`: the caller's upload and
read-back of the loss (portbench/spans.py)."""

from portbench.spans import idle_ms


def read(run):
    return idle_ms(run, "train", "outside")
