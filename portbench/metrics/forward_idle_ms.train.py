"""forward_idle_ms.train: device-idle ms per profiled train step while the
host's main thread was inside `gt.train_step` but neither `gt.backward` nor
`gt.update`: the pyramid, the forward with sampled targets and the loss
(portbench/spans.py)."""

from portbench.spans import idle_ms


def read(run):
    return idle_ms(run, "train", "forward")
