"""backward_dev_ms.train: device ms per train step of the kernels that the
autograd engine's backward ops launch (their `evaluate_function` ranges,
on the engine's thread)."""

from portbench.readers import per_step_ms
from portbench.trace import BACKWARD_PREFIX


def read(run):
    if run.mode != "train":
        return None
    return per_step_ms(run, lambda k: run.trace.launched_in(k, BACKWARD_PREFIX, prefix=True))
