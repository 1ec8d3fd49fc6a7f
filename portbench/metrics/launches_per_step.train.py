"""launches_per_step.train: device kernels launched per profiled train step
(a count; entry and host path, engine/steps.py::train_step)."""


def read(run):
    if run.trace is None or run.mode != "train":
        return None
    return len(run.trace.device_kernels()) / run.trace.steps
