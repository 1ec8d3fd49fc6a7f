"""launches_per_pair.infer: device kernels launched per profiled pair (a
count; entry and host path, demo.register)."""


def read(run):
    if run.trace is None or run.mode != "infer":
        return None
    return len(run.trace.device_kernels()) / run.trace.steps
