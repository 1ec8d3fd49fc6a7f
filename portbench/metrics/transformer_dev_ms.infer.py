"""transformer_dev_ms.infer: device ms per pair of the kernels launched
inside the geometric transformer's range (models/attention.py,
models/embedding.py and its kernel)."""

from portbench.readers import per_step_ms


def read(run):
    if run.mode != "infer":
        return None
    return per_step_ms(run, lambda k: run.trace.launched_in(k, "pb.transformer"))
