"""backbone_dev_ms.infer: device ms per pair of the kernels launched inside
the backbone's range (models/backbone.py, kpconv.py, norms.py)."""

from portbench.readers import per_step_ms


def read(run):
    if run.mode != "infer":
        return None
    return per_step_ms(run, lambda k: run.trace.launched_in(k, "pb.backbone"))
