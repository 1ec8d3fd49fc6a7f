"""matching_dev_ms.infer: device ms per pair of the forward's kernels outside
the backbone's and the transformer's ranges: partition, ground truth,
superpoint matching, patch gather, Sinkhorn and local-to-global
registration."""

from portbench.readers import per_step_ms


def read(run):
    if run.mode != "infer":
        return None
    t = run.trace
    return per_step_ms(run, lambda k: t.launched_in(k, "pb.model") and not t.launched_in(k, "pb.backbone")
                       and not t.launched_in(k, "pb.transformer"))
