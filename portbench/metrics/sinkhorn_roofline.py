"""sinkhorn_roofline: the Sinkhorn iterations over the matched patches as a
share of their roofline: the least time of their valid entries' operations
and bytes (portbench/work/sinkhorn.py) over the device time of the kernels
launched in the optimal-transport module's range."""

from portbench.readers import device_us, share
from portbench.work import sinkhorn


def read(run):
    if run.trace is None or run.mode != "infer":
        return None
    us = device_us(run.trace, lambda k: run.trace.launched_in(k, "pb.optimal_transport"))
    iterations = run.cfg.model.num_sinkhorn_iterations
    bound = sum(sinkhorn.seconds(*sinkhorn.work(blocks, iterations)) for _, blocks in run.counts())
    return share(bound, us)
