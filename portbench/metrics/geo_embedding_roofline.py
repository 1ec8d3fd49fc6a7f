"""geo_embedding_roofline: the structure embedding's forward (both clouds)
as a share of its roofline: the least time of its valid work at the peaks
(portbench/work/embedding.py) over the device time of the kernels launched
in the embedding module's ranges."""

from portbench.readers import device_us, share
from portbench.work import embedding


def read(run):
    if run.trace is None or run.mode != "infer":
        return None
    gt = run.cfg.geotransformer
    us = device_us(run.trace, lambda k: run.trace.launched_in(k, "pb.embedding"))
    bound = 0.0
    for counts, _ in run.counts():
        for cloud in counts.clouds:
            bound += embedding.seconds(*embedding.forward(cloud.points[-1], gt.hidden_dim, gt.angle_k))
    return share(bound, us)
