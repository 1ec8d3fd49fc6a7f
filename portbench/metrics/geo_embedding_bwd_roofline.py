"""geo_embedding_bwd_roofline: the structure embedding's backward (both
clouds) as a share of its roofline: the least time of the weight gradients'
valid work (portbench/work/embedding.py) over the device time of the
backward kernels, matched by name (the backward cannot be ranged from
outside)."""

import re

from portbench.readers import device_us, share
from portbench.work import embedding

NAMES = re.compile(r"geo_embedding_bwd_kernel|sum_chunks_kernel")


def read(run):
    if run.trace is None or run.mode != "train":
        return None
    gt = run.cfg.geotransformer
    us = device_us(run.trace, lambda k: bool(NAMES.search(k.name)))
    bound = 0.0
    for counts, _ in run.counts():
        for cloud in counts.clouds:
            bound += embedding.seconds(*embedding.backward(cloud.points[-1], gt.hidden_dim))
    return share(bound, us)
