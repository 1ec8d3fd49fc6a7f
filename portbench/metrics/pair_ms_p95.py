"""pair_ms_p95: the 95th percentile of the per-pair latency over every pair
of the window (host clock, upload to the transform on the host)."""

import numpy as np


def read(run):
    if run.mode != "infer" or not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
