"""idle_pct.train: share of the profiled block (from its start to its
closing synchronize) in which no kernel, copy or set runs on the device."""


def read(run):
    if run.trace is None or run.mode != "train":
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - run.trace.busy_us() / (hi - lo))
