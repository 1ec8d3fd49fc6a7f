"""mfu.train: the whole train step (forward and backward)'s contraction work at each precision class's
peak (portbench/work/step.py: bf16 KPConv at 989 TFLOP/s where the
configuration declares it, f32 at 495) over the mean time of a step outside
the profiled block, as a share."""

from portbench.work.step import step_tally


def read(run):
    if run.trace is None or run.mode != "train":
        return None
    counts = run.counts()
    bound = sum(step_tally(run.cfg, c, blocks, train=True).seconds() for c, blocks in counts) / len(counts)
    return 100.0 * bound / run.step_seconds()
