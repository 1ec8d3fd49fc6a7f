"""pairs_per_s: pairs completed in the window over the window's length (host
clock), one caller in a closed loop; a pair is upload, pyramid, forward and
the transform read back."""


def read(run):
    if run.mode != "infer" or not run.window_s:
        return None
    return (run.attempted - run.failed) / run.window_s
