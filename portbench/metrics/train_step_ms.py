"""train_step_ms: the window's length over the train steps in it (host
clock); a step is upload, pyramid, forward with sampled targets, loss,
backward and the guarded optimizer update."""


def read(run):
    if run.mode != "train" or not run.attempted:
        return None
    return 1e3 * run.window_s / run.attempted
