"""setup_s: process start (before torch is imported) to the first timed pair
or step: imports, the CUDA context, the kernels' library (built on a
checkout's first run), pool and weights from the seed, warm-up."""


def read(run):
    return run.setup_s
