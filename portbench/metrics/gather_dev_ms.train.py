"""gather_dev_ms.train: device ms per train step of the gathers and their
scatter-add backward (ops/index.py::masked_gather, index_add_): kernels of
the "gather, scatter, index" group by name, since backward ops cannot be
ranged from outside."""

from portbench.readers import group_of, per_step_ms


def read(run):
    if run.mode != "train":
        return None
    return per_step_ms(run, lambda k: group_of(k.name) == "gather, scatter, index")
