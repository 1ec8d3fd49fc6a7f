"""radius_search_roofline: the pair's radius searches as a share of their
roofline: the least time of the pairs within each radius and the bytes read
and written (portbench/work/radius.py) over the device time of the search
kernels, matched by name inside the pyramid's range."""

import re

from portbench.readers import device_us, share
from portbench.trace import PYRAMID
from portbench.work import radius

NAMES = re.compile(r"radius_search_group_kernel|radius_pack_kernel")


def read(run):
    if run.trace is None or run.mode != "infer":
        return None
    t = run.trace
    us = device_us(t, lambda k: bool(NAMES.search(k.name)) and t.launched_in(k, PYRAMID))
    bound = sum(radius.seconds(*radius.work(*s)) for counts, _ in run.counts() for s in counts.searches)
    return share(bound, us)
