"""Layer: kernels, reduce_lanes (K1).  K1's share of its roofline over the
window: the bound of every launch (roofline.reduce_lanes_cost: lanes x the
columns each runs x words x 13, plus 6 a lane-column) over K1's device
time, in %.  K1 verifies the filter's candidates and runs the segmented
fallback."""

import re

from benchmark import roofline

KERNELS = re.compile(r"\b(reduce_lanes_kernel|reduce_split_kernel)\b")


def read(ctx):
    launches = (ctx.recorded or {}).get("reduce_lanes")
    if not launches or ctx.trace is None:
        return None
    bound = sum(roofline.bound_s(*roofline.reduce_lanes_cost(a))
                for a in launches)
    return roofline.share(bound, ctx.device_seconds(KERNELS.search))
