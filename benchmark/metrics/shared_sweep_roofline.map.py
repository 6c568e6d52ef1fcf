"""Layer: kernels, sweep_shared (K2).  K2's share of its roofline over the
window: the bound of every launch (roofline.sweep_shared_cost: lanes x the
columns x words x 13, plus 4 a lane-column) over K2's device time, in %.
K2 sweeps the stragglers past the segmented fallback's 64 over the whole
genome."""

import re

from benchmark import roofline

KERNELS = re.compile(r"\b(sweep_shared_kernel|sweep_shared_split_kernel)\b")


def read(ctx):
    launches = (ctx.recorded or {}).get("sweep_shared")
    if not launches or ctx.trace is None:
        return None
    bound = sum(roofline.bound_s(*roofline.sweep_shared_cost(a))
                for a in launches)
    return roofline.share(bound, ctx.device_seconds(KERNELS.search))
