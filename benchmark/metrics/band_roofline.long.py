"""Layer: kernels, wavefront_banded (#16).  The banded wavefront's share of
its roofline over the window: the bound of the Ukkonen band that each
pair's distance needs (roofline.band_cost), whatever the ladder ran, over
#16's device time, in %.  The distance is the call's answer (held against
the reference after the window); a call answered -1 counts the band of k."""

import re

from benchmark import roofline

KERNELS = re.compile(r"\b(wavefront_tiles_kernel|wavefront_kernel)\b")


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    k = ctx.entry.k
    bound = 0.0
    for i, _, _, d in ctx.calls:
        if d is None:
            continue
        p = ctx.entry.pairs[i % ctx.entry.n_inputs]
        bound += roofline.bound_s(*roofline.band_cost(
            len(p.q_codes), len(p.t_codes), k if d < 0 else d))
    return roofline.share(bound, ctx.device_seconds(KERNELS.search))
