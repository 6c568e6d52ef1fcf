"""Layer: entry, longpair.py and the k ladder's host loop in
ops/wavefront.py.  Host ms a call of nw_distance_long: the call's span
less the device's busy time inside it, mean over the window's calls."""

from benchmark import readers


def read(ctx):
    return readers.host_ms(ctx)
