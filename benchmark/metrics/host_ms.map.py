"""Layer: entry, mapping.py.  Host ms a call of map_reads: the call's span
less the device's busy time inside it, mean over the window's calls."""

from benchmark import readers


def read(ctx):
    return readers.host_ms(ctx)
