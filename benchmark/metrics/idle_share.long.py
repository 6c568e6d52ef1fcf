"""Layer: device.  The card's idle share of the traced window: 1 - the
union of kernel, copy and set intervals over the window, in %."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
