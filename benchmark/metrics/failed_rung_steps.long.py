"""Layer: k ladder, ops/wavefront.BandedWavefront.  The banded steps of the
rungs that did not answer over all banded steps of the window, in %, from
the port's own record of its rungs (ops.wavefront.take_rungs)."""


def read(ctx):
    steps = sum(r["banded_steps"] for r in ctx.rungs)
    if steps <= 0:
        return None
    failed = sum(r["banded_steps"] for r in ctx.rungs if not r["answered"])
    return 100.0 * failed / steps
