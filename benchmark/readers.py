"""Readers that several per-layer metrics share (each metric's own file
names its layer and calls one of these)."""

from __future__ import annotations

from benchmark import devtrace


def idle_share(ctx):
    """% of the traced window in which no kernel, copy or set ran."""
    if ctx.trace is None or not ctx.trace.spans:
        return None
    lo, hi = devtrace.window(ctx.trace)
    busy = devtrace.covered(ctx.trace.device, lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))


def host_ms(ctx):
    """Mean over the window's calls of the call's span less the device's
    busy time inside it, in ms."""
    if ctx.trace is None:
        return None
    calls = [s for s in ctx.trace.spans if s[0] == "call"]
    if not calls:
        return None
    host = [(b - a) - devtrace.covered(ctx.trace.device, a, b)
            for _, a, b in calls]
    return 1e3 * sum(host) / len(host)
