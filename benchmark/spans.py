"""Readers of the program's own spans and counters against the traced
window's device intervals.

The port records spans and counters in one registry
(``edlib_tpu_torch.utils.profiling``): a span has ``name``, ``start_ns`` and
``end_ns`` on ``time.time_ns()``, the clock of torch.profiler's events, so
in seconds it compares directly with ``devtrace``'s intervals.  A traced run
that enables the registry before its window and takes it after hands both to
its context as ``ctx.spans`` and ``ctx.counters``; a context without them
(a program with no registry, or a run that did not enable it) reads None.
Nothing here imports the program.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark import devtrace


def intervals(spans, names) -> List[devtrace.Interval]:
    """The spans whose name is in names, as devtrace intervals in seconds."""
    return [(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans
            if s.name in names]


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]
            ) -> float:
    """Seconds that two sorted lists of disjoint (start, end) pairs share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_s(device, under, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] inside some interval of under in which no device
    interval ran (overlapping intervals of either kind counted once)."""
    u = devtrace.merged(under, lo, hi)
    busy = devtrace.merged(device, lo, hi)
    return sum(b - a for a, b in u) - overlap(u, busy)


def idle_ms(ctx, name: str):
    """The card's idle ms a call under the program's spans named name,
    inside the traced window."""
    spans = getattr(ctx, "spans", None)
    if ctx.trace is None or not spans or not ctx.calls:
        return None
    under = intervals(spans, {name})
    if not under:
        return None
    lo, hi = devtrace.window(ctx.trace)
    return 1e3 * idle_s(ctx.trace.device, under, lo, hi) / len(ctx.calls)


def straggler_share(ctx):
    """Reads the q-gram filter left to the straggler routes over the reads
    it was given, in %, from the program's counters."""
    counts = getattr(ctx, "counters", None) or {}
    live = counts.get("map.reads_live", 0)
    if live <= 0:
        return None
    return 100.0 * (counts.get("map.stragglers_segmented", 0)
                    + counts.get("map.stragglers_shared", 0)) / live
