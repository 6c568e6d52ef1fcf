"""The traced window: torch.profiler over it, read back as intervals.

A ``--trace 1`` run profiles the whole window (CPU ops and the card's
kernels, copies and sets through CUPTI).  The benchmark's own spans are
``record_function`` ranges around each call (``call``) and around its own
work between calls (``between_calls``); they carry the host clock of the
device intervals, so a call's host time is its span less the device time
inside it.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

SPANS = ("call", "between_calls")
Interval = Tuple[str, float, float]     # (name, start s, end s)


class Trace(NamedTuple):
    device: List[Interval]   # kernels, copies and sets, by start
    spans: List[Interval]    # the benchmark's spans, by start
    host: List[Interval]     # the program's host ops, by start


def read(prof) -> Trace:
    """The profile's kernels, copies and sets (the device's events, less the
    spans mirrored on the device), the benchmark's spans and the host's
    torch ops, in seconds on one clock.  Only event fields that PyTorch
    2.11 has are read (it has no activity type)."""
    from torch.autograd import DeviceType
    device, spans, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        iv = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            if iv[0] not in SPANS:
                device.append(iv)
        elif iv[0] in SPANS:
            spans.append(iv)
        elif not e.is_user_annotation():
            host.append(iv)
    return Trace(*(sorted(x, key=lambda v: v[1])
                   for x in (device, spans, host)))


def merged(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the intervals clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    out: List[List[float]] = []
    for _, a, b in sorted(intervals, key=lambda v: v[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that some interval covers."""
    return sum(b - a for a, b in merged(intervals, lo, hi))


def window(tr: Trace) -> Tuple[float, float]:
    """The traced window: the first call's start to the last call's end."""
    calls = [s for s in tr.spans if s[0] == "call"]
    return calls[0][1], calls[-1][2]


def by_name(intervals, lo: float, hi: float, match=None) -> dict:
    """Seconds inside [lo, hi] by name, of the intervals whose name
    satisfies match (all without one)."""
    out: dict = {}
    for name, a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a and (match is None or match(name)):
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def short(name: str) -> str:
    """A kernel's name without its return type and template arguments."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    return n.split("<", 1)[0].split("(", 1)[0][:120] or name[:120]


def _span_at(tr: Trace, t: float) -> str:
    return next((s[0] for s in tr.spans if s[1] <= t <= s[2]), "none")


def _host_at(tr: Trace, a: float, b: float) -> str:
    """What the host ran in the gap [a, b]: the outermost op under its
    middle, else the Python between the last op to end before it and the
    first to start after."""
    mid = (a + b) / 2
    under = [h for h in tr.host if h[1] <= mid <= h[2]]
    if under:
        return max(under, key=lambda h: h[2] - h[1])[0]
    before = max((h for h in tr.host if h[2] <= mid), key=lambda h: h[2],
                 default=None)
    after = min((h for h in tr.host if h[1] >= mid), key=lambda h: h[1],
                default=None)
    return (f"python after {before[0] if before else '-'} before "
            f"{after[0] if after else '-'}")


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window and its
    longest idle gaps, each named by the benchmark's span and the
    outermost host op under its middle."""
    lo, hi = window(tr)
    ops: dict = {}
    for name, secs in by_name(tr.device, lo, hi).items():
        ops[short(name)] = ops.get(short(name), 0.0) + secs
    busy = merged(tr.device, lo, hi)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        named.append([f"{_span_at(tr, (a + b) / 2)}: {_host_at(tr, a, b)}",
                      b - a])
    return {"device_ops": [[n, s] for n, s in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": named}
