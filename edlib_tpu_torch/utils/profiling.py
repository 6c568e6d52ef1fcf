"""Spans and counters of the port, and GCUPS accounting.

One registry in host memory.  A span is a named stretch of one public call's
host work: ``Span(name, start_ns, end_ns, span_id, parent_id, call_id,
attrs)``.  A span opened with none open on its thread is a root (parent_id
0) and takes a new call id; every span under it shares that id.  Code that
several public calls reach, only some of them with a root, opens
``child()``: a span recorded only under an open span of its thread.  Spans are
recorded only after ``enable(True)``; while tracing is off ``span()`` checks
one flag and returns a shared null context, taking no time stamp.  Their
clock is ``time.time_ns()``, the clock of torch.profiler's events
(``kineto_results``), so a span and the card's kernels compare directly.

Counters are host integers counted whether or not tracing is on, from what
the host already holds (never a device fetch): ``launch.<wrapper>`` (kernel
launches, ops/cuda_kernel.launch_counts), ``path_route.<route>`` (PATH
windows, batch.path_route_counts), ``map.reads_live``,
``map.stragglers_segmented`` and ``map.stragglers_shared`` (mapping.py),
``wf.operands_built`` and ``wf.operands_reused`` (ops/wavefront.py: banded
runs that built their call's k-invariant operands, and rungs that took
them from an earlier rung of the call).

``take(prefix)`` returns the spans since the last ``take()`` and the
counters whose names start with prefix, and forgets them; the other
counters stay for their own readers.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Tuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int     # 0 for a root
    call_id: int
    attrs: dict


_ON = False
_SPANS: List[Span] = []
_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()
_OPEN = threading.local()          # .stack: the open spans of a thread
_SPAN_IDS = itertools.count(1)
_CALL_IDS = itertools.count(1)


class _Null:
    """The span while tracing is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()


class _Open:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "call_id",
                 "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        parent = stack[-1] if stack else None
        self.span_id = next(_SPAN_IDS)
        self.parent_id = parent.span_id if parent else 0
        self.call_id = parent.call_id if parent else next(_CALL_IDS)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _OPEN.stack.pop()
        _SPANS.append(Span(self.name, self.start_ns, end_ns, self.span_id,
                           self.parent_id, self.call_id, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context for one span of host work; ``with span(n) as s:`` gives
    ``s.set(**attrs)`` for attributes known later."""
    if not _ON:
        return _NULL
    return _Open(name, attrs)


def child(name: str, **attrs):
    """As span(), but recorded only inside an open span of this thread:
    never a root of its own."""
    if not _ON or not getattr(_OPEN, "stack", None):
        return _NULL
    return _Open(name, attrs)


def enable(on: bool = True) -> None:
    """Record spans from now on (or stop recording them)."""
    global _ON
    _ON = bool(on)


def count(name: str, n: int = 1) -> None:
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counter(name: str) -> int:
    return _COUNTS.get(name, 0)


def reset(prefix: str) -> None:
    """Zero the counters whose names start with prefix."""
    with _COUNTS_LOCK:
        for name in [n for n in _COUNTS if n.startswith(prefix)]:
            del _COUNTS[name]


def take(prefix: str) -> Tuple[List[Span], Dict[str, int]]:
    """(spans, counters): every span since the last take(), oldest first by
    its end, and the counters whose names start with prefix ("" for all);
    those are forgotten, the other counters kept."""
    with _COUNTS_LOCK:
        counts = {n: v for n, v in _COUNTS.items() if n.startswith(prefix)}
        for name in counts:
            del _COUNTS[name]
    spans = _SPANS[:]
    del _SPANS[:len(spans)]
    return spans, counts


def gcups(query_len: int, target_len: int, batch: int, seconds: float
          ) -> float:
    """Naive-cell throughput: Q*T*B cells / s / 1e9 (the accounting the
    reference's published numbers imply; BASELINE.md)."""
    if seconds <= 0:
        return float("inf")
    return query_len * target_len * batch / seconds / 1e9
