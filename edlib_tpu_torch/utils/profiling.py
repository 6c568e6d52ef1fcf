"""Profiling helpers (the port of edlib_tpu/utils/profiling.py).

The reference's only instrumentation is clock() around loops
(aligner.cpp:156, 262-264) and a -r repeat flag.  Here: wall timers, GCUPS
accounting, and a torch.profiler trace context for device timelines.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


def gcups(query_len: int, target_len: int, batch: int, seconds: float
          ) -> float:
    """Naive-cell throughput: Q*T*B cells / s / 1e9 (the accounting the
    reference's published numbers imply; BASELINE.md)."""
    if seconds <= 0:
        return float("inf")
    return query_len * target_len * batch / seconds / 1e9


@dataclass
class Timer:
    """Accumulating wall-clock timer with named sections.

    >>> t = Timer()
    >>> with t.section("sweep"):
    ...     work()
    >>> t.totals["sweep"]
    """

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total*1000:.2f}ms "
                         f"({n} calls, {total/n*1000:.3f}ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler over the block (CPU, and CUDA where a card is
    present), its Chrome trace written to log_dir/trace.json; a no-op for
    None."""
    if log_dir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
