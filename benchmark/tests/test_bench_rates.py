"""The window and its rates: a closed loop of one caller whose window closes
when the call in flight returns, every rate over all the work and all the
window, a stall included."""

import json
import time
import types
from pathlib import Path

import pytest

from benchmark import run as R

ROOT = Path(__file__).resolve().parents[2]


class StallEntry:
    """Calls of 0.05 s, the window's third stalling 0.6 s; 1,000 reads a
    call; two inputs of one shape, so the set-up warms one."""
    unit = "reads"
    n_inputs = 2
    k = -1

    def __init__(self):
        self.made = []

    def shape(self, i):
        return (1000, 150)

    def call(self, i):
        self.made.append(i)
        time.sleep(0.6 if len(self.made) == 1 + 3 else 0.05)
        return i

    def work(self, i):
        return {"reads": 1000, "pairs": 1, "cells": 10**9}

    def check(self, answers, device, control=False):
        return {"ok": (0, 0, "<=")}


@pytest.fixture
def stalled(monkeypatch):
    entry = StallEntry()
    real_load = R.load

    def load(path):
        if path.parent.name == "entries":
            return types.SimpleNamespace(make=lambda *a: entry)
        return real_load(path)
    monkeypatch.setattr(R, "load", load)
    return entry


@pytest.mark.parametrize("workload,metric,per_call",
                         [("ecoli.illumina150", "reads_per_s", 1000),
                          ("chr1m.nw", "gcups", 1.0)])
def test_rate_over_a_window_with_a_stall(stalled, workload, metric,
                                         per_call):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    t0 = time.time()
    out = R.run(workload, 1, 0.3, False, device="cpu", bench=bench,
                process_start=t0, log=lambda m: None)
    # Warm-up: the one shape's first input; then calls until one ends past
    # 0.3 s: the stall (call 3) is in flight at 0.3 s and closes the window.
    assert stalled.made[:1] == [0]
    n_calls = len(stalled.made) - 1
    assert n_calls == 3
    assert stalled.made[1:] == [0, 1, 2]       # from the first input on
    rate = out["metrics"][metric]["value"]
    window = n_calls * per_call / rate
    assert 0.7 <= window <= 0.9            # 0.05 + 0.05 + 0.6, and overhead
    # The rate divides all the work by the whole window, the stall in it.
    assert rate < n_calls * per_call / 0.7
    assert out["metrics"]["setup_s"]["value"] >= 0.05     # the warm call
    assert out["attempted"] == n_calls * 1000      # the entry's unit
    assert out["correct"] is True
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("shapes,warmed", [
    ([(65536, 150)] * 2, [0]),
    ([(10**6, 10**6)] * 4, [0]),
    ([(5, 7), (5, 7), (9, 9), (5, 7), (9, 9)], [0, 2]),
])
def test_setup_warms_each_shape_once(shapes, warmed):
    entry = types.SimpleNamespace(n_inputs=len(shapes),
                                  shape=lambda i: shapes[i])
    assert R.warm_inputs(entry) == warmed
