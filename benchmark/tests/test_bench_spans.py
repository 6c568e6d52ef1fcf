"""The readers of the program's spans and counters (benchmark/spans.py): on
hand-made traces, and on a CPU traced run of each cell with the program's
registry enabled for the window."""

import json
import time
import types

import pytest

from benchmark import devtrace
from benchmark import run as R
from benchmark import spans as S


def _span(name, a, b):
    """A program span from a to b seconds."""
    return types.SimpleNamespace(name=name, start_ns=int(a * 1e9),
                                 end_ns=int(b * 1e9))


def _ctx(device, spans=None, counters=None, n_calls=2):
    tr = devtrace.Trace(device=device, spans=[("call", 1.0, 5.0),
                                              ("call", 5.0, 9.0)], host=[])
    ctx = types.SimpleNamespace(trace=tr, calls=[None] * n_calls)
    if spans is not None:
        ctx.spans = spans
    if counters is not None:
        ctx.counters = counters
    return ctx


def test_overlap_by_hand():
    assert S.overlap([(0, 2), (3, 5)], [(1, 4)]) == pytest.approx(2.0)
    assert S.overlap([(0, 1)], [(1, 2)]) == 0.0
    assert S.overlap([], [(0, 1)]) == 0.0
    assert S.overlap([(0, 10)], [(1, 2), (3, 4), (9, 12)]) == \
        pytest.approx(3.0)


def test_idle_under_a_span_is_clipped_to_the_window():
    # The window is [1, 9]; the span [0, 3] counts from 1: 2 s, 0.5 busy.
    ctx = _ctx([("k", 2.0, 2.5)], [_span("prep", 0.0, 3.0)])
    assert S.idle_ms(ctx, "prep") == pytest.approx(1e3 * 1.5 / 2)
    ctx = _ctx([], [_span("prep", 8.0, 12.0)])
    assert S.idle_ms(ctx, "prep") == pytest.approx(1e3 * 1.0 / 2)


def test_overlapping_device_intervals_and_spans_count_once():
    device = [("k1", 2.0, 3.0), ("k2", 2.5, 3.5), ("copy", 2.6, 2.7)]
    spans = [_span("prep", 2.0, 4.0), _span("prep", 3.0, 4.0),
             _span("other", 1.0, 9.0)]
    # Under prep: [2, 4], busy [2, 3.5]: 0.5 s idle over two calls.
    assert S.idle_ms(_ctx(device, spans), "prep") == pytest.approx(250.0)
    assert S.idle_s(device, S.intervals(spans, {"prep"}), 1.0, 9.0) == \
        pytest.approx(0.5)
    # Under "other": the window less the busy 1.5 s.
    assert S.idle_ms(_ctx(device, spans), "other") == pytest.approx(3250.0)


def test_readers_read_nothing_without_the_program():
    device = [("k", 2.0, 3.0)]
    assert S.idle_ms(_ctx(device), "prep") is None           # no spans
    assert S.idle_ms(_ctx(device, []), "prep") is None
    assert S.idle_ms(_ctx(device, [_span("x", 2, 3)]), "prep") is None
    ctx = _ctx(device, [_span("prep", 2, 3)])
    ctx.trace = None
    assert S.idle_ms(ctx, "prep") is None                    # untraced
    assert S.straggler_share(_ctx(device)) is None
    assert S.straggler_share(_ctx(device, counters={})) is None


def test_straggler_share_by_hand():
    ctx = _ctx([], counters={"map.reads_live": 400,
                             "map.stragglers_segmented": 4,
                             "map.stragglers_shared": 6,
                             "launch.reduce_lanes": 9})
    assert S.straggler_share(ctx) == pytest.approx(2.5)
    ctx.counters = {"map.reads_live": 10}
    assert S.straggler_share(ctx) == 0.0


def _traced_run(monkeypatch, workload):
    """A CPU traced run of a tiny cell with the edit that run.py still
    lacks (PERF.md, Open questions), made here by patching: run() calls
    wf.take_rungs() once after the warm calls and once after the window, and
    beside those two calls the edit enables the program's registry and
    drains it (take("map.")), then disables it and takes again; Context
    gains the taken spans and counters.  Returns the run's context."""
    from edlib_tpu_torch.ops import wavefront as wf
    from edlib_tpu_torch.utils import profiling
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    _, cfg, tr = R.cell_spec(bench, workload)
    if cfg["kind"] == "genome":
        cfg = dict(cfg, length=40000, repeats=[])
        tr = dict(tr, reads_per_call=200, batches=1,
                  sample=dict(tr["sample"], per_batch=8))
    else:
        cfg = dict(cfg, length=2000)
    taken, got = [], {}
    take_rungs = wf.take_rungs

    def take_then_enable():
        taken.append(profiling.take("map."))
        profiling.enable(len(taken) == 1)
        return take_rungs()

    class Context(R.Context):
        def __init__(self, *args):
            super().__init__(*args)
            self.spans, self.counters = taken[-1]
            got["ctx"] = self

    monkeypatch.setattr(wf, "take_rungs", take_then_enable)
    monkeypatch.setattr(R, "Context", Context)
    try:
        out = R.run(workload, 2**31 + 11, 0.01, True, device="cpu",
                    bench=bench, cfg=cfg, traffic=tr,
                    process_start=time.time(), log=lambda m: None)
    finally:
        profiling.enable(False)
    return bench, out, got["ctx"]


@pytest.mark.parametrize("workload", ["ecoli.illumina150", "chr1m.nw"])
def test_a_traced_run_reads_the_spans_in_its_cells(monkeypatch, workload):
    monkeypatch.setenv("EDLIB_TPU_QFILTER", "1")
    bench, out, ctx = _traced_run(monkeypatch, workload)
    assert out["correct"] is True
    roots = [s for s in ctx.spans if s.parent_id == 0]
    assert len(roots) == len(ctx.calls)
    if workload.startswith("ecoli"):
        assert S.idle_ms(ctx, "map_reads.prep") > 0
        assert S.straggler_share(ctx) is not None
        assert S.idle_ms(ctx, "nw_long.prep") is None
    else:
        assert S.idle_ms(ctx, "nw_long.prep") > 0
        assert S.idle_ms(ctx, "rung.init") > 0
        assert S.straggler_share(ctx) is None
    # Every accepted per-layer metric reads on this context what it reads
    # without the program's spans and counters.
    plain = types.SimpleNamespace(**{k: v for k, v in vars(ctx).items()
                                     if k not in ("spans", "counters")})
    plain.work = ctx.work
    plain.device_seconds = ctx.device_seconds
    for m in R.metrics_for(bench, workload, True):
        reader = R.load(R.HERE / "metrics" / f"{m['name']}.py")
        assert reader.read(plain) == reader.read(ctx), m["name"]
        if m["name"] in out["metrics"]:
            assert out["metrics"][m["name"]]["value"] == reader.read(plain)
