"""The port's span and counter registry (edlib_tpu_torch/utils/profiling.py)
and the spans of map_reads and nw_distance_long, on the CPU with the plain
versions of the kernels at tiny sizes."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import edlib_tpu_torch
from edlib_tpu_torch import encode
from edlib_tpu_torch import mapping as tmp
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops import wavefront as twf
from edlib_tpu_torch.utils import profiling

DNA = b"ACGT"


@pytest.fixture
def tracing():
    """Tracing on for the test, nothing left over before or after."""
    profiling.take("")
    twf.take_rungs()
    profiling.enable(True)
    yield
    profiling.enable(False)
    profiling.take("")


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_one_call_id_per_root(tracing):
    with profiling.span("a") as a:
        with profiling.span("b", x=1) as b:
            with profiling.span("c"):
                pass
            b.set(y=2)
        with profiling.span("d"):
            pass
    with profiling.span("e"):
        with profiling.span("f"):
            pass
    spans, _ = profiling.take("")
    s = {sp.name: sp for sp in spans}
    assert [sp.name for sp in spans] == ["c", "b", "d", "a", "f", "e"]
    assert s["a"].parent_id == 0 and s["e"].parent_id == 0
    assert s["b"].parent_id == s["d"].parent_id == s["a"].span_id
    assert s["c"].parent_id == s["b"].span_id
    assert s["f"].parent_id == s["e"].span_id
    assert len({s[n].call_id for n in "abcd"}) == 1
    assert s["e"].call_id == s["f"].call_id != s["a"].call_id
    assert len({sp.span_id for sp in spans}) == 6
    assert s["b"].attrs == {"x": 1, "y": 2} and s["a"].attrs == {}
    assert s["a"].start_ns <= s["b"].start_ns <= s["c"].start_ns \
        <= s["c"].end_ns <= s["b"].end_ns <= s["d"].start_ns \
        <= s["d"].end_ns <= s["a"].end_ns <= s["e"].start_ns
    assert a is not b


def test_a_span_ends_on_an_exception(tracing):
    with pytest.raises(KeyError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise KeyError("inside")
    with profiling.span("next"):
        pass
    spans, _ = profiling.take("")
    assert [s.name for s in spans] == ["inner", "outer", "next"]
    assert spans[2].parent_id == 0 and spans[2].call_id != spans[1].call_id


def test_a_child_span_is_recorded_only_under_an_open_span(tracing):
    with profiling.child("alone"):
        with profiling.span("root"):
            with profiling.child("under", k=3) as c:
                c.set(answered=False)
    with profiling.child("after"):
        pass
    spans, _ = profiling.take("")
    assert [s.name for s in spans] == ["under", "root"]
    assert spans[0].parent_id == spans[1].span_id != 0
    assert spans[0].call_id == spans[1].call_id
    assert spans[0].attrs == {"k": 3, "answered": False}


def test_nothing_is_recorded_while_tracing_is_off():
    profiling.enable(False)
    profiling.take("")
    first = profiling.span("a", k=1)
    assert profiling.span("b") is first        # the shared null context
    with first as s:
        s.set(answered=True)
        with profiling.span("c"):
            pass
        with profiling.child("d"):
            pass
    assert profiling.child("e") is first
    profiling.count("x", 3)                    # counters count regardless
    assert profiling.take("") == ([], {"x": 3})


def test_take_drains_spans_and_the_counters_asked_for(tracing):
    with profiling.span("a"):
        profiling.count("map.n")
        profiling.count("map.n", 2)
        profiling.count("launch.reduce_lanes")
    spans, counts = profiling.take("map.")
    assert [s.name for s in spans] == ["a"] and counts == {"map.n": 3}
    assert profiling.take("map.") == ([], {})
    assert profiling.counter("map.n") == 0
    # Counters of other readers are left as they were.
    assert ck.launch_counts()["reduce_lanes"] == 1
    assert profiling.take("") == ([], {"launch.reduce_lanes": 1})
    assert profiling.take("") == ([], {})


def test_counters_reset_by_prefix_and_the_views():
    profiling.take("")
    profiling.count("launch.reduce_lanes", 2)
    profiling.count("path_route.host", 5)
    profiling.count("map.reads_live", 7)
    assert ck.launch_counts()["reduce_lanes"] == 2
    assert set(ck.launch_counts()) == {f.__name__ for f in ck.KERNELS}
    from edlib_tpu_torch import batch as tb
    assert tb.path_route_counts() == {"capture": 0, "host": 5}
    ck.reset_launch_counts()
    tb.reset_path_route_counts()
    assert sum(ck.launch_counts().values()) == 0
    assert tb.path_route_counts() == {"capture": 0, "host": 0}
    assert profiling.take("") == ([], {"map.reads_live": 7})


def test_counts_from_many_threads_are_not_lost():
    import sys
    import threading
    profiling.take("")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [profiling.count("t") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.take("t")[1] == {"t": 16 * 2000}


def test_a_profiler_event_lies_inside_its_span(tracing):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("work"):
            torch.ones(1000).sum()
    (sp,), _ = profiling.take("")
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::sum"]
    assert events
    for e in events:
        assert sp.start_ns <= e.start_ns() <= e.end_ns() <= sp.end_ns


MAP_SPANS = {"map_reads", "map_reads.prep", "map_reads.index",
             "qfilter.filter_verify", "map_reads.stragglers",
             "map_reads.fallback_segmented", "map_reads.fallback_shared",
             "map_reads.finish"}


def test_map_reads_spans_and_straggler_counters(rng, monkeypatch,
                                                tracing):
    """The forced filter at maxc 1 with two reads granted the segmented
    fallback: every documented span under one root, and the straggler
    counters equal to what each fallback was handed."""
    monkeypatch.setenv("EDLIB_TPU_QFILTER", "1")
    monkeypatch.setenv("EDLIB_TPU_QFILTER_MAXC", "1")
    monkeypatch.setattr(tmp, "_SEG_FB_B", 2)
    handed = {"segmented": 0, "shared": 0}
    seg_fb, shared = tmp._segmented_fallback, tmp._sweep_reads_shared

    def seg_spy(q_arr, *a, **kw):
        handed["segmented"] += q_arr.shape[0]
        return seg_fb(q_arr, *a, **kw)

    def shared_spy(read_ids, *a, **kw):
        handed["shared"] += len(read_ids)
        return shared(read_ids, *a, **kw)

    monkeypatch.setattr(tmp, "_segmented_fallback", seg_spy)
    monkeypatch.setattr(tmp, "_sweep_reads_shared", shared_spy)
    target = bytes(rng.choice(list(DNA), 6000).tolist())
    reads = []
    for _ in range(6):
        s = rng.randint(0, 6000 - 80)
        r = bytearray(target[s:s + 80])
        r[rng.randint(0, 80)] = DNA[rng.randint(0, 4)]
        reads.append(bytes(r))
    reads += [b"ACGT" * 20, b"AAAA" * 20] * 2
    got = edlib_tpu_torch.map_reads(reads, target, device="cpu")
    spans, counts = profiling.take("map.")
    by = _by_name(spans)
    assert set(by) == MAP_SPANS
    (root,) = by["map_reads"]
    assert root.parent_id == 0
    for s in spans:
        assert s.call_id == root.call_id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        if s is not root:
            assert s.parent_id == root.span_id, s.name
    # Entry, then the filter's before and after the index lookup.
    assert len(by["map_reads.prep"]) == 3
    assert handed["segmented"] == 2 and handed["shared"] > 0
    assert counts["map.reads_live"] == len(reads)
    assert counts["map.stragglers_segmented"] == handed["segmented"]
    assert counts["map.stragglers_shared"] == handed["shared"]
    profiling.enable(False)
    want = edlib_tpu_torch.map_reads(reads, target, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert profiling.take("")[0] == []


def test_nw_distance_long_has_a_rung_span_per_rung(rng, tracing):
    q = bytes(rng.choice(list(DNA), 300).tolist())
    t = bytes(rng.choice(list(DNA), 400).tolist())
    d = edlib_tpu_torch.nw_distance_long(q, t, device="cpu")
    assert edlib_tpu_torch.nw_distance_long(q, t, k=d - 1, device="cpu") \
        == -1
    spans, _ = profiling.take("")
    rungs = twf.take_rungs()
    roots = [s for s in spans if s.parent_id == 0]
    assert [s.name for s in roots] == ["nw_distance_long"] * 2
    rung_spans = sorted((s for s in spans if s.name == "rung"),
                        key=lambda s: s.start_ns)
    assert len(rungs) == len(rung_spans) >= 3        # 64, 128 fail
    assert [(r["k"], r["answered"]) for r in rungs] == \
        [(s.attrs["k"], s.attrs["answered"]) for s in rung_spans]
    assert rungs[-1]["k"] == d - 1 and not rungs[-1]["answered"]
    ids = {s.span_id: s for s in spans}

    def root_of(s):
        while s.parent_id:
            s = ids[s.parent_id]
        return s

    for s in spans:
        if s.name == "rung":
            assert ids[s.parent_id].name == "nw_distance_long"
        elif s.name.startswith("rung."):
            assert ids[s.parent_id].name == "rung"
        elif s.name == "nw_long.prep":
            assert ids[s.parent_id].name == "nw_distance_long"
        else:
            assert s.name == "nw_distance_long"
        assert s.call_id == root_of(s).call_id
    by = _by_name(spans)
    assert len(by["nw_long.prep"]) == 2              # one a call
    assert len(by["rung.init"]) == len(by["rung.segments"]) == len(rungs)
    # A band that dies before the window holds the bottom word fetches
    # nothing.
    assert 1 <= len(by["rung.result"]) <= len(rungs)


def test_routes_without_a_root_span_record_none(rng, tracing):
    """The ladder's spans are children: SHW and the banded wavefront reached
    from elsewhere (align's NW route past the wavefront gate) open no root
    and record nothing."""
    q = bytes(rng.choice(list(DNA), 200).tolist())
    t = bytes(rng.choice(list(DNA), 300).tolist())
    edlib_tpu_torch.shw_best_long(q, t, device="cpu")
    q_ids, t_ids, alphabet = encode.transform_sequences(q, t)
    wf = twf.BandedWavefront(device="cpu")
    d = wf.nw_distance(q_ids, t_ids, len(alphabet))
    assert wf.nw_distance(q_ids, t_ids, len(alphabet), cap=d) == d
    assert len(twf.take_rungs()) >= 2
    assert profiling.take("") == ([], {})
