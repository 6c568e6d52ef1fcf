"""A run with the timed path broken underneath comes out not correct, and so
does each cell's control; a sound run at the same size comes out correct.

Runs go through run.run() past its look for a card, on the CPU (the port's
plain versions) at sizes a test run holds.  Faults the cells can have: an
answer altered where it is produced; half of a batch left out; a step of
the wavefront that returns its state unchanged (no cell crosses chips).
The controls' tile and band shrink with the sizes: at 40 kbp, 4,096-column
tiles cut too few of 40 sampled reads, and 3 kbp pairs drift too little
from the diagonal, to fail every seed."""

import json
import time
from pathlib import Path

import numpy as np
import pytest

import edlib_tpu_torch
from benchmark import run as R
from edlib_tpu_torch.ops import cuda_kernel as ck

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 4242


def tiny(workload):
    _, cfg, tr = R.cell_spec(BENCH, workload)
    if cfg["kind"] == "genome":
        cfg = dict(cfg, length=40_000, repeats=[
            {"name": "op", "length": 1000, "copies": 3}])
        tr = dict(tr, reads_per_call=256, batches=1,
                  sample=dict(tr["sample"], per_batch=40))
    else:
        cfg = dict(cfg, length=3000)
        tr = dict(tr, pairs=2, k=min(tr["k"], 200) if tr["k"] >= 0 else -1)
    return cfg, tr


def drive(workload, seed=SEED):
    cfg, tr = tiny(workload)
    return R.run(workload, seed, 0.01, False, device="cpu", bench=BENCH,
                 cfg=cfg, traffic=tr, process_start=time.time(),
                 log=lambda m: None)


def after_warmup(monkeypatch, name, broken):
    """Replace the port's entry point by `broken` once the set-up has made
    its warm call (one a shape: tiny() makes 1 batch, or 2 pairs of one
    length)."""
    real = getattr(edlib_tpu_torch, name)
    warm = 1
    seen = []

    def call(*a, **kw):
        seen.append(1)
        return (real if len(seen) <= warm else broken(real))(*a, **kw)
    monkeypatch.setattr(edlib_tpu_torch, name, call)


@pytest.mark.parametrize("workload", ["ecoli.illumina150", "chr1m.nw",
                                      "chr1m.nw_k"])
def test_sound_run_is_correct(workload):
    out = drive(workload)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0


def test_map_answer_altered(monkeypatch):
    from benchmark import gen
    cfg, tr = tiny("ecoli.illumina150")
    batch = gen.make_reads(gen.make_genome(cfg, SEED), tr, SEED, 0)
    first_random = int(np.nonzero(batch.is_random)[0][0])   # sampled

    def altered(real):
        def call(*a, **kw):
            best, pos = real(*a, **kw)
            best = best.copy()
            best[first_random] += 1
            return best, pos
        return call
    after_warmup(monkeypatch, "map_reads", altered)
    out = drive("ecoli.illumina150")
    assert out["correct"] is False
    assert out["checks"]["mismatched_reads"]["value"] == 1


def test_map_half_the_batch_left_out(monkeypatch):
    def half(real):
        def call(reads, *a, **kw):
            n = len(reads) // 2
            best, pos = real(reads[:n], *a, **kw)
            fill = np.full(len(reads) - n, -1, np.int64)
            return np.concatenate([best, fill]), np.concatenate([pos, fill])
        return call
    after_warmup(monkeypatch, "map_reads", half)
    out = drive("ecoli.illumina150")
    assert out["correct"] is False
    assert out["checks"]["mismatched_reads"]["value"] > 0


@pytest.mark.parametrize("workload", ["chr1m.nw", "chr1m.nw_k"])
def test_nw_answer_altered(monkeypatch, workload):
    after_warmup(monkeypatch, "nw_distance_long",
                 lambda real: lambda *a, **kw: real(*a, **kw) + 1)
    out = drive(workload)
    assert out["correct"] is False
    assert out["checks"]["distance_gap"]["value"] == 1


@pytest.mark.parametrize("workload", ["chr1m.nw", "chr1m.nw_k"])
def test_nw_state_left_unchanged(monkeypatch, workload):
    def frozen(real):
        def call(*a, **kw):
            with monkeypatch.context() as m:
                m.setattr(ck, "wavefront_banded",
                          lambda t, peq, state, *x, **y: state)
                return real(*a, **kw)
        return call
    after_warmup(monkeypatch, "nw_distance_long", frozen)
    out = drive(workload)
    assert out["correct"] is False


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_controls_are_not_correct(monkeypatch, seed):
    mr = R.load(R.HERE / "entries" / "map_reads.py")
    nw = R.load(R.HERE / "entries" / "nw_distance_long.py")
    monkeypatch.setattr(mr, "CONTROL_TILE", 256)
    monkeypatch.setattr(nw, "CONTROL_BAND", 2)
    for workload, mod in (("ecoli.illumina150", mr), ("chr1m.nw", nw),
                          ("chr1m.nw_k", nw)):
        cfg, tr = tiny(workload)
        checks = mod.make(cfg, tr, seed, "cpu").check([], "cpu",
                                                      control=True)
        gap = checks.get("mismatched_reads", checks.get("distance_gap"))
        assert gap[0] > gap[1], (workload, checks)
