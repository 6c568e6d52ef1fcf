"""The generator: deterministic per seed, reads of the stated shape, pairs
with the stated edits."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import gen
from benchmark.reference import hw_map

HERE = Path(__file__).resolve().parents[1]
SEED = 2**31 + 977          # past 32 signed bits, as run seeds may be


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _traffic(name, **kw):
    return dict(json.loads((HERE / "traffic" / f"{name}.json").read_text()),
                **kw)


def _small_genome(**kw):
    return dict(_cfg("ecoli_k12"), length=60_000, repeats=[
        {"name": "op", "length": 1000, "copies": 4},
        {"name": "is", "length": 300, "copies": 3}], **kw)


def test_configs_state_the_deployment_sizes():
    e, c = _cfg("ecoli_k12"), _cfg("chr1m_pair")
    assert e["length"] == 4_641_652
    assert sum(r["copies"] for r in e["repeats"] if r["name"] != "operon") \
        == 40
    assert {"name": "operon", "length": 5000, "copies": 7} in e["repeats"]
    assert all(800 <= r["length"] <= 1500 for r in e["repeats"]
               if r["name"] != "operon")
    assert c["length"] == 1_000_000 and c["edit_rate"] == 0.03
    tr = _traffic("illumina150")
    assert (tr["reads_per_call"], tr["read_len"], tr["k"]) == (65536, 150, -1)
    assert tr["random_share"] == 0.01
    assert _traffic("nw_k")["k"] == 50_000 and _traffic("nw")["k"] == -1


def test_deterministic_per_seed():
    cfg, tr = _small_genome(), _traffic("illumina150", reads_per_call=300)
    g1, g2 = gen.make_genome(cfg, SEED), gen.make_genome(cfg, SEED)
    assert np.array_equal(g1.codes, g2.codes)
    assert np.array_equal(g1.repeat_spans, g2.repeat_spans)
    g3 = gen.make_genome(cfg, SEED + 1)
    assert not np.array_equal(g1.codes, g3.codes)
    # The repeats keep their places from seed to seed.
    assert np.array_equal(g1.repeat_spans, g3.repeat_spans)
    r1, r2 = gen.make_reads(g1, tr, SEED, 0), gen.make_reads(g2, tr, SEED, 0)
    assert r1.reads == r2.reads
    assert r1.reads != gen.make_reads(g1, tr, SEED, 1).reads
    pc = dict(_cfg("chr1m_pair"), length=5000)
    a, b = gen.make_pair(pc, SEED, 0), gen.make_pair(pc, SEED, 0)
    assert (a.query, a.target) == (b.query, b.target)
    assert gen.make_pair(pc, SEED, 0).query != gen.make_pair(pc, SEED,
                                                             1).query


@pytest.mark.parametrize("random_share", [0.01, 0.5])
def test_reads_shape_and_shares(random_share):
    g = gen.make_genome(_small_genome(), SEED)
    tr = _traffic("illumina150", reads_per_call=2000,
                  random_share=random_share)
    b = gen.make_reads(g, tr, SEED, 0)
    assert all(len(r) == 150 and set(r) <= set(b"ACGT") for r in b.reads)
    assert int(b.is_random.sum()) == round(tr["random_share"] * 2000)
    assert (b.origin[b.is_random] == -1).all()
    assert (b.origin[~b.is_random] >= 0).all()
    # Every genome read lies within 3 edits (2% of 150) of its origin.
    mapped = np.nonzero(~b.is_random)[0][:40]
    for i in mapped:
        o = int(b.origin[i])
        window = g.codes[o:o + 160]
        best, _ = hw_map.best_ends(b.codes[i:i + 1], window, "cpu")
        assert best[0] <= 3


def test_edit_mix():
    kinds = gen.edit_plan(gen.rng_for(SEED, 9), 100_000, 3,
                          (0.85, 0.075, 0.075))
    share = np.bincount(kinds.ravel(), minlength=3) / kinds.size
    assert np.allclose(share, [0.85, 0.075, 0.075], atol=0.005)


def test_repeats_planted():
    cfg = _small_genome()
    g = gen.make_genome(cfg, SEED)
    spans = g.repeat_spans
    assert len(spans) == 7
    assert (spans[1:, 0] >= spans[:-1, 1]).all()       # disjoint
    ops = [g.codes[a:b] for a, b in spans if b - a == 1000]
    # Two copies of one unit differ in at most 2 x 0.5% of their bases.
    assert (ops[0] != ops[1]).sum() <= 10
    assert (ops[0] != ops[1]).sum() > 0


def test_pair_edits():
    cfg = dict(_cfg("chr1m_pair"), length=3000)
    p = gen.make_pair(cfg, SEED, 0)
    assert len(p.target) == 3000 and len(p.query) == 3000   # ins == del
    assert p.n_edits == 90
    from benchmark.reference import nw_wfa
    d = nw_wfa.distances(p.q_codes[None], p.t_codes[None], "cpu")[0]
    assert 0 < d <= 90


@pytest.mark.parametrize("name", ["illumina150", "nw", "nw_k"])
def test_traffic_names_its_sources_and_assumptions(name):
    tr = _traffic(name)
    assert tr["source"] and all(isinstance(x, str) for x in tr["source"])
    assert tr["assumed"] and all(isinstance(x, str) for x in tr["assumed"])
