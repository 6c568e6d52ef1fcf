"""The redesigned hit-word sweeps on the CPU: hits_lanes' split-lane plan
(cores that own whole hit words, ops/cuda_kernel.hits_core and
split_cores(word_aligned=True)) and its plain emulation, and hits_eqstream's
word-parallel lane (hits_words_plain), against the plain versions and the
JAX package.

The CUDA kernels follow the same schedules on the card, where chip_smoke.py
holds them against their plain versions.  Every output is an integer (raw
hit words), so every comparison is exact.  Inputs come from numpy with a
fixed seed.  The Pallas kernels run in interpret mode at one to four words
(their unrolled bodies compile for minutes at eight); past four words the
word lane is held against jax_engine's score stream instead.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import edlib_tpu
import edlib_tpu_torch
from edlib_tpu.ops import jax_engine
from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck

NONE = -(1 << 30)      # a best no column reaches: a lane without hits


def _t(a):
    return torch.from_numpy(np.array(a, np.int32))


def _words(rng, shape):
    """Random uint32 bit words as int32 bit patterns."""
    return rng.randint(0, 1 << 32, shape, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


def _edge_windows(rng, B, T):
    """lo/hi with the edge lanes: hi = 0, an empty window, lo past hi, hi
    past the row, both past it, lo a multiple of 32, and ragged windows
    (lo mostly not a multiple of 32)."""
    lo = rng.randint(0, T // 2, B)
    hi = np.minimum(lo + rng.randint(1, T + 1, B), T)
    hi[0::7] = 0
    hi[1::7] = lo[1::7]
    lo[2::7] = hi[2::7] + 3
    hi[3::7] = T + 1 + rng.randint(0, 20, len(hi[3::7]))
    lo[4::7], hi[4::7] = T + 2, T + 9
    lo[5::7] -= lo[5::7] % 32
    return lo.astype(np.int32), hi.astype(np.int32)


def _lanes(rng, B, T, nw, shared, s1=5, rows=4):
    """Per-lane (or, shared, one) target rows and profiles, edge windows."""
    peq = _t(_words(rng, (rows, s1, nw)))
    tg = _t(rng.randint(0, s1, (1 if shared else rows, T)))
    lo, hi = _edge_windows(rng, B, T)
    prow = _t(rng.randint(0, rows, B))
    trow = _t(np.zeros(B) if shared else rng.randint(0, rows, B))
    return peq, tg, _t(lo), _t(hi), prow, trow


def _best(reduced, rng):
    """The reduce's best, with every 5th lane and a random few at NONE."""
    best = reduced[0].clone()
    best[::5] = NONE
    best[torch.from_numpy(rng.rand(best.shape[0]) < 0.1)] = NONE
    return best.contiguous()


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("nw,core", [(1, 32), (1, 40), (4, 96), (8, None),
                                     (2, 160)])
def test_hits_cores_own_whole_words(rng, nw, core):
    """The word-aligned plan: the core length is a multiple of 32, each
    lane's cores are disjoint, in order, start at multiples of 32 and cover
    [s rounded down to 32, end) exactly (s and end as split_cores), so every
    hit word the lane can mark lies in exactly one core; each sweep starts
    a halo before its core, at a multiple of 32."""
    B, T = 120, 2600
    lo, hi = _edge_windows(rng, B, T)
    c = ck.hits_core(B, T, nw, 0, core)
    assert c % 32 == 0 and c >= (core or 1) and c < T
    halo = ck.split_halo(nw)
    lane, c_lo, c_hi, start = ck.split_core_ranges(_t(lo), _t(hi), T, c,
                                                   halo, True)
    assert bool((c_lo % 32 == 0).all()) and bool((start % 32 == 0).all())
    assert torch.equal(start, (c_lo - halo).clamp(min=0))
    s, end, counts = ck.split_cores(_t(lo), _t(hi), T, c, True)
    for b in range(B):
        mine = lane == b
        assert int(mine.sum()) == int(counts[b])
        if not int(counts[b]):
            assert int(end[b]) <= int(s[b])
            continue
        spans = list(zip(c_lo[mine].tolist(), c_hi[mine].tolist()))
        s0 = int(ck.split_cores(_t(lo), _t(hi), T, c)[0][b])
        assert spans[0][0] == int(s[b]) == s0 - s0 % 32
        assert spans[-1][1] == int(end[b])
        assert all(a[1] == z[0] for a, z in zip(spans, spans[1:]))
        # Every column of [max(lo, 0), end), so every hit, in one core.
        words = [set(range(a // 32, -(-z // 32))) for a, z in spans]
        assert all(not (x & y) for x, y in zip(words, words[1:]))
        first = max(int(lo[b]), 0)
        assert first >= spans[0][0] or first >= int(end[b])


@pytest.mark.parametrize("nw,hin0,T,core", [(1, 1, 3000, None),
                                            (1, 1, 3000, 32),
                                            (9, 0, 3000, 32),
                                            (4, 0, 1024, None)])
def test_hits_plan_keeps_whole_lanes(nw, hin0, T, core):
    """hin0 = 1 (prefix-anchored), more than 8 words, and rows no longer
    than four halos keep one core a lane (the one-thread form), forced
    cores or not."""
    assert ck.hits_core(100, T, nw, hin0, core) >= T


@pytest.mark.parametrize("nw,hin0,shared", [
    (1, 0, False), (1, 1, True), (3, 0, True), (4, 0, False), (4, 1, False),
    (8, 0, True)])
def test_split_hits_plain_matches_hits_lanes_plain(rng, nw, hin0, shared):
    """The schedule's emulation == the plain hits over whole lanes, forced
    cores of 32, 64 and 96 columns, per-lane and shared rows, edge lanes,
    lanes without hits."""
    B, T = 16, 300
    ops = _lanes(rng, B, T, nw, shared)
    best = _best(ck.reduce_lanes_plain(*ops, hin0), rng)
    want = ck.hits_lanes_plain(*ops, best, hin0)
    assert bool((want != 0).any())
    for core in (32, 64, 96):
        got = ck.split_hits_plain(*ops, best, hin0, core=core)
        assert torch.equal(got, want), core


def test_split_hits_plain_matches_pallas_per_lane(rng):
    """The emulation at cores of 32 columns on the operands the port's
    reduce_flat_device hands hits_lanes == the Pallas per-lane hits kernel
    in interpret mode (raw hit words), a window reaching past T."""
    B, T, sigma, nw = 9, 200, 4, 1
    q = rng.randint(0, sigma, (B, 30)).astype(np.int32)
    qlens = rng.randint(1, 31, B).astype(np.int32)
    peq = pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens), sigma, nw)
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    lo, hi = _edge_windows(rng, B, T)
    hi[6] = T + 30
    want = pk.reduce_flat_device(peq, jnp.asarray(tg), jnp.asarray(lo),
                                 jnp.asarray(hi), hin0=0, chunk=32,
                                 want_hits=True, interpret=True)
    tpeq = convert.bit_words(np.asarray(peq))
    rows = _t(np.arange(B))
    got = ck.split_hits_plain(tpeq, ck._pad_cols(_t(tg), sigma, 32), _t(lo),
                              _t(hi), rows, rows, _t(np.asarray(want[0])), 0,
                              core=32)
    assert ck.hits_core(B, got.shape[1] * 32, nw, 0, 32) == 32
    np.testing.assert_array_equal(_bits(got[:, :-(-T // 32)].numpy()),
                                  np.asarray(want[4]))
    assert np.asarray(want[4]).any()


def test_split_hits_plain_matches_pallas_shared(rng):
    """The shared form (one target row, trow = 0) at cores of 32 columns ==
    pk.hits_flat_device_shared in interpret mode, HW."""
    B, L, sigma, nw = 6, 150, 4, 1
    q = rng.randint(0, sigma, (B, 25)).astype(np.int32)
    qlens = rng.randint(10, 26, B).astype(np.int32)
    peq = pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens), sigma, nw)
    target = rng.randint(0, sigma, L).astype(np.int32)
    lo = (32 - qlens).astype(np.int32)
    hi = lo + L
    tpeq = convert.bit_words(np.asarray(peq))
    row = ck._shared_row(_t(target), sigma, 32)
    rows = _t(np.arange(B))
    zero = _t(np.zeros(B))
    best = ck.reduce_lanes_plain(tpeq, row, _t(lo), _t(hi), rows, zero, 0)[0]
    best[2] = NONE
    want = pk.hits_flat_device_shared(
        peq, jnp.asarray(target), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(best.numpy()), hin0=0, fill_sym=sigma, chunk=32,
        interpret=True)
    got = ck.split_hits_plain(tpeq, row, _t(lo), _t(hi), rows, zero, best, 0,
                              core=32)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_array_equal(_bits(got.numpy()), np.asarray(want))
    assert np.asarray(want).any()


def test_short_halo_would_change_a_hit_word(monkeypatch):
    """A fixed case whose best alignment ends at column 64, the first column
    of a core of 32: a 32-bp read planted with three inserted symbols, so
    the alignment (cost 3) spans columns 30-64 and needs a sweep from
    column 30.  The planned halo (2R = 64) gives the plain hit words; a
    halo of 33, one column short of what this alignment needs, loses the
    hit at column 64, and one of 34 keeps it."""
    rng = np.random.RandomState(3)
    q = rng.randint(0, 4, 32).astype(np.int32)
    planted = (list(q[:8]) + [int(rng.randint(4))] + list(q[8:16])
               + [int(rng.randint(4))] + list(q[16:24])
               + [int(rng.randint(4))] + list(q[24:]))
    t = np.concatenate([rng.randint(0, 4, 65 - len(planted)), planted,
                        rng.randint(0, 4, 60)]).astype(np.int32)
    peq = ck.build_peq_device(_t(q[None]), _t([32]), 4, 1)
    tg = _t(t[None])
    lanes = (_t([0]), _t([tg.shape[1]]), _t([0]), _t([0]))
    best = ck.reduce_lanes_plain(peq, tg, *lanes, 0)[0]
    want = ck.hits_lanes_plain(peq, tg, *lanes, best, 0)
    assert int(best) == 3 and int(want[0, 2]) & 1           # column 64
    assert torch.equal(ck.split_hits_plain(peq, tg, *lanes, best, 0, core=32),
                       want)
    monkeypatch.setattr(ck, "split_halo", lambda n_words: 33)
    short = ck.split_hits_plain(peq, tg, *lanes, best, 0, core=32)
    assert not int(short[0, 2]) & 1
    monkeypatch.setattr(ck, "split_halo", lambda n_words: 34)
    assert torch.equal(ck.split_hits_plain(peq, tg, *lanes, best, 0, core=32),
                       want)


def _stream_case(rng, B, T, nw, sigma):
    peq = _words(rng, (B, sigma + 1, nw))
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    lo, hi = _edge_windows(rng, B, T)
    return peq, tg, lo, hi


@pytest.mark.parametrize("nw,hin0,T", [(2, 0, 150), (3, 1, 37), (4, 0, 5),
                                       (4, 1, 131)])
def test_hits_words_plain_matches_pallas(rng, nw, hin0, T):
    """The word lane's hits == the Pallas eq-stream kernels' hit words in
    interpret mode (reduce_flat_device_eqstream's best), edge lanes, ragged
    rows and a row shorter than the words (convert.bit_words views the
    JAX uint32 profile).  Windows end at the row (the TPU kernels would
    scan their chunk filler past it; the port's stream stops at T)."""
    B, sigma = 13, 20
    peq, tg, lo, hi = _stream_case(rng, B, T, nw, sigma)
    hi = np.minimum(hi, T)
    want = pk.reduce_flat_device_eqstream(
        jnp.asarray(peq.view(np.uint32)), jnp.asarray(tg), jnp.asarray(lo),
        jnp.asarray(hi), hin0=hin0, chunk=32, want_hits=True, interpret=True)
    eq_t = ck.eqstream_gather(convert.bit_words(peq.view(np.uint32)),
                              _t(tg)).permute(1, 2, 0)
    got = ck.hits_words_plain(eq_t, _t(lo), _t(hi), _t(np.asarray(want[0])),
                              hin0)
    np.testing.assert_array_equal(_bits(got.numpy()), np.asarray(want[4]))


@pytest.mark.parametrize("nw,hin0,T", [(5, 0, 101), (6, 1, 64), (7, 0, 33),
                                       (8, 1, 197), (8, 0, 2)])
def test_hits_words_plain_matches_sweep_scores(rng, nw, hin0, T):
    """Past four words (the Pallas kernels compile for minutes there) the
    word lane's hits == the hit words of jax_engine's score stream at each
    lane's best over [lo, hi), edge lanes and lanes without hits included;
    and == the plain hits."""
    B, sigma = 14, 20
    peq, tg, lo, hi = _stream_case(rng, B, T, nw, sigma)
    scores = np.asarray(jax_engine.sweep_scores(
        jnp.asarray(peq.view(np.uint32)), jnp.asarray(tg), hin0=hin0))
    best = np.array([scores[b, max(lo[b], 0):min(hi[b], T)].min()
                     if min(hi[b], T) > max(lo[b], 0) else NONE
                     for b in range(B)], np.int32)
    best[::5] = NONE
    want = np.zeros((B, -(-T // 32)), np.uint32)
    for b in range(B):
        for c in range(max(0, lo[b]), min(T, hi[b])):
            if scores[b, c] == best[b]:
                want[b, c // 32] |= np.uint32(1) << np.uint32(c % 32)
    eq_t = ck.eqstream_gather(convert.bit_words(peq.view(np.uint32)),
                              _t(tg)).permute(1, 2, 0)
    got = ck.hits_words_plain(eq_t, _t(lo), _t(hi), _t(best), hin0)
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    assert torch.equal(got, ck.hits_eqstream_plain(eq_t, _t(lo), _t(hi),
                                                   _t(best), hin0))


def test_word_lanes_plain_keeps_its_scores(rng):
    """word_lanes_plain, now over the shared tile schedule, still equals
    the plain score stream and carry form."""
    B, T, nw = 7, 70, 3
    peq = _t(_words(rng, (4, 5, nw)))
    tg = _t(rng.randint(0, 5, (4, T)))
    prow, trow = _t(rng.randint(0, 4, B)), _t(rng.randint(0, 4, B))
    pv0 = _t(_words(rng, (B, nw)))
    mv0 = _t(_words(rng, (B, nw))) & ~pv0
    s0 = _t(rng.randint(0, 300, B))
    got = ck.word_lanes_plain(peq, tg, prow, trow, 1, pv0, mv0, s0)
    want = ck.sweep_scores_resume_plain(peq, tg, prow, trow, pv0, mv0, s0, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("buf,want", [
    ((3, 560, 128, 0, 7, 15200, 0, 0, 0, 0),
     dict(form="cores", blocks=560, threads=71680, block=128, cores=7,
          core=15200)),
    ((1, 512, 32, 4, 0, 0, 0, 0, 0, 0),
     dict(form="words", blocks=512, threads=16384, block=32, width=4)),
    ((0, 160, 64, 0, 0, 0, 0, 0, 0, 0),
     dict(form="thread", blocks=160, threads=10240, block=64))])
def test_hit_plans_decode(buf, want):
    """The plans myers_hits_lanes and myers_hits_eqstream report decode to
    their forms; on the CPU the wrappers leave `plan` as it was."""
    got = {"stale": 1}
    ck._fill_plan(got, buf)
    assert got == want
    plan = {}
    z = _t(np.zeros(2))
    ck.hits_lanes(_t(np.zeros((1, 5, 1))), _t(np.zeros((1, 40))), z, z + 40,
                  z, z, z, 0, plan=plan)
    ck.hits_eqstream(_t(np.zeros((40, 2, 2))), z, z + 40, z, 0, plan=plan)
    assert plan == {}


def test_version_matches_the_reference():
    """The port names the version of the package it ports."""
    assert edlib_tpu_torch.__version__ == edlib_tpu.__version__ == "0.1.0"
