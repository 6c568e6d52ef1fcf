"""The redesigned banded SHW reduce and eq-stream reduce on the CPU:
shw_banded's word-parallel band (shw_banded_words_plain, the band emulation
that nw_banded_words_plain and shw_banded_hits_words_plain also read) and
reduce_eqstream's word-parallel lane (reduce_eqstream_words_plain, the
stream schedule that hits_words_plain also reads), against the plain
versions and the JAX package, and the forms the wrappers plan.

The CUDA kernels follow the same schedules on the card, where chip_smoke.py
holds them against their plain versions.  There each thread of a lane's
segment reduces the columns it scores (every W-th column of a tile) and the
segment merges the partial reductions (merge_words: the least best, the
first and last columns reaching it); the emulations reduce the same scores
in column order, and test_the_segment_merge_is_the_column_order_reduction
holds the merge rule equal to that on the band's scores, ties across
threads included.  Every output is an integer (banded values above k and
_BIG included), so every comparison is exact.  Inputs come from numpy with
a fixed seed.  The Pallas banded reduce keeps its loops rolled in interpret
mode and compiles in about a second at any width; the Pallas eq-stream
reduce runs at two words (its unrolled body compiles for minutes at eight).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck

S1 = 5                 # banded profiles: four symbols and the wildcard
BIG = ck._BIG


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _words(rng, shape):
    """Random uint32 bit words as uint32 (JAX) and their int32 patterns."""
    w = rng.randint(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return w, torch.from_numpy(w.view(np.int32))


# --------------------------------------------------------------------------
# #7 shw_banded: the word-parallel band
# --------------------------------------------------------------------------


def _woff(n_chunks, nw, n_win, first, slides):
    """Window offsets from woff[0] = first with the given slides at the
    chunk boundaries (cycled), capped at the bottom word NW - n_win, the
    last chunk at the bottom so most lanes are read there."""
    steps = [slides[i % len(slides)] for i in range(n_chunks - 1)]
    woff = np.minimum(first + np.concatenate([[0], np.cumsum(steps)]),
                      nw - n_win).astype(np.int32)
    woff[-1] = nw - n_win
    return woff


def _band_windows(rng, B, T, nw, chunk, woff, n_win):
    """lo/hi with the band's edge lanes: hi = 0, hi past T, hi inside a
    chunk whose window has not reached the bottom word, hi in the last
    chunk, lo past hi, lo a multiple of 32, the rest inside the row."""
    lo = rng.randint(0, T // 2, B)
    hi = rng.randint(1, T + 1, B)
    hi[0::6] = 0
    hi[1::6] = T + 1 + rng.randint(0, 9, len(hi[1::6]))
    hi[3::6] = T - rng.randint(0, T - (len(woff) - 1) * chunk,
                               len(hi[3::6]))
    early = np.nonzero(woff != nw - n_win)[0]
    if len(early):
        c = min(int(early[-1]) * chunk + chunk - 1, T - 1)
        hi[2::6] = 1 + rng.randint(0, c + 1, len(hi[2::6]))
        lo[2::6] = rng.randint(0, c + 1, len(hi[2::6]))
    lo[4::6] = hi[4::6] + 2
    lo[5::6] -= lo[5::6] % 32
    lo[0::6] = 0
    return lo.astype(np.int32), hi.astype(np.int32)


def _band_case(rng, n_win, nw, chunk, T, first, slides, B=36, rows=4):
    """shw_banded's operands: random profiles and target rows, the lanes'
    rows at random, the band's edge windows.  Profile row 0 matches
    nothing, so its lanes' scores run in plateaus: best ties over columns
    of different threads of a segment."""
    woff = _t(_woff(-(-T // chunk), nw, n_win, first, slides))
    _, peq = _words(rng, (rows, S1, nw))
    peq[0] = 0
    tg = _t(rng.randint(0, S1, (rows, T)))
    lo, hi = (_t(x) for x in _band_windows(rng, B, T, nw, chunk,
                                           woff.numpy(), n_win))
    prow, trow = _t(rng.randint(0, rows, B)), _t(rng.randint(0, rows, B))
    return peq, tg, woff, lo, hi, prow, trow


BAND_CASES = [
    # n_win, nw, chunk, T, woff[0], slides
    (2, 2, 16, 70, 0, [0]),              # the window is the whole profile
    (2, 9, 16, 131, 1, [1]),             # a slide of 1 at every boundary
    (4, 12, 64, 300, 0, [2, 0, 1]),      # slides at the first boundary
    (4, 6, 32, 100, 0, [0]),             # one slide, at the last boundary
    (8, 40, 16, 203, 3, [5, 0, 0, 2]),   # several words at once
    (12, 32, 256, 520, 0, [8]),          # phase 9's chunk and width
    (16, 16, 64, 157, 0, [0]),           # the whole profile at width 16
    (16, 40, 16, 190, 2, [3, 1]),
]


@pytest.mark.parametrize("n_win,nw,chunk,T,first,slides", BAND_CASES)
def test_shw_banded_words_plain_matches_plain(rng, n_win, nw, chunk, T,
                                              first, slides):
    """(best, pfirst, plast) against shw_banded_plain on rows of T columns
    (ragged against the chunk and the 16-column tiles), 36 lanes with the
    edge lanes: hi past the row, hi in a chunk whose window has not reached
    the bottom word (no live column: _BIG and -1), lo past hi, lo a
    multiple of 32."""
    args = _band_case(rng, n_win, nw, chunk, T, first, slides)
    want = ck.shw_banded_plain(*args, n_win, chunk)
    got = ck.shw_banded_words_plain(*args, n_win, chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    lo, hi = args[3], args[4]
    empty = lo >= hi
    assert bool(empty.any()) and bool((want[0][empty] == BIG).all())
    assert bool((want[1][empty] == -1).all())
    assert bool((want[2][empty] == -1).all())
    assert bool((want[0] != BIG).any())


def _merged_by_threads(cols, lo, hi, W):
    """The kernels' reduction: each of a segment's W threads reduces the
    columns c with c % 16 % W == its index (WindowReduction's take, in
    column order), then the partials merge as merge_words merges them."""
    parts = [[torch.full_like(lo, BIG), torch.full_like(lo, -1),
              torch.full_like(lo, -1)] for _ in range(W)]
    for c, score, live in cols:
        p = parts[c % ck.WORD_TILE % W]
        inw = (lo <= c) & (hi > c) & live
        p[2] = torch.where(inw & (score <= p[0]), c, p[2])
        lt = inw & (score < p[0])
        p[1] = torch.where(lt, c, p[1])
        p[0] = torch.where(lt, score, p[0])
    best, pfirst, plast = parts[0]
    for b, pf, pl in parts[1:]:
        eq = b == best
        pfirst = torch.where(b < best, pf,
                             torch.where(eq, torch.minimum(pfirst, pf),
                                         pfirst))
        plast = torch.where(b < best, pl,
                            torch.where(eq, torch.maximum(plast, pl), plast))
        best = torch.minimum(best, b)
    return best, pfirst, plast


@pytest.mark.parametrize("case", [BAND_CASES[1], BAND_CASES[5],
                                  BAND_CASES[7]])
def test_the_segment_merge_is_the_column_order_reduction(rng, case):
    """The segment's merge rule over each thread's columns == the reduction
    in column order that the emulation and the plain version take, on the
    band's own scores; the data holds lanes whose first and last best
    columns lie in different threads of the segment, ties the merge must
    resolve (least pfirst, greatest plast)."""
    n_win, nw, chunk, T, first, slides = case
    args = _band_case(rng, n_win, nw, chunk, T, first, slides)
    W = ck.band_width(n_win, chunk)
    peq, tg, woff, lo, hi, prow, trow = args
    cols = list(ck._band_words_columns("test", peq, tg, woff, prow, trow,
                                       n_win, chunk))
    got = _merged_by_threads(cols, lo, hi, W)
    want = ck.shw_banded_words_plain(*args, n_win, chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    pf, pl = want[1], want[2]
    split = (pf >= 0) & (pf % ck.WORD_TILE % W != pl % ck.WORD_TILE % W)
    assert bool(split.any())


@pytest.mark.parametrize("n_win,nw,chunk,first,slides", [
    (2, 7, 32, 0, [1, 0]), (4, 12, 64, 1, [3, 1]), (8, 24, 32, 0, [0, 4]),
    (16, 40, 32, 2, [5])])
def test_shw_banded_words_plain_matches_pallas_interpret(
        rng, n_win, nw, chunk, first, slides):
    """Against pallas_kernel.sweep_shw_banded_pallas in interpret mode with
    the same window offsets, on whole chunks, through convert's untiling:
    hi past the row and inside the first chunk (before the window reaches
    the bottom word), lo past hi."""
    T, B = 4 * chunk, 24
    woff = _woff(4, nw, n_win, first, slides)
    words, peq = _words(rng, (B, S1, nw))
    tg = rng.randint(0, S1, (B, T)).astype(np.int32)
    lo, hi = _band_windows(rng, B, T, nw, chunk, woff, n_win)
    hi[1::6] = rng.randint(1, chunk + 1, len(hi[1::6]))    # first chunk
    hi[3::6] = T + 5
    jsw = pk.PallasSweeper(chunk=chunk, interpret=True)
    peq_t, tg_t = jsw._packed(words, tg, hi, False)
    raw = pk.sweep_shw_banded_pallas(
        jnp.asarray(peq_t), jnp.asarray(tg_t), jnp.asarray(woff),
        jnp.asarray(jsw.pack_lanes(lo)), jnp.asarray(jsw.pack_lanes(hi)),
        n_win, chunk=chunk, interpret=True)
    rows = _t(np.arange(B))
    got = ck.shw_banded_words_plain(peq, _t(tg), _t(woff), _t(lo), _t(hi),
                                    rows, rows, n_win, chunk)
    for g, w in zip(got, raw):
        np.testing.assert_array_equal(g.numpy(),
                                      convert.lanes_from_tiles(w, B).numpy())
    assert (got[0] != BIG).any() and (got[0] == BIG).any()


def test_shw_banded_words_plain_refuses_thread_shapes():
    peq = torch.zeros(2, S1, 8, dtype=torch.int32)
    tg = torch.zeros(2, 64, dtype=torch.int32)
    lanes = [torch.zeros(2, dtype=torch.int32)] * 4
    for n_win, chunk in ((1, 64), (4, 24), (20, 64)):
        with pytest.raises(ValueError, match="no band form"):
            ck.shw_banded_words_plain(
                peq, tg, torch.zeros(3, dtype=torch.int32), *lanes, n_win,
                chunk)


# --------------------------------------------------------------------------
# #10 reduce_eqstream: the word-parallel lane
# --------------------------------------------------------------------------


def _stream_case(rng, B, T, nw, sigma=20):
    """A gathered Eq stream of random profiles over random target rows,
    and lo/hi with the edge lanes: hi = 0, an empty window, lo past hi, hi
    past the row, both past it, lo a multiple of 32, hi inside the row."""
    words = rng.randint(0, 1 << 32, (B, sigma + 1, nw),
                        dtype=np.uint64).astype(np.uint32)
    words[1::3] = 0                       # plateaus: ties across threads
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    lo = rng.randint(0, max(T // 2, 1), B)
    hi = np.minimum(lo + rng.randint(1, T + 1, B), max(T - 1, 1))
    hi[0::7] = 0
    hi[1::7] = lo[1::7]
    lo[2::7] = hi[2::7] + 3
    hi[3::7] = T + 1 + rng.randint(0, 20, len(hi[3::7]))
    lo[4::7], hi[4::7] = T + 2, T + 9
    lo[5::7] -= lo[5::7] % 32
    eq_t = ck.eqstream_gather(convert.bit_words(words), _t(tg)).permute(
        1, 2, 0)
    return words, tg, eq_t, lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("nw,hin0,T", [
    (2, 0, 150), (2, 1, 37), (3, 0, 5), (3, 1, 197), (4, 0, 131),
    (4, 1, 2), (5, 0, 101), (6, 1, 64), (7, 0, 33), (8, 1, 197), (8, 0, 2)])
def test_reduce_eqstream_words_plain_matches_plain(rng, nw, hin0, T):
    """(best, pfirst, plast, last) against reduce_eqstream_plain at NW 2-8
    (segments of 2, 4 and 8 threads), both hin0, rows of 2 and 5 columns
    (shorter than the words' lag), lo a multiple of 32, hi < T (the lane
    sweeps past hi; last is the score at hi - 1), hi past the row (last
    stays _BIG), lo past hi."""
    _, _, eq_t, lo, hi = _stream_case(rng, 21, T, nw)
    want = ck.reduce_eqstream_plain(eq_t, _t(lo), _t(hi), hin0)
    got = ck.reduce_eqstream_words_plain(eq_t, _t(lo), _t(hi), hin0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    inside = (hi > 0) & (hi < T)
    if inside.any():
        assert bool((want[3][torch.from_numpy(inside)] != BIG).all())
    assert bool((want[3][torch.from_numpy(hi > T)] == BIG).all())


def test_reduce_eqstream_words_plain_on_an_empty_stream():
    """No column: every lane (_BIG, -1, -1, _BIG), as the one-thread kernel
    the wrapper keeps there writes it."""
    eq_t = torch.zeros((0, 4, 5), dtype=torch.int32)
    lo, hi = _t([0, 0, 3, 1, 0]), _t([0, 4, 9, 1, 40])
    got = ck.reduce_eqstream_words_plain(eq_t, lo, hi, 1)
    want = ck.reduce_eqstream_plain(eq_t, lo, hi, 1)
    for g, w, v in zip(got, want, (BIG, -1, -1, BIG)):
        assert torch.equal(g, w) and bool((g == v).all())


@pytest.mark.parametrize("hin0", [0, 1])
def test_reduce_eqstream_words_plain_matches_pallas(rng, hin0):
    """At two words == pallas_kernel.reduce_flat_device_eqstream in
    interpret mode: best, pfirst, plast and last, edge lanes, windows
    ending at the row (the TPU kernel would scan its chunk filler past
    it; the port's stream stops at T)."""
    B, T, nw = 13, 150, 2
    words, tg, eq_t, lo, hi = _stream_case(rng, B, T, nw)
    hi = np.minimum(hi, T)
    want = pk.reduce_flat_device_eqstream(
        jnp.asarray(words), jnp.asarray(tg), jnp.asarray(lo),
        jnp.asarray(hi), hin0=hin0, chunk=32, interpret=True)
    got = ck.reduce_eqstream_words_plain(eq_t, _t(lo), _t(hi), hin0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] != BIG).any() and (got[0] == BIG).any()


# --------------------------------------------------------------------------
# The forms the wrappers pick
# --------------------------------------------------------------------------


def test_forms_on_the_main_paths():
    """Phase 9's shape (chip_smoke: SHW locations on 8,192 1-kbp pairs with
    a 300-column tail, 32 words, chunks of 256, the reduce's k = 64 rung
    and the others up to 128) gives windows of 12-16 words, so the band at
    width 16; the one-thread form stays at n_win 1, past 16 and on chunks
    of partial tiles."""
    n_chunks = -(-1339 // 256)
    woff, n_win = ck.nw_band_schedule(32, n_chunks, 256, -64, 64)
    assert n_win == 12 and ck.band_width(n_win, 256) == 16
    for k in (8, 16, 32, 128):
        woff, n_win = ck.nw_band_schedule(32, n_chunks, 256, -k, k)
        assert ck.band_width(n_win, 256) == 16
    assert ck.band_width(1, 256) == 0 and ck.band_width(20, 256) == 0
    assert ck.band_width(12, 40) == 0
    assert [ck.word_threads(nw) for nw in range(2, 9)] == [2, 4, 4, 8, 8,
                                                           8, 8]


def test_reported_plans_and_cpu_wrappers(rng):
    """The band's and the word lane's plans read with their widths; on the
    CPU both wrappers run their plain versions and report no plan."""
    buf = ck._plan_buffer()
    buf[:] = [6, 1024, 128, 16, 0, 0, 0, 0, 0, 0]
    plan = {}
    ck._fill_plan(plan, buf)
    assert plan == dict(form="band", blocks=1024, threads=1024 * 128,
                        block=128, width=16)
    buf[:] = [1, 128, 128, 4, 0, 0, 0, 0, 0, 0]
    ck._fill_plan(plan, buf)
    assert plan == dict(form="words", blocks=128, threads=128 * 128,
                        block=128, width=4)
    args = _band_case(rng, 4, 12, 64, 300, 0, [2, 0, 1], B=8)
    plan = {"form": "unset"}
    got = ck.shw_banded(*args, 4, 64, plan=plan)
    for g, w in zip(got, ck.shw_banded_plain(*args, 4, 64)):
        assert torch.equal(g, w)
    _, _, eq_t, lo, hi = _stream_case(rng, 8, 40, 3)
    got = ck.reduce_eqstream(eq_t, _t(lo), _t(hi), 0, plan=plan)
    for g, w in zip(got, ck.reduce_eqstream_plain(eq_t, _t(lo), _t(hi), 0)):
        assert torch.equal(g, w)
    assert plan == {"form": "unset"}
