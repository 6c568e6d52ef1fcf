"""The column capture's word groups over lanes and banded NW's word-parallel
band on the CPU: the plain emulations of both schedules
(ops/cuda_kernel.capture_words_plain, nw_banded_words_plain) against the
plain versions and the JAX package, and the shapes the wrappers plan
(capture_plan, band_width).

The capture kernel runs a block of 8, 16 or 32 lanes, a group of threads a
word (or a few consecutive words) of each lane, a group a tile of 16
columns behind the one above; the banded kernel runs a lane's window words
on a segment of threads of one warp, each absolute word x a tile behind
word x - 1, its lag kept across the window's slides.  The CUDA kernels
follow the same schedules on the card, where chip_smoke.py holds them
against their plain versions.  Every output is an integer (the captured
words, the banded scores with their values above k and _BIG), so every
comparison is exact.  Inputs come from numpy with a fixed seed.  The Pallas
kernels run in interpret mode; the capture kernel at up to 32 words (at 64
its interpreted body takes over half a minute to compile), the 64-word
case against capture_plan, which test_torch_path holds against it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch.ops import cuda_kernel as ck

S1 = 5          # four symbols and the wildcard
BIG = ck._BIG


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _words(rng, shape):
    """Random uint32 bit words as uint32 (JAX) and their int32 patterns."""
    w = rng.randint(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return w, torch.from_numpy(w.view(np.int32))


# --------------------------------------------------------------------------
# #14 capture: word groups over lanes
# --------------------------------------------------------------------------


def _equal_all(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert torch.equal(g, w)


@pytest.mark.parametrize("nw,words,B,T", [
    (1, None, 13, 45), (4, None, 13, 45), (8, None, 9, 61),
    (16, None, 13, 45), (17, 4, 11, 40), (32, 2, 10, 33), (64, 8, 9, 20),
    (64, None, 5, 17)])
@pytest.mark.parametrize("hin0", [0, 1])
def test_capture_words_plain_matches_capture_plain(rng, nw, words, B, T,
                                                   hin0):
    """Groups of one word (capture_plan's shape at these lane counts) and of
    2, 4 and 8 (a ragged last group at 17 words), lane counts that are not
    a multiple of a block's 8 lanes, rows of ragged tiles (T not a multiple
    of 16), with and without Ph/Mh."""
    _, peq = _words(rng, (B, S1, nw))
    tg = _t(rng.randint(0, S1, (B, T)))
    for want_h in (False, True):
        _equal_all(ck.capture_words_plain(peq, tg, hin0, want_h, words=words),
                   ck.capture_plain(peq, tg, hin0, want_h))


@pytest.mark.parametrize("nw,hin0,want_h", [
    (1, 0, True), (4, 1, False), (8, 0, True), (16, 1, True), (17, 0, False),
    (32, 1, False)])
def test_capture_words_plain_matches_pallas_interpret(rng, nw, hin0, want_h):
    """Against pallas_kernel.capture_flat_device: 13 lanes (not a multiple
    of the block's lanes), 45 columns padded with the wildcard to a ragged
    last chunk of 32."""
    B, T, chunk = 13, 45, 32
    words, peq = _words(rng, (B, S1, nw))
    tg = rng.randint(0, S1, (B, T)).astype(np.int32)
    want = pk.capture_flat_device(words, tg, hin0=hin0, chunk=chunk,
                                  interpret=True, want_h=want_h)
    got = ck.capture_words_plain(peq, ck._pad_cols(_t(tg), S1 - 1, chunk),
                                 hin0, want_h)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))


# --------------------------------------------------------------------------
# #6 nw_banded: the word-parallel band
# --------------------------------------------------------------------------


def _woff(rng, n_chunks, nw, n_win, first, slides):
    """Window offsets from woff[0] = first with the given slides at the
    chunk boundaries (cycled), capped at the bottom word NW - n_win, the
    last chunk at the bottom so most lanes are read there."""
    steps = [slides[i % len(slides)] for i in range(n_chunks - 1)]
    woff = np.minimum(first + np.concatenate([[0], np.cumsum(steps)]),
                      nw - n_win).astype(np.int32)
    woff[-1] = nw - n_win
    return woff


def _band_lanes(rng, B, T, nw, chunk, woff, n_win, n_rows=4):
    """Per-lane profile and target rows and hi with the edge lanes: hi = 0,
    hi past T, hi - 1 in a chunk whose window has not reached the bottom
    word (_BIG), hi - 1 in the last chunk, and the rest inside the row."""
    _, peq = _words(rng, (n_rows, S1, nw))
    tg = _t(rng.randint(0, S1, (n_rows, T)))
    hi = rng.randint(1, T + 1, B)
    hi[0::5] = 0
    hi[1::5] = T + 1 + rng.randint(0, 9, len(hi[1::5]))
    hi[3::5] = T - rng.randint(0, T - (len(woff) - 1) * chunk,
                               len(hi[3::5]))
    early = np.nonzero(woff != nw - n_win)[0]
    if len(early):
        c = min(int(early[-1]) * chunk + chunk - 1, T - 1)
        hi[2::5] = 1 + rng.randint(0, c + 1, len(hi[2::5]))
    prow = _t(rng.randint(0, n_rows, B))
    trow = _t(rng.randint(0, n_rows, B))
    return peq, tg, _t(hi), prow, trow


BAND_CASES = [
    # n_win, nw, chunk, T, woff[0], slides
    (2, 2, 16, 70, 0, [0]),              # the window is the whole profile
    (2, 9, 16, 131, 1, [1]),             # a slide of 1 at every boundary
    (4, 12, 64, 300, 0, [2, 0, 1]),      # slides at the first boundary
    (4, 6, 32, 100, 0, [0]),             # one slide, at the last boundary
    (8, 40, 16, 203, 3, [5, 0, 0, 2]),   # several words at once
    (12, 32, 256, 1000, 0, [8]),         # phase 8's chunk and width
    (12, 20, 64, 250, 0, [1, 3]),
    (16, 16, 64, 157, 0, [0]),           # the whole profile at width 16
    (16, 40, 16, 190, 2, [3, 1]),
]


@pytest.mark.parametrize("n_win,nw,chunk,T,first,slides", BAND_CASES)
def test_nw_banded_words_plain_matches_plain(rng, n_win, nw, chunk, T,
                                             first, slides):
    """Raw scores (values above any k and _BIG included) against
    nw_banded_plain on rows of T columns (ragged against the chunk and the
    16-column tiles), 40 lanes with the edge lanes."""
    n_chunks = -(-T // chunk)
    woff = _woff(rng, n_chunks, nw, n_win, first, slides)
    ops = _band_lanes(rng, 40, T, nw, chunk, woff, n_win)
    peq, tg, hi, prow, trow = ops
    w = _t(woff)
    got = ck.nw_banded_words_plain(peq, tg, w, hi, prow, trow, n_win, chunk)
    want = ck.nw_banded_plain(peq, tg, w, hi, prow, trow, n_win, chunk)
    assert torch.equal(got, want)
    assert (want == BIG).any() and (want != BIG).any()


@pytest.mark.parametrize("n_win,nw,chunk,first,slides", [
    (2, 7, 16, 0, [1, 0]), (4, 12, 64, 1, [3, 1]), (8, 24, 32, 0, [0, 4]),
    (12, 16, 64, 0, [0]), (16, 40, 16, 2, [5])])
def test_nw_banded_words_plain_matches_pallas_interpret(rng, n_win, nw,
                                                        chunk, first,
                                                        slides):
    """Against the Pallas kernel (pallas_kernel.sweep_nw_banded_pallas,
    interpret mode) with the same window offsets, on whole chunks."""
    T = 4 * chunk
    woff = _woff(rng, 4, nw, n_win, first, slides)
    B = 24
    words, _ = _words(rng, (B, S1, nw))
    tg = rng.randint(0, S1, (B, T)).astype(np.int32)
    hi = rng.randint(1, T + 1, B).astype(np.int32)
    hi[0::6] = 0
    hi[1::6] = rng.randint(1, chunk + 1, len(hi[1::6]))    # first chunk
    jsw = pk.PallasSweeper(chunk=chunk, interpret=True)
    peq_t, tg_t = jsw._packed(words, tg, hi, False)
    raw = pk.sweep_nw_banded_pallas(
        jnp.asarray(peq_t), jnp.asarray(tg_t), jnp.asarray(woff),
        jnp.asarray(jsw.pack_lanes(hi)), n_win, chunk=chunk, interpret=True)
    want = np.asarray(raw).reshape(-1)[:B]
    rows = _t(np.arange(B))
    got = ck.nw_banded_words_plain(torch.from_numpy(words.view(np.int32)),
                                   _t(tg), _t(woff), _t(hi), rows, rows,
                                   n_win, chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == BIG).any() and (want != BIG).any()


@pytest.mark.parametrize("k", [6, 40])
def test_nw_banded_words_plain_matches_flat_device(rng, k):
    """The JAX package's own band schedule (nw_band_schedule for the
    diagonals of band k) through pallas_kernel.nw_banded_flat_device in
    interpret mode, 16-word profiles, chunks of 64."""
    B, nw, chunk = 12, 16, 64
    words, peq = _words(rng, (B, S1, nw))
    T = 300
    tg = rng.randint(0, S1 - 1, (B, T)).astype(np.int32)
    hi = rng.randint(T - 40, T + 1, B).astype(np.int32)
    hi[0] = 0
    D = nw * 32 - hi
    d_lo, d_hi = int(np.min(-((k - D) // 2))), int(np.max((D + k) // 2))
    want = pk.nw_banded_flat_device(
        jnp.asarray(words), jnp.asarray(tg), jnp.asarray(hi), d_lo, d_hi,
        chunk=chunk, interpret=True)
    n_chunks = -(-T // chunk)
    woff, n_win = ck.nw_band_schedule(nw, n_chunks, chunk, d_lo, d_hi)
    assert ck.band_width(n_win, chunk)
    rows = _t(np.arange(B))
    got = ck.nw_banded_words_plain(peq, ck._pad_cols(_t(tg), S1 - 1, chunk),
                                   _t(woff), _t(hi), rows, rows, n_win, chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nw_banded_words_plain_refuses_thread_shapes():
    peq = torch.zeros(2, S1, 8, dtype=torch.int32)
    tg = torch.zeros(2, 64, dtype=torch.int32)
    lanes = [torch.zeros(2, dtype=torch.int32)] * 3
    for n_win, chunk in ((1, 64), (4, 24)):
        with pytest.raises(ValueError, match="no band form"):
            ck.nw_banded_words_plain(peq, tg,
                                     torch.zeros(3, dtype=torch.int32),
                                     *lanes, n_win, chunk)


# --------------------------------------------------------------------------
# The forms the wrappers pick
# --------------------------------------------------------------------------


def test_forms_on_the_main_paths():
    """The new forms on phases 8, 11 and 12's shapes (chip_smoke: 8,192
    1-kbp NW pairs, 32 words, chunks of 256, windows of 12-16 words; the
    HW path's 10,240 4-word windows in slabs of 8,192 and 2,048; the NW
    path's 500-bp pairs, 16 words, slabs of 512 lanes, their distances'
    bands), the old ones where the new cannot run."""
    # batch._run_bucketed_nw_banded's rungs k = 64 and 128 for pairs whose
    # length differences D lie in [-12, 12]: diagonals [-(k + 12) // 2,
    # (k + 12) // 2].
    for nw, T in ((32, 1056), (16, 540)):
        for k in (64, 128):
            woff, n_win = ck.nw_band_schedule(nw, -(-T // 256), 256,
                                              -((k + 12) // 2),
                                              (k + 12) // 2)
            assert 12 <= n_win <= 16 and woff[-1] > woff[0]
            assert ck.band_width(n_win, 256) == 16
    assert ck.capture_plan(16, 512) == {"form": "lane_words", "lanes": 8,
                                        "words": 1}
    assert ck.capture_plan(4, 8192) == {"form": "lane_words", "lanes": 32,
                                        "words": 1}
    assert ck.capture_plan(4, 2048) == {"form": "lane_words", "lanes": 8,
                                        "words": 1}
    # Every NW from 1 to 512 takes the word groups; groups of several
    # words past a block's 512 threads.
    for nw in range(1, 513):
        for n in (3, 512, 10_240):
            plan = ck.capture_plan(nw, n)
            assert plan["form"] == "lane_words"
            assert plan["lanes"] * -(-nw // plan["words"]) <= 512
    assert ck.capture_plan(300, 300)["words"] == 8
    # The old forms: the read-back capture past 512 words; the one-thread
    # band at n_win = 1, a chunk not a whole number of tiles, n_win past 16.
    assert ck.capture_plan(513, 300) == {"form": "thread"}
    assert ck.capture_plan(1023, 10_240) == {"form": "thread"}
    assert ck.band_width(1, 256) == 0
    assert ck.band_width(4, 24) == 0
    assert ck.band_width(20, 256) == 0
    assert [ck.band_width(n, 64) for n in (2, 3, 4, 5, 8, 12, 16)] == [
        2, 4, 4, 8, 8, 16, 16]


def test_reported_plans_of_the_new_forms():
    """The plans the two entries report read as dicts: the band's segment
    width, the word groups' lanes a block and words a group (reported in
    the first two figures' places), the one-thread forms bare."""
    buf = ck._plan_buffer()
    buf[:] = [6, 1024, 128, 16, 0, 0, 0, 0, 0, 0]
    plan = {}
    ck._fill_plan(plan, buf)
    assert plan == dict(form="band", blocks=1024, threads=1024 * 128,
                        block=128, width=16)
    buf[:] = [5, 64, 128, 8, 1, 0, 0, 0, 0, 0]
    ck._fill_plan(plan, buf)
    assert plan == dict(form="lane_words", blocks=64, threads=64 * 128,
                        block=128, lanes=8, words=1)
    buf[:] = [0, 5, 64, 0, 0, 0, 0, 0, 0, 0]
    ck._fill_plan(plan, buf)
    assert plan == dict(form="thread", blocks=5, threads=5 * 64, block=64)


def test_wrappers_leave_plan_on_cpu(rng):
    """The plain versions run on the CPU and report no plan."""
    _, peq = _words(rng, (3, S1, 4))
    tg = _t(rng.randint(0, S1, (3, 40)))
    plan = {"form": "unset"}
    ck.capture(peq, tg, 1, plan=plan)
    rows = _t(np.arange(3))
    ck.nw_banded(peq, tg, _t([0, 0, 0]), _t([40, 10, 0]), rows, rows, 2, 16,
                 plan=plan)
    assert plan == {"form": "unset"}
