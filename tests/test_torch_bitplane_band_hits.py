"""The redesigned bit-plane and banded SHW hit words on the CPU:
hits_bitplane's split-lane plan on K3's staged rows (cores that own whole
hit words, ops/cuda_kernel.hits_core and split_cores(word_aligned=True);
its plain emulation split_hits_bitplane_plain) and shw_banded_hits' word-
parallel band (shw_banded_hits_words_plain, the band emulation that
nw_banded_words_plain also reads), against the plain versions and the JAX
package, and the forms the wrappers plan.

The CUDA kernels follow the same schedules on the card, where chip_smoke.py
holds them against their plain versions.  Every output is an integer (raw
hit words, banded scores with their values above k and _BIG), so every
comparison is exact.  Inputs come from numpy with a fixed seed.  The Pallas
bit-plane kernels with hits run in interpret mode at one word (their
unrolled bodies compile for minutes from two words on); at 4 and 8 words
the emulation is held against hits_bitplane_plain.  The banded hits kernel
keeps its loops rolled there and compiles in about a second at any
width.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck

NONE = -(1 << 30)      # a best no column reaches: a lane without hits
SIGMA = 100            # bit-plane symbols; SIGMA is the wildcard
S1 = 5                 # banded profiles: four symbols and the wildcard
BIG = ck._BIG


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _edge_windows(rng, B, T):
    """lo/hi with the edge lanes: hi = 0, an empty window (hi - 1 < lo), lo
    past hi, hi past the row, both past it, lo a multiple of 32, and
    windows inside the row (lo mostly not a multiple of 32)."""
    lo = rng.randint(0, T // 2, B)
    hi = np.minimum(lo + rng.randint(1, T + 1, B), T)
    hi[0::7] = 0
    hi[1::7] = lo[1::7]
    lo[2::7] = hi[2::7] + 3
    hi[3::7] = T + 1 + rng.randint(0, 20, len(hi[3::7]))
    lo[4::7], hi[4::7] = T + 2, T + 9
    lo[5::7] -= lo[5::7] % 32
    return lo.astype(np.int32), hi.astype(np.int32)


def _none_lanes(best, rng):
    """best with every 5th lane and a random few at NONE."""
    best = best.clone()
    best[::5] = NONE
    best[torch.from_numpy(rng.rand(best.shape[0]) < 0.1)] = NONE
    return best.contiguous()


# --------------------------------------------------------------------------
# #13 hits_bitplane: the split-lane plan on K3's staged rows
# --------------------------------------------------------------------------


def _bitplane_operands(rng, B, nw, n_alts):
    """(q_alts (B, E, NW*32), pad_words (B, NW)) of B reads of ragged
    lengths: the first alternative the read, the others a random partner
    in 30% of the rows, else the sentinel (no alternative)."""
    qmax = nw * 32
    q = rng.randint(0, SIGMA, (B, qmax)).astype(np.int32)
    qlens = rng.randint(1, qmax + 1, B).astype(np.int32)
    qlens[0] = qmax
    qa, pw = ck.bitplane_identity_operands(_t(q), _t(qlens), SIGMA, nw)
    nb = ck.bitplane_nb(SIGMA)
    extra = [np.where(rng.rand(B, 1, qmax) < 0.3,
                      rng.randint(0, SIGMA, (B, 1, qmax)), (1 << nb) - 1)
             for _ in range(n_alts - 1)]
    qa = np.concatenate([qa.numpy()] + extra, 1).astype(np.int32)
    return qa, pw.numpy()


def _bitplane_lanes(rng, B, T, nw, n_alts, rows=4):
    """hits_bitplane's operands: `rows` reads' planes, per-lane target rows
    over the alphabet and the wildcard (a read symbol repeated, for more
    hits), edge windows; the lanes' rows at random."""
    nb = ck.bitplane_nb(SIGMA)
    qa, pw = _bitplane_operands(rng, rows, nw, n_alts)
    tg = rng.randint(0, SIGMA + 1, (rows, T)).astype(np.int32)
    tg[:, ::3] = qa[:, 0, :1]
    lo, hi = _edge_windows(rng, B, T)
    return (ck.bitplane_planes(_t(qa), nb), _t(pw), _t(tg), _t(lo), _t(hi),
            _t(rng.randint(0, rows, B)), _t(rng.randint(0, rows, B)))


@pytest.mark.parametrize("nw,hin0,n_alts", [
    (1, 0, 1), (1, 1, 2), (4, 0, 2), (4, 1, 1), (8, 0, 1), (8, 1, 2)])
def test_split_hits_bitplane_plain_matches_plain(rng, nw, hin0, n_alts):
    """The schedule's emulation == hits_bitplane_plain over whole lanes:
    forced cores of 32, 64, 96 and 160 columns and the unforced plan (one
    core a lane at these shapes, swept from a halo before it), hin0 = 1
    one core a lane from column 0, edge lanes, lanes without hits."""
    B, T = 12, 200
    nb = ck.bitplane_nb(SIGMA)
    ops = _bitplane_lanes(rng, B, T, nw, n_alts)
    tail = (hin0, nb, n_alts, SIGMA)
    best = _none_lanes(ck.reduce_bitplane_plain(*ops, *tail)[0], rng)
    want = ck.hits_bitplane_plain(*ops, best, *tail)
    assert bool((want != 0).any())
    for core in (32, 64, 96, 160, None):
        got = ck.split_hits_bitplane_plain(*ops, best, *tail, core=core)
        assert torch.equal(got, want), core


@pytest.mark.parametrize("nw,hin0,n_alts,core", [
    (1, 0, 1, 32), (1, 1, 2, None)])
def test_split_hits_bitplane_plain_matches_pallas_interpret(rng, nw, hin0,
                                                            n_alts, core):
    """The emulation on the operands the port's reduce_flat_device_bitplane
    hands hits_bitplane == pallas_kernel.reduce_flat_device_bitplane(...,
    want_hits=True) in interpret mode: raw hit words at the JAX reduce's
    best, one row a lane padded to the chunk grain as the JAX wrapper pads
    it, one and two alternatives, the wildcard in the targets."""
    B, T, chunk = 21, 90, 32
    nb = ck.bitplane_nb(SIGMA)
    qa, pw = _bitplane_operands(rng, B, nw, n_alts)
    tg = rng.randint(0, SIGMA + 1, (B, T)).astype(np.int32)
    tg[:, ::4] = qa[:, 0, :1]
    lo, hi = _edge_windows(rng, B, T)
    want = pk.reduce_flat_device_bitplane(
        jnp.asarray(qa), jnp.asarray(pw.view(np.uint32)), jnp.asarray(tg),
        jnp.asarray(lo), jnp.asarray(hi), hin0=hin0, sigma=SIGMA,
        chunk=chunk, want_hits=True, interpret=True)
    rows = torch.arange(B, dtype=torch.int32)
    got = ck.split_hits_bitplane_plain(
        ck.bitplane_planes(_t(qa), nb), _t(pw),
        ck._pad_cols(_t(tg), SIGMA, chunk), _t(lo), _t(hi), rows, rows,
        _t(np.array(want[0])), hin0, nb, n_alts, SIGMA, core=core)
    hits = np.asarray(want[4])
    assert hits.any()
    np.testing.assert_array_equal(_bits(got[:, :hits.shape[1]].numpy()),
                                  hits)


def test_split_hits_bitplane_plain_past_eight_words(rng):
    """Past 8 words the plan is one thread a lane: the plain version."""
    nb = ck.bitplane_nb(SIGMA)
    ops = _bitplane_lanes(rng, 8, 70, 9, 1)
    best = _none_lanes(ck.reduce_bitplane_plain(*ops, 0, nb, 1, SIGMA)[0],
                       rng)
    assert ck.hits_core(8, 70, 9, 0, 32) == 70
    assert torch.equal(
        ck.split_hits_bitplane_plain(*ops, best, 0, nb, 1, SIGMA, core=32),
        ck.hits_bitplane_plain(*ops, best, 0, nb, 1, SIGMA))


# --------------------------------------------------------------------------
# #8 shw_banded_hits: the word-parallel band
# --------------------------------------------------------------------------


def _words(rng, shape):
    """Random uint32 bit words as uint32 (JAX) and their int32 patterns."""
    w = rng.randint(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return w, torch.from_numpy(w.view(np.int32))


def _woff(rng, n_chunks, nw, n_win, first, slides):
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
def test_shw_banded_hits_words_plain_matches_plain(rng, n_win, nw, chunk, T,
                                                   first, slides):
    """Raw hit words against shw_banded_hits_plain on rows of T columns
    (ragged against the chunk and the 16-column tiles), 36 lanes with the
    edge lanes and lanes without hits, best the banded reduce's (values
    above k included); and nw_banded_words_plain, which reads the same
    band emulation, against nw_banded_plain on the same band."""
    B, rows = 36, 4
    n_chunks = -(-T // chunk)
    woff = _t(_woff(rng, n_chunks, nw, n_win, first, slides))
    _, peq = _words(rng, (rows, S1, nw))
    tg = _t(rng.randint(0, S1, (rows, T)))
    lo, hi = (_t(x) for x in _band_windows(rng, B, T, nw, chunk,
                                           woff.numpy(), n_win))
    prow, trow = _t(rng.randint(0, rows, B)), _t(rng.randint(0, rows, B))
    band = (peq, tg, woff)
    lanes = (lo, hi, prow, trow)
    best = _none_lanes(ck.shw_banded_plain(*band, *lanes, n_win, chunk)[0],
                       rng)
    want = ck.shw_banded_hits_plain(*band, *lanes, best, n_win, chunk)
    assert bool((want != 0).any())
    assert torch.equal(ck.shw_banded_hits_words_plain(*band, *lanes, best,
                                                      n_win, chunk), want)
    last = ck.nw_banded_plain(*band, hi, prow, trow, n_win, chunk)
    assert (last == BIG).any() and (last != BIG).any()
    assert torch.equal(ck.nw_banded_words_plain(*band, hi, prow, trow, n_win,
                                                chunk), last)


@pytest.mark.parametrize("n_win,nw,chunk,first,slides", [
    (2, 7, 32, 0, [1, 0]), (4, 12, 64, 1, [3, 1]), (8, 24, 32, 0, [0, 4]),
    (16, 40, 32, 2, [5])])
def test_shw_banded_hits_words_plain_matches_pallas_interpret(
        rng, n_win, nw, chunk, first, slides):
    """Against pallas_kernel.sweep_shw_banded_hits_pallas in interpret mode
    with the same window offsets, on whole chunks, raw hit words through
    convert's untiling: hi past the row and inside the first chunk (before
    the window reaches the bottom word), best from the banded reduce with
    lanes at -(1 << 30)."""
    T, B = 4 * chunk, 24
    woff = _woff(rng, 4, nw, n_win, first, slides)
    words, peq = _words(rng, (B, S1, nw))
    tg = rng.randint(0, S1, (B, T)).astype(np.int32)
    lo, hi = _band_windows(rng, B, T, nw, chunk, woff, n_win)
    hi[1::6] = rng.randint(1, chunk + 1, len(hi[1::6]))    # first chunk
    hi[3::6] = T + 5
    rows = _t(np.arange(B))
    args = (peq, _t(tg), _t(woff), _t(lo), _t(hi), rows, rows)
    best = _none_lanes(ck.shw_banded_plain(*args, n_win, chunk)[0], rng)
    jsw = pk.PallasSweeper(chunk=chunk, interpret=True)
    peq_t, tg_t = jsw._packed(words, tg, hi, False)
    masks = pk.sweep_shw_banded_hits_pallas(
        jnp.asarray(peq_t), jnp.asarray(tg_t), jnp.asarray(woff),
        jnp.asarray(jsw.pack_lanes(lo)), jnp.asarray(jsw.pack_lanes(hi)),
        jnp.asarray(jsw.pack_lanes(best.numpy(), fill=NONE)), n_win,
        chunk=chunk, interpret=True)
    want = convert.hit_words_from_tiles(masks, B)
    assert (want != 0).any()
    got = ck.shw_banded_hits_words_plain(*args, best, n_win, chunk)
    np.testing.assert_array_equal(got.numpy(),
                                  want[:, :got.shape[1]].numpy())
    assert not want[:, got.shape[1]:].any()


def test_shw_banded_hits_words_plain_refuses_thread_shapes():
    peq = torch.zeros(2, S1, 8, dtype=torch.int32)
    tg = torch.zeros(2, 64, dtype=torch.int32)
    lanes = [torch.zeros(2, dtype=torch.int32)] * 5
    for n_win, chunk in ((1, 64), (4, 24), (20, 64)):
        with pytest.raises(ValueError, match="no band form"):
            ck.shw_banded_hits_words_plain(
                peq, tg, torch.zeros(3, dtype=torch.int32), *lanes, n_win,
                chunk)


# --------------------------------------------------------------------------
# The forms the wrappers pick
# --------------------------------------------------------------------------


def test_forms_on_the_main_paths():
    """The new forms on phases 9 and 10's shapes (chip_smoke: SHW locations
    on 8,192 1-kbp pairs with a 300-column tail, 32 words, chunks of 256,
    the reduce's rungs and the hit pass at k up to 128; HW locations over
    sigma = 100, 8,192 120-bp reads, 4 words, each in its own 1,000-column
    window, 1,008 scan columns): the band at width 16 (a window spans a
    chunk's 256 columns of diagonals, so 12-16 words), the split kernel
    with one core a lane; and where the old forms stay."""
    n_chunks = -(-1330 // 256)
    for k in (8, 16, 32, 64, 128):
        woff, n_win = ck.nw_band_schedule(32, n_chunks, 256, -k, k)
        assert 12 <= n_win <= 16 and woff[-1] == 32 - n_win
        assert ck.band_width(n_win, 256) == 16
    for T in (1008, 1024):
        c = ck.hits_core(8192, T, 4, 0)
        assert c % 32 == 0 and c >= T           # no lane cut: one core each
    assert ck.hits_core(8192, 1008, 4, 1) == 1008
    # Forced cores cut the lanes (chip_smoke phase 2), past 8 words and at
    # hin0 = 1 the core is the row.
    assert ck.hits_core(300, 200, 4, 0, 40) == 64
    assert ck.hits_core(300, 200, 9, 0, 40) == 200
    assert ck.hits_core(300, 200, 4, 1, 40) == 200
    assert ck.band_width(1, 256) == 0 and ck.band_width(20, 256) == 0
    assert ck.band_width(6, 24) == 0


def test_reported_plans_and_cpu_wrappers(rng):
    """The split form's plan reads with its cores a lane and core length;
    on the CPU both wrappers run their plain versions and report no
    plan."""
    buf = ck._plan_buffer()
    buf[:] = [3, 64, 128, 0, 1, 1024, 0, 0, 0, 0]
    plan = {}
    ck._fill_plan(plan, buf)
    assert plan == dict(form="cores", blocks=64, threads=64 * 128, block=128,
                        cores=1, core=1024)
    nb = ck.bitplane_nb(SIGMA)
    ops = _bitplane_lanes(rng, 6, 40, 2, 1)
    best = ck.reduce_bitplane_plain(*ops, 0, nb, 1, SIGMA)[0]
    plan = {"form": "unset"}
    assert torch.equal(
        ck.hits_bitplane(*ops, best, 0, nb, 1, SIGMA, core=32, plan=plan),
        ck.hits_bitplane_plain(*ops, best, 0, nb, 1, SIGMA))
    _, peq = _words(rng, (3, S1, 4))
    tg = _t(rng.randint(0, S1, (3, 40)))
    rows = _t(np.arange(3))
    band = (peq, tg, _t([0, 1, 2]), _t([0, 5, 9]), _t([40, 30, 12]), rows,
            rows)
    best = ck.shw_banded_plain(*band, 2, 16)[0]
    assert torch.equal(ck.shw_banded_hits(*band, best, 2, 16, plan=plan),
                       ck.shw_banded_hits_plain(*band, best, 2, 16))
    assert plan == {"form": "unset"}
