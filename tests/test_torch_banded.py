"""The port's banded kernels (nw_banded, shw_banded, shw_banded_hits) and
their band schedule against the JAX package, on the CPU.

The wrappers run their plain PyTorch versions here; chip_smoke.py holds the
CUDA kernels against them on the card.  The Pallas kernels run in interpret
mode (their loops stay rolled there, so 8-word shapes compile in about a
second).  Raw outputs are compared, overestimates above the band's k
included: both packages use the same schedule, so they must agree bit for
bit.  Several k per case, from windows that slide to one that spans every
word.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from edlib_tpu import encode as jenc
from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops import sweeper as tsw

CHUNK = 32
SIGMA = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mutate(rng, seq, rate):
    out = []
    for ch in seq:
        r = rng.rand()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(int(rng.randint(SIGMA)))
        elif r < rate:
            out.extend([int(ch), int(rng.randint(SIGMA))])
        else:
            out.append(int(ch))
    return np.array(out, dtype=np.int32)


def _bucket(rng, B, nw_b, shared, tail=0):
    """(peq uint32 (B, S1, nw_b), targets (B, T) or shared (T,), lo, hi, D)
    in align_batch's scan space: queries of nw_b words against mutated
    copies (or one shared mutated sequence)."""
    eq = np.eye(SIGMA, dtype=bool)
    qs, ts = [], []
    t_shared = _mutate(rng, rng.randint(0, SIGMA, nw_b * 32 - 20), 0.08)
    for b in range(B):
        q = rng.randint(0, SIGMA, nw_b * 32 - rng.randint(0, 28))
        qs.append(q.astype(np.int32))
        t = t_shared if shared else _mutate(rng, q, (0.03, 0.15, 0.6)[b % 3])
        if tail and not shared:
            t = np.concatenate([t, rng.randint(0, SIGMA, tail)]).astype(
                np.int32)
        ts.append(t)
    ws = np.array([nw_b * 32 - len(q) for q in qs], np.int64)
    peq = np.stack([jenc.build_peq_words(q, eq, n_words=nw_b) for q in qs])
    lo = ws
    hi = ws + np.array([len(t) for t in ts], np.int64)
    D = np.array([len(q) - len(t) for q, t in zip(qs, ts)], np.int64)
    if shared:
        return peq, t_shared, lo, hi, D
    t_scan = 1 << int(hi.max() - 1).bit_length()
    targets = np.full((B, t_scan), SIGMA, np.int32)
    for b, t in enumerate(ts):
        targets[b, :len(t)] = t
    return peq, targets, lo, hi, D


@pytest.mark.parametrize("n_words,n_chunks,chunk", [
    (8, 10, 32), (16, 3, 256), (32, 5, 256), (4, 1, 256), (1, 4, 32),
    (64, 9, 256)])
def test_nw_band_schedule_matches_jax(n_words, n_chunks, chunk):
    for d_lo in (-300, -64, -20, -3, 0, 7):
        for d_hi in (d_lo, d_lo + 5, d_lo + 40, d_lo + 200, 400):
            got = ck.nw_band_schedule(n_words, n_chunks, chunk, d_lo, d_hi)
            want = pk.nw_band_schedule(n_words, n_chunks, chunk, d_lo, d_hi)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


def test_nw_banded_flat_device_matches_pallas_interpret():
    """Raw banded NW scores at three bands: a sliding 4-word window that
    cuts most lanes (values above k included), a wider one, and one that
    spans every word."""
    rng = np.random.RandomState(5)
    peq, targets, _, hi, D = _bucket(rng, 6, 16, shared=False)
    peq_t = convert.bit_words(peq)
    slid = False
    for k in (6, 24, 200):
        d_lo = int(np.min(-((k - D) // 2)))
        d_hi = int(np.max((D + k) // 2))
        n_chunks = -(-targets.shape[1] // CHUNK)
        woff, n_win = ck.nw_band_schedule(16, n_chunks, CHUNK, d_lo, d_hi)
        slid |= n_win < 16 and woff[-1] > woff[0]
        want = pk.nw_banded_flat_device(
            jnp.asarray(peq), jnp.asarray(targets), jnp.asarray(hi), d_lo,
            d_hi, chunk=CHUNK, interpret=True)
        got = ck.nw_banded_flat_device(peq_t, _t(targets),
                                       _t(hi.astype(np.int32)), d_lo, d_hi,
                                       chunk=CHUNK)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"k={k}")
    assert slid


@pytest.mark.parametrize("shared", [False, True])
def test_shw_banded_sweeper_matches_pallas_interpret(shared):
    """PallasSweeper.reduce_shw_banded / hits_shw_banded (interpret mode) vs
    the port's Sweeper on the same bucket, at k that slide the window."""
    rng = np.random.RandomState(11 + shared)
    peq, targets, lo, hi, _ = _bucket(rng, 6, 16, shared, tail=40)
    jsw = pk.PallasSweeper(chunk=CHUNK, interpret=True)
    tsweep = tsw.Sweeper(torch.device("cpu"), CHUNK)
    peq_t = convert.bit_words(peq)
    for k in (5, 20, 300):
        want = jsw.reduce_shw_banded(peq, targets, lo, hi, k, shared=shared)
        got = tsweep.reduce_shw_banded(peq_t, targets, lo, hi, k,
                                       shared=shared)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"k={k}")
        best = np.where(want[0] <= k, want[0], -(1 << 30))
        want_h = jsw.hits_shw_banded(peq, targets, lo, hi, best, k,
                                     shared=shared)
        got_h = tsweep.hits_shw_banded(peq_t, targets, lo, hi, best, k,
                                       shared=shared)
        assert len(got_h) == len(want_h)
        for g, w in zip(got_h, want_h):
            np.testing.assert_array_equal(g, w, err_msg=f"k={k}")


def test_shw_banded_raw_outputs_match_pallas_tiles():
    """The TPU kernels' raw tiles (reduce and hit masks, every lane's best
    set whether or not it is within k) through convert's untiling equal the
    port's flat outputs."""
    rng = np.random.RandomState(3)
    B = 5
    peq, targets, lo, hi, _ = _bucket(rng, B, 8, shared=False, tail=25)
    jsw = pk.PallasSweeper(chunk=CHUNK, interpret=True)
    peq_tiles, tg_tiles = jsw._packed(peq, targets, hi, False)
    n_chunks = tg_tiles.shape[1]
    woff, n_win = pk.nw_band_schedule(8, n_chunks, CHUNK, -12, 12)
    lo_t, hi_t = jsw.pack_lanes(lo), jsw.pack_lanes(hi)
    raw = pk.sweep_shw_banded_pallas(
        jnp.asarray(peq_tiles), jnp.asarray(tg_tiles), jnp.asarray(woff),
        jnp.asarray(lo_t), jnp.asarray(hi_t), n_win, chunk=CHUNK,
        interpret=True)
    best = convert.lanes_from_tiles(raw[0], B)
    masks = pk.sweep_shw_banded_hits_pallas(
        jnp.asarray(peq_tiles), jnp.asarray(tg_tiles), jnp.asarray(woff),
        jnp.asarray(lo_t), jnp.asarray(hi_t),
        jnp.asarray(jsw.pack_lanes(best.numpy(), fill=-(1 << 30))), n_win,
        chunk=CHUNK, interpret=True)

    rows = _t(np.arange(B, dtype=np.int32))
    args = (convert.bit_words(peq), _t(targets), _t(woff),
            _t(lo.astype(np.int32)), _t(hi.astype(np.int32)), rows, rows)
    got = ck.shw_banded(*args, n_win, CHUNK)
    for g, w in zip(got, raw):
        np.testing.assert_array_equal(g.numpy(),
                                      convert.lanes_from_tiles(w, B).numpy())
    got_h = ck.shw_banded_hits(*args, best, n_win, CHUNK)
    want_h = convert.hit_words_from_tiles(masks, B)
    assert (want_h != 0).any()
    np.testing.assert_array_equal(got_h.numpy(),
                                  want_h[:, :got_h.shape[1]].numpy())
    assert not want_h[:, got_h.shape[1]:].any()


def test_band_wrappers_refuse_bad_schedules():
    peq = torch.zeros(2, 5, 8, dtype=torch.int32)
    tg = torch.zeros(2, 64, dtype=torch.int32)
    lanes = [torch.zeros(2, dtype=torch.int32)] * 3
    with pytest.raises(ValueError, match="cover"):
        ck.nw_banded(peq, tg, torch.zeros(1, dtype=torch.int32), *lanes, 4,
                     32)
    with pytest.raises(ValueError, match="nondecreasing"):
        ck.nw_banded(peq, tg, torch.tensor([3, 1], dtype=torch.int32),
                     *lanes, 4, 32)
    with pytest.raises(ValueError, match="n_win"):
        ck.nw_banded(peq, tg, torch.zeros(2, dtype=torch.int32), *lanes, 9,
                     32)
