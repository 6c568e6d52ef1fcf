"""The port's q-gram filter (edlib_tpu_torch/ops/qfilter.py) against the JAX
package's (edlib_tpu/ops/qfilter.py), on the CPU.

Inputs come from numpy with a fixed seed and go to both packages; every
output is an integer or a 0/1 table, so every comparison is exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from edlib_tpu.ops import qfilter as jqf
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import qfilter as tqf

SIGMA = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mapping_reads(rng, target, B, qlen, n_random=0, sigma=SIGMA,
                   mut=0.05):
    tlen = len(target)
    reads = []
    for b in range(B):
        if b < n_random:
            r = rng.randint(0, sigma, qlen)
        else:
            s = rng.randint(0, tlen - qlen)
            r = target[s:s + qlen].copy()
            muts = rng.rand(qlen) < mut
            r[muts] = rng.randint(0, sigma, muts.sum())
        reads.append(r.astype(np.int32))
    return np.stack(reads)


@pytest.mark.parametrize("sigma", [2, 4, 20, 100])
def test_choose_q_and_window_geometry_match(sigma):
    for qlen in (8, 50, 120, 300):
        for k in (0, 3, 12, 30):
            for tlen in (200, 5000, 4_194_304):
                geom = jqf.window_geometry(tlen, qlen, k)
                assert tqf.window_geometry(tlen, qlen, k) == geom
                L = geom[0] if geom else 256
                for bump in (False, True):
                    for cap in (None, 5000):
                        assert (tqf.choose_q(sigma, qlen, k, L, max_vocab=cap,
                                             bump=bump)
                                == jqf.choose_q(sigma, qlen, k, L,
                                                max_vocab=cap, bump=bump))


def test_target_index_matches(rng):
    tlen, qlen, k = 3000, 60, 6
    t = rng.randint(0, SIGMA, tlen).astype(np.int32)
    L, stride, n_win = jqf.window_geometry(tlen, qlen, k)
    q = jqf.choose_q(SIGMA, qlen, k, L)
    Lv = tqf.verify_cols(L, 2)
    assert Lv == jqf.verify_cols(L, 2, 256)
    wp, ws = jqf.build_target_index(jnp.asarray(t), SIGMA, q, L, stride,
                                    n_win, Lv)
    gp, gs = tqf.build_target_index(_t(t), SIGMA, q, L, stride, n_win, Lv)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp, np.float32))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("qmax,q", [(120, 5), (400, 6)])
def test_read_presence_and_counts_match(rng, qmax, q):
    """Reads over 256 bp share more than 256 grams with a window: a bf16
    product would round those counts; the port's must stay exact."""
    B = 6
    t = np.tile(rng.randint(0, SIGMA, 700), 3).astype(np.int32)
    L = 1024
    stride = L - qmax + 1
    n_win = (len(t) - L + stride - 1) // stride + 1
    reads = _mapping_reads(rng, t, B, qmax, mut=0.01)
    qlens = np.full(B, qmax, np.int32)
    qlens[1] = qmax - 17                       # grams past qlen are dropped
    wp, wd = jqf.read_gram_presence(jnp.asarray(reads), jnp.asarray(qlens),
                                    SIGMA, q)
    gp, gd = tqf.read_gram_presence(_t(reads), _t(qlens), SIGMA, q)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp, np.float32))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    win = tqf.window_presence(_t(t), SIGMA, q, L, stride, n_win)
    want_c = jqf.candidate_counts(
        wp, jqf.window_presence(jnp.asarray(t), SIGMA, q, L, stride, n_win))
    got_c = tqf.candidate_counts(gp, win)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    if qmax > 256:
        assert got_c.max() > 256               # the bf16 trap is exercised


def test_auto_tune_picks_the_same_q_and_maxc(rng):
    tlen, qlen, k = 20000, 100, 10
    t = rng.randint(0, SIGMA, tlen).astype(np.int32)
    L, stride, n_win = jqf.window_geometry(tlen, qlen, k)
    Lv = tqf.verify_cols(L, 4)
    q0 = jqf.choose_q(SIGMA, qlen, k, L, bump=False)
    jq, jm, _, _, jpred = jqf.auto_tune(
        t, SIGMA, q0, k, qlen, L, stride, n_win, Lv,
        index_builder=lambda q: jqf.build_target_index(
            jnp.asarray(t), SIGMA, q, L, stride, n_win, Lv))
    tq, tm, _, _, tpred = tqf.auto_tune(
        t, SIGMA, q0, k, qlen, L, stride, n_win, Lv,
        index_builder=lambda q: tqf.build_target_index(
            _t(t), SIGMA, q, L, stride, n_win, Lv))
    assert (tq, tm, tpred) == (jq, jm, jpred)
    assert tq is not None
    # Repeat-rich target: both reject the filter.
    rep = np.tile(np.arange(SIGMA, dtype=np.int32), tlen // SIGMA)
    args = (SIGMA, q0, k, qlen, L, stride, n_win, Lv)
    jr = jqf.auto_tune(rep, *args, index_builder=lambda q: jqf.
                       build_target_index(jnp.asarray(rep), SIGMA, q, L,
                                          stride, n_win, Lv))
    tr = tqf.auto_tune(rep, *args, index_builder=lambda q: tqf.
                       build_target_index(_t(rep), SIGMA, q, L, stride, n_win,
                                          Lv))
    assert (tr[0], tr[1]) == (jr[0], jr[1])
    # A target no longer than the probes: no probe fits, no verdict.
    assert tqf.auto_tune(t[:qlen], *args, index_builder=None)[0] is None


def _both_filters(rng, t, reads, qlens, k, maxc, sigma=SIGMA,
                  jax_index=False):
    qmax = reads.shape[1]
    nw = -(-qmax // 32)
    L, stride, n_win = jqf.window_geometry(len(t), qmax, k)
    q = jqf.choose_q(sigma, int(qlens.min()), k, L)
    Lv = jqf.verify_cols(L, nw, 64)
    wp, ws = jqf.build_target_index(jnp.asarray(t), sigma, q, L, stride,
                                    n_win, Lv)
    kw = dict(sigma=sigma, q=q, L=L, stride=stride, tlen=len(t), k=k,
              maxc=maxc, nw=nw)
    want = jqf.filter_verify_batch(jnp.asarray(reads), jnp.asarray(qlens),
                                   wp, ws, chunk=64, interpret=True, **kw)
    if jax_index:
        index = convert.index_from_jax(np.asarray(wp), np.asarray(ws))
    else:
        index = tqf.build_target_index(_t(t), sigma, q, L, stride, n_win, Lv)
    got = tqf.filter_verify_batch(_t(reads.astype(np.uint8)), _t(qlens),
                                  *index, **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_same_verdicts(want, got, k):
    wb, wpos, wres = want
    gb, gpos, gres = got
    np.testing.assert_array_equal(gres, wres)
    hit = wres & (wb <= k)
    np.testing.assert_array_equal(gb[wres], wb[wres])
    np.testing.assert_array_equal(gpos[hit], wpos[hit])


def test_filter_verify_batch_matches_jax_on_a_jax_built_index(rng):
    """The port's filter + verify on the JAX package's own index (carried
    across by convert.index_from_jax) == the JAX Pallas path (interpret)."""
    tlen, qlen, k = 2500, 40, 4
    t = rng.randint(0, SIGMA, tlen).astype(np.int32)
    reads = _mapping_reads(rng, t, 8, qlen, n_random=2)
    qlens = np.full(8, qlen, np.int32)
    want, got = _both_filters(rng, t, reads, qlens, k, maxc=4,
                              jax_index=True)
    _assert_same_verdicts(want, got, k)
    assert want[2].any() and (want[0][want[2]] <= k).any()


@pytest.mark.slow
@pytest.mark.parametrize("sigma", [4, 40])
def test_filter_verify_batch_matches_jax_mixed_lengths(rng, sigma):
    tlen, qlen, k = 3000, 60, 4
    t = rng.randint(0, sigma, tlen).astype(np.int32)
    reads = _mapping_reads(rng, t, 12, qlen, n_random=3, sigma=sigma)
    qlens = rng.randint(qlen - 10, qlen + 1, 12).astype(np.int32)
    want, got = _both_filters(rng, t, reads, qlens, k, maxc=2, sigma=sigma)
    _assert_same_verdicts(want, got, k)


def test_filter_verify_resolves_mapping_reads(rng):
    """Exactness of the port's filter alone: every resolved read with a hit
    <= k reports the host DP's best and first position."""
    tlen, qlen, k = 4000, 60, 6
    t = rng.randint(0, SIGMA, tlen).astype(np.int32)
    reads = _mapping_reads(rng, t, 10, qlen, n_random=2)
    qlens = np.full(10, qlen, np.int32)
    L, stride, n_win = tqf.window_geometry(tlen, qlen, k)
    q = tqf.choose_q(SIGMA, qlen, k, L)
    gb, gp, res = (x.numpy() for x in tqf.filter_verify_map(
        _t(reads.astype(np.uint8)), _t(qlens), _t(t), sigma=SIGMA, q=q, L=L,
        stride=stride, n_win=n_win, k=k, maxc=8, nw=2))
    assert res.mean() > 0.5
    for b in range(10):
        D = np.arange(qlen + 1)[:, None] + np.zeros(tlen + 1, np.int64)
        D[0] = 0
        for i in range(1, qlen + 1):
            diag = D[i - 1, :-1] + (reads[b, i - 1] != t)
            e = np.concatenate([[i], np.minimum(diag, D[i - 1, 1:] + 1)])
            D[i] = np.minimum.accumulate(e - np.arange(tlen + 1)) \
                + np.arange(tlen + 1)
        best = D[qlen, 1:].min()
        if res[b] and best <= k:
            assert (gb[b], gp[b]) == (best, int(np.argmin(D[qlen, 1:])))
        elif res[b]:
            assert gb[b] > k
