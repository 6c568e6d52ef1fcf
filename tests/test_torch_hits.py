"""The port's hit-mask kernels (hits_lanes, hits_bitplane) against the JAX
package, on the CPU.

Here the wrappers run their plain PyTorch versions (CPU tensors); the CUDA
kernels are held against those plain versions on the card by chip_smoke.py.
Every output is an integer (raw hit words included), so every comparison is
exact equality.  Inputs come from numpy with a fixed seed and go to both
packages.  The Pallas kernels run in interpret mode at one- and two-word
shapes (their unrolled bodies compile for minutes at eight words).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from edlib_tpu import batch as jbatch
from edlib_tpu import encode as jenc
from edlib_tpu.ops import jax_engine
from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops import sweeper as tsw


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reads(rng, B, qmax, sigma):
    q = rng.randint(0, sigma, (B, qmax)).astype(np.int32)
    qlens = rng.randint(1, qmax + 1, B).astype(np.int32)
    qlens[0] = qmax
    return q, qlens


def _windows(rng, B, T):
    lo = rng.randint(0, T // 2, B).astype(np.int32)
    hi = (lo + rng.randint(1, T, B)).clip(max=T).astype(np.int32)
    hi[-1] = 0                                       # a pad lane: no columns
    return lo, hi


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _stream_hits(scores, lo, hi, best):
    """numpy hit words of each row: bit c%32 of word c//32 where c in
    [lo, hi) and scores[c] == best."""
    B, T = scores.shape
    out = np.zeros((B, -(-T // 32)), np.uint32)
    for b in range(B):
        for c in range(max(0, lo[b]), min(T, hi[b])):
            if scores[b, c] == best[b]:
                out[b, c // 32] |= np.uint32(1) << np.uint32(c % 32)
    return out


@pytest.mark.parametrize("nw,hin0", [(1, 0), (2, 1), (9, 0)])
def test_hits_lanes_plain_matches_sweep_scores(rng, nw, hin0):
    """The plain hit mask == the JAX scan engine's score stream compared with
    each lane's best, lanes reaching rows by index (nw=9: past the
    register-resident word counts)."""
    B, T, sigma = 7, 90, 4
    q, qlens = _reads(rng, 3, nw * 32, sigma)
    peq = np.asarray(pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens),
                                         sigma, nw))
    rows = rng.randint(0, sigma + 1, (4, T)).astype(np.int32)
    prow = rng.randint(0, 3, B).astype(np.int32)
    trow = rng.randint(0, 4, B).astype(np.int32)
    lo, hi = _windows(rng, B, T)
    scores = np.asarray(jax_engine.sweep_scores(
        jnp.asarray(peq[prow]), jnp.asarray(rows[trow]), hin0=hin0))
    best = np.array([scores[b, lo[b]:hi[b]].min() if hi[b] > lo[b] else 0
                     for b in range(B)], np.int32)
    best[1] = -(1 << 30)                             # a lane with no hits
    before = ck.launch_counts()
    got = ck.hits_lanes(convert.bit_words(peq), _t(rows), _t(lo), _t(hi),
                        _t(prow), _t(trow), _t(best), hin0)
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _stream_hits(scores, lo, hi, best))
    assert ck.launch_counts() == before              # plain version: no launch


def test_reduce_flat_device_with_hits_matches_pallas_interpret(rng):
    """Per-lane reduce + hit words vs the TPU kernels (interpret mode), a
    window reaching past T into the chunk filler."""
    B, T, sigma, nw = 8, 80, 4, 2
    q, qlens = _reads(rng, B, 50, sigma)
    peq = pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens), sigma, nw)
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    lo, hi = _windows(rng, B, T)
    hi[0] = 90                        # past T: scans the S1-1 filler
    want = pk.reduce_flat_device(peq, jnp.asarray(tg), jnp.asarray(lo),
                                 jnp.asarray(hi), hin0=0, chunk=32,
                                 want_hits=True, interpret=True)
    got = ck.reduce_flat_device(convert.bit_words(np.asarray(peq)), _t(tg),
                                _t(lo), _t(hi), 0, chunk=32, want_hits=True)
    assert len(got) == 5
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(_bits(got[4].numpy()), np.asarray(want[4]))
    assert np.asarray(want[4]).any()


def test_hits_flat_device_shared_matches_pallas_interpret(rng):
    """The shared form: every lane against one target row (trow = 0)."""
    B, L, sigma, nw = 6, 70, 4, 1
    q, qlens = _reads(rng, B, 25, sigma)
    peq = pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens), sigma, nw)
    target = rng.randint(0, sigma, L).astype(np.int32)
    lo = (32 - qlens).astype(np.int32)
    hi = lo + L
    best = rng.randint(8, 20, B).astype(np.int32)
    best[2] = -(1 << 30)
    want = pk.hits_flat_device_shared(
        peq, jnp.asarray(target), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(best), hin0=1, fill_sym=sigma, chunk=32, interpret=True)
    got = ck.hits_flat_device_shared(
        convert.bit_words(np.asarray(peq)), _t(target), _t(lo), _t(hi),
        _t(best), 1, sigma, chunk=32)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_array_equal(_bits(got.numpy()), np.asarray(want))
    assert np.asarray(want).any()


@pytest.mark.parametrize("sigma,hin0", [(40, 0), (100, 1)])
def test_reduce_flat_device_bitplane_with_hits_matches_pallas_interpret(
        rng, sigma, hin0):
    B, T, nw = 6, 64, 1
    q, qlens = _reads(rng, B, 30, sigma)
    qa, pw = pk.bitplane_identity_operands(jnp.asarray(q), jnp.asarray(qlens),
                                           sigma, nw)
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    tg[:, ::3] = q[:, :1]             # repeats of a read symbol: more hits
    lo, hi = _windows(rng, B, T)
    want = pk.reduce_flat_device_bitplane(
        qa, pw, jnp.asarray(tg), jnp.asarray(lo), jnp.asarray(hi), hin0=hin0,
        sigma=sigma, chunk=32, want_hits=True, interpret=True)
    got = ck.reduce_flat_device_bitplane(
        *ck.bitplane_identity_operands(_t(q), _t(qlens), sigma, nw), _t(tg),
        _t(lo), _t(hi), hin0, sigma, chunk=32, want_hits=True)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(_bits(got[4].numpy()), np.asarray(want[4]))


def test_hits_bitplane_plain_with_equalities_matches_sweep_scores(rng):
    """Two alternatives per query row and a universal row (pad mask) against
    the scan engine on the equivalent profiles."""
    sigma, nw, B, T = 50, 2, 5, 70
    eq = np.eye(sigma, dtype=bool)
    eq[3, 7] = eq[7, 3] = True
    eq[5, :] = eq[:, 5] = True                       # universal symbol
    altset, universal, n_alts = jbatch._bigalpha_plan(sigma, eq)
    assert n_alts == 3
    q, qlens = _reads(rng, B, nw * 32, sigma)
    nb = ck.bitplane_nb(sigma)
    sent = (1 << nb) - 1
    R = nw * 32
    q_alts = np.full((B, n_alts, R), sent, np.int32)
    pad = np.ones((B, R), bool)
    peq = np.zeros((B, sigma + 1, nw), np.uint32)
    for b in range(B):
        qv = q[b, :qlens[b]]
        alts = altset[qv].T
        q_alts[b, :, :qlens[b]] = np.where(alts >= 0, alts, sent)
        pad[b, :qlens[b]] = universal[qv]
        peq[b] = jenc.build_peq_words(qv, eq, n_words=nw)
    planes = ck.bitplane_planes(_t(q_alts), nb)
    pad_words = ck._pack_bits(_t(pad))
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    lo, hi = _windows(rng, B, T)
    scores = np.asarray(jax_engine.sweep_scores(peq, jnp.asarray(tg),
                                                hin0=0))
    best = np.array([scores[b, lo[b]:hi[b]].min() if hi[b] > lo[b] else 0
                     for b in range(B)], np.int32)
    rows = _t(np.arange(B, dtype=np.int32))
    got = ck.hits_bitplane(planes, pad_words, _t(tg), _t(lo), _t(hi), rows,
                           rows, _t(best), 0, nb, n_alts, sigma)
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _stream_hits(scores, lo, hi, best))


def test_decode_hit_words_matches_jax(rng):
    """Decode of hit words on the words' device == the JAX package's
    per-row numpy decode."""
    words = rng.randint(0, 1 << 32, (9, 5), dtype=np.uint64).astype(np.uint32)
    words[words % 3 == 0] = 0
    words[4] = 0
    words[0, 0] = 0x80000001
    got = tsw.decode_hit_words(convert.bit_words(words))
    assert len(got) == 9
    for b in range(9):
        np.testing.assert_array_equal(got[b] - 7,
                                      jbatch._decode_hit_words(words[b], -7))
    assert tsw.decode_hit_words(torch.zeros((3, 0), dtype=torch.int32))[2] \
        .size == 0
