"""The port's score-stream and eq-stream routes against the JAX package, on
the CPU.

The kernels sweep_scores, reduce_eqstream and hits_eqstream run their plain
PyTorch versions here (CPU tensors); chip_smoke.py holds the CUDA kernels
against those plain versions on the card.  Every output is an integer, so
every comparison is exact equality.  Inputs come from seeded numpy and go to
both packages; the Pallas kernels run in interpret mode at one- and two-word
shapes.

The routes: a per-lane bucket past the per-lane kernels' alphabet cap that
the bit-plane kernels do not take goes to the eq-stream kernels when the
JAX package's footprint test passes (EDLIB_TPU_EQSTREAM_MAX_MB, 1024 by
default; 0 fails it), else to the score stream.  Dense equalities (a symbol
with more than 4 partners) at sigma ~100 reach them at any size; a plain DNA
bucket reaches them only past the bit-plane budget (queries past 65,536 bp),
so those tests shrink the routing budget on both sides (ck's
_ROUTING_VMEM_BYTES and pallas_kernel's _vmem_limit_cache).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import edlib_tpu
import edlib_tpu_torch
from edlib_tpu import batch as jbatch
from edlib_tpu import encode as jenc
from edlib_tpu.ops import host as host_engine
from edlib_tpu.ops import jax_engine
from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu.ops import segmented as jseg
from edlib_tpu_torch import batch as tbatch
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops import segmented as tseg
from edlib_tpu_torch.ops.sweeper import Sweeper

BIG = 0x3FFFFFFF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _profiles(rng, B, sigma, nw):
    """uint32 (B, sigma+1, nw) profiles of random queries, some shorter than
    the bucket (pad rows match every symbol)."""
    eq = np.eye(sigma, dtype=bool)
    peq = np.zeros((B, sigma + 1, nw), np.uint32)
    for b in range(B):
        q = rng.randint(0, sigma, rng.randint(1, nw * 32 + 1))
        peq[b] = jenc.build_peq_words(q.astype(np.int32), eq, n_words=nw)
    return peq


def _windows(rng, B, T):
    lo = rng.randint(0, T // 2, B).astype(np.int32)
    hi = (lo + rng.randint(1, T, B)).clip(max=T).astype(np.int32)
    hi[-1] = 0                                       # a pad lane: no columns
    return lo, hi


@pytest.fixture
def routes(monkeypatch):
    """Counts of calls to each kernel wrapper (plain versions run here)."""
    calls = {f.__name__: 0 for f in ck.KERNELS}
    for f in ck.KERNELS:
        def spy(*a, _f=f, **kw):
            calls[_f.__name__] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(ck, f.__name__, spy)
    return calls


# --------------------------------------------------------------------------
# The kernels' plain versions against the JAX package's kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nw,hin0,sigma", [
    (1, 0, 4), (2, 1, 4), (2, 0, 100), (1, 1, 256), (9, 0, 100), (9, 1, 4)])
def test_sweep_scores_plain_matches_jax(rng, nw, hin0, sigma):
    """The whole (B, T) stream == jax_engine.sweep_scores and, at one and
    two words, PallasSweeper.sweep in interpret mode; T ragged (not a
    multiple of 32 or of the Pallas chunk); nw=9 is past the kernel's
    register-resident word counts."""
    B, T = 11, 77
    peq = _profiles(rng, B, sigma, nw)
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    want = np.asarray(jax_engine.sweep_scores(peq, tg, hin0=hin0))
    before = ck.launch_counts()
    got = ck.sweep_flat_device(convert.bit_words(peq), _t(tg), hin0)
    assert ck.launch_counts() == before              # CPU: no launch
    assert got.shape == (B, T) and got.t().is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    if nw <= 2 and sigma <= 100:
        sweeper = pk.PallasSweeper(chunk=32, interpret=True)
        np.testing.assert_array_equal(got.numpy(),
                                      sweeper.sweep(peq, tg, hin0=hin0))


def test_sweep_scores_lanes_read_rows_by_index(rng):
    """prow / trow name each lane's profile and target row: equal to the
    sweep of the gathered rows, and the Sweeper's full sweep."""
    sigma, nw, T = 7, 2, 64
    peq = _profiles(rng, 3, sigma, nw)
    rows = rng.randint(0, sigma + 1, (4, T)).astype(np.int32)
    prow = rng.randint(0, 3, 9).astype(np.int32)
    trow = rng.randint(0, 4, 9).astype(np.int32)
    got = ck.sweep_scores(convert.bit_words(peq), _t(rows), _t(prow),
                          _t(trow), 1)
    want = np.asarray(jax_engine.sweep_scores(peq[prow], rows[trow], hin0=1))
    np.testing.assert_array_equal(got.numpy(), want)
    swept = Sweeper(torch.device("cpu")).sweep(
        convert.bit_words(peq[prow]), rows[trow], 1)
    np.testing.assert_array_equal(swept.numpy(), want)


@pytest.mark.parametrize("sigma", [25, 64, 200, 256])
def test_eqstream_gather_matches_numpy(rng, sigma):
    B, NW, T = 9, 3, 70
    peq = rng.randint(0, 1 << 32, size=(B, sigma + 1, NW)).astype(np.uint32)
    tg = rng.randint(0, sigma + 1, size=(B, T)).astype(np.int32)
    got = ck.eqstream_gather(convert.bit_words(peq), _t(tg))
    assert got.shape == (B, T, NW) and got.permute(1, 2, 0).is_contiguous()
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  peq[np.arange(B)[:, None], tg, :])
    np.testing.assert_array_equal(
        _bits(got.numpy()),
        np.asarray(pk.eqstream_gather(jnp.asarray(peq), jnp.asarray(tg))))


@pytest.mark.parametrize("nw,hin0,sigma", [(1, 0, 70), (2, 1, 200),
                                           (2, 0, 256), (1, 1, 4)])
def test_eqstream_kernels_plain_match_pallas(rng, nw, hin0, sigma):
    """reduce_flat_device_eqstream (reduce_eqstream_plain, then
    hits_eqstream_plain at the found best) == the Pallas eq-stream kernels
    in interpret mode: best, pfirst, plast, last and the raw hit words, a
    pad lane (hi = 0) included."""
    B, T = 13, 150
    peq = _profiles(rng, B, sigma, nw)
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    lo, hi = _windows(rng, B, T)
    want = pk.reduce_flat_device_eqstream(
        jnp.asarray(peq), jnp.asarray(tg), jnp.asarray(lo), jnp.asarray(hi),
        hin0=hin0, chunk=32, want_hits=True, interpret=True)
    got = ck.reduce_flat_device_eqstream(
        convert.bit_words(peq), _t(tg), _t(lo), _t(hi), hin0=hin0, chunk=32,
        want_hits=True)
    assert len(got) == 5
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(_bits(got[4].numpy()), np.asarray(want[4]))
    assert got[0][-1] == BIG and got[1][-1] == -1


def test_eqstream_kernels_plain_match_sweep_scores(rng):
    """At nine words (the kernels' scratch path) the eq-stream reduce and
    hits equal the same reductions of jax_engine's score stream."""
    B, T, nw, sigma = 6, 90, 9, 30
    peq = _profiles(rng, B, sigma, nw)
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    lo, hi = _windows(rng, B, T)
    scores = np.asarray(jax_engine.sweep_scores(peq, tg, hin0=0))
    eq_t = ck.eqstream_gather(convert.bit_words(peq), _t(tg)).permute(1, 2, 0)
    best, pf, pl_, last = (x.numpy() for x in ck.reduce_eqstream(
        eq_t, _t(lo), _t(hi), 0))
    hits = _bits(ck.hits_eqstream(eq_t, _t(lo), _t(hi), _t(best), 0).numpy())
    for b in range(B - 1):
        s = scores[b, lo[b]:hi[b]]
        cols = np.nonzero(s == s.min())[0] + lo[b]
        assert (best[b], pf[b], pl_[b], last[b]) == (
            s.min(), cols[0], cols[-1], scores[b, hi[b] - 1])
        bits = np.nonzero((hits[b][:, None] >> np.arange(32)) & 1)
        np.testing.assert_array_equal(np.sort(bits[0] * 32 + bits[1]), cols)


def test_summarize_streams_matches_jax(rng):
    """The device summary of a bucket's streams == batch._summarize_stream
    of each lane's real columns, ties and hits included."""
    B, T = 10, 96
    streams = rng.randint(3, 9, (B, T)).astype(np.int32)
    lo = rng.randint(0, 40, B).astype(np.int32)
    hi = (lo + rng.randint(1, 56, B)).astype(np.int32)
    metas = [(1, int(w), T) for w in lo]
    outs = tbatch._summarize_streams(_t(streams), _t(lo), _t(hi), True)
    got = tbatch._summaries(list(range(B)), metas, outs, True)
    for b in range(B):
        want = jbatch._summarize_stream(streams[b, lo[b]:hi[b]], True)
        for key in ("best", "pos_first", "pos_last", "last_score"):
            assert getattr(got[b], key) == getattr(want, key), (b, key)
        np.testing.assert_array_equal(got[b].positions, want.positions)


@pytest.mark.parametrize("cap_mb", [None, "0", "64", "4096"])
def test_eqstream_ok_matches_jax(monkeypatch, cap_mb):
    """The footprint test reads EDLIB_TPU_EQSTREAM_MAX_MB with the JAX
    meaning, so both packages send a bucket to the same route."""
    if cap_mb is None:
        monkeypatch.delenv("EDLIB_TPU_EQSTREAM_MAX_MB", raising=False)
    else:
        monkeypatch.setenv("EDLIB_TPU_EQSTREAM_MAX_MB", cap_mb)
    for n in (1, 8, 1024, 1025, 4096, 8192):
        for nw in (1, 4, 64, 4096):
            for t_scan in (32, 1024, 131072):
                for sigma in (4, 100, 255):
                    assert ck.eqstream_ok(n, nw, t_scan, sigma) \
                        == jbatch._eqstream_ok("interpret", n, nw, t_scan,
                                               sigma)


def test_bigalpha_route_matches_jax(monkeypatch):
    """("bitplane", plan) / ("eqstream", None) / the score stream, as the
    JAX package routes (its (None, None) is the port's "stream")."""
    sigma = 100
    sparse = np.eye(sigma, dtype=bool)
    dense = sparse.copy()
    dense[5, 10:21] = dense[10:21, 5] = True         # 11 partners
    for env in ("1", "0"):
        monkeypatch.setenv("EDLIB_TPU_BITPLANE", env)
        for eq in (sparse, dense):
            for n, nw, t_scan in ((16, 4, 1024), (8192, 4, 1024),
                                  (1, 4096, 131072), (4096, 4, 1024)):
                got = tbatch._bigalpha_route(sigma, eq, n, nw, t_scan)
                want = jbatch._bigalpha_route("tpu", sigma, eq, n, nw,
                                              t_scan)
                assert got[0] == (want[0] or "stream"), (env, n, nw)
                if want[0] == "bitplane":
                    for g, w in zip(got[1], want[1]):
                        np.testing.assert_array_equal(g, w)
    monkeypatch.setenv("EDLIB_TPU_BITPLANE", "1")
    assert tbatch._bigalpha_route(sigma, dense, 4096, 4, 1024)[0] \
        == "eqstream"
    assert tbatch._bigalpha_route(sigma, dense, 8192, 4, 1024)[0] == "stream"
    assert tbatch._bigalpha_route(4, np.eye(4, dtype=bool), 1, 4096,
                                  131072)[0] == "stream"


# --------------------------------------------------------------------------
# align_batch on each route against edlib_tpu
# --------------------------------------------------------------------------


def _seq(rng, n, alphabet):
    return bytes(rng.choice(list(alphabet), n).tolist())


def _mutate(rng, s, alphabet, rate):
    out = bytearray()
    for ch in s:
        r = rng.rand()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(int(rng.choice(list(alphabet))))
        elif r < rate:
            out += bytes([ch, int(rng.choice(list(alphabet)))])
        else:
            out.append(ch)
    return bytes(out)


def _route_env(monkeypatch, route):
    if route == "stream":
        monkeypatch.setenv("EDLIB_TPU_EQSTREAM_MAX_MB", "0")
    else:
        monkeypatch.delenv("EDLIB_TPU_EQSTREAM_MAX_MB", raising=False)


def _check_route(routes, route, mode):
    """Every bucket took `route`: HW/SHW main sweeps want their hit masks,
    NW only its last column."""
    if route == "eqstream":
        assert routes["reduce_eqstream"] > 0 and routes["sweep_scores"] == 0
        assert (routes["hits_eqstream"] > 0) == (mode != "NW")
    else:
        assert routes["sweep_scores"] > 0
        assert routes["reduce_eqstream"] == routes["hits_eqstream"] == 0
    assert routes["reduce_bitplane"] == routes["reduce_lanes"] == 0


@pytest.mark.parametrize("route", ["eqstream", "stream"])
@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_dna_bucket_past_routing_budget_matches_jax(rng, routes, monkeypatch,
                                                   route, mode):
    """A per-lane DNA bucket that fits neither the per-lane nor the
    bit-plane kernels' routing budget (as every query past 65,536 bp does)
    takes the eq-stream or the score-stream route instead of raising.  With
    the budget shrunk to 128 KiB on both sides, 4-word buckets (97-128 bp)
    are past max_sigma1(4) = 2 and bitplane_ok(4, 4, 1) fails."""
    monkeypatch.setattr(ck, "_ROUTING_VMEM_BYTES", 128 * 1024)
    monkeypatch.setattr(pk, "_vmem_limit_cache", 128 * 1024)
    assert ck.max_sigma1(4, False) == pk.max_sigma1(4, False) == 2
    assert not ck.bitplane_ok(4, 4, 1) and not pk.bitplane_ok(4, 4, 1)
    _route_env(monkeypatch, route)
    A = b"ACGT"
    qs = [_seq(rng, n, A) for n in (97, 110, 128, 120)]
    ts = [_mutate(rng, q, A, 0.1) + _seq(rng, 20, A) for q in qs]
    task = "distance" if mode == "NW" else "locations"
    for k in (-1, 5):
        got = edlib_tpu_torch.align_batch(qs, ts, mode=mode, task=task, k=k,
                                          device="cpu")
        want = edlib_tpu.align_batch(qs, ts, mode=mode, task=task, k=k,
                                     backend="host")
        assert got == want, k
    _check_route(routes, route, mode)


def _dense_batch(rng, sigma=100, n_pairs=6):
    """sigma ~100 pairs (every symbol present) and equalities giving one
    symbol 11 partners: the bit-plane kernels take at most 4."""
    A = bytes(range(33, 33 + sigma))
    qs = [_seq(rng, n, A) for n in (31, 45, 64, 50, 60, 40)[:n_pairs]]
    ts = [_mutate(rng, q, A, 0.15) + _seq(rng, 60, A) for q in qs]
    ts[0] += A                                      # every symbol occurs
    eqs = [(A[5], A[i]) for i in range(10, 21)]
    return qs, ts, eqs


@pytest.mark.parametrize("route", ["eqstream", "stream"])
@pytest.mark.parametrize("task", ["distance", "locations"])
@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_dense_equalities_match_jax_host(rng, routes, monkeypatch, route,
                                         task, mode):
    _route_env(monkeypatch, route)
    qs, ts, eqs = _dense_batch(rng)
    for k in (-1, 7):
        got = edlib_tpu_torch.align_batch(qs, ts, mode=mode, task=task, k=k,
                                          additionalEqualities=eqs,
                                          device="cpu")
        want = edlib_tpu.align_batch(qs, ts, mode=mode, task=task, k=k,
                                     additionalEqualities=eqs,
                                     backend="host")
        assert got == want, k
    _check_route(routes, route, mode)


@pytest.mark.parametrize("route", ["eqstream", "stream"])
@pytest.mark.parametrize("mode,task", [("NW", "distance"),
                                       ("SHW", "locations"),
                                       ("HW", "locations"), ("HW", "path")])
def test_dense_equalities_match_jax_device_path(rng, routes, monkeypatch,
                                                route, mode, task):
    """The JAX package's align_batch_device in interpret mode takes the same
    route (its eq-stream kernels, or jax_engine's stream) with the same
    results; HW path reconstructs its windows on the host (sigma+1 is past
    the capture kernel's cap on both sides)."""
    monkeypatch.setenv("EDLIB_TPU_FORCE_PALLAS", "interpret")
    _route_env(monkeypatch, route)
    qs, ts, eqs = _dense_batch(rng, n_pairs=4)
    want = jbatch.align_batch_device(qs, ts, mode=mode, task=task,
                                     additionalEqualities=eqs)
    got = edlib_tpu_torch.align_batch(qs, ts, mode=mode, task=task,
                                      additionalEqualities=eqs, device="cpu")
    assert got == want
    assert got == edlib_tpu.align_batch(qs, ts, mode=mode, task=task,
                                        additionalEqualities=eqs,
                                        backend="host")
    _check_route(routes, route, mode)
    if task == "path":
        assert tbatch.path_route_counts()["capture"] == 0


def test_align_long_hw_read_takes_a_stream_route(rng, routes, monkeypatch):
    """align() of one pair past the per-lane budget (shrunk here) answers
    as edlib_tpu.align, in every mode."""
    monkeypatch.setattr(ck, "_ROUTING_VMEM_BYTES", 128 * 1024)
    monkeypatch.setenv("EDLIB_TPU_EQSTREAM_MAX_MB", "0")
    A = b"ACGT"
    q = _seq(rng, 120, A)
    t = _seq(rng, 30, A) + _mutate(rng, q, A, 0.05) + _seq(rng, 30, A)
    for mode in ("NW", "SHW", "HW"):
        assert edlib_tpu_torch.align(q, t, mode=mode, task="locations",
                                     device="cpu") \
            == edlib_tpu.align(q, t, mode=mode, task="locations")
    assert routes["sweep_scores"] > 0


# --------------------------------------------------------------------------
# hw_stream_segmented
# --------------------------------------------------------------------------


def test_segment_target_matches_jax(rng):
    for tlen, halo, w_pad in ((1500, 79, 24), (997, 33, 15), (40, 10, 0)):
        t = rng.randint(0, 4, tlen).astype(np.int32)
        n_seg, core = tseg.plan_segments(tlen, halo, w_pad)
        np.testing.assert_array_equal(
            tseg.segment_target(t, 4, n_seg, core, halo, w_pad),
            jseg.segment_target(t, 4, n_seg, core, halo, w_pad))


@pytest.mark.parametrize("qlen,tlen,k_frac", [(40, 1500, 1.0), (64, 2000, 1.0),
                                              (17, 997, 1.0), (50, 1200, 0.3)])
def test_hw_stream_segmented_matches_jax(rng, monkeypatch, qlen, tlen,
                                         k_frac):
    """The port's segmented stream == the JAX one (Pallas interpret),
    entry for entry, and the host engine's stream wherever <= k_eff."""
    monkeypatch.setenv("EDLIB_TPU_FORCE_PALLAS", "interpret")
    sigma = 4
    q = rng.randint(0, sigma, qlen).astype(np.uint8)
    t = rng.randint(0, sigma, tlen).astype(np.uint8)
    s = rng.randint(0, tlen - qlen)
    t[s:s + qlen] = q
    k_eff = max(1, int(qlen * k_frac))
    got = tseg.hw_stream_segmented(q, t.astype(np.int32), sigma, k_eff,
                                   device="cpu")
    want = jseg.hw_stream_segmented(q, t.astype(np.int32), sigma, k_eff)
    np.testing.assert_array_equal(got, want)
    truth = host_engine.semiglobal_scores(
        jenc.build_peq_bigint(q, np.eye(sigma, dtype=bool)), t, qlen, "HW")
    exact = truth <= k_eff
    np.testing.assert_array_equal(got[exact], truth[exact])
    assert (got >= truth).all() and got.min() == truth.min()


def test_hw_stream_segmented_any_sigma(rng):
    """Past the JAX function's alphabet cap (it returns None there) the
    port's stream still equals the host engine's."""
    sigma, qlen, tlen = 100, 45, 900
    q = rng.randint(0, sigma, qlen).astype(np.uint8)
    t = rng.randint(0, sigma, tlen).astype(np.uint8)
    t[300:300 + qlen] = q
    got = tseg.hw_stream_segmented(q, t.astype(np.int32), sigma, qlen,
                                   device="cpu")
    truth = host_engine.semiglobal_scores(
        jenc.build_peq_bigint(q, np.eye(sigma, dtype=bool)), t, qlen, "HW")
    np.testing.assert_array_equal(got, truth)


def test_stream_wrappers_check_operands():
    i32 = dict(dtype=torch.int32)
    with pytest.raises(TypeError, match="peq must be int32"):
        ck.sweep_scores(torch.zeros(2, 5, 1, dtype=torch.int64),
                        torch.zeros(2, 10, **i32), torch.zeros(3, **i32),
                        torch.zeros(3, **i32), 0)
    with pytest.raises(ValueError, match="trow has 2 lanes"):
        ck.sweep_scores(torch.zeros(2, 5, 1, **i32), torch.zeros(2, 10, **i32),
                        torch.zeros(3, **i32), torch.zeros(2, **i32), 0)
    with pytest.raises(ValueError, match="eq_t has 4 lanes"):
        ck.reduce_eqstream(torch.zeros(10, 2, 4, **i32),
                           torch.zeros(3, **i32), torch.zeros(3, **i32), 0)
    with pytest.raises(ValueError, match="no words"):
        ck.reduce_eqstream(torch.zeros(10, 0, 3, **i32),
                           torch.zeros(3, **i32), torch.zeros(3, **i32), 0)
    with pytest.raises(ValueError, match="best has 2 lanes"):
        ck.hits_eqstream(torch.zeros(10, 2, 3, **i32), torch.zeros(3, **i32),
                         torch.zeros(3, **i32), torch.zeros(2, **i32), 0)
    with pytest.raises(ValueError, match="must be contiguous"):
        ck.reduce_eqstream(torch.zeros(3, 2, 10, **i32).permute(2, 1, 0),
                           torch.zeros(3, **i32), torch.zeros(3, **i32), 0)
