"""edlib_tpu_torch's long-pair wavefront against edlib_tpu, on the CPU.

The wavefront kernels' plain versions against the Pallas kernels in
interpret mode (the state after each of two segments, carried across with
convert.py); the port's Wavefront / BandedWavefront (device="cpu") against
the JAX classes in interpret mode and the JAX host engine; nw_distance_long,
shw_best_long and semiglobal_locations_long against edlib_tpu's; align's
huge-NW route and the device Hirschberg half-sweeps against edlib_tpu.align.
Inputs come from seeded numpy; every comparison is exact.
"""

import importlib

import numpy as np
import pytest
import torch

import edlib_tpu
import edlib_tpu_torch
from edlib_tpu import encode as jenc
from edlib_tpu.ops import host as jhost
from edlib_tpu.ops import wavefront as jwf
from edlib_tpu_torch import convert
from edlib_tpu_torch import encode as tenc
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops import host as thost
from edlib_tpu_torch.ops import wavefront as twf
from edlib_tpu_torch.path import hirschberg as thb
from edlib_tpu_torch.utils import profiling

talign = importlib.import_module("edlib_tpu_torch.align")
CPU = torch.device("cpu")
DNA = b"ACGT"
EYE4 = np.eye(4, dtype=bool)


def _similar(rng, qlen, tlen, rate, offset=0):
    """(q, t) uint8 ids: t random, q = t[offset:offset+qlen] with `rate`
    substitutions (random tail where t is short)."""
    t = rng.randint(0, 4, tlen).astype(np.uint8)
    q = t[offset:offset + qlen].copy()
    if len(q) < qlen:
        q = np.concatenate([q, rng.randint(0, 4, qlen - len(q))
                            .astype(np.uint8)])
    m = rng.rand(qlen) < rate
    q[m] = rng.randint(0, 4, int(m.sum()))
    return q, t


def _host_nw(q, t):
    st, _, _ = jhost.nw_run(jenc.build_peq_bigint(q, EYE4), t, len(q))
    return int(st.score)


def _t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


# --------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels in interpret mode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("hin0,emit,cols,word0,chunk,ext", [
    (0, True, None, 0, 32, True),        # HW stream
    (1, False, "real", 0, 32, True),     # SHW best over the real columns
    (1, True, (5, 60), 0, 32, True),     # a column range and a stream
    (1, True, None, 2, 32, True),        # pinned window from word 2
    (0, True, (0, 90), 0, 8, True),      # ragged: 40-step segments
    (1, False, None, 0, 32, False),      # column_cells: no wildcard tail
])
def test_wavefront_plain_matches_pallas_interpret(rng, hin0, emit, cols,
                                                  word0, chunk, ext):
    """Two segments of _wavefront_call against wavefront_plain from the
    same state: every state plane (but the symbol window) and the stream."""
    q = rng.randint(0, 4, 100).astype(np.uint8)          # 4 words, w_pad 28
    t = rng.randint(0, 4, 150).astype(np.uint8)
    per_seg = 5                                          # chunks a segment
    jw = jwf.Wavefront(chunk=chunk, interpret=True)
    peq, _, n_words, R, w_pad, t_scan = jw._prepare(q, t, 4,
                                                    wildcard_ext=ext)
    col_lo, col_hi = ((0, 0) if cols is None else (w_pad, w_pad + len(t))
                      if cols == "real" else cols)
    n_steps = 2 * per_seg * chunk
    t_ext = np.full(max(n_steps, t_scan), 4, np.int32)   # wildcard past t
    t_ext[:len(t)] = t
    t_port = _t32(t_ext)
    peq_port = convert.bit_words(peq.reshape(5, -1))
    targets = t_ext
    if word0:
        # The pinned tail's operands: slot s is word word0 + s, and slot 0
        # takes the target of column d - word0 at step d.
        peq = np.zeros_like(peq.reshape(5, -1))
        peq[:, :-word0] = peq_port.numpy().view(np.uint32)[:, word0:]
        peq = peq.reshape(5, R, 128)
        targets = np.full_like(t_ext, 4)
        targets[word0:] = t_ext[:-word0]
    targets = targets[:n_steps].reshape(2 * per_seg, chunk, 1)
    state = jwf.Wavefront.initial_state(R)
    ours = convert.wavefront_state_from_jax(state)
    for seg in range(2):
        d = seg * per_seg * chunk
        _, state, stream = jwf._wavefront_call(
            np.array([d], np.int32), targets[seg * per_seg:
                                             (seg + 1) * per_seg],
            peq, state, R=R, sigma1=5, chunk=chunk, hin0=hin0,
            n_words=n_words, col_lo=col_lo, col_hi=col_hi, t_scan=t_scan,
            emit_stream=emit, word0=word0, interpret=True)
        ours, got = ck.wavefront(t_port, peq_port, ours, d, per_seg * chunk,
                                 n_words, t_scan, hin0, col_lo, col_hi,
                                 word0, emit)
        assert torch.equal(ours, convert.wavefront_state_from_jax(state))
        if emit:
            tiles = np.asarray(stream).reshape(per_seg, R * 128)
            want = tiles[:, :chunk][:, ::-1].reshape(-1)
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert got is None


@pytest.mark.parametrize("lo,cols", [(-10, None), (-40, (30, 2000))])
def test_wavefront_banded_plain_matches_pallas_interpret(rng, lo, cols):
    """r_min = 1: a 128-slot window over 160 words slides every 33 steps;
    two 300-step segments of _wfb_call against wavefront_banded_plain."""
    q, t = _similar(rng, 160 * 32 - 7, 5200, 0.05)
    jb = jwf.BandedWavefront(seg_steps=300, interpret=True, r_min=1)
    n_words = jenc.num_words(len(q))
    peq_flat, rows_all, t_ext, state = jb._init(q, t, 4, n_words, 1)
    t_scan = len(t) + n_words * 32 - len(q)
    col_lo, col_hi = (0, 0) if cols is None else cols
    ours = convert.wavefront_state_from_jax(state)
    t_port, peq_port = _t32(t_ext), convert.bit_words(peq_flat)
    for d in (0, 300):
        state = jb._segment(state, d, 300, peq_flat, rows_all, t_ext,
                            sigma=4, n_words=n_words, lo=lo, R=1,
                            t_scan=t_scan, col_lo=col_lo, col_hi=col_hi)
        ours = ck.wavefront_banded(t_port, peq_port, ours, d, 300, n_words,
                                   t_scan, lo, col_lo, col_hi)
        assert torch.equal(ours, convert.wavefront_state_from_jax(state))
    assert ck.wavefront_base(599, lo, n_words - 128) >= 16   # it slid


@pytest.mark.parametrize("extra_words", [0, 9])
@pytest.mark.parametrize("equalities", [False, True])
@pytest.mark.parametrize("sigma", [1, 4, 20, 256])
@pytest.mark.parametrize("qlen", [1, 31, 32, 33, 1000, 100_003])
def test_profile_on_the_device_matches_build_peq_words(rng, qlen, sigma,
                                                       equalities,
                                                       extra_words):
    """The banded and unbanded runs' profile, built with tensor operations
    on the query's device, equals encode.build_peq_words bit for bit:
    padding cells and row sigma all ones, equalities as
    additionalEqualities gives them, and n_words past the query's words
    (_full_rows' padding)."""
    alphabet = bytes(range(sigma))
    pairs = [(int(a), int(b)) for a, b in rng.randint(0, sigma, (5, 2))]
    eq = tenc.build_equality_matrix(alphabet, pairs if equalities else None)
    q = rng.randint(0, sigma, qlen).astype(np.uint8)
    n_words = tenc.num_words(qlen) + extra_words
    want = tenc.build_peq_words(q, eq, n_words=n_words).view(np.int32)
    got = twf._profile(q, sigma, n_words, eq, CPU)
    assert got.dtype == torch.int32 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), want)
    if not equalities:
        np.testing.assert_array_equal(
            twf._profile(q, sigma, n_words, None, CPU).numpy(), want)


def test_wavefront_state_round_trip(rng):
    state = convert.wavefront_state_from_jax(
        jwf.Wavefront.initial_state(8))
    state[4, :5] = torch.tensor([3, -1, 7, 0, 1 << 20], dtype=torch.int32)
    sym = rng.randint(0, 5, 1024)
    back = convert.wavefront_state_to_jax(state, symwin=sym)
    assert back.shape == (8, 8, 128) and back.dtype == np.uint32
    np.testing.assert_array_equal(back[2].reshape(-1), sym)
    assert torch.equal(convert.wavefront_state_from_jax(back), state)
    peq = rng.randint(0, 1 << 32, (5, 1024), dtype=np.uint64)
    banded = convert.wavefront_state_to_jax(state, sym, peq)
    assert banded.shape == (13, 8, 128)
    assert torch.equal(convert.wavefront_state_from_jax(banded), state)


def test_wavefront_wrappers_check_operands():
    t = torch.zeros(10, dtype=torch.int32)
    peq = torch.zeros(5, 2, dtype=torch.int32)
    state = twf.initial_state(128, CPU)
    before = ck.launch_counts()
    out, stream = ck.wavefront(t, peq, state, 0, 4, 2, 10, 1, 0, 0, 0, True)
    assert stream.shape == (4,) and ck.launch_counts() == before
    with pytest.raises(ValueError, match="state"):
        ck.wavefront(t, peq, state[:6].contiguous(), 0, 4, 2, 10, 1, 0, 0,
                     0, False)
    with pytest.raises(ValueError, match="n_words"):
        ck.wavefront_banded(t, peq, state, 0, 4, 3, 10, 0, 0, 0)
    with pytest.raises(TypeError, match="int32"):
        ck.wavefront_banded(t.long(), peq, state, 0, 4, 2, 10, 0, 0, 0)


# --------------------------------------------------------------------------
# The host classes against the JAX classes and the JAX host engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("qlen,tlen", [(1, 1), (5, 3), (40, 120), (64, 64),
                                       (100, 333), (129, 64), (300, 500)])
def test_wavefront_nw_and_column_cells(rng, qlen, tlen):
    q = rng.randint(0, 4, qlen).astype(np.uint8)
    t = rng.randint(0, 4, tlen).astype(np.uint8)
    wf = twf.Wavefront(chunk=64, device="cpu")
    assert wf.nw_distance(q, t, 4) == _host_nw(q, t)
    stop = max(0, tlen // 2 - 1)
    st, _, _ = jhost.nw_run(jenc.build_peq_bigint(q, EYE4), t, qlen,
                            stop=stop)
    want = jhost.decode_cells(st.Pv, st.Mv, qlen, boundary=stop + 1)
    np.testing.assert_array_equal(wf.column_cells(q, t, 4, stop), want)


@pytest.mark.parametrize("mode_is_hw", [True, False])
def test_wavefront_streams_and_best_match_jax(rng, mode_is_hw):
    """Full bottom-row streams and (best, first end) against the JAX class
    in interpret mode (small shapes) and the host engine, across segments
    and word-row boundaries."""
    wf = twf.Wavefront(chunk=64, seg_chunks=2, device="cpu")
    jw = jwf.Wavefront(chunk=64, interpret=True, seg_chunks=2)
    mode = "HW" if mode_is_hw else "SHW"
    for qlen, tlen in ((1, 1), (40, 120), (64, 64), (200, 333), (129, 64),
                       (4200, 600)):
        q = rng.randint(0, 4, qlen).astype(np.uint8)
        t = rng.randint(0, 4, tlen).astype(np.uint8)
        hs = jhost.semiglobal_scores(jenc.build_peq_bigint(q, EYE4), t, qlen,
                                     mode)
        got = wf.semiglobal_scores(q, t, 4, mode_is_hw=mode_is_hw)
        np.testing.assert_array_equal(got, hs)
        assert wf.semiglobal_best(q, t, 4, mode_is_hw) == (
            int(hs.min()), int(np.argmin(hs)))
        if qlen <= 200:
            np.testing.assert_array_equal(
                got, jw.semiglobal_scores(q, t, 4, mode_is_hw=mode_is_hw))


def test_host_semiglobal_scores_match_jax(rng):
    q = rng.randint(0, 4, 77).astype(np.uint8)
    t = rng.randint(0, 4, 300).astype(np.uint8)
    peq = jenc.build_peq_bigint(q, EYE4)
    for mode in ("HW", "SHW"):
        np.testing.assert_array_equal(
            thost.semiglobal_scores(peq, t, 77, mode),
            jhost.semiglobal_scores(peq, t, 77, mode))


def test_banded_nw_sliding_window_matches_jax(rng):
    """r_min = 1: a 128-slot window over a 157-word query slides ~30 times;
    the distance, and the k = truth / truth - 1 contract, equal the JAX
    class's and the host engine's."""
    q, t = _similar(rng, 5000, 5200, 0.05)
    truth = _host_nw(q, t)
    wfb = twf.BandedWavefront(seg_steps=512, r_min=1, device="cpu")
    assert wfb.nw_distance(q, t, 4) == truth
    assert wfb.nw_distance(q, t, 4, k=truth) == truth
    assert wfb.nw_distance(q, t, 4, k=truth - 1) == -1
    jb = jwf.BandedWavefront(seg_steps=512, interpret=True, r_min=1)
    assert jb.nw_distance(q, t, 4) == truth


@pytest.mark.parametrize("qlen,tlen,mut,offset", [
    (40, 120, 0.1, 0), (200, 300, 0.1, 0), (120, 80, 0.2, 0),
    (300, 290, 0.3, 0), (64, 500, 0.05, 0), (5000, 5300, 0.05, 100)])
def test_banded_shw_best_matches_host(rng, qlen, tlen, mut, offset):
    q, t = _similar(rng, qlen, tlen, mut, offset)
    hs = jhost.semiglobal_scores(jenc.build_peq_bigint(q, EYE4), t, qlen,
                                 "SHW")
    best, pos = int(hs.min()), int(np.argmin(hs))
    wfb = twf.BandedWavefront(seg_steps=512 if qlen > 1000 else 256,
                              r_min=1 if qlen > 1000 else 8, device="cpu")
    assert wfb.shw_best(q, t, 4) == (best, pos)
    assert wfb.shw_best(q, t, 4, k=best) == (best, pos)
    if best > 0:
        assert wfb.shw_best(q, t, 4, k=best - 1) == (-1, -1)


@pytest.mark.parametrize("r_min,seg,qlen,tlen,mut", [
    (1, 512, 1200, 1400, 0.05),   # ~9 slides, then the pinned tail
    (1, 512, 2300, 2100, 0.10),
    (8, 256, 300, 500, 0.10),     # the full window from step 0
    (1, 64, 900, 900, 0.30)])     # a wide band, tiny segments
def test_banded_shw_locations_matches_host(rng, r_min, seg, qlen, tlen,
                                           mut):
    from edlib_tpu.align import _INF, _filter_locations
    q, t = _similar(rng, qlen, tlen, mut)
    hs = jhost.semiglobal_scores(jenc.build_peq_bigint(q, EYE4), t, qlen,
                                 "SHW")
    want = _filter_locations(hs, qlen, _INF)
    wfb = twf.BandedWavefront(seg_steps=seg, r_min=r_min, device="cpu")
    got = wfb.shw_locations(q, t, 4)
    assert (got[0], list(got[1])) == (want[0], list(want[1]))
    assert wfb.shw_locations(q, t, 4, k=want[0])[0] == want[0]
    if want[0] > 0:
        assert wfb.shw_locations(q, t, 4, k=want[0] - 1) == (-1, [])


def test_banded_stream_handoff_geometry():
    """The port's landing walk across thousands of geometries: it ends at a
    step d with the window fully slid (base_of(d-1) == base_cap) and
    d <= d_emit (no emission column missed)."""
    rng = np.random.RandomState(0)
    wfb = twf.BandedWavefront(device="cpu")
    for _ in range(4000):
        qlen = int(rng.randint(64, 2_000_000))
        k = int(min(rng.choice([64, 128, 1000, 10_000, 100_000]), qlen))
        tlen_eff = min(int(qlen * rng.uniform(0.7, 1.5)), qlen + k)
        if qlen - k > tlen_eff:
            continue
        n_words = jenc.num_words(qlen)
        WINW = wfb._rows((2 * k + 31) // 33 + 3, n_words) * 128
        w_pad = n_words * 32 - qlen
        n_steps_total = tlen_eff + w_pad + n_words - 1
        base_cap = max(0, n_words - WINW)
        d_pin = 0 if base_cap == 0 else 33 * base_cap + 31 + k + 1
        d_emit = (n_words - 1) + w_pad + max(0, qlen - 1 - k)
        if d_pin > d_emit:
            continue  # the code path resets to the full window
        d = 0
        for steps, (d0, b) in enumerate(wfb._landing(d_pin, d_emit,
                                                     n_steps_total)):
            assert d0 == d and b >= 1 and steps < 10_000
            d += b
        assert d <= d_emit, (qlen, k, d, d_emit)
        assert ck.wavefront_base(d - 1, -k, base_cap) == base_cap


def test_banded_window_holds_bottom_word_at_last_step():
    """The port's banded runs stop at the last step, where the JAX package
    runs inert steps to a whole segment: equal whenever the window holds
    the bottom word by the last step, which holds for every NW geometry
    with |qlen - tlen| <= k (beyond it the distance exceeds k anyway)."""
    rng = np.random.RandomState(1)
    wfb = twf.BandedWavefront(r_min=1, device="cpu")
    for _ in range(20_000):
        qlen = int(rng.randint(1, 300_000))
        tlen = max(1, int(qlen * rng.uniform(0.5, 1.5)))
        k = int(rng.choice([64, 128, 256, 1000, 5000, 32768]))
        if abs(qlen - tlen) > k:
            continue
        n_words, lo, R = wfb._band_geometry(qlen, tlen, k)
        base_cap = max(0, n_words - R * 128)
        last = tlen + n_words * 32 - qlen + n_words - 2
        assert ck.wavefront_base(last, lo, base_cap) == base_cap, \
            (qlen, tlen, k)


# --------------------------------------------------------------------------
# The public functions against edlib_tpu's
# --------------------------------------------------------------------------


def _seq(rng, n):
    return bytes(rng.choice(list(DNA), n).tolist())


def _mutated(rng, s, n_sub):
    s = bytearray(s)
    for i in rng.choice(len(s), n_sub, replace=False):
        s[i] = rng.choice(list(DNA))
    return bytes(s)


@pytest.mark.parametrize("backend", ["auto", "wavefront", "native"])
def test_nw_distance_long_matches_jax(rng, backend):
    q, t = _seq(rng, 300), _seq(rng, 400)
    want = edlib_tpu.nw_distance_long(q, t, backend="native")
    f = edlib_tpu_torch.nw_distance_long
    assert f(q, t, backend=backend, device="cpu") == want
    assert f(q, t, k=want, backend=backend, device="cpu") == want
    assert f(q, t, k=want - 1, backend=backend, device="cpu") == -1
    for a, b in ((b"", t), (q, b""), (b"", b"")):
        assert f(a, b, backend=backend, device="cpu") == \
            edlib_tpu.nw_distance_long(a, b)
    assert f(b"", t, k=10, device="cpu") == -1


@pytest.mark.parametrize("backend", ["auto", "wavefront", "native"])
def test_shw_best_long_matches_jax(rng, backend):
    t = _seq(rng, 600)
    q = _mutated(rng, t[:300], 20)
    f = edlib_tpu_torch.shw_best_long
    want = edlib_tpu.shw_best_long(q, t, backend="native")
    assert f(q, t, backend=backend, device="cpu") == want
    assert f(q, t, k=want[0] - 1, backend=backend, device="cpu") == (-1, -1)
    # The -1 padding-artifact head (Q % 64 != 0, best == Q), and empties.
    for a, b in ((b"AAA", b"CCCCCC"), (b"Z" * 33, t), (b"", t), (q, b"")):
        assert f(a, b, backend=backend, device="cpu") == \
            edlib_tpu.shw_best_long(a, b, backend="native"), (a[:5], b[:5])
    assert f(b"AAA", b"", k=2, device="cpu") == (-1, -1)


@pytest.mark.parametrize("entry", ["shw_best_long", "locations_shw"])
def test_shw_ladder_shares_its_profile(rng, monkeypatch, entry):
    """An SHW ladder (k = -1, two rungs or more) builds its profile once and
    hands it to every rung; each rung makes its own scan targets (they end
    at min(tlen, qlen + k)).  The answers are the JAX package's."""
    t = _seq(rng, 600)
    q = _mutated(rng, t[:300], 120)
    made = {"profile": 0, "targets": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            made[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(twf, "_profile", spy("profile", twf._profile))
    monkeypatch.setattr(twf, "_scan_targets",
                        spy("targets", twf._scan_targets))
    profiling.take("wf.")
    twf.take_rungs()
    if entry == "shw_best_long":
        got = edlib_tpu_torch.shw_best_long(q, t, device="cpu")
        want = edlib_tpu.shw_best_long(q, t, backend="native")
    else:
        got = edlib_tpu_torch.semiglobal_locations_long(q, t, mode="SHW",
                                                        device="cpu")
        want = edlib_tpu.semiglobal_locations_long(q, t, mode="SHW",
                                                   backend="native")
    assert got == want
    n = len(twf.take_rungs())
    assert n >= 2
    assert made == {"profile": 1, "targets": n}
    assert profiling.take("wf.")[1] == {"wf.operands_built": 1,
                                        "wf.operands_reused": n - 1}


@pytest.mark.parametrize("mode", ["HW", "SHW"])
@pytest.mark.parametrize("backend", ["auto", "native"])
def test_semiglobal_locations_long_matches_jax(rng, mode, backend):
    t = _seq(rng, 700)
    q = _mutated(rng, t[200:500], 15)
    f = edlib_tpu_torch.semiglobal_locations_long
    want = edlib_tpu.semiglobal_locations_long(q, t, mode=mode,
                                               backend="native")
    ref = edlib_tpu.align(q, t, mode=mode)
    assert want == (ref["editDistance"], [e for _, e in ref["locations"]])
    assert f(q, t, mode=mode, backend=backend, device="cpu") == want
    assert f(q, t, mode=mode, k=want[0] - 1, backend=backend,
             device="cpu") == (-1, [])
    for a, b in ((b"Z" * 33, t), (b"AAA", b"CCCCCC"), (b"", t)):
        assert f(a, b, mode=mode, backend=backend, device="cpu") == \
            edlib_tpu.semiglobal_locations_long(a, b, mode=mode,
                                                backend="native")
    assert f(b"AC", b"", mode=mode, k=1, device="cpu") == (-1, [])


def test_long_functions_check_arguments(rng):
    with pytest.raises(ValueError, match="backend"):
        edlib_tpu_torch.nw_distance_long("AC", "AG", backend="tpu",
                                         device="cpu")
    with pytest.raises(ValueError, match="mode"):
        edlib_tpu_torch.semiglobal_locations_long("AC", "AG", mode="NW",
                                                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            edlib_tpu_torch.shw_best_long("AC", "AG")


# --------------------------------------------------------------------------
# align's huge-NW route and the device Hirschberg
# --------------------------------------------------------------------------


@pytest.fixture
def banded_calls(monkeypatch):
    calls = []
    orig = twf.BandedWavefront.nw_distance

    def spy(self, *a, **kw):
        calls.append(a[2])
        return orig(self, *a, **kw)

    monkeypatch.setattr(twf.BandedWavefront, "nw_distance", spy)
    return calls


def test_align_nw_wavefront_route(rng, monkeypatch, banded_calls):
    """With the gate at 1 cell, align takes the banded wavefront for NW
    (k, equalities, every task) and equals edlib_tpu.align."""
    t = _seq(rng, 900)
    q = bytearray(t[:800])
    for i in rng.choice(800, 40, replace=False):
        q[i] = rng.choice(list(b"ACGTN"))
    q = bytes(q)
    eqs = [("N", "A"), ("N", "C"), ("N", "G"), ("N", "T")]
    want = edlib_tpu.align(q, t, additionalEqualities=eqs)
    monkeypatch.setattr(talign, "_WAVEFRONT_MIN_CELLS", 1)
    for task in ("distance", "locations", "path"):
        for k in (-1, want["editDistance"], want["editDistance"] - 1):
            ref = edlib_tpu.align(q, t, task=task, k=k,
                                  additionalEqualities=eqs)
            got = edlib_tpu_torch.align(q, t, task=task, k=k,
                                        additionalEqualities=eqs,
                                        device="cpu")
            assert got == ref, (task, k)
    assert len(banded_calls) == 9
    # Below the gate the pair stays on the batch of one.
    banded_calls.clear()
    monkeypatch.setattr(talign, "_WAVEFRONT_MIN_CELLS", 800 * 900 + 1)
    assert edlib_tpu_torch.align(q, t, additionalEqualities=eqs,
                                 device="cpu") == want
    assert not banded_calls


def test_align_huge_nw_gate_is_similarity_aware(rng, monkeypatch,
                                                banded_calls):
    """The gate reads effective cells (2 * (d_ub + 1) * max_len): a similar
    pair stays on the batch of one where a dissimilar one of the same size
    takes the wavefront (edlib_tpu's _nw_effective_cells)."""
    t = _seq(rng, 1000)
    sim = _mutated(rng, t, 20)
    dis = _seq(rng, 1000)
    monkeypatch.setattr(talign, "_WAVEFRONT_MIN_CELLS", 500_000)
    assert edlib_tpu_torch.align(sim, t, device="cpu") == \
        edlib_tpu.align(sim, t)
    assert not banded_calls
    assert edlib_tpu_torch.align(dis, t, device="cpu") == \
        edlib_tpu.align(dis, t)
    assert banded_calls


def test_device_path_hirschberg(rng, monkeypatch):
    """Hirschberg nodes past the (lowered) device gate take their half-
    sweeps from Wavefront.column_cells; the CIGAR is edlib_tpu.align's."""
    t = _seq(rng, 2800)
    q = _mutated(rng, t[:2600], 200)
    want = edlib_tpu.align(q, t, mode="NW", task="path")
    q_ids, t_ids, alphabet = jenc.transform_sequences(q, t)
    eq = np.eye(len(alphabet), dtype=bool)
    calls = []
    orig = twf.Wavefront.column_cells

    def spy(self, *a, **kw):
        calls.append(len(a[0]))
        return orig(self, *a, **kw)

    def cigar():
        ops = thb.obtain_alignment(q_ids, t_ids, eq, want["editDistance"],
                                   device="cpu")
        return edlib_tpu_torch.alignment_to_cigar(ops)

    monkeypatch.setattr(twf.Wavefront, "column_cells", spy)
    monkeypatch.setattr(thb, "_DEVICE_PATH_MIN_CELLS", 2600 * 2800)
    assert cigar() == want["cigar"]
    assert calls == [2600, 2600]     # the root's two half-sweeps
    calls.clear()
    monkeypatch.setenv("EDLIB_TPU_DEVICE_PATH", "0")
    assert cigar() == want["cigar"] and not calls
    monkeypatch.setenv("EDLIB_TPU_DEVICE_PATH", "interpret")
    with pytest.raises(ValueError, match="EDLIB_TPU_DEVICE_PATH"):
        cigar()
