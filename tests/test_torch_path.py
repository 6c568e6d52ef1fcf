"""edlib_tpu_torch's PATH task (CIGARs) against edlib_tpu, on the CPU.

The capture kernel's plain version against the Pallas capture kernel in
interpret mode; the batched decode and walk (path/batched.py) against the
JAX package's in interpret mode; align_batch / align with task="path"
against edlib_tpu's host engines (which equal the reference edlib) and its
own device route (batch.align_batch_device) in interpret mode; the host
walker and Hirschberg against edlib_tpu's obtain_alignment; the CIGAR
helpers and getNiceAlignment against edlib_tpu's.  Inputs come from seeded
numpy; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import edlib_tpu
import edlib_tpu_torch
from edlib_tpu import batch as jbatch
from edlib_tpu import encode as jenc
from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu.path import batched as jbp
from edlib_tpu.path import hirschberg as jhb
from edlib_tpu_torch import batch as tbatch
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.path import batched as tbp
from edlib_tpu_torch.path import hirschberg as thb

CPU = torch.device("cpu")
DNA = b"ACGT"


def _seq(rng, n, alphabet=DNA):
    return bytes(rng.choice(list(alphabet), n).tolist())


def _mutate(rng, s, alphabet=DNA, rate=0.1):
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


@pytest.fixture
def routes(monkeypatch):
    """Calls of each kernel wrapper (plain versions run here), and the PATH
    route counts zeroed."""
    calls = {f.__name__: 0 for f in ck.KERNELS}
    for f in ck.KERNELS:
        def spy(*a, _f=f, **kw):
            calls[_f.__name__] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(ck, f.__name__, spy)
    tbatch.reset_path_route_counts()
    return calls


# --------------------------------------------------------------------------
# The capture kernel's plain version
# --------------------------------------------------------------------------


def _profiles(rng, B, nw, sigma, eq):
    """Profiles of random queries of random lengths (pad rows included),
    uint32 (B, sigma+1, nw) as edlib_tpu builds them."""
    qs = [rng.randint(0, sigma, rng.randint(1, nw * 32 + 1)) for _ in range(B)]
    return np.stack([jenc.build_peq_words(q, eq, n_words=nw) for q in qs])


def _check_capture(words, tg, hin0, want_h, chunk):
    want = pk.capture_flat_device(words, tg, hin0=hin0, chunk=chunk,
                                  interpret=True, want_h=want_h)
    got = ck.capture_flat_device(convert.bit_words(words),
                                 torch.from_numpy(tg), hin0, chunk, want_h)
    assert len(got) == len(want) == (4 if want_h else 2)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))


@pytest.mark.parametrize("nw", [1, 4, 16])
@pytest.mark.parametrize("want_h", [False, True])
@pytest.mark.parametrize("hin0", [0, 1])
def test_capture_plain_matches_pallas_interpret(rng, nw, want_h, hin0):
    """sigma = 4 profiles; T = 45 is not a multiple of the chunk (32), so
    the wildcard pad columns are captured too."""
    B, sigma, T = 6, 4, 45
    words = _profiles(rng, B, nw, sigma, np.eye(sigma, dtype=bool))
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    _check_capture(words, tg, hin0, want_h, chunk=32)


@pytest.mark.parametrize("hin0", [0, 1])
def test_capture_plain_matches_pallas_interpret_equalities(rng, hin0):
    sigma = 6
    eq = np.eye(sigma, dtype=bool)
    eq[0, 3] = eq[3, 0] = eq[2, 5] = eq[5, 2] = True
    words = _profiles(rng, 5, 2, sigma, eq)
    tg = rng.randint(0, sigma + 1, (5, 70)).astype(np.int32)
    _check_capture(words, tg, hin0, True, chunk=32)


def test_capture_outputs_are_lane_minor(rng):
    words = convert.bit_words(_profiles(rng, 3, 2, 4, np.eye(4, dtype=bool)))
    tg = torch.from_numpy(rng.randint(0, 5, (3, 9)).astype(np.int32))
    for x in ck.capture(words, tg, 1, True):
        assert x.shape == (3, 9, 2) and x.permute(1, 2, 0).is_contiguous()
    with pytest.raises(ValueError, match="lanes"):
        ck.capture(words, tg[:2].contiguous(), 1)


def test_peq_with_equalities_matches_build_peq_words(rng):
    sigma, nw = 7, 4
    eq = np.eye(sigma, dtype=bool)
    eq[1, 4] = eq[4, 1] = eq[2, 6] = eq[6, 2] = True
    eq_s1 = np.ones((sigma + 1, sigma + 1), bool)
    eq_s1[:sigma, :sigma] = eq
    qs = [rng.randint(0, sigma, n) for n in (1, 40, 128, 97)]
    q_arr = np.zeros((len(qs), nw * 32), np.int32)
    for row, q in enumerate(qs):
        q_arr[row, :len(q)] = q
    got = ck.build_peq_eq_device(torch.from_numpy(q_arr),
                                 torch.tensor([len(q) for q in qs]),
                                 torch.from_numpy(eq_s1), nw)
    want = np.stack([jenc.build_peq_words(q, eq, n_words=nw) for q in qs])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# --------------------------------------------------------------------------
# Batched windows: the decode and the walk
# --------------------------------------------------------------------------


def _windows(rng, case):
    sigma = 4
    eq = np.eye(sigma, dtype=bool)
    if case == "mixed":
        # Mixed word counts and window buckets in one call.
        pairs = [(rng.randint(0, sigma, rng.randint(3, 90)),
                  rng.randint(0, sigma, rng.randint(3, 200)))
                 for _ in range(16)]
    elif case == "boundary":
        # Walks that leave through the top row or the left column.
        pairs = [(np.zeros(1, np.int32), np.zeros(64, np.int32)),
                 (np.zeros(64, np.int32), np.zeros(1, np.int32)),
                 (np.arange(4) % sigma, np.arange(4)[::-1] % sigma),
                 (np.array([1]), np.array([2])),
                 (np.array([3, 3]), np.arange(130) % sigma)]
    else:
        eq[0, 3] = eq[3, 0] = True
        pairs = [(rng.randint(0, sigma, rng.randint(5, 60)),
                  rng.randint(0, sigma, rng.randint(5, 150)))
                 for _ in range(6)]
    pairs = [(q.astype(np.int32), w.astype(np.int32)) for q, w in pairs]
    dists = [int(edlib_tpu.align(q.astype(np.uint8).tobytes(),
                                 w.astype(np.uint8).tobytes(),
                                 additionalEqualities=[(0, 3)]
                                 if case == "equalities" else None)
                 ["editDistance"]) for q, w in pairs]
    return pairs, dists, sigma, eq


@pytest.mark.parametrize("case", ["mixed", "boundary", "equalities"])
def test_batched_windows_path_matches_jax(rng, routes, case):
    pairs, dists, sigma, eq = _windows(rng, case)
    want = jbp.batched_windows_path(pairs, dists, sigma, eq,
                                    mode="interpret")
    got = tbp.batched_windows_path(pairs, dists, sigma, eq, CPU)
    for i in range(len(pairs)):
        assert got[i].dtype == np.uint8
        np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))
    assert routes["capture"] > 0


def test_batched_windows_path_equals_host_walker(rng):
    """The two routes of the port emit the same ops."""
    pairs, dists, sigma, eq = _windows(rng, "mixed")
    got = tbp.batched_windows_path(pairs, dists, sigma, eq, CPU)
    for (q, w), d, ops in zip(pairs, dists, got):
        np.testing.assert_array_equal(thb.obtain_alignment(q, w, eq, d), ops)


def test_slab_constants_match_jax():
    for C in (128, 256, 512, 1024, 4096):
        for total in (32, 128, 512, 2048):
            assert tbp._slab_size(C, total) == jbp._slab_size(C, total)
    assert tbp.max_cells() == jbp.max_cells()


# --------------------------------------------------------------------------
# align_batch / align with task="path"
# --------------------------------------------------------------------------


def _check(qs, ts, mode, ks, eqs=None):
    for k in ks:
        got = edlib_tpu_torch.align_batch(qs, ts, mode=mode, task="path",
                                          k=k, additionalEqualities=eqs,
                                          device="cpu")
        want = edlib_tpu.align_batch(qs, ts, mode=mode, task="path", k=k,
                                     additionalEqualities=eqs,
                                     backend="host")
        assert got == want, f"mode={mode} k={k}"


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_align_batch_path_matches_jax(rng, routes, mode):
    """Per-lane targets, the -1 quirk lengths, an empty query and target,
    k = -1 and a k that cuts some pairs."""
    qs = [_seq(rng, n) for n in (31, 32, 64, 65, 0, 90, 7)]
    ts = [_mutate(rng, q, rate=r) + _seq(rng, 15)
          for q, r in zip(qs, (0.05, 0.1, 0.3, 0.05, 0.1, 0.15, 0.0))]
    ts[1] = b""
    _check(qs, ts, mode, ks=(-1, 5))
    assert routes["capture"] > 0
    assert tbatch.path_route_counts()["capture"] > 0


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_align_batch_path_shared_target_and_equalities(rng, routes, mode):
    target = _seq(rng, 300)
    qs = [_mutate(rng, target[s:s + n], rate=0.08)
          for s, n in ((10, 31), (50, 64), (200, 65), (0, 70))]
    qs += [_seq(rng, 40), b""]
    _check(qs, target, mode, ks=(-1, 4))
    _check(qs, target, mode, ks=(-1,), eqs=[("A", "T"), ("C", "G")])
    assert routes["capture"] > 0


@pytest.mark.parametrize("mode", ["NW", "HW"])
def test_oversize_windows_take_the_host_route(rng, routes, monkeypatch,
                                              mode):
    """EDLIB_TPU_BATCHED_PATH_MAX_CELLS lowered (as in the JAX package):
    windows past it take the host walker, the rest the capture kernel."""
    monkeypatch.setenv("EDLIB_TPU_BATCHED_PATH_MAX_CELLS", "900")
    qs = [_seq(rng, n) for n in (10, 20, 40, 50)]
    ts = [_mutate(rng, q) + _seq(rng, 4) for q in qs]
    _check(qs, ts, mode, ks=(-1,))
    counts = tbatch.path_route_counts()
    assert counts["capture"] > 0 and counts["host"] > 0
    assert counts["capture"] + counts["host"] == len(qs)


def test_sigma_past_the_per_lane_cap_takes_the_host_route(rng, routes):
    A = bytes(range(33, 133))
    qs = [_seq(rng, 40, A) for _ in range(3)]
    ts = [_mutate(rng, q, A) for q in qs]
    _check(qs, ts, "HW", ks=(-1,))
    assert tbatch.path_route_counts() == {"capture": 0, "host": 3}


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_align_batch_path_matches_jax_device_path_interpret(rng, routes,
                                                            monkeypatch,
                                                            mode):
    """The JAX package's device route with its batched PATH forced on
    (Pallas in interpret mode) at <= 2-word shapes."""
    monkeypatch.setenv("EDLIB_TPU_FORCE_PALLAS", "interpret")
    monkeypatch.setenv("EDLIB_TPU_BATCHED_PATH", "1")
    monkeypatch.setenv("EDLIB_TPU_PALLAS_CHUNK", "32")
    qs = [_seq(rng, n) for n in (12, 31, 50, 64)]
    ts = [_mutate(rng, q, rate=0.15) + _seq(rng, 20) for q in qs]
    want = jbatch.align_batch_device(qs, ts, mode=mode, task="path")
    got = edlib_tpu_torch.align_batch(qs, ts, mode=mode, task="path",
                                      device="cpu")
    assert got == want
    assert tbatch.path_route_counts() == {"capture": 4, "host": 0}


def test_align_path_matches_jax_align(rng):
    A = bytes(range(65, 70))
    for mode in ("NW", "SHW", "HW"):
        for q, t, k, eqs in ((_seq(rng, 40, A), _seq(rng, 70, A), -1, None),
                             (b"ACGTACGT", b"TTACGAACGTT", 2, [("A", "T")]),
                             (b"", b"ACG", -1, None),
                             (b"ACG", b"", 1, None),
                             ([1, 2, 3, 2], [2, 3, 2, 1, 1], -1, [(1, 3)]),
                             ("ñandú", "andú", -1, None)):
            assert edlib_tpu_torch.align(
                q, t, mode=mode, task="path", k=k, additionalEqualities=eqs,
                device="cpu") \
                == edlib_tpu.align(q, t, mode=mode, task="path", k=k,
                                   additionalEqualities=eqs)


def test_path_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edlib_tpu_torch.align_batch([b"ACG"], b"ACGT", task="path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edlib_tpu_torch.align(b"ACG", b"ACGT", task="path")


# --------------------------------------------------------------------------
# The host walker and Hirschberg
# --------------------------------------------------------------------------


@pytest.mark.parametrize("qlen,rate", [(300, 0.1), (2000, 0.05),
                                       (2100, 0.6)])
def test_host_path_matches_jax_obtain_alignment(rng, qlen, rate):
    """Below the reference's 1 MB traceback estimate the walker runs; above
    it (2000 x ~2000: ~1.3 MB) Hirschberg splits first.  edlib_tpu answers
    from its native engine."""
    eq = np.eye(4, dtype=bool)
    q = _seq(rng, qlen)
    t = _mutate(rng, q, rate=rate)
    d = edlib_tpu.align(q, t)["editDistance"]
    q_ids, t_ids = (np.array([DNA.index(c) for c in s], np.uint8)
                    for s in (q, t))
    big = (thb._traceback_mem_estimate(qlen, len(t))
           >= thb._TRACEBACK_MEM_LIMIT)
    assert big == (qlen >= 2000)
    np.testing.assert_array_equal(thb.obtain_alignment(q_ids, t_ids, eq, d),
                                  jhb.obtain_alignment(q_ids, t_ids, eq, d))


# --------------------------------------------------------------------------
# CIGAR helpers and getNiceAlignment
# --------------------------------------------------------------------------


def test_cigar_helpers_match_jax(rng):
    for n in (0, 1, 7, 200):
        ops = rng.randint(0, 4, n).astype(np.uint8)
        for fmt in (edlib_tpu_torch.CigarFormat.EXTENDED,
                    edlib_tpu_torch.CigarFormat.STANDARD):
            cig = edlib_tpu_torch.alignment_to_cigar(ops, fmt)
            assert cig == edlib_tpu.alignment_to_cigar(ops, int(fmt))
            np.testing.assert_array_equal(
                edlib_tpu_torch.cigar_to_alignment(cig),
                edlib_tpu.cigar_to_alignment(cig))
    for bad in ([0, 4], [-1]):
        for mod in (edlib_tpu_torch, edlib_tpu):
            with pytest.raises(ValueError, match="invalid op codes"):
                mod.alignment_to_cigar(bad)
    for bad in ("3=2", "=3", "3Q", "2=x1I"):
        for mod in (edlib_tpu_torch, edlib_tpu):
            with pytest.raises(ValueError, match="invalid CIGAR"):
                mod.cigar_to_alignment(bad)
    assert (edlib_tpu_torch.EDOP_MATCH, edlib_tpu_torch.EDOP_INSERT,
            edlib_tpu_torch.EDOP_DELETE, edlib_tpu_torch.EDOP_MISMATCH) \
        == (edlib_tpu.EDOP_MATCH, edlib_tpu.EDOP_INSERT,
            edlib_tpu.EDOP_DELETE, edlib_tpu.EDOP_MISMATCH)


def test_nice_alignment_matches_jax(rng):
    for mode in ("NW", "SHW", "HW"):
        q = _seq(rng, 50)
        t = _seq(rng, 10) + _mutate(rng, q) + _seq(rng, 10)
        res = edlib_tpu_torch.align(q, t, mode=mode, task="path",
                                    device="cpu")
        for qq, tt in ((q, t), (q.decode(), t.decode())):
            for gap in ("-", "*"):
                assert edlib_tpu_torch.getNiceAlignment(res, qq, tt, gap) \
                    == edlib_tpu.getNiceAlignment(res, qq, tt, gap)
    bad = [[1, 2], {"cigar": "3="}, {"locations": [(0, 2)]},
           {"locations": [(0, 2)], "cigar": None},
           {"locations": [(0, 2)], "cigar": ""},
           {"locations": [(0, 2)], "cigar": "2=1Q"}]
    for res in bad:
        msgs = []
        for mod in (edlib_tpu_torch, edlib_tpu):
            with pytest.raises(Exception) as err:
                mod.getNiceAlignment(res, "ACG", "ACG")
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
