"""edlib_tpu_torch.align_batch / align against edlib_tpu, on the CPU.

device="cpu" runs the port's plain PyTorch versions of its kernels; the JAX
package answers from its host engines (backend="host"), which equal the
reference edlib, and, for route parity at one- and two-word shapes, from
its own device path (batch.align_batch_device) with the Pallas kernels in
interpret mode.  Inputs are made from seeded numpy; every result must be
equal, field for field.  Spies on the kernel wrappers check that each case
really takes the route it names (full reduce and hits, banded NW/SHW,
bit-plane, shared target).
"""

import numpy as np
import pytest
import torch

import edlib_tpu
import edlib_tpu_torch
import edlib_tpu_torch.parallel as tpar
from edlib_tpu import batch as jbatch
from edlib_tpu import encode as jenc
from edlib_tpu.align import _filter_locations as jfilter_locations
from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch import batch as tbatch
from edlib_tpu_torch.align import _filter_locations as tfilter_locations
from edlib_tpu_torch import encode as tenc
from edlib_tpu_torch.ops import cuda_kernel as ck


def _seq(rng, n, alphabet):
    return bytes(rng.choice(list(alphabet), n).tolist())


def _mutate(rng, s, alphabet, rate=0.1):
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


def _alphabet(sigma):
    return bytes(range(33, 33 + sigma))


def _batch(rng, sigma, lengths=(31, 32, 64, 65, 0, 90), tail=15):
    """Queries at the -1 quirk's boundaries (Q % 64) and an empty one,
    against mutated copies with a random tail (one empty target)."""
    A = _alphabet(sigma)
    qs = [_seq(rng, n, A) for n in lengths]
    ts = [_mutate(rng, q, A) + _seq(rng, tail, A) for q in qs]
    ts[1] = b""
    return qs, ts


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


def _check(qs, ts, mode, task, ks, eqs=None):
    for k in ks:
        got = edlib_tpu_torch.align_batch(qs, ts, mode=mode, task=task, k=k,
                                          additionalEqualities=eqs,
                                          device="cpu")
        want = edlib_tpu.align_batch(qs, ts, mode=mode, task=task, k=k,
                                     additionalEqualities=eqs,
                                     backend="host")
        assert got == want, f"mode={mode} task={task} k={k}"


# --------------------------------------------------------------------------
# Copied host helpers
# --------------------------------------------------------------------------


def test_encode_helpers_match_jax(rng):
    for _ in range(20):
        sigma = int(rng.randint(1, 40))
        A = _alphabet(sigma)
        q, t = _seq(rng, rng.randint(0, 50), A), _seq(rng, rng.randint(0, 50), A)
        for a, b in zip(tenc.transform_sequences(q, t),
                        jenc.transform_sequences(q, t)):
            np.testing.assert_array_equal(np.frombuffer(bytes(a), np.uint8)
                                          if isinstance(a, bytes) else a,
                                          np.frombuffer(bytes(b), np.uint8)
                                          if isinstance(b, bytes) else b)
        pairs = [(int(rng.choice(list(A))), int(rng.choice(list(A))))
                 for _ in range(3)] + [(200, 201)]
        np.testing.assert_array_equal(tenc.build_equality_matrix(A, pairs),
                                      jenc.build_equality_matrix(A, pairs))
        eq = jenc.build_equality_matrix(A, pairs)
        qi = rng.randint(0, sigma, rng.randint(0, 40))
        ti = rng.randint(0, sigma, rng.randint(0, 40))
        assert tenc.nw_upper_bound(qi, ti, eq) == jenc.nw_upper_bound(qi, ti,
                                                                      eq)
        assert tenc.nw_upper_bound(qi, ti) == jenc.nw_upper_bound(qi, ti)
    for args in (("ACGT", b"AC", [("A", "C"), (b"G", 84)]),
                 ([1, 2, 3], [3, 4], [(1, 4)]), ("ñandú", "andu", None)):
        assert tenc.map_to_bytes(*args) == jenc.map_to_bytes(*args)


def test_global_alphabet_and_plan_match_jax(rng):
    tg, jg = tbatch.GlobalAlphabet(), jbatch.GlobalAlphabet()
    for _ in range(6):
        s = _seq(rng, rng.randint(0, 30), _alphabet(60))
        np.testing.assert_array_equal(tg.encode(s), jg.encode(s))
    assert tg.alphabet == jg.alphabet and tg.sigma == jg.sigma
    for sigma in (5, 40, 100):
        for density in (0.0, 0.01, 0.05, 0.5):
            eq = rng.rand(sigma, sigma) < density
            eq |= eq.T
            got = tbatch._bigalpha_plan(sigma, eq)
            want = jbatch._bigalpha_plan(sigma, eq)
            assert (got is None) == (want is None)
            if got is not None:
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)


def test_filter_helpers_match_jax(rng):
    for qlen in (1, 31, 63, 64, 65, 128, 130):
        for best in (0, qlen - 1, qlen, qlen + 3):
            for k_eff in (float("inf"), 0, qlen, qlen - 1):
                pos = np.sort(rng.choice(50, 3, replace=False))
                assert tbatch._filter_best_positions(best, pos, qlen, k_eff) \
                    == jbatch._filter_best_positions(best, pos, qlen, k_eff)
                scores = rng.randint(best, best + 3, 20)
                assert tfilter_locations(scores, qlen, k_eff) \
                    == jfilter_locations(scores, qlen, k_eff)


def test_routing_constants_match_jax():
    """max_sigma1 and bitplane_ok at the 96 MiB routing budget equal the
    JAX package's off the TPU, so both send a bucket to the same kernel."""
    assert pk.vmem_limit_bytes() == 96 * 1024 * 1024
    for nw in (1, 2, 8, 32, 64, 96, 128, 256, 512, 2048):
        for shared in (False, True):
            assert ck.max_sigma1(nw, shared) == pk.max_sigma1(nw, shared)
        for sigma in (4, 40, 100, 255):
            for n_alts in (1, 2, 4):
                assert ck.bitplane_ok(nw, sigma, n_alts) \
                    == pk.bitplane_ok(nw, sigma, n_alts)


def test_bucket_profiles_match_build_peq_words(rng):
    sigma, nw = 7, 4
    eq = np.eye(sigma, dtype=bool)
    eq[1, 4] = eq[4, 1] = eq[2, 6] = eq[6, 2] = True
    qs = [rng.randint(0, sigma, n).astype(np.int32) for n in (1, 40, 128, 97)]
    got = tbatch._bucket_profiles(qs, eq, sigma, nw, torch.device("cpu"))
    want = np.stack([jenc.build_peq_words(q, eq, n_words=nw) for q in qs])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# --------------------------------------------------------------------------
# align_batch vs edlib_tpu (host engines)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
@pytest.mark.parametrize("task", ["distance", "locations"])
def test_align_batch_per_lane_matches_jax(rng, routes, mode, task):
    qs, ts = _batch(rng, 4)
    _check(qs, ts, mode, task, ks=(-1, 0, 6))
    assert routes["reduce_lanes"] > 0
    assert (routes["hits_lanes"] > 0) == (mode != "NW")


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_align_batch_shared_target_matches_jax(rng, routes, monkeypatch,
                                               mode):
    """A broadcast target is read as one target row; reads of similar and
    dissimilar content and the -1 quirk lengths."""
    A = _alphabet(4)
    target = _seq(rng, 300, A)
    qs = [_mutate(rng, target[s:s + n], A, 0.08)
          for s, n in ((10, 31), (50, 64), (200, 65), (0, 70))]
    qs += [_seq(rng, 40, A), b""]
    seen = []
    run = tbatch._run_bucketed_summary

    def spy(pairs, *a, **kw):
        seen.append(tbatch._is_shared(pairs, list(range(len(pairs)))))
        return run(pairs, *a, **kw)

    monkeypatch.setattr(tbatch, "_run_bucketed_summary", spy)
    _check(qs, target, mode, "locations", ks=(-1, 5))
    if mode == "HW":
        assert seen[0]                      # the main sweep: shared


@pytest.mark.parametrize("sigma", [20, 40, 100])
@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_align_batch_alphabets_and_equalities_match_jax(rng, routes, sigma,
                                                        mode):
    """sigma 20 takes the general kernels; 40 the bit-plane kernels (mid
    alphabet); 100 is past the per-lane 64-row cap, also bit-plane.
    Equalities ride as alternative ids (at most 4 per symbol)."""
    qs, ts = _batch(rng, sigma, lengths=(31, 64, 65, 50), tail=10)
    A = _alphabet(sigma)
    eqs = [(A[0], A[1]), (A[2], A[5]), (A[2], A[6])]
    _check(qs, ts, mode, "locations", ks=(-1, 4), eqs=None)
    _check(qs, ts, mode, "locations", ks=(-1,), eqs=eqs)
    # NW takes the bit-plane reduce only past the 64-row cap.
    bitplane = sigma + 1 > 64 if mode == "NW" else sigma >= 32
    assert (routes["reduce_bitplane"] > 0) == bitplane
    assert (routes["hits_bitplane"] > 0) == (bitplane and mode != "NW")


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
@pytest.mark.parametrize("shared", [False, True])
def test_align_batch_banded_routes_match_jax(rng, routes, monkeypatch, mode,
                                             shared):
    """EDLIB_TPU_BAND_MIN_WORDS=2 sends 2-word buckets to the banded NW and
    SHW kernels (HW starts re-run through the full reduce)."""
    monkeypatch.setenv("EDLIB_TPU_BAND_MIN_WORDS", "2")
    A = _alphabet(4)
    base = _seq(rng, 160, A)
    qs = [_mutate(rng, base[:n], A, r)
          for n, r in ((40, 0.05), (60, 0.1), (63, 0.3), (50, 0.0))]
    ts = base if shared else [_mutate(rng, q, A, 0.1) + _seq(rng, 30, A)
                              for q in qs]
    _check(qs, ts, mode, "locations", ks=(-1, 0, 3, 20))
    if mode == "NW":
        assert routes["nw_banded"] > 0
    elif mode == "SHW":
        assert routes["shw_banded"] > 0 and routes["shw_banded_hits"] > 0
    else:
        assert routes["nw_banded"] == routes["shw_banded"] == 0


@pytest.mark.parametrize("mode,band", [("HW", None), ("SHW", "2"),
                                       ("NW", None), ("NW", "2")])
def test_align_batch_matches_jax_device_path_interpret(rng, monkeypatch,
                                                         mode, band):
    """The JAX package's own device path (Pallas in interpret mode) at
    <= 2-word shapes: the same buckets, routes and results."""
    monkeypatch.setenv("EDLIB_TPU_FORCE_PALLAS", "interpret")
    if band:
        monkeypatch.setenv("EDLIB_TPU_BAND_MIN_WORDS", band)
    A = _alphabet(4)
    qs = [_seq(rng, n, A) for n in (31, 32, 50, 64)]
    ts = [_mutate(rng, q, A, 0.15) + _seq(rng, 8, A) for q in qs]
    want = jbatch.align_batch_device(qs, ts, mode=mode, task="locations")
    got = edlib_tpu_torch.align_batch(qs, ts, mode=mode, task="locations",
                                      device="cpu")
    assert got == want


def test_align_matches_jax_align(rng):
    A = _alphabet(5)
    for mode in ("NW", "SHW", "HW"):
        for task in ("distance", "locations"):
            for q, t, k, eqs in ((_seq(rng, 40, A), _seq(rng, 70, A), -1,
                                  None),
                                 (b"ACGTACGT", b"TTACGAACGTT", 2,
                                  [("A", "T")]),
                                 (b"", b"ACG", -1, None),
                                 (b"ACG", b"", 1, None),
                                 ([1, 2, 3, 2], [2, 3, 2, 1, 1], -1,
                                  [(1, 3)]),
                                 ("ñandú", "andú", -1, None)):
                assert edlib_tpu_torch.align(
                    q, t, mode=mode, task=task, k=k,
                    additionalEqualities=eqs, device="cpu") \
                    == edlib_tpu.align(q, t, mode=mode, task=task, k=k,
                                       additionalEqualities=eqs)


def test_align_batch_hashable_fallback_and_edges():
    qs = [[1, 2, 3], [4, 5]]
    ts = [[1, 3, 3, 4], [5, 5, 4]]
    for mode in ("NW", "HW"):
        assert edlib_tpu_torch.align_batch(qs, ts, mode=mode,
                                           task="locations", device="cpu") \
            == edlib_tpu.align_batch(qs, ts, mode=mode, task="locations",
                                     backend="host")
    assert edlib_tpu_torch.align_batch([], [], device="cpu") == []
    with pytest.raises(ValueError, match="equal length"):
        edlib_tpu_torch.align_batch([b"A"], [b"A", b"C"], device="cpu")
    with pytest.raises(ValueError):
        edlib_tpu_torch.align_batch([b"A"], [b"A"], mode="XX", device="cpu")


def test_unported_routes_raise(rng):
    # mesh= is ported: it takes a parallel.DeviceGrid and nothing else.
    with pytest.raises(TypeError, match="DeviceGrid"):
        edlib_tpu_torch.align_batch([b"ACG"], b"ACGT", mesh=object(),
                                    device="cpu")
    # sigma+1 > 64 per-lane with a symbol equal to six others: the eq-stream
    # route, as in the JAX package (no longer a raise).
    A = _alphabet(100)
    qs = [_seq(rng, 40, A) for _ in range(3)]
    ts = [_seq(rng, 50, A) for _ in range(3)]
    ts[0] += A
    dense = [(A[0], A[i]) for i in range(1, 7)]
    assert edlib_tpu_torch.align_batch(
        qs, ts, mode="HW", task="locations", additionalEqualities=dense,
        device="cpu") == edlib_tpu.align_batch(
            qs, ts, mode="HW", task="locations", additionalEqualities=dense,
            backend="host")


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edlib_tpu_torch.align_batch([b"ACG"], b"ACGT")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edlib_tpu_torch.align(b"ACG", b"ACGT")


def test_public_names_cover_jax():
    """Every public name of edlib_tpu has its counterpart (AlignConfig,
    AlignResult, the config helpers and both status codes included)."""
    assert set(edlib_tpu.__all__) <= set(edlib_tpu_torch.__all__)
    assert edlib_tpu_torch.STATUS_ERROR == edlib_tpu.STATUS_ERROR
    assert edlib_tpu_torch.STATUS_OK == edlib_tpu.STATUS_OK
    got = edlib_tpu_torch.new_align_config(5, "HW", "path", [("a", "b")])
    want = edlib_tpu.new_align_config(5, "HW", "path", [("a", "b")])
    assert (got.k, int(got.mode), int(got.task),
            got.additional_equalities) == (want.k, int(want.mode),
                                           int(want.task),
                                           want.additional_equalities)
    d, w = (edlib_tpu_torch.default_align_config(),
            edlib_tpu.default_align_config())
    assert (d.k, int(d.mode), int(d.task)) == (w.k, int(w.mode), int(w.task))
    assert edlib_tpu_torch.AlignResult().to_dict() == \
        edlib_tpu.AlignResult().to_dict()


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_align_batch_backend_values_agree(rng, mode):
    """backend "auto", "jax" and "host" (pair by pair, align on the CPU)
    give one result, as in the JAX package; with mesh= backend is
    ignored."""
    qs, ts = _batch(rng, 4)
    got = {b: edlib_tpu_torch.align_batch(qs, ts, mode=mode,
                                          task="locations", backend=b,
                                          device="cpu")
           for b in ("auto", "jax", "host")}
    assert got["auto"] == got["jax"] == got["host"]
    assert got["host"] == edlib_tpu.align_batch(qs, ts, mode=mode,
                                                task="locations",
                                                backend="host")
    grid = tpar.make_alignment_mesh(devices=["cpu"] * 2)
    assert edlib_tpu_torch.align_batch(qs, ts, mode=mode, task="locations",
                                       backend="host", mesh=grid) \
        == got["auto"]
