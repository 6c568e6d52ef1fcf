"""The port's native engine loader and the host routes it serves, against
edlib_tpu.

Every wrapper of edlib_tpu_torch.native_loader against edlib_tpu's on the
same inputs; the port's obtain_alignment (native, and its big-int fallback)
against edlib_tpu's on windows either side of the 1 MB traceback estimate;
the long functions' backend="native" and align_batch(backend="host")
against edlib_tpu and the port's device="cpu" route, with the library and
without it (the fallbacks, also under EDLIB_TPU_NO_NATIVE=1 in a fresh
process); where the artefacts land; and two processes building at once.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import edlib_tpu
from edlib_tpu import native_loader as jnl
from edlib_tpu.path import hirschberg as jhb

import edlib_tpu_torch
from edlib_tpu_torch import native_loader as tnl
from edlib_tpu_torch.encode import build_peq_words, num_words
from edlib_tpu_torch.path import hirschberg as thb

REPO = Path(__file__).resolve().parents[1]
DNA = "ACGT"


@pytest.fixture
def no_native(monkeypatch):
    """The port's loader as without a library: every wrapper None."""
    monkeypatch.setattr(tnl, "get_lib", lambda: None)
    monkeypatch.setattr(tnl, "get_ext", lambda: None)


def _ids(rng, n, sigma):
    return rng.randint(0, sigma, n).astype(np.uint8)


def _mutate_ids(rng, ids, rate, sigma):
    out = []
    for c in ids:
        r = rng.rand()
        if r < rate / 3:
            continue                                   # deletion
        if r < 2 * rate / 3:
            out.append(rng.randint(sigma))             # insertion
        out.append(rng.randint(sigma) if r < rate else c)
    return np.array(out or [0], np.uint8)


def _eq(rng, sigma, n_extra):
    eq = np.eye(sigma, dtype=bool)
    for _ in range(n_extra):
        a, b = rng.randint(sigma, size=2)
        eq[a, b] = eq[b, a] = True
    return eq


def _seq(rng, n):
    return "".join(rng.choice(list(DNA), n))


def _mutated(rng, s, n_edits):
    s = list(s)
    for _ in range(n_edits):
        p = rng.randint(len(s))
        r = rng.rand()
        if r < 0.4:
            s[p] = rng.choice(list(DNA))
        elif r < 0.7:
            del s[p]
        else:
            s.insert(p, rng.choice(list(DNA)))
    return "".join(s)


# --------------------------------------------------------------------------
# The wrappers, one by one
# --------------------------------------------------------------------------


def test_library_loads_from_the_port_build_dir():
    assert tnl.available()
    lib = tnl.build("libedlib_tpu_native", tnl.LIB_SOURCES)
    assert lib.parent == tnl.BUILD_DIR
    assert lib.name.startswith("libedlib_tpu_native-")
    assert tnl.BUILD_DIR == REPO / "build" / "edlib_tpu_torch"
    ext = tnl.get_ext()
    assert ext is not None and Path(ext.__file__).parent == tnl.BUILD_DIR


@pytest.mark.parametrize("sigma,qlen,tlen,n_eq", [
    (1, 63, 200, 0), (4, 64, 300, 0), (4, 65, 257, 2), (20, 127, 400, 5),
    (100, 128, 300, 30), (255, 191, 500, 60)])
def test_sweep_wrappers_match_jax(sigma, qlen, tlen, n_eq):
    rng = np.random.RandomState(sigma * 1000 + qlen)
    q = _ids(rng, qlen, sigma)
    t = _mutate_ids(rng, np.concatenate([_ids(rng, 40, sigma), q,
                                         _ids(rng, tlen - qlen, sigma)]),
                    0.1, sigma)
    eq = _eq(rng, sigma, n_eq)
    peq = tnl.build_peq64_native(q, eq)
    np.testing.assert_array_equal(peq, jnl.build_peq64_native(q, eq))
    nw64 = num_words(qlen, 64)
    np.testing.assert_array_equal(
        peq, build_peq_words(q, eq, word_size=64, n_words=nw64))
    w64 = nw64 * 64 - qlen
    t_ext = np.concatenate([t, np.full(w64, sigma, np.uint8)])
    for hin0 in (0, 1):
        np.testing.assert_array_equal(
            tnl.sweep_scores_native(peq, t_ext, hin0),
            jnl.sweep_scores_native(peq, t_ext, hin0))
        for k in (0, 5, 40, qlen):
            np.testing.assert_array_equal(
                tnl.sweep_scores_banded_native(peq, t_ext, hin0, k),
                jnl.sweep_scores_banded_native(peq, t_ext, hin0, k))
        for k in (-1, 0, 7, 60):
            got = tnl.semiglobal_best_native(peq, t_ext, w64, qlen, len(t),
                                             hin0, k)
            want = jnl.semiglobal_best_native(peq, t_ext, w64, qlen, len(t),
                                              hin0, k)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
    for k in (1, 20, 100, 1000):
        assert (tnl.nw_distance_banded_native(peq, t, qlen, k)
                == jnl.nw_distance_banded_native(peq, t, qlen, k))
    for stop in (0, len(t) // 2, len(t) - 1):
        np.testing.assert_array_equal(
            tnl.nw_cells_at_native(peq, qlen, t, stop),
            jnl.nw_cells_at_native(peq, qlen, t, stop))
        np.testing.assert_array_equal(
            tnl.nw_cells_at_native(peq, qlen, t, stop, k=30),
            jnl.nw_cells_at_native(peq, qlen, t, stop, k=30))
    d = jnl.nw_distance_banded_native(peq, t, qlen, qlen + len(t))
    for fn in ("obtain_alignment_native", "nw_path_native"):
        np.testing.assert_array_equal(getattr(tnl, fn)(q, t, eq, d),
                                      getattr(jnl, fn)(q, t, eq, d))
    np.testing.assert_array_equal(
        tnl.obtain_alignment_native(q, t, eq, d, use_threads=0),
        jnl.obtain_alignment_native(q, t, eq, d, use_threads=0))


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
@pytest.mark.parametrize("want_starts", [False, True])
def test_align_native_matches_jax(rng, mode, want_starts):
    for trial in range(12):
        sigma = [2, 4, 30, 255][trial % 4]
        letters = bytes(range(1, 256))[:sigma]
        qlen = [31, 64, 65, 129][trial % 4]
        q = bytes(letters[i] for i in rng.randint(0, sigma, qlen))
        t = bytes(letters[i] for i in rng.randint(0, sigma, 3 * qlen))
        eqs = [(letters[0], letters[-1])] if trial % 3 == 0 else None
        for k in (-1, 0, qlen // 3):
            got = tnl.align_native(q, t, mode, want_starts, k, eqs)
            want = jnl.align_native(q, t, mode, want_starts, k, eqs)
            assert got.keys() == want.keys()
            for key in got:
                np.testing.assert_array_equal(got[key], want[key])


def test_transform_cigar_and_fasta_wrappers_match_jax(rng, tmp_path):
    for q, t in ((b"ACGT", b"TTGACX"), (b"", b"AC"), (b"Z", b""),
                 (bytes(range(128)), bytes(range(255, 100, -1))),
                 (bytes(range(256)), bytes(range(256))[::-1])):
        got, want = tnl.transform_native(q, t), jnl.transform_native(q, t)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for n in (1, 5, 300):
        ops = rng.randint(0, 4, n).astype(np.uint8)
        for ext in (False, True):
            assert (tnl.cigar_encode_native(ops, ext)
                    == jnl.cigar_encode_native(ops, ext))
    with pytest.raises(ValueError, match="op codes"):
        tnl.cigar_encode_native(np.array([0, 4], np.uint8), True)
    p = tmp_path / "x.fa"
    p.write_bytes(b"HEADERLESS\r\nAC\n>s1 d\nAC\r\nGT\n\n>s2\n>s3\nTT")
    assert tnl.read_fasta(str(p)) == jnl.read_fasta(str(p)) \
        == tnl._read_fasta_py(str(p)) == jnl._read_fasta_py(str(p))
    with pytest.raises(FileNotFoundError):
        tnl.read_fasta(str(tmp_path / "missing.fa"))


# --------------------------------------------------------------------------
# obtain_alignment: the JAX dispatch order
# --------------------------------------------------------------------------


@pytest.mark.parametrize("qlen,rate,sigma", [(1700, 0.05, 4),
                                              (1900, 0.05, 4),
                                              (1900, 0.3, 20)])
def test_obtain_alignment_matches_jax_and_the_bigint_route(
        monkeypatch, qlen, rate, sigma):
    """Either side of the 1 MB estimate (1,700: the traceback; 1,900: past
    it, Hirschberg), native and big-int, sequential and forked."""
    rng = np.random.RandomState(qlen + sigma)
    q = _ids(rng, qlen, sigma)
    t = _mutate_ids(rng, q, rate, sigma)
    eq = _eq(rng, sigma, 2)
    small = thb._traceback_mem_estimate(qlen, len(t)) < thb._TRACEBACK_MEM_LIMIT
    assert small == (qlen == 1700)
    d = jnl.nw_distance_banded_native(jnl.build_peq64_native(q, eq), t,
                                      qlen, qlen + len(t))
    want = jhb.obtain_alignment(q, t, eq, d)
    np.testing.assert_array_equal(thb.obtain_alignment(q, t, eq, d), want)
    np.testing.assert_array_equal(
        thb.obtain_alignment(q, t, eq, d, parallel=False), want)
    if not small:
        # One Hirschberg level in Python over the banded native half-sweeps.
        np.testing.assert_array_equal(thb._hirschberg(q, t, eq, d, "cpu"),
                                      want)
    monkeypatch.setattr(tnl, "get_lib", lambda: None)
    np.testing.assert_array_equal(thb.obtain_alignment(q, t, eq, d), want)


def test_obtain_alignment_above_255_symbols_takes_the_bigint_route(rng):
    q = _ids(rng, 300, 256)
    t = _mutate_ids(rng, q, 0.1, 256)
    eq = np.eye(256, dtype=bool)
    d = edlib_tpu.align(q.tobytes(), t.tobytes())["editDistance"]
    np.testing.assert_array_equal(thb.obtain_alignment(q, t, eq, d),
                                  jhb.obtain_alignment(q, t, eq, d))


def test_pooled_path_windows_match(monkeypatch, rng):
    """The PATH host route pools from 4 windows; EDLIB_TPU_THREADS=0 runs
    them one by one; both equal edlib_tpu's host route."""
    from edlib_tpu_torch import batch as tb
    qs = [_seq(rng, 400) for _ in range(6)]
    ts = [_mutated(rng, q, 30) for q in qs]
    want = edlib_tpu.align_batch(qs, ts, task="path", backend="host")
    monkeypatch.setattr(tb.batched_path, "max_cells", lambda: 100)
    for threads in ("", "0"):
        monkeypatch.setenv("EDLIB_TPU_THREADS", threads)
        tb.reset_path_route_counts()
        got = edlib_tpu_torch.align_batch(qs, ts, task="path", device="cpu")
        assert tb.path_route_counts() == {"capture": 0, "host": 6}
        assert got == want


# --------------------------------------------------------------------------
# backend="native" and backend="host"
# --------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False])
def test_long_functions_native_backend(request, rng, native):
    if not native:
        request.getfixturevalue("no_native")
    t = _seq(rng, 900)
    q = _mutated(rng, t[100:700], 25)
    pairs = ((q, t), (t, _mutated(rng, t, 40)), (b"Z" * 65, t), (b"", t))
    for a, b in pairs:
        for k in (-1, 0, 10, 40):
            assert edlib_tpu_torch.nw_distance_long(
                a, b, k=k, backend="native") == edlib_tpu.nw_distance_long(
                a, b, k=k, backend="native")
            assert edlib_tpu_torch.shw_best_long(
                a, b, k=k, backend="native") == edlib_tpu.shw_best_long(
                a, b, k=k, backend="native")
            for mode in ("HW", "SHW"):
                assert edlib_tpu_torch.semiglobal_locations_long(
                    a, b, mode=mode, k=k, backend="native") == \
                    edlib_tpu.semiglobal_locations_long(
                        a, b, mode=mode, k=k, backend="native")
    # The card's route on its plain versions gives the same answers.
    assert edlib_tpu_torch.nw_distance_long(q, t, backend="native") == \
        edlib_tpu_torch.nw_distance_long(q, t, device="cpu")
    assert edlib_tpu_torch.semiglobal_locations_long(
        q, t, backend="native") == edlib_tpu_torch.semiglobal_locations_long(
        q, t, device="cpu")


def _host_batch(rng):
    target = _seq(rng, 700)
    qs, ts = [], []
    for i in range(10):
        a = rng.randint(0, 500)
        qs.append(_mutated(rng, target[a:a + [31, 64, 65, 130][i % 4]], 4))
        ts.append(target if i % 2 else _mutated(rng, qs[-1], 6) + "ACG")
    qs[3], ts[5] = "", ""
    return qs, ts


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
@pytest.mark.parametrize("task", ["distance", "locations", "path"])
def test_align_batch_host_backend(rng, mode, task):
    qs, ts = _host_batch(rng)
    for k, eqs in ((-1, None), (5, None), (-1, [("A", "C")]), (0, None)):
        got = edlib_tpu_torch.align_batch(qs, ts, mode=mode, task=task, k=k,
                                          additionalEqualities=eqs,
                                          backend="host")
        want = edlib_tpu.align_batch(qs, ts, mode=mode, task=task, k=k,
                                     additionalEqualities=eqs,
                                     backend="host")
        assert got == want, (mode, task, k, eqs)
    # The last case (k = 0) on the port's own route, its plain versions.
    assert got[:4] == edlib_tpu_torch.align_batch(
        qs[:4], ts[:4], mode=mode, task=task, k=0, device="cpu")


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_align_batch_host_backend_without_the_library(no_native, rng, mode):
    """Without the library every pair takes align(..., device="cpu")."""
    qs, ts = _host_batch(rng)
    qs, ts = qs[:5], ts[:5]
    got = edlib_tpu_torch.align_batch(qs, ts, mode=mode, task="path", k=20,
                                      additionalEqualities=[("G", "T")],
                                      backend="host")
    assert got == edlib_tpu.align_batch(qs, ts, mode=mode, task="path",
                                        k=20,
                                        additionalEqualities=[("G", "T")],
                                        backend="host")


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
@pytest.mark.parametrize("task", ["distance", "locations"])
def test_align_batch_host_backend_without_the_extension(monkeypatch, rng,
                                                        mode, task):
    """With the ctypes library but no CPython extension, distance and
    locations come from the host engines on the library; the answers are
    edlib_tpu's."""
    monkeypatch.setattr(tnl, "get_ext", lambda: None)
    qs, ts = _host_batch(rng)
    for k, eqs in ((-1, None), (5, [("A", "C")])):
        got = edlib_tpu_torch.align_batch(qs, ts, mode=mode, task=task, k=k,
                                          additionalEqualities=eqs,
                                          backend="host")
        assert got == edlib_tpu.align_batch(qs, ts, mode=mode, task=task,
                                            k=k, additionalEqualities=eqs,
                                            backend="host"), (k, eqs)


def test_host_route_keeps_the_port_route_past_the_wavefront_gate(
        monkeypatch, rng):
    """An NW pair past the wavefront gate and an empty pair take
    align(..., device="cpu") on the host route, as edlib_tpu sends them
    elsewhere; the answer is the same."""
    ta_mod = sys.modules["edlib_tpu_torch.align"]
    calls = []
    orig = ta_mod.align

    def spy(*a, **kw):
        calls.append(kw.get("device"))
        return orig(*a, **kw)

    monkeypatch.setattr(ta_mod, "align", spy)
    monkeypatch.setattr(ta_mod, "_WAVEFRONT_MIN_CELLS", 50_000)
    q = _seq(rng, 300)
    t = _mutated(rng, q, 10)
    got = ta_mod.align_host(q, t, task="locations")
    assert calls == ["cpu"]
    assert got == edlib_tpu.align(q, t, task="locations")
    assert ta_mod.align_host("", t) == edlib_tpu.align("", t)
    assert calls == ["cpu", "cpu"]
    assert ta_mod.align_host(q[:50], t[:50]) == edlib_tpu.align(q[:50],
                                                                 t[:50])
    assert len(calls) == 2


# --------------------------------------------------------------------------
# The switch and the build
# --------------------------------------------------------------------------


def _run(code, *args, env=None, timeout=240):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          env=dict(os.environ, **(env or {})),
                          capture_output=True, text=True, timeout=timeout)


def test_no_native_switch_gives_the_same_results():
    code = """
import json, sys
import edlib_tpu_torch as et
from edlib_tpu_torch import native_loader as nl
q, t = "ACGTTGCAACGTAGGT" * 5, "TTACGTTGCAACGAAGGTAC" * 6
out = dict(available=nl.available(), ext=nl.get_ext() is not None,
           nw=et.nw_distance_long(q, t, backend="native"),
           hw=et.semiglobal_locations_long(q, t, backend="native"),
           path=et.align_batch([q] * 4, [t] * 4, mode="HW", task="path",
                               backend="host"),
           loc=et.align_batch([q], [t], task="locations", backend="host"))
print(json.dumps(out))
"""
    import json
    off = _run(code, env={"EDLIB_TPU_NO_NATIVE": "1"})
    on = _run(code)
    assert off.returncode == 0 and on.returncode == 0, off.stderr + on.stderr
    off, on = json.loads(off.stdout), json.loads(on.stdout)
    assert (off.pop("available"), off.pop("ext")) == (False, False)
    assert (on.pop("available"), on.pop("ext")) == (True, True)
    assert off == on


def test_two_processes_build_at_once_and_native_is_untouched(tmp_path):
    """Two fresh processes reach the first build of the library together in
    an empty build directory: both load it, one artefact lands there, no
    temporary file is left, and none of the port's files lands in native/
    (where edlib_tpu's own loader may write its builds meanwhile)."""
    def port_files_in_native():
        return [p.name for p in (REPO / "native").iterdir()
                if re.search(r"-[0-9a-f]{16}(\.\d+\.tmp)?\.so$|\.lock$",
                             p.name)]

    code = """
import sys
from pathlib import Path
from edlib_tpu_torch import native_loader as nl
nl.BUILD_DIR = Path(sys.argv[1])
assert nl.available()
assert nl.transform_native(b"AC", b"CA")[2] == b"AC"
print(nl.build("libedlib_tpu_native", nl.LIB_SOURCES))
"""
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    built = sorted(p.name for p in tmp_path.iterdir())
    assert [n for n in built if n.endswith(".so")] == [Path(*paths).name]
    assert not [n for n in built if ".tmp" in n]
    assert port_files_in_native() == []
