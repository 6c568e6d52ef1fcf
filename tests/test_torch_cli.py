"""The port's CLI slice against edlib_tpu's: cli, io/fasta, edlib_compat,
oracle and utils/profiling.

edlib_tpu_torch.cli.main(argv) prints byte for byte what
edlib_tpu.cli.main(argv) prints under --backend host, the "Cpu time" line
masked: the cases of tests/test_cli_io.py, a seeded fuzz of flag draws in
the style of scripts/cli_diff_fuzz.py, and the port's batch backend on
device="cpu" (the kernels' plain versions).
"""

import contextlib
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import edlib_tpu.cli as jcli
import edlib_tpu.edlib_compat as jcompat
from edlib_tpu import oracle as joracle
from edlib_tpu.io import read_fasta_bytes as j_read_bytes
from edlib_tpu.io import read_fasta_strings as j_read_strings

import edlib_tpu_torch.cli as tcli
import edlib_tpu_torch.edlib_compat as tcompat
from edlib_tpu_torch import oracle as toracle
from edlib_tpu_torch.io import read_fasta_bytes, read_fasta_strings
from edlib_tpu_torch.utils import gcups, profiling

REPO = Path(__file__).resolve().parents[1]


def write(tmp_path, name, content):
    p = tmp_path / name
    p.write_text(content)
    return str(p)


def run(main, argv, **kw):
    """(exit code, stdout with the Cpu time line masked)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    lines = buf.getvalue().split("\n")
    return rc, "\n".join("Cpu time" if ln.startswith("Cpu time") else ln
                         for ln in lines)


def same_as_jax(argv, backend="host", **kw):
    """The port's output under backend (and main's keywords kw) equals
    edlib_tpu.cli's under --backend host; returns it."""
    want = run(jcli.main, argv + ["--backend", "host"])
    got = run(tcli.main, argv + ["--backend", backend], **kw)
    assert got == want, argv
    return got


def _fasta(seqs, headerless=False):
    return "".join(("" if headerless else f">s{i}\n") + s + "\n"
                   for i, s in enumerate(seqs))


# --------------------------------------------------------------------------
# tests/test_cli_io.py's cases
# --------------------------------------------------------------------------


def test_cli_distance(tmp_path):
    q = write(tmp_path, "q.fa", ">q1\nACT\n>q2\nTTTT\n")
    t = write(tmp_path, "t.fa", ">t\nCGACTGAC\n")
    rc, out = same_as_jax(["-m", "HW", q, t])
    assert rc == 0 and "#0: 0" in out and "Using HW alignment mode." in out


def test_cli_path_nice(tmp_path):
    q = write(tmp_path, "q.fa", ">q1\nelephant\n")
    t = write(tmp_path, "t.fa", ">t\ntelephone\n")
    rc, out = same_as_jax(["-p", q, t])
    assert rc == 0 and "score = 3" in out and "T: " in out


@pytest.mark.parametrize("fmt,want", [("CIG_EXT", "4="), ("CIG_STD", "4M")])
def test_cli_cigar_format(tmp_path, fmt, want):
    q = write(tmp_path, "q.fa", ">q1\nAAAA\n")
    t = write(tmp_path, "t.fa", ">t\nAAAA\n")
    assert want in same_as_jax(["-p", "-f", fmt, q, t])[1]


def test_cli_best_n_and_k(tmp_path):
    q = write(tmp_path, "q.fa", ">a\nAAAA\n>b\nAAAT\n>c\nTTTT\n>d\nAATT\n")
    t = write(tmp_path, "t.fa", ">t\nAAAA\n")
    rc, out = same_as_jax(["-n", "2", q, t])
    assert "#0: 0" in out and "#1: 1" in out and "#2:" not in out
    rc, out = same_as_jax(["-k", "0", q, t])
    assert "#0: 0" in out and "#1:" not in out


def test_cli_missing_files(tmp_path):
    t = write(tmp_path, "t.fa", ">t\nAAAA\n")
    rc, out = same_as_jax(["/nonexistent/q.fa", t])
    assert rc == 1 and "no file" in out
    rc, out = same_as_jax([t, str(tmp_path / "missing.fa")])
    assert rc == 1 and "no file" in out


def test_cli_progress_bytes(tmp_path):
    rng = np.random.RandomState(0)
    q = write(tmp_path, "q.fa", _fasta(
        ["".join(rng.choice(list("ACGT"), 40)) for _ in range(6)]))
    t = write(tmp_path, "t.fa", ">t\n" + "".join(
        rng.choice(list("ACGT"), 4000)) + "\n")
    expect = "0/6" + "".join("\r%d/6" % (i + 1) for i in range(6))
    for backend, kw in (("host", {}), ("jax", {"device": "cpu"})):
        rc, out = same_as_jax(["-m", "HW", "-l", q, t], backend, **kw)
        assert rc == 0 and expect in out


# --------------------------------------------------------------------------
# A seeded fuzz of flag draws (scripts/cli_diff_fuzz.py's style)
# --------------------------------------------------------------------------


def _draw(rng, trial):
    flags = ["-m", ["HW", "NW", "SHW"][trial % 3]]
    r = rng.rand()
    if r < 0.4:
        flags.append("-p")
    elif r < 0.7:
        flags.append("-l")
    if rng.rand() < 0.4:
        flags += ["-k", str(int(rng.choice([0, 5, 30])))]
    if rng.rand() < 0.3 and "-p" not in flags:
        flags += ["-n", str(int(rng.choice([1, 5])))]
    if rng.rand() < 0.25:
        flags += ["-f", str(rng.choice(["CIG_STD", "CIG_EXT", "NICE"]))]
    if rng.rand() < 0.2:
        flags += ["-r", "2"]
    if rng.rand() < 0.2:
        flags.append("-s")
    return flags


@pytest.mark.parametrize("chunk", range(4))
def test_cli_fuzz_matches_jax(tmp_path, chunk):
    """40 trials in 4 chunks: mixed alphabets, headerless files, targets of
    300-3,000 symbols, 3-25 queries of 20-200."""
    rng = np.random.RandomState(1000 + chunk)
    for trial in range(chunk * 10, chunk * 10 + 10):
        alpha = ["ACGT", "ACGTN", "ABCDEFGHIJ"][trial % 3]
        headerless = trial % 5 == 4
        tlen = int(rng.choice([300, 1000, 3000]))
        target = "".join(rng.choice(list(alpha), tlen))
        queries = []
        for _ in range(int(rng.choice([3, 9, 25]))):
            n = rng.randint(20, 200)
            if rng.rand() < 0.6:       # a mutated slice of the target
                a = rng.randint(0, max(1, tlen - n))
                s = list(target[a:a + n])
                for p in rng.choice(len(s), max(1, len(s) // 12)):
                    s[p] = rng.choice(list(alpha))
                queries.append("".join(s))
            else:
                queries.append("".join(rng.choice(list(alpha), n)))
        q = write(tmp_path, f"q{trial}.fa", _fasta(queries, headerless))
        t = write(tmp_path, f"t{trial}.fa", _fasta([target], headerless))
        same_as_jax(_draw(rng, trial) + [q, t])


# --------------------------------------------------------------------------
# The batch backend on the CPU, and auto
# --------------------------------------------------------------------------


def _hw_files(tmp_path, n_queries, seed=7):
    rng = np.random.RandomState(seed)
    target = "".join(rng.choice(list("ACGT"), 400))
    qs = []
    for _ in range(n_queries):
        s = rng.randint(0, 360)
        w = list(target[s:s + 40])
        for p in rng.choice(40, 3, replace=False):
            w[p] = rng.choice(list("ACGT"))
        qs.append("".join(w))
    return (write(tmp_path, "q.fa", _fasta(qs)),
            write(tmp_path, "t.fa", ">t\n" + target + "\n"))


@pytest.mark.parametrize("extra", [["-l"], ["-p"], ["-p", "-f", "CIG_EXT"],
                                   ["-l", "-k", "4"], ["-n", "2"],
                                   ["-p", "-n", "2"], ["-s", "-l"]])
def test_cli_batch_backend_on_cpu_matches_jax_host(tmp_path, extra):
    """The device batch (device="cpu": the plain versions) and its heap
    replay print what edlib_tpu's host loop prints; with -p -n the queries
    the replay drops print nothing, as in the host loop."""
    q, t = _hw_files(tmp_path, 10)
    same_as_jax(["-m", "HW", *extra, q, t], "jax", device="cpu")


def test_cli_auto_takes_the_batch_from_256_queries_on_a_card(
        tmp_path, monkeypatch):
    calls = []
    orig = tcli.align_batch

    def spy(*a, **kw):
        calls.append((kw.get("backend"), kw.get("device")))
        return orig(*a, device="cpu", **{k: v for k, v in kw.items()
                                          if k != "device"})

    monkeypatch.setattr(tcli, "align_batch", spy)
    q, t = _hw_files(tmp_path, 256, seed=11)
    same_as_jax(["-m", "HW", "-l", q, t], "auto", device="cpu")
    assert calls == []                  # no card: the host loop
    monkeypatch.setattr(tcli, "_has_card", lambda device: True)
    same_as_jax(["-m", "HW", "-l", q, t], "auto")
    assert calls == [("jax", None)]
    q, t = _hw_files(tmp_path, 255, seed=11)
    same_as_jax(["-m", "HW", "-l", q, t], "auto")
    assert calls == [("jax", None)]     # 255 queries: the host loop


def test_cli_runs_as_a_module(tmp_path):
    q, t = _hw_files(tmp_path, 5)
    argv = ["-m", "HW", "-p", "-f", "CIG_STD", q, t]
    proc = subprocess.run([sys.executable, "-m", "edlib_tpu_torch.cli",
                           *argv], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    masked = "\n".join("Cpu time" if ln.startswith("Cpu time") else ln
                       for ln in proc.stdout.split("\n"))
    assert masked == run(tcli.main, argv)[1]


def test_cli_slice_imports_neither_jax_nor_edlib_tpu(tmp_path):
    q, t = _hw_files(tmp_path, 5)
    code = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["edlib_tpu"] = None
import edlib_tpu_torch.edlib_compat, edlib_tpu_torch.io
import edlib_tpu_torch.native_loader, edlib_tpu_torch.oracle
import edlib_tpu_torch.utils
sys.argv[0] = "edlib_tpu_torch.cli"
runpy.run_module("edlib_tpu_torch.cli", run_name="__main__")
"""
    proc = subprocess.run([sys.executable, "-c", code, "-m", "HW", "-l", q,
                           t], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "#0: " in proc.stdout


# --------------------------------------------------------------------------
# io/fasta, edlib_compat, oracle, utils/profiling
# --------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False])
def test_read_fasta_matches_jax(tmp_path, monkeypatch, native):
    """The native reader against edlib_tpu's, and without the library the
    Python reader against edlib_tpu's (the two readers part on a '>' inside
    a line, in both packages)."""
    from edlib_tpu.native_loader import _read_fasta_py
    from edlib_tpu_torch import native_loader
    if not native:
        monkeypatch.setattr(native_loader, "get_lib", lambda: None)
    cases = [">s1\nACGT\nACGT\n>s2 desc\nTTTT\n", "ACGT\r\nAC\n>s2\nGG\n",
             ">x\nAC\nGT\n\n>y\n\n>z\nTT\nheaderless", "", ">only\n",
             "NOHEADER\nAT\r\n\r\nCG", "\xe9\xff>\n>a\r\nZ"]
    for i, content in enumerate(cases):
        p = str(tmp_path / f"{i}.fa")
        Path(p).write_bytes(content.encode("latin-1"))
        want = j_read_bytes(p) if native else _read_fasta_py(p)
        assert read_fasta_bytes(p) == want, content
        assert read_fasta_strings(p) == [s.decode("latin-1") for s in want]
        if native:
            assert read_fasta_strings(p) == j_read_strings(p)
    with pytest.raises((FileNotFoundError, OSError)):
        read_fasta_bytes(str(tmp_path / "nope.fa"))


def test_edlib_compat_matches_jax():
    assert tcompat.__all__ == jcompat.__all__
    for q, t, kw in (("ACT", "CGACTGAC", dict(mode="HW", task="path")),
                     ("elephant", "telephone", dict(task="path")),
                     ("AACG", "TCAACCTG", dict(mode="SHW", task="locations",
                                               k=2)),
                     ([1, 2, 3], [3, 1, 2, 3], dict(task="path")),
                     ("AC", "GT", dict(additionalEqualities=[("A", "G")]))):
        got = tcompat.align(q, t, device="cpu", **kw)
        assert got == jcompat.align(q, t, **kw)
        if got["cigar"] and isinstance(q, str):
            assert tcompat.getNiceAlignment(got, q, t) == \
                jcompat.getNiceAlignment(got, q, t)


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_oracle_matches_jax(rng, mode):
    for trial in range(25):
        sigma = [1, 2, 4, 9][trial % 4]
        q = rng.randint(0, sigma, rng.randint(0, 30))
        t = rng.randint(0, sigma, rng.randint(0, 40))
        eq = None
        if trial % 3 == 1:
            eq = rng.rand(sigma, sigma) < 0.3
            eq = eq | eq.T | np.eye(sigma, dtype=bool)
        assert toracle.edit_distance_simple(q, t, mode, eq) == \
            joracle.edit_distance_simple(q, t, mode, eq)
        if not len(q):
            continue             # full_dp_matrix takes a non-empty query
        np.testing.assert_array_equal(
            toracle.full_dp_matrix(q, t, mode, eq),
            joracle.full_dp_matrix(q, t, mode, eq))
    assert toracle.edit_distance_simple([], [1, 2], mode) == \
        joracle.edit_distance_simple([], [1, 2], mode)


def test_timer_gcups_and_trace():
    """utils/profiling: spans and take (the registry that replaced the
    Timer and the trace context), and the GCUPS accounting."""
    profiling.take("")
    profiling.enable(True)
    try:
        for _ in range(3):
            with profiling.span("a"):
                pass
        with pytest.raises(KeyError):
            with profiling.span("b"):
                raise KeyError("inside")
    finally:
        profiling.enable(False)
    spans, counts = profiling.take("")
    assert [s.name for s in spans] == ["a", "a", "a", "b"] and counts == {}
    assert all(s.end_ns >= s.start_ns and s.parent_id == 0 for s in spans)
    assert len({s.call_id for s in spans}) == 4
    with profiling.span("c"):
        pass
    assert profiling.take("") == ([], {})
    assert gcups(100, 1000, 10, 0.5) == pytest.approx(2e-3)
    assert gcups(1, 1, 1, 0.0) == float("inf")
