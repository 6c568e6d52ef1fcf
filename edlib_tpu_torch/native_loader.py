"""The native C++ host engine (native/*.cpp), built and bound for the port.

The counterpart of edlib_tpu/native_loader.py.  At first use g++ builds
``libedlib_tpu_native.so`` from ``native/edlib_tpu_native.cpp`` and
``native/edlib_compat.cpp``, and the CPython extension
``_edlib_tpu_native_ext`` from ``native/pyext.cpp`` with the engine, with
the JAX loader's flags.  Both go to ``build/edlib_tpu_torch/`` at the root
of the checkout, named by a hash of their sources, the flags, the Python
headers' directory and the host CPU (``-march=native``), so a changed
source builds anew and an unchanged one is reused.  Each build compiles to
a temporary file, renamed into place, under a file lock, so processes that
reach the first build together run one g++ and all load its output.
Nothing is read from or written to ``native/`` but the sources.

Every wrapper returns None when the library is not loaded (no g++, a failed
build, or ``EDLIB_TPU_NO_NATIVE`` set), and its caller then takes its
Python route.  ``EDLIB_TPU_REBUILD_NATIVE`` is not read: the port has no
prebuilt artefact to bypass.  ctypes releases the interpreter lock around
each call, so threads can run the engine side by side.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.util
import os
import platform
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
NATIVE_DIR = _REPO / "native"
BUILD_DIR = _REPO / "build" / "edlib_tpu_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-march=native", "-pthread",
             "-shared")
LIB_SOURCES = ("edlib_tpu_native.cpp", "edlib_compat.cpp")
EXT_SOURCES = ("pyext.cpp", "edlib_tpu_native.cpp")
EXT_NAME = "_edlib_tpu_native_ext"

_lib_lock = threading.Lock()
_ext_lock = threading.Lock()
_lib = None
_tried = False
_ext = None
_ext_tried = False


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().split(b"\n\n")[0].splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines)
    except OSError:
        return platform.processor().encode()


def artefact_path(stem: str, sources, flags) -> Path:
    """BUILD_DIR/<stem>-<hash>.so, the hash over the flags, the host CPU and
    every source's bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(_cpu_identity())
    for name in sources:
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build(stem: str, sources, extra_flags=()) -> Optional[Path]:
    """Compile sources (names under native/) into one shared object unless
    it is built already; its path, or None when g++ fails or is missing."""
    flags = (*GXX_FLAGS, *extra_flags)
    try:
        out = artefact_path(stem, sources, flags)
    except OSError:
        return None
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out          # another process built it while we waited
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        try:
            subprocess.run(["g++", *flags, "-o", str(tmp),
                            *(str(NATIVE_DIR / s) for s in sources)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, out)
        except (subprocess.SubprocessError, OSError):
            return None
        finally:
            tmp.unlink(missing_ok=True)
    return out


def _load_ext():
    path = build(EXT_NAME, EXT_SOURCES,
                 ("-I", sysconfig.get_paths()["include"]))
    if path is None:
        return None
    spec = importlib.util.spec_from_file_location(EXT_NAME, path)
    try:
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    except (ImportError, OSError):
        return None
    return module


def get_ext():
    """The CPython extension (one single-pair call without numpy), or None."""
    global _ext, _ext_tried
    with _ext_lock:
        if not _ext_tried:
            _ext_tried = True
            if not os.environ.get("EDLIB_TPU_NO_NATIVE"):
                _ext = _load_ext()
        return _ext


def _load_lib() -> Optional[ctypes.CDLL]:
    path = build("libedlib_tpu_native", LIB_SOURCES)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    c_i64 = ctypes.c_int64
    lib.etn_fasta_stat.restype = ctypes.c_int
    lib.etn_fasta_stat.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(c_i64),
                                   ctypes.POINTER(c_i64)]
    lib.etn_fasta_read.restype = ctypes.c_int
    lib.etn_fasta_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_void_p, c_i64, c_i64]
    lib.etn_cigar_encode.restype = c_i64
    lib.etn_cigar_encode.argtypes = [ctypes.c_void_p, c_i64, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.etn_sweep_scores.restype = None
    lib.etn_sweep_scores.argtypes = [ctypes.c_void_p, c_i64, ctypes.c_void_p,
                                     c_i64, ctypes.c_int, ctypes.c_void_p]
    lib.etn_build_peq.restype = None
    lib.etn_build_peq.argtypes = [ctypes.c_void_p, c_i64, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.etn_nw_path.restype = c_i64
    lib.etn_nw_path.argtypes = [ctypes.c_void_p, c_i64, ctypes.c_void_p,
                                c_i64, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int32, ctypes.c_void_p]
    lib.etn_nw_cells_at.restype = None
    lib.etn_nw_cells_at.argtypes = [ctypes.c_void_p, c_i64, c_i64,
                                    ctypes.c_void_p, c_i64, ctypes.c_void_p]
    lib.etn_nw_cells_at_banded.restype = None
    lib.etn_nw_cells_at_banded.argtypes = [
        ctypes.c_void_p, c_i64, c_i64, ctypes.c_void_p, c_i64, c_i64,
        c_i64, ctypes.c_void_p]
    lib.etn_sweep_scores_banded.restype = c_i64
    lib.etn_sweep_scores_banded.argtypes = [
        ctypes.c_void_p, c_i64, ctypes.c_void_p, c_i64, ctypes.c_int,
        c_i64, ctypes.c_void_p]
    lib.etn_semiglobal_best.restype = c_i64
    lib.etn_semiglobal_best.argtypes = [
        ctypes.c_void_p, c_i64, ctypes.c_void_p, c_i64, c_i64, c_i64,
        c_i64, ctypes.c_int, c_i64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_void_p]
    lib.etn_transform.restype = c_i64
    lib.etn_transform.argtypes = [
        ctypes.c_char_p, c_i64, ctypes.c_char_p, c_i64, c_i64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.etn_nw_distance_banded.restype = ctypes.c_int32
    lib.etn_nw_distance_banded.argtypes = [
        ctypes.c_void_p, c_i64, ctypes.c_void_p, c_i64, c_i64, c_i64]
    lib.etn_obtain_alignment.restype = c_i64
    lib.etn_obtain_alignment.argtypes = [
        ctypes.c_void_p, c_i64, ctypes.c_void_p, c_i64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int]
    lib.etn_align.restype = ctypes.c_int
    lib.etn_align.argtypes = [
        ctypes.c_char_p, c_i64, ctypes.c_char_p, c_i64,
        ctypes.c_int, ctypes.c_int, c_i64,
        ctypes.c_void_p, ctypes.c_void_p, c_i64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_void_p, ctypes.POINTER(c_i64), ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None where it cannot load or
    EDLIB_TPU_NO_NATIVE is set."""
    global _lib, _tried
    with _lib_lock:
        if not _tried:
            _tried = True
            if not os.environ.get("EDLIB_TPU_NO_NATIVE"):
                _lib = _load_lib()
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# Wrappers (edlib_tpu/native_loader.py:248-531)
# ---------------------------------------------------------------------------

def read_fasta(path: str) -> List[bytes]:
    """All sequences in a FASTA file (headerless-tolerant)."""
    lib = get_lib()
    if lib is None:
        return _read_fasta_py(path)
    n = ctypes.c_int64()
    total = ctypes.c_int64()
    if lib.etn_fasta_stat(path.encode(), ctypes.byref(n),
                          ctypes.byref(total)):
        raise FileNotFoundError(path)
    data = np.empty(total.value, dtype=np.uint8)
    offsets = np.empty(n.value + 1, dtype=np.int64)
    if lib.etn_fasta_read(path.encode(), data.ctypes.data,
                          offsets.ctypes.data, total.value, n.value):
        raise FileNotFoundError(path)
    return [data[offsets[i]:offsets[i + 1]].tobytes()
            for i in range(n.value)]


def _read_fasta_py(path: str) -> List[bytes]:
    """Python fallback with the reference reader's acceptance rules
    (aligner.cpp:290-328): headerless tolerated, '\\r'/'\\n' skipped."""
    seqs: List[bytearray] = []
    in_seq = False
    with open(path, "rb") as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                in_seq = False
                continue
            if not line:
                continue
            if not in_seq:
                seqs.append(bytearray())
                in_seq = True
            seqs[-1].extend(line)
    return [bytes(s) for s in seqs]


def cigar_encode_native(ops: np.ndarray, extended: bool) -> Optional[str]:
    lib = get_lib()
    if lib is None:
        return None
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    out = ctypes.create_string_buffer(12 * max(1, len(ops)) + 1)
    n = lib.etn_cigar_encode(ops.ctypes.data, len(ops), int(extended), out)
    if n < 0:
        raise ValueError("alignment contains invalid op codes (must be 0..3)")
    return out.value.decode()


def sweep_scores_native(peq64: np.ndarray, target_ext: np.ndarray,
                        hin0: int) -> Optional[np.ndarray]:
    """peq64: uint64 (sigma+1, n_words); target_ext: uint8 wildcard-extended
    symbols.  Returns the int32 padded-bottom score of every column."""
    lib = get_lib()
    if lib is None:
        return None
    peq64 = np.ascontiguousarray(peq64, dtype=np.uint64)
    target_ext = np.ascontiguousarray(target_ext, dtype=np.uint8)
    out = np.empty(len(target_ext), dtype=np.int32)
    lib.etn_sweep_scores(peq64.ctypes.data, peq64.shape[1],
                         target_ext.ctypes.data, len(target_ext), hin0,
                         out.ctypes.data)
    return out


SCORE_INF = 0x3FFFFFFF  # banded sweeps: "provably > k" marker

_MODE_CODE = {"NW": 0, "SHW": 1, "HW": 2}


def align_native(query: bytes, target: bytes, mode: str, want_starts: bool,
                 k: int, eq_pairs) -> Optional[dict]:
    """One pair's distance and locations in C: {editDistance,
    alphabetLength, endLocations, startLocations} with numpy arrays, or None
    without the library.  Any alphabet of up to 256 symbols; the caller
    handles empty sequences."""
    ext = get_ext()
    if ext is not None:
        eq_a = eq_b = None
        if eq_pairs:
            eq_a = bytes(p[0] for p in eq_pairs)
            eq_b = bytes(p[1] for p in eq_pairs)
        out = ext.align(query, target, _MODE_CODE[mode], int(want_starts),
                        int(k), eq_a, eq_b)
        if out is None:
            return None
        dist, alpha, ends, starts = out
        return {
            "editDistance": dist,
            "alphabetLength": alpha,
            "endLocations": np.asarray(ends, dtype=np.int64),
            "startLocations": (np.asarray(starts, dtype=np.int64)
                               if want_starts else None),
        }
    lib = get_lib()
    if lib is None:
        return None
    tlen = len(target)
    n_eq = 0
    eq_a = eq_b = None
    if eq_pairs:
        n_eq = len(eq_pairs)
        eq_a = np.array([p[0] for p in eq_pairs], dtype=np.uint8)
        eq_b = np.array([p[1] for p in eq_pairs], dtype=np.uint8)
    dist = ctypes.c_int32()
    alpha = ctypes.c_int32()
    n_locs = ctypes.c_int64()
    ends = np.empty(tlen + 1, dtype=np.int32)
    starts = np.empty(tlen + 1, dtype=np.int32)
    rc = lib.etn_align(
        query, len(query), target, tlen,
        _MODE_CODE[mode], int(want_starts), int(k),
        eq_a.ctypes.data if eq_a is not None else None,
        eq_b.ctypes.data if eq_b is not None else None, n_eq,
        ctypes.byref(dist), ctypes.byref(alpha),
        ends.ctypes.data, ctypes.byref(n_locs), starts.ctypes.data)
    if rc != 0:
        return None
    n = n_locs.value
    return {
        "editDistance": dist.value,
        "alphabetLength": alpha.value,
        "endLocations": ends[:n].astype(np.int64),
        "startLocations": starts[:n].astype(np.int64) if want_starts else None,
    }


def sweep_scores_banded_native(peq64: np.ndarray, target_ext: np.ndarray,
                               hin0: int, k: int) -> Optional[np.ndarray]:
    """Ukkonen-banded sweep; entries are exact where <= k, SCORE_INF where
    the band proves the score > k."""
    lib = get_lib()
    if lib is None:
        return None
    peq64 = np.ascontiguousarray(peq64, dtype=np.uint64)
    target_ext = np.ascontiguousarray(target_ext, dtype=np.uint8)
    out = np.empty(len(target_ext), dtype=np.int32)
    n = lib.etn_sweep_scores_banded(peq64.ctypes.data, peq64.shape[1],
                                    target_ext.ctypes.data, len(target_ext),
                                    hin0, int(k), out.ctypes.data)
    out[n:] = SCORE_INF  # band vanished: remaining columns are > k
    return out


def semiglobal_best_native(peq64: np.ndarray, target_ext: np.ndarray,
                           w_pad: int, qlen: int, tlen: int, hin0: int,
                           k: int):
    """(best, minimal end positions) in one call, no score stream kept
    (etn_semiglobal_best); k < 0 runs the reference's dynamic-k doubling
    in C.  None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    peq64 = np.ascontiguousarray(peq64, dtype=np.uint64)
    target_ext = np.ascontiguousarray(target_ext, dtype=np.uint8)
    locs = np.empty(tlen + 1, dtype=np.int32)
    best = ctypes.c_int32(-1)
    n = lib.etn_semiglobal_best(peq64.ctypes.data, peq64.shape[1],
                                target_ext.ctypes.data, len(target_ext),
                                int(w_pad), int(qlen), int(tlen), hin0,
                                int(k), ctypes.byref(best), locs.ctypes.data)
    return int(best.value), locs[:n]


def transform_native(query: bytes, target: bytes):
    """(q_ids, t_ids, alphabet) by the C table passes; None without the
    library; ValueError past 256 symbols (as transform_sequences)."""
    lib = get_lib()
    if lib is None:
        return None
    q_ids = np.empty(max(len(query), 1), dtype=np.uint8)
    t_ids = np.empty(max(len(target), 1), dtype=np.uint8)
    alphabet = np.empty(256, dtype=np.uint8)
    sigma = lib.etn_transform(query, len(query), target, len(target), 256,
                              q_ids.ctypes.data, t_ids.ctypes.data,
                              alphabet.ctypes.data)
    if sigma < 0:
        raise ValueError(
            "query and target combined have more than 256 unique values, "
            "this is not supported.")
    return (q_ids[:len(query)], t_ids[:len(target)],
            alphabet[:sigma].tobytes())


def build_peq64_native(q_ids: np.ndarray, eq: np.ndarray
                       ) -> Optional[np.ndarray]:
    """The 64-bit query profile, uint64 (sigma+1, n_words) with wildcard
    padding rows, as encode.build_peq_words(word_size=64) gives it."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q_ids, dtype=np.uint8)
    sigma = eq.shape[0]
    eqm = np.ascontiguousarray(eq, dtype=np.uint8)
    n_words = max(1, (len(q) + 63) // 64)
    out = np.empty((sigma + 1, n_words), dtype=np.uint64)
    lib.etn_build_peq(q.ctypes.data, len(q), eqm.ctypes.data, sigma,
                      out.ctypes.data)
    return out


def nw_distance_banded_native(peq64: np.ndarray, t_ids: np.ndarray,
                              qlen: int, k: int) -> Optional[int]:
    """NW distance within the band k, or -1 when it is above k."""
    lib = get_lib()
    if lib is None:
        return None
    peq64 = np.ascontiguousarray(peq64, dtype=np.uint64)
    t = np.ascontiguousarray(t_ids, dtype=np.uint8)
    return int(lib.etn_nw_distance_banded(peq64.ctypes.data, peq64.shape[1],
                                          t.ctypes.data, len(t), qlen,
                                          int(k)))


def nw_cells_at_native(peq64: np.ndarray, qlen: int, t_ids: np.ndarray,
                       stop: int, k: Optional[int] = None
                       ) -> Optional[np.ndarray]:
    """Cell values of NW column `stop` (the Hirschberg half-sweep); with k,
    the bestScore-banded sweep, out-of-band cells SCORE_INF (> k)."""
    lib = get_lib()
    if lib is None:
        return None
    peq64 = np.ascontiguousarray(peq64, dtype=np.uint64)
    t = np.ascontiguousarray(t_ids, dtype=np.uint8)
    out = np.empty(qlen, dtype=np.int32)
    if k is None:
        lib.etn_nw_cells_at(peq64.ctypes.data, peq64.shape[1], qlen,
                            t.ctypes.data, stop, out.ctypes.data)
    else:
        lib.etn_nw_cells_at_banded(peq64.ctypes.data, peq64.shape[1], qlen,
                                   t.ctypes.data, len(t), stop, int(k),
                                   out.ctypes.data)
    return out


def obtain_alignment_native(q_ids: np.ndarray, t_ids: np.ndarray,
                            eq: np.ndarray, best_score: int,
                            use_threads: int = -1
                            ) -> Optional[np.ndarray]:
    """The whole PATH reconstruction (dispatch, Hirschberg, traceback) in C.
    use_threads: 1 forks inside the recursion, 0 runs it sequentially (for
    callers that pool many alignments), -1 reads EDLIB_TPU_THREADS."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q_ids, dtype=np.uint8)
    t = np.ascontiguousarray(t_ids, dtype=np.uint8)
    eqb = np.ascontiguousarray(eq, dtype=np.uint8)
    ops = np.empty(len(q) + len(t) or 1, dtype=np.uint8)
    n = lib.etn_obtain_alignment(q.ctypes.data, len(q), t.ctypes.data,
                                 len(t), eqb.ctypes.data, eq.shape[0],
                                 best_score, ops.ctypes.data,
                                 int(use_threads))
    if n < 0:
        raise RuntimeError("native path reconstruction inconsistent with "
                           "best_score")
    return ops[:n]


def nw_path_native(q_ids: np.ndarray, t_ids: np.ndarray, eq: np.ndarray,
                   best_score: int) -> Optional[np.ndarray]:
    """The NW traceback of a window under the 1 MB estimate, in C."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q_ids, dtype=np.uint8)
    t = np.ascontiguousarray(t_ids, dtype=np.uint8)
    eqb = np.ascontiguousarray(eq, dtype=np.uint8)
    ops = np.empty(len(q) + len(t) or 1, dtype=np.uint8)
    n = lib.etn_nw_path(q.ctypes.data, len(q), t.ctypes.data, len(t),
                        eqb.ctypes.data, eq.shape[0], best_score,
                        ops.ctypes.data)
    if n < 0:
        raise RuntimeError("native traceback inconsistent with best_score")
    return ops[:n]
