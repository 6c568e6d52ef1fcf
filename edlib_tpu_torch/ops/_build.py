"""Builds the port's CUDA source and binds it with ctypes.

At first use ``csrc/myers.cu`` and ``csrc/wavefront.cu`` are compiled for
``sm_90a`` by one nvcc each, both started together, and linked into one
shared library with a plain C interface; both include ``csrc/groups.cuh``.
The library goes to ``build/edlib_tpu_torch/`` at the root of the checkout,
named by a hash of the sources, the header and the flags, so a changed
file builds anew and an unchanged one is reused.  A failed build raises
with nvcc's output.
ptxas's register and spill report is kept beside the library (``.log``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from edlib_tpu_torch.utils import hw

CSRC = Path(__file__).resolve().parent / "csrc"
# Linked into one library: the per-lane sweeps and the
# single-pair wavefront sweeps.
SOURCES = (CSRC / "myers.cu", CSRC / "wavefront.cu")
# Included by both: the warp groups' machinery.
HEADERS = (CSRC / "groups.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "edlib_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of csrc/*.cu: the device index first, the stream last,
# every pointer and the stream as void*.
SIGNATURES = {
    "myers_reduce_lanes": [_I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I,
                           _P, _L, _I, _I, _P, _P, _P, _P, _P],
    "myers_reduce_bitplane": [_I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P,
                              _P, _P, _I, _I, _P, _L, _I, _I, _P, _P, _P,
                              _P, _P],
    "myers_sweep_shared": [_I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                           _I, _P, _P, _P],
    "myers_hits_lanes": [_I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P,
                         _L, _I, _I, _P, _P, _I, _P, _P, _P],
    "myers_hits_bitplane": [_I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P,
                            _P, _I, _I, _P, _L, _I, _I, _P, _P, _I, _P, _P,
                            _P],
    "myers_nw_banded": [_I, _P, _I, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P,
                        _I, _P, _P, _I, _P, _P],
    "myers_shw_banded": [_I, _P, _I, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P,
                         _P, _I, _P, _P, _P, _P, _I, _P, _P],
    "myers_shw_banded_hits": [_I, _P, _I, _I, _P, _I, _P, _I, _I, _I, _P,
                              _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P],
    "myers_capture": [_I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                      _P, _P, _P],
    "myers_sweep_scores": [_I, _P, _I, _I, _P, _I, _P, _P, _I, _I, _P, _P,
                           _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "myers_sweep_scores_plan": [_I, _I, _I, _I, _I, _I, _I, _P,
                                ctypes.POINTER(_L)],
    "myers_reduce_resume": [_I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I,
                            _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P],
    "myers_hw_adaptive": [_I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "myers_hw_adaptive_clusters": [_I, _I, _I, _P, _P],
    "myers_reduce_eqstream": [_I, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P,
                              _P, _P, _P, _P],
    "myers_hits_eqstream": [_I, _P, _I, _I, _P, _P, _I, _I, _P, _P, _I, _P,
                            _P, _P],
    "myers_wavefront": [_I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P,
                        _P, _P],
    "myers_wavefront_capacity": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "myers_wavefront_banded": [_I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmyers-{h.hexdigest()[:16]}.so"


def _run(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build() -> Path:
    """Compile csrc/*.cu unless they are built already; returns the
    library's path.  Raises RuntimeError with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = hw.nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in SOURCES]
    tmp = out.with_name(f"{tag}.tmp.so")
    try:
        procs = [_run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
                 for src, obj in zip(SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{src.name}:\n{log}")
        link = _run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        link_log = link.communicate()[0]
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed ({link.returncode}) linking "
                               f"{out.name}:\n{link_log}")
        out.with_suffix(".log").write_text("".join(logs) + link_log)
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.myers_error_string.argtypes = [ctypes.c_int]
            lib.myers_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise RuntimeError when a launch returned a CUDA error."""
    if code != 0:
        msg = lib.myers_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
