"""Builds the port's CUDA source and binds it with ctypes.

At first use ``csrc/myers.cu`` is compiled by nvcc into a shared library with
a plain C interface, for ``sm_90a``.  The library goes to
``build/edlib_tpu_torch/`` at the root of the checkout, named by a hash of the
source and flags, so a changed source builds anew and an unchanged one is
reused.  A failed build raises with nvcc's output.  ptxas's register and
spill report is kept beside the library (``.log``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from edlib_tpu_torch.utils import hw

SOURCE = Path(__file__).resolve().parent / "csrc" / "myers.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "edlib_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/myers.cu: the device index first, the stream last,
# every pointer and the stream as void*.
SIGNATURES = {
    "myers_reduce_lanes": [_I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I,
                           _P, _P, _P, _P, _P, _P],
    "myers_reduce_bitplane": [_I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P,
                              _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    "myers_sweep_shared": [_I, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P,
                           _P],
}

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmyers-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/myers.cu unless it is built already; returns the
    library's path.  Raises RuntimeError with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [hw.nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                           f"{SOURCE.name}:\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
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
