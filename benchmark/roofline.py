"""The yardstick of the kernels: peaks, the work a launch needs, the
launches of a window.

Peaks of one NVIDIA H100 SXM at its 700 W limit.  HBM: 3.35 TB/s, the
data sheet's.  INT32: 64 lanes a cycle on each of 132 SMs at the 1.98 GHz
boost clock, 16.7 T operations a second, worked out from the Hopper
whitepaper's SM description and not a published row (the benchmark samples
the SM clock and the power limit beside the window).  A kernel's bound is
the larger of its bytes over the HBM peak and its operations over the
INT32 peak; a share of the roofline is the bound over the kernel's device
time.

Operations are counted as Hopper issues them: a Myers word step is 13
(a logic function of up to three inputs one LOP3, (x << 1) | bit one LEA,
a + b - c one IADD3), plus 6 a lane-column for the score and the reduction
(4 in the shared sweep); the counts are the work the inputs need, not what
an implementation recomputes (a split lane's halo).
"""

from __future__ import annotations

import functools
import inspect
import math

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
OPS_PER_WORD = 13
OPS_PER_COLUMN = 6
OPS_PER_COLUMN_SHARED = 4
WORD = 32


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


class Recorder:
    """Wraps the kernel wrappers of a module (``module.KERNELS``, called
    through the module's attributes) so that, while ``on``, every call's
    operands are kept by wrapper name, bound to their parameter names."""

    def __init__(self, module):
        self.module = module
        self.orig = {k.__name__: k for k in module.KERNELS}
        self.calls = {name: [] for name in self.orig}
        self.on = False
        for name, fn in self.orig.items():
            setattr(module, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kw):
            if self.on:
                self.calls[name].append(sig.bind(*args, **kw).arguments)
            return fn(*args, **kw)
        return call

    def restore(self):
        for name, fn in self.orig.items():
            setattr(self.module, name, fn)


def lane_call_cost(words_per_row, targets, hi, prow, trow, n_vecs, ops_col,
                   out_bytes):
    """(bytes, ops) a per-lane call needs: every profile row and every
    target row a lane reads (up to the furthest column any lane scans in
    it), the lane vectors in and the outputs out; ops_col operations for
    every column a lane scans."""
    import torch
    T = targets.shape[1]
    n = hi.shape[0]
    cols = hi.long().clamp(0, T)
    row_cols = torch.zeros(targets.shape[0], dtype=torch.int64,
                           device=cols.device)
    row_cols.scatter_reduce_(0, trow.long(), cols, "amax")
    n_prof = int(torch.unique(prow[cols > 0]).numel())
    nbytes = (n_prof * words_per_row * 4 + int(row_cols.sum()) * 4
              + n * n_vecs * 4 + out_bytes)
    return nbytes, int(cols.sum()) * ops_col


def reduce_lanes_cost(a: dict):
    """(bytes, ops) of one K1 call (``reduce_lanes``): a lane runs the scan
    columns [0, min(hi, T)) of its target row."""
    peq = a["peq"]
    nw = peq.shape[2]
    n = a["hi"].shape[0]
    return lane_call_cost(peq.shape[1] * nw, a["targets"], a["hi"],
                          a["prow"], a["trow"], 4,
                          nw * OPS_PER_WORD + OPS_PER_COLUMN, n * 4 * 4)


def sweep_shared_cost(a: dict):
    """(bytes, ops) of one K2 call (``sweep_shared``): every lane runs the
    scan columns [0, min(col_hi, n_cols)) of the one target."""
    peq_t, target = a["peq_t"], a["target"]
    nw, n = peq_t.shape[1], peq_t.shape[2]
    end = min(target.shape[0], int(a["col_hi"]))
    return (peq_t.numel() * 4 + end * 4 + n * 8,
            n * end * (nw * OPS_PER_WORD + OPS_PER_COLUMN_SHARED))


def band_cost(qlen: int, tlen: int, d: int, sigma: int = 4):
    """(bytes, ops) of the Ukkonen band a pair of distance d needs: the
    diagonals min(0, Q - T) - s .. max(0, Q - T) + s with
    s = ceil((d - |Q - T|) / 2), over Q rows, 32 cells a word, 13
    operations a word; the target and the profile read once."""
    diff = qlen - tlen
    s = max(0, math.ceil((d - abs(diff)) / 2))
    width = max(0, diff) + s - (min(0, diff) - s) + 1
    words = width * qlen / WORD
    nbytes = tlen * 4 + (sigma + 1) * -(-qlen // WORD) * 4
    return nbytes, words * OPS_PER_WORD


def share(bound_total_s: float, device_s: float):
    """A roofline share in %, or None where the kernel did not run."""
    if device_s <= 0 or bound_total_s <= 0:
        return None
    return 100.0 * bound_total_s / device_s
