"""Alignment dispatch and Hirschberg divide and conquer, on the host.

Copied from the JAX package's path/hirschberg.py (obtainAlignment,
edlib.cpp:1161-1213; obtainAlignmentHirschberg, edlib.cpp:1231-1396), with
the host big-int engine (ops/host.py), and from 1e10 cells a node's two
half-sweeps on the card (Wavefront.column_cells, the unbanded wavefront
kernel).  The dispatch threshold and the crossing-row search order replicate
the reference's, including its 64-bit memory estimate, so the method chosen
— and so the emitted path — is the reference's for every input.

The JAX package runs the windows below 1e10 cells on its native C++ engine
when it is built; it emits the same ops.  EDLIB_TPU_DEVICE_PATH="0" keeps
every half-sweep on the host; "1" (or unset) takes the card from 1e10
cells.
"""

from __future__ import annotations

import os

import numpy as np

from edlib_tpu_torch.encode import build_peq_bigint
from edlib_tpu_torch.ops.host import HostColumnProvider, decode_cells, nw_run
from edlib_tpu_torch.path.traceback import traceback
from edlib_tpu_torch.types import EDOP_DELETE, EDOP_INSERT

# Reference dispatch threshold: estimated traceback memory < 1 MB
# (edlib.cpp:1186-1190), with the reference's 64-bit Word.
_REF_WORD_BYTES = 8
_TRACEBACK_MEM_LIMIT = 1024 * 1024

# Hirschberg nodes of at least this many DP cells take their half-sweeps on
# the card (edlib_tpu/path/hirschberg.py:40); the tests lower it.
_DEVICE_PATH_MIN_CELLS = 10_000_000_000


def _device_path_enabled(qlen: int, tlen: int) -> bool:
    dev = os.environ.get("EDLIB_TPU_DEVICE_PATH", "")
    if dev not in ("", "0", "1"):
        raise ValueError(f"EDLIB_TPU_DEVICE_PATH must be 0 or 1, got {dev!r}")
    return dev != "0" and qlen * tlen >= _DEVICE_PATH_MIN_CELLS


def _traceback_mem_estimate(qlen: int, tlen: int) -> int:
    max_blocks64 = -(-qlen // 64)
    return (2 * _REF_WORD_BYTES + 4) * max_blocks64 * tlen + 2 * 4 * tlen


def obtain_alignment(q_ids: np.ndarray, t_ids: np.ndarray,
                     eq: np.ndarray, best_score: int,
                     device=None) -> np.ndarray:
    """Ops (uint8 EDOP codes) of the NW alignment of query vs window whose
    distance is best_score.  device: where the half-sweeps of nodes past
    _DEVICE_PATH_MIN_CELLS run (None: the card)."""
    qlen, tlen = len(q_ids), len(t_ids)
    if qlen == 0 or tlen == 0:
        # Empty-sequence base case (edlib.cpp:1167-1175).
        op = EDOP_DELETE if qlen == 0 else EDOP_INSERT
        return np.full(qlen + tlen, op, dtype=np.uint8)
    if _traceback_mem_estimate(qlen, tlen) < _TRACEBACK_MEM_LIMIT:
        peq = build_peq_bigint(q_ids, eq)
        provider = HostColumnProvider(peq, t_ids, qlen)
        return traceback(provider, qlen, tlen, best_score)
    return _hirschberg(q_ids, t_ids, eq, best_score, device)


def _hirschberg(q_ids: np.ndarray, t_ids: np.ndarray,
                eq: np.ndarray, best_score: int, device=None) -> np.ndarray:
    qlen, tlen = len(q_ids), len(t_ids)
    rq = q_ids[::-1].copy()
    rt = t_ids[::-1].copy()
    left_w = tlen // 2
    right_w = tlen - left_w

    # Forward sweep stopped at the last column of the left half, reverse
    # sweep at the last column of the (reversed) right half
    # (edlib.cpp:1250-1260).  left[r] = cost(query[:r+1], target[:left_w]);
    # rev[j] = cost(rq[:j+1], rt[:right_w]), so the suffix cost of original
    # row i is rev[qlen-1-i] (readBlockReverse, edlib.cpp:1290-1309).
    if _device_path_enabled(qlen, tlen):
        # On the card: the wavefront over target[:stop+1] with no wildcard
        # extension leaves every word at exactly the stop column.
        from edlib_tpu_torch.ops.wavefront import Wavefront
        wf = Wavefront(device=device)
        sigma = eq.shape[0]
        left = wf.column_cells(q_ids, t_ids, sigma, left_w - 1, eq=eq)
        rev = wf.column_cells(rq, rt, sigma, right_w - 1, eq=eq)
    else:
        lstate, _ = nw_run(build_peq_bigint(q_ids, eq), t_ids, qlen,
                           stop=left_w - 1)
        rstate, _ = nw_run(build_peq_bigint(rq, eq), rt, qlen,
                           stop=right_w - 1)
        left = decode_cells(lstate.Pv, lstate.Mv, qlen, boundary=left_w)
        rev = decode_cells(rstate.Pv, rstate.Mv, qlen, boundary=right_w)
    right_suffix = rev[::-1]

    # The crossing row: first r in 0..Q-2 with left[r] + right_suffix[r+1]
    # == best, then the -1 / Q-1 boundary rows — the search order of
    # edlib.cpp:1327-1353, so ties break identically.
    hits = np.nonzero(left[:-1] + right_suffix[1:] == best_score)[0]
    if hits.size:
        row = int(hits[0])
        l_score = int(left[row])
        r_score = int(right_suffix[row + 1])
    elif left_w + int(right_suffix[0]) == best_score:
        row = -1
        l_score = left_w
        r_score = int(right_suffix[0])
    elif int(left[qlen - 1]) + right_w == best_score:
        row = qlen - 1
        l_score = int(left[qlen - 1])
        r_score = right_w
    else:
        raise RuntimeError(
            "Hirschberg: no crossing row — bestScore is inconsistent")

    ul = obtain_alignment(q_ids[:row + 1], t_ids[:left_w], eq, l_score,
                          device)
    lr = obtain_alignment(q_ids[row + 1:], t_ids[left_w:], eq, r_score,
                          device)
    return np.concatenate([ul, lr])
