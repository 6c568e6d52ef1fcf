"""Batched PATH on the card: thousands of small alignment windows at once.

Port of edlib_tpu/path/batched.py.  The reference reconstructs a small
window's path by storing every column's (Pv, Mv) during one NW sweep and
bit-walking back (edlib.cpp:883-893 capture + 976-1134 walk), one pair at a
time.  Here each slab of windows runs four stages on the card:

  1. profiles — query profiles under the equality matrix, with the
     wildcard row and the rows past each query set
     (cuda_kernel.build_peq_eq_device);
  2. capture — the column-capture kernel stores every column's Pv, Mv, Ph
     and Mh words (cuda_kernel.capture_flat_device, want_h=True);
  3. decode — the move at every cell is a bitwise function of those words
     (go_up <=> Pv, go_left <=> Ph, MATCH <=> the vertical delta cancels
     the row-above horizontal delta), with the reference's preference: up
     (INSERT), then left (DELETE), then diagonal, MATCH iff the diagonal
     value is unchanged; then the length of every diagonal MATCH run by
     log-doubling;
  4. walk — one edit event per step (a MATCH-run jump or one op), a
     gather per step for every lane at once.

Stages 1, 3 and 4 are plain torch ops, as the JAX package leaves them to
XLA.  The decode runs on whole words before unpacking: the layout is the
capture kernel's lane-minor (column, row, lane).  Only the per-step (move,
run) codes and the final (r, c) leave the card; the host expands runs,
prepends the boundary run (all DELETE / all INSERT) and reverses, exactly
like the scalar walk's r == -1 / c == -1 exits.

Buckets (nw_b, C = pow2 >= window length, at least 128) and slabs
(_slab_size, sorted by distance) are the JAX package's, so both cut the
same slabs; the output does not depend on them.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from edlib_tpu_torch import encode
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.types import (EDOP_DELETE, EDOP_INSERT, EDOP_MATCH,
                                   EDOP_MISMATCH)

# Windows of more DP cells than this take the host route (the JAX package's
# _MAX_CELLS; EDLIB_TPU_BATCHED_PATH_MAX_CELLS overrides it).
_MAX_CELLS = 1 << 18
# Working-set budget of one slab (the JAX package's _BUDGET_MB at ~10 bytes
# per padded DP cell): it sets the slab size only.
_BUDGET_MB = 1536
_CHUNK = 128

_MOVE_TO_OP = np.array([255, EDOP_INSERT, EDOP_DELETE, EDOP_MATCH,
                        EDOP_MISMATCH], dtype=np.uint8)


def max_cells() -> int:
    return int(os.environ.get("EDLIB_TPU_BATCHED_PATH_MAX_CELLS",
                              _MAX_CELLS))


def _pow2_at_least(x: int, floor: int = 1) -> int:
    n = floor
    while n < x:
        n *= 2
    return n


def _slab_size(C: int, total_rows: int) -> int:
    per_lane = max(1, C * total_rows * 10)
    slab = max(256, min(8192, (_BUDGET_MB << 20) // per_lane))
    return _pow2_at_least(slab + 1) // 2  # round down to a power of two


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """(Tp, NW, B) int32 words -> (Tp, NW*32, B) uint8 bits, row 32w+j =
    bit j of word w."""
    Tp, nw, B = words.shape
    j = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None, :] >> j[None, None, :, None]) & 1
    return bits.to(torch.uint8).reshape(Tp, nw * 32, B)


def _row_above(words: torch.Tensor, top: int) -> torch.Tensor:
    """Each row's bit moved down one row (row r takes row r-1), row 0
    taking `top`: the row-above horizontal delta."""
    carry = torch.empty_like(words)
    carry[:, 0] = top
    carry[:, 1:] = (words[:, :-1] >> 31) & 1
    return (words << 1) | carry


def move_codes(pv, mv, ph, mh) -> torch.Tensor:
    """Packed per-cell codes (Tp, total, B): move | run << 3, move 1 = up
    (INSERT), 2 = left (DELETE), 3 = diagonal MATCH, 4 = diagonal MISMATCH;
    run the length of the diagonal MATCH run ending at the cell (walking
    up-left, the cell included).  Inputs (Tp, NW, B) int32 words."""
    ph_up = _row_above(ph, 1)          # h(-1, c) = +1: the top row costs c+1
    mh_up = _row_above(mh, 0)
    diag_match = (pv & mh_up) | (mv & ph_up) | ~(pv | mv | ph_up | mh_up)
    diag = ~(pv | ph)
    match = diag & diag_match
    # movec = b0 + 2 b1 + 4 b2: 1 = up, 2 = left, 3 = match, 4 = mismatch.
    b0 = _unpack(pv | match)
    b1 = _unpack((ph & ~pv) | match)
    b2 = _unpack(diag & ~diag_match)
    movec = b0 | (b1 << 1) | (b2 << 2)
    del b0, b1, b2
    Tp, total = movec.shape[:2]
    # Diagonal MATCH-run lengths by log-doubling: after K doublings runs
    # shorter than 2^(K+1) >= min(Tp, total) + 1 are exact.  uint8 while the
    # bound fits, else int16; the packed code int16 while runs fit 12 bits
    # (only a raised EDLIB_TPU_BATCHED_PATH_MAX_CELLS passes 4095).
    run_dt = torch.uint8 if min(Tp, total) <= 255 else torch.int16
    run = _unpack(match).to(run_dt)
    span = 1
    while span < min(Tp, total):
        shifted = torch.zeros_like(run)
        shifted[span:, span:] = run[:-span, :-span]
        run = run + torch.where(run == span, shifted, 0).to(run_dt)
        span *= 2
    pk_dt = torch.int16 if min(Tp, total) <= 4095 else torch.int32
    return movec.to(pk_dt) | (run.to(pk_dt) << 3)


def walk(packed: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
         steps: int):
    """The event walk from (r0, c0) for `steps` steps over packed codes
    (Tp, total, B).  Returns (moves (B, steps), counts (B, steps), r_f,
    c_f), moves 0 once a lane has reached the top row or left column."""
    Tp, total, B = packed.shape
    flat = packed.reshape(-1)
    lanes = torch.arange(B, dtype=torch.int64, device=packed.device)
    r, c = r0.to(torch.int64), c0.to(torch.int64)
    done = torch.zeros(B, dtype=torch.bool, device=packed.device)
    moves, counts = [], []
    for _ in range(steps):
        bdry = (r < 0) | (c < 0)
        idx = ((c.clamp(0, Tp - 1) * total + r.clamp(0, total - 1)) * B
               + lanes)
        p = flat[idx].to(torch.int32)
        m = p & 7
        n = torch.where(m == 3, p >> 3, 1)
        act = ~done & ~bdry
        moves.append(torch.where(act, m, 0))
        counts.append(torch.where(act, n, 0))
        r = torch.where(act & (m != 2), r - n, r)
        c = torch.where(act & (m != 1), c - n, c)
        done = done | bdry
    return torch.stack(moves, 1), torch.stack(counts, 1), r, c


def _capture_walk(q_ids, windows, lens, eq_s1, n_words: int, steps: int):
    """One slab on the card: profiles, capture, decode, walk.  q_ids (B,
    n_words*32) and windows (B, C) int32 (pad columns hold the wildcard
    S1-1), lens (B, 2) int64 query and window lengths; returns walk()'s
    outputs."""
    peq = ck.build_peq_eq_device(q_ids, lens[:, 0], eq_s1, n_words)
    pv, mv, ph, mh = ck.capture_flat_device(peq, windows, 1, chunk=_CHUNK,
                                            want_h=True)
    del peq
    # The capture kernel's lane-minor storage, (Tp, NW, B).
    packed = move_codes(*(x.permute(1, 2, 0) for x in (pv, mv, ph, mh)))
    del pv, mv, ph, mh
    return walk(packed, lens[:, 0] - 1, lens[:, 1] - 1, steps)


def batched_windows_path(pairs: List[Tuple[np.ndarray, np.ndarray]],
                         dists: List[int], sigma: int, eq: np.ndarray,
                         device) -> List[np.ndarray]:
    """Ops (uint8 EDOP arrays) of many (query, window) NW alignments.

    pairs: (q_ids, window_ids) int arrays in the global alphabet; dists the
    edit distances (they size each slab's walk).  The caller guarantees
    qlen >= 1, wlen >= 1, qlen * wlen <= max_cells(), nw_b * 32 <= 32767
    and wlen <= 32767 for every pair (batch.py's eligibility test)."""
    out: List[Optional[np.ndarray]] = [None] * len(pairs)
    eq_s1 = np.ones((sigma + 1, sigma + 1), bool)
    eq_s1[:sigma, :sigma] = eq[:sigma, :sigma].astype(bool)
    eq_dev = torch.from_numpy(eq_s1).to(device)

    buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, (q_ids, w_ids) in enumerate(pairs):
        nw_b = _pow2_at_least(encode.num_words(len(q_ids)))
        if not (nw_b * 32 <= 32767 and len(w_ids) <= 32767):
            raise ValueError("batched_windows_path: window past the int16 "
                             "bounds (see the docstring)")
        buckets[(nw_b, _pow2_at_least(len(w_ids), floor=_CHUNK))].append(i)

    # Every slab is enqueued before any result is fetched, so the card
    # works through them while the host assembles.
    inflight = []
    for (nw_b, C), idxs in buckets.items():
        total = nw_b * 32
        slab = _slab_size(C, total)
        # The walk needs ~2*dist+2 steps: distance-sorted slabs size their
        # walk by their own worst lane.
        idxs = sorted(idxs, key=lambda i: dists[i])
        for s0 in range(0, len(idxs), slab):
            sub = idxs[s0:s0 + slab]
            B = len(sub)
            q_arr = np.zeros((B, total), np.int32)
            w_arr = np.full((B, C), sigma, np.int32)
            lens = np.empty((B, 2), np.int64)
            for row, i in enumerate(sub):
                q_ids, w_ids = pairs[i]
                q_arr[row, :len(q_ids)] = q_ids
                w_arr[row, :len(w_ids)] = w_ids
                lens[row] = len(q_ids), len(w_ids)
            steps = _pow2_at_least(
                min(2 * max(dists[i] for i in sub) + 4, total + C), floor=16)
            res = _capture_walk(*(torch.from_numpy(a).to(device)
                                  for a in (q_arr, w_arr, lens)),
                                eq_dev, nw_b, steps)
            inflight.append((sub, res))

    for sub, res in inflight:
        moves, counts, r_f, c_f = (x.cpu().numpy() for x in res)
        ends = moves == 0
        n_moves = np.where(ends.any(axis=1), np.argmax(ends, axis=1),
                           moves.shape[1])
        for row, i in enumerate(sub):
            ne = n_moves[row]
            events = np.repeat(_MOVE_TO_OP[moves[row, :ne]],
                               counts[row, :ne])
            if int(r_f[row]) == -1:
                tail = np.full(int(c_f[row]) + 1, EDOP_DELETE, np.uint8)
            else:
                tail = np.full(int(r_f[row]) + 1, EDOP_INSERT, np.uint8)
            out[i] = np.concatenate([events, tail])[::-1].copy()
    return out  # type: ignore[return-value]
