"""Myers bit-vector sweeps with in-sweep reduction: CUDA kernels and their
plain PyTorch versions.

Port of the sweeps of edlib_tpu/ops/pallas_kernel.py and
edlib_tpu/ops/wavefront.py.  Sixteen kernels, in csrc/myers.cu and
csrc/wavefront.cu (their headers say what bounds them), and a carry form of
one of them:

  reduce_lanes     per-lane target rows, Eq from each lane's query profile
                   (pallas_kernel._reduce_kernel, per-lane form; with one
                   target row for every lane, its shared form);
  reduce_bitplane  the same with Eq rebuilt from query-id bit planes
                   (the kernel's bit-plane form, alphabets past 32);
  sweep_shared     every lane against ONE target (_shared_kernel);
  hits_lanes       packed mask of the columns reaching a given best
                   (_hits_kernel, per-lane and shared forms);
  hits_bitplane    the same with bit-plane Eq (_hits_kernel, bit-plane;
                   hits_lanes' split-lane plan on K3's staged rows);
  nw_banded        NW score at hi-1 inside a sliding word window
                   (_nw_banded_kernel);
  shw_banded       banded SHW (best, pfirst, plast) (_shw_banded_kernel);
  shw_banded_hits  banded SHW hit mask (_shw_banded_hits_kernel; both on
                   nw_banded's word-parallel band where band_width
                   allows);
  capture          every column's (Pv, Mv[, Ph, Mh]) words, stored
                   (_capture_kernel), for the batched PATH decode;
  sweep_scores     every column's bottom-row score, stored (_sweep_kernel),
                   for buckets the JAX package sweeps as score streams (at
                   2-8 words the word-parallel lane, from 256 warp groups;
                   plan= reports what a call launched);
  reduce_eqstream  reduce_lanes with each column's Eq words gathered before
                   the launch (eqstream_gather; _reduce_kernel, eq-stream
                   form), for dense equalities past the per-lane cap;
  hits_eqstream    hits_lanes on the same stream (_hits_kernel, eq-stream;
                   both at 2-8 words the word-parallel lane);
  reduce_resume    reduce_lanes over one whole target segment from a
                   carried (Pv, Mv, score), the exit state written out
                   (_reduce_kernel, resume form), for the sharded pipelines
                   (split-lane cores, or the word-parallel lane; plan=
                   reports what a call launched);
  sweep_scores_resume  sweep_scores from and to a carried state
                   (jax_engine.sweep_scores_resumable, which the JAX package
                   leaves to XLA), for sharded_nw_pipeline;
  hw_adaptive      the value-adaptive banded HW/SHW reduce, one live word
                   band a 1,024-lane tile (_hw_adaptive_kernel), the tile
                   on a thread-block cluster (adaptive_plan);
  wavefront        ONE pair, every query word of it (or a fixed word
                   window) an anti-diagonal a step (wavefront._wf_kernel);
  wavefront_banded the same over a window of word slots sliding along the
                   band (wavefront._wfb_kernel).

Each wrapper checks its operands, runs the plain version when they lie on
the CPU, and otherwise launches its kernel on the current stream, raises on
a CUDA error, and counts the launch (launch_counts()).  A CUDA tensor never
falls back to the plain version.  reduce_lanes, reduce_bitplane,
sweep_shared, hits_lanes and hits_bitplane plan their launches here (the
split-lane schedule: split_core and below).

Layouts follow the JAX package's flat wrappers, (B, S1, NW) profiles and
(B, T) targets, without its (8, 128) lane tiles.  Bit words travel as int32
tensors holding the uint32 bit patterns (torch has no uint32 arithmetic on
the CPU); the kernels read them as uint32.  In the plain versions int32 add
and << wrap like uint32, and the logical >> 31 is written (x >> 31) & 1.
A hit mask is int32 (B, ceil(T/32)): bit j of word g marks scan column
32g + j.

Lane indices (prow, trow) name each lane's profile row and target row, so a
caller verifying maxc candidate windows per read, fanning a read over
target segments, or sweeping every lane against one shared target, never
materialises the repeated profiles or targets.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from edlib_tpu_torch.encode import WORD_SIZE
from edlib_tpu_torch.ops import _build

_BIG = 0x3FFFFFFF          # best of a lane that saw no column (pallas _BIG)
_I32 = torch.int32
# Kernel launches per wrapper, counted where each wrapper launches its kernel.
_LAUNCHES = {"reduce_lanes": 0, "reduce_bitplane": 0, "sweep_shared": 0,
             "hits_lanes": 0, "hits_bitplane": 0, "nw_banded": 0,
             "shw_banded": 0, "shw_banded_hits": 0, "capture": 0,
             "wavefront": 0, "wavefront_banded": 0, "sweep_scores": 0,
             "reduce_eqstream": 0, "hits_eqstream": 0, "reduce_resume": 0,
             "sweep_scores_resume": 0, "hw_adaptive": 0}

# ---------------------------------------------------------------------------
# Routing constants and the band schedule, as the JAX package computes them.
# ---------------------------------------------------------------------------

# pallas_kernel.vmem_limit_bytes() off the TPU (and on v4-v6 TPUs): the
# budget max_sigma1 and bitplane_ok divide.  This is a routing constant that
# makes both packages send the same bucket to the same kernel; the card's
# kernels have no such limit.
_ROUTING_VMEM_BYTES = 96 * 1024 * 1024
_TILE_LANES = 8 * 128      # the TPU kernels' lane tile, in the same formulas
_WIN_ROUND = 4             # band window widths round up to this many words


def max_sigma1(n_words: int, shared: bool) -> int:
    """Largest profile row count (sigma+1) the JAX package's per-lane
    (64) or shared (257) kernels take at this word count
    (pallas_kernel.max_sigma1 at the 96 MiB routing budget)."""
    vmem_rows = max(1, (_ROUTING_VMEM_BYTES // 4)
                    // (max(1, n_words) * _TILE_LANES * 4))
    return min(257 if shared else 64, vmem_rows)


def bitplane_ok(n_words: int, sigma: int, n_alts: int) -> bool:
    """Whether the JAX package routes this bucket to the bit-plane kernels
    (pallas_kernel.bitplane_ok at the routing budget)."""
    rows = n_alts * bitplane_nb(sigma) * n_words
    return rows * _TILE_LANES * 4 <= _ROUTING_VMEM_BYTES // 4


def eqstream_ok(n_pairs: int, n_words: int, t_scan: int, sigma: int) -> bool:
    """Whether the JAX package routes a per-lane bucket past the per-lane
    alphabet cap to its eq-stream kernels (batch._eqstream_ok): its
    estimate of the device memory the TPU route takes, for lanes padded to
    1024-lane tiles, the gathered stream twice and its gather's bf16 one-hot
    operand, within EDLIB_TPU_EQSTREAM_MAX_MB (default 1024).  Otherwise the
    bucket takes the score stream.  A routing constant, read with the JAX
    meaning so both packages send a bucket to the same kernels: the port
    keeps one stream and no one-hot, and the card has no such limit."""
    b_pad = -(-max(n_pairs, 1) // _TILE_LANES) * _TILE_LANES
    cap = int(os.environ.get("EDLIB_TPU_EQSTREAM_MAX_MB", "1024")) << 20
    stream = b_pad * t_scan * n_words * 4 * 2
    onehot = b_pad * t_scan * (sigma + 1) * 2
    return stream + onehot <= cap


def adaptive_classes(n_words: int):
    """The adaptive reduce's live-width classes, ascending and ending at
    n_words (pallas_kernel.adaptive_classes): fine at the bottom, where
    mapping spends its steady state, coarse above."""
    if n_words <= 4:
        return list(range(1, n_words + 1))
    cs = [1, 2, 4]
    step = max(2, n_words // 4)
    w = 4 + step
    while w < n_words:
        cs.append(w)
        w += step
    cs.append(n_words)
    return sorted(set(c for c in cs if c <= n_words))


def nw_band_schedule(n_words: int, n_chunks: int, chunk: int,
                     d_lo: int, d_hi: int):
    """(per-chunk window offsets int32 (n_chunks,), window width) for live
    scan diagonals row - col in [d_lo, d_hi] (pallas_kernel.nw_band_schedule).

    The window covers [w_lo, w_hi) of the exact band in every chunk (wider is
    still exact), rounded up to _WIN_ROUND words, and reaches the bottom word
    by the chunk holding each feasible lane's final column."""
    j = np.arange(n_chunks, dtype=np.int64)
    c_first = j * chunk
    c_last = c_first + chunk - 1
    w_hi = np.clip((c_last + d_hi) // 32 + 1, 1, n_words)
    w_lo = np.clip((c_first + d_lo) // 32, 0, n_words - 1)
    w_lo = np.minimum(w_lo, w_hi - 1)
    width = int(np.max(w_hi - w_lo))
    n_win = min(-(-width // _WIN_ROUND) * _WIN_ROUND, n_words)
    woff = np.clip(w_lo, 0, n_words - n_win)
    woff = np.maximum.accumulate(woff)
    return woff.astype(np.int32), n_win


# ---------------------------------------------------------------------------
# Operand builders (plain PyTorch on whichever device the inputs are on).
# ---------------------------------------------------------------------------


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool (..., n*32) -> int32 (..., n): bit i of word g = mask[32g + i]."""
    shape = mask.shape[:-1] + (mask.shape[-1] // WORD_SIZE, WORD_SIZE)
    shifts = torch.arange(WORD_SIZE, dtype=_I32, device=mask.device)
    return (mask.reshape(shape).to(_I32) << shifts).sum(-1, dtype=_I32)


def build_peq_device(q_ids: torch.Tensor, qlens: torch.Tensor, sigma: int,
                     n_words: int) -> torch.Tensor:
    """Query profiles, (B, sigma+1, n_words) int32 bit words.

    q_ids: (B, Qmax) symbol ids in [0, sigma) (entries past qlens are
    ignored).  Row sigma is the wildcard (all ones); rows past each qlen
    match every symbol.  Counterpart of pallas_kernel.build_peq_device, built
    by scatter: O(B * Qmax) memory instead of O(B * S1 * NW * 32)."""
    B, qmax = q_ids.shape
    dev = q_ids.device
    s1 = sigma + 1
    rows = torch.arange(qmax, dtype=torch.int64, device=dev)
    valid = rows[None, :] < qlens.to(torch.int64)[:, None]
    sym = torch.where(valid, q_ids.to(torch.int64), 0)
    flat = ((torch.arange(B, dtype=torch.int64, device=dev)[:, None] * s1
             + sym) * n_words + rows[None, :] // WORD_SIZE)
    bit = torch.ones(1, dtype=_I32, device=dev) << (rows % WORD_SIZE).to(_I32)
    vals = torch.where(valid, bit[None, :], 0)
    peq = torch.zeros(B * s1 * n_words, dtype=_I32, device=dev)
    peq.scatter_add_(0, flat.reshape(-1), vals.reshape(-1))
    peq = peq.view(B, s1, n_words)
    all_rows = torch.arange(n_words * WORD_SIZE, device=dev)
    pad = _pack_bits(all_rows[None, :] >= qlens.to(torch.int64)[:, None])
    peq |= pad[:, None, :]
    peq[:, sigma, :] = -1
    return peq


def build_peq_eq_device(q_ids: torch.Tensor, qlens: torch.Tensor,
                        eq_s1: torch.Tensor, n_words: int) -> torch.Tensor:
    """Query profiles under an equality matrix, (B, S1, n_words) int32.

    q_ids: (B, >= n_words*32) symbol ids (entries past qlens are ignored);
    eq_s1: bool (S1, S1), the equality matrix with the wildcard row and
    column S1-1 all True.  Bit i of word w of row s is eq_s1[s, q[32w+i]],
    and every bit of a row past qlen is set (path/batched.py's profile,
    the Peq build of the JAX package's _capture_walk)."""
    B = q_ids.shape[0]
    s1 = eq_s1.shape[0]
    R = n_words * WORD_SIZE
    rows = torch.arange(R, device=q_ids.device)
    q = q_ids[:, :R].to(torch.int64).clamp(0, s1 - 1)
    pad = rows[None, :] >= qlens.to(torch.int64)[:, None]       # (B, R)
    match = eq_s1[:, q].permute(1, 0, 2) | pad[:, None, :]      # (B, S1, R)
    return _pack_bits(match).reshape(B, s1, n_words)


def bitplane_nb(sigma: int) -> int:
    """Bit planes per alternative: enough for symbols [0, sigma] plus a
    sentinel id (1<<nb)-1 > sigma that matches no target symbol."""
    return (sigma + 1).bit_length()


def bitplane_identity_operands(q_arr: torch.Tensor, qlens: torch.Tensor,
                               sigma: int, n_words: int):
    """(q_alts int32 (B, 1, NW*32), pad_words int32 (B, NW)) for identity
    equality: the reads with the sentinel in every pad slot, and the packed
    bits of rows past each qlen (pallas_kernel.bitplane_identity_operands)."""
    B, qmax = q_arr.shape
    dev = q_arr.device
    R = n_words * WORD_SIZE
    sent = (1 << bitplane_nb(sigma)) - 1
    pad = (torch.arange(R, device=dev)[None, :]
           >= qlens.to(torch.int64)[:, None])
    qa = torch.full((B, R), sent, dtype=_I32, device=dev)
    qa[:, :qmax] = q_arr.to(_I32)
    q_alts = torch.where(pad, sent, qa)[:, None, :]
    return q_alts, _pack_bits(pad)


def eqstream_gather(peq: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """eq[b, c, w] = peq[b, targets[b, c], w]: int32 (B, T, NW), a view of
    lane-minor (T, NW, B) storage, so x.permute(1, 2, 0) is the eq-stream
    kernels' contiguous operand.  An exact index gather, one per word
    (pallas_kernel.eqstream_gather, which gathers with a one-hot product on
    the TPU's matrix unit).  peq: int32 (B, S1, NW); targets: int32 (B, T)
    in [0, S1)."""
    B, _, nw = peq.shape
    T = targets.shape[1]
    out = torch.empty((T, nw, B), dtype=_I32, device=peq.device)
    idx = targets.long()
    for w in range(nw):
        out[:, w, :] = torch.gather(peq[:, :, w], 1, idx).t()
    return out.permute(2, 0, 1)


def bitplane_planes(q_alts: torch.Tensor, nb: int) -> torch.Tensor:
    """int32 (B, E*nb*NW): plane (e, b) word w holds bit b of the ids of
    query rows 32w..32w+31 of alternative e (the kernel's operand)."""
    B, E, R = q_alts.shape
    shifts = torch.arange(nb, dtype=_I32, device=q_alts.device)
    bits = ((q_alts[:, :, None, :] >> shifts[None, None, :, None]) & 1) > 0
    return _pack_bits(bits).reshape(B, E * nb * (R // WORD_SIZE))


# ---------------------------------------------------------------------------
# Plain versions: lanes vectorised, a Python loop over columns.  A sweep
# yields (column, score, live) for every column up to the furthest hi; a
# visitor reduces what it yields as the kernels' visitors do (live is False
# where a band window has not reached the bottom word).
# ---------------------------------------------------------------------------


def _advance_word_h(pv, mv, eq, hneg, hpos):
    """Myers block update on int32 bit words (pallas_kernel._advance_word_h):
    (Pv', Mv', hout_neg, hout_pos, Ph, Mh) with Ph/Mh the unshifted
    horizontal delta words."""
    xv = eq | mv
    eq = eq | hneg
    xh = (((eq & pv) + pv) ^ pv) | eq
    ph = mv | ~(xh | pv)
    mh = pv & xh
    phs = (ph << 1) | hpos
    mhs = (mh << 1) | hneg
    return (mhs | ~(xv | phs), phs & xv, (mh >> 31) & 1, (ph >> 31) & 1,
            ph, mh)


def _advance_word(pv, mv, eq, hneg, hpos):
    """Myers block update on int32 bit words (pallas_kernel._advance_word):
    (Pv', Mv', hout_neg, hout_pos)."""
    return _advance_word_h(pv, mv, eq, hneg, hpos)[:4]


def _columns_end(n_cols: int, hi) -> int:
    return min(n_cols, int(hi.max())) if hi.shape[0] else 0


def _sweep_plain(eq_at, end: int, n_words: int, n_lanes: int, dev,
                 hin0: int, carry=None, exit_state=None):
    """Advance every lane over columns [0, end); eq_at(c) returns the
    column's Eq words, a list of NW int32 (B,) tensors.  carry: (pv (B, NW),
    mv (B, NW), score (B,)) to start from instead of a fresh start;
    exit_state: a list that receives the state after the last column."""
    if carry is None:
        pv = [torch.full((n_lanes,), -1, dtype=_I32, device=dev)] * n_words
        mv = [torch.zeros(n_lanes, dtype=_I32, device=dev)] * n_words
        score = torch.full((n_lanes,), n_words * WORD_SIZE, dtype=_I32,
                           device=dev)
    else:
        pv, mv = list(carry[0].unbind(1)), list(carry[1].unbind(1))
        score = carry[2]
    zero = torch.zeros(n_lanes, dtype=_I32, device=dev)
    hpos0 = torch.full((n_lanes,), hin0, dtype=_I32, device=dev)
    for c in range(end):
        eqs = eq_at(c)
        hneg, hpos = zero, hpos0
        for w in range(n_words):
            pv[w], mv[w], hneg, hpos = _advance_word(pv[w], mv[w], eqs[w],
                                                     hneg, hpos)
        score = score + hpos - hneg
        yield c, score, True
    if exit_state is not None:
        exit_state.extend([torch.stack(pv, 1), torch.stack(mv, 1), score])


def _sweep_banded_plain(words_at, end: int, n_words: int, n_lanes: int, dev,
                        woff, chunk: int, n_win: int):
    """The banded kernels' sweep: only window words [woff[c // chunk],
    +n_win) advance, hin = +1 into the window top, the score is the window's
    bottom row; words_at(c) returns the column's (B, NW) Eq words."""
    woff = [int(x) for x in woff]
    pv = [torch.full((n_lanes,), -1, dtype=_I32, device=dev)] * n_words
    mv = [torch.zeros(n_lanes, dtype=_I32, device=dev)] * n_words
    off = woff[0] if woff else 0
    score = torch.full((n_lanes,), (off + n_win) * WORD_SIZE, dtype=_I32,
                       device=dev)
    zero = torch.zeros(n_lanes, dtype=_I32, device=dev)
    one = torch.ones(n_lanes, dtype=_I32, device=dev)
    for c in range(end):
        if c and c % chunk == 0:
            nxt = woff[c // chunk]
            score = score + (nxt - off) * WORD_SIZE
            off = nxt
        words = words_at(c)
        hneg, hpos = zero, one
        for w in range(off, off + n_win):
            pv[w], mv[w], hneg, hpos = _advance_word(pv[w], mv[w],
                                                     words[:, w], hneg, hpos)
        score = score + hpos - hneg
        yield c, score, off == n_words - n_win


def _reduction(columns, lo, hi):
    """(best, pfirst, plast, last) over the live columns in [lo, hi)."""
    best = torch.full_like(lo, _BIG)
    pfirst = torch.full_like(lo, -1)
    plast = pfirst.clone()
    last = best.clone()
    for c, score, live in columns:
        if not live:
            continue
        in_win = (lo <= c) & (hi > c)
        upd = (score < best) & in_win
        pfirst = torch.where(upd, c, pfirst)
        plast = torch.where((score <= best) & in_win, c, plast)
        best = torch.where(upd, score, best)
        last = torch.where(hi - 1 == c, score, last)
    return best, pfirst, plast, last


def _hit_words(columns, lo, hi, best, n_cols: int):
    """int32 (B, ceil(n_cols/32)) mask of live columns in [lo, hi) whose
    score equals best."""
    out = torch.zeros((lo.shape[0], -(-n_cols // WORD_SIZE)), dtype=_I32,
                      device=lo.device)
    for c, score, live in columns:
        if not live:
            continue
        hit = ((score == best) & (lo <= c) & (hi > c)).to(_I32)
        out[:, c // WORD_SIZE] |= hit << (c % WORD_SIZE)
    return out


def _peq_columns(peq, targets, hi, prow, trow, hin0, carry=None,
                 exit_state=None):
    """Plain sweep of per-lane profiles over per-lane target rows: up to
    the furthest hi, or, resuming from a carry, every column."""
    n_words = peq.shape[2]
    end = (targets.shape[1] if carry is not None
           else _columns_end(targets.shape[1], hi))
    prof = peq[prow.long()]                               # (B, S1, NW)
    tg = targets[trow.long(), :end]                       # (B, end)
    lanes = torch.arange(hi.shape[0], device=hi.device)

    def eq_at(c):
        words = prof[lanes, tg[:, c].long()]              # (B, NW)
        return [words[:, w] for w in range(n_words)]

    return _sweep_plain(eq_at, end, n_words, hi.shape[0], hi.device, hin0,
                        carry, exit_state)


def _bitplane_eq(pl, pd, sym, nb: int, n_alts: int, wildcard: int):
    """Eq words (a list of NW int32 (n,) tensors) of symbols sym (n,) from
    bit planes pl (n, E*nb*NW) and pad pd (n, NW): row i matches where
    every bit of some alternative id equals the symbol's (BitplaneEq)."""
    n_words = pd.shape[1]
    tb = [-((sym >> b) & 1) for b in range(nb)]
    wild = torch.where(sym == wildcard, -1, 0).to(_I32)
    words = []
    for w in range(n_words):
        acc = pd[:, w] | wild
        for e in range(n_alts):
            base = e * nb * n_words + w
            x = pl[:, base] ^ tb[0]
            for b in range(1, nb):
                x = x | (pl[:, base + b * n_words] ^ tb[b])
            acc = acc | ~x
        words.append(acc)
    return words


def bitplane_profile(planes, pad, nb: int, n_alts: int, wildcard: int):
    """int32 (R_p, 2^nb, NW): every row's Eq words for every symbol the
    planes tell apart, the profile K3's split kernel expands in shared
    memory (csrc/myers.cu reduce_bitplane_split_kernel)."""
    R, nw = pad.shape
    S = 1 << nb
    sym = torch.arange(S, dtype=_I32, device=pad.device).repeat(R)
    pl = planes.repeat_interleave(S, 0)
    pd = pad.repeat_interleave(S, 0)
    words = _bitplane_eq(pl, pd, sym, nb, n_alts, wildcard)
    return torch.stack(words, 1).reshape(R, S, nw)


def _bitplane_columns(planes, pad, targets, hi, prow, trow, hin0, nb,
                      n_alts, wildcard):
    """Plain sweep with Eq rebuilt from query-id bit planes."""
    n_words = pad.shape[1]
    end = _columns_end(targets.shape[1], hi)
    pl = planes[prow.long()]                              # (B, E*nb*NW)
    pd = pad[prow.long()]                                 # (B, NW)
    tg = targets[trow.long(), :end]
    return _sweep_plain(
        lambda c: _bitplane_eq(pl, pd, tg[:, c], nb, n_alts, wildcard), end,
        n_words, hi.shape[0], hi.device, hin0)


def _stream_columns(eq_t, hi, hin0):
    """Plain sweep over a gathered Eq stream int32 (T, NW, B)."""
    T, n_words, B = eq_t.shape
    end = _columns_end(T, hi)
    return _sweep_plain(lambda c: list(eq_t[c].unbind(0)), end, n_words, B,
                        hi.device, hin0)


def _banded_columns(peq, targets, woff, hi, prow, trow, n_win, chunk):
    """Plain banded sweep of per-lane profiles over per-lane target rows."""
    end = _columns_end(targets.shape[1], hi)
    prof = peq[prow.long()]
    tg = targets[trow.long(), :end]
    lanes = torch.arange(hi.shape[0], device=hi.device)
    return _sweep_banded_plain(
        lambda c: prof[lanes, tg[:, c].long()], end, peq.shape[2],
        hi.shape[0], hi.device, woff.tolist(), chunk, n_win)


def capture_plain(peq, targets, hin0: int, want_h: bool = False):
    """Plain version of capture (same operands and outputs)."""
    B, _, n_words = peq.shape
    T = targets.shape[1]
    dev = peq.device
    lanes = torch.arange(B, device=dev)
    n_out = 4 if want_h else 2
    outs = [torch.empty((T, n_words, B), dtype=_I32, device=dev)
            for _ in range(n_out)]
    pv = [torch.full((B,), -1, dtype=_I32, device=dev)] * n_words
    mv = [torch.zeros(B, dtype=_I32, device=dev)] * n_words
    zero = torch.zeros(B, dtype=_I32, device=dev)
    hpos0 = torch.full((B,), hin0, dtype=_I32, device=dev)
    for c in range(T):
        words = peq[lanes, targets[:, c].long()]                # (B, NW)
        hneg, hpos = zero, hpos0
        ph, mh = [None] * n_words, [None] * n_words
        for w in range(n_words):
            pv[w], mv[w], hneg, hpos, ph[w], mh[w] = _advance_word_h(
                pv[w], mv[w], words[:, w], hneg, hpos)
        for out, val in zip(outs, (pv, mv, ph, mh)):
            out[c] = torch.stack(val)
    return tuple(o.permute(2, 0, 1) for o in outs)


def sweep_scores_plain(peq, targets, prow, trow, hin0: int):
    """Plain version of sweep_scores (same operands and output)."""
    T, n = targets.shape[1], prow.shape[0]
    out = torch.empty((T, n), dtype=_I32, device=prow.device)
    hi = torch.full((n,), T, dtype=_I32, device=prow.device)
    for c, score, _ in _peq_columns(peq, targets, hi, prow, trow, hin0):
        out[c] = score
    return out.t()


def sweep_scores_resume_plain(peq, targets, prow, trow, pv0, mv0, s0,
                              hin0: int):
    """Plain version of sweep_scores_resume (same operands and outputs)."""
    T, n = targets.shape[1], prow.shape[0]
    out = torch.empty((T, n), dtype=_I32, device=prow.device)
    hi = torch.full((n,), T, dtype=_I32, device=prow.device)
    state = []
    for c, score, _ in _peq_columns(peq, targets, hi, prow, trow, hin0,
                                    (pv0, mv0, s0), state):
        out[c] = score
    return (out.t(),) + tuple(state)


def reduce_resume_plain(peq, targets, lo, hi, prow, trow, pv0, mv0, s0,
                        hin0: int):
    """Plain version of reduce_resume (same operands and outputs)."""
    state = []
    red = _reduction(_peq_columns(peq, targets, hi, prow, trow, hin0,
                                  (pv0, mv0, s0), state), lo, hi)
    return red + tuple(state)


def _min_cells_exact(pv, mv, bottom):
    """Exact minimum cell of one word per lane (pallas_kernel.
    _min_cells_exact): bottom minus the largest suffix sum of the bit
    deltas from bit 31 down to bit 0, the empty suffix included."""
    total = torch.zeros_like(bottom)
    best = torch.zeros_like(bottom)
    for i in range(WORD_SIZE - 1, -1, -1):
        total = total + ((pv >> i) & 1) - ((mv >> i) & 1)
        best = torch.maximum(best, total)
    return bottom - best


def hw_adaptive_plain(peq, targets, lo, hi, prow, trow, k: int, hin0: int,
                      group: int, strong_every: int, live=None):
    """Plain version of hw_adaptive (same operands and outputs), every
    1,024-lane tile with its own band, vectorised over tiles."""
    n, nw = lo.shape[0], peq.shape[2]
    dev = lo.device
    n_tiles = n // _TILE_LANES
    classes = adaptive_classes(nw)

    def class_at_least(raw):
        out = torch.full_like(raw, classes[-1])
        for c in reversed(classes[:-1]):
            out = torch.where(raw <= c, c, out)
        return out

    def tile_min(x):
        return x.view(n_tiles, _TILE_LANES).amin(1)

    def per_lane(x):
        return x.repeat_interleave(_TILE_LANES)

    T = targets.shape[1]
    end = int(hi.clamp(max=T).max()) if n else 0
    tile_end = hi.clamp(max=T).view(n_tiles, _TILE_LANES).amax(1)
    if live is not None:
        live.zero_()
    prof = peq[prow.long()]                               # (n, S1, NW)
    trows = trow.long()
    lanes = torch.arange(n, device=dev)
    pv = [torch.full((n,), -1, dtype=_I32, device=dev)] * nw
    mv = [torch.zeros(n, dtype=_I32, device=dev)] * nw
    sw = [torch.full((n,), WORD_SIZE * (w + 1), dtype=_I32, device=dev)
          for w in range(nw)]
    best = torch.full((n,), _BIG, dtype=_I32, device=dev)
    pfirst = torch.full((n,), -1, dtype=_I32, device=dev)
    plast = pfirst.clone()
    zero = torch.zeros(n, dtype=_I32, device=dev)
    hpos0 = torch.full((n,), hin0, dtype=_I32, device=dev)
    whi = class_at_least(torch.full((n_tiles,), min(max((k + 32) // 32, 1),
                                                    nw), dtype=_I32,
                                    device=dev))
    for g, c0 in enumerate(range(0, end, group)):
        cw = per_lane(whi)
        full = cw == nw
        n_live = int(whi.max())
        c1 = min(c0 + group, end)
        if live is not None:
            live += (whi.long() * (torch.clamp(tile_end, max=c1) - c0)
                     .clamp(min=0))
        for c in range(c0, c1):
            words = prof[lanes, targets[trows, c].long()]     # (n, NW)
            hneg, hpos = zero, hpos0
            for w in range(n_live):
                in_band = cw > w
                p2, m2, hneg, hpos = _advance_word(pv[w], mv[w],
                                                   words[:, w], hneg, hpos)
                pv[w] = torch.where(in_band, p2, pv[w])
                mv[w] = torch.where(in_band, m2, mv[w])
                sw[w] = torch.where(in_band, sw[w] + hpos - hneg, sw[w])
            score = sw[nw - 1]
            in_win = full & (lo <= c) & (hi > c)
            upd = (score < best) & in_win
            pfirst = torch.where(upd, c, pfirst)
            plast = torch.where((score <= best) & in_win, c, plast)
            best = torch.where(upd, score, best)
        if c1 >= end:
            break
        # The band for the next group (dead words' stale mins are masked).
        keff = torch.clamp(best, max=k)
        m = [tile_min(sw[w] - keff) for w in range(nw)]
        ms = torch.stack(m)                                   # (NW, tiles)
        tiles = torch.arange(n_tiles, device=dev)
        mlast = ms[(whi - 1).long(), tiles]
        grow = mlast <= group
        n_grow = torch.where(grow, (group - mlast) // 32 + 1, 0)
        grown = torch.clamp(whi + n_grow, max=nw)
        keep_hi = torch.ones_like(whi)
        for w in range(1, nw):
            keep_hi = torch.where((w < whi) & (m[w] < 32 + group), w + 1,
                                  keep_hi)
        raw = torch.where(grow, grown, keep_hi)
        if strong_every > 0 and (g + 1) % strong_every == 0:
            kh = torch.ones_like(whi)
            for w in range(1, nw):
                mc = tile_min(_min_cells_exact(pv[w], mv[w], sw[w]) - keff)
                kh = torch.where((w < whi) & (mc <= group), w + 1, kh)
            raw = torch.minimum(raw, torch.maximum(
                kh, torch.where(grow, grown, 1)))
        whi_new = class_at_least(raw)
        # Rejoining words restart on the ramp below the last live word.
        wl, wnl = per_lane(whi), per_lane(whi_new)
        last_bot = torch.stack(sw)[(wl - 1).long(), lanes]
        for w in range(1, nw):
            rejoin = (w >= wl) & (w < wnl)
            pv[w] = torch.where(rejoin, -1, pv[w])
            mv[w] = torch.where(rejoin, 0, mv[w])
            sw[w] = torch.where(rejoin, last_bot + 32 * (w - wl + 1), sw[w])
        whi = whi_new
    return best, pfirst, plast


def reduce_eqstream_plain(eq_t, lo, hi, hin0: int):
    """Plain version of reduce_eqstream (same operands and outputs)."""
    return _reduction(_stream_columns(eq_t, hi, hin0), lo, hi)


def hits_eqstream_plain(eq_t, lo, hi, best, hin0: int):
    """Plain version of hits_eqstream (same operands and output)."""
    return _hit_words(_stream_columns(eq_t, hi, hin0), lo, hi, best,
                      eq_t.shape[0])


def reduce_lanes_plain(peq, targets, lo, hi, prow, trow, hin0: int):
    """Plain version of reduce_lanes (same operands and outputs)."""
    return _reduction(_peq_columns(peq, targets, hi, prow, trow, hin0), lo,
                      hi)


def reduce_bitplane_plain(planes, pad, targets, lo, hi, prow, trow,
                          hin0: int, nb: int, n_alts: int, wildcard: int):
    """Plain version of reduce_bitplane (same operands and outputs)."""
    return _reduction(_bitplane_columns(planes, pad, targets, hi, prow, trow,
                                        hin0, nb, n_alts, wildcard), lo, hi)


def sweep_shared_plain(peq_t, target, hin0: int, col_lo: int, col_hi: int):
    """Plain version of sweep_shared (same operands and outputs)."""
    n_words, B = peq_t.shape[1], peq_t.shape[2]
    dev = peq_t.device
    lo = torch.full((B,), col_lo, dtype=_I32, device=dev)
    hi = torch.full((B,), col_hi, dtype=_I32, device=dev)
    syms = target.tolist()

    def eq_at(c):
        words = peq_t[syms[c]]                            # (NW, B)
        return [words[w] for w in range(n_words)]

    end = _columns_end(target.shape[0], hi)
    best, pfirst, _, _ = _reduction(
        _sweep_plain(eq_at, end, n_words, B, dev, hin0), lo, hi)
    return best, pfirst


def hits_lanes_plain(peq, targets, lo, hi, prow, trow, best, hin0: int):
    """Plain version of hits_lanes (same operands and output)."""
    return _hit_words(_peq_columns(peq, targets, hi, prow, trow, hin0), lo,
                      hi, best, targets.shape[1])


def hits_bitplane_plain(planes, pad, targets, lo, hi, prow, trow, best,
                        hin0: int, nb: int, n_alts: int, wildcard: int):
    """Plain version of hits_bitplane (same operands and output)."""
    return _hit_words(_bitplane_columns(planes, pad, targets, hi, prow, trow,
                                        hin0, nb, n_alts, wildcard), lo, hi,
                      best, targets.shape[1])


def nw_banded_plain(peq, targets, woff, hi, prow, trow, n_win: int,
                    chunk: int):
    """Plain version of nw_banded (same operands and output)."""
    cols = _banded_columns(peq, targets, woff, hi, prow, trow, n_win, chunk)
    return _reduction(cols, torch.zeros_like(hi), hi)[3]


def shw_banded_plain(peq, targets, woff, lo, hi, prow, trow, n_win: int,
                     chunk: int):
    """Plain version of shw_banded (same operands and outputs)."""
    cols = _banded_columns(peq, targets, woff, hi, prow, trow, n_win, chunk)
    return _reduction(cols, lo, hi)[:3]


def shw_banded_hits_plain(peq, targets, woff, lo, hi, prow, trow, best,
                          n_win: int, chunk: int):
    """Plain version of shw_banded_hits (same operands and output)."""
    cols = _banded_columns(peq, targets, woff, hi, prow, trow, n_win, chunk)
    return _hit_words(cols, lo, hi, best, targets.shape[1])


# ---------------------------------------------------------------------------
# The split-lane schedule of K1 (reduce_lanes), K3 (reduce_bitplane) and K2
# (sweep_shared) at 1-8 words (csrc/myers.cu says why it is exact): in HW
# mode a lane's scanned columns are cut into cores, each (lane, core) one
# thread that sweeps from
# the fresh state split_halo columns before its core and reduces its core;
# the cores merge by packed keys.  The plan the wrappers hand the kernels,
# and a plain emulation of the schedule that the tests hold against the JAX
# package.
# ---------------------------------------------------------------------------

_FILL_THREADS = 132 * 16 * WORD_SIZE  # (lane, core) threads: 16 warps an SM
_SPLIT_MAX_WORDS = 8                   # the split kernels' register forms
# Packed keys (csrc/myers.cu first_key, last_key) of a lane that saw no
# column: (_BIG, -1) in both.
_KEY_FIRST_NONE = (_BIG << 32) | 0xFFFFFFFF
_KEY_LAST_NONE = 0xFFFFFFFF


def split_halo(n_words: int) -> int:
    """Columns a core's sweep starts before its core: 2R, R = 32 * NW.
    Every HW bottom-row score is <= R, and an alignment of cost d spans at
    most R + d columns; so does every row's: a cell of row i is <= i + 1
    and its optimal path spans <= 2 (i + 1) <= 2R columns, which makes
    every word's state exact from the core on (the wavefront's cores)."""
    return 2 * n_words * WORD_SIZE


def split_core(n_lanes: int, cols: int, n_words: int, hin0: int,
               core=None) -> int:
    """Columns each (lane, core) thread reduces, for n_lanes lanes of at
    most `cols` scanned columns: enough cores for _FILL_THREADS threads, but
    at least 4 halos (so the halo adds at most 25% work); a lane that short
    stays one thread.  `core` forces it (checks only).  hin0 = 1 (a
    column's score depends on column 0) and lanes past 8 words keep one
    core a lane: max(cols, 1)."""
    if hin0 or n_words > _SPLIT_MAX_WORDS:
        return max(cols, 1)
    if core is not None:
        return max(1, int(core))
    return max(4 * split_halo(n_words), -(-n_lanes * cols // _FILL_THREADS))


def split_cores(lo, hi, n_cols: int, core: int, word_aligned: bool = False):
    """(s, end, count) (B,): a lane scans [s, end), end = min(hi,
    n_cols) and s = max(0, min(lo, end - 1)) (so hi - 1 is scanned where it
    is a column, also when the window [lo, hi) is empty), in `count` cores
    of `core` columns.  word_aligned (hits_lanes' plan, core a multiple of
    32): s rounded down to a multiple of 32, so that every hit word lies in
    one core."""
    end = hi.clamp(0, n_cols)
    s = torch.minimum(lo, end - 1).clamp(min=0)
    if word_aligned:
        s = s - s % WORD_SIZE
    n = (end - s).clamp(min=0).long()
    return s, end, (n + (core - 1)) // core


def split_offsets(counts) -> torch.Tensor:
    """int32 (B + 1,): each lane's first thread (the exclusive prefix sum of
    the core counts), the total last."""
    off = torch.zeros(counts.shape[0] + 1, dtype=_I32, device=counts.device)
    off[1:] = torch.cumsum(counts, 0)
    return off


def split_core_ranges(lo, hi, n_cols: int, core: int, halo,
                      word_aligned: bool = False):
    """Every (lane, core) of the schedule in thread order, int64 (n,) each:
    its lane, its core [c_lo, c_hi) and the column its sweep starts from
    (max(0, c_lo - halo); 0 with halo None, for lanes that stay whole);
    word_aligned as split_cores."""
    s, end, counts = split_cores(lo, hi, n_cols, core, word_aligned)
    dev = lo.device
    lane = torch.repeat_interleave(torch.arange(lo.shape[0], device=dev),
                                   counts.long())
    k = torch.arange(lane.shape[0], device=dev) - split_offsets(counts)[
        lane].long()
    c_lo = s.long()[lane] + k * core
    c_hi = torch.minimum(c_lo + core, end.long()[lane])
    start = (torch.zeros_like(c_lo) if halo is None
             else (c_lo - halo).clamp(min=0))
    return lane, c_lo, c_hi, start


def _new_keys(n: int, count: int, dev) -> torch.Tensor:
    """int64 (count, n) packed keys of lanes that saw no column: first
    keys, then (count 2) last keys."""
    keys = torch.empty((count, n), dtype=torch.int64, device=dev)
    keys[0] = _KEY_FIRST_NONE
    if count > 1:
        keys[1] = _KEY_LAST_NONE
    return keys


def _unpack_keys(keys):
    """(best, pfirst[, plast]) int32 (n,) from packed keys int64 (count, n):
    a key's high 32-bit word is the score, its low word the column (all ones
    where no column was seen: -1).  A little-endian device (x86, ARM, every
    CUDA card) holds a key as (low, high) int32 words, so one copy splits
    them."""
    w = keys.view(_I32).view(keys.shape[0], -1, 2).permute(0, 2, 1)
    w = w.contiguous()
    return (w[0, 1], w[0, 0]) + ((w[1, 0],) if keys.shape[0] > 1 else ())


def _split_emulate(reduce, nw: int, targets, lo, hi, prow, trow, hin0: int,
                   core: int):
    """The schedule in plain PyTorch: reduce(rows, lo, hi, prow, trow) is
    the plain per-lane reduce that sweeps each (lane, core)."""
    n_cols, B = targets.shape[1], lo.shape[0]
    dev = lo.device
    halo = None if hin0 or nw > _SPLIT_MAX_WORDS else split_halo(nw)
    lane, c_lo, c_hi, start = split_core_ranges(lo, hi, n_cols, core, halo)
    keys = _new_keys(B, 2, dev)
    last = torch.full((B,), _BIG, dtype=_I32, device=dev)
    n = lane.shape[0]
    if n:
        width = int((c_hi - start).max())
        cols = (start[:, None] + torch.arange(width, device=dev)).clamp(
            max=n_cols - 1)
        rows = targets[trow.long()[lane][:, None], cols]
        best, pf, pl, lst = reduce(
            rows, (torch.maximum(lo.long()[lane], c_lo) - start).to(_I32),
            (c_hi - start).to(_I32), prow[lane],
            torch.arange(n, dtype=_I32, device=dev))
        seen = pf >= 0
        b = best.long()[seen]
        keys[0].scatter_reduce_(
            0, lane[seen], (b << 32) | (pf.long() + start)[seen], "amin")
        keys[1].scatter_reduce_(
            0, lane[seen], ((_BIG - b) << 32) | (pl.long() + start)[seen],
            "amax")
        h = hi.long()[lane] - 1
        holds = (h >= c_lo) & (h < c_hi)
        last[lane[holds]] = lst[holds]
    return _unpack_keys(keys) + (last,)


def split_reduce_plain(peq, targets, lo, hi, prow, trow, hin0: int,
                       core=None):
    """reduce_lanes' split-lane schedule in plain PyTorch: every (lane,
    core) swept by reduce_lanes_plain from the fresh state at its start,
    reduced over its core, and merged by packed keys as the kernel merges
    them.  Operands and outputs as reduce_lanes."""
    c = split_core(lo.shape[0], targets.shape[1], peq.shape[2], hin0, core)
    return _split_emulate(
        lambda *ops: reduce_lanes_plain(peq, *ops, hin0), peq.shape[2],
        targets, lo, hi, prow, trow, hin0, c)


def split_bitplane_plain(planes, pad, targets, lo, hi, prow, trow,
                         hin0: int, nb: int, n_alts: int, wildcard: int,
                         core=None):
    """reduce_bitplane's split-lane schedule in plain PyTorch (K1's
    schedule, Eq from the bit planes); operands and outputs as
    reduce_bitplane."""
    nw = pad.shape[1]
    c = split_core(lo.shape[0], targets.shape[1], nw, hin0, core)
    return _split_emulate(
        lambda *ops: reduce_bitplane_plain(planes, pad, *ops, hin0, nb,
                                           n_alts, wildcard),
        nw, targets, lo, hi, prow, trow, hin0, c)


def hits_core(n_lanes: int, cols: int, n_words: int, hin0: int,
              core=None) -> int:
    """Columns a core of hits_lanes' and hits_bitplane's split-lane plan:
    split_core's, rounded up to a multiple of 32 so that cores counted
    from a multiple of 32 (split_cores with word_aligned) own whole hit
    words; hin0 = 1 and lanes past 8 words keep one core a lane
    (max(cols, 1))."""
    c = split_core(n_lanes, cols, n_words, hin0, core)
    if hin0 or n_words > _SPLIT_MAX_WORDS:
        return c
    return -(-c // WORD_SIZE) * WORD_SIZE


def _split_hits_emulate(hits, nw: int, targets, lo, hi, prow, trow, best,
                        hin0: int, core: int):
    """The word-aligned hit-word schedule in plain PyTorch: every (lane,
    core) of split_cores(..., word_aligned=True) swept by hits(rows, lo,
    hi, prow, trow, best), the plain per-lane hits, from the fresh state
    at its start (split_halo before its core; column 0 at hin0 = 1),
    marking its core's columns, and the cores' hit bits OR-ed into their
    lane's words."""
    n_cols, B = targets.shape[1], lo.shape[0]
    dev = lo.device
    lane, c_lo, c_hi, start = split_core_ranges(
        lo, hi, n_cols, core, None if hin0 else split_halo(nw), True)
    n_out = -(-n_cols // WORD_SIZE)
    bits = torch.zeros((B, n_out * WORD_SIZE), dtype=torch.int64, device=dev)
    n = lane.shape[0]
    if n:
        width = int((c_hi - start).max())
        cols = start[:, None] + torch.arange(width, device=dev)
        words = hits(
            targets[trow.long()[lane][:, None], cols.clamp(max=n_cols - 1)],
            (torch.maximum(lo.long()[lane], c_lo) - start).to(_I32),
            (c_hi - start).to(_I32), prow[lane],
            torch.arange(n, dtype=_I32, device=dev), best[lane])
        j = torch.arange(width, device=dev)
        got = (words[:, j // WORD_SIZE] >> (j % WORD_SIZE)) & 1  # (n, width)
        on = cols < n_cols
        bits.index_put_((lane[:, None].expand(-1, width)[on], cols[on]),
                        got[on], accumulate=True)
    return _pack_bits(bits > 0)


def split_hits_plain(peq, targets, lo, hi, prow, trow, best, hin0: int,
                     core=None):
    """hits_lanes' split-lane schedule in plain PyTorch (_split_hits_emulate
    over hits_lanes_plain).  Where the plan is one core a lane (hin0 = 1,
    past 8 words, a row no longer than a core) the kernel keeps one thread
    a lane: the plain version itself.  Operands and output as
    hits_lanes."""
    n_cols, nw = targets.shape[1], peq.shape[2]
    c = hits_core(lo.shape[0], n_cols, nw, hin0, core)
    if c >= n_cols:
        return hits_lanes_plain(peq, targets, lo, hi, prow, trow, best, hin0)
    return _split_hits_emulate(
        lambda *ops: hits_lanes_plain(peq, *ops, hin0), nw, targets, lo, hi,
        prow, trow, best, hin0, c)


def split_hits_bitplane_plain(planes, pad, targets, lo, hi, prow, trow,
                              best, hin0: int, nb: int, n_alts: int,
                              wildcard: int, core=None):
    """hits_bitplane's split-lane schedule in plain PyTorch
    (_split_hits_emulate over hits_bitplane_plain): at 1-8 words every
    lane on the word-aligned plan, one core a lane included (swept from a
    halo before it, or from column 0 at hin0 = 1); past 8 words the plain
    version itself (one thread a lane).  Operands and output as
    hits_bitplane."""
    nw = pad.shape[1]
    if nw > _SPLIT_MAX_WORDS:
        return hits_bitplane_plain(planes, pad, targets, lo, hi, prow, trow,
                                   best, hin0, nb, n_alts, wildcard)
    return _split_hits_emulate(
        lambda *ops: hits_bitplane_plain(planes, pad, *ops, hin0, nb, n_alts,
                                         wildcard),
        nw, targets, lo, hi, prow, trow, best, hin0,
        hits_core(lo.shape[0], targets.shape[1], nw, hin0, core))


def _shared_span(n_cols: int, col_lo: int, col_hi: int) -> int:
    """Columns a sweep_shared lane scans (split_cores for one lane)."""
    end = max(0, min(n_cols, col_hi))
    return max(0, end - max(0, min(col_lo, end - 1)))


def split_shared_plain(peq_t, target, hin0: int, col_lo: int, col_hi: int,
                       core=None):
    """sweep_shared's split-lane schedule in plain PyTorch (operands and
    outputs as sweep_shared)."""
    nw, B = peq_t.shape[1], peq_t.shape[2]
    dev = peq_t.device
    c = split_core(B, _shared_span(target.shape[0], col_lo, col_hi), nw,
                   hin0, core)
    lanes = torch.arange(B, dtype=_I32, device=dev)
    peq = peq_t.permute(2, 0, 1).contiguous()
    best, pfirst, _, _ = _split_emulate(
        lambda *ops: reduce_lanes_plain(peq, *ops, hin0), nw,
        target[None],
        torch.full((B,), col_lo, dtype=_I32, device=dev),
        torch.full((B,), col_hi, dtype=_I32, device=dev), lanes,
        torch.zeros(B, dtype=_I32, device=dev), hin0, c)
    return best, pfirst


def resume_cores(n_lanes: int, n_cols: int, n_words: int, hin0: int,
                 core=None):
    """(core, cores a lane) of reduce_resume's split-lane plan: every lane's
    n_cols columns cut into cores of split_core columns from column 0 (the
    exit state needs the last one, the carry the first)."""
    c = split_core(n_lanes, n_cols, n_words, hin0, core)
    return c, -(-n_cols // c) if n_cols else 0


def split_resume_plain(peq, targets, lo, hi, prow, trow, pv0, mv0, s0,
                       hin0: int, core=None):
    """reduce_resume's split-lane schedule in plain PyTorch: every (lane,
    core) swept from the carried state where its sweep starts at column 0
    (c_lo - split_halo <= 0, or hin0 = 1: one core a lane, at 2-8 words the
    word-parallel lane, word_lanes_plain), else from the
    fresh state a halo before its core; each reduces [lo, hi) over its core
    and merges by packed keys, the core holding hi - 1 gives last and the
    one holding T - 1 the exit state.  Operands and outputs as
    reduce_resume, equal to reduce_resume_plain where the carry is an HW
    sweep's state (hin0 = 0) or any carry (hin0 = 1).  The halo argument
    of the split-lane schedule holds across the carry: every cell of row i
    is <= i + 1 from the top row, and a path from the carried column
    costs its row's carried value (>= 0) plus at least the columns it
    crosses less its rows, more than that from 2 (i + 1) columns on."""
    n, T, nw = lo.shape[0], targets.shape[1], peq.shape[2]
    dev = lo.device
    c, K = resume_cores(n, T, nw, hin0, core)
    if K == 1 and 2 <= nw <= _SPLIT_MAX_WORDS:
        return reduce_resume_words_plain(peq, targets, lo, hi, prow, trow,
                                         pv0, mv0, s0, hin0)
    if K == 1:      # one core a lane: the plain sweep from the carry
        return reduce_resume_plain(peq, targets, lo, hi, prow, trow, pv0,
                                   mv0, s0, hin0)
    keys = _new_keys(n, 2, dev)
    last = torch.full((n,), _BIG, dtype=_I32, device=dev)
    pv1, mv1, s1 = pv0.clone(), mv0.clone(), s0.clone()
    if not (n and K):
        return _unpack_keys(keys) + (last, pv1, mv1, s1)
    # Several cores a lane: HW at 1-8 words (resume_cores).
    lane = torch.arange(n, device=dev).repeat_interleave(K)
    c_lo = torch.arange(K, device=dev).repeat(n) * c
    c_hi = torch.clamp(c_lo + c, max=T)
    start = (c_lo - split_halo(nw)).clamp(min=0)
    carried = start == 0
    m = lane.shape[0]
    pv = torch.where(carried[:, None], pv0[lane], -1)
    mv = torch.where(carried[:, None], mv0[lane], 0)
    score = torch.where(carried, s0[lane], nw * WORD_SIZE)
    prof = peq[prow.long()[lane]]
    tg = targets[trow.long()[lane]]
    rows = torch.arange(m, device=dev)
    lo_v = torch.maximum(lo.long()[lane], c_lo)
    hi_v = hi.long()[lane]
    best = torch.full((m,), _BIG, dtype=_I32, device=dev)
    pf = torch.full((m,), -1, dtype=torch.int64, device=dev)
    pl = pf.clone()
    lst = best.clone()
    zero = torch.zeros(m, dtype=_I32, device=dev)
    hpos0 = torch.full((m,), hin0, dtype=_I32, device=dev)
    for i in range(int((c_hi - start).max())):
        col = start + i
        on = col < c_hi
        words = prof[rows, tg[rows, col.clamp(max=T - 1)].long()]
        hneg, hpos = zero, hpos0
        pv2, mv2 = pv.clone(), mv.clone()
        for w in range(nw):
            pv2[:, w], mv2[:, w], hneg, hpos = _advance_word(
                pv[:, w], mv[:, w], words[:, w], hneg, hpos)
        pv = torch.where(on[:, None], pv2, pv)
        mv = torch.where(on[:, None], mv2, mv)
        score = torch.where(on, score + hpos - hneg, score)
        win = on & (col >= lo_v) & (col < hi_v)
        pl = torch.where(win & (score <= best), col, pl)
        upd = win & (score < best)
        pf = torch.where(upd, col, pf)
        best = torch.where(upd, score, best)
        lst = torch.where(on & (col == hi_v - 1), score, lst)
    seen = pf >= 0
    b = best.long()[seen]
    keys[0].scatter_reduce_(0, lane[seen], (b << 32) | pf[seen], "amin")
    keys[1].scatter_reduce_(0, lane[seen], ((_BIG - b) << 32) | pl[seen],
                            "amax")
    holds = (hi_v - 1 >= c_lo) & (hi_v - 1 < c_hi)
    last[lane[holds]] = lst[holds]
    ends = c_hi == T
    pv1[lane[ends]] = pv[ends]
    mv1[lane[ends]] = mv[ends]
    s1[lane[ends]] = score[ends]
    return _unpack_keys(keys) + (last, pv1, mv1, s1)


# ---------------------------------------------------------------------------
# The wavefront of one pair.  State int32 (7, NS), one column per word slot
# in logical order (slot s holds word base + s): [Pv, Mv, hneg, hpos, score,
# runmin, runpos], the JAX kernels' state planes without the symbol plane
# and the banded kernel's Peq window (the port reads target and profile
# directly).  At step d word w advances scan column d - w with the hout word
# w-1 produced at step d-1 (the window's top word takes (0, hin0)).
# ---------------------------------------------------------------------------

WF_PLANES = 7


def wavefront_base(d: int, lo: int, base_cap: int) -> int:
    """The banded window's top word at step d (wavefront.py:454-456)."""
    return min(max((d + lo - 31) // 33, 0), base_cap)


def _wavefront_steps(t, peq, state, d_base: int, n_steps: int, n_words: int,
                     t_scan: int, hin0: int, col_lo: int, col_hi: int,
                     base_of, stream):
    """The step body of wavefront._wf_kernel / _wfb_kernel in torch, one
    loop iteration per step over all slots; base_of(d) gives the window's
    top word (a step where it advances slides the window first)."""
    ns = state.shape[1]
    dev = state.device
    pw = peq.shape[1]
    flat = peq.reshape(-1)
    pv, mv, hn, hp, sc, rmin, rpos = state.clone().unbind(0)
    slot = torch.arange(ns, dtype=torch.int64, device=dev)
    zero = torch.zeros(1, dtype=_I32, device=dev)
    top = torch.full((1,), hin0, dtype=_I32, device=dev)
    ones, big = top.new_full((1,), -1), top.new_full((1,), _BIG)
    track = col_hi > col_lo
    bottom = n_words - 1
    base = base_of(d_base - 1)
    for i in range(n_steps):
        d = d_base + i
        nb = base_of(d)
        if nb != base:
            # Slide: the top word leaves, the entering bottom word is the
            # cell above + 1 per row, from the old bottom's step d-1 state.
            enter = sc[-1:] - (hp[-1:] - hn[-1:]) + 32
            pv, mv, hn, hp, sc, rmin, rpos = (
                torch.cat([x[1:], f]) for x, f in (
                    (pv, ones), (mv, zero), (hn, zero), (hp, zero),
                    (sc, enter), (rmin, big), (rpos, ones)))
        base = nb
        in_n = torch.cat([zero, hn[:-1]])
        in_p = torch.cat([top, hp[:-1]])
        word = base + slot
        col = d - word
        active = (col >= 0) & (col < t_scan) & (word < n_words)
        sym = t[col.clamp(0, t_scan - 1)].long()
        eq = flat[sym * pw + word.clamp(0, pw - 1)]
        pv2, mv2, on, op = _advance_word(pv, mv, eq, in_n, in_p)
        pv = torch.where(active, pv2, pv)
        mv = torch.where(active, mv2, mv)
        sc = sc + torch.where(active, op - on, 0)
        hn = torch.where(active, on, 0)
        hp = torch.where(active, op, 0)
        if track:
            upd = (active & (word == bottom) & (col >= col_lo)
                   & (col < col_hi) & (sc < rmin))
            rmin = torch.where(upd, sc, rmin)
            rpos = torch.where(upd, col.to(_I32), rpos)
        if stream is not None and 0 <= bottom - base < ns:
            stream[i] = sc[bottom - base]
    return torch.stack([pv, mv, hn, hp, sc, rmin, rpos])


def _wavefront_stream(n_steps: int, emit: bool, dev):
    return (torch.full((n_steps,), _BIG, dtype=_I32, device=dev)
            if emit else None)


def wavefront_plain(t, peq, state, d_base: int, n_steps: int, n_words: int,
                    t_scan: int, hin0: int, col_lo: int, col_hi: int,
                    word0: int, emit_stream: bool):
    """Plain version of wavefront (same operands and outputs)."""
    stream = _wavefront_stream(n_steps, emit_stream, state.device)
    out = _wavefront_steps(t, peq, state, d_base, n_steps, n_words, t_scan,
                           hin0, col_lo, col_hi, lambda d: word0, stream)
    return out, stream


def wavefront_banded_plain(t, peq, state, d_base: int, n_steps: int,
                           n_words: int, t_scan: int, lo: int, col_lo: int,
                           col_hi: int):
    """Plain version of wavefront_banded (same operands and output)."""
    base_cap = max(0, n_words - state.shape[1])
    return _wavefront_steps(t, peq, state, d_base, n_steps, n_words, t_scan,
                            1, col_lo, col_hi,
                            lambda d: wavefront_base(d, lo, base_cap), None)


# The banded wavefront's tile schedule (csrc/wavefront.cu
# wavefront_tiles_kernel; WF_TILE columns a tile).  Cell (w, c) needs only
# (w, c-1) and (w-1, c), and the band's rules depend on the anti-diagonal
# c + w alone, so word w may sweep its columns in tiles of 32, tile j at
# super-step j + w, taking word w-1's horizontal deltas of tile j as two
# 32-bit masks and its score after the tile.  Word w's columns in a segment
# are one interval [c_lo, c_hi) (its steps in [d_base, d_end) inside the
# window); it takes the top boundary (0, +1) from column c_top on; a word
# that enters the window during the segment starts at its first column from
# Pv = ~0 with the score of word w-1 before that column + 32.  The word
# intervals and boundaries come from _first_step (no division).
WF_TILE = 32
_WF_FAR = 1 << 40
_WF_TILES_MAX_SLOTS = 4096  # past this the banded entry keeps a step a barrier
# A segment costs the tiles about n_steps / 16 + ns super-steps, the
# pipeline's fill and drain a fixed part; on the H100 the tiles overtake a
# step a barrier between 4,096 and 8,192 steps at 1,024-4,096 slots
# (chip_smoke's banded form crossover).
_WF_TILES_MIN_STEPS = 6144


def wavefront_banded_form(ns: int, n_steps: int) -> str:
    """The launch form of a wavefront_banded segment of n_steps steps over
    ns slots: "tiles" (one block, one barrier a super-step of 32 columns)
    from _WF_TILES_MIN_STEPS steps up to 4,096 slots; else "steps" (one
    barrier an anti-diagonal step: the block forms, or past 4,096 slots
    the cooperative grid)."""
    return ("tiles" if ns <= _WF_TILES_MAX_SLOTS
            and n_steps >= _WF_TILES_MIN_STEPS else "steps")


def _first_step(x, lo: int, base_cap: int):
    """The first step d with wavefront_base(d) >= x (-far / +far where it
    holds for every step / none)."""
    return torch.where(x <= 0, -_WF_FAR,
                       torch.where(x > base_cap, _WF_FAR, 33 * x + 31 - lo))


def _popc(x):
    return sum((x >> b) & 1 for b in range(WF_TILE))


def wavefront_banded_tiles_plain(t, peq, state, d_base: int, n_steps: int,
                                 n_words: int, t_scan: int, lo: int,
                                 col_lo: int, col_hi: int):
    """The tile schedule of wavefront_banded in plain PyTorch, thread by
    thread as the kernel runs it (slots vectorised): operands and output as
    wavefront_banded, and equal to wavefront_banded_plain."""
    ns = state.shape[1]
    dev = state.device
    if n_steps == 0:
        return state.clone()
    cap = max(0, n_words - ns)
    d_end = d_base + n_steps
    b0 = wavefront_base(d_base - 1, lo, cap)
    b_end = wavefront_base(d_end - 1, lo, cap)
    i64 = torch.int64
    p = torch.arange(ns, dtype=i64, device=dev)
    w = b0 + (p - b0) % ns               # slot p's word at step d_base - 1
    pv, mv, hn0, hp0, sc, rmin, rpos = state[:, w - b0].unbind(0)
    pw = peq.shape[1]
    flat = peq.reshape(-1)
    bottom = n_words - 1
    lane = torch.arange(WF_TILE, dtype=i64, device=dev)
    first = lambda x: _first_step(x, lo, cap)

    def span(w):
        c_lo = torch.clamp(first(w - ns + 1), min=d_base) - w
        c_hi = torch.clamp(first(w + 1), max=d_end) - w
        return c_lo, c_hi, (c_lo >> 5) + w, ((c_hi - 1) >> 5) + w

    # Records [parity][slot]: hp mask, hn mask, score after the tile.  The
    # initial words' records of the column before the segment come first.
    rec = torch.zeros((3, 2, ns), dtype=i64, device=dev)
    cp = d_base - 1 - w
    par = ((cp >> 5) + w) & 1
    rec[0, par, p] = hp0.long() << (cp & 31)
    rec[1, par, p] = hn0.long() << (cp & 31)
    rec[2, par, p] = sc.long()
    words = torch.arange(b0, b_end + ns, dtype=i64, device=dev)
    c_lo, c_hi, s_a, s_b = span(words)
    some = c_lo < c_hi
    for s in range(int(s_a[some].min()), int(s_b[some].max()) + 1):
        while True:   # a slot takes its next word when its word is done
            c_lo, c_hi, s_a, s_b = span(w)
            nxt = ((c_lo >= c_hi) | (s > s_b)) & (w + 1 <= b_end)
            if not bool(nxt.any()):
                break
            w = torch.where(nxt, w + ns, w)
            pv = torch.where(nxt, -1, pv)
            mv = torch.where(nxt, 0, mv)
            rmin = torch.where(nxt, _BIG, rmin)
            rpos = torch.where(nxt, -1, rpos)
        live = (c_lo < c_hi) & (s_a <= s) & (s <= s_b)
        c0 = (s - w) * WF_TILE
        cols = c0[:, None] + lane
        act = ((cols >= c_lo[:, None]) & (cols < c_hi[:, None]) & (cols >= 0)
               & (cols < t_scan) & (w < n_words)[:, None] & live[:, None])
        c_top = torch.where(w <= cap, first(w) - w, _WF_FAR)
        top = (cols >= c_top[:, None]).long()
        prev = (p - 1) % ns
        r_hp, r_hn, r_sc = rec[:, (s - 1) & 1, prev]
        # A word that entered the window in this segment: its first column.
        enter = live & (w >= b0 + ns) & (c_lo >> 5 == s - w)
        k = (c_lo - c0).clamp(0, WF_TILE - 1)
        sc = torch.where(enter, (r_sc - _popc(r_hp >> k) + _popc(r_hn >> k)
                                 + 32).to(_I32), sc)
        in_p = (((r_hp[:, None] >> lane) & 1) | top).to(_I32)
        in_n = (((r_hn[:, None] >> lane) & 1) & (1 - top)).to(_I32)
        eqs = flat[t[cols.clamp(0, t_scan - 1)].long() * pw
                   + w.clamp(0, pw - 1)[:, None]]          # the tile's Eq
        trk = (live & (w == bottom)).any() and col_hi > col_lo
        o_p, o_n = [], []
        for i in range(WF_TILE):
            a = act[:, i]
            pv2, mv2, on, op = _advance_word(pv, mv, eqs[:, i], in_n[:, i],
                                             in_p[:, i])
            pv = torch.where(a, pv2, pv)
            mv = torch.where(a, mv2, mv)
            o_p.append(op & a)
            o_n.append(on & a)
            sc = sc + o_p[-1] - o_n[-1]
            if trk:
                col = cols[:, i]
                upd = (a & (w == bottom) & (col >= col_lo) & (col < col_hi)
                       & (sc < rmin))
                rmin = torch.where(upd, sc, rmin)
                rpos = torch.where(upd, col.to(_I32), rpos)
        o_hp = (torch.stack(o_p, 1).long() << lane).sum(1)
        o_hn = (torch.stack(o_n, 1).long() << lane).sum(1)
        # An initial word's first tile keeps the record of the column
        # before the segment.
        pre = live & (w < b0 + ns) & ((d_base - 1 - w) >> 5 == s - w)
        cur = rec[:, s & 1, p]
        o_hp = torch.where(pre, o_hp | cur[0], o_hp)
        o_hn = torch.where(pre, o_hn | cur[1], o_hn)
        rec[:, s & 1, p] = torch.where(live, torch.stack(
            [o_hp, o_hn, sc.long()]), cur)
    # Each slot holds a word of the last step's window; its hout is the
    # bit of its last column (d_end - 1 - w) in its last tile's record.
    cl = d_end - 1 - w
    last = rec[:, ((cl >> 5) + w) & 1, p]
    hp = ((last[0] >> (cl & 31)) & 1).to(_I32)
    hn = ((last[1] >> (cl & 31)) & 1).to(_I32)
    out = torch.empty_like(state)
    out[:, w - b_end] = torch.stack([pv, mv, hn, hp, sc, rmin, rpos])
    return out


# The fixed-window wavefront's group schedule (csrc/wavefront.cu
# wavefront_groups_kernel).  A warp holds WF_GROUP consecutive words, one a
# lane, lane i one column behind lane i-1 (its input by a vote), and
# runs the segment in tiles of WF_TILE steps.  The bottom lane of group g
# publishes each tile's hout bits as one record (hp, hn masks, bit k = step
# d0 + k) into a ring of `ring` tiles; group g+1's top lane reads it before
# its own tile, one tile behind.  A record carries its tile's tag, so the
# reader needs no separate flag; the reader publishes the tiles it has
# consumed every max(1, ring // 4) tiles and the writer waits while the
# ring is full.  Windows wider than one launch holds run as passes of
# consecutive groups, the bottom group of a pass writing every record of
# the segment for the next pass's top group.  In HW (hin0 = 0) from step 0
# with word0 = 0 the scan's columns are cut into cores (wavefront_core):
# core k owns columns [k * core, (k + 1) * core) (the first from -inf, the
# last to +inf) and sweeps from the fresh state split_halo(n_words)
# columns before them, the first from the loaded state.  Every cell of row i
# is <= i + 1 in HW, so an optimal path to a cell of that row spans at most
# 2 (i + 1) columns: every word's state, not only the bottom row's, is exact
# from the core's first owned column on.  A core writes the exit state of
# the words whose last column it owns, the stream of the steps whose bottom
# column it owns, and merges the bottom word's (min, first argmin) over its
# owned columns as a packed key.
WF_GROUP = 32
_WF_RING = 64            # tiles a link's ring holds
_WF_FILL_WARPS = 132 * 8  # HW cores: enough groups for 8 warps an SM
_WF_BLOCK_WARPS = 8      # groups a block of the group kernel, at most


def wavefront_core(ns: int, n_words: int, t_scan: int, d_base: int,
                   hin0: int, word0: int, core=None) -> int:
    """Columns each core of a wavefront call owns (t_scan or more: one
    core).  Only HW (hin0 = 0) calls from step 0 with word0 = 0 are cut:
    into cores of at least split_halo(n_words) columns, enough of them for
    _WF_FILL_WARPS warps.  `core` forces the length (checks only)."""
    if hin0 or word0 or d_base:
        return t_scan
    if core is not None:
        return max(1, int(core))
    groups = -(-min(ns, n_words) // WF_GROUP)
    return max(split_halo(n_words),
               -(-t_scan // max(1, _WF_FILL_WARPS // groups)))


def wavefront_form(ns: int, n_words: int, t_scan: int, d_base: int,
                   hin0: int, word0: int, core=None) -> dict:
    """The launch plan of a wavefront call: its cores and their length,
    and its warp groups (the words of the window below n_words)."""
    real = min(ns, n_words - word0)
    c = wavefront_core(ns, n_words, t_scan, d_base, hin0, word0, core)
    return dict(cores=-(-t_scan // c), core=c,
                groups=max(0, -(-real // WF_GROUP)))


def _wf_core_span(k: int, K: int, clen: int, halo: int, t_scan: int,
                  d_base: int, d_end: int, word0: int, w_last: int):
    """Core k's swept columns [cs, ce) and steps [d_lo, d_hi)."""
    cs = 0 if k == 0 else max(0, k * clen - halo)
    ce = t_scan if k == K - 1 else min(t_scan, (k + 1) * clen)
    d_lo = d_base if k == 0 else max(d_base, cs + word0)
    d_hi = d_end if k == K - 1 else min(d_end, ce + w_last)
    return cs, ce, d_lo, d_hi


def _bits(mask: int, dev) -> torch.Tensor:
    return torch.tensor([(mask >> k) & 1 for k in range(WF_TILE)],
                        dtype=_I32, device=dev)


def wavefront_groups_plain(t, peq, state, d_base: int, n_steps: int,
                           n_words: int, t_scan: int, hin0: int, col_lo: int,
                           col_hi: int, word0: int, emit_stream: bool, *,
                           core=None, ring=None, pass_groups=None,
                           block_groups=None, blocks=None):
    """The group schedule of wavefront in plain PyTorch, group by group and
    tile by tile as the kernel runs it (lanes vectorised): operands and
    outputs as wavefront, equal to wavefront_plain.  core, ring and
    pass_groups force the core length, the ring depth and the groups a
    launch holds; block_groups and blocks the groups a block takes (a task)
    and the blocks resident at once, tasks taken in increasing order.  The
    running groups take turns, each running tiles until it waits on a
    record or on ring space; a turn in which none advances raises."""
    ns = state.shape[1]
    dev = state.device
    out = state.clone()
    stream = _wavefront_stream(n_steps, emit_stream, dev)
    if n_steps == 0:
        return out, stream
    real = min(ns, n_words - word0)
    out[2:4, max(real, 0):] = 0
    if real <= 0:
        return out, stream
    G = -(-real // WF_GROUP)
    clen = wavefront_core(ns, n_words, t_scan, d_base, hin0, word0, core)
    P = pass_groups or G
    if P < G:
        clen = t_scan                  # passes run one core
    K = -(-t_scan // clen)
    ring = ring or _WF_RING
    wpb = block_groups or _WF_BLOCK_WARPS
    bottom = n_words - 1 - word0
    track = col_hi > col_lo and 0 <= bottom < ns
    key = [(int(state[5, bottom]), int(state[6, bottom]) & 0xFFFFFFFF)]
    halo = split_halo(n_words)
    w_last = word0 + real - 1
    d_end = d_base + n_steps
    pw = peq.shape[1]
    flat = peq.reshape(-1)
    lane = torch.arange(WF_GROUP, dtype=torch.int64, device=dev)

    def owner(c):
        return 0 if K == 1 else min(max(c, 0), t_scan - 1) // clen

    def group(k, g, gl, n_pass, link_in, link_out, top_in, bottom_out):
        cs, ce, d_lo, d_hi = _wf_core_span(k, K, clen, halo, t_scan, d_base,
                                           d_end, word0, w_last)
        s = WF_GROUP * g + lane
        w = word0 + s
        live = (s < ns) & (w < n_words)
        sl = s.clamp(max=ns - 1)
        if k == 0:
            pv, mv, sc = state[0, sl], state[1, sl], state[4, sl]
            hn, hp = state[2, sl] & 1, state[3, sl] & 1
            carry = ((int(state[2, s[0] - 1]) & 1, int(state[3, s[0] - 1]) & 1)
                     if g else (0, hin0))
        else:
            pv = torch.full((WF_GROUP,), -1, dtype=_I32, device=dev)
            mv = torch.zeros(WF_GROUP, dtype=_I32, device=dev)
            sc = ((s + 1) * WORD_SIZE).to(_I32)
            hn = hp = torch.zeros(WF_GROUP, dtype=_I32, device=dev)
            carry = (0, hin0 if g == 0 else 0)
        bl = bottom - WF_GROUP * g
        has_bottom = 0 <= bl < WF_GROUP
        every = max(1, ring // 4)
        n_tiles = -(-(d_hi - d_lo) // WF_TILE) if d_hi > d_lo else 0
        for j in range(n_tiles):
            d0 = d_lo + WF_TILE * j
            nk = min(WF_TILE, d_hi - d0)
            if g == 0:
                tin_p, tin_n = (hin0 << WF_TILE) - hin0, 0
            else:
                if top_in is not None:
                    rec = top_in[j]
                else:
                    while link_in["rec"][j % ring][0] != j + 1:
                        yield False
                    rec = link_in["rec"][j % ring]
                    if (j + 1) % every == 0:
                        link_in["cons"] = j + 1
                tin_n = ((rec[2] << 1) | carry[0]) & 0xFFFFFFFF
                tin_p = ((rec[1] << 1) | carry[1]) & 0xFFFFFFFF
                carry = (rec[2] >> 31, rec[1] >> 31)
            bits_n, bits_p = _bits(tin_n, dev), _bits(tin_p, dev)
            o_p = o_n = 0
            for i in range(nk):
                d = d0 + i
                x_n = torch.cat([bits_n[i:i + 1], hn[:-1]])
                x_p = torch.cat([bits_p[i:i + 1], hp[:-1]])
                c = d - w
                act = live & (c >= cs) & (c < ce)
                eq = flat[t[c.clamp(0, t_scan - 1)].long() * pw
                          + w.clamp(0, pw - 1)]
                pv2, mv2, on, op = _advance_word(pv, mv, eq, x_n, x_p)
                pv = torch.where(act, pv2, pv)
                mv = torch.where(act, mv2, mv)
                sc = sc + torch.where(act, op - on, 0)
                hn = torch.where(act, on, 0)
                hp = torch.where(act, op, 0)
                o_p |= int(hp[-1]) << i
                o_n |= int(hn[-1]) << i
                if has_bottom:
                    cb = d - (n_words - 1)
                    if owner(cb) == k:
                        if stream is not None:
                            stream[d - d_base] = sc[bl]
                        # The kernel's packed key: (score, column) least.
                        if (track and bool(act[bl]) and col_lo <= cb < col_hi
                                and (int(sc[bl]), cb) < key[0]):
                            key[0] = (int(sc[bl]), cb)
            if bottom_out is not None and gl == n_pass - 1:
                bottom_out.append((j + 1, o_p, o_n))
            elif link_out is not None:
                while j - link_out["cons"] >= ring:
                    yield False
                link_out["rec"][j % ring] = (j + 1, o_p, o_n)
            yield True
        # The exit state of the words whose last column this core owns.
        for i in range(WF_GROUP):
            if bool(live[i]) and owner(d_end - 1 - int(w[i])) == k:
                out[[0, 1, 2, 3, 4], int(s[i])] = torch.stack(
                    [pv[i], mv[i], hn[i], hp[i], sc[i]])

    # Tasks (core, a block's groups) in increasing order, at most `blocks`
    # running; passes one after another, each a launch of its own.
    top_in = None
    for p0 in range(0, G, P):
        n_pass = min(P, G - p0)
        bottom_out = [] if p0 + n_pass < G else None
        links = {}
        tasks = [(k, b) for k in range(K)
                 for b in range(-(-n_pass // wpb))]
        running = []
        while tasks or running:
            while tasks and (blocks is None or len(running) < blocks):
                k, b = tasks.pop(0)
                gens = []
                for gl in range(b * wpb, min((b + 1) * wpb, n_pass)):
                    li = links.setdefault((k, gl), {"rec": [(0, 0, 0)] * ring,
                                                    "cons": 0})
                    lo_ = links.setdefault((k, gl + 1),
                                           {"rec": [(0, 0, 0)] * ring,
                                            "cons": 0})
                    gens.append(group(k, p0 + gl, gl, n_pass,
                                      li if gl else None,
                                      lo_ if p0 + gl + 1 < G else None,
                                      top_in if gl == 0 and p0 else None,
                                      bottom_out))
                running.append(gens)
            moved = False
            for gens in running:
                for gen in list(gens):
                    try:
                        while next(gen):
                            moved = True
                    except StopIteration:
                        gens.remove(gen)
                        moved = True
            running = [gens for gens in running if gens]
            if not moved:
                raise RuntimeError("wavefront_groups_plain: no group can "
                                   "advance (the schedule deadlocks)")
        top_in = bottom_out
    if track:
        rmin, rpos = key[0]
        out[5, bottom] = rmin
        out[6, bottom] = rpos - (1 << 32) if rpos >= 1 << 31 else rpos
    return out, stream


# ---------------------------------------------------------------------------
# The lanes that cannot be cut into column cores (csrc/myers.cu says how
# each runs and which form a call takes): the resumable reduce where its
# plan is one core a lane and the score stream, at 2-8 words as the
# word-parallel lane, and the score stream's long lanes as warp groups.
# Plain emulations of both schedules, which the tests hold against the
# plain versions and the JAX package.
# ---------------------------------------------------------------------------

WORD_TILE = 16                 # csrc/myers.cu kWordTile: columns a step


def word_threads(n_words: int) -> int:
    """Threads of a word-parallel lane's segment: 2, 4 or 8, one a word
    (csrc/myers.cu word_width)."""
    return 2 if n_words <= 2 else 4 if n_words <= 4 else 8


def _word_tiles(eq_at, B: int, T: int, nw: int, dev, hin0: int, pv0=None,
                mv0=None, s0=None, exit_state=None):
    """The word-parallel lane's schedule, step by step as the kernel runs it
    (lanes and segment threads vectorised): thread w of a lane's
    word_threads(NW) advances the WORD_TILE columns [WORD_TILE (s - w),
    + WORD_TILE) at step s, each column taking its carry bit from the two
    masks (hneg << WORD_TILE | hpos) that thread w - 1 sent for the same
    tile a step before (the top thread (0, hin0)).  eq_at(c, wr) gives the
    Eq words int32 (B, P) of columns c (P,), clamped into the row, for the
    threads' words wr (P,).  From the carry (pv0 (B, NW), mv0, s0 (B,); None:
    a fresh start).  Yields after each step (cb, scores): the bottom word's
    tile [cb, cb + WORD_TILE) and the score after each of its columns,
    int32 (B, WORD_TILE) (meaningful for the columns in [0, T)); exit_state
    receives [pv, mv, score] after the last step."""
    P = word_threads(nw)
    w = torch.arange(P, device=dev)
    wr = w.clamp(max=nw - 1)
    if pv0 is None:
        pv = torch.full((B, P), -1, dtype=_I32, device=dev)
        mv = torch.zeros((B, P), dtype=_I32, device=dev)
        score = torch.full((B,), nw * WORD_SIZE, dtype=_I32, device=dev)
    else:
        pv, mv, score = pv0[:, wr].clone(), mv0[:, wr].clone(), s0.clone()
    K, bottom = WORD_TILE, nw - 1
    mask = (1 << K) - 1
    out = torch.zeros((B, P), dtype=_I32, device=dev)
    for s in range(-(-T // K) + nw - 1 if T else 0):
        x = torch.cat([out[:, :1], out[:, :-1]], 1)        # __shfl_up_sync
        hp_in, hn_in = x & mask, (x >> K) & mask
        hp_in[:, 0] = mask if hin0 else 0
        hn_in[:, 0] = 0
        o_p = torch.zeros((B, P), dtype=_I32, device=dev)
        o_n = torch.zeros_like(o_p)
        tile = torch.zeros((B, K), dtype=_I32, device=dev)
        for k in range(K):
            c = K * (s - w) + k                            # (P,) a thread
            act = (c >= 0) & (c < T)
            e = eq_at(c.clamp(0, T - 1), wr)
            pv2, mv2, hn2, hp2 = _advance_word(pv, mv, e, (hn_in >> k) & 1,
                                               (hp_in >> k) & 1)
            pv = torch.where(act, pv2, pv)
            mv = torch.where(act, mv2, mv)
            hn2 = torch.where(act, hn2, 0)
            hp2 = torch.where(act, hp2, 0)
            o_p |= hp2 << k
            o_n |= hn2 << k
            if 0 <= int(c[bottom]) < T:
                score = score + hp2[:, bottom] - hn2[:, bottom]
                tile[:, k] = score
        out = (o_n << K) | o_p
        yield K * (s - bottom), tile
    if exit_state is not None:
        exit_state.extend([pv[:, :nw], mv[:, :nw], score])


def word_lanes_plain(peq, targets, prow, trow, hin0: int, pv0=None,
                     mv0=None, s0=None):
    """The word-parallel lane's schedule in plain PyTorch (_word_tiles, Eq
    from each lane's profile row and target row).  Operands as
    sweep_scores_resume (pv0 None: a fresh start); returns (scores int32
    (B, T), pv, mv, score): every column's bottom-row score and the state
    after the last column."""
    B, T, nw = prow.shape[0], targets.shape[1], peq.shape[2]
    dev = prow.device
    scores = torch.empty((T, B), dtype=_I32, device=dev)
    prof = peq[prow.long()]                                # (B, S1, NW)
    tg = targets[trow.long()]                              # (B, T)
    lanes = torch.arange(B, device=dev)[:, None]
    state = []
    for cb, tile in _word_tiles(
            lambda c, wr: prof[lanes, tg[:, c].long(), wr[None, :]], B, T,
            nw, dev, hin0, pv0, mv0, s0, state):
        n = min(WORD_TILE, T - cb)
        if cb >= 0 and n > 0:
            scores[cb:cb + n] = tile[:, :n].t()
    return (scores.t(),) + tuple(state)


def _stream_word_tiles(eq_t, hin0: int):
    """_word_tiles with Eq from a gathered stream int32 (T, NW, B): every
    lane over all T columns from the fresh state, as the eq-stream kernels'
    word-parallel lane runs it."""
    T, nw, B = eq_t.shape
    return _word_tiles(lambda c, wr: eq_t[c, wr].t(), B, T, nw, eq_t.device,
                       hin0)


def hits_words_plain(eq_t, lo, hi, best, hin0: int):
    """hits_eqstream on the word-parallel lane's schedule in plain PyTorch
    (_stream_word_tiles) with the kernel's hit visitor: thread w of a lane's
    segment marks the columns cb + k, k = w (mod width), of each bottom tile
    that lie in [lo, min(hi, T)) and equal best; after a tile that ends a
    hit word or the row the segment's bits are OR-ed and the word stored
    where it is non-zero.  Operands and output as hits_eqstream."""
    T, nw, B = eq_t.shape
    dev = lo.device
    out = _hit_output(B, T, dev)
    if not (B and T):
        return out
    P = word_threads(nw)
    end = hi.clamp(max=T)
    masks = torch.zeros((B, P), dtype=_I32, device=dev)
    for cb, tile in _stream_word_tiles(eq_t, hin0):
        for k in range(WORD_TILE):
            c = cb + k
            if 0 <= c < T:
                hit = (c >= lo) & (c < end) & (tile[:, k] == best)
                masks[:, k % P] |= hit.to(_I32) << (c % WORD_SIZE)
        if cb >= 0 and (cb % WORD_SIZE or cb + WORD_TILE >= T):
            m = masks[:, 0]
            for p in range(1, P):
                m = m | masks[:, p]
            g = cb // WORD_SIZE
            out[:, g] = torch.where(m != 0, m, out[:, g])
            masks.zero_()
    return out


def reduce_eqstream_words_plain(eq_t, lo, hi, hin0: int):
    """reduce_eqstream on the word-parallel lane's schedule in plain PyTorch
    (_stream_word_tiles and the window reduction of its bottom tiles'
    scores: columns c >= hi are swept but not taken, last is the score at
    hi - 1 only).  Operands and outputs as reduce_eqstream."""
    T = eq_t.shape[0]
    cols = ((cb + k, tile[:, k], True)
            for cb, tile in _stream_word_tiles(eq_t, hin0)
            for k in range(WORD_TILE) if 0 <= cb + k < T)
    return _reduction(cols, lo, hi)


def reduce_resume_words_plain(peq, targets, lo, hi, prow, trow, pv0, mv0, s0,
                              hin0: int):
    """reduce_resume on the word-parallel lane's schedule (word_lanes_plain
    and the window reduction of its scores); operands and outputs as
    reduce_resume, equal to reduce_resume_plain from any carry."""
    scores, pv, mv, score = word_lanes_plain(peq, targets, prow, trow, hin0,
                                             pv0, mv0, s0)
    cols = ((c, scores[:, c], True) for c in range(targets.shape[1]))
    return _reduction(cols, lo, hi) + (pv, mv, score)


def sweep_scores_groups_plain(peq, targets, prow, trow, hin0: int, pv0=None,
                              mv0=None, s0=None, *, ring=None,
                              pass_groups=None, block_groups=None,
                              blocks=None):
    """The score stream's warp groups in plain PyTorch: each lane is the
    group schedule of one wavefront call (wavefront_groups_plain, tile by
    tile, rings, passes, tasks and blocks as there) over the lane's profile
    row and target row, all its words from step 0 to the last column's
    bottom step, from the lane's carry in the state's Pv and Mv planes and
    its score in the score plane; column c's score is the bottom word's
    after step c + NW - 1.  Operands as sweep_scores_resume (pv0 None: a
    fresh start), ring, pass_groups, block_groups and blocks as
    wavefront_groups_plain; returns (scores (B, T), pv, mv, score), equal
    to sweep_scores_resume_plain."""
    B, T, nw = prow.shape[0], targets.shape[1], peq.shape[2]
    dev = prow.device
    scores = torch.empty((T, B), dtype=_I32, device=dev)
    pv1 = torch.full((B, nw), -1, dtype=_I32, device=dev)
    mv1 = torch.zeros((B, nw), dtype=_I32, device=dev)
    s1 = torch.full((B,), nw * WORD_SIZE, dtype=_I32, device=dev)
    if pv0 is not None:
        pv1, mv1, s1 = pv0.clone(), mv0.clone(), s0.clone()
    if not T:
        return scores.t(), pv1, mv1, s1
    for i in range(B):
        state = torch.zeros((WF_PLANES, nw), dtype=_I32, device=dev)
        state[0], state[1], state[4] = pv1[i], mv1[i], s1[i]
        state[5], state[6] = _BIG, -1
        new, stream = wavefront_groups_plain(
            targets[int(trow[i])], peq[int(prow[i])], state, 0, T + nw - 1,
            nw, T, hin0, 0, 0, 0, True, core=T, ring=ring,
            pass_groups=pass_groups, block_groups=block_groups,
            blocks=blocks)
        scores[:, i] = stream[nw - 1:]
        pv1[i], mv1[i], s1[i] = new[0], new[1], new[4, nw - 1]
    return scores.t(), pv1, mv1, s1


# ---------------------------------------------------------------------------
# The column capture's word groups over lanes and banded NW's word-parallel
# band (csrc/myers.cu says how each runs): the shapes the wrappers plan and
# plain emulations of both schedules, step by step, which the tests hold
# against the plain versions and the JAX package.
# ---------------------------------------------------------------------------

_CAP_MAX_THREADS = 512     # csrc/myers.cu kCapMaxThreads
_CAP_MAX_WORDS = 8         # csrc/myers.cu kCapMaxWords
_CARD_SMS = 132            # an H100 SXM's SMs: capture_plan's default
_BAND_MAX_WIDTH = 16       # csrc/myers.cu kBandMaxWidth


def capture_plan(n_words: int, n_lanes: int, sms: int = _CARD_SMS) -> dict:
    """The capture kernel's launch shape: {"form": "lane_words", "lanes":
    lanes a block, "words": words a group}, or {"form": "thread"} (the
    read-back form, one thread a lane) for a window of more than 512
    words (or 16 columns of 2^32 words or more: offsets inside a tile are
    32-bit).  The most lanes a block (32, 16 or 8) that still gives each
    of the card's sms SMs a block, then the fewest words a group (1, 2, 4
    or 8) that keep a block within 512 threads, fewer lanes where even 8
    do not."""
    lanes = 32
    while lanes > 8 and -(-n_lanes // lanes) < sms:
        lanes //= 2
    words = 1
    while (words < _CAP_MAX_WORDS
           and lanes * -(-n_words // words) > _CAP_MAX_THREADS):
        words *= 2
    while lanes > 8 and lanes * -(-n_words // words) > _CAP_MAX_THREADS:
        lanes //= 2
    if (lanes * -(-n_words // words) > _CAP_MAX_THREADS
            or n_words * n_lanes * WORD_TILE >= 1 << 32):
        return {"form": "thread"}
    return {"form": "lane_words", "lanes": lanes, "words": words}


def band_width(n_win: int, chunk: int) -> int:
    """Threads a lane's segment of nw_banded's word-parallel band: the
    smallest of 2, 4, 8 and 16 that is at least n_win; 0 where the kernel
    keeps one thread a lane (n_win = 1, a chunk that is not a whole number
    of WORD_TILE-column tiles, n_win past 16)."""
    if n_win < 2 or n_win > _BAND_MAX_WIDTH or chunk % WORD_TILE:
        return 0
    return 2 if n_win <= 2 else 4 if n_win <= 4 else 8 if n_win <= 8 else 16


def capture_words_plain(peq, targets, hin0: int, want_h: bool = False, *,
                        words=None):
    """The capture kernel's word groups in plain PyTorch, step by step
    (lanes and groups vectorised): group g of a lane holds the words
    [g K, (g + 1) K) (K = words, or capture_plan's) and advances the
    WORD_TILE columns [WORD_TILE (s - g), + WORD_TILE) at step s, each
    column taking its carry bit from the two masks (hneg << WORD_TILE |
    hpos) group g - 1 sent for the same tile a step before (the top group
    (0, hin0)).  Operands and outputs as capture."""
    B, _, nw = peq.shape
    T = targets.shape[1]
    dev = peq.device
    K = words or capture_plan(nw, B).get("words", _CAP_MAX_WORDS)
    G = -(-nw // K)
    outs = [torch.empty((T, nw, B), dtype=_I32, device=dev)
            for _ in range(4 if want_h else 2)]
    if not (B and T):
        return tuple(o.permute(2, 0, 1) for o in outs)
    g = torch.arange(G, device=dev)
    lanes = torch.arange(B, device=dev)[:, None]
    pv = torch.full((B, G, K), -1, dtype=_I32, device=dev)
    mv = torch.zeros((B, G, K), dtype=_I32, device=dev)
    mask = (1 << WORD_TILE) - 1
    link = torch.zeros((B, G), dtype=_I32, device=dev)
    for s in range(-(-T // WORD_TILE) + G - 1):
        tau = s - g
        y = torch.cat([link[:, :1], link[:, :-1]], 1)       # group g - 1
        hp_in, hn_in = y & mask, (y >> WORD_TILE) & mask
        hp_in[:, 0] = mask if hin0 else 0
        hn_in[:, 0] = 0
        o = torch.zeros((B, G), dtype=_I32, device=dev)
        for k in range(WORD_TILE):
            c = WORD_TILE * tau + k
            act = (tau >= 0) & (c < T)                      # (G,)
            sym = targets[:, c.clamp(0, T - 1)].long()      # (B, G)
            hneg, hpos = (hn_in >> k) & 1, (hp_in >> k) & 1
            for i in range(K):
                w = g * K + i
                upd = act & (w < nw)
                e = peq[lanes, sym, w.clamp(max=nw - 1)[None, :]]
                pv2, mv2, hn2, hp2, ph, mh = _advance_word_h(
                    pv[:, :, i], mv[:, :, i], e, hneg, hpos)
                pv[:, :, i] = torch.where(upd, pv2, pv[:, :, i])
                mv[:, :, i] = torch.where(upd, mv2, mv[:, :, i])
                hneg = torch.where(upd, hn2, hneg)
                hpos = torch.where(upd, hp2, hpos)
                at = upd.nonzero()[:, 0]
                for out, val in zip(outs, (pv2, mv2, ph, mh)):
                    out[c[at], w[at]] = val[:, at].t()
            o |= torch.where(act, (hpos << k) | (hneg << (k + WORD_TILE)), 0)
        link = o
    return tuple(x.permute(2, 0, 1) for x in outs)


def _band_words_columns(name: str, peq, targets, woff, prow, trow,
                        n_win: int, chunk: int):
    """The word-parallel band's schedule in plain PyTorch, step by step
    (lanes and segment threads vectorised): absolute word x runs tile tau
    at step tau + x - woff[0] on thread x mod W (W = band_width), the tiles
    in flight at a step those with start(tau) = tau + off(tau) - woff[0] <=
    step < start(tau) + n_win; a thread's new word starts from the reset
    state; word x takes its carry masks from thread x - 1 mod W a step
    before, or hin = +1 where it is its tile's top word; each tile's bottom
    word carries the score, +32 a word the window slides.  Yields (column,
    score (B,), live) for every column of each tile at its bottom word's
    step, in column order, as the kernels' visitors see them (live where
    the tile's window has reached the bottom word); _reduction and
    _hit_words reduce them as the band kernels' visitors do."""
    W = band_width(n_win, chunk)
    if not W:
        raise ValueError(f"{name}: no band form at n_win={n_win}, "
                         f"chunk={chunk}")
    B, T, nw = prow.shape[0], targets.shape[1], peq.shape[2]
    if not (B and T):
        return
    dev = prow.device
    woff = [int(v) for v in woff]
    tpc = chunk // WORD_TILE
    off0 = woff[0]
    n_tiles = -(-T // WORD_TILE)

    def off(tau):
        return woff[tau // tpc]

    def start(tau):
        return tau + off(tau) - off0

    prof = peq[prow.long()]                                # (B, S1, NW)
    tg = targets[trow.long()]                              # (B, T)
    lanes = torch.arange(B, device=dev)[:, None]
    j = torch.arange(W, device=dev)
    pv = torch.full((B, W), -1, dtype=_I32, device=dev)
    mv = torch.zeros((B, W), dtype=_I32, device=dev)
    cur = torch.full((W,), -1, dtype=torch.int64, device=dev)
    out = torch.zeros((B, W), dtype=_I32, device=dev)
    score = torch.full((B,), (off0 + n_win) * WORD_SIZE, dtype=_I32,
                       device=dev)
    mask = (1 << WORD_TILE) - 1
    lo, hi_t = 0, -1
    for s in range(start(n_tiles - 1) + n_win):
        while hi_t + 1 < n_tiles and start(hi_t + 1) <= s:
            hi_t += 1
        while lo <= hi_t and start(lo) + n_win <= s:
            lo += 1
        x_min = s - hi_t + off0
        x = x_min + (j - x_min) % W
        valid = (x <= s - lo + off0) & (lo <= hi_t)
        tau = s - x + off0
        new = valid & (x != cur)                           # entering words
        pv[:, new], mv[:, new] = -1, 0
        cur = torch.where(valid, x, cur)
        top = valid & (x == torch.tensor(
            [off(int(t)) if v else -1 for t, v in zip(tau, valid)],
            device=dev))
        y = out.roll(1, 1)                                 # thread j - 1
        hp_in = torch.where(top, mask, y & mask)
        hn_in = torch.where(top, 0, (y >> WORD_TILE) & mask)
        xr = x.clamp(0, nw - 1)
        o_p = torch.zeros((B, W), dtype=_I32, device=dev)
        o_n = torch.zeros_like(o_p)
        for k in range(WORD_TILE):
            c = WORD_TILE * tau + k
            act = valid & (c < T)
            e = prof[lanes, tg[:, c.clamp(0, T - 1)].long(), xr[None, :]]
            pv2, mv2, hn2, hp2 = _advance_word(pv, mv, e, (hn_in >> k) & 1,
                                               (hp_in >> k) & 1)
            pv = torch.where(act, pv2, pv)
            mv = torch.where(act, mv2, mv)
            o_p |= torch.where(act, hp2, 0) << k
            o_n |= torch.where(act, hn2, 0) << k
        out = (o_n << WORD_TILE) | o_p
        if lo <= hi_t and start(lo) + n_win - 1 == s:      # a tile's bottom
            ob = off(lo)
            jb = (ob + n_win - 1) % W
            bp, bn = o_p[:, jb], o_n[:, jb]
            cb = WORD_TILE * lo
            for k in range(min(WORD_TILE, T - cb)):
                m = (2 << k) - 1
                yield (cb + k, score + _popc(bp & m) - _popc(bn & m),
                       ob == nw - n_win)
            score = score + _popc(bp) - _popc(bn)
            if lo + 1 < n_tiles:
                score = score + (off(lo + 1) - ob) * WORD_SIZE


def nw_banded_words_plain(peq, targets, woff, hi, prow, trow, n_win: int,
                          chunk: int):
    """nw_banded on the word-parallel band's schedule in plain PyTorch
    (_band_words_columns): the score at hi - 1 where live.  Operands and
    output as nw_banded (band_width > 0)."""
    cols = _band_words_columns("nw_banded_words_plain", peq, targets, woff,
                               prow, trow, n_win, chunk)
    return _reduction(cols, torch.zeros_like(hi), hi)[3]


def shw_banded_words_plain(peq, targets, woff, lo, hi, prow, trow,
                           n_win: int, chunk: int):
    """shw_banded on the word-parallel band's schedule in plain PyTorch
    (_band_words_columns): (best, pfirst, plast) over the live columns in
    [lo, hi).  Operands and outputs as shw_banded (band_width > 0)."""
    cols = _band_words_columns("shw_banded_words_plain", peq, targets, woff,
                               prow, trow, n_win, chunk)
    return _reduction(cols, lo, hi)[:3]


def shw_banded_hits_words_plain(peq, targets, woff, lo, hi, prow, trow,
                                best, n_win: int, chunk: int):
    """shw_banded_hits on the word-parallel band's schedule in plain
    PyTorch (_band_words_columns): the live columns in [lo, min(hi, T))
    that score best.  Operands and output as shw_banded_hits (band_width
    > 0)."""
    cols = _band_words_columns("shw_banded_hits_words_plain", peq, targets,
                               woff, prow, trow, n_win, chunk)
    return _hit_words(cols, lo, hi, best, targets.shape[1])


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _on_cuda(name: str, *tensors) -> bool:
    """False for CPU operands (plain version), True for CUDA operands
    (kernel); raises for mixed devices or any other device type."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel for device {dev}")


def _check(name: str, t: torch.Tensor, what: str, ndim: int) -> None:
    if t.dtype != _I32:
        raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {what} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _check_lanes(name: str, vecs: dict) -> int:
    n = next(iter(vecs.values())).shape[0]
    for what, v in vecs.items():
        _check(name, v, what, 1)
        if v.shape[0] != n:
            raise ValueError(f"{name}: {what} has {v.shape[0]} lanes, "
                             f"expected {n}")
    return n


def _check_planes(name, planes, pad, nb: int, n_alts: int) -> None:
    _check(name, planes, "planes", 2)
    _check(name, pad, "pad", 2)
    nw = pad.shape[1]
    if planes.shape[1] != n_alts * nb * nw or planes.shape[0] != pad.shape[0]:
        raise ValueError(f"{name}: planes {tuple(planes.shape)} do not match "
                         f"pad {tuple(pad.shape)} with n_alts={n_alts}, "
                         f"nb={nb}")
    if not 1 <= nb <= 9:
        raise ValueError(f"{name}: nb={nb} outside [1, 9]")


def _check_band(name, peq, targets, woff, n_win: int, chunk: int) -> None:
    _check(name, woff, "woff", 1)
    nw = peq.shape[2]
    if not 1 <= n_win <= nw or chunk < 1:
        raise ValueError(f"{name}: n_win={n_win} outside [1, {nw}] or "
                         f"chunk={chunk} < 1")
    if woff.shape[0] * chunk < targets.shape[1]:
        raise ValueError(f"{name}: {woff.shape[0]} window offsets of {chunk} "
                         f"columns do not cover {targets.shape[1]} columns")
    if woff.numel() and not bool((woff.min() >= 0) & (woff.max() <= nw - n_win)
                                 & (woff[1:] >= woff[:-1]).all()):
        raise ValueError(f"{name}: window offsets must be nondecreasing in "
                         f"[0, {nw - n_win}]")


def _lane_outputs(n: int, dev, count: int = 4):
    return [torch.empty(n, dtype=_I32, device=dev) for _ in range(count)]


def _hit_output(n: int, n_cols: int, dev) -> torch.Tensor:
    return torch.zeros((n, -(-n_cols // WORD_SIZE)), dtype=_I32, device=dev)


def _scratch(n_words: int, n_lanes: int, dev, full: bool = False
             ) -> torch.Tensor:
    """State buffer of the kernels' generic paths: more than 8 words, or
    (full) a band window of a width without a register path, which the
    banded kernels pick themselves."""
    size = 2 * n_words * n_lanes if full or n_words > 8 else 1
    return torch.empty(size, dtype=_I32, device=dev)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(name: str, fn: str, *args) -> None:
    lib = _build.load()
    _build.check(lib, getattr(lib, fn)(*args), name)
    _LAUNCHES[name] += 1


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy where its data is not 16-byte aligned: the split
    kernels stream targets in 16-byte chunks."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _split_launch(name, fn, head, nw: int, targets, lo, hi, prow, trow,
                  hin0: int, core, dev):
    """Launch K1 or K3 (fn, its leading operands head) on the split-lane
    plan and unpack its keys: (best, pfirst, plast, last).  Where no lane
    has two cores, thread i is lane i and no offsets are passed."""
    n, n_cols = lo.shape[0], targets.shape[1]
    keys = _new_keys(n, 2, dev)
    last = torch.full((n,), _BIG, dtype=_I32, device=dev)
    if n and n_cols:
        c = split_core(n, n_cols, nw, hin0, core)
        offsets = (split_offsets(split_cores(lo, hi, n_cols, c)[2])
                   if c < n_cols and nw <= _SPLIT_MAX_WORDS else None)
        targets = _aligned(targets)
        _launch(name, fn, dev.index, *head, targets.data_ptr(), n_cols,
                *_ptrs(lo, hi, prow, trow), n, int(hin0),
                None if offsets is None else offsets.data_ptr(),
                n * -(-n_cols // c), c, split_halo(nw), keys[0].data_ptr(),
                keys[1].data_ptr(), last.data_ptr(),
                _scratch(nw, n, dev).data_ptr(), _stream(dev))
    return _unpack_keys(keys) + (last,)


def _hits_launch(name, fn, head, nw: int, targets, lo, hi, prow, trow,
                 best, hin0: int, core, plan, dev):
    """Launch #5 or #13 (fn, its leading operands head) on the hit words'
    word-aligned plan (hits_core); offsets only where some lane has two
    cores.  Returns the hit words."""
    n, n_cols = lo.shape[0], targets.shape[1]
    hits = _hit_output(n, n_cols, dev)
    if n == 0:
        return hits
    c = hits_core(n, n_cols, nw, hin0, core)
    offsets = (split_offsets(split_cores(lo, hi, n_cols, c, True)[2])
               if c < n_cols else None)
    targets = _aligned(targets)
    buf = _plan_buffer()
    _launch(name, fn, dev.index, *head, targets.data_ptr(), n_cols,
            *_ptrs(lo, hi, prow, trow), n, int(hin0),
            None if offsets is None else offsets.data_ptr(),
            n * -(-n_cols // c), c, split_halo(nw), best.data_ptr(),
            hits.data_ptr(), hits.shape[1], _scratch(nw, n, dev).data_ptr(),
            ctypes.addressof(buf), _stream(dev))
    _fill_plan(plan, buf)
    return hits


def reduce_lanes(peq, targets, lo, hi, prow, trow, hin0: int, *, core=None):
    """Per-lane Myers sweep with in-sweep reduction (kernel K1).

    peq: int32 (R_p, S1, NW) profile bit words; targets: int32 (R_t, T)
    symbols in [0, S1); lo, hi, prow, trow: int32 (B,).  Lane i sweeps
    target row trow[i] with profile row prow[i] over scan columns
    [0, min(hi[i], T)) and returns, over columns [lo[i], hi[i]):
    best, pfirst, plast (int32 (B,)) and last, the score at hi[i]-1.
    hin0: 0 for HW (free leading gap), 1 for SHW/NW.  At 1-8 words the
    kernel runs the split-lane schedule (split_core); `core` forces its
    core length, for checks only."""
    name = "reduce_lanes"
    _check(name, peq, "peq", 3)
    _check(name, targets, "targets", 2)
    _check_lanes(name, dict(lo=lo, hi=hi, prow=prow, trow=trow))
    if not _on_cuda(name, peq, targets, lo, hi, prow, trow):
        return reduce_lanes_plain(peq, targets, lo, hi, prow, trow, hin0)
    s1, nw = peq.shape[1], peq.shape[2]
    return _split_launch(name, "myers_reduce_lanes",
                         (peq.data_ptr(), s1, nw), nw, targets, lo, hi, prow,
                         trow, hin0, core, peq.device)


def reduce_bitplane(planes, pad, targets, lo, hi, prow, trow, hin0: int,
                    nb: int, n_alts: int, wildcard: int, *, core=None):
    """reduce_lanes with Eq rebuilt per column from query-id bit planes
    (kernel K3): planes int32 (R_p, n_alts*nb*NW) from bitplane_planes,
    pad int32 (R_p, NW) rows matching every symbol, wildcard the target
    symbol matching every row; targets in [0, 2^nb).  Other operands and
    outputs as reduce_lanes, and at 1-8 words the same split-lane plan
    (`core` forces its core length, for checks only)."""
    name = "reduce_bitplane"
    _check_planes(name, planes, pad, nb, n_alts)
    _check(name, targets, "targets", 2)
    _check_lanes(name, dict(lo=lo, hi=hi, prow=prow, trow=trow))
    if not _on_cuda(name, planes, pad, targets, lo, hi, prow, trow):
        return reduce_bitplane_plain(planes, pad, targets, lo, hi, prow,
                                     trow, hin0, nb, n_alts, wildcard)
    nw = pad.shape[1]
    return _split_launch(name, "myers_reduce_bitplane",
                         (planes.data_ptr(), pad.data_ptr(), nw, nb, n_alts,
                          wildcard), nw, targets, lo, hi, prow, trow, hin0,
                         core, planes.device)


def sweep_shared(peq_t, target, hin0: int, col_lo: int, col_hi: int, *,
                 core=None):
    """Every lane against one target (kernel K2).

    peq_t: int32 (S1, NW, B) profile bit words, lane-minor so a warp reads
    consecutive words; target: int32 (n_cols,) symbols in [0, S1).
    Returns (best, pos) int32 (B,): the minimal score over scan columns
    [col_lo, col_hi) and the first column reaching it.  At 1-8 words the
    kernel runs the split-lane schedule; `core` as reduce_lanes."""
    name = "sweep_shared"
    _check(name, peq_t, "peq_t", 3)
    _check(name, target, "target", 1)
    if not _on_cuda(name, peq_t, target):
        return sweep_shared_plain(peq_t, target, hin0, col_lo, col_hi)
    s1, nw, n = peq_t.shape
    dev = peq_t.device
    keys = _new_keys(n, 1, dev)
    span = _shared_span(target.shape[0], col_lo, col_hi)
    if n and span:
        c = split_core(n, span, nw, hin0, core)
        target = _aligned(target)
        _launch(name, "myers_sweep_shared", dev.index, peq_t.data_ptr(), s1,
                nw, n, target.data_ptr(), target.shape[0],
                int(hin0), int(col_lo), int(col_hi), -(-span // c), c,
                split_halo(nw), keys.data_ptr(),
                _scratch(nw, n, dev).data_ptr(), _stream(dev))
    return _unpack_keys(keys)


def hits_lanes(peq, targets, lo, hi, prow, trow, best, hin0: int, *,
               core=None, plan=None):
    """Packed hit mask of each lane's columns that reach `best`.

    Operands as reduce_lanes plus best int32 (B,); returns int32
    (B, ceil(T/32)), bit j of word g set iff scan column 32g+j lies in
    [lo, hi) and its score equals best (a lane with best = -(1<<30) has
    none).  With one target row and trow = 0 it is the shared form.  At
    1-8 words and hin0 = 0 the kernel runs the split-lane schedule with
    cores that own whole hit words (hits_core, split_hits_plain); a lane
    no longer than a core stays one thread.  For checks only: `core`
    forces the core length (rounded up to 32), and a dict `plan` receives
    what the kernel launched (sweep_scores)."""
    name = "hits_lanes"
    _check(name, peq, "peq", 3)
    _check(name, targets, "targets", 2)
    _check_lanes(name, dict(lo=lo, hi=hi, prow=prow, trow=trow, best=best))
    if not _on_cuda(name, peq, targets, lo, hi, prow, trow, best):
        return hits_lanes_plain(peq, targets, lo, hi, prow, trow, best, hin0)
    s1, nw = peq.shape[1], peq.shape[2]
    return _hits_launch(name, "myers_hits_lanes", (peq.data_ptr(), s1, nw),
                        nw, targets, lo, hi, prow, trow, best, hin0, core,
                        plan, peq.device)


def hits_bitplane(planes, pad, targets, lo, hi, prow, trow, best, hin0: int,
                  nb: int, n_alts: int, wildcard: int, *, core=None,
                  plan=None):
    """hits_lanes with bit-plane Eq; operands as reduce_bitplane plus
    best, output as hits_lanes.  At 1-8 words the kernel runs #5's
    split-lane plan (hits_core, cores that own whole hit words) on K3's
    staged rows, one core a lane included (split_hits_bitplane_plain);
    past 8 words one thread a lane.  For checks only: `core` forces the
    core length (rounded up to 32), and a dict `plan` receives what the
    kernel launched (sweep_scores)."""
    name = "hits_bitplane"
    _check_planes(name, planes, pad, nb, n_alts)
    _check(name, targets, "targets", 2)
    _check_lanes(name, dict(lo=lo, hi=hi, prow=prow, trow=trow, best=best))
    if not _on_cuda(name, planes, pad, targets, lo, hi, prow, trow, best):
        return hits_bitplane_plain(planes, pad, targets, lo, hi, prow, trow,
                                   best, hin0, nb, n_alts, wildcard)
    nw = pad.shape[1]
    return _hits_launch(name, "myers_hits_bitplane",
                        (planes.data_ptr(), pad.data_ptr(), nw, nb, n_alts,
                         wildcard), nw, targets, lo, hi, prow, trow, best,
                        hin0, core, plan, planes.device)


def _banded_common(name, peq, targets, woff, n_win, chunk, lanes: dict):
    _check(name, peq, "peq", 3)
    _check(name, targets, "targets", 2)
    _check_band(name, peq, targets, woff, n_win, chunk)
    n = _check_lanes(name, lanes)
    on_cuda = _on_cuda(name, peq, targets, woff, *lanes.values())
    return n, on_cuda


def _band_head(peq, targets, woff, n_win: int, chunk: int, n: int):
    """The banded entry points' leading arguments, after the device."""
    nw = peq.shape[2]
    scratch = _scratch(nw, n, peq.device, full=True)
    head = (peq.data_ptr(), peq.shape[1], nw, targets.data_ptr(),
            targets.shape[1], woff.data_ptr(), woff.shape[0], int(chunk),
            int(n_win))
    return head, scratch


def nw_banded(peq, targets, woff, hi, prow, trow, n_win: int, chunk: int,
              *, plan=None):
    """Banded NW: each lane's score at scan column hi-1, advancing only the
    window words [woff[c // chunk], +n_win) at column c.

    peq, targets, hi, prow, trow as reduce_lanes; woff int32 (n_chunks,)
    nondecreasing in [0, NW - n_win] with n_chunks * chunk >= T.  Returns
    int32 (B,): exact where the distance is within the band, otherwise an
    overestimate (never below the distance); _BIG where the window had not
    reached the bottom word at hi-1.  The kernel runs the word-parallel
    band (nw_banded_words_plain) where band_width gives it a segment, else
    one thread a lane; a dict `plan` receives what it launched
    (sweep_scores; checks only)."""
    name = "nw_banded"
    n, on_cuda = _banded_common(name, peq, targets, woff, n_win, chunk,
                                dict(hi=hi, prow=prow, trow=trow))
    if not on_cuda:
        return nw_banded_plain(peq, targets, woff, hi, prow, trow, n_win,
                               chunk)
    dev = peq.device
    (last,) = _lane_outputs(n, dev, 1)
    if n == 0:
        return last
    head, scratch = _band_head(peq, targets, woff, n_win, chunk, n)
    buf = _plan_buffer()
    _launch(name, "myers_nw_banded", dev.index, *head,
            *_ptrs(hi, prow, trow), n, last.data_ptr(), scratch.data_ptr(),
            band_width(n_win, chunk), ctypes.addressof(buf), _stream(dev))
    _fill_plan(plan, buf)
    return last


def shw_banded(peq, targets, woff, lo, hi, prow, trow, n_win: int,
               chunk: int, *, plan=None):
    """Banded SHW reduce: (best, pfirst, plast) int32 (B,) over columns in
    [lo, hi) where the window has reached the bottom word; operands as
    nw_banded plus lo.  Exact for lanes whose best is within the band.  The
    kernel runs the word-parallel band (shw_banded_words_plain) where
    band_width gives it a segment, else one thread a lane; a dict `plan`
    receives what it launched (sweep_scores; checks only)."""
    name = "shw_banded"
    n, on_cuda = _banded_common(name, peq, targets, woff, n_win, chunk,
                                dict(lo=lo, hi=hi, prow=prow, trow=trow))
    if not on_cuda:
        return shw_banded_plain(peq, targets, woff, lo, hi, prow, trow,
                                n_win, chunk)
    dev = peq.device
    out = _lane_outputs(n, dev, 3)
    if n == 0:
        return tuple(out)
    head, scratch = _band_head(peq, targets, woff, n_win, chunk, n)
    buf = _plan_buffer()
    _launch(name, "myers_shw_banded", dev.index, *head,
            *_ptrs(lo, hi, prow, trow), n, *_ptrs(*out), scratch.data_ptr(),
            band_width(n_win, chunk), ctypes.addressof(buf), _stream(dev))
    _fill_plan(plan, buf)
    return tuple(out)


def shw_banded_hits(peq, targets, woff, lo, hi, prow, trow, best,
                    n_win: int, chunk: int, *, plan=None):
    """Banded SHW hit mask: as hits_lanes over the columns where the window
    has reached the bottom word; operands as shw_banded plus best.  The
    kernel runs the word-parallel band (shw_banded_hits_words_plain) where
    band_width gives it a segment, else one thread a lane; a dict `plan`
    receives what it launched (sweep_scores; checks only)."""
    name = "shw_banded_hits"
    n, on_cuda = _banded_common(name, peq, targets, woff, n_win, chunk,
                                dict(lo=lo, hi=hi, prow=prow, trow=trow,
                                     best=best))
    if not on_cuda:
        return shw_banded_hits_plain(peq, targets, woff, lo, hi, prow, trow,
                                     best, n_win, chunk)
    dev = peq.device
    hits = _hit_output(n, targets.shape[1], dev)
    if n == 0:
        return hits
    head, scratch = _band_head(peq, targets, woff, n_win, chunk, n)
    buf = _plan_buffer()
    _launch(name, "myers_shw_banded_hits", dev.index, *head,
            *_ptrs(lo, hi, prow, trow), n, best.data_ptr(), hits.data_ptr(),
            hits.shape[1], scratch.data_ptr(), band_width(n_win, chunk),
            ctypes.addressof(buf), _stream(dev))
    _fill_plan(plan, buf)
    return hits


def _card_sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def capture(peq, targets, hin0: int, want_h: bool = False, *, plan=None):
    """Every column's Myers state per lane (the column-capture kernel).

    peq: int32 (B, S1, NW) profile bit words; targets: int32 (B, T) symbols
    in [0, S1), one row per lane (pad columns hold the wildcard S1-1).
    Returns (pv, mv), with want_h also (ph, mh), each int32 (B, T, NW): word
    w of lane b after column c, Ph/Mh the unshifted horizontal deltas
    (bit i set where cell(32w+i, c) - cell(32w+i, c-1) is +1 / -1).  The
    tensors are views of (T, NW, B) storage, lane-minor: x.permute(1, 2, 0)
    is contiguous.  hin0: 0 for HW, 1 for SHW/NW.  The kernel runs word
    groups over lanes in capture_plan's shape (capture_words_plain), one
    thread a lane past 512 words; a dict `plan` receives what it
    launched (sweep_scores; checks only)."""
    name = "capture"
    _check(name, peq, "peq", 3)
    _check(name, targets, "targets", 2)
    if targets.shape[0] != peq.shape[0]:
        raise ValueError(f"{name}: targets has {targets.shape[0]} lanes, "
                         f"peq {peq.shape[0]}")
    if not _on_cuda(name, peq, targets):
        return capture_plain(peq, targets, hin0, want_h)
    B, s1, nw = peq.shape
    T = targets.shape[1]
    dev = peq.device
    outs = [torch.empty((T, nw, B), dtype=_I32, device=dev)
            for _ in range(4 if want_h else 2)]
    if B and T:
        ptrs = _ptrs(*outs) + ([None, None] if not want_h else [])
        shape = capture_plan(nw, B, _card_sms(dev))
        buf = _plan_buffer()
        _launch(name, "myers_capture", dev.index, peq.data_ptr(), s1, nw,
                targets.data_ptr(), T, B, int(hin0), shape.get("lanes", 0),
                shape.get("words", 0), *ptrs, ctypes.addressof(buf),
                _stream(dev))
        _fill_plan(plan, buf)
    return tuple(o.permute(2, 0, 1) for o in outs)


# A launch plan as csrc/myers.cu's entries report it (LaunchPlan): the
# form, the blocks and threads a block of its (first) launch, then the
# segment width, the cores a lane and their columns, the groups a lane,
# ring tiles, passes and groups a pass; the capture's word groups give
# their lanes a block and words a group in the first two figures' places.
_PLAN_FORMS = ("thread", "words", "groups", "cores", "wave", "lane_words",
               "band")
_PLAN_KEYS = ("width", "cores", "core", "groups", "ring", "passes",
              "pass_groups")
_PLAN_FORM_KEYS = {"lane_words": ("lanes", "words")}


def _plan_buffer():
    return (ctypes.c_longlong * (3 + len(_PLAN_KEYS)))()


def _fill_plan(plan, buf) -> None:
    """Write a reported plan into the caller's dict `plan` (None: not
    asked): form, blocks, threads (in all) and block (threads a block),
    and the form's own figures (those of its _PLAN_FORM_KEYS, else of
    _PLAN_KEYS, that are set)."""
    if plan is None:
        return
    plan.clear()
    form = _PLAN_FORMS[buf[0]]
    plan.update(form=form, blocks=buf[1], threads=buf[1] * buf[2],
                block=buf[2])
    keys = _PLAN_FORM_KEYS.get(form, _PLAN_KEYS)
    plan.update((k, v) for k, v in zip(keys, buf[3:]) if v)


def _scores_scratch(dev, s1: int, nw: int, T: int, n: int, ring: int,
                    pass_groups) -> torch.Tensor:
    """The score-stream kernel's scratch, as large as its entry's plan
    asks (the state of the scratch form, the groups' links and pass
    records)."""
    lib = _build.load()
    words = ctypes.c_longlong(0)
    _build.check(lib, lib.myers_sweep_scores_plan(
        dev.index, s1, nw, T, n, ring, pass_groups or 0, None,
        ctypes.byref(words)), "sweep_scores")
    return torch.empty(words.value, dtype=_I32, device=dev)


def _check_ring(name: str, ring, pass_groups=None) -> int:
    if ring is not None and ring < 1:
        raise ValueError(f"{name}: ring={ring} < 1")
    if pass_groups is not None and pass_groups < 1:
        raise ValueError(f"{name}: pass_groups={pass_groups} < 1")
    return ring or _WF_RING


def sweep_scores(peq, targets, prow, trow, hin0: int, *, ring=None,
                 pass_groups=None, plan=None):
    """Every lane's score after every column (the score-stream kernel).

    peq: int32 (R_p, S1, NW) profile bit words; targets: int32 (R_t, T)
    symbols in [0, S1); prow, trow: int32 (B,).  Lane i sweeps target row
    trow[i] with profile row prow[i] over all T columns.  Returns int32
    (B, T), the padded bottom cell after each column (equal to the true
    cell(qlen-1, c - W) for c >= W), a view of (T, B) storage: lane-minor,
    x.t() is contiguous.  hin0: 0 for HW, 1 for SHW/NW.  The kernel runs
    at 2-8 words the word-parallel lane (word_lanes_plain), from 256 words
    warp groups (sweep_scores_groups_plain), in passes where a lane holds
    more groups than one launch keeps resident.  For checks only: `ring`
    forces the groups' ring depth in tiles and `pass_groups` the most
    groups a pass holds; a dict `plan` receives what the kernel launched
    (_fill_plan; left as it is on the CPU)."""
    name = "sweep_scores"
    _check(name, peq, "peq", 3)
    _check(name, targets, "targets", 2)
    n = _check_lanes(name, dict(prow=prow, trow=trow))
    ring = _check_ring(name, ring, pass_groups)
    if not _on_cuda(name, peq, targets, prow, trow):
        return sweep_scores_plain(peq, targets, prow, trow, hin0)
    s1, nw = peq.shape[1], peq.shape[2]
    T = targets.shape[1]
    dev = peq.device
    out = torch.empty((T, n), dtype=_I32, device=dev)
    if n and T:
        buf = _plan_buffer()
        _launch(name, "myers_sweep_scores", dev.index, peq.data_ptr(), s1, nw,
                targets.data_ptr(), T, *_ptrs(prow, trow), n, int(hin0),
                out.data_ptr(), *[None] * 6,
                _scores_scratch(dev, s1, nw, T, n, ring,
                                pass_groups).data_ptr(), ring,
                pass_groups or 0, ctypes.addressof(buf), _stream(dev))
        _fill_plan(plan, buf)
    return out.t()


def _check_carry(name, pv0, mv0, s0, n: int, nw: int) -> None:
    _check(name, pv0, "pv0", 2)
    _check(name, mv0, "mv0", 2)
    _check(name, s0, "s0", 1)
    if (tuple(pv0.shape) != (n, nw) or tuple(mv0.shape) != (n, nw)
            or s0.shape[0] != n):
        raise ValueError(f"{name}: carry pv0 {tuple(pv0.shape)}, mv0 "
                         f"{tuple(mv0.shape)}, s0 {tuple(s0.shape)} do not "
                         f"match {n} lanes of {nw} words")


def _carry_out(n: int, nw: int, dev):
    return (torch.empty((n, nw), dtype=_I32, device=dev),
            torch.empty((n, nw), dtype=_I32, device=dev),
            torch.empty(n, dtype=_I32, device=dev))


def sweep_scores_resume(peq, targets, prow, trow, pv0, mv0, s0, hin0: int,
                        *, ring=None, pass_groups=None, plan=None):
    """sweep_scores from a carried state (the carry form of the
    score-stream kernel): operands as sweep_scores plus pv0, mv0 int32
    (B, NW) and s0 int32 (B,), the state after the column before this
    segment.  Returns (scores as sweep_scores, pv, mv, score): the state
    after the last column, so segments chained through it equal one sweep
    of their concatenation (jax_engine.sweep_scores_resumable).  The forms,
    `ring`, `pass_groups` and `plan` as sweep_scores."""
    name = "sweep_scores_resume"
    _check(name, peq, "peq", 3)
    _check(name, targets, "targets", 2)
    n = _check_lanes(name, dict(prow=prow, trow=trow))
    _check_carry(name, pv0, mv0, s0, n, peq.shape[2])
    ring = _check_ring(name, ring, pass_groups)
    if not _on_cuda(name, peq, targets, prow, trow, pv0, mv0, s0):
        return sweep_scores_resume_plain(peq, targets, prow, trow, pv0, mv0,
                                         s0, hin0)
    s1, nw = peq.shape[1], peq.shape[2]
    T = targets.shape[1]
    dev = peq.device
    out = torch.empty((T, n), dtype=_I32, device=dev)
    if not (n and T):
        return out.t(), pv0.clone(), mv0.clone(), s0.clone()
    state = _carry_out(n, nw, dev)
    buf = _plan_buffer()
    _launch(name, "myers_sweep_scores", dev.index, peq.data_ptr(), s1, nw,
            targets.data_ptr(), T, *_ptrs(prow, trow), n, int(hin0),
            out.data_ptr(), *_ptrs(pv0, mv0, s0, *state),
            _scores_scratch(dev, s1, nw, T, n, ring, pass_groups).data_ptr(),
            ring, pass_groups or 0, ctypes.addressof(buf), _stream(dev))
    _fill_plan(plan, buf)
    return (out.t(),) + state


def reduce_resume(peq, targets, lo, hi, prow, trow, pv0, mv0, s0, hin0: int,
                  *, core=None, plan=None):
    """The resumable reduce (kernel reduce_resume): every lane sweeps ALL
    T columns of its target row from the carried state pv0, mv0 int32
    (B, NW), s0 int32 (B,), and reduces the columns in [lo, hi) as
    reduce_lanes does (last: the score at hi-1, _BIG when hi-1 is not a
    column of this segment).  Returns (best, pfirst, plast, last, pv, mv,
    score), the last three the state after column T-1: segments chained
    through it equal one sweep of their concatenation.  A fresh start is
    pv0 = -1 (all ones), mv0 = 0, s0 = NW * 32.  At 1-8 words the kernel
    runs the split-lane schedule with the carry (resume_cores,
    split_resume_plain): at hin0 = 0 its cores past the first halo start
    from the fresh state, so the carry must be a state an HW sweep leaves
    (every row's value >= 0, the score the bottom row's), as the pipelines'
    carries are; one core a lane (hin0 = 1, or a segment shorter than a
    core) takes any carry, at 2-8 words on the word-parallel lane.  For
    checks only: `core` forces its core length, and a dict `plan` receives
    what the kernel launched (sweep_scores)."""
    name = "reduce_resume"
    _check(name, peq, "peq", 3)
    _check(name, targets, "targets", 2)
    n = _check_lanes(name, dict(lo=lo, hi=hi, prow=prow, trow=trow))
    _check_carry(name, pv0, mv0, s0, n, peq.shape[2])
    if not _on_cuda(name, peq, targets, lo, hi, prow, trow, pv0, mv0, s0):
        return reduce_resume_plain(peq, targets, lo, hi, prow, trow, pv0, mv0,
                                   s0, hin0)
    s1, nw = peq.shape[1], peq.shape[2]
    T = targets.shape[1]
    dev = peq.device
    if not (n and T):
        return (torch.full((n,), _BIG, dtype=_I32, device=dev),
                torch.full((n,), -1, dtype=_I32, device=dev),
                torch.full((n,), -1, dtype=_I32, device=dev),
                torch.full((n,), _BIG, dtype=_I32, device=dev),
                pv0.clone(), mv0.clone(), s0.clone())
    state = _carry_out(n, nw, dev)
    c, n_cores = resume_cores(n, T, nw, hin0, core)
    # Several cores a lane merge packed keys; one core writes its lane.
    keys = _new_keys(n, 2, dev) if n_cores > 1 else None
    out = _lane_outputs(n, dev)
    if keys is not None:
        out[3].fill_(_BIG)
    targets = _aligned(targets)
    buf = _plan_buffer()
    _launch(name, "myers_reduce_resume", dev.index, peq.data_ptr(), s1, nw,
            targets.data_ptr(), T, *_ptrs(lo, hi, prow, trow), n, int(hin0),
            *_ptrs(pv0, mv0, s0), n_cores, c, split_halo(nw),
            *([None, None] if keys is None else _ptrs(*keys)),
            *_ptrs(*out), *_ptrs(*state), _scratch(nw, n, dev).data_ptr(),
            ctypes.addressof(buf), _stream(dev))
    _fill_plan(plan, buf)
    if keys is not None:
        out[:3] = _unpack_keys(keys)
    return tuple(out) + state


# The adaptive reduce's launch (csrc/myers.cu hw_adaptive_cluster_kernel):
# a tile's 1,024 lanes over a thread-block cluster of C blocks, a lane's
# words in registers at a capacity of _ADAPTIVE_WORDS, else in scratch.
_ADAPTIVE_CLUSTERS = (16, 8, 4, 2, 1)
_ADAPTIVE_WORDS = (1, 2, 4, 8, 16, 32)
_ADAPTIVE_SMEM = 232_448   # a block's shared memory on the H100 (csrc
#                            kAdaptiveSmemMax)
_ADAPTIVE_PASS_WORDS = 2048  # words a barrier publishes (kAdaptivePassWords)
_ADAPTIVE_FORMS = ("regs", "scratch")


def adaptive_plan(nw: int, s1: int, cluster: int, regs: bool = True) -> dict:
    """The adaptive reduce's launch for nw words and s1 profile rows with C =
    `cluster` blocks a tile: form "regs" (a lane's words in registers, nwc
    the least capacity of _ADAPTIVE_WORDS that holds nw) where regs and nw
    <= 32, else "scratch" (nwc 0); lanes a block, 1,024 / C; staged: the
    block's profile rows in shared memory, where they fit its budget beside
    the minima (three buffers of two per word of a pass); smem: the bytes
    it asks."""
    if cluster not in _ADAPTIVE_CLUSTERS:
        raise ValueError(f"hw_adaptive: cluster={cluster} not one of "
                         f"{_ADAPTIVE_CLUSTERS}")
    lanes = _TILE_LANES // cluster
    nwc = next((c for c in _ADAPTIVE_WORDS if c >= nw), 0) if regs else 0
    minima = 4 * 6 * min(nw, _ADAPTIVE_PASS_WORDS)  # adaptive_smem_words
    rows = 4 * s1 * nw * lanes
    staged = minima + rows <= _ADAPTIVE_SMEM
    return dict(form="regs" if nwc else "scratch", cluster=cluster,
                lanes=lanes, staged=staged, nwc=nwc,
                smem=minima + rows * staged)


def adaptive_plans(nw: int, s1: int, cluster=None):
    """The plans hw_adaptive tries, in order: the register form at C = 16,
    8, 4, 2 and 1 (those <= cluster), then the scratch form at the same;
    it launches the first the card admits."""
    cs = [c for c in _ADAPTIVE_CLUSTERS if cluster is None or c <= cluster]
    return [adaptive_plan(nw, s1, c, regs) for regs in (True, False)
            for c in cs if not regs or nw <= _ADAPTIVE_WORDS[-1]]


def _plan_words(p: dict):
    """A plan as myers_hw_adaptive takes it: int32 (5,)."""
    return (ctypes.c_int32 * 5)(_ADAPTIVE_FORMS.index(p["form"]),
                                p["cluster"], p["lanes"], int(p["staged"]),
                                p["nwc"])


def _adaptive_admitted(dev, nw: int, s1: int, cluster) -> dict:
    """The first of adaptive_plans that the card admits (one cluster of it
    at least can be resident), with `clusters`, how many can."""
    lib = _build.load()
    for p in adaptive_plans(nw, s1, cluster):
        words, n = _plan_words(p), ctypes.c_int(0)
        _build.check(lib, lib.myers_hw_adaptive_clusters(
            dev.index, s1, nw, ctypes.addressof(words), ctypes.byref(n)),
            "hw_adaptive")
        if n.value > 0:
            return dict(p, clusters=n.value)
    raise RuntimeError(f"hw_adaptive: the card admits no cluster of any plan "
                       f"for {nw} words and {s1} profile rows")


def hw_adaptive(peq, targets, lo, hi, prow, trow, k: int, hin0: int,
                group: int = 8, strong_every: int = 64, live=None, *,
                cluster=None, plan=None):
    """The value-adaptive banded reduce (kernel hw_adaptive): operands as
    reduce_lanes with B a multiple of 1,024.  Each 1,024 lanes (a tile, the
    TPU kernel's (8, 128)) share one live word band, updated every `group`
    columns from the tile's minima and, every strong_every groups (0:
    never), from an exact min-cell strong reduce; k >= 0 is the band's
    threshold.  Returns (best, pfirst, plast) int32 (B,) over [lo, hi),
    exact for lanes whose best is <= k, above k otherwise (the TPU kernel's
    raw outputs, overestimates included).  live: an int64 (B // 1024,)
    tensor or None; the word-columns each tile swept are written there.
    On the card a tile runs on a cluster of C blocks, the first of
    adaptive_plans the card admits.  For checks only: `cluster` caps C (it
    may only lower it), and a dict `plan` receives the launch (adaptive_plan's
    fields, blocks, and the clusters the card holds at once)."""
    name = "hw_adaptive"
    _check(name, peq, "peq", 3)
    _check(name, targets, "targets", 2)
    n = _check_lanes(name, dict(lo=lo, hi=hi, prow=prow, trow=trow))
    s1, nw = peq.shape[1], peq.shape[2]
    if n % _TILE_LANES or k < 0 or group < 1 or strong_every < 0:
        raise ValueError(f"{name}: lanes {n} (a multiple of {_TILE_LANES}), "
                         f"k={k} (>= 0), group={group} (>= 1), "
                         f"strong_every={strong_every} (>= 0)")
    if cluster is not None and cluster not in _ADAPTIVE_CLUSTERS:
        raise ValueError(f"{name}: cluster={cluster} not one of "
                         f"{_ADAPTIVE_CLUSTERS}")
    if live is not None and (live.dtype != torch.int64
                             or live.shape != (n // _TILE_LANES,)):
        raise ValueError(f"{name}: live must be int64 ({n // _TILE_LANES},)")
    if not _on_cuda(name, peq, targets, lo, hi, prow, trow,
                    *([] if live is None else [live])):
        return hw_adaptive_plain(peq, targets, lo, hi, prow, trow, k, hin0,
                                 group, strong_every, live)
    dev = peq.device
    out = _lane_outputs(n, dev, 3)
    if n == 0:
        return tuple(out)
    chosen = _adaptive_admitted(dev, nw, s1, cluster)
    classes = torch.tensor(adaptive_classes(nw), dtype=_I32, device=dev)
    scratch = torch.empty(3 * nw * n if chosen["form"] == "scratch" else 1,
                          dtype=_I32, device=dev)
    words = _plan_words(chosen)
    _launch(name, "myers_hw_adaptive", dev.index, peq.data_ptr(), s1, nw,
            targets.data_ptr(), targets.shape[1],
            *_ptrs(lo, hi, prow, trow), n, int(k), int(hin0), int(group),
            int(strong_every), classes.data_ptr(), classes.shape[0],
            *_ptrs(*out), None if live is None else live.data_ptr(),
            scratch.data_ptr(), ctypes.addressof(words), _stream(dev))
    if plan is not None:
        plan.clear()
        plan.update(chosen, blocks=n // _TILE_LANES * chosen["cluster"])
    return tuple(out)


def _check_stream(name, eq_t) -> None:
    _check(name, eq_t, "eq_t", 3)
    if eq_t.shape[1] < 1:
        raise ValueError(f"{name}: eq_t {tuple(eq_t.shape)} has no words")


def reduce_eqstream(eq_t, lo, hi, hin0: int, *, plan=None):
    """reduce_lanes on Eq words gathered before the launch (kernel
    reduce_eqstream).

    eq_t: int32 (T, NW, B), lane b's Eq word w of column c at [c, w, b]
    (eqstream_gather(...).permute(1, 2, 0)); lo, hi: int32 (B,).  Returns
    (best, pfirst, plast, last) int32 (B,) over columns [lo, hi), as
    reduce_lanes.  At 2-8 words and T > 0 the kernel runs the word-parallel
    lane (reduce_eqstream_words_plain), else one thread a lane; a dict
    `plan` receives what it launched (sweep_scores; checks only)."""
    name = "reduce_eqstream"
    _check_stream(name, eq_t)
    n = _check_lanes(name, dict(lo=lo, hi=hi))
    if n != eq_t.shape[2]:
        raise ValueError(f"{name}: eq_t has {eq_t.shape[2]} lanes, lo {n}")
    if not _on_cuda(name, eq_t, lo, hi):
        return reduce_eqstream_plain(eq_t, lo, hi, hin0)
    T, nw = eq_t.shape[0], eq_t.shape[1]
    dev = eq_t.device
    out = _lane_outputs(n, dev)
    if n == 0:
        return tuple(out)
    buf = _plan_buffer()
    _launch(name, "myers_reduce_eqstream", dev.index, eq_t.data_ptr(), nw, T,
            *_ptrs(lo, hi), n, int(hin0), *_ptrs(*out),
            _scratch(nw, n, dev).data_ptr(), ctypes.addressof(buf),
            _stream(dev))
    _fill_plan(plan, buf)
    return tuple(out)


def hits_eqstream(eq_t, lo, hi, best, hin0: int, *, plan=None):
    """hits_lanes on a gathered Eq stream (kernel hits_eqstream): operands as
    reduce_eqstream plus best int32 (B,); output as hits_lanes.  At 2-8
    words the kernel runs the word-parallel lane (hits_words_plain); a dict
    `plan` receives what it launched (sweep_scores; checks only)."""
    name = "hits_eqstream"
    _check_stream(name, eq_t)
    n = _check_lanes(name, dict(lo=lo, hi=hi, best=best))
    if n != eq_t.shape[2]:
        raise ValueError(f"{name}: eq_t has {eq_t.shape[2]} lanes, lo {n}")
    if not _on_cuda(name, eq_t, lo, hi, best):
        return hits_eqstream_plain(eq_t, lo, hi, best, hin0)
    T, nw = eq_t.shape[0], eq_t.shape[1]
    dev = eq_t.device
    hits = _hit_output(n, T, dev)
    if n == 0:
        return hits
    buf = _plan_buffer()
    _launch(name, "myers_hits_eqstream", dev.index, eq_t.data_ptr(), nw, T,
            *_ptrs(lo, hi), n, int(hin0), best.data_ptr(), hits.data_ptr(),
            hits.shape[1], _scratch(nw, n, dev).data_ptr(),
            ctypes.addressof(buf), _stream(dev))
    _fill_plan(plan, buf)
    return hits


def _check_wavefront(name, t, peq, state, d_base: int, n_steps: int,
                     n_words: int, t_scan: int) -> None:
    _check(name, t, "t", 1)
    _check(name, peq, "peq", 2)
    _check(name, state, "state", 2)
    ns = state.shape[1]
    if state.shape[0] != WF_PLANES or ns < 1:
        raise ValueError(f"{name}: state must be ({WF_PLANES}, slots), got "
                         f"{tuple(state.shape)}")
    if not 1 <= n_words <= peq.shape[1] or not 1 <= t_scan <= t.shape[0]:
        raise ValueError(f"{name}: n_words={n_words} / t_scan={t_scan} "
                         f"outside peq {tuple(peq.shape)} / t "
                         f"{tuple(t.shape)}")
    # The kernels hand scores on packed as score << 2 | hout bits.
    if (n_words + ns + 1) * WORD_SIZE + t_scan >= 1 << 29:
        raise ValueError(f"{name}: {n_words} words and {t_scan} columns "
                         "exceed the kernels' score range")
    if n_steps < 0 or d_base < 0 or d_base + n_steps >= 1 << 31:
        raise ValueError(f"{name}: steps [{d_base}, {d_base + n_steps}) "
                         "outside [0, 2^31)")


_WF_CAPACITY = {}


def _wf_capacity(dev, s1: int, ring: int) -> int:
    """Warp groups one launch of the group kernel keeps resident on the
    card (every block at once), for s1 profile rows and a ring of `ring`
    tiles."""
    key = (dev.index, s1, ring)
    if key not in _WF_CAPACITY:
        lib = _build.load()
        groups = ctypes.c_int(0)
        _build.check(lib, lib.myers_wavefront_capacity(
            dev.index, s1, ring, ctypes.byref(groups)), "wavefront")
        _WF_CAPACITY[key] = groups.value
    return _WF_CAPACITY[key]


def _wf_scratch_words(n_cores: int, n_groups: int, ring: int) -> int:
    """int32 words of a group launch's zeroed scratch (csrc/wavefront.cu
    GroupScratch): each link's ring of 16-byte records, each link's
    consumed count, and the task counter."""
    links = n_cores * n_groups
    return links * ring * 4 + links + 1


def wavefront(t, peq, state, d_base: int, n_steps: int, n_words: int,
              t_scan: int, hin0: int, col_lo: int, col_hi: int, word0: int,
              emit_stream: bool, *, core=None, ring=None, pass_groups=None):
    """n_steps wavefront steps of one pair from absolute step d_base over
    the fixed word window [word0, word0 + NS) (kernel wavefront).

    t: int32 (>= t_scan,) scan-column symbols; peq: int32 (S1, >= n_words)
    profile bit words; state: int32 (7, NS) (layout above).  Only words
    < n_words and columns in [0, t_scan) advance; the bottom word n_words-1
    keeps its running (min, first argmin) over columns [col_lo, col_hi).
    Returns (new state, stream): stream int32 (n_steps,) holds the bottom
    word's score after each step (None unless emit_stream; _BIG where the
    bottom word is outside the window).  The input state is not changed.

    The kernel runs warp groups linked by per-tile records
    (wavefront_groups_plain), in passes where the window holds more groups
    than one launch keeps resident (a launch each), and in HW from step 0
    over column cores (wavefront_core; such a call must start from
    initial_state).  core, ring and pass_groups force the core length, the
    ring's depth in tiles and the groups a pass holds, for checks only."""
    name = "wavefront"
    _check_wavefront(name, t, peq, state, d_base, n_steps, n_words, t_scan)
    ring = _check_ring(name, ring)
    dev = state.device
    if not _on_cuda(name, t, peq, state):
        return wavefront_plain(t, peq, state, d_base, n_steps, n_words,
                               t_scan, hin0, col_lo, col_hi, word0,
                               emit_stream)
    out = state.clone()
    stream = _wavefront_stream(n_steps, emit_stream, dev)
    ns = state.shape[1]
    real = min(ns, n_words - word0)
    if not n_steps:
        return out, stream
    out[2:4, max(real, 0):] = 0
    if real <= 0:
        return out, stream
    s1 = peq.shape[0]
    G = -(-real // WF_GROUP)
    cap = _wf_capacity(dev, s1, ring)
    if pass_groups is not None:
        cap = max(1, min(cap, int(pass_groups)))
    clen = (t_scan if G > cap else
            wavefront_core(ns, n_words, t_scan, d_base, hin0, word0, core))
    K = -(-t_scan // clen)
    bottom = n_words - 1 - word0
    key = None
    if col_hi > col_lo and 0 <= bottom < ns:
        key = ((state[5, bottom:bottom + 1].long() << 32)
               | (state[6, bottom:bottom + 1].long() & 0xFFFFFFFF))
    n_tiles = -(-n_steps // WF_TILE)
    top = None
    for g_lo in range(0, G, cap):
        n = min(cap, G - g_lo)
        scratch = torch.zeros(_wf_scratch_words(K, n, ring), dtype=_I32,
                              device=dev)
        below = (torch.zeros(4 * n_tiles, dtype=_I32, device=dev)
                 if g_lo + n < G else None)
        _launch(name, "myers_wavefront", dev.index, t.data_ptr(),
                peq.data_ptr(), peq.shape[1], s1, state.data_ptr(),
                out.data_ptr(), int(d_base), int(n_steps), ns, int(n_words),
                int(t_scan), int(hin0), int(col_lo), int(col_hi), int(word0),
                None if stream is None else stream.data_ptr(),
                None if key is None else key.data_ptr(), g_lo, n, K, clen,
                split_halo(n_words), scratch.data_ptr(), ring,
                None if top is None else top.data_ptr(),
                None if below is None else below.data_ptr(), _stream(dev))
        top = below
    if key is not None:
        w = key.view(_I32)                   # (low, high): see _unpack_keys
        out[5, bottom] = w[1]
        out[6, bottom] = w[0]
    return out, stream


def tile_symbols(t, t_scan: int) -> torch.Tensor:
    """The scan columns as 16-bit symbols padded with zeros to whole tiles
    (int16 (n_tiles * WF_TILE,); symbols are < 2^15): a tile is 64 bytes,
    four vector loads of the tile kernel.  A caller that runs many
    wavefront_banded segments over one target makes it once (tiled=)."""
    n_tiles = -(-t_scan // WF_TILE)
    tt = torch.zeros(n_tiles * WF_TILE, dtype=torch.int16, device=t.device)
    tt[:t_scan] = t[:t_scan]
    return tt


def wavefront_banded(t, peq, state, d_base: int, n_steps: int, n_words: int,
                     t_scan: int, lo: int, col_lo: int, col_hi: int, *,
                     tiled=None, form=None):
    """n_steps banded wavefront steps from absolute step d_base (kernel
    wavefront_banded): the window of NS word slots has its top word at
    wavefront_base(d, lo, max(0, n_words - NS)) and slides as that
    advances; its top word takes hin +1.  Operands as wavefront; returns
    the new state (exact wherever a value is <= the band's k).  The kernel
    runs the tile schedule or a step a barrier by wavefront_banded_form;
    `form` forces one ("tiles" up to 4,096 slots, or "steps"), for checks
    only.  tiled: tile_symbols(t, t_scan), where the caller made it."""
    name = "wavefront_banded"
    _check_wavefront(name, t, peq, state, d_base, n_steps, n_words, t_scan)
    ns = state.shape[1]
    if form not in (None, "tiles", "steps") or (
            form == "tiles" and ns > _WF_TILES_MAX_SLOTS):
        raise ValueError(f"{name}: no {form!r} form at {ns} slots")
    if not _on_cuda(name, t, peq, state):
        return wavefront_banded_plain(t, peq, state, d_base, n_steps,
                                      n_words, t_scan, lo, col_lo, col_hi)
    dev = state.device
    out = state.clone()
    if n_steps:
        tiles = (form or wavefront_banded_form(ns, n_steps)) == "tiles"
        hand = torch.empty(0 if tiles else 2 * ns, dtype=_I32, device=dev)
        if tiles:
            t = tile_symbols(t, t_scan) if tiled is None else tiled
        _launch(name, "myers_wavefront_banded", dev.index, t.data_ptr(),
                peq.data_ptr(), peq.shape[1], out.data_ptr(),
                hand.data_ptr(), int(d_base), int(n_steps), ns,
                int(n_words), int(t_scan), int(lo), int(col_lo),
                int(col_hi), int(tiles), peq.shape[0], _stream(dev))
    return out


KERNELS = (reduce_lanes, reduce_bitplane, sweep_shared, hits_lanes,
           hits_bitplane, nw_banded, shw_banded, shw_banded_hits, capture,
           wavefront, wavefront_banded, sweep_scores, reduce_eqstream,
           hits_eqstream, reduce_resume, sweep_scores_resume, hw_adaptive)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# The JAX package's flat signatures (one profile row and one target row per
# lane, or one shared target), for callers and tests that hold per-lane
# operands.
# ---------------------------------------------------------------------------


def _identity_rows(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=dev)


def _pad_cols(targets: torch.Tensor, fill: int, chunk: int):
    """Targets padded with ``fill`` to the JAX wrappers' chunk grain, so a
    window reaching past T scans the same filler columns there and here."""
    T = targets.shape[1]
    Tp = -(-T // chunk) * chunk
    if Tp == T:
        return targets
    pad = targets.new_full((targets.shape[0], Tp - T), fill)
    return torch.cat([targets, pad], 1)


def reduce_flat_device(peq, targets, lo, hi, hin0: int, chunk: int = 256,
                       want_hits: bool = False):
    """pallas_kernel.reduce_flat_device: peq (B, S1, NW), targets (B, T),
    lo/hi (B,) -> (best, pfirst, plast, last) (B,) int32, plus the hit
    words int32 (B, ceil(T/32)) at best when want_hits."""
    rows = _identity_rows(lo.shape[0], lo.device)
    tg = _pad_cols(targets, peq.shape[1] - 1, chunk)
    out = reduce_lanes(peq, tg, lo, hi, rows, rows, hin0)
    if not want_hits:
        return out
    hits = hits_lanes(peq, tg, lo, hi, rows, rows, out[0], hin0)
    return out + (hits[:, :-(-targets.shape[1] // WORD_SIZE)],)


def reduce_flat_device_bitplane(q_alts, pad_words, targets, lo, hi,
                                hin0: int, sigma: int, chunk: int = 256,
                                want_hits: bool = False):
    """pallas_kernel.reduce_flat_device_bitplane: q_alts int32 (B, E, R)
    alternative ids per query row (sentinel where none), pad_words (B, NW),
    targets (B, T) in [0, sigma] with sigma the wildcard.  Returns as
    reduce_flat_device."""
    nb = bitplane_nb(sigma)
    rows = _identity_rows(lo.shape[0], lo.device)
    planes = bitplane_planes(q_alts, nb)
    tg = _pad_cols(targets, sigma, chunk)
    args = (planes, pad_words, tg, lo, hi, rows, rows)
    out = reduce_bitplane(*args, hin0, nb, q_alts.shape[1], sigma)
    if not want_hits:
        return out
    hits = hits_bitplane(*args, out[0], hin0, nb, q_alts.shape[1], sigma)
    return out + (hits[:, :-(-targets.shape[1] // WORD_SIZE)],)


def reduce_flat_device_eqstream(peq, targets, lo, hi, hin0: int,
                                chunk: int = 128, want_hits: bool = False):
    """pallas_kernel.reduce_flat_device_eqstream: peq (B, S1, NW) of any
    S1, targets (B, T) in [0, S1), lo/hi (B,); the Eq stream gathered once
    (eqstream_gather) for the reduce and the hits kernel.  Returns as
    reduce_flat_device.  chunk is accepted for the JAX signature: it sized
    the TPU's column blocks and changes nothing here."""
    del chunk
    eq_t = eqstream_gather(peq, targets).permute(1, 2, 0)
    out = reduce_eqstream(eq_t, lo, hi, hin0)
    if not want_hits:
        return out
    return out + (hits_eqstream(eq_t, lo, hi, out[0], hin0),)


def sweep_flat_device(peq, targets, hin0: int):
    """PallasSweeper.sweep on flat operands: peq (B, S1, NW), targets (B, T)
    one row per lane -> int32 (B, T) score streams (a lane-minor view)."""
    rows = _identity_rows(peq.shape[0], peq.device)
    return sweep_scores(peq, targets, rows, rows, hin0)


def _shared_row(target_scan, fill_sym: int, chunk: int):
    """One shared target (L,) padded with fill_sym to whole chunks, as a
    single target row (1, Lp)."""
    L = target_scan.shape[0]
    tg = target_scan.new_full((1, -(-L // chunk) * chunk), fill_sym)
    tg[0, :L] = target_scan
    return tg


def reduce_flat_device_shared(peq, target_scan, lo, hi, hin0: int,
                              fill_sym: int, chunk: int = 256):
    """pallas_kernel.reduce_flat_device_shared: every lane against the one
    target_scan (L,), padded with fill_sym to whole chunks; returns (best,
    pfirst, plast, last) (B,) int32 as reduce_lanes."""
    B = lo.shape[0]
    return reduce_lanes(peq, _shared_row(target_scan, fill_sym, chunk), lo,
                        hi, _identity_rows(B, lo.device),
                        torch.zeros(B, dtype=_I32, device=lo.device), hin0)


def hits_flat_device_shared(peq, target_scan, lo, hi, best, hin0: int,
                            fill_sym: int, chunk: int = 256):
    """pallas_kernel.hits_flat_device_shared: every lane against the one
    target_scan (L,), padded with fill_sym to whole chunks; returns the hit
    words int32 (B, ceil(L/chunk) * chunk / 32)."""
    B = lo.shape[0]
    return hits_lanes(peq, _shared_row(target_scan, fill_sym, chunk), lo, hi,
                      _identity_rows(B, lo.device),
                      torch.zeros(B, dtype=_I32, device=lo.device), best,
                      hin0)


def nw_banded_flat_device(peq, targets, hi, d_lo: int, d_hi: int,
                          chunk: int = 256):
    """pallas_kernel.nw_banded_flat_device: banded NW scores (B,) int32 for
    live diagonals [d_lo, d_hi], with the JAX package's band schedule."""
    n_chunks = -(-targets.shape[1] // chunk)
    woff, n_win = nw_band_schedule(peq.shape[2], n_chunks, chunk, d_lo, d_hi)
    rows = _identity_rows(hi.shape[0], hi.device)
    return nw_banded(peq, _pad_cols(targets, peq.shape[1] - 1, chunk),
                     torch.from_numpy(woff).to(hi.device), hi, rows, rows,
                     n_win, chunk)


def sweep_best_shared(peq, target, hin0: int, col_lo: int, col_hi: int):
    """pallas_kernel.sweep_best_pallas_shared on flat operands: peq
    (B, S1, NW), target (n_cols,) -> (best, pos) (B,) int32, pos a scan
    column (-1 when no column of the window was seen)."""
    return sweep_shared(peq.permute(1, 2, 0).contiguous(), target, hin0,
                        col_lo, col_hi)


def capture_flat_device(peq, targets, hin0: int, chunk: int = 128,
                        want_h: bool = False):
    """pallas_kernel.capture_flat_device: peq (B, S1, NW), targets (B, T)
    per-lane windows, padded here with the wildcard S1-1 to Tp = T rounded
    up to chunk.  Returns (pv, mv), with want_h also (ph, mh), each int32
    (B, Tp, NW) holding the JAX wrapper's uint32 words."""
    return capture(peq, _pad_cols(targets, peq.shape[1] - 1, chunk), hin0,
                   want_h)


def reduce_resumable_flat_device(peq, targets, lo, hi, pv0, mv0, s0,
                                 hin0: int):
    """pallas_kernel.reduce_resumable_flat_device on flat operands: peq
    (B, S1, NW), targets (B, T) one row per lane or (T,) one shared row,
    lo/hi (B,) windows in this segment's columns, the carried state pv0,
    mv0 (B, NW) and s0 (B,).  Returns (best, pfirst, plast, last, pv, mv,
    s).  Exactly the segment's T columns are swept, so T need not be a
    multiple of the TPU wrapper's chunk."""
    n = lo.shape[0]
    rows = _identity_rows(n, lo.device)
    if targets.dim() == 1:
        targets = targets[None]
        trow = torch.zeros(n, dtype=_I32, device=lo.device)
    else:
        trow = rows
    return reduce_resume(peq, targets, lo, hi, rows, trow, pv0, mv0, s0,
                         hin0)


def hw_adaptive_padded(peq, targets, lo, hi, prow, trow, k: int, hin0: int,
                       group: int = 8, strong_every: int = 64):
    """hw_adaptive on any number of lanes: padded to whole tiles of 1,024
    as PallasSweeper.pack_peq and pack_lanes pad them (all-ones profiles,
    lo = hi = 0; the pads take part in their tile's band), outputs for the
    given lanes only."""
    n = lo.shape[0]
    n_pad = -(-n // _TILE_LANES) * _TILE_LANES - n
    if n_pad:
        dev = lo.device
        ones = torch.full((1,) + tuple(peq.shape[1:]), -1, dtype=_I32,
                          device=dev)
        peq = torch.cat([peq, ones])
        zeros = torch.zeros(n_pad, dtype=_I32, device=dev)
        lo, hi = torch.cat([lo, zeros]), torch.cat([hi, zeros])
        prow = torch.cat([prow, zeros + (peq.shape[0] - 1)])
        trow = torch.cat([trow, zeros])
    out = hw_adaptive(peq, targets, lo, hi, prow, trow, k, hin0, group,
                      strong_every)
    return tuple(o[:n] for o in out)
