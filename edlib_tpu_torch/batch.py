"""Batched alignment on the card: the port of edlib_tpu/batch.py.

Pairs are bucketed by shape (power-of-two word count and scan length), each
bucket's profiles and targets go to the card in one piece, and the sweep
kernels (ops/cuda_kernel.py, driven per bucket by ops/sweeper.py) return
per-lane reductions and hit masks.  Post-processing follows the same
location rules as the single-pair orchestrator, so the results equal
edlib_tpu.align_batch field for field.

Routes, as the JAX package takes them with a device:

* NW: the banded NW kernel with a bucket-level k-doubling ladder for
  buckets of >= EDLIB_TPU_BAND_MIN_WORDS (8) words; smaller buckets read the
  final column from the full reduce.
* HW/SHW: the reduce, then (for all minimal end locations) the hit mask at
  the found best.  SHW buckets of >= EDLIB_TPU_BAND_MIN_WORDS words take the
  banded SHW kernels under a k-doubling ladder.  Buckets whose pairs share
  one target object read that one target row.
* Per-lane buckets with sigma >= 32 (or past the per-lane kernels' 64-row
  alphabet cap) take the bit-plane kernels, unless EDLIB_TPU_BITPLANE=0.
  A bucket past the cap that the bit-plane kernels do not take (dense
  equalities, or a profile past their routing budget, as any query past
  65,536 bp) takes the eq-stream kernels on Eq words gathered per column
  where the JAX package's footprint test passes
  (EDLIB_TPU_EQSTREAM_MAX_MB), else the score-stream kernel, summarised on
  the device.  No single-card route raises.
* HW start locations: every (pair, end location) reversed-SHW re-run goes
  into one more bucketed reduce.
* Under mesh= (a parallel.DeviceGrid), as the JAX package routes under its
  mesh: NW skips the banded route and SHW the banded ladder; a shared-target
  HW bucket goes sequence-parallel (halo slices over "sp", the minima merged
  over the grid, its `last` the sentinel), every other bucket data-parallel
  over the whole grid (_run_bucket_mesh).
* PATH: the window of the first location pair of every pair within k is
  reconstructed.  Windows the JAX package sends to its device route (at
  most max_cells() DP cells, int16-sized, sigma+1 within the per-lane
  kernels' cap) take the column-capture kernel and the batched decode and
  walk (path/batched.py), in a batch of any size; every other window takes
  the host walker or Hirschberg (path/hirschberg.py).  The choice is made
  by shape before any launch; path_route_counts() counts both.
"""

from __future__ import annotations

import functools
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from edlib_tpu_torch import encode
from edlib_tpu_torch.align import _neg1_candidate_exists, align
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops.sweeper import Sweeper, decode_hit_words
from edlib_tpu_torch.path import batched as batched_path
from edlib_tpu_torch.path.hirschberg import obtain_alignment
from edlib_tpu_torch.types import (
    STATUS_OK,
    AlignMode,
    AlignResult,
    AlignTask,
)

_INF = float("inf")
_CHUNK = 256               # the JAX package's scan grain (band schedule)
_BIG_SENTINEL = 0x3FFFFFFF
# PATH windows per route since the last reset: the capture kernel and the
# batched decode and walk on the card, or the host walker / Hirschberg.
_PATH_ROUTES = {"capture": 0, "host": 0}


def path_route_counts() -> dict:
    """{"capture": windows, "host": windows} reconstructed since the last
    reset_path_route_counts()."""
    return dict(_PATH_ROUTES)


def reset_path_route_counts() -> None:
    for name in _PATH_ROUTES:
        _PATH_ROUTES[name] = 0


def _pow2_at_least(x: int, floor: int = 1) -> int:
    n = floor
    while n < x:
        n *= 2
    return n


class GlobalAlphabet:
    """Shared symbol table across a batch (engine ids are mapping-invariant;
    per-pair alphabetLength is computed separately for API parity)."""

    def __init__(self):
        self.letter_idx = np.full(256, -1, dtype=np.int16)
        self.alphabet = bytearray()

    def encode(self, seq: bytes) -> np.ndarray:
        arr = np.frombuffer(seq, dtype=np.uint8)
        unseen = arr[self.letter_idx[arr] < 0]
        if unseen.size:
            # First-appearance order (matches transform_sequences,
            # edlib.cpp:1417-1462) so these ids stay safe to surface.
            uniq, first = np.unique(unseen, return_index=True)
            for c in uniq[np.argsort(first)]:
                self.letter_idx[c] = len(self.alphabet)
                self.alphabet.append(int(c))
        return self.letter_idx[arr].astype(np.int32)

    @property
    def sigma(self) -> int:
        return len(self.alphabet)


class PairSummary:
    """Everything the orchestration needs from one pair's sweep, without the
    O(T) score stream (edlib.cpp:657-693 keeps only this much too)."""

    __slots__ = ("best", "pos_first", "pos_last", "last_score", "positions")

    def __init__(self, best, pos_first, pos_last, last_score, positions):
        self.best = best              # min over real end positions
        self.pos_first = pos_first    # first position attaining it
        self.pos_last = pos_last      # last position attaining it
        self.last_score = last_score  # score at position tlen-1 (NW)
        self.positions = positions    # all minimal positions, or None


def _filter_best_positions(best: int, positions, qlen: int, k_eff
                           ) -> Tuple[int, List[int]]:
    """Same contract as align._filter_locations, from (best, hit list)."""
    overall = int(best)
    if _neg1_candidate_exists(qlen):
        overall = min(overall, qlen)
    if overall > k_eff:
        return -1, []
    out: List[int] = []
    if _neg1_candidate_exists(qlen) and qlen == overall:
        out.append(-1)
    if int(best) == overall:
        out.extend(int(p) for p in positions)
    return overall, out


_BITPLANE_MAX_ALTS = 4


@functools.lru_cache(maxsize=32)
def _bigalpha_plan_cached(sigma: int, eq_key: bytes):
    eqb = np.frombuffer(eq_key, dtype=bool).reshape(sigma, sigma).copy()
    np.fill_diagonal(eqb, True)
    cnt = eqb.sum(1)
    universal = cnt >= sigma
    live = ~universal
    n_alts = int(cnt[live].max()) if live.any() else 1
    if n_alts > _BITPLANE_MAX_ALTS:
        return None
    altset = np.full((sigma, n_alts), -1, np.int32)
    for v in np.nonzero(live)[0]:
        alts = np.nonzero(eqb[v])[0]
        altset[v, :len(alts)] = alts
    return altset, universal, n_alts


def _bigalpha_plan(sigma: int, eq: np.ndarray):
    """Host-side decomposition of the equality matrix for the bit-plane
    kernels: per-symbol alternative-id table, universal-row mask (rows
    matching everything ride the packed pad mask), and the alternative
    count E.  None when some non-universal row matches more than
    _BITPLANE_MAX_ALTS symbols.  Cached per equality matrix."""
    eqb = np.ascontiguousarray(eq[:sigma, :sigma].astype(bool))
    return _bigalpha_plan_cached(sigma, eqb.tobytes())


def _bigalpha_route(sigma: int, eq: np.ndarray, n_pairs: int, nw_b: int,
                    t_scan: int):
    """The route of a per-lane bucket past the per-lane kernels' alphabet
    cap, as the JAX package picks it (edlib_tpu/batch.py:356-372):
    ("bitplane", plan) when the bit-plane kernels take its equalities,
    ("eqstream", None) when the eq-stream footprint test passes, else
    ("stream", None), the score stream."""
    if os.environ.get("EDLIB_TPU_BITPLANE", "") != "0":
        plan = _bigalpha_plan(sigma, eq)
        if plan is not None and ck.bitplane_ok(nw_b, sigma, plan[2]):
            return "bitplane", plan
    if ck.eqstream_ok(n_pairs, nw_b, t_scan, sigma):
        return "eqstream", None
    return "stream", None


def _bucket_profiles(queries, eq: np.ndarray, sigma: int, nw_b: int,
                     dev) -> torch.Tensor:
    """Query profiles int32 (B, sigma+1, nw_b) on the device, equal to
    encode.build_peq_words of each query: identity profiles built in one
    pass, then each symbol's row ORed with the rows of its equal symbols."""
    B = len(queries)
    qlens = np.fromiter((len(q) for q in queries), np.int32, B)
    q_arr = np.zeros((B, max(int(qlens.max()), 1)), np.int32)
    for row, q in enumerate(queries):
        q_arr[row, :len(q)] = q
    peq = ck.build_peq_device(torch.from_numpy(q_arr).to(dev),
                              torch.from_numpy(qlens).to(dev), sigma, nw_b)
    extra = np.argwhere(eq & ~np.eye(sigma, dtype=bool))
    if len(extra):
        ident = peq.clone()
        for a, b in extra:
            peq[:, a] |= ident[:, b]
    return peq


def _bucket_targets(t_list, sigma: int, t_scan: int) -> np.ndarray:
    targets = np.full((len(t_list), t_scan), sigma, dtype=np.int32)
    for row, t_ids in enumerate(t_list):
        targets[row, :len(t_ids)] = t_ids
    return targets


def _run_bucket_bitplane(idxs, pairs, metas, sigma, plan, nw_b, t_scan,
                         hin0, want_hits, dev) -> List[PairSummary]:
    """One per-lane bucket of any alphabet size through the bit-plane
    kernels: Eq rows rebuilt in the kernel from query-id bit planes."""
    altset, universal, n_alts = plan
    nb = ck.bitplane_nb(sigma)
    sent = (1 << nb) - 1
    R = nw_b * 32
    B = len(idxs)
    q_alts = np.full((B, n_alts, R), sent, np.int32)
    pad_words = np.zeros((B, nw_b), np.uint32)
    row_bit = (np.uint32(1) << (np.arange(R, dtype=np.uint32) % 32))
    for row, i in enumerate(idxs):
        q_ids = pairs[i][0]
        qlen = len(q_ids)
        qv = np.asarray(q_ids, np.int64)
        alts = altset[qv].T                        # (n_alts, qlen)
        q_alts[row, :, :qlen] = np.where(alts >= 0, alts, sent)
        always = np.ones(R, bool)
        always[:qlen] = universal[qv]
        pad_words[row] = np.bitwise_or.reduce(
            np.where(always, row_bit, 0).reshape(nw_b, 32), axis=1)
    targets = _bucket_targets([pairs[i][1] for i in idxs], sigma, t_scan)
    outs = ck.reduce_flat_device_bitplane(
        *(torch.from_numpy(a).to(dev) for a in (
            q_alts, pad_words.view(np.int32), targets)),
        *_bucket_windows(idxs, pairs, metas, dev),
        hin0=hin0, sigma=sigma, chunk=_CHUNK, want_hits=want_hits)
    return _summaries(idxs, metas, outs, want_hits)


def _summaries(idxs, metas, outs, want_hits) -> List[PairSummary]:
    """PairSummary per lane (real position space) from a bucket's
    (best, pfirst, plast, last[, hit words]) in scan-column space."""
    best, pf, pl_, last = (o.cpu().numpy() for o in outs[:4])
    hits = decode_hit_words(outs[4]) if want_hits else None
    out = []
    for row, i in enumerate(idxs):
        w = metas[i][1]
        positions = hits[row] - w if want_hits else None
        out.append(PairSummary(int(best[row]), int(pf[row]) - w,
                               int(pl_[row]) - w, int(last[row]), positions))
    return out


def _bucket_windows(idxs, pairs, metas, dev):
    """Each lane's real end columns [lo, hi) = [W, W + tlen), int32 on
    the device."""
    lo = np.array([metas[i][1] for i in idxs], np.int32)
    hi = lo + np.array([len(pairs[i][1]) for i in idxs], np.int32)
    return torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)


def _run_bucket_eqstream(idxs, pairs, metas, sigma, eq, nw_b, t_scan, hin0,
                         want_hits, dev) -> List[PairSummary]:
    """One per-lane bucket past the alphabet cap through the eq-stream
    kernels: each lane's Eq words gathered per column from its profile, then
    the reduce (and hits) over that stream (edlib_tpu/batch.py:375-411)."""
    peq = _bucket_profiles([pairs[i][0] for i in idxs], eq, sigma, nw_b, dev)
    targets = _bucket_targets([pairs[i][1] for i in idxs], sigma, t_scan)
    lo, hi = _bucket_windows(idxs, pairs, metas, dev)
    outs = ck.reduce_flat_device_eqstream(
        peq, torch.from_numpy(targets).to(dev), lo, hi, hin0=hin0,
        want_hits=want_hits)
    return _summaries(idxs, metas, outs, want_hits)


def _sweep_bucket(q_ids_list, t_ids_list, sigma: int, eq: np.ndarray,
                  n_words: int, t_scan: int, hin0: int, dev) -> torch.Tensor:
    """One shape bucket's score streams, int32 (B, t_scan) on the device
    (edlib_tpu/batch.py:69-82 with _run_sweep :100-116, which takes
    jax_engine past the per-lane cap: here always the stream kernel)."""
    peq = _bucket_profiles(q_ids_list, eq, sigma, n_words, dev)
    targets = _bucket_targets(t_ids_list, sigma, t_scan)
    return Sweeper(dev, _CHUNK).sweep(peq, targets, hin0)


def _summarize_streams(streams: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, want_hits: bool):
    """(best, pfirst, plast, last[, hit words]) of each lane's stream over
    its columns [lo, hi), on the device, as the reduce and hits kernels give
    them: batch._summarize_stream (edlib_tpu/batch.py:134-138) on every
    lane at once.  T must be a multiple of 32 (t_scan is)."""
    T = streams.shape[1]
    cols = torch.arange(T, dtype=torch.int32, device=streams.device)[None, :]
    in_win = (cols >= lo[:, None]) & (cols < hi[:, None])
    best = torch.where(in_win, streams, _BIG_SENTINEL).amin(1)
    hit = in_win & (streams == best[:, None])
    any_hit = hit.any(1)
    pfirst = torch.where(any_hit, torch.where(hit, cols, T).amin(1), -1)
    plast = torch.where(hit, cols, -1).amax(1)
    last = torch.where(
        hi > 0, streams.gather(1, (hi.long() - 1).clamp(0, T - 1)[:, None])
        [:, 0], _BIG_SENTINEL)
    out = tuple(x.to(torch.int32) for x in (best, pfirst, plast, last))
    return out + ((ck._pack_bits(hit),) if want_hits else ())


def _run_bucket_stream(idxs, pairs, metas, sigma, eq, nw_b, t_scan, hin0,
                       want_hits, dev) -> List[PairSummary]:
    """One per-lane bucket through the score-stream kernel, each lane's
    stream summarised over its real columns (edlib_tpu/batch.py:522-530)."""
    streams = _sweep_bucket([pairs[i][0] for i in idxs],
                            [pairs[i][1] for i in idxs], sigma, eq, nw_b,
                            t_scan, hin0, dev)
    lo, hi = _bucket_windows(idxs, pairs, metas, dev)
    return _summaries(idxs, metas,
                      _summarize_streams(streams, lo, hi, want_hits),
                      want_hits)


def _run_bucket_past_cap(idxs, pairs, metas, sigma, eq, nw_b, t_scan, hin0,
                         want_hits, dev) -> List[PairSummary]:
    """A per-lane bucket past the per-lane kernels' alphabet cap, on the
    route _bigalpha_route picks."""
    route, plan = _bigalpha_route(sigma, eq, len(idxs), nw_b, t_scan)
    if route == "bitplane":
        return _run_bucket_bitplane(idxs, pairs, metas, sigma, plan, nw_b,
                                    t_scan, hin0, want_hits, dev)
    run = _run_bucket_eqstream if route == "eqstream" else _run_bucket_stream
    return run(idxs, pairs, metas, sigma, eq, nw_b, t_scan, hin0, want_hits,
               dev)


def _run_bucket_mesh(grid, idxs, pairs, metas, sigma, eq, nw_b, t_scan,
                     hin0, want_hits, shared, dev) -> List[PairSummary]:
    """One bucket on a device grid (edlib_tpu/batch.py:169-247):
    sequence-parallel halo slices of a shared HW target over "sp", the
    locations merged over the grid; data-parallel over the whole grid
    otherwise (parallel/dist.py)."""
    from edlib_tpu_torch.parallel import dist

    queries = [pairs[i][0] for i in idxs]
    ws = np.array([metas[i][1] for i in idxs], np.int32)
    peq = _bucket_profiles(queries, eq, sigma, nw_b, dev)
    if shared and hin0 == 0:
        # Sequence-parallel HW: halo-sliced shared target, the merge over
        # the grid.  The halo is word-aligned so that the core start falls
        # on a hit word (a bigger halo stays exact).
        t_ids = pairs[idxs[0]][1]
        w_max = int(ws.max())
        halo = 2 * max(len(q) for q in queries) - 1
        halo += (-(halo + w_max)) % 32
        null = torch.zeros((len(idxs), 1, nw_b), dtype=torch.int32,
                           device=dev)
        slices, _ = dist.shard_target_slices(np.asarray(t_ids), sigma,
                                             grid.shape["sp"], halo, w_max,
                                             c_multiple=32)
        best, pf, pl_, hits = dist.sharded_hw_locations(
            grid, torch.cat([peq, null], 1), slices, halo, w_max,
            len(t_ids), w_lanes=ws, want_hits=want_hits)
        best, pf, pl_ = (x.cpu().numpy() for x in (best, pf, pl_))
        cols = decode_hit_words(hits) if want_hits else None
        out = []
        for row in range(len(idxs)):
            positions = None
            if want_hits:
                positions = cols[row] + (w_max - ws[row])
                positions = positions[positions < len(t_ids)]
            # Positions come merged (no W shift), and there is no final-
            # column capture: NW never routes here.
            out.append(PairSummary(int(best[row]), int(pf[row]),
                                   int(pl_[row]), _BIG_SENTINEL, positions))
        return out
    # Data-parallel: per-pair targets, or a mode other than HW.
    targets = _bucket_targets([pairs[i][1] for i in idxs], sigma, t_scan)
    hi = ws + np.array([len(pairs[i][1]) for i in idxs], np.int32)
    outs = dist.sharded_reduce_dp(grid, peq, targets, ws, hi, hin0,
                                  want_hits=want_hits)
    return _summaries(idxs, metas, outs, want_hits)


def _shw_banded_bucket(sweeper, peq, targets, lo, hi, kb, k_user,
                       want_hits, shared):
    """Banded SHW bucket: k-doubling ladder over the sliding-window
    kernel, capped at the per-lane guaranteed bounds kb (>= each lane's
    true best, so the capped run always completes every lane within the
    k_user cutoff) — the device counterpart of the reference's SHW under
    the doubling loop (edlib.cpp:58-78 banding + 154-160 boundaries).

    Returns (best, pos_first, pos_last, positions) per lane, scan-column
    space; not-found lanes (true best > k_user) report _BIG_SENTINEL /
    empty positions.
    """
    B = len(kb)
    k_lim = max(int(kb.max(initial=1)), 1)
    if k_user >= 0:
        k_lim = min(k_lim, max(int(k_user), 1))
    best = np.full(B, _BIG_SENTINEL, np.int64)
    pf = np.full(B, -1, np.int64)
    pl_ = np.full(B, -1, np.int64)
    done = np.zeros(B, bool)
    k_cur = min(64, k_lim)
    while True:
        rb, rf, rl = sweeper.reduce_shw_banded(peq, targets, lo, hi, k_cur,
                                               shared=shared)
        newly = ~done & (rb[:B] <= k_cur)
        best[newly] = rb[:B][newly]
        pf[newly] = rf[:B][newly]
        pl_[newly] = rl[:B][newly]
        done |= newly
        if done.all() or k_cur >= k_lim:
            break
        k_cur = min(k_cur * 2, k_lim)
        if 2 * k_cur >= peq.shape[2] * 32:
            # The next window would span every word: go straight to the
            # guaranteed cap (one final rung instead of log2 full-width
            # rungs).
            k_cur = k_lim
    positions: List[Optional[np.ndarray]] = [None] * B
    if want_hits:
        if done.any():
            # All minimal cells of a found lane lie within +-best of the
            # diagonal, so one hits pass at the found maximum covers all.
            k_h = max(int(best[done].max()), 1)
            bb = np.full(peq.shape[0], -(1 << 30), np.int64)
            bb[:B][done] = best[done]
            hits = sweeper.hits_shw_banded(peq, targets, lo, hi, bb, k_h,
                                           shared=shared)
            for b in range(B):
                positions[b] = hits[b] if done[b] \
                    else np.empty(0, np.int64)
        else:
            positions = [np.empty(0, np.int64) for _ in range(B)]
    return best, pf, pl_, positions


def _buckets(pairs):
    """{(nw_b, t_scan): pair indices} and per-pair (nw_b, W, t_scan)."""
    buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    metas = []
    for i, (q_ids, t_ids) in enumerate(pairs):
        nw_b = _pow2_at_least(encode.num_words(len(q_ids)))
        w = nw_b * 32 - len(q_ids)
        t_scan = _pow2_at_least(len(t_ids) + w, floor=32)
        buckets[(nw_b, t_scan)].append(i)
        metas.append((nw_b, w, t_scan))
    return buckets, metas


def _is_shared(pairs, idxs) -> bool:
    return (len(idxs) > 1
            and all(pairs[i][1] is pairs[idxs[0]][1] for i in idxs))


def _run_bucketed_summary(pairs: List[Tuple[np.ndarray, np.ndarray]],
                          sigma: int, eq: np.ndarray, hin0: int,
                          want_hits: bool, dev, shw_kb=None,
                          k_user: int = -1, mesh=None) -> List[PairSummary]:
    """Bucketed sweeps returning per-pair summaries (real position space):
    a reduction pass, plus (only when the all-minimal-locations list is
    needed) a packed hit-mask pass.  Buckets whose pairs all share one
    target object read that one target.  Under a device grid (mesh) every
    bucket takes _run_bucket_mesh."""
    buckets, metas = _buckets(pairs)
    out: List[Optional[PairSummary]] = [None] * len(pairs)
    for (nw_b, t_scan), idxs in buckets.items():
        shared = _is_shared(pairs, idxs)
        if mesh is not None:
            for i, summ in zip(idxs, _run_bucket_mesh(
                    mesh, idxs, pairs, metas, sigma, eq, nw_b, t_scan, hin0,
                    want_hits, shared, dev)):
                out[i] = summ
            continue
        if not (shared or sigma + 1 <= ck.max_sigma1(nw_b, False)):
            for i, summ in zip(idxs, _run_bucket_past_cap(
                    idxs, pairs, metas, sigma, eq, nw_b, t_scan, hin0,
                    want_hits, dev)):
                out[i] = summ
            continue
        use_band = (shw_kb is not None and hin0 == 1
                    and nw_b >= _band_min_words())
        if (not shared and not use_band and sigma >= 32
                and os.environ.get("EDLIB_TPU_BITPLANE", "") != "0"):
            # Mid-size alphabets take the bit-plane kernels, as the JAX
            # package routes them.
            plan = _bigalpha_plan(sigma, eq)
            if plan is not None and ck.bitplane_ok(nw_b, sigma, plan[2]):
                for i, summ in zip(idxs, _run_bucket_bitplane(
                        idxs, pairs, metas, sigma, plan, nw_b, t_scan,
                        hin0, want_hits, dev)):
                    out[i] = summ
                continue
        peq = _bucket_profiles([pairs[i][0] for i in idxs], eq, sigma, nw_b,
                               dev)
        lo = np.array([metas[i][1] for i in idxs], np.int64)
        hi = lo + np.array([len(pairs[i][1]) for i in idxs], np.int64)
        if shared:
            targets = pairs[idxs[0]][1]
        else:
            targets = _bucket_targets([pairs[i][1] for i in idxs], sigma,
                                      t_scan)
        sweeper = Sweeper(dev, _CHUNK)
        if use_band:
            kb = np.array([shw_kb[i] for i in idxs], np.int64)
            bbest, bpf, bpl, bpos = _shw_banded_bucket(
                sweeper, peq, targets, lo, hi, kb, k_user, want_hits,
                shared)
            for row, i in enumerate(idxs):
                w = metas[i][1]
                positions = bpos[row] - w if want_hits else None
                out[i] = PairSummary(int(bbest[row]), int(bpf[row]) - w,
                                     int(bpl[row]) - w, _BIG_SENTINEL,
                                     positions)
            continue
        best, pf, pl_, last = sweeper.reduce(peq, targets, lo, hi, hin0,
                                             shared=shared)
        if want_hits:
            hit_cols = sweeper.hits(peq, targets, lo, hi, best, hin0,
                                    shared=shared)
        for row, i in enumerate(idxs):
            w = metas[i][1]
            positions = hit_cols[row] - w if want_hits else None
            out[i] = PairSummary(int(best[row]), int(pf[row]) - w,
                                 int(pl_[row]) - w, int(last[row]),
                                 positions)
    return out


_NW_BAND_MIN_WORDS = 8  # band pruning pays only for multi-word queries


def _band_min_words() -> int:
    """Minimum bucket word count for the banded kernels
    (EDLIB_TPU_BAND_MIN_WORDS, as in the JAX package)."""
    return int(os.environ.get("EDLIB_TPU_BAND_MIN_WORDS",
                              _NW_BAND_MIN_WORDS))


def _run_bucketed_nw_banded(pairs: List[Tuple[np.ndarray, np.ndarray]],
                            sigma: int, eq: np.ndarray, k_user: int,
                            dev) -> np.ndarray:
    """Batched banded NW distances with bucket-level k-doubling.

    Returns (len(pairs),) int64: the exact distance where it is <= k_user
    (always found when k_user < 0), else -1.  Each doubling reruns the
    bucket with a wider static diagonal band; banded results > the current
    k are discarded as unreliable (edlib.cpp:58-78 + 796-870).  Buckets too
    small to band read the final column from the full reduce.
    """
    out = np.full(len(pairs), -1, np.int64)
    buckets, metas = _buckets(pairs)
    for (nw_b, t_scan), idxs in buckets.items():
        shared = _is_shared(pairs, idxs)
        if not (shared or sigma + 1 <= ck.max_sigma1(nw_b, False)):
            # Full-sweep NW distance: the final column of the bit-plane or
            # eq-stream reduce, or of the score stream.
            summs = _run_bucket_past_cap(idxs, pairs, metas, sigma, eq, nw_b,
                                         t_scan, 1, False, dev)
            for row, i in enumerate(idxs):
                out[i] = int(summs[row].last_score)
            continue

        B = len(idxs)
        peq = _bucket_profiles([pairs[i][0] for i in idxs], eq, sigma, nw_b,
                               dev)
        hi = np.array([metas[i][1] + len(pairs[i][1]) for i in idxs],
                      np.int64)
        D = np.array([len(pairs[i][0]) - len(pairs[i][1]) for i in idxs],
                     np.int64)
        cap = max(max(len(pairs[i][0]), len(pairs[i][1])) for i in idxs)
        if shared:
            targets = pairs[idxs[0]][1]
        else:
            targets = _bucket_targets([pairs[i][1] for i in idxs], sigma,
                                      t_scan)
        sweeper = Sweeper(dev, _CHUNK)

        if nw_b < _band_min_words():
            lo = np.maximum(hi - 1, 0)
            _, _, _, last = sweeper.reduce(peq, targets, lo, hi, 1,
                                           shared=shared)
            for row, i in enumerate(idxs):
                out[i] = int(last[row])
            continue

        k_lim = cap if k_user < 0 else min(k_user, cap)
        # Hamming cap: the bucket ladder at max over lanes of the bound
        # finishes every lane (encode.nw_upper_bound).
        hb_max = max(max((encode.nw_upper_bound(pairs[i][0], pairs[i][1],
                                                eq) for i in idxs),
                         default=1), 1)
        k_lim = min(k_lim, hb_max)
        k_cur = min(max(64, int(np.abs(D).min(initial=0))), k_lim)
        done = np.zeros(B, bool)
        while True:
            feas = ~done & (np.abs(D) <= k_cur)
            if feas.any():
                # ceil((D-k)/2) / floor((D+k)/2) over the feasible lanes
                d_lo = int(np.min(-((k_cur - D[feas]) // 2)))
                d_hi = int(np.max((D[feas] + k_cur) // 2))
                rl = sweeper.reduce_nw_banded(peq, targets, hi, d_lo, d_hi,
                                              shared=shared)
                newly = feas & (rl <= k_cur)
                for row in np.nonzero(newly)[0]:
                    out[idxs[row]] = int(rl[row])
                done |= newly
            if done.all() or k_cur >= k_lim:
                break
            k_cur = min(k_cur * 2, k_lim)
    if k_user >= 0:
        # The hamming cap can complete lanes whose distance exceeds the
        # user k; keep the documented <=k_user-or-minus-1 contract.
        out[out > k_user] = -1
    return out


def align_batch_device(queries, targets, mode="NW", task="distance", k=-1,
                       additionalEqualities=None, device=None,
                       mesh=None) -> List[dict]:
    """edlib_tpu.batch.align_batch_device on `device` (a torch.device: the
    card, or the CPU for the plain versions), the sweeps sharded over the
    device grid `mesh` when one is given."""
    mode = AlignMode.parse(mode)
    task = AlignTask.parse(task)
    if k is None:
        k = -1

    # The device path needs a consistent byte space across the batch; fall
    # back to per-pair align (each again a batch of one) for exotic
    # hashable alphabets.
    try:
        byte_pairs = []
        eq_pairs = None
        map_cache: Dict[int, bytes] = {}

        def to_bytes(s):
            got = map_cache.get(id(s))
            if got is None:
                got = map_cache[id(s)] = encode._map_ascii(s)
            return got

        for q, t in zip(queries, targets):
            byte_pairs.append((to_bytes(q), to_bytes(t)))
        if additionalEqualities is not None:
            eq_pairs = [(encode._eq_symbol_to_byte(a),
                         encode._eq_symbol_to_byte(b))
                        for a, b in additionalEqualities]
    except encode.NeedsAlphabetMapping:
        return [align(q, t, mode=mode, task=task, k=k,
                      additionalEqualities=additionalEqualities,
                      device=device)
                for q, t in zip(queries, targets)]

    glob = GlobalAlphabet()
    # Encode each distinct object once: broadcast targets share one id
    # array, which lets the bucketed sweeps detect shared-target buckets by
    # object identity.
    enc_cache: Dict[int, np.ndarray] = {}

    def enc(seq: bytes) -> np.ndarray:
        key = id(seq)
        got = enc_cache.get(key)
        if got is None:
            got = enc_cache[key] = glob.encode(seq)
        return got

    id_pairs = [(enc(qb), enc(tb)) for qb, tb in byte_pairs]
    sigma = glob.sigma
    eq = encode.build_equality_matrix(bytes(glob.alphabet), eq_pairs)
    k_eff = _INF if k < 0 else k

    # Each distinct object's byte set once: a broadcast target of 1e5
    # symbols is not re-scanned for every read.
    byte_sets: Dict[int, frozenset] = {}

    def byte_set(seq: bytes) -> frozenset:
        got = byte_sets.get(id(seq))
        if got is None:
            got = byte_sets[id(seq)] = frozenset(seq)
        return got

    results: List[AlignResult] = []
    main_idx = []  # indices with non-empty sequences needing device sweeps
    for i, (q_ids, t_ids) in enumerate(id_pairs):
        qb, tb = byte_pairs[i]
        res = AlignResult(status=STATUS_OK,
                          alphabet_length=len(byte_set(qb) | byte_set(tb)))
        if len(q_ids) == 0 or len(t_ids) == 0:
            # Early empty-sequence convention (edlib.cpp:166-184).
            if mode == AlignMode.NW:
                res.edit_distance = max(len(q_ids), len(t_ids))
                res.end_locations = np.array([len(t_ids) - 1], np.int64)
            else:
                res.edit_distance = len(q_ids)
                res.end_locations = np.array([-1], np.int64)
            res.num_locations = 1
        else:
            main_idx.append(i)
        results.append(res)

    if main_idx and mode == AlignMode.NW and mesh is None:
        dists = _run_bucketed_nw_banded([id_pairs[i] for i in main_idx],
                                        sigma, eq, k, device)
        for i, d in zip(main_idx, dists):
            res = results[i]
            if 0 <= d <= k_eff:
                res.edit_distance = int(d)
                res.end_locations = np.array([len(id_pairs[i][1]) - 1],
                                             np.int64)
                res.num_locations = 1
    elif main_idx:
        hin0 = 0 if mode == AlignMode.HW else 1
        # NW reaches here only under a grid: the final column of the full
        # reduce, no hit pass.
        want_hits = mode != AlignMode.NW
        sweep_pairs = [id_pairs[i] for i in main_idx]
        shw_kb = None
        if mode == AlignMode.SHW:
            # SHW minimal end positions never exceed Q-1+best with
            # best <= min(k, Q), so columns beyond Q+min(k, Q) cannot
            # contribute — truncate the scan (edlib.cpp:644-654).
            trunc = []
            slice_cache: Dict[Tuple[int, int], np.ndarray] = {}
            for q_ids, t_ids in sweep_pairs:
                lim = len(q_ids) + min(len(q_ids),
                                       k if k >= 0 else len(q_ids))
                if len(t_ids) > lim:
                    # One slice object per (target, lim) so broadcast
                    # targets stay shared.
                    key = (id(t_ids), lim)
                    if key not in slice_cache:
                        slice_cache[key] = t_ids[:lim]
                    t_ids = slice_cache[key]
                trunc.append((q_ids, t_ids))
            sweep_pairs = trunc
        if mode == AlignMode.SHW and mesh is None:
            # Guaranteed per-pair bounds on the SHW best: best <= d_NW <=
            # the hamming bound, and best <= Q, so the banded ladder capped
            # there always completes every lane.
            shw_kb = np.array(
                [min(encode.nw_upper_bound(q, t, eq), max(len(q), 1))
                 for q, t in sweep_pairs], np.int64)
        summaries = _run_bucketed_summary(sweep_pairs, sigma, eq, hin0,
                                          want_hits, device, shw_kb=shw_kb,
                                          k_user=k, mesh=mesh)
        for i, summ in zip(main_idx, summaries):
            res = results[i]
            if mode == AlignMode.NW:
                if summ.last_score <= k_eff:
                    res.edit_distance = summ.last_score
                    res.end_locations = np.array(
                        [len(id_pairs[i][1]) - 1], np.int64)
                    res.num_locations = 1
                continue
            best, positions = _filter_best_positions(
                summ.best, summ.positions, len(id_pairs[i][0]), k_eff)
            res.edit_distance = best
            if best >= 0:
                res.end_locations = np.array(positions, np.int64)
                res.num_locations = len(positions)

    if task in (AlignTask.LOC, AlignTask.PATH):
        _fill_start_locations(results, id_pairs, main_idx, mode, sigma, eq,
                              device, mesh)
    if task == AlignTask.PATH:
        _fill_paths(results, id_pairs, main_idx, sigma, eq, device)
    return [r.to_dict() for r in results]


def _capture_eligible(qlen: int, wlen: int, sigma: int) -> bool:
    """The JAX package's device-route test for a PATH window
    (edlib_tpu/batch.py:952-969): at most max_cells() DP cells, query rows
    and window columns within int16, sigma+1 within the per-lane kernels'
    alphabet cap."""
    if wlen < 1 or qlen < 1 or qlen * wlen > batched_path.max_cells():
        return False
    nw_b = _pow2_at_least(encode.num_words(qlen))
    if nw_b * 32 > 32767 or wlen > 32767:
        return False
    return sigma + 1 <= ck.max_sigma1(nw_b, False)


def _fill_paths(results, id_pairs, main_idx, sigma, eq, dev):
    """The alignment of the first location pair of every result within k:
    eligible windows on the card in one batch, the rest on the host."""
    dev_idx, host_idx = [], []
    for i in main_idx:
        res = results[i]
        if res.edit_distance < 0:
            continue
        wlen = int(res.end_locations[0]) - int(res.start_locations[0]) + 1
        (dev_idx if _capture_eligible(len(id_pairs[i][0]), wlen, sigma)
         else host_idx).append(i)

    def window(i):
        res = results[i]
        q_ids, t_ids = id_pairs[i]
        return q_ids, t_ids[int(res.start_locations[0]):
                            int(res.end_locations[0]) + 1]

    if dev_idx:
        ops_list = batched_path.batched_windows_path(
            [window(i) for i in dev_idx],
            [int(results[i].edit_distance) for i in dev_idx], sigma, eq, dev)
        for i, ops in zip(dev_idx, ops_list):
            results[i].alignment = ops
    for i in host_idx:
        q_ids, w_ids = window(i)
        results[i].alignment = obtain_alignment(q_ids, w_ids, eq,
                                                int(results[i].edit_distance),
                                                dev)
    for i in dev_idx + host_idx:
        results[i].alignment_length = len(results[i].alignment)
    _PATH_ROUTES["capture"] += len(dev_idx)
    _PATH_ROUTES["host"] += len(host_idx)


def _fill_start_locations(results, id_pairs, main_idx, mode, sigma, eq,
                          dev, mesh=None):
    """Start locations; HW batches every reversed-SHW re-run on the card
    (over the device grid mesh when one is given)."""
    if mode != AlignMode.HW:
        for i in main_idx:
            res = results[i]
            if res.edit_distance >= 0:
                res.start_locations = np.zeros(res.num_locations, np.int64)
        return

    sub_pairs = []   # (reversed query, reversed target prefix) per re-run
    sub_owner = []
    for i in main_idx:
        res = results[i]
        if res.edit_distance < 0:
            continue
        res.start_locations = np.zeros(res.num_locations, np.int64)
        q_ids, t_ids = id_pairs[i]
        rq = q_ids[::-1].copy()
        for j, e in enumerate(res.end_locations):
            e = int(e)
            if e == -1:
                res.start_locations[j] = 0  # open edge case, edlib.cpp:237-249
                continue
            # The last minimal reversed-SHW position p satisfies
            # p <= Q-1+e_d, so only the last Q+e_d target chars before e
            # can matter (the band-death exit, edlib.cpp:644-654).
            lim = len(q_ids) + res.edit_distance
            rt_prefix = t_ids[max(0, e + 1 - lim):e + 1][::-1].copy()
            sub_pairs.append((rq, rt_prefix))
            sub_owner.append((i, j, e))

    if not sub_pairs:
        return
    # Only the LAST minimal SHW position is needed (edlib.cpp:258-260): the
    # reduce pass carries it directly, no hit pass.
    summaries = _run_bucketed_summary(sub_pairs, sigma, eq, hin0=1,
                                      want_hits=False, dev=dev, mesh=mesh)
    for (i, j, e), summ in zip(sub_owner, summaries):
        results[i].start_locations[j] = e - summ.pos_last
