#!/usr/bin/env python3
"""Smoke run of edlib_tpu_torch on one NVIDIA card (run: python3 chip_smoke.py).

Phases, each of which exits non-zero on any failure:

1. Build the CUDA kernels from edlib_tpu_torch/ops/csrc with nvcc (sm_90a)
   and print the card's name and power limit.
2. Hold every kernel against its plain PyTorch version on the card, at small
   shapes, for exact equality (every output is an integer); the capture
   kernel at NW 1, 4, 8, 16 and 64, both hin0, with and without Ph/Mh,
   over a ragged last chunk; the score-stream
   and eq-stream kernels at NW 1, 4 (registers) and 9 (scratch), both
   hin0, over a ragged 197 columns; every per-lane kernel in the wave form
   (one block a lane; sweep_scores in warp groups) at 256 and a ragged 300
   words; and sweep_scores (warp groups) and reduce_lanes (past the wave
   form: one thread a lane) at 12,300 words;
   the resumable reduce and the carry form of the score stream, per-lane
   and shared rows, both hin0, NW 1, 4, 9 and 300, from a fresh and a
   random state, two chained segments equal to one reduce_lanes /
   sweep_scores sweep; and hw_adaptive at NW 1, 4 and 32 over two tiles of
   1,024 lanes, with and without the strong reduce (raw outputs and the
   word-columns each tile swept), and its cluster launch at NW 1, 4, 32, 33
   and 160 over two or three tiles whose windows end apart, C left to the
   card and forced down to 4, 2 and 1, sigma=100 (profile rows read from
   global memory) and per-lane targets at hin0 = 1, each call's plan
   checked (check_adaptive_cluster); K1 and K2 with forced cores of 1-40
   columns (the split-lane schedule) at NW 1 and 4, both hin0 (hin0 = 1
   keeps one core a lane), 300 lanes of ragged spans with the edge lanes
   (hi = 0, hi - 1 < lo, lo past hi, hi past the row), and at NW 9 (the
   scratch form, one thread a lane, whatever the forced core); K3 likewise
   at NW 1, 4, 8 and 9, sigma 100 and 300, one and two alternatives, rows
   sorted and random (its profile expansion and staged planes), and four
   alternatives at sigma 300 (the planes past the block's budget); and the banded wavefront's tile schedule on segments of ragged
   starts and lengths at 128, 1,024, 2,048 and 4,096 slots (a capped
   window, a tracked range), its plain emulation beside the 128-slot ones;
   the fixed-window wavefront's warp groups on ragged segments with rings
   of 1, 2 and 64 tiles, passes forced to 3 and 4 groups, word0 > 0 and
   6,144 slots, and HW from step 0 over forced column cores (halos reaching
   column 0 and fresh ones), stream and tracked range, its emulation beside
   the first; and the resumable reduce's split-lane cores with a carry at
   NW 1, 4 and 8, both hin0, forced cores of 1-40 columns, per-lane and
   shared rows, the edge lanes, fresh and carried states (at hin0 = 0 an HW
   sweep's state), chained segments equal to one sweep; the word-parallel
   lane (reduce_resume with one core a lane, sweep_scores and its carry
   form) at NW 2-8 (segments of 2, 4 and 8 threads), both hin0, fresh and
   random carries, the edge lanes, rows of 101, 5 and 2 columns, chained
   segments; and the score stream's warp groups at 256, 300 and 4,096
   words, rings of 1, 2 and 64 tiles, fresh and carried, in one launch and
   in forced passes, chained segments, and a 140,000-word lane in passes
   unforced against the wavefront; nw_banded's word-parallel band at
   n_win 2-16 (segments of 2-16 threads, windows sliding by 0, 1 and
   several words, the whole profile, edge lanes), shw_banded and
   shw_banded_hits on the same band cases and the one-thread ones,
   reduce_eqstream beside hits_eqstream on the word-parallel lane (and
   one thread a lane at one word and on an empty stream), and the
   capture's word
   groups over lanes (NW 1-500, blocks of 8, 16 and 32 lanes, groups of
   1-8 words, the read-back form at 600 words); hits_bitplane on its
   split-lane cores over K3's staged rows (K3's operand cases, forced
   cores of 32-160 columns and one core a lane, both hin0, NW 1-8 and
   the one-thread form at 9); the plain emulation of each schedule beside
   a first case; each call's reported form checked.
3. The main path at full width: 8192 reads of 120 bp (96 of them random,
   unmappable) against a 4,194,304-bp sigma=4 target (a random 1 Mbp tiled
   4x, so exact repeats tie first positions across windows), through
   map_reads(k=-1).  Launch counts are zeroed just before and read just
   after; the filter's verify and segmented fallback (reduce_lanes) and the
   overflow stragglers' shared sweep (sweep_shared) must each have run.
   Every read must equal an unfiltered shared sweep over all reads; every
   overflow straggler and two sampled reads an O(Q*T) DP on the card over
   the whole target, and the sampled two a numpy DP as well.
4. The bit-plane path: the same read batch shape against a 1,048,576-bp
   sigma=100 target, where verification and fallback take reduce_bitplane;
   checked against the unfiltered shared sweep.
5. An SHW batch and a B <= 64 segmented batch, each equal to the same call
   on the CPU (the plain versions).
6. Each kernel timed on the operands its main path gave it (CUDA events)
   and its output held against its plain version's on the same operands,
   over at most the first SHARED_PLAIN_COLS columns.  Beside each: the plain
   version's time over the columns it ran, and the least time the card
   could take.  Every K1 and K2 call (phase 3's overflow sweep, phase 7's
   shared row) is also held exactly against the same kernel with one core
   a lane, and timed so (whole_ms).

7-10. align_batch at full width, one phase per path, each with its launch
   counts zeroed just before and read just after the call, a warm repeat
   that must agree, a subsample of 128 pairs equal to device="cpu" (the
   plain versions; phases 7 and 11 share one), and 4 sampled pairs equal
   to a numpy DP (distance, every end location, start locations):
   7. HW locations, shared target: 10,240 reads x 120 bp, windows of one
      random 100,000-bp target with 6% substitutions (reduce_lanes on the
      shared row and the per-lane start re-runs, hits_lanes);
   8. NW distance, banded: 8,192 pairs of a random 1,000-bp query and a
      copy with 3% edits (nw_banded);
   9. SHW locations, banded: the same queries against their copy plus a
      300-bp random tail (shw_banded, shw_banded_hits);
   10. HW locations, sigma=100, per-lane: 8,192 reads x 120 bp against
      their own 1,000-bp windows (reduce_bitplane, hits_bitplane).
11-12. align_batch with task="path" at full width, checked as 7-10 (the
   numpy DP also walks the window with edlib's move preference and gives
   the CIGAR), plus: every CIGAR valid (it consumes the whole query and the
   window [start, end], '=' on equal and 'X' on unequal symbols, and its I,
   D and X count the distance), and every window on the capture route:
   11. HW path on phase 7's batch (capture; reduce_lanes and hits_lanes for
      the locations), 10,240 windows in one (4-word, 128-column) bucket;
   12. NW path, 8,192 pairs of a random 500-bp query and a copy with 3%
      edits: 16-word windows of 512 columns (1,024 for copies past 512 bp;
      nw_banded for the distances, capture).
   Each path phase also profiles one batched-windows call alone: the
   capture kernel's device time, the decode and walk's, and peak memory.
13. Each kernel of phases 7-12 and 18-23 timed and held against its plain
   version on its phase's operands, over at most SHARED_PLAIN_COLS columns
   (and PLAIN_WORD_COLS word-columns) of at most the first, middle and last
   calls of a path; each wavefront kernel of phases 14-17 timed over every
   call of its path (its microseconds a step; the banded one also by launch
   form, with its tile width; the fixed-window one with each call's plan,
   its column cores and warp groups, and where it runs cores the same calls
   with one core) and held against its plain version in the form the path's
   call runs over the first, middle and last calls: WF_PLAIN_STEPS steps,
   two cores and the query where the call runs column cores, the banded one
   at least the tiles' 6,144 steps; it fails where the form differs.  K1's,
   K3's, K2's and the resumable reduce's calls also give their core
   length, threads and the time with one core a lane (whole_ms), and so do
   hits_lanes' (which must run several cores a lane on phase 7).  The short
   kernels' calls (TRACED) also give a traced batch (the kernels' device
   time a call by torch.profiler and the device's idle share) and the
   device time of their launches alone (launch_ms).  The resumable reduce
   has an entry at each hin0; its calls, the score stream's and the
   hit-word sweeps', the banded and the eq-stream reduces' give their plan
   as the kernel reports it (form, blocks and threads, and the cores and
   core, the segment width or the warp groups a lane, ring and passes); hits_eqstream must run the word lane at
   width 4 on phase 18, reduce_eqstream on phases 18 and 19, nw_banded the
   word-parallel band at width 16 on phases 8 and 12, shw_banded and
   shw_banded_hits the band on phase 9, hits_bitplane its
   split-lane cores on phase 10, capture its word groups over lanes on
   phases 11 and 12, and hw_adaptive the register form on a cluster of at
   least 8 blocks on phase 23 (NEW_FORMS; its calls give their plan: form,
   C, lanes a block, staging, NWC, and the clusters the card holds).
14-17. Long single pairs through nw_distance_long, shw_best_long,
   semiglobal_locations_long and align, each with its launch counts, a
   warm repeat that must agree, and its k ladder rung by rung (k, banded
   and tail steps, whether the band died, whether the rung answered):
   14. NW: a random 1,000,000-bp target and its copy with 3% edits;
      nw_distance_long and align (distance, locations) on the banded
      wavefront (nw_banded must not run), equal to the unbanded wavefront,
      k = d gives d and k = d-1 gives -1; on a 30,000-bp pair the banded
      wavefront equals (and is timed against) the one-lane align_batch.
   15. SHW: the same query against its target plus a 200,000-bp random
      tail; shw_best_long is the head of semiglobal_locations_long's list,
      which equals the filtered unbanded stream.
   16. HW: a 10,000-bp read with 5% edits planted twice in the target;
      semiglobal_locations_long equals align(task="locations")'s ends.
   17. NW path: align(task="path") on a 200,000-bp pair with 3% edits (the
      banded distance, the root's half-sweeps on the card), a valid CIGAR
      of that cost; on a 30,000-bp pair with the device gate lowered the
      ops equal the host half-sweeps'.
18-19. align_batch past the per-lane alphabet cap with dense equalities,
   checked as 7-10 (the numpy DP compares equality classes): HW locations
   of 120-bp reads over sigma=100, each against its own 1,000-bp window
   with 6% substitutions, every symbol equal to the other 7 of its class of
   8 (v // 8), so no bit-plane plan exists:
   18. 4,096 reads: the JAX footprint estimate is 0.98 GB, under 1 GiB, so
      the eq-stream kernels run (reduce_eqstream, hits_eqstream; the start
      re-runs too) and sweep_scores must not;
   19. 8,192 reads: 1.96 GB, so the main bucket takes the score stream
      (sweep_scores).
20. One long pair on the score-stream route: align(a, b), task distance and
   then locations, on a random 100,000-bp sigma=4 sequence and its copy
   with 3% substitutions (one lane of 4,096 words x 131,072 columns; the
   bit-plane budget and the eq-stream footprint both fail, and the Hamming
   bound keeps it under the wavefront gate): sweep_scores runs,
   wavefront_banded must not; its distance equals nw_distance_long's, k = d
   gives d and k = d-1 gives -1; warm against the banded wavefront.  And
   hw_stream_segmented: a 1,000-bp read with 5% edits planted in phase 14's
   1 Mbp target, its positions at the stream's minimum equal
   semiglobal_locations_long(mode="HW")'s ends.
21-22. The sharded API (edlib_tpu_torch.parallel) on a 2 x 2 DeviceGrid of
   the one card (the shards take turns on its kernels), each call with its
   launch counts and a warm repeat that must agree:
   21. sharded_reduce_pipeline of phase 3's 8,192 reads against its
      4,194,304-bp target, hin0 0 and 1: reduce_resume 2 launches a dp row,
      4 in all (at hin0 0 several cores a lane, which it checks), the
      result equal lane for lane to one shared reduce_lanes sweep of the
      whole scan.
   22. align_batch(mesh=) on phase 7's HW batch (locations: sp halo slices
      merged over the grid, start re-runs data-parallel) and phase 8's NW
      batch (the full reduce, nw_banded must not run), map_reads(mesh=) on
      phase 3's batch (the filter over the grid, the stragglers on
      sweep_shared), each equal to its phase's unsharded result; and
      sharded_nw_pipeline of 1,024 of phase 3's reads against phase 7's
      target, equal to one sweep_scores of the joined scan
      (sweep_scores_resume, 4 launches).
23. Sweeper.reduce_hw_adaptive: 8,192 reads of 1,000 bp (32 words) with 6%
   substitutions planted in one shared 100,000-bp target, k = 8, 16, 32 and
   64 (hw_adaptive); lanes whose unbanded best (reduce_lanes on the same
   operands) is <= k equal it, the rest are above k.  The unbanded sweep is
   timed beside it: its wall (unbanded_s) and its reduce_lanes launch's
   device ms (unbanded_ms, launch_ms), beside each k's hw_adaptive launch
   (ms).
   Phase 13 holds the kernels of 21-23 against their plain versions on
   their phases' operands (hw_adaptive's raw outputs over the first
   2,048 columns) and times them; hw_adaptive's bound counts the live
   word-columns the kernel reports.

Output: the kernels' JSON line, the end-to-end JSON line, the card line, and
last {"ok": true, "device": {...}}.  Data comes from --seed.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import re
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# The least time the card could take for a call (H100 SXM published peaks at
# its 700 W limit): HBM at 3.35 TB/s, and 32-bit integer issue at 64 INT32
# lanes per SM per clock x 132 SMs x 1.98 GHz (the sweeps do only 32-bit
# logic, add and shift; the guide's table has no INT32 row).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Integer operations the function needs, counted as Hopper issues them: a
# logic function of up to three inputs is one LOP3, (x << 1) | bit one LEA,
# a + b - c one IADD3.  advance_word (csrc/myers.cu) is 13 per 32-cell word
# per column; the carried score and the windowed reduction of a per-lane
# sweep are 6 per lane per column (score, min, two compare-and-selects), of
# the shared sweep 4 (score, min, one compare-and-select).  Addressing and
# loop control are not counted.
OPS_PER_WORD = 13
OPS_PER_COLUMN = 6
OPS_PER_COLUMN_SHARED = 4
# A sweep's plain version runs over at most the first staging chunk of
# csrc/myers.cu (kChunk = 2048) and a ragged tail, and over at most
# PLAIN_WORD_COLS word-columns (a lane of 4,096 words: 16 columns); the
# shared sweep's full-width output is held against an O(Q*T) DP on the card
# (dp_best_hw_card), the per-lane sweeps' by each phase's device="cpu"
# subsample and DP checks.
SHARED_PLAIN_COLS = 2048 + 37
PLAIN_WORD_COLS = 1 << 16
# Main-path sizes (bench.py's read-mapping shape).
READS, QLEN, N_RANDOM = 8192, 120, 96
BASE_LEN, TILES = 1 << 20, 4          # sigma=4 target: BASE_LEN random, tiled
BIG_SIGMA, BIG_SIGMA_LEN = 100, 1 << 20
SHW_LEN, SHW_READS, SEG_LEN, SEG_READS = 5000, 128, 60_000, 32
# align_batch phases (scripts/hw_batched_path.py's HW workload; NW/SHW pairs
# of 1,000 bp, so nw_b = 32 words and the banded kernels run).
HW_READS, HW_QLEN, HW_TLEN, HW_RATE = 10_240, 120, 100_000, 0.06
PAIRS, PAIR_LEN, PAIR_EDITS, SHW_TAIL = 8_192, 1_000, 0.03, 300
BP_READS, BP_QLEN, BP_WIN, BP_SIGMA = 8_192, 120, 1_000, 100
SUBSAMPLE, DP_SAMPLES = 128, 4
# align_batch task="path" phases: phase 7's HW batch, and NW pairs of 500 bp
# (qlen * wlen <= 2^18, so every window takes the capture kernel).
PATH_PAIRS, PATH_LEN = 8_192, 500
# Long single pairs (phases 14-17): a random sigma=4 target of 1 Mbp and its
# copy with 3% edits (the JAX package's 1 Mbp chromosome-vs-mutant drive),
# the same query against the target plus a random SHW tail, a 10 kbp read
# planted twice for HW, and NW PATH pairs.  BREAK_LEN pairs time the
# banded wavefront against the one-lane align_batch route (nw_banded); past
# 65,536 bp (2,048 words) that route is the score stream (phase 20): the
# profile fits neither the per-lane nor the bit-plane kernels' routing
# budget, and one lane's eq-stream footprint estimate is past 1 GiB.
LONG_LEN, LONG_EDITS, BREAK_LEN, LONG_SHW_TAIL = 1_000_000, 0.03, 30_000, \
    200_000
LONG_READ, LONG_READ_EDITS = 10_000, 0.05
LONG_PATH_LEN, LONG_PATH_EQ_LEN, PATH_EQ_GATE = 200_000, 30_000, 10**8
# Phases 18-19: phase 10's read shape over sigma = BP_SIGMA with dense
# equalities (each symbol equal to the other EQ_CLASS - 1 of its class).
EQ_READS, STREAM_READS, EQ_CLASS = 4_096, 8_192, 8
# Phase 20: a STREAM_LEN-bp pair with substitutions only, and a
# SEG_READ_LEN-bp read for hw_stream_segmented.
STREAM_LEN, STREAM_SUBS, SEG_READ_LEN = 100_000, 0.03, 1_000
# Phases 21-23: a 2 x 2 grid of the one card; NW_PIPE_READS of phase 3's
# reads through sharded_nw_pipeline against phase 7's target; and the
# adaptive reduce on 1,000-bp reads (32 words) in one shared 100 kbp target.
GRID_DP, GRID_SP, NW_PIPE_READS = 2, 2, 1024
ADAPT_READS, ADAPT_QLEN, ADAPT_TLEN = 8_192, 1_000, 100_000
ADAPT_KS = (8, 16, 32, 64)
# The wavefront kernels' plain versions run one torch step per wavefront
# step: a full-width call is held over WF_PLAIN_STEPS steps of its first,
# middle and last segments (wavefront_banded over enough steps to run the
# launch form the path's segment ran).
WF_PLAIN_STEPS = 1024
KERNEL_SOURCE = {"wavefront": "edlib_tpu_torch/ops/csrc/wavefront.cu",
                 "wavefront_banded": "edlib_tpu_torch/ops/csrc/wavefront.cu"}
KERNEL_SOURCE_DEFAULT = "edlib_tpu_torch/ops/csrc/myers.cu"
REPLACES = {
    "reduce_lanes": "edlib_tpu/ops/pallas_kernel.py:605",
    "sweep_shared": "edlib_tpu/ops/pallas_kernel.py:342",
    "reduce_bitplane": "edlib_tpu/ops/pallas_kernel.py:2040",
    "hits_lanes": "edlib_tpu/ops/pallas_kernel.py:874",
    "hits_bitplane": "edlib_tpu/ops/pallas_kernel.py:2083",
    "nw_banded": "edlib_tpu/ops/pallas_kernel.py:1066",
    "shw_banded": "edlib_tpu/ops/pallas_kernel.py:1215",
    "shw_banded_hits": "edlib_tpu/ops/pallas_kernel.py:1348",
    "capture": "edlib_tpu/ops/pallas_kernel.py:2635",
    "wavefront": "edlib_tpu/ops/wavefront.py:205",
    "wavefront_banded": "edlib_tpu/ops/wavefront.py:573",
    "sweep_scores": "edlib_tpu/ops/pallas_kernel.py:211",
    "reduce_eqstream": "edlib_tpu/ops/pallas_kernel.py:1869",
    "hits_eqstream": "edlib_tpu/ops/pallas_kernel.py:1905",
    "reduce_resume": "edlib_tpu/ops/pallas_kernel.py:679",
    "hw_adaptive": "edlib_tpu/ops/pallas_kernel.py:1669",
    # The carry form of the score stream: the JAX package leaves it to XLA.
    "sweep_scores_resume": "edlib_tpu/ops/jax_engine.py:140",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(f"[chip_smoke {time.time() - START:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


START = time.time()


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------


def make_batch(rng, t_ids, sigma, n_reads, qlen, n_random, rate=0.05):
    """(reads int32 (B, qlen), indices of the random reads): reads drawn from
    the target with `rate` substitutions, n_random of them uniform random."""
    tlen = len(t_ids)
    starts = rng.randint(0, tlen - qlen, n_reads)
    reads = t_ids[starts[:, None] + np.arange(qlen)[None, :]]
    muts = rng.rand(n_reads, qlen) < rate
    reads[muts] = rng.randint(0, sigma, int(muts.sum()))
    rand_idx = np.sort(rng.choice(n_reads, n_random, replace=False))
    reads[rand_idx] = rng.randint(0, sigma, (n_random, qlen))
    return reads.astype(np.int32), rand_idx


def to_bytes(ids, letters: np.ndarray):
    return [letters[r].tobytes() for r in ids]


def dp_best_hw(read, t_ids):
    """O(Q*T) HW DP in numpy, row by row: (best, first best end position),
    position -1 when the empty alignment (score qlen) is best."""
    T = len(t_ids)
    ar = np.arange(T + 1, dtype=np.int32)
    row = np.zeros(T + 1, np.int32)              # free leading gap
    for i, sym in enumerate(read, start=1):
        diag = row[:-1] + (t_ids != sym)
        e = np.empty(T + 1, np.int32)
        e[0] = i
        np.minimum(diag, row[1:] + 1, out=e[1:])
        row = np.minimum.accumulate(e - ar) + ar
    j = int(np.argmin(row))
    return int(row[j]), j - 1


def dp_best_hw_card(reads, t_ids, dev):
    """dp_best_hw for a batch of equal-length reads at once, in PyTorch on
    the card: reads int (n, Q), t_ids int (T,) -> (best, pos) numpy (n,)."""
    import torch
    q = torch.as_tensor(np.asarray(reads, np.int32), device=dev)
    t = torch.as_tensor(np.asarray(t_ids, np.int32), device=dev)
    n, T = q.shape[0], t.shape[0]
    ar = torch.arange(T + 1, dtype=torch.int32, device=dev)
    row = torch.zeros(n, T + 1, dtype=torch.int32, device=dev)
    e = torch.empty_like(row)
    for i in range(q.shape[1]):
        e[:, 0] = i + 1
        e[:, 1:] = torch.minimum(row[:, :-1] + (t[None, :] != q[:, i, None]),
                                 row[:, 1:] + 1)
        row = torch.cummin(e - ar, dim=1).values + ar
    j = torch.argmin(row, dim=1)            # the first minimum
    best = row.gather(1, j[:, None])[:, 0]
    return best.cpu().numpy().astype(np.int64), (j - 1).cpu().numpy()


def dp_last_row(q, t, free_start: bool):
    """Bottom row D[Q][j], j = 0..T, of the edit-distance DP of query q
    against the prefixes of t, in numpy row by row; free_start: HW (row 0
    is all 0), else NW/SHW (row 0 is j)."""
    T = len(t)
    ar = np.arange(T + 1, dtype=np.int32)
    row = np.zeros(T + 1, np.int32) if free_start else ar.copy()
    for i, sym in enumerate(q, start=1):
        diag = row[:-1] + (t != sym)
        e = np.empty(T + 1, np.int32)
        e[0] = i
        np.minimum(diag, row[1:] + 1, out=e[1:])
        row = np.minimum.accumulate(e - ar) + ar
    return row


def dp_align(q, t, mode: str, task: str) -> dict:
    """edlib's editDistance and locations for one pair (k = -1) from the DP:
    every end location reaching the best (with edlib's -1 end location,
    score Q, where its 64-bit blocks pad the query: Q % 64 != 0), and for
    HW the start of each end as the last minimal SHW end of the reversed
    query over the reversed target prefix (edlib.cpp:230-266)."""
    Q, T = len(q), len(t)
    row = dp_last_row(q, t, mode == "HW")
    if mode == "NW":
        return {"editDistance": int(row[T]),
                "locations": [(0 if task == "locations" else None, T - 1)]}
    real = row[1:]
    best_real = int(real.min())
    quirk = Q % 64 != 0
    best = min(best_real, Q) if quirk else best_real
    ends = [-1] if quirk and best == Q else []
    if best_real == best:
        ends += [int(j) for j in np.nonzero(real == best)[0]]
    starts = []
    for e in ends:
        if task != "locations":
            starts.append(None)
        elif mode == "SHW" or e == -1:
            starts.append(0)
        else:
            rr = dp_last_row(q[::-1], t[:e + 1][::-1], False)[1:]
            starts.append(e - int(np.nonzero(rr == rr.min())[0][-1]))
    return {"editDistance": best, "locations": list(zip(starts, ends))}


def dp_path(q, t, mode: str) -> dict:
    """dp_align's editDistance and locations (task "locations"), and the
    extended CIGAR of the first location pair: the full NW matrix of the
    query against that window, walked back from its last cell with edlib's
    move preference (up = I, then left = D, then diagonal: '=' where the
    value is unchanged, else 'X'; edlib.cpp:1020-1130)."""
    want = dp_align(q, t, mode, "locations")
    start, end = want["locations"][0]
    w = t[start:end + 1]
    Q, W = len(q), len(w)
    ar = np.arange(W + 1, dtype=np.int32)
    D = np.empty((Q + 1, W + 1), np.int32)
    D[0] = ar
    for i in range(1, Q + 1):
        e = np.empty(W + 1, np.int32)
        e[0] = i
        np.minimum(D[i - 1, :-1] + (w != q[i - 1]), D[i - 1, 1:] + 1,
                   out=e[1:])
        D[i] = np.minimum.accumulate(e - ar) + ar
    ops = []
    i, j = Q, W
    while i > 0 and j > 0:
        v = D[i, j]
        if D[i - 1, j] + 1 == v:
            ops.append("I")
            i -= 1
        elif D[i, j - 1] + 1 == v:
            ops.append("D")
            j -= 1
        else:
            ops.append("=" if D[i - 1, j - 1] == v else "X")
            i -= 1
            j -= 1
    ops += ["D"] * j if i == 0 else ["I"] * i
    ops.reverse()
    runs = []
    for op in ops:
        if runs and runs[-1][1] == op:
            runs[-1][0] += 1
        else:
            runs.append([1, op])
    want["cigar"] = "".join(f"{n}{op}" for n, op in runs)
    return want


CIGAR_RE = re.compile(r"(\d+)([=XID])")


def check_cigars(label, out, q_ids, t_ids, shared: bool) -> None:
    """Every result's CIGAR is a valid alignment of its query and first
    window: it consumes the whole query and target[start:end+1], '=' joins
    equal and 'X' unequal symbols, and its I, D and X count the distance."""
    for i, r in enumerate(out):
        cig = r["cigar"] or ""
        parts = CIGAR_RE.findall(cig)
        if not parts or "".join(n + op for n, op in parts) != cig:
            fail(f"{label}: pair {i} has no valid CIGAR: {cig!r}")
        ops = np.frombuffer("".join(op * int(n) for n, op in parts).encode(),
                            np.uint8)
        q = q_ids[i]
        start, end = r["locations"][0]
        w = (t_ids if shared else t_ids[i])[start:end + 1]
        in_q = ops != ord("D")
        in_t = ops != ord("I")
        diag = in_q & in_t
        equal = (q[np.cumsum(in_q)[diag] - 1]
                 == w[np.cumsum(in_t)[diag] - 1]) if diag.any() else diag[:0]
        if (int(in_q.sum()) != len(q) or int(in_t.sum()) != len(w)
                or not np.array_equal(equal, ops[diag] == ord("="))
                or int((ops != ord("=")).sum()) != r["editDistance"]):
            fail(f"{label}: pair {i}'s CIGAR {cig} is not an alignment of "
                 f"distance {r['editDistance']} of its query and window "
                 f"[{start}, {end}]")


def edit_copy(rng, q, rate, sigma):
    """q with edits at `rate` per symbol: substitutions, deletions and
    insertions (after the symbol) in equal shares."""
    r = rng.rand(len(q))
    dele = r < rate / 3
    sub = (r >= rate / 3) & (r < 2 * rate / 3)
    ins = (r >= 2 * rate / 3) & (r < rate)
    t = q.copy()
    t[sub] = (t[sub] + rng.randint(1, sigma, int(sub.sum()))) % sigma
    counts = np.where(dele, 0, np.where(ins, 2, 1))
    out = np.repeat(t, counts)
    out[np.cumsum(counts)[ins] - 1] = rng.randint(0, sigma, int(ins.sum()))
    return out.astype(np.int32)


# --------------------------------------------------------------------------
# Kernels vs plain versions
# --------------------------------------------------------------------------


def lane_operands(rng, dev, *, n_lanes, n_rows, T, s1, nw):
    import torch
    lo = rng.randint(0, T // 2, n_lanes)
    hi = np.minimum(lo + rng.randint(1, T + 1, n_lanes), T)
    hi[::7] = 0                                   # pad lanes: no columns
    prow = rng.randint(0, n_rows, n_lanes)
    trow = rng.randint(0, n_rows, n_lanes)
    targets = rng.randint(0, s1, (n_rows, T))
    words = rng.randint(0, 1 << 32, (n_rows, s1, nw), dtype=np.uint64)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    peq = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    return peq, i32(targets), i32(lo), i32(hi), i32(prow), i32(trow)


def edge_lanes(lo, hi, T):
    """The split and word checks' edge lanes, in place (lane_operands has
    set hi = 0 on every 7th): an empty window, lo past hi, hi past the row
    and both past it."""
    hi[1::7] = lo[1::7]                   # empty window
    lo[2::7] = hi[2::7] + 3               # lo past hi
    hi[3::7] = T + 1 + lo[3::7] % 20      # hi past the row
    lo[4::7], hi[4::7] = T + 2, T + 9     # both past the row


def max_abs_err(got, want) -> float:
    return max((float((g.long() - w.long()).abs().max()) if g.numel() else 0.0)
               for g, w in zip(got, want))


def on_host(fn, *args, **kw):
    """A plain version run on host copies of its tensor operands, its
    outputs moved back to the card: the same integers, at a small shape far
    sooner than one launch an operation on the card."""
    import torch
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    host = lambda a: a.cpu() if isinstance(a, torch.Tensor) else a
    out = fn(*map(host, args), **{k: host(v) for k, v in kw.items()})
    back = lambda o: o.to(dev) if isinstance(o, torch.Tensor) else o
    if isinstance(out, torch.Tensor):
        return out.to(dev)
    return type(out)(map(back, out))


def check_form(name, plan, form, **want) -> None:
    """The plan a wrapper reported (plan=) names `form` and the figures in
    want."""
    if plan.get("form") != form or any(plan.get(k) != v
                                       for k, v in want.items()):
        fail(f"{name}: launched {plan}, not the {form} form {want}")


def check_equal(name, got, want) -> float:
    import torch
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err})")
    return err


def check_kernels(rng, dev, ck):
    """Every kernel == its plain version at small shapes on the card."""
    import torch
    for nw in (1, 4, 9):
        for hin0 in (0, 1):
            ops = lane_operands(rng, dev, n_lanes=300, n_rows=6, T=200, s1=5,
                                nw=nw)
            check_equal(f"reduce_lanes nw={nw} hin0={hin0}",
                        ck.reduce_lanes(*ops, hin0),
                        on_host(ck.reduce_lanes_plain, *ops, hin0))
            words = rng.randint(0, 1 << 32, (5, nw, 70), dtype=np.uint64)
            peq_t = torch.from_numpy(
                words.astype(np.uint32).view(np.int32)).to(dev)
            target = ops[1][0].contiguous()
            check_equal(f"sweep_shared nw={nw} hin0={hin0}",
                        ck.sweep_shared(peq_t, target, hin0, 17, 190),
                        on_host(ck.sweep_shared_plain, peq_t, target, hin0,
                                17, 190))
    sigma = 100
    nb = ck.bitplane_nb(sigma)
    for nw in (4, 9):
        B = 40
        qlens = torch.from_numpy(rng.randint(1, nw * 32 + 1, B)
                                 .astype(np.int32)).to(dev)
        q = torch.from_numpy(rng.randint(0, sigma, (B, nw * 32))
                             .astype(np.int32)).to(dev)
        q_alts, pad = ck.bitplane_identity_operands(q, qlens, sigma, nw)
        planes = ck.bitplane_planes(q_alts, nb)
        _, targets, lo, hi, prow, trow = lane_operands(
            rng, dev, n_lanes=300, n_rows=B, T=200, s1=sigma + 2, nw=1)
        for hin0 in (0, 1):
            args = (planes, pad, targets, lo, hi, prow, trow, hin0)
            check_equal(f"reduce_bitplane nw={nw} hin0={hin0}",
                        ck.reduce_bitplane(*args, nb, 1, sigma),
                        on_host(ck.reduce_bitplane_plain, *args, nb, 1, sigma))
            best = hit_targets(rng, ck.reduce_bitplane(*args, nb, 1, sigma))
            hargs = args[:7] + (best, hin0, nb, 1, sigma)
            check_equal(f"hits_bitplane nw={nw} hin0={hin0}",
                        [ck.hits_bitplane(*hargs)],
                        [on_host(ck.hits_bitplane_plain, *hargs)])
    for nw in (1, 4, 9):
        for hin0 in (0, 1):
            ops = lane_operands(rng, dev, n_lanes=300, n_rows=6, T=200, s1=5,
                                nw=nw)
            best = hit_targets(rng, ck.reduce_lanes(*ops, hin0))
            check_equal(f"hits_lanes nw={nw} hin0={hin0}",
                        [ck.hits_lanes(*ops, best, hin0)],
                        [on_host(ck.hits_lanes_plain, *ops, best, hin0)])
    # Band windows of every register width and two scratch widths (3, 20),
    # sliding by 0, 1 and several words at chunk boundaries.
    chunk = 64
    for n_win, nw in ((1, 3), (2, 8), (4, 9), (8, 16), (12, 32), (16, 24),
                      (3, 7), (20, 40)):
        peq, targets, lo, hi, prow, trow = lane_operands(
            rng, dev, n_lanes=300, n_rows=6, T=200, s1=5, nw=nw)
        n_chunks = -(-200 // chunk)
        steps = rng.choice([0, 0, 1, 2, 5], n_chunks - 1)
        woff = np.minimum(np.concatenate([[0], np.cumsum(steps)]),
                          nw - n_win).astype(np.int32)
        woff_t = torch.from_numpy(woff).to(dev)
        band = (peq, targets, woff_t)
        tail = (prow, trow, n_win, chunk)
        check_equal(f"nw_banded n_win={n_win} nw={nw}",
                    [ck.nw_banded(*band, hi, *tail)],
                    [on_host(ck.nw_banded_plain, *band, hi, *tail)])
        got = ck.shw_banded(*band, lo, hi, *tail)
        check_equal(f"shw_banded n_win={n_win} nw={nw}", got,
                    on_host(ck.shw_banded_plain, *band, lo, hi, *tail))
        best = hit_targets(rng, got)
        check_equal(f"shw_banded_hits n_win={n_win} nw={nw}",
                    [ck.shw_banded_hits(*band, lo, hi, prow, trow, best,
                                        n_win, chunk)],
                    [on_host(ck.shw_banded_hits_plain, *band, lo, hi, prow,
                             trow, best, n_win, chunk)])
    # The score-stream and eq-stream kernels: register widths and a scratch
    # width, both hin0, a ragged 197 columns, sigma = 100.
    for nw in (1, 4, 9):
        for hin0 in (0, 1):
            peq, targets, lo, hi, prow, trow = lane_operands(
                rng, dev, n_lanes=300, n_rows=6, T=197, s1=101, nw=nw)
            rows = (peq, targets, prow, trow, hin0)
            check_equal(f"sweep_scores nw={nw} hin0={hin0}",
                        [ck.sweep_scores(*rows)],
                        [on_host(ck.sweep_scores_plain, *rows)])
            eq_t = ck.eqstream_gather(peq[prow.long()],
                                      targets[trow.long()]).permute(1, 2, 0)
            got = ck.reduce_eqstream(eq_t, lo, hi, hin0)
            check_equal(f"reduce_eqstream nw={nw} hin0={hin0}", got,
                        on_host(ck.reduce_eqstream_plain, eq_t, lo, hi,
                                hin0))
            best = hit_targets(rng, got)
            check_equal(f"hits_eqstream nw={nw} hin0={hin0}",
                        [ck.hits_eqstream(eq_t, lo, hi, best, hin0)],
                        [on_host(ck.hits_eqstream_plain, eq_t, lo, hi, best,
                                 hin0)])
    # The wave form (a block a lane, 8 words a thread) at 256 words and at a
    # ragged 300, over fewer columns than the block has threads (every
    # column still passes every thread).
    for nw, hin0 in ((256, 0), (300, 1)):
        peq, targets, lo, hi, prow, trow = lane_operands(
            rng, dev, n_lanes=3, n_rows=2, T=16, s1=5, nw=nw)
        lanes = (peq, targets, lo, hi, prow, trow, hin0)
        got = ck.reduce_lanes(*lanes)
        check_equal(f"reduce_lanes nw={nw} hin0={hin0}", got,
                    on_host(ck.reduce_lanes_plain, *lanes))
        best = hit_targets(rng, got)
        check_equal(f"hits_lanes nw={nw} hin0={hin0}",
                    [ck.hits_lanes(*lanes[:6], best, hin0)],
                    [on_host(ck.hits_lanes_plain, *lanes[:6], best, hin0)])
        rows = (peq, targets, prow, trow, hin0)
        check_equal(f"sweep_scores nw={nw} hin0={hin0}",
                    [ck.sweep_scores(*rows)],
                    [on_host(ck.sweep_scores_plain, *rows)])
        eq_t = ck.eqstream_gather(peq[prow.long()],
                                  targets[trow.long()]).permute(1, 2, 0)
        got = ck.reduce_eqstream(eq_t, lo, hi, hin0)
        check_equal(f"reduce_eqstream nw={nw} hin0={hin0}", got,
                    on_host(ck.reduce_eqstream_plain, eq_t, lo, hi, hin0))
        best = hit_targets(rng, got)
        check_equal(f"hits_eqstream nw={nw} hin0={hin0}",
                    [ck.hits_eqstream(eq_t, lo, hi, best, hin0)],
                    [on_host(ck.hits_eqstream_plain, eq_t, lo, hi, best,
                             hin0)])
        q = torch.from_numpy(rng.randint(0, sigma, (3, nw * 32))
                             .astype(np.int32)).to(dev)
        qlens = torch.from_numpy(rng.randint(1, nw * 32 + 1, 3)
                                 .astype(np.int32)).to(dev)
        q_alts, pad = ck.bitplane_identity_operands(q, qlens, sigma, nw)
        args = (ck.bitplane_planes(q_alts, nb), pad, targets, lo, hi, prow,
                trow, hin0)
        got = ck.reduce_bitplane(*args, nb, 1, sigma)
        check_equal(f"reduce_bitplane nw={nw} hin0={hin0}", got,
                    on_host(ck.reduce_bitplane_plain, *args, nb, 1, sigma))
        best = hit_targets(rng, got)
        hargs = args[:7] + (best, hin0, nb, 1, sigma)
        check_equal(f"hits_bitplane nw={nw} hin0={hin0}",
                    [ck.hits_bitplane(*hargs)],
                    [on_host(ck.hits_bitplane_plain, *hargs)])
    # Lanes past the wave form's 4,096 words take one thread each again
    # (the score stream: warp groups): 12,300 words, a few columns.
    peq, targets, lo, hi, prow, trow = lane_operands(
        rng, dev, n_lanes=3, n_rows=2, T=3, s1=5, nw=12_300)
    hi[:] = 3
    rows = (peq, targets, prow, trow, 0)
    check_equal("sweep_scores nw=12300 hin0=0", [ck.sweep_scores(*rows)],
                [on_host(ck.sweep_scores_plain, *rows)])
    lanes = (peq, targets, lo, hi, prow, trow, 1)
    check_equal("reduce_lanes nw=12300 hin0=1", ck.reduce_lanes(*lanes),
                on_host(ck.reduce_lanes_plain, *lanes))
    # The capture kernel (word groups over lanes), 200 columns padded with
    # the wildcard to 256 (a ragged last chunk).
    for nw in (1, 4, 8, 16, 64):
        peq, targets = lane_operands(rng, dev, n_lanes=300, n_rows=300,
                                     T=200, s1=5, nw=nw)[:2]
        tg = ck._pad_cols(targets, 4, 128)
        for hin0 in (0, 1):
            for want_h in (False, True):
                check_equal(f"capture nw={nw} hin0={hin0} want_h={want_h}",
                            ck.capture_flat_device(peq, targets, hin0, 128,
                                                   want_h),
                            on_host(ck.capture_plain, peq, tg, hin0, want_h))


def hit_targets(rng, reduced):
    """A hit kernel's best per lane: the reduce's best for most lanes, a
    random value or -(1<<30) (no hits) for some."""
    import torch
    best = reduced[0].clone()
    n = best.shape[0]
    pick = torch.from_numpy(rng.rand(n) < 0.2).to(best.device)
    rand = torch.from_numpy(rng.randint(0, 200, n).astype(np.int32)).to(
        best.device)
    best = torch.where(pick, rand, best)
    best[::11] = -(1 << 30)
    return best.contiguous()


def wavefront_operands(rng, dev, n_words, t_scan):
    """Random scan symbols in [0, 5) and (5, n_words) profile bit words."""
    import torch
    t = torch.from_numpy(rng.randint(0, 5, t_scan).astype(np.int32))
    words = rng.randint(0, 1 << 32, (5, n_words), dtype=np.uint64)
    peq = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    return t.to(dev), peq.to(dev)


def check_wavefront_kernels(rng, dev, ck):
    """Both wavefront kernels == their plain versions at small shapes, two
    chained segments (the second ragged), in each launch form: one block of
    one slot a thread (<= 1,024 slots), one block of up to 8 (<= 4,096), and
    the cooperative grid; hin0 0 and 1, the stream on and off, a column
    range, a pinned window (word0 > 0), and banded windows that slide, up
    to their cap in one case."""
    from edlib_tpu_torch.ops.wavefront import initial_state
    operands = functools.partial(wavefront_operands, rng, dev)

    for ns, n_words, word0 in ((1024, 100, 0), (1024, 900, 40),
                               (2048, 2000, 0), (6144, 6000, 0)):
        t_scan = 3000
        t, peq = operands(n_words, t_scan)
        for hin0, emit, cols in ((0, True, (0, 0)), (1, False, (3, 2990)),
                                 (1, True, (100, 200))):
            got = want = initial_state(ns, dev)
            d0 = word0 + n_words // 2
            for d, n in ((d0, 150), (d0 + 150, 97)):
                args = (d, n, n_words, t_scan, hin0, *cols, word0, emit)
                got, gs = ck.wavefront(t, peq, got, *args)
                want, ws = on_host(ck.wavefront_plain, t, peq, want, *args)
                check_equal(f"wavefront ns={ns} words={n_words} "
                            f"word0={word0} hin0={hin0} emit={emit} "
                            f"cols={cols} from step {d}",
                            [got] + ([gs] if emit else []),
                            [want] + ([ws] if emit else []))
    for ns, n_words, lo, cols in ((128, 160, -10, (0, 0)),
                                  (128, 140, -10, (5, 2000)),
                                  (1024, 1200, -300, (0, 0)),
                                  (2048, 2500, -500, (40, 2900)),
                                  (8192, 9000, -20, (0, 0))):
        t_scan = 3000
        t, peq = operands(n_words, t_scan)
        got = want = initial_state(ns, dev)
        d0 = max(0, 31 - lo)
        for d, n in ((d0, 200), (d0 + 200, 333)):
            args = (d, n, n_words, t_scan, lo, *cols)
            got = ck.wavefront_banded(t, peq, got, *args)
            want = on_host(ck.wavefront_banded_plain, t, peq, want, *args)
            check_equal(f"wavefront_banded ns={ns} words={n_words} lo={lo} "
                        f"cols={cols} from step {d}", [got], [want])


def check_wavefront_tiles(rng, dev, ck):
    """The banded entry's tile schedule (segments of at least 6,144 steps,
    up to 4,096 slots) == the plain version: segments that start and end
    mid-tile (d_base and n_steps not multiples of 32), slides inside tiles,
    a tracked range cut by tile edges, windows that reach their cap, and
    windows of 128, 1,024, 2,048 and 4,096 slots; the schedule's plain
    emulation beside the first 128-slot segment."""
    from edlib_tpu_torch.ops.wavefront import initial_state
    operands = functools.partial(wavefront_operands, rng, dev)

    for ns, n_words, lo, cols, segs in (
            (128, 160, -10, (0, 0), ((7, 6161), (6168, 6250))),
            (128, 300, -40, (37, 6001), ((0, 6613), (6613, 6150))),
            (1024, 1200, -300, (0, 0), ((331, 6150), (6481, 6200))),
            (2048, 2500, -500, (40, 7900), ((531, 6145), (6676, 6177))),
            (4096, 4500, -100, (5, 8000), ((131, 6300), (6431, 6211)))):
        t_scan = 9000
        t, peq = operands(n_words, t_scan)
        got = want = initial_state(ns, dev)
        for d, n in segs:
            if ck.wavefront_banded_form(ns, n) != "tiles":
                fail(f"wavefront_banded ns={ns} n_steps={n} does not take "
                     "the tiles")
            args = (d, n, n_words, t_scan, lo, *cols)
            before = got
            got = ck.wavefront_banded(t, peq, got, *args)
            want = on_host(ck.wavefront_banded_plain, t, peq, want, *args)
            check_equal(f"wavefront_banded tiles ns={ns} words={n_words} "
                        f"lo={lo} cols={cols} from step {d} ({n} steps)",
                        [got], [want])
            if (ns, d) == (128, 7):
                check_equal("wavefront_banded_tiles_plain ns=128 from step 7",
                            [on_host(ck.wavefront_banded_tiles_plain, t,
                                     peq, before, *args)], [want])


def check_wavefront_groups(rng, dev, ck):
    """The fixed-window wavefront's warp groups == wavefront_plain: ragged
    segment starts and lengths over 10 groups with rings of 1, 2 and 64
    tiles, passes forced to 3 and 4 groups, word0 > 0, a tracked range cut
    by a segment, a window of 6,144 slots (past the old block forms), and HW
    from step 0 over forced column cores (cores of 300 and 900 columns with
    a 2,560-column halo: the first cores' halos reach column 0, the later
    ones start fresh) with the stream and the tracked range, whole and cut
    runs; the schedule's plain emulation beside the first segment."""
    from edlib_tpu_torch.ops.wavefront import initial_state
    operands = functools.partial(wavefront_operands, rng, dev)

    def held(label, args, **kw):
        got = ck.wavefront(*args, **kw)
        want = on_host(ck.wavefront_plain, *args)
        check_equal(label, [got[0]] + ([got[1]] if args[11] else []),
                    [want[0]] + ([want[1]] if args[11] else []))
        return got[0], want

    for ns, n_words, word0, hin0, cols, segs, kw in (
            (384, 300, 0, 1, (0, 0), ((0, 97), (97, 613)), dict(ring=1)),
            (384, 300, 0, 0, (45, 700), ((13, 333), (346, 650)),
             dict(ring=2)),
            (384, 300, 0, 1, (0, 900), ((0, 410), (410, 500)),
             dict(pass_groups=3)),
            (1024, 900, 40, 1, (0, 0), ((440, 301), (741, 700)),
             dict(pass_groups=4, ring=2)),
            (6144, 6000, 0, 1, (10, 800), ((3001, 700), (3701, 431)), {})):
        t_scan = 1000
        t, peq = operands(n_words, t_scan)
        state = initial_state(ns, dev)
        for i, (d, n) in enumerate(segs):
            args = (t, peq, state, d, n, n_words, t_scan, hin0, *cols, word0,
                    True)
            label = (f"wavefront groups ns={ns} words={n_words} word0={word0}"
                     f" hin0={hin0} cols={cols} {kw} from step {d} ({n})")
            state, want = held(label, args, **kw)
            if (ns, i) == (384, 0) and kw == dict(ring=1):
                emu = on_host(ck.wavefront_groups_plain, *args, ring=1)
                check_equal("wavefront_groups_plain " + label,
                            list(emu), list(want))
    for core, steps, cols in ((300, None, (70, 5900)), (900, None, (0, 0)),
                              (900, 3100, (500, 2900))):
        n_words, t_scan = 40, 6000
        t, peq = operands(n_words, t_scan)
        n = t_scan + n_words - 1 if steps is None else steps
        if ck.wavefront_form(128, n_words, t_scan, 0, 0, 0, core)["cores"] < 3:
            fail(f"wavefront: core={core} does not give column cores")
        held(f"wavefront HW cores core={core} steps={n} cols={cols}",
             (t, peq, initial_state(128, dev), 0, n, n_words, t_scan, 0,
              *cols, 0, True), core=core)


def hw_state(dev, ck, peq, rows, n, nw, rng):
    """A random HW state a lane's sweep leaves (the pipelines' carry): each
    lane's exit state after a random row of 60 columns from fresh."""
    import torch
    pre = torch.from_numpy(rng.randint(0, 5, (n, 60)).astype(np.int32)).to(
        dev)
    fresh = (torch.full((n, nw), -1, dtype=torch.int32, device=dev),
             torch.zeros((n, nw), dtype=torch.int32, device=dev),
             torch.full((n,), nw * 32, dtype=torch.int32, device=dev))
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    return on_host(ck.reduce_resume_plain, peq, pre, zero, zero, rows, rows,
                   *fresh, 0)[4:]


def check_resume_split(rng, dev, ck):
    """The resumable reduce's split-lane schedule with a carry == its plain
    version: NW 1, 4 and 8, both hin0 (hin0 = 1 keeps one core a lane),
    forced cores of 1-40 columns, per-lane and shared rows, the edge lanes,
    from the fresh state and from a random carry (at hin0 = 0 an HW sweep's
    state, as the pipelines carry), every output and every word of the exit
    state; two chained segments equal one sweep; and its plain emulation
    beside the first."""
    import torch
    T = 251
    for nw, shared in ((1, False), (4, True), (8, False)):
        n = 300
        peq, targets, lo, hi, prow, trow = lane_operands(
            rng, dev, n_lanes=n, n_rows=6, T=T, s1=5, nw=nw)
        if shared:
            targets, trow = targets[:1].contiguous(), trow * 0
        edge_lanes(lo, hi, T)
        hi[5::7] = 0
        words = rng.randint(0, 1 << 32, (2, n, nw), dtype=np.uint64)
        pv0, mv0 = torch.from_numpy(
            words.astype(np.uint32).view(np.int32)).to(dev)
        random = (pv0, mv0 & ~pv0, torch.from_numpy(
            rng.randint(0, 400, n).astype(np.int32)).to(dev))
        fresh = (torch.full((n, nw), -1, dtype=torch.int32, device=dev),
                 torch.zeros((n, nw), dtype=torch.int32, device=dev),
                 torch.full((n,), nw * 32, dtype=torch.int32, device=dev))
        for hin0 in (0, 1):
            carries = (("fresh", fresh), (
                "carried", random if hin0 else hw_state(dev, ck, peq, prow,
                                                        n, nw, rng)))
            for what, carry in carries:
                ops = (peq, targets, lo, hi, prow, trow) + carry + (hin0,)
                want = on_host(ck.reduce_resume_plain, *ops)
                tag = f"nw={nw} shared={shared} hin0={hin0} {what}"
                for core in (1, 7, 40, None):
                    check_equal(f"reduce_resume split {tag} core={core}",
                                ck.reduce_resume(*ops, core=core), want)
                if (nw, what) == (1, "carried"):
                    check_equal(f"split_resume_plain {tag}",
                                on_host(ck.split_resume_plain, *ops, core=7),
                                want)
            cut = T // 2 + 1
            r1 = ck.reduce_resume(peq, targets[:, :cut].contiguous(),
                                  lo.clamp(max=cut), hi.clamp(max=cut), prow,
                                  trow, *fresh, hin0, core=9)
            r2 = ck.reduce_resume(peq, targets[:, cut:].contiguous(),
                                  (lo - cut).clamp(min=0),
                                  (hi - cut).clamp(min=0), prow, trow,
                                  *r1[4:], hin0, core=9)
            check_equal(f"reduce_resume split chained state nw={nw} "
                        f"hin0={hin0}", r2[4:], on_host(
                            ck.reduce_resume_plain, peq, targets, lo, hi,
                            prow, trow, *fresh, hin0)[4:])


def check_word_lanes(rng, dev, ck):
    """The word-parallel lane == the plain versions: reduce_resume where its
    plan is one core a lane (hin0 = 1; at hin0 = 0 one core forced), and
    sweep_scores and sweep_scores_resume, at NW 2-8 (segments of 2, 4 and 8
    threads, NW 3, 5, 6 and 7 padded), 70 lanes (at every width the last
    warp part empty), both hin0, from the fresh state and a random carry,
    the edge lanes (hi = 0, an empty window, lo past hi, hi past the row,
    both past it), ragged rows of 101 columns and rows of 2 and 5 columns
    (fewer columns than words), every output and every word of the exit
    state; two chained segments equal one sweep; the schedule's plain
    emulation beside the first.  The form and segment width each call
    reports are checked; the plain versions run on the host."""
    import torch
    n = 70
    for nw in range(2, 9):
        for T in ((101, 2, 5) if nw in (3, 8) else (101,)):
            peq, targets, lo, hi, prow, trow = lane_operands(
                rng, dev, n_lanes=n, n_rows=6, T=T, s1=5, nw=nw)
            edge_lanes(lo, hi, T)
            words = rng.randint(0, 1 << 32, (2, n, nw), dtype=np.uint64)
            pv0, mv0 = torch.from_numpy(
                words.astype(np.uint32).view(np.int32)).to(dev)
            random = (pv0, mv0 & ~pv0, torch.from_numpy(
                rng.randint(0, 400, n).astype(np.int32)).to(dev))
            fresh = (torch.full((n, nw), -1, dtype=torch.int32, device=dev),
                     torch.zeros((n, nw), dtype=torch.int32, device=dev),
                     torch.full((n,), nw * 32, dtype=torch.int32, device=dev))
            rows = (peq, targets, prow, trow)
            width = 2 if nw <= 2 else 4 if nw <= 4 else 8
            for hin0 in (0, 1):
                core = None if hin0 else T
                tag = f"nw={nw} T={T} hin0={hin0}"
                for what, carry in (("fresh", fresh), ("carried", random)):
                    ops = (peq, targets, lo, hi, prow, trow) + carry + (hin0,)
                    want = on_host(ck.reduce_resume_plain, *ops)
                    plan = {}
                    check_equal(f"reduce_resume words {tag} {what}",
                                ck.reduce_resume(*ops, core=core, plan=plan),
                                want)
                    check_form(f"reduce_resume {tag}", plan, "words",
                               width=width, cores=1)
                    if (nw, T, hin0, what) == (2, 101, 0, "carried"):
                        check_equal(f"reduce_resume_words_plain {tag} {what}",
                                    on_host(ck.reduce_resume_words_plain,
                                            *ops), want)
                    whole = on_host(ck.sweep_scores_resume_plain, *rows,
                                    *carry, hin0)
                    check_equal(f"sweep_scores_resume words {tag} {what}",
                                ck.sweep_scores_resume(*rows, *carry, hin0,
                                                       plan=plan),
                                whole)
                    check_form(f"sweep_scores_resume {tag}", plan, "words",
                               width=width)
                check_equal(f"sweep_scores words {tag}",
                            [ck.sweep_scores(*rows, hin0, plan=plan)],
                            [on_host(ck.sweep_scores_plain, *rows, hin0)])
                check_form(f"sweep_scores {tag}", plan, "words", width=width)
                if T < 100:
                    continue
                cut = T // 2 + 1
                halves = (targets[:, :cut].contiguous(),
                          targets[:, cut:].contiguous())
                r1 = ck.reduce_resume(peq, halves[0], lo, hi, prow, trow,
                                      *random, hin0, core=core and cut)
                r2 = ck.reduce_resume(peq, halves[1], lo, hi, prow, trow,
                                      *r1[4:], hin0, core=core and T - cut)
                s1 = ck.sweep_scores_resume(peq, halves[0], prow, trow,
                                            *random, hin0)
                s2 = ck.sweep_scores_resume(peq, halves[1], prow, trow,
                                            *s1[1:], hin0)
                # whole: the carried sweep's plain version, from the loop.
                check_equal(f"word lanes chained {tag}",
                            [r2[4], r2[5], r2[6],
                             torch.cat([s1[0], s2[0]], 1)] + list(s2[1:]),
                            list(whole[1:]) + list(whole))


def check_score_groups(rng, dev, ck):
    """The score stream's warp groups == the plain versions: lanes of 256,
    300 (a ragged last group) and 4,096 words with per-lane rows, rings of
    1, 2 and 64 tiles, both hin0, from the fresh state and a random carry
    (sweep_scores, sweep_scores_resume: the scores and every word of the
    exit state), in one launch and in passes forced to 4 and 48 groups
    (3 passes each: two lanes' records handed on between launches); two
    chained segments equal one sweep; the schedule's plain emulation beside
    the first.  The form, ring and passes each call reports are checked;
    the plain versions run on the host.  Last a lane too long for one
    launch, in passes unforced, against the wavefront."""
    import torch
    for nw, n, T, ring, hin0, passes in (
            (256, 2, 64, 1, 0, None), (300, 2, 49, 2, 1, None),
            (300, 2, 40, 64, 0, None), (300, 2, 45, 2, 1, 4),
            (4096, 1, 8, 2, 1, None), (4096, 2, 6, 64, 0, 48)):
        peq, targets, _, _, prow, trow = lane_operands(
            rng, dev, n_lanes=n, n_rows=2, T=T, s1=5, nw=nw)
        groups = -(-nw // 32)
        form = dict(groups=groups, ring=ring,
                    passes=-(-groups // (passes or groups)))
        rows = (peq, targets, prow, trow)
        words = rng.randint(0, 1 << 32, (2, n, nw), dtype=np.uint64)
        pv0, mv0 = torch.from_numpy(
            words.astype(np.uint32).view(np.int32)).to(dev)
        carry = (pv0, mv0 & ~pv0, torch.from_numpy(
            rng.randint(0, 400, n).astype(np.int32)).to(dev))
        tag = (f"nw={nw} lanes={n} T={T} ring={ring} hin0={hin0} "
               f"passes of {passes or groups}")
        kw = dict(ring=ring, pass_groups=passes)
        plan = {}
        want = on_host(ck.sweep_scores_plain, *rows, hin0)
        check_equal(f"sweep_scores groups {tag}",
                    [ck.sweep_scores(*rows, hin0, plan=plan, **kw)], [want])
        check_form(f"sweep_scores {tag}", plan, "groups", **form)
        if nw == 256 and ring == 1:    # one lane of the emulation
            one = (peq, targets, prow[:1], trow[:1])
            check_equal(f"sweep_scores_groups_plain {tag}",
                        [on_host(ck.sweep_scores_groups_plain, *one, hin0,
                                 ring=ring)[0]],
                        [want[:1]])
        if nw == 4096 and not passes:
            continue
        whole = on_host(ck.sweep_scores_resume_plain, *rows, *carry, hin0)
        check_equal(f"sweep_scores_resume groups {tag}",
                    ck.sweep_scores_resume(*rows, *carry, hin0, plan=plan,
                                           **kw),
                    whole)
        check_form(f"sweep_scores_resume {tag}", plan, "groups", **form)
        if nw == 4096:
            continue
        cut = T // 2 + 3
        s1 = ck.sweep_scores_resume(peq, targets[:, :cut].contiguous(), prow,
                                    trow, *carry, hin0, **kw)
        s2 = ck.sweep_scores_resume(peq, targets[:, cut:].contiguous(), prow,
                                    trow, *s1[1:], hin0, **kw)
        check_equal(f"sweep_scores_resume groups chained {tag}",
                    [torch.cat([s1[0], s2[0]], 1)] + list(s2[1:]),
                    list(whole))
    # A lane past the groups one launch keeps resident (4,375 groups, a
    # 4.48 Mbp query): passes with nothing forced, held against the
    # fixed-window wavefront's stream of the same pair.
    from edlib_tpu_torch.ops.wavefront import initial_state
    nw, T = 140_000, 64
    peq, targets, _, _, prow, trow = lane_operands(
        rng, dev, n_lanes=1, n_rows=1, T=T, s1=5, nw=nw)
    plan = {}
    t0 = time.perf_counter()
    got = ck.sweep_scores(peq, targets, prow, trow, 0, plan=plan)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if plan.get("form") != "groups" or plan.get("passes", 0) < 2:
        fail(f"sweep_scores nw={nw}: launched {plan}, not groups in passes")
    _, stream = ck.wavefront(targets[0], peq[0], initial_state(nw, dev), 0,
                             T + nw - 1, nw, T, 0, 0, 0, 0, True)
    check_equal(f"sweep_scores groups nw={nw} in passes vs the wavefront",
                [got[0]], [stream[nw - 1:]])
    log(f"sweep_scores nw={nw} x {T} cols: {plan['passes']} passes of "
        f"{plan['pass_groups']} groups, {ms:.1f} ms, equal the wavefront")


def check_split_hits(rng, dev, ck):
    """hits_lanes on its split-lane schedule (cores that own whole hit
    words) == its plain version: forced cores of 32, 64, 96 and 160
    columns and the unforced plan, at NW 1, 4 and 8, and NW 9 (one thread a
    lane whatever the core), hin0 0 (split) and 1 (one core a lane), 70
    lanes of ragged spans (lo mostly not a multiple of 32) with the edge
    lanes, per-lane rows and the shared row, best from the plain reduce
    with every 5th lane at -(1 << 30); the schedule's plain emulation
    beside the first case.  The form each call reports is checked; the
    plain versions run on the host."""
    T, n = 700, 70
    for nw, shared in ((1, False), (4, True), (8, False), (9, True)):
        peq, targets, lo, hi, prow, trow = lane_operands(
            rng, dev, n_lanes=n, n_rows=6, T=T, s1=5, nw=nw)
        if shared:
            targets, trow = targets[:1].contiguous(), trow * 0
        edge_lanes(lo, hi, T)
        lo[5::7] -= lo[5::7] % 32             # lo a multiple of 32
        ops = (peq, targets, lo, hi, prow, trow)
        for hin0 in (0, 1):
            best = on_host(ck.reduce_lanes_plain, *ops, hin0)[0].clone()
            best[::5] = -(1 << 30)
            want = on_host(ck.hits_lanes_plain, *ops, best, hin0)
            tag = f"nw={nw} shared={shared} hin0={hin0}"
            for core in (32, 64, 96, 160, None):
                plan = {}
                check_equal(f"hits_lanes split {tag} core={core}",
                            [ck.hits_lanes(*ops, best, hin0, core=core,
                                           plan=plan)], [want])
                c = ck.hits_core(n, T, nw, hin0, core)
                if c < T:
                    check_form(f"hits_lanes {tag} core={core}", plan,
                               "cores", core=c)
                else:
                    check_form(f"hits_lanes {tag} core={core}", plan,
                               "thread")
            if (nw, hin0) == (1, 0):
                check_equal(f"split_hits_plain {tag}",
                            [on_host(ck.split_hits_plain, *ops, best, hin0,
                                     core=64)], [want])


def check_word_hits(rng, dev, ck):
    """reduce_eqstream (#10) and hits_eqstream (#11) on the word-parallel
    lane == their plain versions: NW 2-8 (segments of 2, 4 and 8 threads),
    both hin0, 70 lanes with the edge lanes (hi past the row, lo past hi,
    lo a multiple of 32) and a profile row matching nothing (its lanes'
    bests tie over columns of different threads), rows of 197 columns (a hit word straddling two
    tiles) and at NW 3 and 8 also of 101, 5 and 2 columns (rows shorter
    than the words), the hits' best from the plain reduce with every 5th
    lane at -(1 << 30); the schedule's plain emulations beside one case;
    and the old forms, one thread a lane, at one word and on an empty
    stream (the reduce still writes its outputs).  The form and segment
    width each call reports are checked; the plain versions run on the
    host."""
    import torch
    n = 70
    for nw in range(2, 9):
        for T in ((197, 101, 5, 2) if nw in (3, 8) else (197,)):
            peq, targets, lo, hi, prow, trow = lane_operands(
                rng, dev, n_lanes=n, n_rows=6, T=T, s1=5, nw=nw)
            peq[0] = 0  # a row matching nothing: best ties across threads
            edge_lanes(lo, hi, T)
            lo[5::7] -= lo[5::7] % 32         # lo a multiple of 32
            eq_t = ck.eqstream_gather(peq[prow.long()],
                                      targets[trow.long()]).permute(1, 2, 0)
            width = 2 if nw <= 2 else 4 if nw <= 4 else 8
            for hin0 in (0, 1):
                tag = f"nw={nw} T={T} hin0={hin0}"
                reduced = on_host(ck.reduce_eqstream_plain, eq_t, lo, hi,
                                  hin0)
                plan = {}
                check_equal(f"reduce_eqstream words {tag}",
                            ck.reduce_eqstream(eq_t, lo, hi, hin0,
                                               plan=plan), reduced)
                check_form(f"reduce_eqstream {tag}", plan, "words",
                           width=width)
                best = reduced[0].clone()
                best[::5] = -(1 << 30)
                want = on_host(ck.hits_eqstream_plain, eq_t, lo, hi, best,
                               hin0)
                plan = {}
                check_equal(f"hits_eqstream words {tag}",
                            [ck.hits_eqstream(eq_t, lo, hi, best, hin0,
                                              plan=plan)], [want])
                check_form(f"hits_eqstream {tag}", plan, "words",
                           width=width)
                if (nw, T, hin0) == (3, 197, 1):
                    check_equal(f"reduce_eqstream_words_plain {tag}",
                                on_host(ck.reduce_eqstream_words_plain, eq_t,
                                        lo, hi, hin0), reduced)
                    check_equal(f"hits_words_plain {tag}",
                                [on_host(ck.hits_words_plain, eq_t, lo, hi,
                                         best, hin0)], [want])
    # The old forms: one word (a thread a lane) and an empty stream.
    peq, targets, lo, hi, prow, trow = lane_operands(
        rng, dev, n_lanes=n, n_rows=6, T=197, s1=5, nw=1)
    edge_lanes(lo, hi, 197)
    streams = (ck.eqstream_gather(peq[prow.long()], targets[trow.long()])
               .permute(1, 2, 0), torch.zeros((0, 4, n), dtype=torch.int32,
                                             device=dev))
    for eq_t in streams:
        T, nw = eq_t.shape[:2]
        for hin0 in (0, 1):
            tag = f"nw={nw} T={T} hin0={hin0}"
            reduced = on_host(ck.reduce_eqstream_plain, eq_t, lo, hi, hin0)
            plan = {}
            check_equal(f"reduce_eqstream thread {tag}",
                        ck.reduce_eqstream(eq_t, lo, hi, hin0, plan=plan),
                        reduced)
            check_form(f"reduce_eqstream {tag}", plan, "thread")
            if T == 0:
                continue
            best = hit_targets(rng, reduced)
            plan = {}
            check_equal(f"hits_eqstream thread {tag}",
                        [ck.hits_eqstream(eq_t, lo, hi, best, hin0,
                                          plan=plan)],
                        [on_host(ck.hits_eqstream_plain, eq_t, lo, hi, best,
                                 hin0)])
            check_form(f"hits_eqstream {tag}", plan, "thread")


# (n_win, nw, chunk, T, woff[0], slides at the chunk boundaries, cycled):
# tests/test_torch_band_capture_words.py's cases.
BAND_CASES = (
    (2, 2, 16, 70, 0, (0,)), (2, 9, 16, 131, 1, (1,)),
    (4, 12, 64, 300, 0, (2, 0, 1)), (4, 6, 32, 100, 0, (0,)),
    (8, 40, 16, 203, 3, (5, 0, 0, 2)), (12, 32, 256, 1000, 0, (8,)),
    (12, 20, 64, 250, 0, (1, 3)), (16, 16, 64, 157, 0, (0,)),
    (16, 40, 16, 190, 2, (3, 1)))


def check_banded_words(rng, dev, ck):
    """nw_banded on the word-parallel band == its plain version: n_win 2, 4,
    8, 12 and 16 (segments of 2, 4, 8 and 16 threads) over profiles of 2
    to 40 words, chunks of 16, 32, 64 and 256 columns, window offsets
    sliding by 0, 1 and several words at a boundary (the first one too),
    windows equal to the whole profile, rows ragged against the chunk and
    the tiles, 300 lanes with the edge lanes (hi = 0, hi past the row, hi -
    1 in a chunk whose window has not reached the bottom word, hi - 1 in
    the last chunk) and a profile row matching nothing (its lanes' bests
    tie over columns of different threads): the raw scores, values above
    any k and _BIG included; shw_banded and shw_banded_hits on the same
    bands (check_band_hits); the schedules' plain emulations beside the
    first case; and the one-thread form where
    the band cannot run (n_win 1, chunks of 8, 24 and 40 columns, n_win
    20), for both.  The form and segment width each call reports are
    checked; the plain versions run on the host."""
    import torch
    n = 300
    for i, (n_win, nw, chunk, T, first, slides) in enumerate(BAND_CASES):
        peq, targets, _, hi, prow, trow = lane_operands(
            rng, dev, n_lanes=n, n_rows=6, T=T, s1=5, nw=nw)
        peq[0] = 0      # a row matching nothing: best ties across threads
        n_chunks = -(-T // chunk)
        steps = [slides[j % len(slides)] for j in range(n_chunks - 1)]
        woff = np.minimum(first + np.concatenate([[0], np.cumsum(steps)]),
                          nw - n_win).astype(np.int32)
        woff[-1] = nw - n_win
        hi_h = hi.cpu().numpy()
        hi_h[1::5] = T + 1 + rng.randint(0, 9, len(hi_h[1::5]))
        hi_h[3::5] = T - rng.randint(0, T - (n_chunks - 1) * chunk,
                                     len(hi_h[3::5]))
        early = np.nonzero(woff != nw - n_win)[0]
        if len(early):
            c = min(int(early[-1]) * chunk + chunk - 1, T - 1)
            hi_h[2::5] = 1 + rng.randint(0, c + 1, len(hi_h[2::5]))
        hi = torch.from_numpy(hi_h).to(dev)
        band = (peq, targets, torch.from_numpy(woff).to(dev), hi, prow,
                trow, n_win, chunk)
        tag = f"n_win={n_win} nw={nw} chunk={chunk} T={T} woff={woff}"
        want = on_host(ck.nw_banded_plain, *band)
        plan = {}
        check_equal(f"nw_banded band {tag}", [ck.nw_banded(*band, plan=plan)],
                    [want])
        check_form(f"nw_banded {tag}", plan, "band",
                   width=ck.band_width(n_win, chunk))
        if i == 0:
            check_equal(f"nw_banded_words_plain {tag}",
                        [on_host(ck.nw_banded_words_plain, *band)], [want])
        check_band_hits(rng, ck, band, tag, "band",
                        width=ck.band_width(n_win, chunk), emulate=i == 0)
    # The one-thread form where the band cannot run: n_win = 1, chunks that
    # are not whole 16-column tiles (register windows of 4, 12 and 16 words),
    # n_win past 16 (the scratch window).
    for n_win, nw, chunk in ((1, 3, 64), (4, 9, 24), (12, 20, 40),
                             (16, 24, 8), (20, 40, 64)):
        T = 150
        peq, targets, _, hi, prow, trow = lane_operands(
            rng, dev, n_lanes=n, n_rows=6, T=T, s1=5, nw=nw)
        n_chunks = -(-T // chunk)
        woff = np.minimum(np.arange(n_chunks) * 2, nw - n_win).astype(
            np.int32)
        band = (peq, targets, torch.from_numpy(woff).to(dev), hi, prow,
                trow, n_win, chunk)
        tag = f"n_win={n_win} nw={nw} chunk={chunk}"
        plan = {}
        check_equal(f"nw_banded thread {tag}",
                    [ck.nw_banded(*band, plan=plan)],
                    [on_host(ck.nw_banded_plain, *band)])
        check_form(f"nw_banded {tag}", plan, "thread")
        check_band_hits(rng, ck, band, tag, "thread")


def check_band_hits(rng, ck, band, tag, form, emulate=False, **want_plan):
    """shw_banded (#7) and shw_banded_hits (#8) on nw_banded's operands
    `band` (peq, targets, woff, hi, prow, trow, n_win, chunk) with lo drawn
    beside hi (lo past hi on every 7th lane, a multiple of 32 on others),
    each == its plain version (on the host), the launches in `form`
    (want_plan their figures); the hits' best the card's banded reduce with
    every 5th lane at -(1 << 30); with emulate the band's plain emulations
    beside them."""
    import torch
    peq, targets, woff, hi, prow, trow, n_win, chunk = band
    T = targets.shape[1]
    hi_h = hi.cpu().numpy()
    lo_h = rng.randint(0, T // 2, len(hi_h))
    lo_h[4::7] = hi_h[4::7] + 2
    lo_h[5::7] -= lo_h[5::7] % 32
    lo = torch.from_numpy(lo_h.astype(np.int32)).to(hi.device)
    lanes = (peq, targets, woff, lo, hi, prow, trow)
    reduced = on_host(ck.shw_banded_plain, *lanes, n_win, chunk)
    plan = {}
    got = ck.shw_banded(*lanes, n_win, chunk, plan=plan)
    check_equal(f"shw_banded {form} {tag}", got, reduced)
    check_form(f"shw_banded {tag}", plan, form, **want_plan)
    if emulate:
        check_equal(f"shw_banded_words_plain {tag}",
                    on_host(ck.shw_banded_words_plain, *lanes, n_win, chunk),
                    reduced)
    best = got[0].clone()
    best[::5] = -(1 << 30)
    want = on_host(ck.shw_banded_hits_plain, *lanes, best, n_win, chunk)
    plan = {}
    check_equal(f"shw_banded_hits {form} {tag}",
                [ck.shw_banded_hits(*lanes, best, n_win, chunk, plan=plan)],
                [want])
    check_form(f"shw_banded_hits {tag}", plan, form, **want_plan)
    if emulate:
        check_equal(f"shw_banded_hits_words_plain {tag}",
                    [on_host(ck.shw_banded_hits_words_plain, *lanes, best,
                             n_win, chunk)], [want])


def check_capture_words(rng, dev, ck):
    """capture on its word groups over lanes == its plain version: NW 1, 4,
    8, 16, 17, 32 and 64 at 300 lanes (blocks of 8 lanes, the last one
    part-filled; a group a word), both hin0, with and without Ph/Mh, rows
    of 45 columns (a ragged last tile) and at NW 1, 16 and 64 also of 200
    padded with the wildcard to a ragged last chunk of 128; groups of 2,
    4 and 8 words (NW 100, 200, 300 and 500: a block past 512 threads at a
    word a group), blocks of 16 and 32 lanes (2,200 and 4,300 lanes); and
    the read-back form past 512 words (600); the schedule's plain
    emulation beside the first case.  The
    form, lanes a block and words a group each call reports are checked
    against capture_plan; the plain versions run on the host."""
    sms = ck._card_sms(dev)
    cases = [(nw, 300, T) for nw in (1, 4, 8, 16, 17, 32, 64)
             for T in ((45, 200) if nw in (1, 16, 64) else (45,))]
    cases += [(100, 60, 33), (200, 40, 20), (300, 300, 12), (500, 20, 4),
              (2, 2200, 37), (4, 4300, 20), (600, 3, 3)]
    for i, (nw, n, T) in enumerate(cases):
        peq, targets = lane_operands(rng, dev, n_lanes=n, n_rows=n, T=T,
                                     s1=5, nw=nw)[:2]
        want_plan = ck.capture_plan(nw, n, sms)
        form = want_plan.pop("form")
        for hin0 in (0, 1):
            for want_h in (False, True):
                if nw > 64 and (hin0, want_h) != (1, True):
                    continue
                tag = f"nw={nw} lanes={n} T={T} hin0={hin0} want_h={want_h}"
                # 200 columns padded to 256 as capture_flat_device pads.
                tg = ck._pad_cols(targets, 4, 128) if T == 200 else targets
                plan = {}
                got = ck.capture(peq, tg, hin0, want_h, plan=plan)
                want = on_host(ck.capture_plain, peq, tg, hin0, want_h)
                check_equal(f"capture words {tag}", got, want)
                check_form(f"capture {tag}", plan, form, **want_plan)
                if i == 0 and hin0 and want_h:
                    check_equal(f"capture_words_plain {tag}",
                                on_host(ck.capture_words_plain, peq, tg,
                                        hin0, want_h), want)


def check_resumable_kernels(rng, dev, ck):
    """The resumable reduce and the carry form of the score stream == their
    plain versions at small shapes: per-lane and shared target rows, both
    hin0, registers (NW 1, 4), scratch (9) and the wave form (300 words),
    from a fresh and a random carried state; two chained segments (the
    second ragged) equal one reduce_lanes / sweep_scores sweep of the joined
    columns, and their exit state one resumable sweep's."""
    import torch
    from edlib_tpu_torch.parallel.dist import merge_segments
    for nw, shared in ((1, False), (4, True), (9, False), (300, True)):
        n, T = (3, 24) if nw == 300 else (300, 200)
        peq, targets, lo, hi, prow, trow = lane_operands(
            rng, dev, n_lanes=n, n_rows=6, T=T, s1=5, nw=nw)
        if shared:
            targets, trow = targets[:1].contiguous(), trow * 0
        fresh = (torch.full((n, nw), -1, dtype=torch.int32, device=dev),
                 torch.zeros((n, nw), dtype=torch.int32, device=dev),
                 torch.full((n,), nw * 32, dtype=torch.int32, device=dev))
        words = rng.randint(0, 1 << 32, (2, n, nw), dtype=np.uint64)
        pv0, mv0 = torch.from_numpy(
            words.astype(np.uint32).view(np.int32)).to(dev)
        carried = (pv0, mv0 & ~pv0, torch.from_numpy(
            rng.randint(0, 400, n).astype(np.int32)).to(dev))
        cut = T // 2 + 1
        halves = (targets[:, :cut].contiguous(),
                  targets[:, cut:].contiguous())
        for hin0 in (0, 1):
            tag = f"nw={nw} shared={shared} hin0={hin0}"
            for state in (fresh, carried):
                lanes = (peq, targets, lo, hi, prow, trow) + state + (hin0,)
                check_equal(f"reduce_resume {tag}", ck.reduce_resume(*lanes),
                            on_host(ck.reduce_resume_plain, *lanes))
                rows = (peq, targets, prow, trow) + state + (hin0,)
                check_equal(f"sweep_scores_resume {tag}",
                            ck.sweep_scores_resume(*rows),
                            on_host(ck.sweep_scores_resume_plain, *rows))
            r1 = ck.reduce_resume(peq, halves[0], lo.clamp(max=cut),
                                  hi.clamp(max=cut), prow, trow, *fresh,
                                  hin0)
            r2 = ck.reduce_resume(peq, halves[1], (lo - cut).clamp(min=0),
                                  (hi - cut).clamp(min=0), prow, trow,
                                  *r1[4:], hin0)
            # Lanes with an empty window keep the pipelines' defaults.
            live = hi > lo
            check_equal(f"reduce_resume chained {tag}",
                        [x[live] for x in merge_segments(
                            [r1[:4], r2[:4]], cut, hi)],
                        [x[live] for x in ck.reduce_lanes(
                            peq, targets, lo, hi, prow, trow, hin0)])
            check_equal(f"reduce_resume chained state {tag}", r2[4:],
                        ck.reduce_resume(peq, targets, lo, hi, prow, trow,
                                         *fresh, hin0)[4:])
            s1 = ck.sweep_scores_resume(peq, halves[0], prow, trow, *fresh,
                                        hin0)
            s2 = ck.sweep_scores_resume(peq, halves[1], prow, trow, *s1[1:],
                                        hin0)
            check_equal(f"sweep_scores_resume chained {tag}",
                        [torch.cat([s1[0], s2[0]], 1)],
                        [ck.sweep_scores(peq, targets, prow, trow, hin0)])


def check_adaptive_kernel(rng, dev, ck):
    """hw_adaptive == its plain version, raw outputs and the word-columns
    each tile swept, at NW 1, 4 and 32 over two tiles of 1,024 lanes (reads
    with 6% substitutions planted in one shared target, and random reads),
    with and without the strong reduce."""
    import torch
    for nw, strong, k in ((1, 2, 6), (4, 4, 12), (4, 0, 40), (32, 2, 40),
                          (32, 0, 70)):
        qlen = nw * 32 - 5
        t_ids = rng.randint(0, 4, 400 if nw < 32 else 1500).astype(np.int32)
        reads, _ = make_batch(rng, t_ids, 4, 2048, qlen, 256, rate=0.06)
        q = torch.from_numpy(reads).to(dev)
        peq = ck.build_peq_device(
            q, torch.full((2048,), qlen, dtype=torch.int32, device=dev), 4,
            nw)
        W = nw * 32 - qlen
        tg = torch.full((1, len(t_ids) + W), 4, dtype=torch.int32,
                        device=dev)
        tg[0, :len(t_ids)] = torch.from_numpy(t_ids).to(dev)
        lo = torch.full((2048,), W, dtype=torch.int32, device=dev)
        hi = lo + len(t_ids)
        hi[1500:] -= 77                    # the second tile ends earlier
        rows = torch.arange(2048, dtype=torch.int32, device=dev)
        args = (peq, tg, lo, hi, rows, rows * 0, k, 0, 8, strong)
        live = torch.zeros(2, dtype=torch.int64, device=dev)
        live_plain = live.clone()
        got = ck.hw_adaptive(*args, live=live)
        want = ck.hw_adaptive_plain(*args, live=live_plain)
        check_equal(f"hw_adaptive nw={nw} strong_every={strong} k={k}",
                    list(got) + [live], list(want) + [live_plain])


# check_adaptive_cluster's cases: (nw, sigma, tiles, per-lane targets,
# hin0, columns, k, strong_every).
ADAPT_CLUSTER_CASES = ((1, 4, 2, False, 0, 600, 6, 2),
                       (4, 4, 3, False, 0, 600, 12, 4),
                       (32, 4, 2, False, 0, 700, 40, 2),
                       (33, 4, 2, False, 0, 500, 40, 2),
                       (160, 4, 2, False, 0, 200, 150, 1),
                       (32, 100, 2, False, 0, 400, 40, 2),
                       (8, 4, 3, True, 1, 500, 20, 3))


def check_adaptive_cluster(rng, dev, ck):
    """hw_adaptive's cluster launch == its plain version (on the host), raw
    outputs and the word-columns each tile swept, on ADAPT_CLUSTER_CASES:
    NW 1, 4, 32, 33 and 160 (the scratch form past 32) over two or three
    tiles whose windows end at different columns, sigma = 100 at 32 words
    (profile rows past a block's budget, so read from global memory), and
    per-lane targets at hin0 = 1; each with C left to the card (the first
    of adaptive_plans it admits) and forced down to 4, 2 and 1.  Every
    reported plan is checked: C within the cap, the scratch form past 32
    words, the staging adaptive_plan gives, and the card's own C (the
    largest admitted) at least 8 in the register form at 32 words."""
    import torch
    for nw, sigma, tiles, per_lane, hin0, cols, k, strong in \
            ADAPT_CLUSTER_CASES:
        # Reads shorter than the row where nw * 32 is not (their words past
        # qlen match every symbol).
        n = tiles * 1024
        qlen = min(nw * 32 - 5, cols // 2)
        t_ids = rng.randint(0, sigma, cols).astype(np.int32)
        reads, _ = make_batch(rng, t_ids, sigma, n, qlen, n // 8, rate=0.06)
        peq = ck.build_peq_device(
            torch.from_numpy(reads).to(dev),
            torch.full((n,), qlen, dtype=torch.int32, device=dev), sigma, nw)
        W = 5
        scan = np.concatenate([t_ids, np.full(W, sigma, np.int32)])
        if per_lane:
            rows = np.tile(scan, (n, 1))
            at = rng.randint(0, cols, n // 2)
            rows[np.arange(0, n, 2), at] = rng.randint(0, sigma, n // 2)
        else:
            rows = scan[None]
        tg = torch.from_numpy(rows).to(dev)
        lo = torch.full((n,), W, dtype=torch.int32, device=dev)
        hi = lo + cols
        for t in range(1, tiles):          # each tile ends elsewhere
            hi[t * 1024:] -= 37 * t
        lanes = torch.arange(n, dtype=torch.int32, device=dev)
        trow = lanes if per_lane else lanes * 0
        args = (peq, tg, lo, hi, lanes, trow, k, hin0, 8, strong)
        live_plain = torch.zeros(tiles, dtype=torch.int64)
        want = ck.hw_adaptive_plain(*[a.cpu() if isinstance(a, torch.Tensor)
                                      else a for a in args], live=live_plain)
        want = [w.to(dev) for w in want] + [live_plain.to(dev)]
        for cap in (None, 4, 2, 1):
            tag = (f"hw_adaptive nw={nw} sigma={sigma} tiles={tiles} "
                   f"per_lane={per_lane} hin0={hin0} cluster<={cap}")
            live = torch.zeros(tiles, dtype=torch.int64, device=dev)
            plan = {}
            got = ck.hw_adaptive(*args, live=live, cluster=cap, plan=plan)
            check_equal(tag, list(got) + [live], want)
            c = plan.get("cluster", 0)
            staged = ck.adaptive_plan(nw, sigma + 1, max(c, 1),
                                      plan.get("form") == "regs")["staged"]
            if (c < 1 or (cap is not None and c > cap)
                    or (nw > 32 and plan.get("form") != "scratch")
                    or (cap is None and nw <= 32
                        and plan.get("form") != "regs")
                    or plan.get("staged") != staged
                    or (sigma == 100 and nw == 32 and staged)):
                fail(f"{tag}: launched {plan}")
            if cap is None and nw == 32 and sigma == 4 and c < 8:
                fail(f"{tag}: launched {plan}, not on a cluster of at least "
                     "8 blocks")
            log(f"{tag}: equal, plan {plan}")


def check_split_kernels(rng, dev, ck):
    """K1, K3 and K2 with forced small cores (the split-lane schedule) ==
    their plain versions and the schedule's plain emulation: NW 1 and 4,
    both hin0 (hin0 = 1 must keep one core a lane), 300 lanes of ragged
    spans with the edge lanes (hi = 0, hi - 1 < lo, lo past hi, hi past the
    row), K3 with one and two alternatives and the wildcard in the
    targets; and at NW 9, where a forced core leaves the scratch form one
    thread a lane."""
    import torch
    T = 251
    for nw in (1, 4, 9):
        for hin0 in (0, 1):
            whole = ck.split_core(300, T, nw, hin0, core=3) == T
            if whole != (hin0 == 1 or nw > 8):
                fail(f"split_core nw={nw} hin0={hin0}: core=3 gives "
                     f"{ck.split_core(300, T, nw, hin0, core=3)}")
            peq, targets, lo, hi, prow, trow = lane_operands(
                rng, dev, n_lanes=300, n_rows=6, T=T, s1=5, nw=nw)
            edge_lanes(lo, hi, T)
            ops = (peq, targets, lo, hi, prow, trow, hin0)
            want = on_host(ck.reduce_lanes_plain, *ops)
            for core in (1, 2, 5, 17, 40):
                check_equal(f"reduce_lanes nw={nw} hin0={hin0} core={core}",
                            ck.reduce_lanes(*ops, core=core), want)
            check_equal(f"split_reduce_plain nw={nw} hin0={hin0}",
                        on_host(ck.split_reduce_plain, *ops, core=7), want)
            peq_t = torch.from_numpy(rng.randint(
                0, 1 << 32, (5, nw, 300), dtype=np.uint64).astype(
                    np.uint32).view(np.int32)).to(dev)
            target = torch.cat([targets[0], targets[0]]).contiguous()
            for col_lo, col_hi in ((0, 2 * T), (17, 390), (300, 3 * T)):
                want = on_host(ck.sweep_shared_plain, peq_t, target, hin0,
                               col_lo, col_hi)
                for core in (1, 6, 40):
                    check_equal(f"sweep_shared nw={nw} hin0={hin0} "
                                f"[{col_lo}, {col_hi}) core={core}",
                                ck.sweep_shared(peq_t, target, hin0, col_lo,
                                                col_hi, core=core), want)
                check_equal(f"split_shared_plain nw={nw} hin0={hin0}",
                            on_host(ck.split_shared_plain, peq_t, target,
                                    hin0, col_lo, col_hi, core=4),
                            want)


def bitplane_cases(rng, dev, ck, T):
    """K3's operand cases, one a (sigma, NW): 40 reads' bit planes (one
    alternative, two, and at sigma = 300 four), 300 lanes of T columns over
    the alphabet, the wildcard and the symbol past it, with the edge lanes:
    (sigma, nw, nb, pad, [(n_alts, q_alts)], targets, lo, hi, prow,
    trow)."""
    import torch
    for sigma, nw in ((100, 1), (100, 4), (100, 8), (100, 9), (300, 8)):
        nb = ck.bitplane_nb(sigma)
        q = torch.from_numpy(rng.randint(0, sigma, (40, nw * 32))
                             .astype(np.int32)).to(dev)
        qlens = torch.from_numpy(rng.randint(1, nw * 32 + 1, 40)
                                 .astype(np.int32)).to(dev)
        q_alts, pad = ck.bitplane_identity_operands(q, qlens, sigma, nw)
        alt = torch.from_numpy(np.where(
            rng.rand(*q_alts.shape) < 0.3, rng.randint(0, sigma, q_alts.shape),
            (1 << nb) - 1).astype(np.int32)).to(dev)
        _, targets, lo, hi, prow, trow = lane_operands(
            rng, dev, n_lanes=300, n_rows=40, T=T, s1=sigma + 2, nw=1)
        edge_lanes(lo, hi, T)
        alts = [(1, q_alts), (2, torch.cat([q_alts, alt], 1))]
        if sigma == 300:
            alts.append((4, torch.cat([q_alts, alt, alt.flip(0),
                                       alt.roll(1, 0)], 1)))
        yield sigma, nw, nb, pad, alts, targets, lo, hi, prow, trow


def check_bitplane_split(rng, dev, ck):
    """K3 with forced small cores == its plain version: NW 1, 4, 8 and 9
    (9: one thread a lane), both hin0, 300 lanes with the edge lanes over
    40 reads' bit planes, prow sorted
    (the main path's order: few rows a block, the profiles expanded in
    shared memory) and random (many rows a block: the planes staged), one
    and two alternatives, targets holding the wildcard and the symbol past
    it; and sigma = 300 at 8 words (nb = 9: profiles too large to expand,
    Eq from the staged planes), also with four alternatives (planes past
    the block's shared-memory budget even at 32 threads)
    (bitplane_cases)."""
    import torch
    for (sigma, nw, nb, pad, alts, targets, lo, hi, prow,
         trow) in bitplane_cases(rng, dev, ck, 131):
        hi[5::7] = 0
        for hin0 in (0, 1):
            for n_alts, qa in alts:
                planes = ck.bitplane_planes(qa.contiguous(), nb)
                for order, rows in (("sorted", torch.sort(prow)[0]),
                                    ("random", prow)):
                    bp = (planes, pad, targets, lo, hi, rows.contiguous(),
                          trow, hin0, nb, n_alts, sigma)
                    want = on_host(ck.reduce_bitplane_plain, *bp)
                    tag = (f"sigma={sigma} nw={nw} hin0={hin0} "
                           f"alts={n_alts} rows {order}")
                    for core in (None, 1, 7, 40):
                        check_equal(f"reduce_bitplane {tag} core={core}",
                                    ck.reduce_bitplane(*bp, core=core), want)


def check_hits_bitplane_split(rng, dev, ck):
    """hits_bitplane on its split-lane cores over K3's staged rows == its
    plain version: K3's operand cases (bitplane_cases: sigma 100 at NW 1,
    4, 8 and 9, sigma 300 at 8 words, the planes staged, also with four
    alternatives past the block's budget at 32 threads; rows sorted and
    random), both hin0, forced cores of 32, 64, 96 and 160 columns and the
    unforced plan (one core a lane on the split kernel, thread i lane i),
    300 lanes of 200 columns with the edge lanes and lo a multiple of 32 on
    every 7th, best from K3 with every 5th lane at -(1 << 30); NW 9 one
    thread a lane.  The form each call reports is checked; the plain
    versions run on the host (once a case: the sorted rows are the random
    ones' lanes permuted); the schedule's plain emulation beside the first
    case."""
    import torch
    T, n = 200, 300
    emulated = False
    for (sigma, nw, nb, pad, alts, targets, lo, hi, prow,
         trow) in bitplane_cases(rng, dev, ck, T):
        lo[5::7] -= lo[5::7] % 32
        order = torch.argsort(prow)
        for hin0 in (0, 1):
            for n_alts, qa in alts:
                planes = ck.bitplane_planes(qa.contiguous(), nb)
                ops = (planes, pad, targets, lo, hi, prow, trow)
                tail = (hin0, nb, n_alts, sigma)
                best = ck.reduce_bitplane(*ops, *tail)[0].clone()
                best[::5] = -(1 << 30)
                want = on_host(ck.hits_bitplane_plain, *ops, best, *tail)
                by_rows = (("random", ops + (best,), want),
                           ("sorted", ops[:3] + tuple(
                               x[order].contiguous()
                               for x in ops[3:] + (best,)), want[order]))
                tag = f"sigma={sigma} nw={nw} hin0={hin0} alts={n_alts}"
                for rows, args, w in by_rows:
                    for core in (32, 64, 96, 160, None):
                        plan = {}
                        check_equal(f"hits_bitplane {tag} rows {rows} "
                                    f"core={core}",
                                    [ck.hits_bitplane(*args, *tail,
                                                      core=core, plan=plan)],
                                    [w])
                        if nw > 8:
                            check_form(f"hits_bitplane {tag}", plan,
                                       "thread")
                        else:
                            check_form(f"hits_bitplane {tag} core={core}",
                                       plan, "cores",
                                       core=ck.hits_core(n, T, nw, hin0,
                                                         core))
                if not emulated:
                    check_equal(f"split_hits_bitplane_plain {tag}",
                                [on_host(ck.split_hits_bitplane_plain, *ops,
                                         best, *tail, core=64)], [want])
                    emulated = True


def wavefront_work(ck, name, args):
    """(bytes, ops) one wavefront call needs: 13 operations (OPS_PER_WORD)
    per advanced word-step, the word-steps counted from the call's own
    window and columns; the state read and written once, the stream
    written, the profile words of the window and the symbols of the columns
    it reaches read once."""
    t, peq, state, d0, n, n_words, t_scan = args[:7]
    ns = state.shape[1]
    if name == "wavefront":
        word0, emit = args[10], args[11]
        w = np.arange(word0, min(word0 + ns, n_words), dtype=np.int64)
        steps = np.minimum(d0 + n, w + t_scan) - np.maximum(d0, w)
        out_bytes = n * 4 if emit else 0
    else:
        lo, emit = args[7], False
        d = np.arange(d0, d0 + n, dtype=np.int64)
        b = np.minimum(np.maximum((d + lo - 31) // 33, 0),
                       max(0, n_words - ns))
        steps = (np.minimum(np.minimum(b + ns, n_words), d + 1)
                 - np.maximum(b, d - t_scan + 1))
        out_bytes = 0
    word_steps = int(np.clip(steps, 0, None).sum())
    nbytes = (2 * ck.WF_PLANES * ns * 4 + out_bytes
              + peq.shape[0] * min(ns, n_words) * 4 + min(n + ns, t_scan) * 4)
    return nbytes, word_steps * OPS_PER_WORD


def measure_wavefront(ck, name, calls):
    """The wavefront kernel's time over every recorded call of a path (CUDA
    events around the whole sequence, after one warm pass), the bound summed
    over the calls, and the kernel held against its plain version over
    WF_PLAIN_STEPS steps of the first, middle and last calls' operands."""
    import torch
    kernel = getattr(ck, name)
    plain = getattr(ck, name + "_plain")

    def run_all():
        for a in calls:
            kernel(*a)

    ms = time_ms(run_all, 1)
    nbytes = ops = 0
    b_ms = 0.0
    for a in calls:
        nb, op = wavefront_work(ck, name, a)
        nbytes, ops = nbytes + nb, ops + op
        b_ms += bound(nb, op)[0]
    err, plain_ms, plain_steps, forms_held = 0.0, 0.0, 0, []
    # Each held call runs the launch form the path's call ran: wavefront_banded
    # over at least the tiles' 6,144 steps (cuda_kernel.wavefront_banded_form),
    # wavefront over WF_PLAIN_STEPS steps, or where the path's call runs
    # column cores (wavefront_form) over two cores and the query, so that a
    # core swept from the fresh state a halo before its own is held too.
    for i in sorted({0, len(calls) // 2, len(calls) - 1}):
        a = list(calls[i])
        if name == "wavefront_banded":
            a[4] = min(a[4], max(WF_PLAIN_STEPS, ck._WF_TILES_MIN_STEPS))
            ns, form = a[2].shape[1], ck.wavefront_banded_form(
                a[2].shape[1], calls[i][4])
            held_form = ck.wavefront_banded_form(ns, a[4])
        else:
            form = wavefront_plan(ck, calls[i])
            a[4] = min(a[4], WF_PLAIN_STEPS if form["cores"] == 1
                       else 2 * form["core"] + a[5])
            held_form = wavefront_plan(ck, a)
        if held_form != form:
            fail(f"{name}: the held call {i} ({a[4]} steps) runs another "
                 f"form ({held_form}) than the path's ({calls[i][4]} steps, "
                 f"{form})")
        forms_held.append(form)
        got = kernel(*a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(*a)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        plain_steps += a[4]
        if isinstance(got, torch.Tensor):
            got, want = (got, None), (want, None)
        err = max(err, check_equal(
            f"{name} on main-path operands (call {i}, step {a[3]}, "
            f"{a[4]} steps)",
            [x for x in got if x is not None],
            [x for x in want if x is not None]))
    steps = sum(a[4] for a in calls)
    ns = calls[0][2].shape[1]
    summary = dict(segments=len(calls), slots=ns, cols=steps, ms=ms,
                   us_per_step=ms * 1e3 / max(steps, 1), plain_ms=plain_ms,
                   plain_cols=plain_steps, bound_ms=b_ms,
                   plain_forms=forms_held)
    if name == "wavefront":
        # The plan of each call (cores, core length, warp groups), and for
        # calls cut into column cores the same calls with one core (the
        # groups alone, core = t_scan).
        summary["forms"] = [wavefront_plan(ck, a) for a in calls]
        cored = [a for a in calls if wavefront_plan(ck, a)["cores"] > 1]
        if cored:
            summary["one_core_ms"] = time_ms(lambda: [
                kernel(*a, core=a[6]) for a in cored], 1)
            summary["cored_ms"] = time_ms(lambda: [kernel(*a)
                                                   for a in cored], 1)
    if name == "wavefront_banded":
        # The segments each form ran (cuda_kernel.wavefront_banded_form),
        # the tile width, and each form's time on its own segments.
        forms = {}
        for a in calls:
            forms.setdefault(ck.wavefront_banded_form(a[2].shape[1], a[4]),
                             []).append(a)
        summary.update(tile_cols=ck.WF_TILE, forms={
            f: dict(segments=len(c), steps=sum(a[4] for a in c),
                    ms=time_ms(lambda c=c: [kernel(*a) for a in c], 1))
            for f, c in forms.items()})
    log(f"{name}: {len(calls)} calls, {steps} steps over {ns} slots, kernel "
        f"{ms:.3f} ms ({summary['us_per_step']:.4f} us a step; bound "
        f"{b_ms:.3f} ms), plain {plain_ms:.1f} ms over {plain_steps} steps"
        f" of forms {forms_held}, equal"
        + (f"; forms {summary['forms']}" if "forms" in summary else "")
        + (f"; cored {summary['cored_ms']:.3f} ms, one core "
           f"{summary['one_core_ms']:.3f} ms" if "one_core_ms" in summary
           else ""))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, nbytes=nbytes,
                ops=ops, max_abs_err=err, bound_by=bound(nbytes, ops)[1],
                calls=[summary])


def wavefront_plan(ck, a):
    """A recorded wavefront call's launch plan (cuda_kernel.wavefront_form):
    its column cores, their length and its warp groups."""
    _, _, state, d0, _, n_words, t_scan, hin0 = a[:8]
    return ck.wavefront_form(state.shape[1], n_words, t_scan, d0, hin0, a[10])


def banded_form_crossover(ck, call):
    """wavefront_banded's two launch forms timed against each other on one
    recorded call's operands (a fresh window of 1,024 and of 4,096 slots
    at the call's step), for segments of 2,048 to 16,384 steps: where the
    tiles overtake a step a barrier (cuda_kernel.wavefront_banded_form)."""
    from edlib_tpu_torch.ops.wavefront import initial_state
    t, peq, state, d0, _, n_words, t_scan, lo = call[:8]
    out = []
    for ns in (1024, 4096):
        fresh = initial_state(ns, state.device)
        for n in (2048, 4096, 8192, 16384):
            row = dict(slots=ns, steps=n, rule=ck.wavefront_banded_form(ns, n))
            for form in ("tiles", "steps"):
                row[f"{form}_ms"] = time_ms(lambda: ck.wavefront_banded(
                    t, peq, fresh, d0, n, n_words, t_scan, lo, 0, 0,
                    form=form), 3)
            out.append(row)
    log(f"wavefront_banded form crossover: {out}")
    return out


# --------------------------------------------------------------------------
# Recording the main path's launches, and timing them
# --------------------------------------------------------------------------


class Recorder:
    """Wraps the kernel wrappers in cuda_kernel so that a main-path run keeps
    each call's operands (the launch counts stay on the wrappers)."""

    def __init__(self, ck):
        self.ck = ck
        self.orig = {k.__name__: k for k in ck.KERNELS}
        self.calls = {name: [] for name in self.orig}
        self.on = False
        for name, fn in self.orig.items():
            setattr(ck, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if self.on:
                self.calls[name].append(args)
            return fn(*args, **kw)
        return call

    def take(self):
        calls = self.calls
        self.calls = {name: [] for name in self.orig}
        return calls


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean CUDA-event time of reps calls, after one warm-up call unless
    the caller has just made one (warm=False)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_call(fn, top: int = 8, groups=None) -> dict:
    """Device time of one call by kernel (torch.profiler over CUPTI), the
    call's wall time, and the device's idle share of that wall time; with
    groups ({label: substring or tuple of them}) also the device time of the
    kernels whose name holds one of a label's substrings."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # Device-side events only: a CPU op's row repeats its kernels' time.
    rows = [(e.key, dev_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall,
           "top": [{"name": k[:80], "device_ms": ms, "count": c}
                   for k, ms, c in rows[:top]]}
    for label, subs in (groups or {}).items():
        subs = (subs,) if isinstance(subs, str) else subs
        out[label + "_device_ms"] = sum(ms for k, ms, _ in rows
                                        if any(s in k for s in subs))
    return out


# The forms the redesigned kernels must report on their paths (phase 7's
# hits_lanes: several cores a lane; phase 10's hits_bitplane: the split
# kernel, one core a lane of whole hit words; phase 18's hits_eqstream and
# phases 18 and 19's reduce_eqstream: the word-parallel lane, segments of 4
# threads; phases 8 and 12's nw_banded and phase 9's shw_banded and
# shw_banded_hits: the word-parallel band, 16 threads a lane at their
# 12-16-word windows; phases 11 and 12's capture: word groups over 8, 16 or
# 32 lanes a block).
NEW_FORMS = {"hits_lanes": ("cores", lambda p: p.get("cores", 0) > 1),
             "hits_bitplane": ("cores",
                               lambda p: p.get("core", 0) % 32 == 0),
             "hits_eqstream": ("words", lambda p: p.get("width") == 4),
             "reduce_eqstream": ("words", lambda p: p.get("width") == 4),
             "nw_banded": ("band", lambda p: p.get("width") == 16),
             "shw_banded": ("band", lambda p: p.get("width") == 16),
             "shw_banded_hits": ("band", lambda p: p.get("width") == 16),
             "capture": ("lane_words",
                         lambda p: p.get("lanes") in (8, 16, 32)),
             "hw_adaptive": ("regs", lambda p: p.get("cluster", 0) >= 8)}

# The wrappers that take plan= (their C entries report what they launched).
PLANNED = ("reduce_resume", "sweep_scores", "sweep_scores_resume",
           "hits_lanes", "hits_bitplane", "hits_eqstream", "reduce_eqstream",
           "nw_banded", "shw_banded", "shw_banded_hits", "capture",
           "hw_adaptive")

# The kernels whose calls phase 13 also traces, with substrings of their
# CUDA kernels' names (the traced device time sums the kernels that hold
# one): the short calls, whose event times hold their wrappers' host work.
TRACED = {
    "reduce_bitplane": ("reduce_bitplane",),
    "hits_lanes": ("hits_lanes",),
    "hits_bitplane": ("hits_bitplane",),
    "nw_banded": ("nw_banded",),
    "shw_banded": ("shw_banded_kernel", "shw_banded_words_kernel"),
    "shw_banded_hits": ("shw_banded_hits",),
    "capture": ("capture_kernel", "capture_words_kernel"),
    "reduce_eqstream": ("reduce_eqstream",),
    "hits_eqstream": ("hits_eqstream",),
    "sweep_scores": ("sweep_scores", "words_kernel"),
}


def check_new_forms(name, m, path) -> None:
    """The redesigned kernels run their new forms on their paths (NEW_FORMS):
    every measured call's reported plan."""
    for c in m["calls"] if name in NEW_FORMS else ():
        form, want = NEW_FORMS[name]
        if c["plan"].get("form") != form or not want(c["plan"]):
            fail(f"{name} on {path} launched {c['plan']}, not the "
                 f"{form} form this path takes")


def launch_ms(ck, fn, reps: int) -> float:
    """Device milliseconds of the kernel launches of one fn() call, the mean
    over reps calls: CUDA events recorded just before and after each C
    launch (cuda_kernel._launch), with a sleep kernel queued first so that
    the stream is busy while the event, the kernel and the event are queued
    and they run back to back, whatever host work the wrapper does around
    them (the events bracket the launch alone)."""
    import torch
    orig, pairs = ck._launch, []

    def bracketed(*a):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        orig(*a)
        stop.record()
        pairs.append((start, stop))

    ck._launch = bracketed
    try:
        for _ in range(reps):
            fn()
    finally:
        ck._launch = orig
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


# About 0.5 ms at the H100's boost clock: longer than the host's event
# record and C call that follow the sleep kernel into the queue.
SLEEP_CYCLES = 1_000_000


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


def call_plan(ck, name, args):
    """(bytes, ops, lanes, cols, words, plain args, plain cols) of one
    recorded call.  Operations per lane-column: 13 per advanced word
    (OPS_PER_WORD), plus OPS_PER_COLUMN for the score and the reduction or
    hit mask.  The bit-plane Eq is built once per profile row a lane reads,
    as a 2^nb-symbol profile (the least work: the columns then read Eq as
    K1 does): NW words a symbol, each one 3-input op per plane and
    alternative, the OR into the word per alternative and the OR of pad
    and wildcard, n_alts * (nb + 1) + 1 operations.  A call's
    plain version runs over at most its first SHARED_PLAIN_COLS columns
    and PLAIN_WORD_COLS word-columns (the kernel is held on the same
    prefix).  The score stream writes every lane-column's score; the
    eq-stream kernels read NW words for every column a lane scans."""
    import torch
    if name == "sweep_scores":
        peq, targets, prow, trow, hin0 = args
        n, T, nw = prow.shape[0], targets.shape[1], peq.shape[2]
        full = torch.full((n,), T, dtype=torch.int64, device=prow.device)
        nbytes, ops = lane_call_cost(peq.shape[1] * nw, targets, full, prow,
                                     trow, 2, nw * OPS_PER_WORD + 1, n * T * 4)
        plain_cols = min(T, SHARED_PLAIN_COLS, max(8, PLAIN_WORD_COLS // nw))
        checked = args if plain_cols == T else (
            peq, targets[:, :plain_cols].contiguous(), prow, trow, hin0)
        return nbytes, ops, n, T, nw, checked, plain_cols
    if name == "sweep_scores_resume":
        peq, targets, prow, trow, pv0, mv0, s0, hin0 = args
        n, T, nw = prow.shape[0], targets.shape[1], peq.shape[2]
        full = torch.full((n,), T, dtype=torch.int64, device=prow.device)
        nbytes, ops = lane_call_cost(peq.shape[1] * nw, targets, full, prow,
                                     trow, 2 + 2 * (2 * nw + 1),
                                     nw * OPS_PER_WORD + 1, n * T * 4)
        plain_cols = min(T, SHARED_PLAIN_COLS, max(8, PLAIN_WORD_COLS // nw))
        checked = (peq, targets[:, :plain_cols].contiguous()) + args[2:]
        return nbytes, ops, n, T, nw, checked, plain_cols
    if name == "reduce_resume":
        # Every lane sweeps every column of its segment (for the exit
        # state), whatever its window; the state is read and written.
        peq, targets, lo, hi, prow, trow = args[:6]
        n, T, nw = prow.shape[0], targets.shape[1], peq.shape[2]
        full = torch.full((n,), T, dtype=torch.int64, device=prow.device)
        nbytes, ops = lane_call_cost(peq.shape[1] * nw, targets, full, prow,
                                     trow, 4 + 2 * (2 * nw + 1),
                                     nw * OPS_PER_WORD + OPS_PER_COLUMN,
                                     n * 4 * 4)
        plain_cols = min(T, SHARED_PLAIN_COLS, max(8, PLAIN_WORD_COLS // nw))
        checked = (peq, targets[:, :plain_cols].contiguous()) + args[2:]
        return nbytes, ops, n, T, nw, checked, plain_cols
    if name == "hw_adaptive":
        # The operations the band admitted: 13 per live word-column of each
        # tile (the kernel counts them) for its 1,024 lanes, and the score
        # and reduction for every lane-column.
        peq, targets, lo, hi, prow, trow = args[:6]
        n, nw = prow.shape[0], peq.shape[2]
        live = torch.zeros(n // 1024, dtype=torch.int64, device=prow.device)
        getattr(ck.hw_adaptive, "__wrapped__", ck.hw_adaptive)(*args,
                                                               live=live)
        end = min(targets.shape[1], int(hi.max())) if n else 0
        nbytes, _ = lane_call_cost(peq.shape[1] * nw, targets, hi, prow,
                                   trow, 4, 0, n * 3 * 4)
        ops = (int(live.sum()) * 1024 * OPS_PER_WORD
               + int(hi.long().clamp(0, targets.shape[1]).sum())
               * OPS_PER_COLUMN)
        plain_cols = min(end, SHARED_PLAIN_COLS,
                         max(8, PLAIN_WORD_COLS // nw))
        checked = (peq, targets[:, :plain_cols].contiguous()) + args[2:]
        return nbytes, ops, n, end, nw, checked, plain_cols
    if name in ("reduce_eqstream", "hits_eqstream"):
        eq_t, lo, hi = args[:3]
        T, nw, n = eq_t.shape
        lane_cols = int(hi.long().clamp(0, T).sum())
        end = min(T, int(hi.max())) if n else 0
        hits = name == "hits_eqstream"
        nbytes = (lane_cols * nw * 4 + n * (3 if hits else 2) * 4
                  + n * (-(-T // 32) if hits else 4) * 4)
        ops = lane_cols * (nw * OPS_PER_WORD + OPS_PER_COLUMN)
        plain_cols = min(end, SHARED_PLAIN_COLS, max(8, PLAIN_WORD_COLS // nw))
        checked = args if plain_cols == end else (
            (eq_t[:plain_cols],) + tuple(args[1:]))
        return nbytes, ops, n, end, nw, checked, plain_cols
    if name == "capture":
        # Profiles and targets read once, every output word written once.
        peq, targets, _, want_h = args
        B, _, nw = peq.shape
        T = targets.shape[1]
        out_bytes = (4 if want_h else 2) * B * T * nw * 4
        return ((peq.numel() + targets.numel()) * 4 + out_bytes,
                B * T * nw * OPS_PER_WORD, B, T, nw, args, T)
    if name == "sweep_shared":
        peq_t, target, hin0, col_lo, col_hi = args
        nw, n = peq_t.shape[1], peq_t.shape[2]
        end = min(target.shape[0], col_hi)
        plain_cols = min(end, SHARED_PLAIN_COLS)
        return (peq_t.numel() * 4 + end * 4 + n * 8,
                n * end * (nw * OPS_PER_WORD + OPS_PER_COLUMN_SHARED), n,
                end, nw, (peq_t, target, hin0, col_lo, plain_cols),
                plain_cols)
    params = tuple(inspect.signature(getattr(ck, name)).parameters)
    a = dict(zip(params, args))
    targets, hi = a["targets"], a["hi"]
    n = hi.shape[0]
    end = min(targets.shape[1], int(hi.max())) if n else 0
    expand_ops = 0
    if "planes" in a:
        nw, nb, n_alts = a["pad"].shape[1], a["nb"], a["n_alts"]
        words = a["planes"].shape[1] + nw
        ops_col = nw * OPS_PER_WORD + OPS_PER_COLUMN
        read = a["prow"][hi.long().clamp(0, targets.shape[1]) > 0]
        expand_ops = (int(torch.unique(read).numel()) * (1 << nb) * nw
                      * (n_alts * (nb + 1) + 1))
    else:
        nw = a["n_win"] if "n_win" in a else a["peq"].shape[2]
        words = a["peq"].shape[1] * a["peq"].shape[2]
        ops_col = nw * OPS_PER_WORD + OPS_PER_COLUMN
    checked, plain_cols = args, end
    if end > SHARED_PLAIN_COLS:
        # The plain version over a prefix: 3 staging chunks and a ragged
        # tail of every target row (the kernel reruns on the same prefix).
        plain_cols = SHARED_PLAIN_COLS
        checked = tuple(
            v[:, :plain_cols].contiguous() if k == "targets" else v
            for k, v in a.items())
    if "best" in a:
        out_bytes = n * -(-targets.shape[1] // 32) * 4
    else:
        out_bytes = n * 4 * (4 if name in ("reduce_lanes", "reduce_bitplane")
                             else 3 if name == "shw_banded" else 1)
    n_vecs = sum(k in a for k in ("lo", "hi", "prow", "trow", "best"))
    nbytes, ops = lane_call_cost(words, targets, hi, a["prow"], a["trow"],
                                 n_vecs, ops_col, out_bytes)
    return nbytes, ops + expand_ops, n, end, nw, checked, plain_cols


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def split_vs_whole(ck, name, args, reps):
    """K1's, K3's, K2's, #5's or the resumable reduce's split-lane launch on
    a recorded call's operands held exactly against the same kernel with
    one core a lane (core = the row length), and the plan and time of
    both."""
    import torch
    kernel = getattr(ck, name)
    n_cols = args[2 if name == "reduce_bitplane" else 1].shape[-1]
    whole = lambda: kernel(*args, core=n_cols)
    got, want = kernel(*args), whole()
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    check_equal(f"{name}: the split launch against one core a lane", got,
                want)
    if name == "hits_lanes":
        peq, targets, lo, hi, _, _, _, hin0 = args
        core = ck.hits_core(lo.shape[0], n_cols, peq.shape[2], hin0)
        threads = int(ck.split_cores(lo, hi, n_cols, core, True)[2].sum())
    elif name == "reduce_resume":
        peq, _, lo = args[:3]
        core, k = ck.resume_cores(lo.shape[0], n_cols, peq.shape[2], args[9])
        threads = lo.shape[0] * k
    elif name in ("reduce_lanes", "reduce_bitplane"):
        if name == "reduce_lanes":
            peq, targets, lo, hi, _, _, hin0 = args
            nw = peq.shape[2]
        else:
            _, pad, targets, lo, hi, _, _, hin0 = args[:8]
            nw = pad.shape[1]
        core = ck.split_core(lo.shape[0], n_cols, nw, hin0)
        threads = int(ck.split_cores(lo, hi, n_cols, core)[2].sum())
    else:
        peq_t, target, hin0, col_lo, col_hi = args
        span = ck._shared_span(n_cols, col_lo, col_hi)
        core = ck.split_core(peq_t.shape[2], span, peq_t.shape[1], hin0)
        threads = peq_t.shape[2] * -(-span // core)
    return dict(core=core, threads=threads,
                whole_ms=time_ms(whole, reps))


def measure(ck, name, calls):
    """Kernel time, plain time and bound summed over a path's calls of one
    kernel, the first, middle and last calls' outputs held against their
    plain versions' on the calls' operands (see call_plan for the columns
    the plain version runs)."""
    import torch
    kernel = getattr(ck, name)
    plain = getattr(ck, name + "_plain")
    out = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, nbytes=0, ops=0,
               max_abs_err=0.0, calls=[])
    held = {0, len(calls) // 2, len(calls) - 1}
    for i, args in enumerate(calls):
        nbytes, ops, n, end, nw, checked, plain_cols = call_plan(
            ck, name, args)
        # The warm-up call sets the repetitions: one for a call of seconds
        # (a single lane of thousands of words).
        _, first_s = timed(lambda: kernel(*args))
        reps = 1 if first_s > 0.5 else 3 if end * n > 1e8 else 10
        ms = time_ms(lambda: kernel(*args), reps, warm=False)
        traced = None
        if name in TRACED:
            # Short calls can be shorter than their wrapper's host work,
            # which the event time then includes: a second batch, traced,
            # gives the kernels' own device time and the device's idle share
            # (not its event time: the profiler slows the host further).
            trace = profile_call(lambda: [kernel(*args) for _ in range(reps)],
                                 top=4, groups={"kernel": TRACED[name]})
            traced = dict(device_ms=trace["kernel_device_ms"] / reps,
                          idle_share=trace["device_idle_share"],
                          launch_ms=launch_ms(ck, lambda: kernel(*args),
                                              reps))
        plain_ms = 0.0
        if i not in held:
            plain_cols = 0
        else:
            got = kernel(*checked)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain(*checked)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if isinstance(got, torch.Tensor):
                got, want = [got], [want]
            out["max_abs_err"] = max(out["max_abs_err"], check_equal(
                f"{name} on main-path operands", got, want))
            del got, want
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        b, _ = bound(nbytes, ops)
        out["bound_ms"] += b
        out["nbytes"] += nbytes
        out["ops"] += ops
        call = dict(lanes=n, cols=end, nw=nw, ms=ms, plain_ms=plain_ms,
                    plain_cols=plain_cols, bound_ms=b)
        if traced:
            call["traced"] = traced
        if name in ("reduce_lanes", "reduce_bitplane", "sweep_shared",
                    "reduce_resume", "hits_lanes"):
            call.update(split_vs_whole(ck, name, args, reps))
        if name in PLANNED:
            # What the kernel launched on these operands, as it reports it.
            call["plan"] = {}
            kernel(*args, plan=call["plan"])
        out["calls"].append(call)
        log(f"{name} call: {n} lanes x {end} cols (nw {nw}), kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms over {plain_cols} cols"
            + (", equal" if i in held else "")
            + (f" (traced: device {traced['device_ms']:.3f} ms a call, "
               f"idle {traced['idle_share']:.3f}; the launches alone "
               f"{traced['launch_ms']:.4f} ms)" if traced else "")
            + (f"; {call['threads']} threads of {call['core']} cols, one "
               f"core a lane {call['whole_ms']:.3f} ms, equal"
               if "core" in call else "")
            + (f"; plan {call['plan']}" if "plan" in call else ""))
        torch.cuda.empty_cache()
    out["bound_by"] = bound(out["nbytes"], out["ops"])[1]
    return out


def kernel_entry(name, m, launches, path, card):
    """One kernel's record in the kernels line."""
    return {
        "name": name, "route": "cuda",
        "source": KERNEL_SOURCE.get(name, KERNEL_SOURCE_DEFAULT),
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "plain_cols": sum(c["plain_cols"] for c in m["calls"]),
        "cols": sum(c["cols"] for c in m["calls"]),
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "library_ms": None, "path": path, "calls": m["calls"], "card": card}


def drive(ck, rec, label, call, required):
    """One path through its public entry point: launch counts zeroed just
    before the call and read just after, every kernel call's operands
    recorded, then a warm repeat that must return the same."""
    import torch
    from edlib_tpu_torch import batch as tb
    ck.reset_launch_counts()
    tb.reset_path_route_counts()
    rec.on = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    rec.on = False
    launches = ck.launch_counts()
    routes = tb.path_route_counts()
    calls = rec.take()
    log(f"{label}: {cold:.2f} s cold, launches {launches}, PATH windows "
        f"{routes}")
    for name in required:
        if launches[name] == 0:
            fail(f"{label} never launched {name}")
    t0 = time.perf_counter()
    again = call()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    if again != out:
        fail(f"{label}: a second call on the same batch disagrees")
    return out, launches, calls, cold, warm, routes


def check_align(label, align_batch, out, queries, targets, q_ids, t_ids,
                mode, task, rng, cpu_refs, cpu_key=None, eqs=None):
    """align_batch's results: one per pair, distances in range, a
    subsample of SUBSAMPLE pairs equal to device="cpu" (a shared target
    stays shared; with the same equalities eqs), DP_SAMPLES of them equal
    to the numpy DP (q_ids, t_ids: symbols, or with equalities their
    classes, which the DP compares).  Phases that
    name one cpu_key run the same batch: the first runs the device="cpu"
    reference once with task "path" (its editDistance, alphabetLength and
    locations are the other tasks' answers) on one subsample, kept in
    cpu_refs, and every such phase compares against it."""
    shared = isinstance(targets, bytes)
    if len(out) != len(queries):
        fail(f"{label}: {len(out)} results for {len(queries)} pairs")
    for i, r in enumerate(out):
        if not (0 <= r["editDistance"] <= len(queries[i]) + (
                0 if shared else len(targets[i]))) or not r["locations"]:
            fail(f"{label}: pair {i} has no valid result: {r}")
    t0 = time.perf_counter()
    if cpu_key in cpu_refs:
        idx, ref = cpu_refs[cpu_key]
    else:
        idx = np.sort(rng.choice(len(queries), SUBSAMPLE, replace=False))
        ref = align_batch([queries[i] for i in idx],
                          targets if shared else [targets[i] for i in idx],
                          mode=mode, task="path" if cpu_key else task,
                          additionalEqualities=eqs, device="cpu")
        if cpu_key:
            cpu_refs[cpu_key] = idx, ref
    cpu_s = time.perf_counter() - t0
    for j, i in enumerate(idx):
        want = ref[j] if task == "path" else dict(ref[j], cigar=None)
        if out[i] != want:
            fail(f"{label}: pair {i} differs from device='cpu': {out[i]} vs "
                 f"{want}")
    dp = dp_path if task == "path" else functools.partial(dp_align,
                                                           task=task)
    for i in idx[:DP_SAMPLES]:
        want = dp(q_ids[i], t_ids if shared else t_ids[i], mode)
        got = {key: out[i][key] for key in want}
        if got != want:
            fail(f"{label}: pair {i} differs from the numpy DP: {got} vs "
                 f"{want}")
    log(f"{label}: {SUBSAMPLE} pairs equal device='cpu' ({cpu_s:.1f} s), "
        f"{DP_SAMPLES} the numpy DP")
    return cpu_s


def timed(fn):
    """(result, seconds) of one call that ends in a card synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def recorded(ck, rec, fn):
    """(result, seconds, recorded calls, launch counts) of one call outside
    the main paths (a cross-check), its launches counted on their own."""
    ck.reset_launch_counts()
    rec.on = True
    out, secs = timed(fn)
    rec.on = False
    return out, secs, rec.take(), ck.launch_counts()


def long_pair_phases(rng, dev, ck, rec, et, acgt):
    """Phases 14-17 and 20: one long pair at a time through
    nw_distance_long, shw_best_long, semiglobal_locations_long and align
    (NW huge route, the device Hirschberg, the score-stream route), each
    held against the unbanded wavefront, the batched routes or the host
    engine; and hw_stream_segmented.  Returns (the e2e summary, {label:
    (recorded calls, launch counts)} for the kernel timings)."""
    import torch
    from edlib_tpu_torch.align import _filter_locations
    from edlib_tpu_torch.encode import transform_sequences
    from edlib_tpu_torch.ops.wavefront import Wavefront, take_rungs
    from edlib_tpu_torch.path import hirschberg as thb
    summary, calls = {}, {}

    def phase(label, call, required, forbidden=()):
        # The k ladder's rungs of the cold call (ops.wavefront.take_rungs).
        rungs = []

        def cold_first():
            out = call()
            if not rungs:
                rungs.append(take_rungs())
            return out

        take_rungs()
        out, counts, rec_calls, cold, warm, _ = drive(ck, rec, label,
                                                      cold_first, required)
        take_rungs()
        for name in forbidden:
            if counts[name]:
                fail(f"{label} launched {name} {counts[name]} times")
        calls[label] = rec_calls, counts
        summary[label] = dict(cold_s=cold, warm_s=warm, launches={
            k: v for k, v in counts.items() if v}, rungs=rungs[0])
        return out

    # 14. Long NW: 1 Mbp against its copy with 3% edits.
    t_ids = rng.randint(0, 4, LONG_LEN).astype(np.int32)
    q_ids = edit_copy(rng, t_ids, LONG_EDITS, 4)
    qb, tb = acgt[q_ids].tobytes(), acgt[t_ids].tobytes()
    d, a_dist, a_loc = phase("long_nw", lambda: (
        et.nw_distance_long(qb, tb), et.align(qb, tb),
        et.align(qb, tb, task="locations")), ("wavefront_banded",),
        ("nw_banded",))
    want = {"editDistance": d, "alphabetLength": 4,
            "locations": [(None, len(t_ids) - 1)], "cigar": None}
    if a_dist != want or a_loc != dict(want, locations=[(0, len(t_ids) - 1)]):
        fail(f"long_nw: align gives {a_dist}, {a_loc}; nw_distance_long {d}")
    if (et.nw_distance_long(qb, tb, k=d) != d
            or et.nw_distance_long(qb, tb, k=d - 1) != -1):
        fail(f"long_nw: k = {d} / {d - 1} does not give {d} / -1")
    pq, pt, _ = transform_sequences(qb, tb)
    d_unb, unb_s, unb_calls, unb_counts = recorded(
        ck, rec, lambda: Wavefront(device=dev).nw_distance(pq, pt, 4))
    if d_unb != d:
        fail(f"long_nw: banded {d} != unbanded wavefront {d_unb}")
    calls["long_nw_unbanded_check"] = unb_calls, unb_counts
    summary["long_nw"].update(distance=d, unbanded_s=unb_s)
    log(f"long_nw: distance {d} (k contract holds), equal to the unbanded "
        f"wavefront ({unb_s:.2f} s)")
    # The break-even at BREAK_LEN: the banded wavefront against the one-lane
    # align_batch route (nw_banded), which align takes below the gate.
    bq = rng.randint(0, 4, BREAK_LEN).astype(np.int32)
    bqb, btb = acgt[bq].tobytes(), acgt[edit_copy(rng, bq, LONG_EDITS,
                                                  4)].tobytes()
    be = {}
    for route, fn, kernel in (
            ("wavefront", lambda: et.nw_distance_long(bqb, btb),
             "wavefront_banded"),
            ("one_lane_nw_banded",
             lambda: et.align_batch([bqb], [btb])[0]["editDistance"],
             "nw_banded")):
        got, cold, _, counts = recorded(ck, rec, fn)
        if not counts[kernel]:
            fail(f"break-even: the {route} route never launched {kernel}")
        _, warm = timed(fn)
        be[route] = dict(result=got, cold_s=cold, warm_s=warm)
    if be["wavefront"]["result"] != be["one_lane_nw_banded"]["result"]:
        fail(f"break-even: align {be['wavefront']['result']} != align_batch "
             f"{be['one_lane_nw_banded']['result']}")
    summary["break_even"] = dict(
        pair_len=BREAK_LEN,
        distance=be["wavefront"]["result"],
        **{f"{r}_{k}": v[k] for r, v in be.items()
           for k in ("cold_s", "warm_s")})
    log(f"break-even {BREAK_LEN} bp: {summary['break_even']}")

    # 15. Long SHW: the same query against its source plus a random tail.
    s_ids = np.concatenate([t_ids, rng.randint(0, 4, LONG_SHW_TAIL)]
                           ).astype(np.int32)
    sb = acgt[s_ids].tobytes()
    best, locs = phase("long_shw", lambda: (
        et.shw_best_long(qb, sb),
        et.semiglobal_locations_long(qb, sb, mode="SHW")),
        ("wavefront_banded", "wavefront"))
    if best != (locs[0], locs[1][0]):
        fail(f"long_shw: shw_best_long {best} is not the head of {locs}")
    pq, ps, _ = transform_sequences(qb, sb)
    stream, stream_s = timed(lambda: Wavefront(device=dev).semiglobal_scores(
        pq, ps, 4, mode_is_hw=False))
    want = _filter_locations(stream, len(pq), float("inf"))
    if (want[0], list(want[1])) != (locs[0], list(locs[1])):
        fail(f"long_shw: {locs[0]}, {locs[1][:5]} != the unbanded stream's "
             f"{want[0]}, {want[1][:5]}")
    summary["long_shw"].update(best=locs[0], n_locations=len(locs[1]),
                               unbanded_stream_s=stream_s)
    log(f"long_shw: best {locs[0]} at {len(locs[1])} ends, equal to the "
        f"unbanded stream ({stream_s:.2f} s)")

    # 16. Long HW: a 10 kbp read with 5% edits planted twice in the target.
    a = rng.randint(0, LONG_LEN - LONG_READ)
    read = edit_copy(rng, t_ids[a:a + LONG_READ], LONG_READ_EDITS, 4)
    h_ids = t_ids.copy()
    for p in (LONG_LEN // 4, 3 * LONG_LEN // 4):
        h_ids[p:p + len(read)] = read
    rb, hb = acgt[read].tobytes(), acgt[h_ids].tobytes()
    locs = phase("long_hw", lambda: et.semiglobal_locations_long(
        rb, hb, mode="HW"), ("wavefront",))
    ref, ref_s = timed(lambda: et.align(rb, hb, mode="HW",
                                        task="locations"))
    if len(locs[1]) < 2 or locs != (ref["editDistance"],
                                    [e for _, e in ref["locations"]]):
        fail(f"long_hw: {locs} != align's {ref['editDistance']}, "
             f"{ref['locations']}")
    summary["long_hw"].update(best=locs[0], ends=locs[1], align_s=ref_s)
    log(f"long_hw: best {locs[0]} at ends {locs[1]}, equal to align's "
        f"per-lane route ({ref_s:.1f} s)")

    # 17. Long NW path: the distance from the banded wavefront, the root's
    # half-sweeps from column_cells on the card, the rest on the host.
    pq = rng.randint(0, 4, LONG_PATH_LEN).astype(np.int32)
    pt = edit_copy(rng, pq, LONG_EDITS, 4)
    pqb, ptb = acgt[pq].tobytes(), acgt[pt].tobytes()
    out = phase("long_path", lambda: et.align(pqb, ptb, task="path"),
                ("wavefront_banded", "wavefront"))
    check_cigars("long_path", [out], [pq], [pt], shared=False)
    _, dist_s = timed(lambda: et.nw_distance_long(pqb, ptb))
    summary["long_path"].update(pair_len=LONG_PATH_LEN,
                                distance=out["editDistance"],
                                distance_only_s=dist_s)
    log(f"long_path: CIGAR valid, distance {out['editDistance']}; "
        f"distance alone {dist_s:.2f} s")
    # The device half-sweeps against the host's on a smaller pair, the
    # gate lowered so three Hirschberg levels take the card.
    eq_q = rng.randint(0, 4, LONG_PATH_EQ_LEN).astype(np.int32)
    eq_t = edit_copy(rng, eq_q, LONG_EDITS, 4)
    cq, ct, alpha = transform_sequences(acgt[eq_q].tobytes(),
                                        acgt[eq_t].tobytes())
    eq = np.eye(len(alpha), dtype=bool)
    dist = et.nw_distance_long(acgt[eq_q].tobytes(), acgt[eq_t].tobytes())
    gate = thb._DEVICE_PATH_MIN_CELLS
    thb._DEVICE_PATH_MIN_CELLS = PATH_EQ_GATE
    try:
        ops_dev, dev_s, _, counts = recorded(
            ck, rec, lambda: thb.obtain_alignment(cq, ct, eq, dist,
                                                  device=dev))
    finally:
        thb._DEVICE_PATH_MIN_CELLS = gate
    ops_host, host_s = timed(lambda: thb.obtain_alignment(cq, ct, eq, dist,
                                                          device=dev))
    if not counts["wavefront"]:
        fail("long_path: the lowered gate took no half-sweep on the card")
    if not np.array_equal(ops_dev, ops_host):
        fail(f"long_path: {LONG_PATH_EQ_LEN} bp ops differ between the "
             "device and the host half-sweeps")
    summary["long_path"].update(eq_pair_len=LONG_PATH_EQ_LEN,
                                eq_device_s=dev_s, eq_host_s=host_s,
                                eq_half_sweep_launches=counts["wavefront"])
    log(f"long_path: {LONG_PATH_EQ_LEN} bp ops byte-equal, device "
        f"half-sweeps {dev_s:.2f} s vs host {host_s:.2f} s")

    # 20. One long pair on the score-stream route: substitutions only, so
    # the Hamming bound keeps the pair under the wavefront gate, and past
    # 65,536 bp neither the per-lane nor the bit-plane kernels take it.
    sq = rng.randint(0, 4, STREAM_LEN).astype(np.int32)
    st = sq.copy()
    sub = rng.rand(STREAM_LEN) < STREAM_SUBS
    st[sub] = (st[sub] + rng.randint(1, 4, int(sub.sum()))) % 4
    sqb, stb = acgt[sq].tobytes(), acgt[st].tobytes()
    got = phase("long_stream", lambda: et.align(sqb, stb), ("sweep_scores",),
                ("wavefront_banded", "wavefront"))
    loc, loc_s, _, counts = recorded(
        ck, rec, lambda: et.align(sqb, stb, task="locations"))
    if not counts["sweep_scores"] or counts["wavefront_banded"]:
        fail(f"long_stream: locations took launches {counts}")
    d, wf_cold = timed(lambda: et.nw_distance_long(sqb, stb))
    _, wf_warm = timed(lambda: et.nw_distance_long(sqb, stb))
    want = {"editDistance": d, "alphabetLength": 4,
            "locations": [(None, STREAM_LEN - 1)], "cigar": None}
    if got != want or loc != dict(want, locations=[(0, STREAM_LEN - 1)]):
        fail(f"long_stream: align gives {got}, {loc}; nw_distance_long {d}")
    if (et.align(sqb, stb, k=d)["editDistance"] != d
            or et.align(sqb, stb, k=d - 1)["editDistance"] != -1):
        fail(f"long_stream: k = {d} / {d - 1} does not give {d} / -1")
    summary["long_stream"].update(
        pair_len=STREAM_LEN, distance=d, locations_s=loc_s,
        wavefront_cold_s=wf_cold, wavefront_warm_s=wf_warm)
    log(f"long_stream: distance {d} (k contract holds), equal to "
        f"nw_distance_long; align warm {summary['long_stream']['warm_s']:.2f}"
        f" s vs the banded wavefront {wf_warm:.3f} s")

    # hw_stream_segmented: a read planted in phase 14's target, its stream's
    # minimal positions against semiglobal_locations_long's ends.
    from edlib_tpu_torch.ops.segmented import hw_stream_segmented
    a = rng.randint(0, LONG_LEN - SEG_READ_LEN)
    read = edit_copy(rng, t_ids[a:a + SEG_READ_LEN], LONG_READ_EDITS, 4)
    g_ids = t_ids.copy()
    g_ids[LONG_LEN // 2:LONG_LEN // 2 + len(read)] = read
    stream, seg_s, seg_calls, counts = recorded(
        ck, rec, lambda: hw_stream_segmented(read, g_ids, 4, len(read),
                                             device=dev))
    if not counts["sweep_scores"]:
        fail("segmented stream: sweep_scores never ran")
    locs = et.semiglobal_locations_long(acgt[read].tobytes(),
                                        acgt[g_ids].tobytes(), mode="HW")
    got = (int(stream.min()), np.nonzero(stream == stream.min())[0].tolist())
    if stream.shape != (LONG_LEN,) or got != (locs[0], [
            e for e in locs[1] if e >= 0]):
        fail(f"segmented stream: {got} != semiglobal_locations_long's {locs}")
    calls["segmented_stream"] = seg_calls, counts
    summary["segmented_stream"] = dict(read_len=len(read), s=seg_s,
                                       best=got[0], ends=got[1],
                                       launches=counts["sweep_scores"])
    log(f"segmented stream: best {got[0]} at {got[1]} in {seg_s:.2f} s, "
        "equal to semiglobal_locations_long")
    torch.cuda.empty_cache()
    return summary, calls


# --------------------------------------------------------------------------
# Main
# --------------------------------------------------------------------------


def as_lists(outs):
    """Tensors or arrays -> lists, so that two runs' results compare."""
    return [np.asarray(x.cpu() if hasattr(x, "cpu") else x).tolist()
            for x in outs]


def sharded_phases(rng, dev, ck, rec, et, grid, acgt, main_batch, hw_batch,
                   nw_batch, prior):
    """Phases 21-22 on the DeviceGrid `grid` (the card four times, 2 x 2),
    each through its public entry point with its launch counts (drive):

    21. sharded_reduce_pipeline of phase 3's reads against its 4 Mbp target,
        hin0 0 and 1, equal lane for lane to one shared reduce_lanes sweep
        of the whole scan; reduce_resume 2 launches a dp row, 4 in all.
    22. align_batch(mesh=) on phase 7's HW batch (locations) and phase 8's
        NW batch (distance), map_reads(mesh=) on phase 3's batch, each equal
        to its phase's unsharded result; and sharded_nw_pipeline of
        NW_PIPE_READS of phase 3's reads against phase 7's target, equal to
        one sweep_scores of the joined scan (sweep_scores_resume, 4
        launches).

    prior: the unsharded results {"map": (best, pos), "hw_shared": out,
    "nw_banded": out}.  Returns (the e2e summary, {label: (recorded calls,
    launch counts)})."""
    import hashlib

    import torch
    from edlib_tpu_torch import parallel as tpar
    summary, calls = {}, {}

    def digest(t):
        return tuple(t.shape), hashlib.blake2b(
            t.contiguous().cpu().numpy().tobytes(), digest_size=16).digest()

    def phase(label, call, required, exact=None):
        out, counts, rec_calls, cold, warm, _ = drive(ck, rec, label, call,
                                                      required)
        for name, n in (exact or {}).items():
            if counts[name] != n:
                fail(f"{label}: {name} launched {counts[name]} times, not "
                     f"{n}")
        calls[label] = rec_calls, counts
        summary[label] = dict(cold_s=cold, warm_s=warm, launches={
            k: v for k, v in counts.items() if v})
        return out

    # 21. The resumable reduce pipeline, 8,192 reads x 4,194,304 columns.
    read_ids, t_ids = main_batch
    B, qlen = read_ids.shape
    nw = -(-qlen // 32)
    W = nw * 32 - qlen
    peq = ck.build_peq_device(
        torch.from_numpy(read_ids).to(dev),
        torch.full((B,), qlen, dtype=torch.int32, device=dev), 4, nw)
    T = len(t_ids)
    lo = np.full(B, W, np.int64)
    hi = lo + T
    scan = torch.full((1, T + W), 4, dtype=torch.int32, device=dev)
    scan[0, :T] = torch.from_numpy(t_ids).to(dev)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    lo_t = torch.from_numpy(lo.astype(np.int32)).to(dev)
    hi_t = torch.from_numpy(hi.astype(np.int32)).to(dev)
    dp = grid.shape["dp"]
    for hin0 in (0, 1):
        label = f"reduce_pipeline_hin0_{hin0}"
        got = phase(label, lambda: as_lists(tpar.sharded_reduce_pipeline(
            grid, peq, t_ids, qlen, lo, hi, hin0=hin0)), ("reduce_resume",),
            {"reduce_resume": 2 * dp})
        if hin0 == 0:
            # The split-lane schedule with a carry: several cores a lane.
            for a in calls[label][0]["reduce_resume"]:
                cores = ck.resume_cores(a[2].shape[0], a[1].shape[1],
                                        a[0].shape[2], 0)[1]
                if cores < 2:
                    fail(f"{label}: a reduce_resume call ran {cores} core "
                         "a lane")
        want, secs = timed(lambda: as_lists(ck.reduce_lanes(
            peq, scan, lo_t, hi_t, rows, rows * 0, hin0)))
        if got != want:
            fail(f"{label} differs from one reduce_lanes sweep of the scan")
        summary[label]["one_sweep_s"] = secs
        log(f"{label}: {B} lanes equal one shared reduce_lanes sweep "
            f"({secs:.2f} s)")

    # 22. The sharded API at full width.
    hw_q, hw_t = hw_batch
    out = phase("mesh_hw_shared", lambda: et.align_batch(
        hw_q, hw_t, mode="HW", task="locations", mesh=grid),
        ("reduce_lanes", "hits_lanes"))
    if out != prior["hw_shared"]:
        fail("mesh_hw_shared differs from phase 7's unsharded results")
    nw_q, nw_t = nw_batch
    out = phase("mesh_nw", lambda: et.align_batch(
        nw_q, nw_t, mode="NW", task="distance", mesh=grid),
        ("reduce_lanes",))
    if calls["mesh_nw"][1]["nw_banded"]:
        fail("mesh_nw took the banded NW route under a grid")
    if out != prior["nw_banded"]:
        fail("mesh_nw differs from phase 8's unsharded results")
    reads = to_bytes(read_ids, acgt)
    target = acgt[t_ids].tobytes()
    out = phase("mesh_map_reads", lambda: as_lists(et.map_reads(
        reads, target, k=-1, mesh=grid)), ("reduce_lanes", "sweep_shared"))
    if out != as_lists(prior["map"]):
        fail("mesh_map_reads differs from phase 3's unsharded results")
    t_hw = prior["hw_target_ids"]
    n = min(NW_PIPE_READS, B)
    ppeq = peq[:n]
    sp = grid.shape["sp"]
    C = -(-(len(t_hw) + W) // sp)
    got = phase("mesh_nw_pipeline", lambda: digest(
        tpar.sharded_nw_pipeline(grid, ppeq, t_hw, qlen)[0]),
        ("sweep_scores_resume",), {"sweep_scores_resume": 2 * dp})
    joined = torch.full((1, C * sp), 4, dtype=torch.int32, device=dev)
    joined[0, :len(t_hw)] = torch.from_numpy(t_hw).to(dev)
    stream = ck.sweep_scores(ppeq, joined, rows[:n], rows[:n] * 0, 1)
    if got != digest(stream.reshape(n, sp, C).permute(1, 0, 2)):
        fail("mesh_nw_pipeline differs from one sweep_scores of the scan")
    log(f"mesh_nw_pipeline: {n} lanes x {C * sp} columns equal one "
        "sweep_scores")
    return summary, calls


def adaptive_phase(rng, dev, ck, rec):
    """Phase 23: Sweeper.reduce_hw_adaptive on ADAPT_READS reads of
    ADAPT_QLEN bp with 6% substitutions, planted in one shared ADAPT_TLEN-bp
    target, for k in ADAPT_KS, each with its launch counts (drive); lanes
    whose unbanded best (reduce_lanes on the same operands) is <= k equal
    it, the others are above k; the unbanded sweep is timed beside it.
    Returns (the e2e summary, {label: (recorded calls, launch counts)})."""
    import torch
    from edlib_tpu_torch.ops.sweeper import Sweeper
    t_ids = rng.randint(0, 4, ADAPT_TLEN).astype(np.int32)
    reads, _ = make_batch(rng, t_ids, 4, ADAPT_READS, ADAPT_QLEN, 0,
                          rate=0.06)
    nw = -(-ADAPT_QLEN // 32)
    W = nw * 32 - ADAPT_QLEN
    peq = ck.build_peq_device(
        torch.from_numpy(reads).to(dev),
        torch.full((ADAPT_READS,), ADAPT_QLEN, dtype=torch.int32,
                   device=dev), 4, nw)
    lo = np.full(ADAPT_READS, W, np.int64)
    hi = lo + ADAPT_TLEN
    sw = Sweeper(dev)
    unbanded = lambda: sw.reduce(peq, t_ids, lo, hi, 0, shared=True)
    full, full_s = timed(unbanded)
    # The unbanded reduce_lanes launch's device time (events around the
    # launch alone), beside each k's hw_adaptive launch.
    unbanded_ms = launch_ms(ck, unbanded, 3)
    summary, calls = {"unbanded_s": full_s, "unbanded_ms": unbanded_ms}, {}
    for k in ADAPT_KS:
        label = f"hw_adaptive_k{k}"
        adaptive = lambda: sw.reduce_hw_adaptive(peq, t_ids, lo, hi, k,
                                                 shared=True)
        got, counts, rec_calls, cold, warm, _ = drive(
            ck, rec, label, lambda: as_lists(adaptive()), ("hw_adaptive",))
        got = [np.asarray(x) for x in got]
        within = full[0] <= k
        for g, w in zip(got, full[:3]):
            if not np.array_equal(g[within], w[within]):
                fail(f"{label}: a lane with best <= k differs from the "
                     "unbanded reduce")
        if (got[0][~within] <= k).any():
            fail(f"{label}: a lane with best > k reported <= k")
        calls[label] = rec_calls, counts
        ms = launch_ms(ck, adaptive, 1)
        summary[label] = dict(cold_s=cold, warm_s=warm, ms=ms,
                              unbanded_ms=unbanded_ms,
                              lanes_within_k=int(within.sum()))
        log(f"{label}: {int(within.sum())} of {ADAPT_READS} lanes within k "
            f"equal the unbanded reduce ({warm:.2f} s warm, unbanded "
            f"{full_s:.2f} s; device {ms:.1f} ms, unbanded {unbanded_ms:.1f} "
            "ms)")
    return summary, calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        import edlib_tpu_torch
        from edlib_tpu_torch import mapping as mp
        from edlib_tpu_torch import parallel as tpar
        from edlib_tpu_torch.ops import _build
        from edlib_tpu_torch.ops import cuda_kernel as ck
        from edlib_tpu_torch.path import batched as bpath
        from edlib_tpu_torch.utils import hw
    except ImportError as e:
        print(f"chip_smoke: edlib_tpu_torch is not importable here ({e})",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules or "edlib_tpu" in sys.modules:
        fail("the port imported jax or edlib_tpu")
    dev = hw.resolve_device(None)
    card = hw.card_name_and_power()
    kind = torch.cuda.get_device_name(0)
    rng = np.random.RandomState(args.seed)

    # 1. Build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    build_s = time.perf_counter() - t0
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    log(f"built {lib_path.name} in {build_s:.1f} s on {card}")

    # 2. Kernels vs plain versions, small shapes, each check's seconds
    # logged.  The checks added since PR 7 draw from generators of their
    # own (--seed + 1, ..., + 7), so the paths below see the same data as
    # before.
    phase2_s = {}
    extra = [np.random.RandomState(args.seed + i)
             for i in (1, 2, 3, 4, 5, 6, 7)]
    for check, gen in ((check_kernels, rng), (check_wavefront_kernels, rng),
                       (check_resumable_kernels, rng),
                       (check_adaptive_kernel, rng),
                       (check_split_kernels, rng),
                       (check_bitplane_split, extra[0]),
                       (check_wavefront_tiles, extra[0]),
                       (check_wavefront_groups, extra[1]),
                       (check_resume_split, extra[1]),
                       (check_word_lanes, extra[2]),
                       (check_score_groups, extra[2]),
                       (check_split_hits, extra[3]),
                       (check_word_hits, extra[3]),
                       (check_banded_words, extra[4]),
                       (check_capture_words, extra[4]),
                       (check_hits_bitplane_split, extra[5]),
                       (check_adaptive_cluster, extra[6])):
        t0 = time.perf_counter()
        check(gen, dev, ck)
        phase2_s[check.__name__] = time.perf_counter() - t0
        log(f"{check.__name__}: equal, {phase2_s[check.__name__]:.1f} s")
    log(f"kernels equal their plain versions at small shapes "
        f"({sum(phase2_s.values()):.1f} s)")

    rec = Recorder(ck)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    # 3. Main path, sigma = 4, full width.
    B = READS
    base = rng.randint(0, 4, BASE_LEN).astype(np.int32)
    t_ids = np.tile(base, TILES)
    target = acgt[t_ids].tobytes()
    read_ids, rand_idx = make_batch(rng, t_ids, 4, B, QLEN, N_RANDOM)
    reads = to_bytes(read_ids, acgt)
    # The reads the filter hands to the shared sweep (the overflow
    # stragglers), in the port's symbol ids.
    overflow = []
    sweep_reads_shared = mp._sweep_reads_shared

    def spy(r_list, *rest):
        overflow.extend(r_list)
        return sweep_reads_shared(r_list, *rest)

    mp._sweep_reads_shared = spy
    ck.reset_launch_counts()
    rec.on = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, pos = edlib_tpu_torch.map_reads(reads, target, k=-1)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    rec.on = False
    mp._sweep_reads_shared = sweep_reads_shared
    launches = ck.launch_counts()
    main_calls = rec.take()
    log(f"main path sigma=4: {cold_s:.2f} s, launches {launches}")
    for name in ("reduce_lanes", "sweep_shared"):
        if launches[name] == 0:
            fail(f"main path never launched {name}")
    t0 = time.perf_counter()
    best2, pos2 = edlib_tpu_torch.map_reads(reads, target, k=-1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not (np.array_equal(best, best2) and np.array_equal(pos, pos2)):
        fail("a second map_reads call on the same batch disagrees")
    prof = profile_call(lambda: edlib_tpu_torch.map_reads(reads, target,
                                                           k=-1))
    if best.shape != (B,) or (best < 0).any() or (best > QLEN).any():
        fail("map_reads returned out-of-range distances")
    r_ids, t_enc, sigma, _, t_key = mp._prep(reads, target)
    qlens = np.full(B, QLEN, np.int64)
    t0 = time.perf_counter()
    want = mp.finish(*mp._sweep_reads_shared(r_ids, t_enc, t_key, sigma, 0,
                                             dev), qlens, -1)
    sweep_s = time.perf_counter() - t0
    bad = np.nonzero((best != want[0]) | (pos != want[1]))[0]
    if len(bad):
        i = bad[0]
        fail(f"{len(bad)} reads differ from the unfiltered shared sweep, "
             f"first read {i}: {best[i], pos[i]} vs {want[0][i], want[1][i]}")
    # Every overflow straggler, and two sampled reads, against a DP at the
    # target's full length (the overflow reads' answers come from the shared
    # sweep on both sides of the check above).  The sampled reads also hold
    # the card's DP against the numpy DP.
    where = {r.tobytes(): i for i, r in enumerate(r_ids)}
    mapped = np.setdiff1d(np.arange(B), rand_idx)
    sampled = [int(rng.choice(mapped)), int(rng.choice(rand_idx))]
    dp_idx = sampled + [where[r.tobytes()] for r in overflow]
    t0 = time.perf_counter()
    dp_best, dp_pos = dp_best_hw_card(np.stack([r_ids[i] for i in dp_idx]),
                                      t_enc, dev)
    dp_s = time.perf_counter() - t0
    for n_i, i in enumerate(dp_idx):
        if (best[i], pos[i]) != (dp_best[n_i], dp_pos[n_i]):
            fail(f"read {i}: {best[i], pos[i]} vs the card's DP "
                 f"{dp_best[n_i], dp_pos[n_i]}")
    for i in sampled:
        ref = dp_best_hw(read_ids[i], t_ids)
        if (best[i], pos[i]) != ref:
            fail(f"read {i}: {best[i], pos[i]} vs numpy DP {ref}")
    log(f"sigma=4 results equal the full sweep ({sweep_s:.1f} s); "
        f"{len(overflow)} overflow stragglers and 2 sampled reads equal the "
        f"DP ({dp_s:.1f} s); {int((best > max(8, QLEN // 10)).sum())} reads "
        f"above the filter rung")

    # 4. Bit-plane path, sigma = 100.
    letters = np.arange(BIG_SIGMA, dtype=np.uint8) + 28
    t100 = rng.randint(0, BIG_SIGMA, BIG_SIGMA_LEN).astype(np.int32)
    target100 = letters[t100].tobytes()
    ids100, _ = make_batch(rng, t100, BIG_SIGMA, B, QLEN, N_RANDOM)
    reads100 = to_bytes(ids100, letters)
    ck.reset_launch_counts()
    rec.on = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best100, pos100 = edlib_tpu_torch.map_reads(reads100, target100, k=-1)
    torch.cuda.synchronize()
    cold100_s = time.perf_counter() - t0
    rec.on = False
    launches100 = ck.launch_counts()
    bitplane_calls = rec.take()
    log(f"bit-plane path sigma=100: {cold100_s:.2f} s, launches "
        f"{launches100}")
    if launches100["reduce_bitplane"] == 0:
        fail("the sigma=100 path never launched reduce_bitplane")
    r_ids, t_enc, sigma, _, t_key = mp._prep(reads100, target100)
    want = mp.finish(*mp._sweep_reads_shared(r_ids, t_enc, t_key, sigma, 0,
                                             dev), qlens, -1)
    if not (np.array_equal(best100, want[0])
            and np.array_equal(pos100, want[1])):
        fail("sigma=100 results differ from the unfiltered shared sweep")

    # 5. SHW and few-reads segmented batches vs the plain versions.
    t_small = t_ids[:SHW_LEN]
    shw_ids, _ = make_batch(rng, t_small[:400], 4, SHW_READS, QLEN,
                            SHW_READS // 4)
    shw_reads = to_bytes(shw_ids, acgt)
    for k in (-1, 8):
        got = edlib_tpu_torch.map_reads(shw_reads, acgt[t_small].tobytes(),
                                        mode="SHW", k=k)
        ref = edlib_tpu_torch.map_reads(shw_reads, acgt[t_small].tobytes(),
                                        mode="SHW", k=k, device="cpu")
        if not (np.array_equal(got[0], ref[0])
                and np.array_equal(got[1], ref[1])):
            fail(f"SHW k={k} differs from the plain versions")
    seg_t = acgt[t_ids[:SEG_LEN]].tobytes()
    seg_ids, _ = make_batch(rng, t_ids[:SEG_LEN], 4, SEG_READS, QLEN, 4)
    seg_reads = to_bytes(seg_ids, acgt)
    got = edlib_tpu_torch.map_reads(seg_reads, seg_t)
    ref = edlib_tpu_torch.map_reads(seg_reads, seg_t, device="cpu")
    if not (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])):
        fail("segmented batch differs from the plain versions")
    log("SHW and segmented batches equal the plain versions")

    # 7-12. align_batch, one phase per path.
    align_batch = edlib_tpu_torch.align_batch
    phases = {}

    cpu_refs = {}
    outs = {}

    def run_phase(label, queries, targets, q_ids, t_ids, mode, task,
                  required, cpu_key=None, eqs=None, forbidden=()):
        call = lambda: align_batch(queries, targets, mode=mode, task=task,
                                   additionalEqualities=eqs)
        # The batched-windows call of a PATH phase's first run, kept to
        # profile that stage alone.
        windows = []
        batched = bpath.batched_windows_path

        def keep(*a):
            if not windows:
                windows.append(a)
            return batched(*a)

        bpath.batched_windows_path = keep
        try:
            out, counts, calls, cold, warm, routes = drive(
                ck, rec, label, call, required)
        finally:
            bpath.batched_windows_path = batched
        for name in forbidden:
            if counts[name]:
                fail(f"{label} launched {name} {counts[name]} times")
        outs[label] = out
        cpu_s = check_align(label, align_batch, out, queries, targets,
                            q_ids, t_ids, mode, task, rng, cpu_refs, cpu_key,
                            eqs)
        prof_ = profile_call(call)
        phases[label] = dict(pairs=len(queries), mode=mode, task=task,
                             cold_s=cold, warm_s=warm, cpu_subsample_s=cpu_s,
                             warm_profile=prof_)
        if task == "path":
            if routes != {"capture": len(queries), "host": 0}:
                fail(f"{label}: PATH windows took routes {routes}, not "
                     f"{len(queries)} on the capture route")
            check_cigars(label, out, q_ids, t_ids,
                         isinstance(targets, bytes))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            stage = profile_call(lambda: batched(*windows[0]), groups={
                "capture": TRACED["capture"], "copies": "emcpy"})
            stage["decode_walk_device_ms"] = (
                stage["device_busy_ms"] - stage["capture_device_ms"]
                - stage["copies_device_ms"])
            stage["peak_mib"] = (torch.cuda.max_memory_allocated(dev)
                                 - base) / 2**20
            phases[label]["path_stage"] = stage
            log(f"{label}: {len(queries)} CIGARs valid; windows stage "
                f"{stage['wall_ms']:.1f} ms wall, capture "
                f"{stage['capture_device_ms']:.3f} ms, decode+walk "
                f"{stage['decode_walk_device_ms']:.3f} ms on the device, "
                f"peak {stage['peak_mib']:.0f} MiB")
        return counts, calls

    # 7. HW locations against one shared 100,000-bp target.
    t_hw = rng.randint(0, 4, HW_TLEN).astype(np.int32)
    starts = rng.randint(0, HW_TLEN - HW_QLEN, HW_READS)
    hw_ids = t_hw[starts[:, None] + np.arange(HW_QLEN)[None, :]]
    muts = rng.rand(HW_READS, HW_QLEN) < HW_RATE
    hw_ids[muts] = (hw_ids[muts] + rng.randint(1, 4, int(muts.sum()))) % 4
    hw_counts, hw_calls = run_phase(
        "hw_shared", to_bytes(hw_ids, acgt), acgt[t_hw].tobytes(), hw_ids,
        t_hw, "HW", "locations", ("reduce_lanes", "hits_lanes"),
        cpu_key="hw")
    rows = [c[1].shape[0] for c in hw_calls["reduce_lanes"]]
    if 1 not in rows or max(rows) == 1:
        fail(f"hw_shared: reduce_lanes ran target rows {rows}, not the "
             "shared row and the per-lane start re-runs")

    # 8. NW distance and 9. SHW locations, 1,000-bp pairs (banded).
    pq = rng.randint(0, 4, (PAIRS, PAIR_LEN)).astype(np.int32)
    pt = [edit_copy(rng, q, PAIR_EDITS, 4) for q in pq]
    p_queries = to_bytes(pq, acgt)
    nw_counts, nw_calls = run_phase(
        "nw_banded", p_queries, [acgt[t].tobytes() for t in pt], pq, pt,
        "NW", "distance", ("nw_banded",))
    st = [np.concatenate([t, rng.randint(0, 4, SHW_TAIL)]).astype(np.int32)
          for t in pt]
    shw_counts, shw_calls = run_phase(
        "shw_banded", p_queries, [acgt[t].tobytes() for t in st], pq, st,
        "SHW", "locations", ("shw_banded", "shw_banded_hits"))

    # 10. HW locations, sigma = 100, each read against its own window.
    win = rng.randint(0, BP_SIGMA, (BP_READS, BP_WIN)).astype(np.int32)
    off = rng.randint(0, BP_WIN - BP_QLEN, BP_READS)
    bp_ids = win[np.arange(BP_READS)[:, None],
                 off[:, None] + np.arange(BP_QLEN)[None, :]]
    muts = rng.rand(BP_READS, BP_QLEN) < HW_RATE
    bp_ids[muts] = (bp_ids[muts]
                    + rng.randint(1, BP_SIGMA, int(muts.sum()))) % BP_SIGMA
    bp_counts, bp_calls = run_phase(
        "hw_sigma100", to_bytes(bp_ids, letters), to_bytes(win, letters),
        bp_ids, win, "HW", "locations", ("reduce_bitplane", "hits_bitplane"))

    # 11. HW path on phase 7's batch (and its device="cpu" subsample).
    hwp_counts, hwp_calls = run_phase(
        "hw_path", to_bytes(hw_ids, acgt), acgt[t_hw].tobytes(), hw_ids,
        t_hw, "HW", "path", ("capture", "reduce_lanes", "hits_lanes"),
        cpu_key="hw")

    # 12. NW path, 500-bp pairs: 16-word windows.
    nq = rng.randint(0, 4, (PATH_PAIRS, PATH_LEN)).astype(np.int32)
    nt = [edit_copy(rng, q, PAIR_EDITS, 4) for q in nq]
    nwp_counts, nwp_calls = run_phase(
        "nw_path", to_bytes(nq, acgt), [acgt[t].tobytes() for t in nt], nq,
        nt, "NW", "path", ("capture", "nw_banded"))

    # 18-19. HW locations past the per-lane cap with dense equalities:
    # sigma = 100, every symbol equal to the other 7 of its class of 8.
    cls = np.arange(BP_SIGMA) // EQ_CLASS
    eq_pairs = [(int(letters[a]), int(letters[b]))
                for a in range(BP_SIGMA) for b in range(a + 1, BP_SIGMA)
                if cls[a] == cls[b]]

    def eq_batch(n):
        win = rng.randint(0, BP_SIGMA, (n, BP_WIN)).astype(np.int32)
        off = rng.randint(0, BP_WIN - BP_QLEN, n)
        ids = win[np.arange(n)[:, None],
                  off[:, None] + np.arange(BP_QLEN)[None, :]]
        muts = rng.rand(n, BP_QLEN) < HW_RATE
        ids[muts] = (ids[muts] + rng.randint(1, BP_SIGMA, int(muts.sum()))
                     ) % BP_SIGMA
        return ids, win

    eq_ids, eq_win = eq_batch(EQ_READS)
    eq_counts, eq_calls = run_phase(
        "hw_eqstream", to_bytes(eq_ids, letters), to_bytes(eq_win, letters),
        cls[eq_ids], cls[eq_win], "HW", "locations",
        ("reduce_eqstream", "hits_eqstream"), eqs=eq_pairs,
        forbidden=("sweep_scores",))
    st_ids, st_win = eq_batch(STREAM_READS)
    st_counts, st_calls = run_phase(
        "hw_stream", to_bytes(st_ids, letters), to_bytes(st_win, letters),
        cls[st_ids], cls[st_win], "HW", "locations", ("sweep_scores",),
        eqs=eq_pairs)
    del eq_ids, eq_win, st_ids, st_win

    # 14-17 and 20. Long single pairs, each through its public entry points.
    long_pairs, long_calls = long_pair_phases(
        rng, dev, ck, rec, edlib_tpu_torch, acgt)

    # 21-22. The sharded API on a 2 x 2 grid of the card.
    grid = tpar.make_alignment_mesh(GRID_DP * GRID_SP, dp=GRID_DP,
                                    sp=GRID_SP,
                                    devices=[dev] * (GRID_DP * GRID_SP))
    sharded, sharded_calls = sharded_phases(
        rng, dev, ck, rec, edlib_tpu_torch, grid, acgt, (read_ids, t_ids),
        (to_bytes(hw_ids, acgt), acgt[t_hw].tobytes()),
        (p_queries, [acgt[t].tobytes() for t in pt]),
        {"map": (best, pos), "hw_shared": outs["hw_shared"],
         "nw_banded": outs["nw_banded"], "hw_target_ids": t_hw})

    # 23. The adaptive banded reduce.
    adaptive, adaptive_calls = adaptive_phase(rng, dev, ck, rec)

    # 6 and 13. Timings on each path's own operands.
    kernels = []
    for name, calls, counts, path in (
            ("reduce_lanes", main_calls["reduce_lanes"], launches,
             "map_reads sigma=4"),
            ("sweep_shared", main_calls["sweep_shared"], launches,
             "map_reads sigma=4"),
            ("reduce_bitplane", bitplane_calls["reduce_bitplane"],
             launches100, "map_reads sigma=100"),
            ("hits_lanes", hw_calls["hits_lanes"], hw_counts, "hw_shared"),
            ("hits_bitplane", bp_calls["hits_bitplane"], bp_counts,
             "hw_sigma100"),
            ("nw_banded", nw_calls["nw_banded"], nw_counts, "nw_banded"),
            ("shw_banded", shw_calls["shw_banded"], shw_counts, "shw_banded"),
            ("shw_banded_hits", shw_calls["shw_banded_hits"], shw_counts,
             "shw_banded"),
            ("capture", hwp_calls["capture"], hwp_counts, "hw_path"),
            ("reduce_eqstream", eq_calls["reduce_eqstream"], eq_counts,
             "hw_eqstream"),
            ("hits_eqstream", eq_calls["hits_eqstream"], eq_counts,
             "hw_eqstream"),
            ("sweep_scores", st_calls["sweep_scores"], st_counts,
             "hw_stream")):
        m = measure(ck, name, calls)
        kernels.append(kernel_entry(name, m, counts[name], path, card))
        log(f"timed {name} ({path}): {m['ms']:.3f} ms (plain "
            f"{m['plain_ms']:.1f} ms, bound {m['bound_ms']:.4f} ms)")
        check_new_forms(name, m, path)
    # Kernels that also run on a second path, beside their entries.
    for name, calls, counts, path in (
            ("reduce_lanes", hw_calls["reduce_lanes"], hw_counts,
             "hw_shared"),
            ("reduce_bitplane", bp_calls["reduce_bitplane"], bp_counts,
             "hw_sigma100"),
            ("capture", nwp_calls["capture"], nwp_counts, "nw_path"),
            ("nw_banded", nwp_calls["nw_banded"], nwp_counts, "nw_path"),
            ("reduce_eqstream", st_calls["reduce_eqstream"], st_counts,
             "hw_stream"),
            ("sweep_scores", long_calls["long_stream"][0]["sweep_scores"],
             long_calls["long_stream"][1], "long_stream")):
        if not calls:
            continue
        m = measure(ck, name, calls)
        check_new_forms(name, m, path)
        entry = next(k for k in kernels if k["name"] == name)
        sub = kernel_entry(name, m, counts[name], path, card)
        entry.setdefault("other_paths", []).append(
            {k: sub[k] for k in ("path", "launches", "max_abs_err", "ms",
                                 "plain_ms", "plain_cols", "cols",
                                 "bound_ms", "bound_by", "calls")})
        log(f"timed {name} ({path}): {m['ms']:.3f} ms (plain "
            f"{m['plain_ms']:.1f} ms, bound {m['bound_ms']:.4f} ms)")
    # Phase 13 for the kernels of phases 21-23 (the resumable reduce at both
    # hin0, an entry each).
    pipe_calls, pipe_counts = sharded_calls["reduce_pipeline_hin0_0"]
    pipe1_calls, pipe1_counts = sharded_calls["reduce_pipeline_hin0_1"]
    nwp_calls2, nwp_counts2 = sharded_calls["mesh_nw_pipeline"]
    ad_calls = [c for k in ADAPT_KS
                for c in adaptive_calls[f"hw_adaptive_k{k}"][0]["hw_adaptive"]]
    ad_launches = sum(adaptive_calls[f"hw_adaptive_k{k}"][1]["hw_adaptive"]
                      for k in ADAPT_KS)
    for name, calls, n_launch, path in (
            ("reduce_resume", pipe_calls["reduce_resume"],
             pipe_counts["reduce_resume"], "reduce_pipeline_hin0_0"),
            ("reduce_resume", pipe1_calls["reduce_resume"],
             pipe1_counts["reduce_resume"], "reduce_pipeline_hin0_1"),
            ("sweep_scores_resume", nwp_calls2["sweep_scores_resume"],
             nwp_counts2["sweep_scores_resume"], "mesh_nw_pipeline"),
            ("hw_adaptive", ad_calls, ad_launches, "hw_adaptive")):
        m = measure(ck, name, calls)
        check_new_forms(name, m, path)
        kernels.append(kernel_entry(name, m, n_launch, path, card))
        log(f"timed {name} ({path}): {m['ms']:.3f} ms (plain "
            f"{m['plain_ms']:.1f} ms, bound {m['bound_ms']:.4f} ms)")
    # Phase 13 for the wavefront kernels: every call of each path timed,
    # held against the plain version on segments of its own operands.
    for name, path, others in (
            ("wavefront_banded", "long_nw", ("long_shw", "long_path")),
            ("wavefront", "long_hw", ("long_shw", "long_path",
                                      "long_nw_unbanded_check"))):
        entry = None
        for label in (path,) + others:
            calls, counts = long_calls[label]
            if not calls[name]:
                continue
            m = measure_wavefront(ck, name, calls[name])
            sub = kernel_entry(name, m, counts[name], label, card)
            if entry is None:
                entry = sub
                kernels.append(entry)
                if name == "wavefront_banded":
                    entry["form_crossover"] = banded_form_crossover(
                        ck, calls[name][len(calls[name]) // 2])
            else:
                entry.setdefault("other_paths", []).append(
                    {k: sub[k] for k in ("path", "launches", "max_abs_err",
                                         "ms", "plain_ms", "plain_cols",
                                         "cols", "bound_ms", "bound_by",
                                         "calls")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": {
        "card": card, "reads": B, "qlen": QLEN, "target_len": len(t_ids),
        "sigma": 4, "k": -1, "map_reads_cold_s": cold_s,
        "map_reads_warm_s": warm_s, "full_shared_sweep_s": sweep_s,
        "sigma100_target_len": len(t100), "sigma100_map_reads_cold_s":
        cold100_s, "build_s": build_s, "phase2_s": phase2_s,
        "warm_profile": prof,
        "align_batch": phases, "long_pairs": long_pairs,
        "sharded": sharded, "adaptive": adaptive}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
