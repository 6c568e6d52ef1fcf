#!/usr/bin/env python3
"""Smoke run of edlib_tpu_torch on one NVIDIA card (run: python3 chip_smoke.py).

Phases, each of which exits non-zero on any failure:

1. Build the CUDA kernels from edlib_tpu_torch/ops/csrc with nvcc (sm_90a)
   and print the card's name and power limit.
2. Hold every kernel against its plain PyTorch version on the card, at small
   shapes, for exact equality (every output is an integer).
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
   and its output held against its plain version's on the same operands:
   over every column for the per-lane reduces, over the first
   SHARED_PLAIN_COLS columns for the shared sweep.  Beside each: the plain
   version's time over the columns it ran, and the least time the card
   could take.

Output: the kernels' JSON line, the end-to-end JSON line, the card line, and
last {"ok": true, "device": {...}}.  Data comes from --seed.
"""

from __future__ import annotations

import argparse
import json
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
# The shared sweep's plain version runs over the first 3 staging chunks of
# csrc/myers.cu (kChunk = 2048) and a ragged tail; its full-width output is
# held against an O(Q*T) DP on the card (dp_best_hw_card) instead.
SHARED_PLAIN_COLS = 3 * 2048 + 37
# Main-path sizes (bench.py's read-mapping shape).
READS, QLEN, N_RANDOM = 8192, 120, 96
BASE_LEN, TILES = 1 << 20, 4          # sigma=4 target: BASE_LEN random, tiled
BIG_SIGMA, BIG_SIGMA_LEN = 100, 1 << 20
SHW_LEN, SHW_READS, SEG_LEN, SEG_READS = 5000, 128, 60_000, 32
KERNEL_SOURCE = "edlib_tpu_torch/ops/csrc/myers.cu"
REPLACES = {
    "reduce_lanes": "edlib_tpu/ops/pallas_kernel.py:605",
    "sweep_shared": "edlib_tpu/ops/pallas_kernel.py:342",
    "reduce_bitplane": "edlib_tpu/ops/pallas_kernel.py:2040",
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


def max_abs_err(got, want) -> float:
    return max((float((g.long() - w.long()).abs().max()) if g.numel() else 0.0)
               for g, w in zip(got, want))


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
            ops = lane_operands(rng, dev, n_lanes=300, n_rows=6, T=400, s1=5,
                                nw=nw)
            check_equal(f"reduce_lanes nw={nw} hin0={hin0}",
                        ck.reduce_lanes(*ops, hin0),
                        ck.reduce_lanes_plain(*ops, hin0))
            words = rng.randint(0, 1 << 32, (5, nw, 70), dtype=np.uint64)
            peq_t = torch.from_numpy(
                words.astype(np.uint32).view(np.int32)).to(dev)
            target = ops[1][0].contiguous()
            check_equal(f"sweep_shared nw={nw} hin0={hin0}",
                        ck.sweep_shared(peq_t, target, hin0, 17, 390),
                        ck.sweep_shared_plain(peq_t, target, hin0, 17, 390))
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
            rng, dev, n_lanes=300, n_rows=B, T=400, s1=sigma + 2, nw=1)
        for hin0 in (0, 1):
            args = (planes, pad, targets, lo, hi, prow, trow, hin0)
            check_equal(f"reduce_bitplane nw={nw} hin0={hin0}",
                        ck.reduce_bitplane(*args, nb, 1, sigma),
                        ck.reduce_bitplane_plain(*args, nb, 1, sigma))


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
        def call(*args):
            if self.on:
                self.calls[name].append(args)
            return fn(*args)
        call.__name__ = name
        return call

    def take(self):
        calls = self.calls
        self.calls = {name: [] for name in self.orig}
        return calls


def time_ms(fn, reps: int) -> float:
    import torch
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


def profile_call(fn, top: int = 8) -> dict:
    """Device time of one call by kernel (torch.profiler over CUPTI), the
    call's wall time, and the device's idle share of that wall time."""
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
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top": [{"name": k[:80], "device_ms": ms, "count": c}
                    for k, ms, c in rows[:top]]}


def lane_call_cost(peq_words, targets, lo, hi, prow, trow, ops_col):
    """(bytes, ops) a per-lane reduce call needs: every profile row and every
    target row a lane reads (up to the furthest column any lane scans in it),
    the lane vectors in and the four outputs out; ops_col operations for
    every column a lane scans."""
    import torch
    T = targets.shape[1]
    n = lo.shape[0]
    cols = hi.long().clamp(0, T)
    row_cols = torch.zeros(targets.shape[0], dtype=torch.int64,
                           device=cols.device)
    row_cols.scatter_reduce_(0, trow.long(), cols, "amax")
    n_prof = int(torch.unique(prow[cols > 0]).numel())
    nbytes = (n_prof * peq_words * 4 + int(row_cols.sum()) * 4
              + n * 4 * 4 + n * 4 * 4)
    return nbytes, int(cols.sum()) * ops_col


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def measure(ck, name, calls):
    """Kernel time, plain time and bound summed over a main path's calls of
    one kernel, each call's output held against its plain version's.  The
    per-lane reduces run their plain versions over every column of the call;
    the shared sweep over its first SHARED_PLAIN_COLS columns (plain_cols
    says how many were timed)."""
    import torch
    kernel = getattr(ck, name)
    plain = getattr(ck, name + "_plain")
    out = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, nbytes=0, ops=0,
               max_abs_err=0.0, calls=[])
    for args in calls:
        if name == "sweep_shared":
            peq_t, target, hin0, col_lo, col_hi = args
            nw, n = peq_t.shape[1], peq_t.shape[2]
            end = min(target.shape[0], col_hi)
            nbytes = peq_t.numel() * 4 + end * 4 + n * 8
            ops = n * end * (nw * OPS_PER_WORD + OPS_PER_COLUMN_SHARED)
            plain_cols = min(end, SHARED_PLAIN_COLS)
            checked = (peq_t, target, hin0, col_lo, plain_cols)
        else:
            # Operand positions: reduce_lanes(peq, targets, lo, hi, prow,
            # trow, hin0); reduce_bitplane(planes, pad, targets, lo, hi,
            # prow, trow, hin0, nb, n_alts, wildcard).
            i = 1 if name == "reduce_lanes" else 2
            targets, lo, hi, prow, trow = args[i:i + 5]
            if name == "reduce_lanes":
                nw = args[0].shape[2]
                nbytes, ops = lane_call_cost(
                    args[0].shape[1] * nw, targets, lo, hi, prow, trow,
                    nw * OPS_PER_WORD + OPS_PER_COLUMN)
            else:
                nw, nb, n_alts = args[1].shape[1], args[8], args[9]
                # Eq per word: one 3-input op per plane and alternative plus
                # the OR into the word; per column two ops per plane for the
                # symbol's bit masks and two for the wildcard test.
                nbytes, ops = lane_call_cost(
                    args[0].shape[1] + nw, targets, lo, hi, prow, trow,
                    nw * (OPS_PER_WORD + n_alts * (nb + 1))
                    + 2 * nb + 2 + OPS_PER_COLUMN)
            n = lo.shape[0]
            end = min(targets.shape[1], int(hi.max()))
            plain_cols = end
            checked = args
        reps = 3 if end * n > 1e8 else 10
        ms = time_ms(lambda: kernel(*args), reps)
        got = kernel(*checked)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(*checked)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        out["max_abs_err"] = max(out["max_abs_err"],
                                 check_equal(f"{name} on main-path operands",
                                             got, want))
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        b, _ = bound(nbytes, ops)
        out["bound_ms"] += b
        out["nbytes"] += nbytes
        out["ops"] += ops
        out["calls"].append(dict(lanes=n, cols=end, nw=nw, ms=ms,
                                 plain_ms=plain_ms, plain_cols=plain_cols,
                                 bound_ms=b))
        log(f"{name} call: {n} lanes x {end} cols, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms over {plain_cols} cols, equal")
        del got, want
        torch.cuda.empty_cache()
    out["bound_by"] = bound(out["nbytes"], out["ops"])[1]
    return out


# --------------------------------------------------------------------------
# Main
# --------------------------------------------------------------------------


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
        from edlib_tpu_torch.ops import _build
        from edlib_tpu_torch.ops import cuda_kernel as ck
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

    # 2. Kernels vs plain versions, small shapes.
    check_kernels(rng, dev, ck)
    log("kernels equal their plain versions at small shapes")

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

    # 6. Timings on the main paths' own operands.
    kernels = []
    for name, calls, counts in (
            ("reduce_lanes", main_calls["reduce_lanes"], launches),
            ("sweep_shared", main_calls["sweep_shared"], launches),
            ("reduce_bitplane", bitplane_calls["reduce_bitplane"],
             launches100)):
        m = measure(ck, name, calls)
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "plain_cols": sum(c["plain_cols"] for c in m["calls"]),
            "cols": sum(c["cols"] for c in m["calls"]),
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "path": "sigma=100" if name == "reduce_bitplane" else "sigma=4",
            "calls": m["calls"], "card": card})
        log(f"timed {name}: {m['ms']:.3f} ms (plain {m['plain_ms']:.1f} ms, "
            f"bound {m['bound_ms']:.4f} ms)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": {
        "card": card, "reads": B, "qlen": QLEN, "target_len": len(t_ids),
        "sigma": 4, "k": -1, "map_reads_cold_s": cold_s,
        "map_reads_warm_s": warm_s, "full_shared_sweep_s": sweep_s,
        "sigma100_target_len": len(t100), "sigma100_map_reads_cold_s":
        cold100_s, "build_s": build_s, "warm_profile": prof}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
