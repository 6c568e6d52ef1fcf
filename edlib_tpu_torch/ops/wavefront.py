"""Anti-diagonal wavefront: ONE long alignment on the whole card.

The port of edlib_tpu/ops/wavefront.py.  The batched kernels parallelise
over alignments; these classes parallelise a single pair over its query
words.  Word w (32 DP rows) processes column c = d - w at wavefront step d,
so every word of an anti-diagonal is independent, and the hout word w-1
emitted at step d-1 is word w's hin at step d (the kernels: wavefront and
wavefront_banded in ops/cuda_kernel.py, csrc/wavefront.cu).

* ``Wavefront`` — unbanded: NW distance, HW/SHW best score and first best
  end, the full bottom-row score stream, and the Hirschberg half-sweep
  (``column_cells``), over all query words.
* ``BandedWavefront`` — NW distance and SHW best end / all minimal ends with
  a window of word slots sliding along the band (exact within k, dynamic-k
  doubling on the host).  A call builds its k-invariant operands once, on
  the device, and hands them to every rung (_Operands: the profile, and
  for NW the scan targets and their tiles).  Under an open span
  (utils/profiling.child), an NW distance run is a span ``rung`` (attrs k
  and answered, as its take_rungs record) and every banded run has
  ``rung.init`` (the state, and in the call's first run the operands:
  attr built), ``rung.segments`` (launches and band-death fetches) and
  ``rung.result`` (the final fetch).

Both run in bounded resumable segments with the state (7 planes of one
int32 per word slot) kept on the device between them.  Slot counts follow
the JAX package (R * 128 slots, R a multiple of 8 or the banded window's
power of two), so the two packages' states convert one to one
(convert.wavefront_state_from_jax).  The JAX package's symbol window and
banded Peq window are not carried: a thread reads target[c] and the profile
word itself.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple, Tuple

import numpy as np
import torch

from edlib_tpu_torch import encode
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.utils import hw, profiling

LANES = 128
SUB_MIN = 8
_BIG = 0x3FFFFFFF
# The newest banded runs (k ladder rungs), oldest first: see take_rungs.
_RUNGS: deque = deque(maxlen=1024)


def take_rungs() -> list:
    """The banded runs since the last call, oldest first, and forget them:
    for each, its entry (distance_bounded, shw_best_bounded or
    shw_locations_bounded), k, the wavefront steps it ran in banded
    segments and in the pinned-tail stream, whether the band died before
    the last step, and whether it answered (the result was <= k)."""
    out = list(_RUNGS)
    _RUNGS.clear()
    return out


def _rung(fn: str, k: int, banded_steps: int, tail_steps: int, died: bool,
          out):
    _RUNGS.append(dict(fn=fn, k=k, banded_steps=banded_steps,
                       tail_steps=tail_steps, died=died,
                       answered=out is not None))
    return out


def _full_rows(n_words: int) -> int:
    """Slot rows holding every query word (a multiple of SUB_MIN)."""
    rows = -(-n_words // LANES)
    return max(SUB_MIN, -(-rows // SUB_MIN) * SUB_MIN)


def initial_state(ns: int, device) -> torch.Tensor:
    """(7, ns) int32: Pv all ones, Mv and hout 0, slot s's score (s+1)*32
    (the padded bottom cell of column -1), running min _BIG, argmin -1."""
    state = torch.zeros((ck.WF_PLANES, ns), dtype=torch.int32, device=device)
    state[0] = -1
    state[4] = (torch.arange(ns, dtype=torch.int32, device=device) + 1) * 32
    state[5] = _BIG
    state[6] = -1
    return state


def _profile(q_ids, sigma: int, n_words: int, eq, device) -> torch.Tensor:
    """(sigma+1, n_words) int32 profile bit words (row sigma: wildcard),
    encode.build_peq_words' bit for bit, built on the device: the query goes
    up once, a byte a symbol where sigma <= 256, and ck.build_peq_device
    scatters each cell's bit into its symbol's word; a row of eq beyond the
    identity then ORs in its equal symbols' rows.  Temporaries O(qlen +
    sigma * n_words)."""
    q = torch.from_numpy(np.asarray(
        q_ids, np.uint8 if sigma <= 256 else np.int32)).to(device)
    peq = ck.build_peq_device(
        q[None], torch.full((1,), len(q), dtype=torch.int32, device=device),
        sigma, n_words)[0]
    extra = [] if eq is None else np.argwhere(eq & ~np.eye(sigma, dtype=bool))
    if len(extra):
        own = peq.clone()
        for a, b in extra:
            peq[a] |= own[b]
    return peq


def _scan_targets(t_ids, t_scan: int, sigma: int, device) -> torch.Tensor:
    """The scan columns' symbols: the target, then the wildcard sigma up to
    t_scan (the padding rows' extension)."""
    t = np.full(t_scan, sigma, np.int32)
    t[:len(t_ids)] = np.asarray(t_ids)[:t_scan]
    return torch.from_numpy(t).to(device)


class _Prepared(NamedTuple):
    peq: torch.Tensor
    t: torch.Tensor
    n_words: int
    ns: int
    w_pad: int
    t_scan: int
    n_steps: int       # the last word reaches the last column at n_steps-1


class Wavefront:
    """Host side of the unbanded wavefront kernel.

    NW and SHW runs (hin0 = 1) are split into segments of seg_chunks *
    chunk steps, 2^18 by default (the JAX package's grain is 16,384: a
    segment here refills the kernel's pipeline of warp groups, and the
    carried state makes the cut invisible in the results); the last
    segment stops at the run's last step, where the JAX package runs inert
    steps to a whole segment.  An HW run (hin0 = 0) is one call from step
    0, which the kernel cuts into column cores (cuda_kernel.wavefront_core)."""

    def __init__(self, chunk: int = 512, seg_chunks: int = 512, device=None):
        self.chunk = chunk
        self.seg_chunks = seg_chunks
        self.device = hw.resolve_device(device)

    def _prepare(self, q_ids, t_ids, sigma: int, wildcard_ext: bool = True,
                 eq=None) -> _Prepared:
        qlen = len(q_ids)
        n_words = encode.num_words(qlen)
        R = _full_rows(n_words)
        w_pad = (n_words * 32 - qlen) if wildcard_ext else 0
        t_scan = len(t_ids) + w_pad
        return _Prepared(_profile(q_ids, sigma, n_words, eq, self.device),
                         _scan_targets(t_ids, t_scan, sigma, self.device),
                         n_words, R * LANES, w_pad, t_scan,
                         t_scan + n_words - 1)

    def _sweep(self, p: _Prepared, hin0: int, col_lo: int, col_hi: int,
               emit_stream: bool):
        """(final state, stream by step or None) of the whole run."""
        state = initial_state(p.ns, self.device)
        streams = []
        seg = p.n_steps if hin0 == 0 else self.chunk * self.seg_chunks
        for d in range(0, p.n_steps, seg):
            state, stream = ck.wavefront(p.t, p.peq, state, d,
                                         min(seg, p.n_steps - d), p.n_words,
                                         p.t_scan, hin0, col_lo, col_hi, 0,
                                         emit_stream)
            streams.append(stream)
        return state, (torch.cat(streams) if emit_stream else None)

    def column_cells(self, q_ids, t_ids, sigma: int, stop: int,
                     eq=None) -> np.ndarray:
        """NW column cells cell(r, stop), r in [0, qlen): the Hirschberg
        half-sweep on the card (edlib.cpp:896-908's targetStopPosition).

        Runs the wavefront over target[:stop+1] with NO wildcard extension,
        so every word's final (Pv, Mv, score) is its state at exactly column
        ``stop``; the 32-cells-per-word decode happens on the host."""
        qlen = len(q_ids)
        p = self._prepare(q_ids, np.asarray(t_ids)[:stop + 1], sigma,
                          wildcard_ext=False, eq=eq)
        state, _ = self._sweep(p, 1, 0, 0, False)
        planes = state[[0, 1, 4], :p.n_words].cpu().numpy()
        Pv = planes[0].view(np.uint32)
        Mv = planes[1].view(np.uint32)
        bottom = planes[2].astype(np.int64)
        # Word w's 32 rows from its bottom score:
        # cell(w, b) = bottom[w] - sum_{j > b} (P_bit(j) - M_bit(j)).
        bits = np.arange(32, dtype=np.uint32)
        delta = (((Pv[:, None] >> bits) & 1).astype(np.int64)
                 - ((Mv[:, None] >> bits) & 1).astype(np.int64))
        above = np.cumsum(delta[:, ::-1], axis=1)[:, ::-1] - delta
        cells = (bottom[:, None] - above).reshape(-1)
        return cells[:qlen]

    def run(self, q_ids, t_ids, sigma: int, hin0: int, col_lo: int,
            col_hi: int, emit_stream: bool = False, eq=None):
        """(bottom word's [score, runmin, runpos], w_pad[, stream]): the
        stream is the bottom word's score at scan columns [0, t_scan)."""
        p = self._prepare(q_ids, t_ids, sigma, eq=eq)
        state, stream = self._sweep(p, hin0, col_lo, col_hi, emit_stream)
        col = state[4:7, p.n_words - 1].cpu().numpy()
        if not emit_stream:
            return col, p.w_pad
        # Column c of the bottom word runs at step c + n_words - 1.
        first = p.n_words - 1
        return col, p.w_pad, stream[first:first + p.t_scan].cpu().numpy()

    def semiglobal_scores(self, q_ids, t_ids, sigma: int,
                          mode_is_hw: bool, eq=None) -> np.ndarray:
        """Full bottom-row score stream cell(Q-1, c), c in [0, tlen) (the
        input to align._filter_locations for all-locations lists)."""
        _, w_pad, stream = self.run(q_ids, t_ids, sigma,
                                    hin0=0 if mode_is_hw else 1,
                                    col_lo=0, col_hi=0, emit_stream=True,
                                    eq=eq)
        return stream[w_pad:w_pad + len(t_ids)]

    def nw_distance(self, q_ids, t_ids, sigma: int, eq=None) -> int:
        """cell(Q-1, T-1): the bottom word's final padded-bottom score."""
        col, _ = self.run(q_ids, t_ids, sigma, hin0=1, col_lo=0, col_hi=0,
                          eq=eq)
        return int(col[0])

    def semiglobal_best(self, q_ids, t_ids, sigma: int, mode_is_hw: bool,
                        eq=None) -> Tuple[int, int]:
        """(best, first best end position) over real end positions."""
        w_pad = encode.num_words(len(q_ids)) * 32 - len(q_ids)
        col, _ = self.run(q_ids, t_ids, sigma, hin0=0 if mode_is_hw else 1,
                          col_lo=w_pad, col_hi=w_pad + len(t_ids), eq=eq)
        return int(col[1]), int(col[2]) - w_pad


# ---------------------------------------------------------------------------
# Banded wavefront (NW, SHW): a window of WINW = R*128 word slots tracks the
# Ukkonen band down the main diagonal.  Word w's rows meet the band
# [c+lo, c+hi] at its column c = d - w iff 33w is in [d+lo-31, d+hi], so the
# window's top word advances one word every ~33 steps (wavefront_base).  On
# a slide the entering bottom word is "cell above + 1" and the window top
# takes the boundary hin = +1: the banded-Myers upper bounds, so every value
# <= k is exact and the host runs the dynamic-k doubling.
# ---------------------------------------------------------------------------


class _Operands:
    """One call's k-invariant operands of its banded runs: the first run
    builds them (inside its rung.init), every later rung of the call takes
    them.  The profile always; the scan targets and their tiles only where
    keep_targets (NW: SHW's targets end at min(tlen, qlen + k), so each
    rung makes its own).  Lives for one call: nothing outlasts it."""

    __slots__ = ("keep_targets", "peq", "t", "tiled")

    def __init__(self, keep_targets: bool = False):
        self.keep_targets = keep_targets
        self.peq = self.t = self.tiled = None


class BandedWavefront:
    """NW distance / SHW best-end search for one long pair with a sliding
    banded window.  Exact whenever the true result is <= k; the public
    entries run the dynamic-k doubling loop.  Window widths are powers of
    two slot rows, as in the JAX package (HW has no static band: long HW
    goes through the unbanded Wavefront)."""

    def __init__(self, seg_steps: int = 65536, r_min: int = SUB_MIN,
                 device=None):
        self.seg_steps = seg_steps
        self.r_min = r_min  # < SUB_MIN only for slide-forcing tests
        self.device = hw.resolve_device(device)

    def _rows(self, band_words: int, n_words: int) -> int:
        R = self.r_min
        while R * LANES < band_words:
            R *= 2
        return min(R, _full_rows(n_words))

    def _band_geometry(self, qlen: int, tlen: int, k: int):
        n_words = encode.num_words(qlen)
        diff = qlen - tlen
        s = max(0, (k - abs(diff)) // 2)
        lo = min(0, diff) - s
        hi = max(0, diff) + s
        return n_words, lo, self._rows((hi - lo + 31) // 33 + 3, n_words)

    def _init(self, q_ids, t_ids, sigma: int, n_words: int, R: int, eq,
              ops: _Operands):
        """(peq, scan targets, their 16-bit tiles, initial state) of a
        banded run: the tiles (on a card; None elsewhere) made once for
        every segment's tile form.  What ops holds is taken, the rest built
        (and kept in ops where it is k-invariant); the span's attr built
        says whether this run built the call's operands, and the counters
        wf.operands_built / wf.operands_reused count it."""
        with profiling.child("rung.init") as sp:
            built = ops.peq is None
            if built:
                ops.peq = _profile(q_ids, sigma, n_words, eq, self.device)
            t, tiled = ops.t, ops.tiled
            if t is None:
                t_scan = len(t_ids) + n_words * 32 - len(q_ids)
                t = _scan_targets(t_ids, t_scan, sigma, self.device)
                tiled = ck.tile_symbols(t, t_scan) if t.is_cuda else None
                if ops.keep_targets:
                    ops.t, ops.tiled = t, tiled
            sp.set(built=built)
            profiling.count("wf.operands_built" if built
                            else "wf.operands_reused")
            return ops.peq, t, tiled, initial_state(R * LANES, self.device)

    @staticmethod
    def _band_dead(state, d: int, n_words: int, lo: int, R: int,
                   k: int) -> bool:
        """Frontier-death test between segments: every cell of word w is
        >= score_w - 31 and DP edges never decrease values, so min over the
        window's live words of (bottom score) - 31 > k proves every future
        cell > k (the CPU core's band-vanish exit).  One scalar fetch."""
        WINW = R * LANES
        base = ck.wavefront_base(d - 1, lo, max(0, n_words - WINW))
        n_valid = min(WINW, n_words - base)
        if n_valid <= 0:
            return False
        return int(state[4, :n_valid].min()) - 31 > k

    def _segment(self, state, d: int, n_steps: int, peq, t, tiled, *,
                 n_words: int, lo: int, t_scan: int, col_lo: int,
                 col_hi: int):
        """One banded segment of n_steps from absolute step d."""
        return ck.wavefront_banded(t, peq, state, d, n_steps, n_words, t_scan,
                                   lo, col_lo, col_hi, tiled=tiled)

    def _run_banded(self, q_ids, t_ids, sigma: int, n_words: int, lo: int,
                    R: int, col_lo: int, col_hi: int, ops: _Operands,
                    eq=None, k_exit=None):
        """Run the banded sweep; return the bottom word's (score, runmin,
        runpos) as ints, the steps run and whether the band died.  k_exit:
        stop as soon as the frontier provably exceeds it (_band_dead); hits
        recorded before death still count (they keep the frontier <= k, so
        death comes after the last)."""
        qlen, tlen = len(q_ids), len(t_ids)
        WINW = R * LANES
        t_scan = tlen + n_words * 32 - qlen
        n_steps_total = t_scan + n_words - 1
        peq, t, tiled, state = self._init(q_ids, t_ids, sigma, n_words, R,
                                          eq, ops)
        d = 0
        died = False
        with profiling.child("rung.segments"):
            while d < n_steps_total:
                # The JAX package runs whole segments past the last step;
                # those steps are inert and only slide the window toward its
                # cap, which never moves the bottom word once the window
                # holds it.
                n = min(self.seg_steps, n_steps_total - d)
                state = self._segment(state, d, n, peq, t, tiled,
                                      n_words=n_words, lo=lo, t_scan=t_scan,
                                      col_lo=col_lo, col_hi=col_hi)
                d += n
                if (k_exit is not None and d < n_steps_total
                        and self._band_dead(state, d, n_words, lo, R,
                                            k_exit)):
                    died = True
                    break
        # The bottom word's slot follows the base at the last executed step.
        slot = (n_words - 1) - ck.wavefront_base(d - 1, lo,
                                                 max(0, n_words - WINW))
        if slot >= WINW:
            # Died before the window reached the bottom word: every
            # bottom-row cell is provably > k_exit, nothing was tracked.
            return _BIG, _BIG, -1, d, died
        with profiling.child("rung.result"):
            score, runmin, runpos = state[4:7, slot].tolist()
        # On death the bottom word's final column was never reached; only
        # the tracked (runmin, runpos) hits (all <= k_exit) are valid.
        return (_BIG if died else score), runmin, runpos, d, died

    def distance_bounded(self, q_ids, t_ids, sigma: int, k: int, eq=None,
                         ops=None):
        """NW distance if <= k else None.  ops: the call's _Operands, shared
        by its rungs (a new one where None)."""
        with profiling.child("rung") as sp:
            n_words, lo, R = self._band_geometry(len(q_ids), len(t_ids), k)
            score, _, _, steps, died = self._run_banded(
                q_ids, t_ids, sigma, n_words, lo, R, col_lo=0, col_hi=0,
                ops=ops or _Operands(), eq=eq, k_exit=k)
            sp.set(k=k, answered=score <= k)
            return _rung("distance_bounded", k, steps, 0, died,
                         score if score <= k else None)

    def shw_best_bounded(self, q_ids, t_ids, sigma: int, k: int, eq=None,
                         ops=None):
        """SHW (best score, first best end position) if the best is <= k,
        else None.  SHW cells are prefix-vs-prefix global distances, so
        cell(r, c) >= |r - c|: the band -k..+k covers every value <= k, and
        end columns past qlen-1+k are cut off (edlib.cpp:550-704)."""
        qlen, tlen = len(q_ids), len(t_ids)
        k = min(k, max(qlen, tlen))
        tlen_eff = min(tlen, qlen + k)
        n_words = encode.num_words(qlen)
        R = self._rows((2 * k + 31) // 33 + 3, n_words)
        w_pad = n_words * 32 - qlen
        _, best, pos, steps, died = self._run_banded(
            q_ids, np.asarray(t_ids)[:tlen_eff], sigma, n_words, -k, R,
            col_lo=w_pad, col_hi=w_pad + tlen_eff,
            ops=ops or _Operands(), eq=eq, k_exit=k)
        return _rung("shw_best_bounded", k, steps, 0, died,
                     (best, pos - w_pad) if best <= k else None)

    # Segment sizes for landing the banded phase inside the [window-pin,
    # first-emission] step interval (always >= 64 steps wide:
    # 33*WINW - 2k - 33 with WINW >= (2k+31)//33 + 3).
    _TAIL_BUCKETS = (65536, 32768, 4096, 512, 64)

    def _landing(self, d_pin: int, d_emit: int, n_steps_total: int):
        """The phase-1 segment sizes: a greedy walk from step 0 that ends
        at a step d with d_pin <= d <= d_emit (the window fully slid, no
        emission column missed)."""
        buckets = tuple(b for b in self._TAIL_BUCKETS
                        if b <= self.seg_steps) or (self.seg_steps,)
        d = 0
        while d < d_pin:
            limit = min(d_emit, n_steps_total)
            b = next((b for b in buckets if d + b <= limit), None)
            if b is None:  # tiny remaining gap; exact-size fallback
                b = min(d_pin - d, self.seg_steps, max(1, limit - d))
            yield d, b
            d += b

    def shw_locations_bounded(self, q_ids, t_ids, sigma: int, k: int,
                              eq=None, ops=None):
        """SHW (best, [ALL minimal end positions]) if best <= k, else None:
        the banded full-stream search.

        Phase 1 slides the banded window up to a step in [d_pin, d_emit]:
        d_pin is where the window stops sliding (base at its cap), d_emit
        the first step at which the bottom word reaches a column that can
        hold a value <= k.  After the pin the banded recurrences ARE the
        unbanded kernel's on the window, so phase 2 hands the state to the
        stream-emitting wavefront kernel with word0 = base_cap and collects
        the bottom-score stream over the emission columns."""
        from edlib_tpu_torch.align import _filter_locations
        qlen, tlen = len(q_ids), len(t_ids)
        k = min(k, max(qlen, tlen))
        tlen_eff = min(tlen, qlen + k)
        if qlen - k > tlen_eff:
            # Every SHW alignment deletes >= qlen - tlen_eff > k chars.
            return _rung("shw_locations_bounded", k, 0, 0, False, None)
        t_eff = np.asarray(t_ids)[:tlen_eff]
        n_words = encode.num_words(qlen)
        lo = -k
        R = self._rows((2 * k + 31) // 33 + 3, n_words)
        w_pad = n_words * 32 - qlen
        t_scan = tlen_eff + w_pad
        n_steps_total = t_scan + n_words - 1
        base_cap = max(0, n_words - R * LANES)
        # Phase 2 must start after the LAST slide: the slide to base_cap
        # happens at the start of step d_pin, so phase 2 starts at
        # d >= d_pin + 1.
        d_pin = 0 if base_cap == 0 else 33 * base_cap + 31 + k + 1
        c_emit = w_pad + max(0, qlen - 1 - k)  # first col that can be <= k
        d_emit = (n_words - 1) + c_emit
        if d_pin > d_emit:  # unreachable by the WINW bound; belt-and-braces
            d_pin = 0
            base_cap = 0
            R = _full_rows(n_words)

        peq, t, tiled, state = self._init(
            q_ids, t_eff, sigma, n_words, R, eq,
            ops or _Operands())
        d = 0
        for d0, b in self._landing(d_pin, d_emit, n_steps_total):
            state = self._segment(state, d0, b, peq, t, tiled,
                                  n_words=n_words, lo=lo, t_scan=t_scan,
                                  col_lo=0, col_hi=0)
            d = d0 + b
            if d < d_pin and self._band_dead(state, d, n_words, lo, R, k):
                # Bottom-row columns are all in the future: nothing <= k.
                return _rung("shw_locations_bounded", k, d, 0, True, None)

        # Phase 2: the pinned-tail stream (word0 = base_cap).
        streams = []
        for s0 in range(d, n_steps_total, self.seg_steps):
            n = min(self.seg_steps, n_steps_total - s0)
            state, stream = ck.wavefront(t, peq, state, s0, n, n_words,
                                         t_scan, 1, 0, 0, base_cap, True)
            streams.append(stream)
        by_step = torch.cat(streams).cpu().numpy()  # sample after step d + s
        # The bottom word is at scan column c after step c + n_words - 1.
        scores_cells = np.full(tlen_eff, _BIG, np.int64)
        c0 = max(w_pad, d - (n_words - 1))  # cols before d are pre-tail (> k)
        steps0 = c0 + n_words - 1 - d
        n_c = t_scan - c0
        scores_cells[c0 - w_pad:] = by_step[steps0:steps0 + n_c][
            :tlen_eff - (c0 - w_pad)]
        best, positions = _filter_locations(scores_cells, qlen, k)
        return _rung("shw_locations_bounded", k, d,
                     max(0, n_steps_total - d), False,
                     (best, positions) if best >= 0 else None)

    def shw_locations(self, q_ids, t_ids, sigma: int, k: int = -1, eq=None):
        """SHW (best, [all minimal end positions]); (-1, []) when k >= 0
        and the best exceeds k.  Dynamic-k doubling when k < 0."""
        cap = max(1, min(len(q_ids), self._hamming_cap(q_ids, t_ids, eq)))
        if k < 0:
            return self._ladder(self.shw_locations_bounded, q_ids, t_ids,
                                sigma, cap, eq, _Operands())
        r = self.shw_locations_bounded(q_ids, t_ids, sigma, k, eq=eq)
        return (-1, []) if r is None else r

    @staticmethod
    def _hamming_cap(q_ids, t_ids, eq) -> int:
        """encode.nw_upper_bound, also valid for semiglobal ladders
        (semiglobal best <= d_NW)."""
        return encode.nw_upper_bound(q_ids, t_ids, eq)

    @staticmethod
    def _ladder(bounded, q_ids, t_ids, sigma: int, cap: int, eq,
                ops: _Operands):
        """The dynamic-k doubling: k = 64, 128, ... up to cap, where the
        run always succeeds; every rung takes the call's operands ops."""
        kk = 64
        while True:
            r = bounded(q_ids, t_ids, sigma, min(kk, cap), eq=eq, ops=ops)
            if r is not None:
                return r
            if kk >= cap:
                raise RuntimeError("unreachable: the ladder's cap bounds "
                                   "the result")
            kk *= 2

    def nw_distance(self, q_ids, t_ids, sigma: int, k: int = -1, eq=None,
                    cap=None) -> int:
        """NW distance; -1 when k >= 0 and it exceeds k.  cap: the pair's
        encode.nw_upper_bound, where the caller already has it."""
        if cap is None:
            cap = self._hamming_cap(q_ids, t_ids, eq)
        bound = max(1, min(max(len(q_ids), len(t_ids)), cap))
        if k < 0:
            return self._ladder(self.distance_bounded, q_ids, t_ids, sigma,
                                bound, eq, _Operands(keep_targets=True))
        d = self.distance_bounded(q_ids, t_ids, sigma, min(k, bound), eq=eq)
        return -1 if d is None else d

    def shw_best(self, q_ids, t_ids, sigma: int, k: int = -1,
                 eq=None) -> Tuple[int, int]:
        """SHW (best score, first best end position); (-1, -1) when k >= 0
        and the best exceeds k.  Dynamic-k doubling when k < 0 (the bottom
        row always holds a value <= qlen, so the loop ends)."""
        cap = max(1, min(len(q_ids), self._hamming_cap(q_ids, t_ids, eq)))
        if k < 0:
            return self._ladder(self.shw_best_bounded, q_ids, t_ids, sigma,
                                cap, eq, _Operands())
        r = self.shw_best_bounded(q_ids, t_ids, sigma, k, eq=eq)
        return (-1, -1) if r is None else r
