// Myers bit-vector sweeps for NVIDIA Hopper (sm_90a), bound from Python with
// ctypes (edlib_tpu_torch/ops/_build.py).  Plain C interface: every pointer and
// the stream arrive as void*, every function returns the cudaError_t of its
// launch (0 = cudaSuccess) and never synchronises or allocates.
//
// Fourteen kernels, one thread per alignment lane (one per core of a
// lane in K1, K2, K3, myers_hits_lanes and myers_hits_bitplane at 1-8
// words; a block, in the wave form below; a segment of 2-8 threads in the
// word-parallel lane and of 2-16 in the word-parallel band of
// myers_nw_banded, myers_shw_banded and myers_shw_banded_hits; warp groups
// for the score stream's long lanes; a thread a word of 8-32 lanes in
// myers_capture's word groups; a thread-block cluster per 1,024-lane tile
// for myers_hw_adaptive).  Each replaces a kernel of
// edlib_tpu/ops/pallas_kernel.py:
//
//   myers_reduce_lanes     _reduce_kernel (:434), per-lane form, launched by
//                          _sweep_reduce_call (:580, pallas_call :605); its
//                          shared form (shared=True, same call) is this
//                          kernel with one target row for every lane.  At
//                          1-8 words a thread is one core of a lane (the
//                          split-lane schedule below).
//   myers_reduce_bitplane  the bit-plane form of the same kernel
//                          (_bitplane_tb :407, _bitplane_eq :415), launched by
//                          _sweep_reduce_bitplane_call (:2013, pallas_call
//                          :2040); split-lane at 1-8 words, as
//                          myers_reduce_lanes.
//   myers_sweep_shared     _shared_kernel (:249), launched by
//                          sweep_best_pallas_shared (:325, pallas_call :342);
//                          split-lane at 1-8 words, as myers_reduce_lanes.
//   myers_hits_lanes       _hits_kernel (:768), per-lane and shared forms,
//                          launched by _sweep_hits_call (:855, pallas_call
//                          :874).  At 1-8 words and hin0 = 0 split-lane
//                          (as myers_reduce_lanes), its cores aligned to
//                          whole hit words.
//   myers_hits_bitplane    its bit-plane form, _sweep_hits_bitplane_call
//                          (:2062, pallas_call :2083); split-lane at 1-8
//                          words on K3's staged rows, its cores aligned to
//                          whole hit words.
//   myers_nw_banded        _nw_banded_kernel (:961, pallas_call :1066);
//                          the word-parallel band at window widths 2-16
//                          (below).
//   myers_shw_banded       _shw_banded_kernel (:1091, pallas_call :1215);
//                          the word-parallel band at window widths 2-16,
//                          as myers_nw_banded.
//   myers_shw_banded_hits  _shw_banded_hits_kernel (:1243, pallas_call
//                          :1348); the word-parallel band at window
//                          widths 2-16, as myers_nw_banded.
//   myers_capture          _capture_kernel (:2548), launched by
//                          _sweep_capture_call (:2605, pallas_call :2635)
//                          through capture_flat_device (:2655); word
//                          groups over lanes up to 512 words (below).
//   myers_sweep_scores     _sweep_kernel (:134), launched by
//                          sweep_scores_pallas (:196, pallas_call :211): the
//                          bottom-row score of every column of every lane,
//                          stored instead of reduced.  Peq is read per lane,
//                          so it takes any alphabet (the TPU kernel's S1-way
//                          select capped it at 64 rows).  At 2-8 words the
//                          word-parallel lane, from 256 words warp groups
//                          (below).
//   myers_reduce_eqstream  _reduce_kernel with eq_stream=True, launched by
//                          _sweep_reduce_eqstream_call (:1851, pallas_call
//                          :1869): Eq words pre-gathered per column.  At
//                          2-8 words the word-parallel lane.
//   myers_hits_eqstream    _hits_kernel with eq_stream=True, launched by
//                          _sweep_hits_eqstream_call (:1891, pallas_call
//                          :1905).  At 2-8 words the word-parallel lane.
//   myers_reduce_resume    _reduce_kernel with resume=True (:434), launched
//                          by _sweep_reduce_resumable_call (:649,
//                          pallas_call :679) through
//                          reduce_resumable_flat_device (:716): the reduce
//                          of one target segment from a carried (Pv, Mv,
//                          score), with the exit state written out.  It
//                          sweeps exactly the segment's columns (the TPU
//                          wrapper asserts T % chunk == 0, since swept pad
//                          columns would corrupt the carry); split-lane at
//                          1-8 words, the cores at column 0 from the carry;
//                          one core a lane at 2-8 words is the
//                          word-parallel lane (below).
//   myers_hw_adaptive      _hw_adaptive_kernel (:1469), launched by
//                          sweep_hw_adaptive_pallas (:1636, pallas_call
//                          :1669): the value-adaptive banded HW/SHW reduce,
//                          its live word band shared by a 1,024-lane tile,
//                          the tile spread over a thread-block cluster
//                          (hw_adaptive_cluster_kernel below).
// myers_sweep_scores also takes an optional carry in and out (the resumable
// score stream, jax_engine.sweep_scores_resumable, which the JAX package
// leaves to XLA).
//
// What bounds them on this card: integer issue.  advance_word below is 20
// two-input operations as written, 13 as Hopper issues them (a logic function
// of up to three inputs is one LOP3, (x << 1) | bit one LEA): eq|hneg, the
// AND, the add, xh, ph, mh, xv, pv, mv, two shifts out, two LEAs in.  The
// carried score and the windowed reduction add about 6 per column, and the
// H100 SXM issues 64 INT32 operations per SM per clock: 132 SMs x 64 x
// 1.98 GHz, about 16.7e12 operations/s.  The bytes are small beside that: one
// symbol (4 B) per lane-column, the Eq words come from a few KB per lane that
// stay in L1/L2; a hit mask writes one bit per lane-column.
//
// What the designs do about it.  A thread keeps its Pv/Mv words and running
// reduction in registers (templated on the word count for 1-8 words, on the
// band window width for 1, 2, 4, 8, 12 and 16 words; other counts keep their
// state in a global scratch buffer laid out (NW, lanes) so a warp's accesses
// coalesce, or take the wave form below).  A column is one dependent chain
// of word updates, so issue is only reached with many threads resident: a
// launch of a few long lanes is latency-bound.
//
// K1 (myers_reduce_lanes), K3 (myers_reduce_bitplane), K2
// (myers_sweep_shared), #5 (myers_hits_lanes), #13 (myers_hits_bitplane)
// and the resumable reduce at 1-8 words take the split-lane schedule (see "The split-lane schedule" below): in HW mode a
// long lane is cut into cores of columns, each core one thread that starts
// from the fresh state a halo of 2 * 32 * NW columns before its core (the
// resumable reduce's first cores from the carry), so a few long lanes (K2's
// overflow stragglers, K1's and K3's segmented fallbacks, the shared row,
// the sharded pipelines' segments) fill the card; each thread streams its target columns through shared memory
// with cp.async, keeps its block's profile rows (K3 and #13: its rows'
// expanded bit-plane profiles) in shared memory and loads the next
// column's Eq words
// before the current column advances.  Past 8 words, and in the other
// kernels, each thread sweeps one lane and loads each column's symbol and
// Eq words from memory on the critical path.  A lane stops at its own window end hi, so padded
// candidates (hi = 0) cost nothing.
//
// The capture kernel is bound by its stores instead: it writes every
// column's Pv and Mv (and Ph and Mh) words, 8-16 bytes per word-column
// against its 13 operations, so at the PATH windows' shapes its bound is the
// output bytes over the HBM rate.  Its outputs are lane-minor, (column,
// word, lane), so the stores of one word of a block's 8-32 lanes fill
// whole 32-byte sectors (the (lane, column, word) order of the JAX
// package's flat outputs would put neighbouring lanes Tp * NW words
// apart); the wrapper hands out the (lane, column, word) view.  It runs
// word groups over lanes (see "Column capture" below); past 512 words it
// reads the previous column's state back from its own output.
//
// The eq-stream kernels read each lane-column's NW Eq words (4 * NW bytes)
// from a stream gathered before the launch, against 13 * NW operations: at
// about 3.3 operations a byte, where the card issues about 5 for every byte
// HBM delivers, so they are bound by bytes.  The stream is lane-minor,
// (column, word, lane), so a warp's loads of one word fill whole lines (the
// TPU's (n_tiles, n_chunks, chunk*NW, 8, 128) blocks are not kept).  The
// score-stream kernel writes 4 bytes per lane-column (lane-minor,
// (column, lane), so a warp's stores of one column fill whole lines)
// against 13 * NW + 1 operations: at one or two words it is bound by its
// stores, beyond that by integer issue.
//
// Past 8 words (template argument 0) a lane takes one of two forms.  A
// lane of kWaveMinWords to kWaveWords * kWaveThreads words (one long pair,
// 8-131 kbp) is a block of its own, the wave form: in one thread its column
// would be one dependent chain of word updates, about 6 dependent operations
// a word, so instead each thread holds kWaveWords words in registers and
// runs one column behind the thread above it, which makes the block an
// anti-diagonal pipeline on one SM, one barrier a column step.  Other lanes
// keep their state in the global scratch buffer, one thread a lane.  The
// score stream runs lanes of kWaveMinWords words and more as warp groups
// linked by per-tile records instead (csrc/groups.cuh), spread over the
// SMs with no barrier, in passes where a lane holds more groups than one
// launch keeps resident.
//
// Where a lane cannot be cut into column cores (the resumable reduce at
// hin0 = 1, NW and SHW being prefix-anchored; the score stream, which
// writes every column; the eq-stream kernels, whose lanes are shorter than
// a core's four halos) and has 2-8 words, its words run on a segment of
// threads of one warp, each a tile of 16 columns behind the one above, the
// word-parallel lane (below): a tile's carries go down in one shuffle, and a
// column's chain is the word update's Pv recurrence.  Banded NW's window
// of 2-16 words runs the same way on the word-parallel band, each
// absolute word a tile behind the one above so that the words keep their
// lag as the window slides, and banded SHW's reduce and hit words on the
// same band; the capture runs each word of a block's lanes on a group of
// threads, a tile behind the word above.
//
// Semantics are the TPU kernels' exactly:
//   score starts at NW*32 (the padded bottom cell of column -1), hin of the
//   top word is 0 (HW: free leading gap) or +1 (SHW/NW), and for scan columns
//   c in [lo, hi):  best = min score, pfirst = first column reaching it,
//   plast = last column reaching it; last = score at column hi-1; the hit
//   mask has bit c%32 of word c/32 set where score == best; the score
//   stream holds the score after every column c < T.
//   Columns past the row length are not scanned (callers keep hi <= T).
//   A carried state (Pv, Mv words (lanes, NW), score (lanes,)) replaces the
//   fresh start where a kernel takes one; the resumable reduce and the
//   carry form of the score stream sweep every column of the row and write
//   the state after the last one.
// The banded kernels advance only the window of n_win words whose top word
// for column c is woff[c / chunk] (nondecreasing).  Words below the window
// keep the reset state (Pv = ~0, Mv = 0), which is the band's ramp init, so
// a word entering the window needs no initialisation; words that left it are
// never read again.  The window's top word takes hin = +1.  The carried score
// is the window's bottom row: it starts at (woff[0] + n_win) * 32 and gains
// 32 for every word the window slides down.  Outputs count only columns where
// the window has reached the bottom word (woff == NW - n_win); a value above
// the band's k is an overestimate, never below the true one.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "groups.cuh"

namespace {

constexpr int32_t kBig = 0x3FFFFFFF;  // pallas_kernel._BIG: "no column seen"
constexpr int kThreads = 64;          // lanes per block
constexpr int kChunk = 2048;          // shared-target symbols staged per step
constexpr int kMaxPlanes = 9;         // bit planes for symbols up to 256 + sentinel
constexpr int kWaveWords = 8;         // words per thread of a wave block
constexpr int kWaveThreads = 512;     // threads of a wave block, at most
constexpr int kWaveMinWords = 256;    // lanes of this many words take a block

// One Myers block update (edlib.cpp:412-447; pallas_kernel._advance_word_h).
// hneg/hpos carry the horizontal delta into the word (1 where it is -1/+1)
// and return the delta out of its top cell.  ph/mh receive the word's
// unshifted horizontal deltas: bit i set where cell(i, c) - cell(i, c-1) is
// +1 / -1.
__device__ __forceinline__ void advance_word_h(uint32_t& pv, uint32_t& mv,
                                               uint32_t eq, uint32_t& hneg,
                                               uint32_t& hpos, uint32_t& ph,
                                               uint32_t& mh) {
  const uint32_t xv = eq | mv;
  eq |= hneg;
  const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
  ph = mv | ~(xh | pv);
  mh = pv & xh;
  const uint32_t phs = (ph << 1) | hpos;
  const uint32_t mhs = (mh << 1) | hneg;
  hpos = ph >> 31;
  hneg = mh >> 31;
  pv = mhs | ~(xv | phs);
  mv = phs & xv;
}

// The same update without the horizontal deltas (pallas_kernel._advance_word).
__device__ __forceinline__ void advance_word(uint32_t& pv, uint32_t& mv,
                                             uint32_t eq, uint32_t& hneg,
                                             uint32_t& hpos) {
  uint32_t ph, mh;
  advance_word_h(pv, mv, eq, hneg, hpos, ph, mh);
}

// One lane's carried state: words (nw,) and the score in, the same out after
// the last column.  A null pv0 starts fresh (Pv = ~0, Mv = 0, score =
// nw*32); a null pv1 keeps nothing.
struct LaneCarry {
  const uint32_t* pv0 = nullptr;
  const uint32_t* mv0 = nullptr;
  const int32_t* s0 = nullptr;
  uint32_t* pv1 = nullptr;
  uint32_t* mv1 = nullptr;
  int32_t* s1 = nullptr;

  __device__ __forceinline__ uint32_t pv(int w) const {
    return pv0 ? pv0[w] : ~0u;
  }
  __device__ __forceinline__ uint32_t mv(int w) const {
    return pv0 ? mv0[w] : 0u;
  }
  __device__ __forceinline__ int32_t score(int nw) const {
    return pv0 ? *s0 : nw * 32;
  }
  __device__ __forceinline__ void keep(int w, uint32_t p, uint32_t m) const {
    if (pv1) {
      pv1[w] = p;
      mv1[w] = m;
    }
  }
  __device__ __forceinline__ void keep_score(int32_t score) const {
    if (pv1) *s1 = score;
  }
};

// Visitors: a sweep calls update(score, c, live) for every scanned column
// c < min(hi, n_cols) and finish(end) after the last one.  live is false
// where a banded window has not reached the bottom word.

// (best, pfirst, plast) over [lo, hi) and last = score at hi-1.
struct Reduction {
  int lo, hi;
  int32_t best = kBig, pfirst = -1, plast = -1, last = kBig;

  __device__ __forceinline__ void update(int32_t score, int c, bool live) {
    if (!live) return;
    if (c >= lo) {
      if (score <= best) plast = c;
      if (score < best) {
        best = score;
        pfirst = c;
      }
    }
    if (c == hi - 1) last = score;
  }
  __device__ __forceinline__ void finish(int) {}
};

// Reduction over [lo, hi) of a sweep that runs past hi (the resumable
// reduce sweeps its whole segment, for the exit state).  take is update
// written with selects: in the word-parallel lane branches would split the
// warp between its shuffles every column (measured slower on the card).
struct WindowReduction : Reduction {
  __device__ __forceinline__ void update(int32_t score, int c, bool live) {
    if (c < hi) Reduction::update(score, c, live);
  }
  __device__ __forceinline__ void take(int32_t score, int c, bool live) {
    const bool in = live && c >= lo && c < hi;
    plast = in && score <= best ? c : plast;
    const bool lt = in && score < best;
    pfirst = lt ? c : pfirst;
    best = lt ? score : best;
    last = live && c == hi - 1 ? score : last;
  }
  __device__ __forceinline__ void tile(int, int) {}
};

// last = score at hi-1 only (the banded NW readout).
struct LastScore {
  int hi;
  int32_t last = kBig;

  __device__ __forceinline__ void update(int32_t score, int c, bool live) {
    if (live && c == hi - 1) last = score;
  }
  __device__ __forceinline__ void finish(int) {}
};

// Bit c%32 of row[c/32] set where c >= lo and score == best.  Words with no
// hit are left as the caller zeroed them.
struct HitMask {
  int lo;
  int32_t best;
  int32_t* row;
  uint32_t mask = 0u;

  __device__ __forceinline__ void update(int32_t score, int c, bool live) {
    if (live && c >= lo && score == best) mask |= 1u << (c & 31);
    if ((c & 31) == 31) {
      if (mask) row[c >> 5] = static_cast<int32_t>(mask);
      mask = 0u;
    }
  }
  __device__ __forceinline__ void finish(int end) {
    if (mask) row[(end - 1) >> 5] = static_cast<int32_t>(mask);
  }
};

// Every column's score: column c of this lane at out[c * stride] (out is
// offset by the lane, stride is the lane count: a (T, lanes) stream).
struct ScoreStream {
  int32_t* out;
  size_t stride;

  __device__ __forceinline__ void update(int32_t score, int c, bool) {
    out[(size_t)c * stride] = score;
  }
  __device__ __forceinline__ void take(int32_t score, int c, bool live) {
    if (live) out[(size_t)c * stride] = score;
  }
  __device__ __forceinline__ void tile(int, int) {}
  __device__ __forceinline__ void finish(int) {}
};

// Eq words of one lane from its query profile: peq row `sym` of (S1, NW).
struct PeqEq {
  const uint32_t* peq;
  const int32_t* tg;
  int nw;
  const uint32_t* row;

  __device__ __forceinline__ void at(int c) { row = peq + (size_t)tg[c] * nw; }
  __device__ __forceinline__ uint32_t word(int w) const { return row[w]; }
};

// Eq words rebuilt from query-id bit planes (pallas_kernel._bitplane_eq):
// row i matches symbol s iff every bit of some alternative id of row i equals
// the bit of s, so Eq = pad | wild | OR_e ~OR_b (plane[e, b] ^ tb[b]).
struct BitplaneEq {
  const uint32_t* planes;  // (n_alts * nb * NW) words of this lane
  const uint32_t* pad;     // (NW) words of rows that match every symbol
  const int32_t* tg;
  int nw, nb, n_alts, wildcard;
  uint32_t tb[kMaxPlanes];
  uint32_t wild;

  __device__ __forceinline__ void at(int c) {
    const int32_t s = tg[c];
#pragma unroll
    for (int b = 0; b < kMaxPlanes; ++b)
      tb[b] = 0u - ((static_cast<uint32_t>(s) >> b) & 1u);
    wild = s == wildcard ? ~0u : 0u;
  }
  __device__ __forceinline__ uint32_t word(int w) const {
    uint32_t acc = pad[w] | wild;
    for (int e = 0; e < n_alts; ++e) {
      const uint32_t* p = planes + (size_t)e * nb * nw + w;
      uint32_t x = p[0] ^ tb[0];
#pragma unroll
      for (int b = 1; b < kMaxPlanes; ++b)
        if (b < nb) x |= p[(size_t)b * nw] ^ tb[b];
      acc |= ~x;
    }
    return acc;
  }
};

// Eq words gathered before the launch: word w of column c of this lane at
// eq[(c * nw + w) * lanes] (eq is offset by the lane: a (T, NW, lanes)
// stream, so a warp's loads of one word are consecutive).
struct StreamEq {
  const uint32_t* eq;
  size_t lanes;
  int nw;
  const uint32_t* row;

  __device__ __forceinline__ void at(int c) {
    row = eq + (size_t)c * nw * lanes;
  }
  __device__ __forceinline__ uint32_t word(int w) const {
    return row[(size_t)w * lanes];
  }
};

// One lane swept by a whole block (the wave form): thread t holds words
// [kWaveWords * t, + kWaveWords) in registers and advances column d - t at
// step d, its top word taking the carry out of thread t-1's bottom word
// from step d-1 through shared memory (double-buffered, one barrier a
// step).  Each thread loads the next column's Eq words before advancing
// this one.  The thread holding the bottom word carries the score and runs
// the visitor.  Every thread of the block must call this.
template <class Eq, class Visit>
__device__ __forceinline__ void sweep_wave(Eq eq, int nw, int end,
                                           uint32_t hin_pos,
                                           const LaneCarry& cr, Visit& v) {
  __shared__ uint32_t carry[2][2][kWaveThreads];  // [buffer][neg, pos][t]
  const int t = threadIdx.x;
  const int last = blockDim.x - 1;
  const int w0 = t * kWaveWords;
  const int n = min(kWaveWords, nw - w0);
  uint32_t pv[kWaveWords], mv[kWaveWords], e[kWaveWords], en[kWaveWords];
#pragma unroll
  for (int i = 0; i < kWaveWords; ++i) {
    pv[i] = i < n ? cr.pv(w0 + i) : ~0u;
    mv[i] = i < n ? cr.mv(w0 + i) : 0u;
  }
  if (end > 0) {
    eq.at(0);
#pragma unroll
    for (int i = 0; i < kWaveWords; ++i)
      if (i < n) e[i] = eq.word(w0 + i);
  }
  int32_t score = cr.score(nw);
  for (int d = 0; d < end + last; ++d) {
    const int c = d - t;
    const int buf = d & 1;
    if (c >= 0 && c < end) {
      const bool more = c + 1 < end;
      if (more) {
        eq.at(c + 1);
#pragma unroll
        for (int i = 0; i < kWaveWords; ++i)
          if (i < n) en[i] = eq.word(w0 + i);
      }
      uint32_t hneg = 0u, hpos = hin_pos;
      if (t > 0) {
        hneg = carry[buf][0][t - 1];
        hpos = carry[buf][1][t - 1];
      }
#pragma unroll
      for (int i = 0; i < kWaveWords; ++i)
        if (i < n) advance_word(pv[i], mv[i], e[i], hneg, hpos);
      carry[buf ^ 1][0][t] = hneg;
      carry[buf ^ 1][1][t] = hpos;
      if (t == last) {
        score += static_cast<int32_t>(hpos) - static_cast<int32_t>(hneg);
        v.update(score, c, true);
      }
      if (more) {
#pragma unroll
        for (int i = 0; i < kWaveWords; ++i) e[i] = en[i];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kWaveWords; ++i)
    if (i < n) cr.keep(w0 + i, pv[i], mv[i]);
  if (t == last) {
    cr.keep_score(score);
    if (end > 0) v.finish(end);
  }
}

// Sweep one lane over columns [0, min(hi, n_cols)) from the carried state
// cr (a fresh start when it has none), keeping the exit state where cr asks
// for it.  NW > 0: the word count, state in registers.  NW == 0: nw words,
// either the wave form (wave: the block is the lane) or one thread with its
// state in scratch (stride apart).
template <int NW, class Eq, class Visit>
__device__ __forceinline__ void sweep_lane(Eq eq, int nw, int n_cols, int hi,
                                           uint32_t hin_pos, uint32_t* spv,
                                           uint32_t* smv, size_t stride,
                                           bool wave, const LaneCarry& cr,
                                           Visit& v) {
  const int end = min(hi, n_cols);
  if constexpr (NW == 0) {
    if (wave) {
      sweep_wave(eq, nw, end, hin_pos, cr, v);
      return;
    }
  }
  int32_t score = cr.score(nw);
  if constexpr (NW > 0) {
    uint32_t pv[NW], mv[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      pv[w] = cr.pv(w);
      mv[w] = cr.mv(w);
    }
    for (int c = 0; c < end; ++c) {
      eq.at(c);
      uint32_t hneg = 0u, hpos = hin_pos;
#pragma unroll
      for (int w = 0; w < NW; ++w) advance_word(pv[w], mv[w], eq.word(w), hneg, hpos);
      score += static_cast<int32_t>(hpos) - static_cast<int32_t>(hneg);
      v.update(score, c, true);
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) cr.keep(w, pv[w], mv[w]);
  } else {
    for (int w = 0; w < nw; ++w) {
      spv[w * stride] = cr.pv(w);
      smv[w * stride] = cr.mv(w);
    }
    for (int c = 0; c < end; ++c) {
      eq.at(c);
      uint32_t hneg = 0u, hpos = hin_pos;
      for (int w = 0; w < nw; ++w) {
        uint32_t pv = spv[w * stride], mv = smv[w * stride];
        advance_word(pv, mv, eq.word(w), hneg, hpos);
        spv[w * stride] = pv;
        smv[w * stride] = mv;
      }
      score += static_cast<int32_t>(hpos) - static_cast<int32_t>(hneg);
      v.update(score, c, true);
    }
    for (int w = 0; w < nw; ++w) cr.keep(w, spv[w * stride], smv[w * stride]);
  }
  cr.keep_score(score);
  if (end > 0) v.finish(end);
}

// The band's sliding word window (see the header): woff (n_chunks,) top word
// per chunk of `chunk` columns, n_win words wide, over a profile of nw words.
struct Band {
  const int32_t* woff;
  int chunk, n_win, nw;
};

// Banded sweep of one lane over columns [0, min(hi, n_cols)), hin = +1 into
// the window's top word.  NWIN > 0: the window width, window state in
// registers (words slide down through them).  NWIN == 0: all nw words' state
// in scratch, the window indexed in place.
template <int NWIN, class Visit>
__device__ __forceinline__ void sweep_banded(PeqEq eq, Band band, int n_cols,
                                             int hi, uint32_t* spv,
                                             uint32_t* smv, size_t stride,
                                             Visit& v) {
  const int end = min(hi, n_cols);
  if (end <= 0) return;
  const int n_win = NWIN > 0 ? NWIN : band.n_win;
  const int bottom = band.nw - n_win;
  int off = band.woff[0];
  int32_t score = (off + n_win) * 32;
  uint32_t pv[NWIN > 0 ? NWIN : 1], mv[NWIN > 0 ? NWIN : 1];
  if constexpr (NWIN > 0) {
#pragma unroll
    for (int w = 0; w < NWIN; ++w) {
      pv[w] = ~0u;
      mv[w] = 0u;
    }
  } else {
    for (int w = 0; w < band.nw; ++w) {
      spv[w * stride] = ~0u;
      smv[w * stride] = 0u;
    }
  }
  for (int c0 = 0; c0 < end; c0 += band.chunk) {
    if (c0 > 0) {
      const int next = band.woff[c0 / band.chunk];
      const int slide = next - off;
      score += slide * 32;
      off = next;
      if constexpr (NWIN > 0) {
        // Words move up one register per slid word; the words entering at
        // the bottom have never been advanced, so they hold the reset.
        for (int s = 0; s < min(slide, NWIN); ++s) {
#pragma unroll
          for (int w = 0; w + 1 < NWIN; ++w) {
            pv[w] = pv[w + 1];
            mv[w] = mv[w + 1];
          }
          pv[NWIN - 1] = ~0u;
          mv[NWIN - 1] = 0u;
        }
      }
    }
    const bool at_bottom = off == bottom;
    const int c1 = min(c0 + band.chunk, end);
    for (int c = c0; c < c1; ++c) {
      eq.at(c);
      uint32_t hneg = 0u, hpos = 1u;
      if constexpr (NWIN > 0) {
#pragma unroll
        for (int w = 0; w < NWIN; ++w)
          advance_word(pv[w], mv[w], eq.word(off + w), hneg, hpos);
      } else {
        for (int w = off; w < off + n_win; ++w) {
          uint32_t p = spv[w * stride], m = smv[w * stride];
          advance_word(p, m, eq.word(w), hneg, hpos);
          spv[w * stride] = p;
          smv[w * stride] = m;
        }
      }
      score += static_cast<int32_t>(hpos) - static_cast<int32_t>(hneg);
      v.update(score, c, at_bottom);
    }
  }
  v.finish(end);
}

struct LaneArgs {
  const int32_t* targets;  // (R_t, n_cols)
  int n_cols;
  const int32_t* lo;
  const int32_t* hi;
  const int32_t* prow;
  const int32_t* trow;
  int n_lanes;
  uint32_t hin_pos;
  int32_t* best;
  int32_t* pfirst;
  int32_t* plast;
  int32_t* last;
  // K1's reduction as packed keys (first_key, last_key), merged over cores.
  unsigned long long* key_first;
  unsigned long long* key_last;
  uint32_t* scratch;       // 2 * nw * n_lanes words for the scratch paths
  int wave;                // per-lane kernels: one lane a block (sweep_wave)
  const int32_t* want;     // hit kernels: the best each lane's mask marks
  int32_t* hits;           // hit kernels: (n_lanes, n_out) words, zeroed
  int n_out;
  // Carried state (resumable kernels): Pv, Mv (n_lanes, nw) and the score
  // (n_lanes,) in and out; null in-pointers start fresh, null out-pointers
  // keep nothing.
  const uint32_t* pv0;
  const uint32_t* mv0;
  const int32_t* s0;
  uint32_t* pv1;
  uint32_t* mv1;
  int32_t* s1;
};

__device__ __forceinline__ LaneCarry lane_carry(const LaneArgs& a, int nw,
                                                int lane) {
  LaneCarry c;
  const size_t at = (size_t)lane * nw;
  if (a.pv0) {
    c.pv0 = a.pv0 + at;
    c.mv0 = a.mv0 + at;
    c.s0 = a.s0 + lane;
  }
  if (a.pv1) {
    c.pv1 = a.pv1 + at;
    c.mv1 = a.mv1 + at;
    c.s1 = a.s1 + lane;
  }
  return c;
}

__device__ __forceinline__ void store(const LaneArgs& a, int lane,
                                      const Reduction& r) {
  a.best[lane] = r.best;
  a.pfirst[lane] = r.pfirst;
  a.plast[lane] = r.plast;
  a.last[lane] = r.last;
}

// K1 and K2 merge their cores' reductions with 64-bit atomics on packed
// keys (scores are >= 0, columns < 2^31): atomicMin over (score << 32 |
// column) gives best and pfirst, atomicMax over ((kBig - score) << 32 |
// column) gives plast.  A lane that saw no column keeps (kBig, -1) in both:
// the wrappers start the keys there and unpack them.
__device__ __forceinline__ unsigned long long first_key(int32_t score, int c) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(score)) << 32) |
         static_cast<uint32_t>(c);
}

__device__ __forceinline__ unsigned long long last_key(int32_t score, int c) {
  return first_key(kBig - score, c);
}

__device__ __forceinline__ void store_keys(const LaneArgs& a, int lane,
                                           const Reduction& r) {
  a.key_first[lane] = first_key(r.best, r.pfirst);
  a.key_last[lane] = last_key(r.best, r.plast);
  a.last[lane] = r.last;
}

__device__ __forceinline__ PeqEq peq_eq(const uint32_t* peq, int s1, int nw,
                                        const LaneArgs& a, int lane) {
  return PeqEq{peq + (size_t)a.prow[lane] * s1 * nw,
               a.targets + (size_t)a.trow[lane] * a.n_cols, nw, nullptr};
}

__device__ __forceinline__ BitplaneEq bitplane_eq(
    const uint32_t* planes, const uint32_t* pad, int nw, int nb, int n_alts,
    int wildcard, const LaneArgs& a, int lane) {
  const int row = a.prow[lane];
  BitplaneEq eq;
  eq.planes = planes + (size_t)row * n_alts * nb * nw;
  eq.pad = pad + (size_t)row * nw;
  eq.tg = a.targets + (size_t)a.trow[lane] * a.n_cols;
  eq.nw = nw;
  eq.nb = nb;
  eq.n_alts = n_alts;
  eq.wildcard = wildcard;
  return eq;
}

__device__ __forceinline__ uint32_t* scratch_pv(const LaneArgs& a, int lane) {
  return a.scratch + lane;
}

__device__ __forceinline__ uint32_t* scratch_mv(const LaneArgs& a, int nw,
                                                int lane) {
  return a.scratch + (size_t)nw * a.n_lanes + lane;
}

// This thread's lane, and whether it writes the lane's results: in the
// wave form the block is the lane and its last thread holds the results.
__device__ __forceinline__ int lane_index(const LaneArgs& a) {
  return a.wave ? blockIdx.x : blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ bool lane_owner(const LaneArgs& a) {
  return !a.wave || threadIdx.x == blockDim.x - 1;
}

// K1 past 8 words: a thread a lane (state in scratch) or the wave form.
template <int NW>
__global__ void __launch_bounds__(kWaveThreads)
reduce_lanes_kernel(const uint32_t* __restrict__ peq, int s1, int nw, LaneArgs a) {
  static_assert(NW == 0, "1-8 words take reduce_split_kernel");
  const int lane = lane_index(a);
  if (lane >= a.n_lanes) return;
  Reduction r{a.lo[lane], a.hi[lane]};
  sweep_lane<NW>(peq_eq(peq, s1, nw, a, lane), nw, a.n_cols, r.hi, a.hin_pos,
                 scratch_pv(a, lane), scratch_mv(a, nw, lane),
                 (size_t)a.n_lanes, a.wave, lane_carry(a, nw, lane), r);
  if (lane_owner(a)) store_keys(a, lane, r);
}

// K3 past 8 words: a thread a lane (state in scratch) or the wave form.
template <int NW>
__global__ void __launch_bounds__(kWaveThreads)
reduce_bitplane_kernel(const uint32_t* __restrict__ planes,
                       const uint32_t* __restrict__ pad, int nw, int nb,
                       int n_alts, int wildcard, LaneArgs a) {
  static_assert(NW == 0, "1-8 words take reduce_bitplane_split_kernel");
  const int lane = lane_index(a);
  if (lane >= a.n_lanes) return;
  Reduction r{a.lo[lane], a.hi[lane]};
  sweep_lane<NW>(bitplane_eq(planes, pad, nw, nb, n_alts, wildcard, a, lane),
                 nw, a.n_cols, r.hi, a.hin_pos, scratch_pv(a, lane),
                 scratch_mv(a, nw, lane), (size_t)a.n_lanes, a.wave, lane_carry(a, nw, lane), r);
  if (lane_owner(a)) store_keys(a, lane, r);
}

// #5 one thread a lane (hin0 = 1, lanes shorter than a core; past 8 words
// with its state in scratch, or the wave form); 1-8 words at hin0 = 0 take
// hits_lanes_split_kernel.
template <int NW>
__global__ void __launch_bounds__(NW == 0 ? kWaveThreads : kThreads)
hits_lanes_kernel(const uint32_t* __restrict__ peq, int s1, int nw, LaneArgs a) {
  const int lane = lane_index(a);
  if (lane >= a.n_lanes) return;
  HitMask h{a.lo[lane], a.want[lane], a.hits + (size_t)lane * a.n_out};
  sweep_lane<NW>(peq_eq(peq, s1, nw, a, lane), nw, a.n_cols, a.hi[lane],
                 a.hin_pos, scratch_pv(a, lane), scratch_mv(a, nw, lane),
                 (size_t)a.n_lanes, a.wave, lane_carry(a, nw, lane), h);
}

// #13 past 8 words: a thread a lane (state in scratch) or the wave form;
// 1-8 words take hits_bitplane_split_kernel.
template <int NW>
__global__ void __launch_bounds__(kWaveThreads)
hits_bitplane_kernel(const uint32_t* __restrict__ planes,
                     const uint32_t* __restrict__ pad, int nw, int nb,
                     int n_alts, int wildcard, LaneArgs a) {
  static_assert(NW == 0, "1-8 words take hits_bitplane_split_kernel");
  const int lane = lane_index(a);
  if (lane >= a.n_lanes) return;
  HitMask h{a.lo[lane], a.want[lane], a.hits + (size_t)lane * a.n_out};
  sweep_lane<NW>(bitplane_eq(planes, pad, nw, nb, n_alts, wildcard, a, lane),
                 nw, a.n_cols, a.hi[lane], a.hin_pos, scratch_pv(a, lane),
                 scratch_mv(a, nw, lane), (size_t)a.n_lanes, a.wave, lane_carry(a, nw, lane), h);
}

// Every column of every lane; out (n_cols, n_lanes).  A thread a lane: at
// 1 word, and at 9 to kWaveMinWords - 1 words with its state in scratch
// (2-8 words take words_kernel, longer lanes sweep_scores_groups_kernel).
template <int NW>
__global__ void __launch_bounds__(kThreads)
sweep_scores_kernel(const uint32_t* __restrict__ peq, int s1, int nw,
                    LaneArgs a, int32_t* out) {
  const int lane = lane_index(a);
  if (lane >= a.n_lanes) return;
  ScoreStream s{out + lane, (size_t)a.n_lanes};
  sweep_lane<NW>(peq_eq(peq, s1, nw, a, lane), nw, a.n_cols, a.n_cols,
                 a.hin_pos, scratch_pv(a, lane), scratch_mv(a, nw, lane),
                 (size_t)a.n_lanes, a.wave, lane_carry(a, nw, lane), s);
}

// The resumable reduce past 8 words: every column of the lane's target row
// from the carried state, the reduction over [lo, hi) of those columns (1-8
// words take reduce_resume_split_kernel).
template <int NW>
__global__ void __launch_bounds__(kWaveThreads)
reduce_resume_kernel(const uint32_t* __restrict__ peq, int s1, int nw,
                     LaneArgs a) {
  static_assert(NW == 0, "1-8 words take reduce_resume_split_kernel");
  const int lane = lane_index(a);
  if (lane >= a.n_lanes) return;
  WindowReduction r;
  r.lo = a.lo[lane];
  r.hi = a.hi[lane];
  sweep_lane<NW>(peq_eq(peq, s1, nw, a, lane), nw, a.n_cols, a.n_cols,
                 a.hin_pos, scratch_pv(a, lane), scratch_mv(a, nw, lane),
                 (size_t)a.n_lanes, a.wave, lane_carry(a, nw, lane), r);
  if (lane_owner(a)) store(a, lane, r);
}

__device__ __forceinline__ StreamEq stream_eq(const uint32_t* eq, int nw,
                                              const LaneArgs& a, int lane) {
  return StreamEq{eq + lane, (size_t)a.n_lanes, nw, nullptr};
}

// #10 one thread a lane at 1 word, past 8 (scratch, or the wave form) and
// on an empty stream; 2-8 words take reduce_eqstream_words_kernel.
template <int NW>
__global__ void __launch_bounds__(NW == 0 ? kWaveThreads : kThreads)
reduce_eqstream_kernel(const uint32_t* __restrict__ eq, int nw, LaneArgs a) {
  const int lane = lane_index(a);
  if (lane >= a.n_lanes) return;
  Reduction r{a.lo[lane], a.hi[lane]};
  sweep_lane<NW>(stream_eq(eq, nw, a, lane), nw, a.n_cols, r.hi, a.hin_pos,
                 scratch_pv(a, lane), scratch_mv(a, nw, lane),
                 (size_t)a.n_lanes, a.wave, lane_carry(a, nw, lane), r);
  if (lane_owner(a)) store(a, lane, r);
}

// #11 one thread a lane at 1 word and past 8 (scratch, or the wave form);
// 2-8 words take hits_eqstream_words_kernel.
template <int NW>
__global__ void __launch_bounds__(NW == 0 ? kWaveThreads : kThreads)
hits_eqstream_kernel(const uint32_t* __restrict__ eq, int nw, LaneArgs a) {
  const int lane = lane_index(a);
  if (lane >= a.n_lanes) return;
  HitMask h{a.lo[lane], a.want[lane], a.hits + (size_t)lane * a.n_out};
  sweep_lane<NW>(stream_eq(eq, nw, a, lane), nw, a.n_cols, a.hi[lane],
                 a.hin_pos, scratch_pv(a, lane), scratch_mv(a, nw, lane),
                 (size_t)a.n_lanes, a.wave, lane_carry(a, nw, lane), h);
}

template <int NWIN>
__global__ void __launch_bounds__(kThreads)
nw_banded_kernel(const uint32_t* __restrict__ peq, int s1, Band band,
                 LaneArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  LastScore r{a.hi[lane]};
  sweep_banded<NWIN>(peq_eq(peq, s1, band.nw, a, lane), band, a.n_cols, r.hi,
                     scratch_pv(a, lane), scratch_mv(a, band.nw, lane),
                     (size_t)a.n_lanes, r);
  a.last[lane] = r.last;
}

// #7 one thread a lane where band_width gives no segment; else
// shw_banded_words_kernel.
template <int NWIN>
__global__ void __launch_bounds__(kThreads)
shw_banded_kernel(const uint32_t* __restrict__ peq, int s1, Band band,
                  LaneArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  Reduction r{a.lo[lane], a.hi[lane]};
  sweep_banded<NWIN>(peq_eq(peq, s1, band.nw, a, lane), band, a.n_cols, r.hi,
                     scratch_pv(a, lane), scratch_mv(a, band.nw, lane),
                     (size_t)a.n_lanes, r);
  a.best[lane] = r.best;
  a.pfirst[lane] = r.pfirst;
  a.plast[lane] = r.plast;
}

template <int NWIN>
__global__ void __launch_bounds__(kThreads)
shw_banded_hits_kernel(const uint32_t* __restrict__ peq, int s1, Band band,
                       LaneArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  HitMask h{a.lo[lane], a.want[lane], a.hits + (size_t)lane * a.n_out};
  sweep_banded<NWIN>(peq_eq(peq, s1, band.nw, a, lane), band, a.n_cols,
                     a.hi[lane], scratch_pv(a, lane),
                     scratch_mv(a, band.nw, lane), (size_t)a.n_lanes, h);
}

// ---------------------------------------------------------------------------
// The split-lane schedule of K1 (myers_reduce_lanes), K3
// (myers_reduce_bitplane), K2 (myers_sweep_shared), #5 (myers_hits_lanes)
// and #13 (myers_hits_bitplane) at 1-8 words.
//
// In HW mode (hin = 0) every cell of row i is at most i, so every bottom-row
// score is at most R = 32 * nw, and an alignment of cost d that ends at
// column c spans at most R + d <= 2R columns.  A sweep from the fresh state
// (Pv = ~0, Mv = 0, score = R) at column max(0, s - 2R) therefore gives the
// exact score at every column c >= s; edlib_tpu/ops/segmented.py makes the
// same argument across lanes.  So the wrapper (cuda_kernel.split_core) cuts
// a lane's scanned columns [s, end) into cores of `core` columns, and each
// (lane, core) pair is one thread: it sweeps from the fresh state at
// max(0, core start - halo), halo = 2R, and reduces over its core only.
// The cores merge with atomics on packed keys (first_key, last_key); the
// core that holds hi - 1 writes last.  A lane with hin = 1 (NW and SHW: the
// score at a column depends on column 0) is one core swept from column 0.
// s = max(0, min(lo, end - 1)) and end = min(hi, n_cols), so a lane whose
// window is empty but whose hi - 1 is a column still sweeps to hi - 1.
//
// Threads run core-fastest: with many cores a lane, a warp is 32 cores of
// one lane, and a few long lanes fill the card.  A thread streams its target
// columns through its own ring of two kStage-column stages in shared memory
// with cp.async (one stage in flight while the other is swept), reads Eq
// from its block's profile rows in shared memory (K1: the block's distinct
// prow rows; K2: its lanes' slice of the (S1, NW, B) profile; global memory
// when they do not fit; K3: the distinct rows' bit planes, expanded once
// into full 2^nb-symbol profiles where those fit, else Eq built from the
// staged planes per column), and loads the next column's Eq words before
// the current column advances.
constexpr int kSplitMaxThreads = 128;
constexpr int kStage = 16;                // columns a cp.async stage brings
constexpr int kRingWords = 2 * kStage;    // a thread's ring: two stages
constexpr int kPeqSmemWords = 6144;       // profile words a block may hold
constexpr int kBitplaneSmemWords = 9216;  // K3: profiles and planes, the
                                          // same (4 blocks of 128 an SM)

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// One 4-byte element (cp.async.ca takes 4, 8 or 16 bytes; .cg only 16).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// This thread's symbols of `count` consecutive columns of one target row,
// from `first` (the wrapper keeps the operand 16-byte aligned, so the chunk
// holding `first` starts inside it) up to `limit` (the row's end; bytes past
// it are zero-filled, never read).  Chunk k (4 symbols) of the stream lands
// in ring chunk (k % 8) ^ (t & 7), so a quarter warp's 16-byte reads of one
// chunk hit 32 distinct banks.
struct SymStream {
  uint32_t* ring;
  const char* base;   // the 16-byte chunk holding `first`
  const char* limit;
  int skip, n, swz;   // symbols before `first` in chunk 0; skip + count

  __device__ __forceinline__ SymStream(uint32_t* rings, const int32_t* first,
                                       const int32_t* end, int count) {
    ring = rings + threadIdx.x * kRingWords;
    swz = threadIdx.x & 7;
    const uintptr_t at = reinterpret_cast<uintptr_t>(first);
    base = reinterpret_cast<const char*>(at & ~uintptr_t(15));
    skip = static_cast<int>((at & 15) >> 2);
    n = skip + count;
    limit = reinterpret_cast<const char*>(end);
  }
  __device__ __forceinline__ uint32_t* slot(int s, int q) const {
    return ring + 4 * ((((s & 1) << 2) | q) ^ swz);
  }
  // Stage s (4 chunks) into its half of the ring, as one commit group.
  __device__ __forceinline__ void issue(int s) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * s + q;
      if (4 * k < n) {
        const char* src = base + 16 * (size_t)k;
        const long long left = limit - src;
        cp_async16(slot(s, q), src, left >= 16 ? 16 : static_cast<int>(left));
      }
    }
    cp_async_commit();
  }
};

// Eq word w of symbol sym at base[(sym & sym_mask) * sym_stride + w *
// w_stride] (K3's expanded profile keeps 2^nb rows and masks the symbol).
struct EqRows {
  const uint32_t* base;
  int sym_stride, w_stride;
  int32_t sym_mask = -1;

  template <int NW>
  __device__ __forceinline__ void load(uint32_t (&e)[NW], int32_t sym) const {
    const uint32_t* r = base + (size_t)(sym & sym_mask) * sym_stride;
#pragma unroll
    for (int w = 0; w < NW; ++w) e[w] = r[(size_t)w * w_stride];
  }
  // One word, a row's offsets in 32 bits (profile rows are far smaller).
  __device__ __forceinline__ uint32_t word(int32_t sym, int w) const {
    return base[(sym & sym_mask) * sym_stride + w * w_stride];
  }
};

// K3's Eq built per column from one profile row's bit planes (the
// arithmetic of BitplaneEq): planes[(e * nb + b) * NW + w] and pad[w], in
// shared memory; the path of rows whose expanded profiles do not fit (a
// block of lanes that each have a row of their own).
struct PlaneRows {
  const uint32_t* planes;
  const uint32_t* pad;
  int nb, n_alts, wildcard;

  template <int NW>
  __device__ __forceinline__ void load(uint32_t (&e)[NW], int32_t sym) const {
    uint32_t tb[kMaxPlanes];
#pragma unroll
    for (int b = 0; b < kMaxPlanes; ++b)
      tb[b] = 0u - ((static_cast<uint32_t>(sym) >> b) & 1u);
    const uint32_t wild = sym == wildcard ? ~0u : 0u;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint32_t acc = pad[w] | wild;
#pragma unroll 1
      for (int k = 0; k < n_alts; ++k) {
        const uint32_t* p = planes + k * nb * NW + w;
        uint32_t x = p[0] ^ tb[0];
#pragma unroll
        for (int b = 1; b < kMaxPlanes; ++b)
          if (b < nb) x |= p[b * NW] ^ tb[b];
        acc |= ~x;
      }
      e[w] = acc;
    }
  }
};

// Sweep the stream's columns (the first is column c0) from the state (pv,
// mv, score), calling v.update(score, c, true) for each; the state after
// the last column is left in (pv, mv, score).
template <int NW, class Eq, class Visit>
__device__ __forceinline__ void sweep_core(const SymStream& st, const Eq& eq,
                                           uint32_t hin_pos, int c0,
                                           uint32_t (&pv)[NW],
                                           uint32_t (&mv)[NW], int32_t& score,
                                           Visit& v) {
  st.issue(0);
  st.issue(1);
  for (int s = 0; s * kStage < st.n; ++s) {
    cp_async_wait<1>();
    int32_t sym[kStage];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 x = *reinterpret_cast<const int4*>(st.slot(s, q));
      sym[4 * q] = x.x;
      sym[4 * q + 1] = x.y;
      sym[4 * q + 2] = x.z;
      sym[4 * q + 3] = x.w;
    }
    const int i0 = s * kStage;
    uint32_t e[NW];
    if (i0 >= st.skip && i0 < st.n) eq.template load<NW>(e, sym[0]);
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = i0 + j;
      uint32_t en[NW];
      if (j + 1 < kStage && i + 1 >= st.skip && i + 1 < st.n)
        eq.template load<NW>(en, sym[j + 1]);
      if (i >= st.skip && i < st.n) {
        uint32_t hneg = 0u, hpos = hin_pos;
#pragma unroll
        for (int w = 0; w < NW; ++w) advance_word(pv[w], mv[w], e[w], hneg, hpos);
        score += static_cast<int32_t>(hpos) - static_cast<int32_t>(hneg);
        v.update(score, c0 + i - st.skip, true);
      }
      if (j + 1 < kStage) {
#pragma unroll
        for (int w = 0; w < NW; ++w) e[w] = en[w];
      }
    }
    // Every symbol of stage s is used above, so its slots are free again.
    st.issue(s + 2);
  }
  cp_async_wait<0>();
}

// The same sweep from the fresh state.
template <int NW, class Eq, class Visit>
__device__ __forceinline__ void sweep_core(const SymStream& st, const Eq& eq,
                                           uint32_t hin_pos, int c0,
                                           Visit& v) {
  uint32_t pv[NW], mv[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    pv[w] = ~0u;
    mv[w] = 0u;
  }
  int32_t score = NW * 32;
  sweep_core<NW>(st, eq, hin_pos, c0, pv, mv, score, v);
}

// One core of a lane: columns [c_lo, c_hi) of its scanned span [s, end),
// and the column its sweep starts from.  word_aligned (the hit words' plan):
// the span starts at s rounded down to a multiple of 32.
struct Core {
  int c_lo, c_hi, start;

  __device__ __forceinline__ Core(int lo, int hi, int n_cols, int k, int core,
                                  int halo, uint32_t hin_pos,
                                  bool word_aligned = false) {
    const int end = min(hi, n_cols);
    const int s = max(0, min(lo, end - 1)) & (word_aligned ? ~31 : ~0);
    c_lo = s + k * core;
    c_hi = static_cast<int>(min((long long)c_lo + core, (long long)end));
    start = hin_pos ? 0 : max(0, c_lo - halo);
  }
};

// The largest lane l < n with off[l] <= t (off nondecreasing from 0): the
// lane that owns thread t, lanes without cores skipped.
__device__ __forceinline__ int lane_of(const int32_t* off, int n, int t) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= t) lo = mid;
    else hi = mid;
  }
  return lo;
}

// Inclusive sum of x over the block's threads (every thread must call it).
__device__ __forceinline__ int block_inclusive_sum(int x, int* warp_sums) {
  const int l = threadIdx.x & 31, wp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(~0u, x, d);
    if (l >= d) x += y;
  }
  if (l == 31) warp_sums[wp] = x;
  __syncthreads();
  for (int i = 0; i < wp; ++i) x += warp_sums[i];
  return x;
}

struct SplitArgs {
  const int32_t* offsets;  // (n_lanes + 1,): a lane's first thread; total
                           // (K1; null: n_cores cores a lane, or one core a
                           // lane, thread t lane t, where n_cores is 0)
  int core, halo;
  int peq_words;           // profile words the block's shared memory holds
  int n_cores;             // the resumable reduce: cores a lane, every lane
};

// A split-lane thread's place: its lane and core, and the block's distinct
// profile rows (slot_row[0, n_slots); slot is this thread's).  Thread t is
// core t - offsets[lane] of its lane, or lane t where offsets is null.
struct SplitPlace {
  bool active;
  int lane, core, row, slot, n_slots;
};

// False where the whole block lies past the last thread (it returns before
// any barrier).  Every thread of the block calls it.
__device__ __forceinline__ bool split_place(const LaneArgs& a,
                                            const SplitArgs& sp,
                                            SplitPlace& p, int* slot_row) {
  __shared__ int row_of[kSplitMaxThreads];
  __shared__ int warp_sums[kSplitMaxThreads / 32], n_slots;
  const int T = blockDim.x;
  const long long total = sp.offsets  ? sp.offsets[a.n_lanes]
                          : sp.n_cores ? (long long)a.n_lanes * sp.n_cores
                                       : a.n_lanes;
  const long long t0 = (long long)blockIdx.x * T;
  if (t0 >= total) return false;
  const long long tl = t0 + threadIdx.x;
  const int t = static_cast<int>(tl);
  p.active = tl < total;
  p.lane = -1;
  p.core = 0;
  if (p.active && sp.offsets) {
    p.lane = lane_of(sp.offsets, a.n_lanes, t);
    p.core = t - sp.offsets[p.lane];
  } else if (p.active && sp.n_cores) {  // thread t: core t % n_cores
    p.lane = static_cast<int>(tl / sp.n_cores);
    p.core = static_cast<int>(tl % sp.n_cores);
  } else if (p.active) {  // one core a lane: thread t is lane t
    p.lane = t;
    p.active = min(a.hi[p.lane], a.n_cols) > 0;
  }
  // A new slot where a thread's prow differs from the previous thread's
  // (threads run in lane order).
  p.row = p.active ? a.prow[p.lane] : -1;
  row_of[threadIdx.x] = p.row;
  __syncthreads();
  const int fresh =
      p.active && (threadIdx.x == 0 || p.row != row_of[threadIdx.x - 1]);
  p.slot = block_inclusive_sum(fresh, warp_sums) - 1;
  if (fresh) slot_row[p.slot] = p.row;
  if (threadIdx.x == T - 1) n_slots = p.slot + 1;
  __syncthreads();
  p.n_slots = n_slots;
  return true;
}

// The block's distinct profile rows of s1 * NW words, staged after the
// threads' rings of ring_words words in shared memory where they fit
// sp.peq_words (every thread of the block calls it); the Eq rows of this
// thread's profile row, there or in global memory.  An inactive thread's
// rows are not to be read.
__device__ __forceinline__ EqRows stage_rows(const uint32_t* peq, int s1,
                                             int nw, const SplitArgs& sp,
                                             const SplitPlace& p,
                                             const int* slot_row,
                                             uint32_t* dyn, int ring_words) {
  const int T = blockDim.x;
  const int rw = s1 * nw;
  uint32_t* rows = dyn + T * ring_words;
  const bool in_smem = p.n_slots * rw <= sp.peq_words;
  if (in_smem)
    for (int i = threadIdx.x; i < p.n_slots * rw; i += T)
      rows[i] = peq[(size_t)slot_row[i / rw] * rw + i % rw];
  __syncthreads();
  return EqRows{in_smem ? rows + p.slot * rw
                        : peq + (size_t)max(p.row, 0) * rw,
                nw, 1};
}

template <int NW>
__device__ __forceinline__ EqRows stage_rows(const uint32_t* peq, int s1,
                                             const SplitArgs& sp,
                                             const SplitPlace& p,
                                             const int* slot_row,
                                             uint32_t* dyn,
                                             int ring_words = kRingWords) {
  return stage_rows(peq, s1, NW, sp, p, slot_row, dyn, ring_words);
}

// Sweep one core from the fresh state at its start and merge its
// reduction into its lane's keys; the core holding hi - 1 writes last.
template <int NW, class Eq>
__device__ __forceinline__ void split_sweep(const LaneArgs& a,
                                            const SplitArgs& sp,
                                            const SplitPlace& p,
                                            uint32_t* rings, const Eq& eq) {
  const int lo = a.lo[p.lane], hi = a.hi[p.lane];
  const Core k(lo, hi, a.n_cols, p.core, sp.core, sp.halo, a.hin_pos);
  const int32_t* tg = a.targets + (size_t)a.trow[p.lane] * a.n_cols;
  const SymStream st(rings, tg + k.start, tg + a.n_cols, k.c_hi - k.start);
  Reduction r{max(lo, k.c_lo), hi};
  sweep_core<NW>(st, eq, a.hin_pos, k.start, r);
  if (r.pfirst >= 0) {
    atomicMin(a.key_first + p.lane, first_key(r.best, r.pfirst));
    atomicMax(a.key_last + p.lane, last_key(r.best, r.plast));
  }
  if (hi - 1 >= k.c_lo && hi - 1 < k.c_hi) a.last[p.lane] = r.last;
}

// Sweep one core of the hit words' plan (word-aligned, below) from the
// fresh state at its start, marking hits only in its own core.
template <int NW, class Eq>
__device__ __forceinline__ void split_hits(const LaneArgs& a,
                                           const SplitArgs& sp,
                                           const SplitPlace& p,
                                           uint32_t* rings, const Eq& eq) {
  const int lo = a.lo[p.lane];
  const Core k(lo, a.hi[p.lane], a.n_cols, p.core, sp.core, sp.halo,
               a.hin_pos, true);
  const int32_t* tg = a.targets + (size_t)a.trow[p.lane] * a.n_cols;
  const SymStream st(rings, tg + k.start, tg + a.n_cols, k.c_hi - k.start);
  HitMask h{max(lo, k.c_lo), a.want[p.lane],
            a.hits + (size_t)p.lane * a.n_out};
  sweep_core<NW>(st, eq, a.hin_pos, k.start, h);
  h.finish(k.c_hi);
}

// K1, split-lane.
template <int NW>
__global__ void __launch_bounds__(kSplitMaxThreads, 4)
reduce_split_kernel(const uint32_t* __restrict__ peq, int s1, LaneArgs a,
                    SplitArgs sp) {
  extern __shared__ __align__(16) uint32_t dyn[];  // rings, profile rows
  __shared__ int slot_row[kSplitMaxThreads];
  SplitPlace p;
  if (!split_place(a, sp, p, slot_row)) return;
  const EqRows eq = stage_rows<NW>(peq, s1, sp, p, slot_row, dyn);
  if (!p.active) return;
  split_sweep<NW>(a, sp, p, dyn, eq);
}

// #5 (myers_hits_lanes) at 1-8 words and hin0 = 0, split-lane: each
// (lane, core) thread sweeps as K1's does and marks hits only in its own
// core.  The cores own whole hit words: the plan (ops/cuda_kernel.py
// hits_core, split_cores with word_aligned) counts a lane's cores from s
// rounded down to a multiple of 32, and the core length is a multiple of
// 32, so every hit word lies in exactly one core and has one writer;
// plain stores suffice (no atomicOr).  Its sweep starts at a multiple of
// 32 too (c_lo - halo, halo = 64 * NW, or 0), and the halo's columns lie
// before c_lo, so they mark nothing.  (split_hits; #13 runs the same on
// K3's staged rows, hits_bitplane_split_kernel.)
template <int NW>
__global__ void __launch_bounds__(kSplitMaxThreads, 4)
hits_lanes_split_kernel(const uint32_t* __restrict__ peq, int s1, LaneArgs a,
                        SplitArgs sp) {
  extern __shared__ __align__(16) uint32_t dyn[];  // rings, profile rows
  __shared__ int slot_row[kSplitMaxThreads];
  SplitPlace p;
  if (!split_place(a, sp, p, slot_row)) return;
  const EqRows eq = stage_rows<NW>(peq, s1, sp, p, slot_row, dyn);
  if (!p.active) return;
  split_hits<NW>(a, sp, p, dyn, eq);
}

// The resumable reduce, split-lane (1-8 words): every lane's n_cols columns
// in sp.n_cores cores of sp.core columns from column 0, thread t core
// t % n_cores of lane t / n_cores.  A core whose sweep starts at column 0
// (c_lo - halo <= 0, or hin = 1: one core a lane) starts from the lane's
// carried state; the others from the fresh state a halo before the core,
// exact in HW by the argument above, since the carried columns before the
// segment lie further back still (the carry must be an HW sweep's state,
// its rows >= 0).  Each core reduces [lo, hi) over its core and merges it
// as packed keys (scores >= 0); with one core a lane (n_cores = 1) it
// writes best, pfirst and plast itself, whatever the carry.  The core
// holding hi - 1 writes last, the one holding column n_cols - 1 the exit
// state.
template <int NW>
__global__ void __launch_bounds__(kSplitMaxThreads, 4)
reduce_resume_split_kernel(const uint32_t* __restrict__ peq, int s1,
                           LaneArgs a, SplitArgs sp) {
  extern __shared__ __align__(16) uint32_t dyn[];  // rings, profile rows
  __shared__ int slot_row[kSplitMaxThreads];
  SplitPlace p;
  if (!split_place(a, sp, p, slot_row)) return;
  const EqRows eq = stage_rows<NW>(peq, s1, sp, p, slot_row, dyn);
  if (!p.active) return;
  const int lane = p.lane;
  const int c_lo = static_cast<int>((long long)p.core * sp.core);
  const int c_hi =
      static_cast<int>(min((long long)c_lo + sp.core, (long long)a.n_cols));
  const int start = a.hin_pos ? 0 : max(0, c_lo - sp.halo);
  const bool carried = start == 0;
  const LaneCarry cr = lane_carry(a, NW, lane);
  uint32_t pv[NW], mv[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    pv[w] = carried ? cr.pv(w) : ~0u;
    mv[w] = carried ? cr.mv(w) : 0u;
  }
  int32_t score = carried ? cr.score(NW) : NW * 32;
  const int32_t* tg = a.targets + (size_t)a.trow[lane] * a.n_cols;
  const SymStream st(dyn, tg + start, tg + a.n_cols, c_hi - start);
  const int lo = a.lo[lane], hi = a.hi[lane];
  WindowReduction r;
  r.lo = max(lo, c_lo);
  r.hi = hi;
  sweep_core<NW>(st, eq, a.hin_pos, start, pv, mv, score, r);
  if (sp.n_cores == 1) {
    store(a, lane, r);
  } else {
    if (r.pfirst >= 0) {
      atomicMin(a.key_first + lane, first_key(r.best, r.pfirst));
      atomicMax(a.key_last + lane, last_key(r.best, r.plast));
    }
    if (hi - 1 >= c_lo && hi - 1 < c_hi) a.last[lane] = r.last;
  }
  if (c_hi == a.n_cols) {
#pragma unroll
    for (int w = 0; w < NW; ++w) cr.keep(w, pv[w], mv[w]);
    cr.keep_score(score);
  }
}

// ---------------------------------------------------------------------------
// The word-parallel lane (ops/cuda_kernel.py word_lanes_plain is the same
// schedule in PyTorch; hits_words_plain for the hit words): the resumable
// reduce where its plan is one core a lane (hin0 = 1, or a segment shorter
// than a core), the score stream and the eq-stream hit words, at 2-8
// words.  NW and SHW are prefix-anchored, so no halo split exists, and the
// eq-stream lanes are shorter than a core; the only parallelism left
// inside a lane runs across its words.
//
// A lane's NW words go to a segment of word_threads<NW>() (2, 4 or 8)
// threads of one warp, word w in thread w (threads past NW run on clamped
// words and write nothing), so a warp holds 32 / width lanes.  Thread w
// advances the kWordTile columns [kWordTile (s - w), + kWordTile) at step
// s; the tile's horizontal carries out of word w, two kWordTile-bit masks
// (hneg above hpos), reach thread w + 1 at step s + 1 in one
// __shfl_up_sync inside the segment.  A column of one step's tile then
// depends on the step's shuffle only through its carry bit, and on the
// column before it through the word's Pv and Mv: one shuffle is paid a
// tile, and the chain a column is the word update's Pv recurrence.  (A
// tile of one column, the carry and the next symbol packed in one
// shuffle, ran slower on the card: the shuffle and the bit handling sat
// on every column's chain.)  Each thread reads its own
// tile's symbols a step ahead and its Eq words from the block's staged
// profile rows at the step's start.  Steps where every thread's tile lies
// inside the row run the bare updates; the first and last steps predicate
// each column.  After each step the bottom word's two masks go to every
// thread of the segment (two more shuffles, off the chain), and each thread
// scores and visits every width-th column of the tile from them (popcounts
// of the masks' prefixes), branch-free (take): a warp instruction of that
// work serves width columns.  Every thread carries the bottom word's score;
// the reduce merges its threads' partial reductions at the end
// (merge_words).  Each thread starts from its word of the carry and the
// carried score and keeps its word of the exit state; any carry stays
// exact.  Every lane of a launch sweeps all n_cols columns, so the warp's
// steps are uniform; the threads past the last lane run the last lane's
// sweep and write nothing.

constexpr int kWordTile = 16;  // columns a thread advances a step

__host__ __device__ constexpr int word_width(int nw) {
  return nw <= 2 ? 2 : nw <= 4 ? 4 : 8;
}

template <int NW>
__host__ __device__ constexpr int word_threads() {
  return word_width(NW);
}

// Where a word-parallel lane's Eq words come from: load(c) reads column c's
// value for the thread's word (clamped into the row; a tile's loads are
// issued a step ahead, off the chain), word(x) turns it into the Eq word.
// The lane's target row with the block's staged profile rows (the
// resumable reduce, the score stream): the symbol, then its row's word.
struct RowSource {
  const int32_t* tg;
  int last;  // the row's last column
  EqRows eq;
  int w;     // the word (clamped to NW - 1)

  __device__ __forceinline__ uint32_t load(int c) const {
    return static_cast<uint32_t>(__ldg(tg + min(max(c, 0), last)));
  }
  __device__ __forceinline__ uint32_t word(uint32_t x) const {
    return eq.word(static_cast<int32_t>(x), w);
  }
};

// The gathered Eq stream (T, NW, lanes) (myers_hits_eqstream): word w of
// column c of the lane at eq[c * stride], eq offset by the word and lane,
// stride = NW * lanes; the loaded word is the Eq word.
struct StreamSource {
  const uint32_t* eq;
  size_t stride;
  int last;

  __device__ __forceinline__ uint32_t load(int c) const {
    return __ldg(eq + (size_t)min(max(c, 0), last) * stride);
  }
  __device__ __forceinline__ uint32_t word(uint32_t x) const { return x; }
};

// Thread w of a lane's segment sweeps word w over every column of its row
// (n_cols >= 1, Eq from src) from (pv, mv), left there after the last
// column, and carries the bottom word's score from `score`; with emit it
// calls v.take(score, c, true) for the columns c = w mod width of the row
// (and takes with false where it has no such column), and after each step
// v.tile(cb, n_cols) with the bottom word's tile [cb, cb + kWordTile) (cb
// is the same in every thread of the warp).  Every thread of the warp calls
// it.
template <int NW, class Src, class Visit>
__device__ __forceinline__ void sweep_words(const Src& src, int n_cols,
                                            uint32_t hin_pos, int w,
                                            bool emit, uint32_t& pv,
                                            uint32_t& mv, int32_t& score,
                                            Visit& v) {
  constexpr int kWidth = word_threads<NW>();
  constexpr uint32_t kMask = (1u << kWordTile) - 1u;
  const bool top = w == 0;
  const int n_steps = (n_cols + kWordTile - 1) / kWordTile + NW - 1;
  uint32_t out = 0u;  // the last step's masks: hneg << kWordTile | hpos
  uint32_t x[kWordTile];
#pragma unroll
  for (int k = 0; k < kWordTile; ++k) x[k] = src.load(k - kWordTile * w);
  for (int s = 0; s < n_steps; ++s) {
    const int c0 = kWordTile * (s - w);
    uint32_t e[kWordTile];
#pragma unroll
    for (int k = 0; k < kWordTile; ++k) e[k] = src.word(x[k]);
#pragma unroll
    for (int k = 0; k < kWordTile; ++k) x[k] = src.load(c0 + kWordTile + k);
    const uint32_t y = __shfl_up_sync(kFull, out, 1, kWidth);
    const uint32_t hp_in = top ? (hin_pos ? kMask : 0u) : y & kMask;
    const uint32_t hn_in = top ? 0u : y >> kWordTile;
    const bool whole =
        __all_sync(kFull, c0 >= 0 && c0 + kWordTile <= n_cols);
    uint32_t o_p = 0u, o_n = 0u;
    if (whole) {
#pragma unroll
      for (int k = 0; k < kWordTile; ++k) {
        uint32_t hneg = (hn_in >> k) & 1u, hpos = (hp_in >> k) & 1u;
        advance_word(pv, mv, e[k], hneg, hpos);
        o_p |= hpos << k;
        o_n |= hneg << k;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kWordTile; ++k) {
        const int c = c0 + k;
        const bool act = c >= 0 && c < n_cols;
        uint32_t hneg = (hn_in >> k) & 1u, hpos = (hp_in >> k) & 1u;
        uint32_t p = pv, m = mv;
        advance_word(p, m, e[k], hneg, hpos);
        pv = act ? p : pv;
        mv = act ? m : mv;
        hneg = act ? hneg : 0u;
        hpos = act ? hpos : 0u;
        o_p |= hpos << k;
        o_n |= hneg << k;
      }
    }
    out = (o_n << kWordTile) | o_p;
    // The bottom word's tile, columns cb + k: thread w scores and visits
    // k = w, w + width, ... (the score after column cb + k is the score
    // before the tile plus the carries of its columns up to k).
    const uint32_t bp = __shfl_sync(kFull, o_p, NW - 1, kWidth);
    const uint32_t bn = __shfl_sync(kFull, o_n, NW - 1, kWidth);
    const int cb = kWordTile * (s - (NW - 1));
#pragma unroll
    for (int i = 0; i < kWordTile / kWidth; ++i) {
      const int k = w + i * kWidth;
      const uint32_t m = (2u << k) - 1u;
      const int c = cb + k;
      v.take(score + __popc(bp & m) - __popc(bn & m), c,
             emit && c >= 0 && c < n_cols);
    }
    v.tile(cb, n_cols);
    score += __popc(bp) - __popc(bn);
  }
}

// The hit words of a word-parallel lane (#11 on the word lane): each
// thread marks the columns it scores that lie in [lo, end) and equal best;
// after every tile that ends a hit word (its second half) or the row, the
// segment ORs its threads' bits (__shfl_xor_sync) and its first thread
// stores the word where it is non-zero (`store`: that thread of a lane of
// the launch).  The calls are uniform over the warp (tile's cb and n_cols
// are), so the shuffles never diverge.
template <int kWidth>
struct WordHits {
  static_assert(2 * kWordTile == 32, "a hit word is two tiles");
  int lo, end;
  int32_t best;
  int32_t* row;
  bool store;
  uint32_t mask = 0u;

  __device__ __forceinline__ void take(int32_t score, int c, bool live) {
    const bool hit = live && c >= lo && c < end && score == best;
    mask |= (hit ? 1u : 0u) << (c & 31);
  }
  __device__ __forceinline__ void tile(int cb, int n_cols) {
    if (cb < 0 || ((cb & kWordTile) == 0 && cb + kWordTile < n_cols)) return;
    uint32_t m = mask;
#pragma unroll
    for (int d = 1; d < kWidth; d <<= 1)
      m |= __shfl_xor_sync(kFull, m, d, kWidth);
    if (store && m) row[cb >> 5] = static_cast<int32_t>(m);
    mask = 0u;
  }
};

// The segment's partial reductions (each thread's columns) merged in every
// thread: the least best, the first and last columns reaching it, and the
// score at hi - 1 (kBig where a thread did not visit that column).
template <int kWidth>
__device__ __forceinline__ void merge_words(WindowReduction& r) {
#pragma unroll
  for (int d = 1; d < kWidth; d <<= 1) {
    const int32_t b = __shfl_xor_sync(kFull, r.best, d, kWidth);
    const int32_t pf = __shfl_xor_sync(kFull, r.pfirst, d, kWidth);
    const int32_t pl = __shfl_xor_sync(kFull, r.plast, d, kWidth);
    const int32_t l = __shfl_xor_sync(kFull, r.last, d, kWidth);
    if (b < r.best) {
      r.best = b;
      r.pfirst = pf;
      r.plast = pl;
    } else if (b == r.best) {
      r.pfirst = min(r.pfirst, pf);
      r.plast = max(r.plast, pl);
    }
    r.last = min(r.last, l);
  }
}

// The word-parallel lane over every column of each lane's target row from
// its carried state (null pv0: fresh), the exit state kept where asked;
// STREAM: the score stream (out (n_cols, n_lanes)), else the resumable
// reduce's window reduction written directly (best, pfirst, plast, last).
// Thread t is word t % width of lane t / width (split_place with
// sp.n_cores = width); the block's distinct profile rows are staged as in
// the split kernels, with no rings before them.
template <int NW, bool STREAM>
__global__ void __launch_bounds__(kSplitMaxThreads, 4)
words_kernel(const uint32_t* __restrict__ peq, int s1, LaneArgs a,
             SplitArgs sp, int32_t* out) {
  extern __shared__ __align__(16) uint32_t dyn[];  // profile rows
  __shared__ int slot_row[kSplitMaxThreads];
  SplitPlace p;
  if (!split_place(a, sp, p, slot_row)) return;
  // Threads past the last lane take its slot, which split_place gave them.
  const EqRows eq = stage_rows<NW>(peq, s1, sp, p, slot_row, dyn, 0);
  const int lane = p.active ? p.lane : a.n_lanes - 1;
  const int w = threadIdx.x % word_threads<NW>();
  const int wr = min(w, NW - 1);
  const LaneCarry cr = lane_carry(a, NW, lane);
  uint32_t pv = cr.pv(wr), mv = cr.mv(wr);
  int32_t score = cr.score(NW);
  const RowSource src{a.targets + (size_t)a.trow[lane] * a.n_cols,
                      a.n_cols - 1, eq, wr};
  if constexpr (STREAM) {
    ScoreStream v{out + lane, (size_t)a.n_lanes};
    sweep_words<NW>(src, a.n_cols, a.hin_pos, w, p.active, pv, mv, score, v);
  } else {
    WindowReduction r;
    r.lo = a.lo[lane];
    r.hi = a.hi[lane];
    sweep_words<NW>(src, a.n_cols, a.hin_pos, w, p.active, pv, mv, score, r);
    merge_words<word_threads<NW>()>(r);
    if (p.active && w == NW - 1) store(a, lane, r);
  }
  if (!p.active) return;
  if (w < NW) cr.keep(w, pv, mv);
  if (w == NW - 1) cr.keep_score(score);
}

// #11 (myers_hits_eqstream) at 2-8 words on the word-parallel lane: thread
// t is word t % width of lane t / width, each lane from the fresh state over
// every column of the stream (so every lane of the launch takes the same
// steps), its Eq words read from the stream a tile ahead (StreamSource),
// its hit words by WordHits.  The threads past the last lane run the last
// lane's sweep and store nothing.
template <int NW>
__global__ void __launch_bounds__(kSplitMaxThreads)
hits_eqstream_words_kernel(const uint32_t* __restrict__ eq, LaneArgs a) {
  constexpr int kWidth = word_threads<NW>();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = t / kWidth < a.n_lanes;
  const int lane = active ? static_cast<int>(t / kWidth) : a.n_lanes - 1;
  const int w = threadIdx.x % kWidth;
  const StreamSource src{eq + (size_t)min(w, NW - 1) * a.n_lanes + lane,
                         (size_t)NW * a.n_lanes, a.n_cols - 1};
  WordHits<kWidth> v{a.lo[lane], min(a.hi[lane], a.n_cols), a.want[lane],
                     a.hits + (size_t)lane * a.n_out, active && w == 0};
  uint32_t pv = ~0u, mv = 0u;
  int32_t score = NW * 32;
  sweep_words<NW>(src, a.n_cols, a.hin_pos, w, active, pv, mv, score, v);
}

// #10 (myers_reduce_eqstream) at 2-8 words on the word-parallel lane:
// hits_eqstream_words_kernel's lanes and stream with the window reduction
// in place of its hit words.  Every lane sweeps all n_cols columns, so
// WindowReduction's take masks the columns c >= hi that the one-thread
// kernel never sweeps, and last is the score at hi - 1 only (kBig past the
// row).  Every thread of the warp merges its segment's partial reductions
// (merge_words: the least best, the first and last columns reaching it);
// the first thread of an active lane stores the four outputs.
template <int NW>
__global__ void __launch_bounds__(kSplitMaxThreads)
reduce_eqstream_words_kernel(const uint32_t* __restrict__ eq, LaneArgs a) {
  constexpr int kWidth = word_threads<NW>();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = t / kWidth < a.n_lanes;
  const int lane = active ? static_cast<int>(t / kWidth) : a.n_lanes - 1;
  const int w = threadIdx.x % kWidth;
  const StreamSource src{eq + (size_t)min(w, NW - 1) * a.n_lanes + lane,
                         (size_t)NW * a.n_lanes, a.n_cols - 1};
  WindowReduction r;
  r.lo = a.lo[lane];
  r.hi = a.hi[lane];
  uint32_t pv = ~0u, mv = 0u;
  int32_t score = NW * 32;
  sweep_words<NW>(src, a.n_cols, a.hin_pos, w, active, pv, mv, score, r);
  merge_words<kWidth>(r);
  if (active && w == 0) store(a, lane, r);
}

// ---------------------------------------------------------------------------
// #6 (myers_nw_banded) as a word-parallel band (ops/cuda_kernel.py
// nw_banded_words_plain is the same schedule in PyTorch).  NW is
// prefix-anchored, so a lane cannot be cut into column cores; its band
// window's n_win words run on a segment of W threads of one warp (W =
// band_width(n_win), 2, 4, 8 or 16), each a tile of kWordTile columns a
// step, as the word-parallel lane's do.
//
// The window slides down by whole words at chunk boundaries, so a word's
// lag is tied to its absolute index, not its window position: absolute
// word x runs tile tau at step tau + x - woff[0], and thread j holds the
// words x = j (mod W) in turn.  Word x at tile tau takes its carry from
// word x - 1 at tile tau one step before (a rotated shuffle inside the
// segment, from thread j - 1 mod W), or hin = +1 where x is the window's
// top word off(tau) = woff[tau kWordTile / chunk] (a chunk is a whole
// number of tiles).  The tiles in flight at step s are those with start(tau)
// = tau + off(tau) - woff[0] <= s < start(tau) + n_win: an interval, since
// start strictly increases; their words s - tau + woff[0] are consecutive
// and at most n_win <= W of them, so a thread holds at most one live word
// a step.  A word's live tiles are consecutive, so its steps are too, and
// a word that enters the window (a thread's new word) starts from the
// reset state (Pv = ~0, Mv = 0), as the one-thread kernel's never-advanced
// words do; words that left it are never read again.  The score is
// carried by each tile's bottom word off(tau) + n_win - 1, which runs at
// start(tau) + n_win - 1: at most one tile's bottom a step, in tile order.
// Its two masks reach the segment in two shuffles and each thread scores
// and visits every W-th column of the tile (take), as sweep_words does;
// the score gains 32 a word the window slides at the next tile.  All of
// this depends on the step, woff, n_win and n_cols alone, which every
// lane of a launch shares, so the warp never diverges on it and every
// lane sweeps all n_cols columns.  Steps: n_tiles + off(last tile) -
// woff[0] + n_win - 1.  The visitor sees a column as live where its
// chunk's window has reached the bottom word (off == nw - n_win).  The
// block's distinct profile rows (all nw words of a row, since x ranges
// over them) are staged in shared memory as words_kernel does; each
// segment brings a tile's symbols into its ring in shared memory (cp.async)
// the step before the tile starts, so its words read them there.
//
// #7 (myers_shw_banded) and #8 (myers_shw_banded_hits) run the same band
// with WindowReduction (its select-only take, the segment's partial
// reductions merged by merge_words as the word-parallel lane's are) and
// WordHits in place of BandLast (ops/cuda_kernel.py
// shw_banded_words_plain, shw_banded_hits_words_plain).  The one-thread
// kernels (sweep_banded) keep n_win = 1, a chunk that is not a whole
// number of tiles and n_win past kBandMaxWidth; the wrapper
// (cuda_kernel.band_width) picks the form.
constexpr int kBandMaxWidth = 16;

__host__ __device__ constexpr int band_width(int n_win) {
  return n_win <= 2 ? 2 : n_win <= 4 ? 4 : n_win <= 8 ? 8 : 16;
}

// A tile index walking forward with its chunk's window offset (pos: the
// tile's place in its chunk), so the band's bookkeeping divides nothing.
struct TileCursor {
  int tau = 0, pos = 0, ch = 0, off = 0;
};

// The band's tiles in flight at a step, [lo, nx - 1], advanced step by
// step: lo the oldest, nx the next to start; hi_start the newest one's
// start.
struct BandTiles {
  const int32_t* woff;
  int tpc, n_win, n_tiles, off0;  // tpc: tiles a chunk
  TileCursor lo, nx;
  int hi_start = -1;

  __device__ __forceinline__ BandTiles(const int32_t* w, int chunk, int nwin,
                                       int n_cols)
      : woff(w), tpc(chunk / kWordTile), n_win(nwin),
        n_tiles((n_cols + kWordTile - 1) / kWordTile), off0(__ldg(w)) {
    lo.off = nx.off = off0;
  }
  __device__ __forceinline__ int start(const TileCursor& c) const {
    return c.tau + c.off - off0;
  }
  __device__ __forceinline__ void step(TileCursor& c) const {
    ++c.tau;
    if (++c.pos == tpc && c.tau < n_tiles) {
      c.pos = 0;
      c.off = __ldg(woff + ++c.ch);
    }
  }
  __device__ __forceinline__ void advance(int s) {
    while (nx.tau < n_tiles && start(nx) <= s) {
      hi_start = start(nx);
      step(nx);
    }
    while (lo.tau < nx.tau && start(lo) + n_win <= s) step(lo);
  }
  __device__ __forceinline__ bool any() const { return lo.tau < nx.tau; }
};

// Thread j's word x and tile tau at step s (valid: it has a live word;
// top: its word is the tile's top word, which the tile starts with).
struct BandWord {
  int x, tau;
  bool valid, top;
};

template <int W>
__device__ __forceinline__ BandWord band_word(const BandTiles& bt, int s,
                                              int j) {
  const int hi = bt.nx.tau - 1;
  const int x_min = s - hi + bt.off0;
  BandWord a;
  a.x = x_min + ((j - x_min) & (W - 1));
  a.valid = bt.any() && a.x <= s - bt.lo.tau + bt.off0;
  a.tau = s - a.x + bt.off0;
  a.top = a.valid && a.tau == hi && bt.hi_start == s;
  return a;
}

// The NW readout on the band: the score at hi - 1 where live, kBig
// elsewhere; merged over the segment at the end (merge_last).
struct BandLast {
  int hi;
  int32_t last = kBig;

  __device__ __forceinline__ void take(int32_t score, int c, bool live) {
    last = live && c == hi - 1 ? score : last;
  }
  __device__ __forceinline__ void tile(int, int) {}
};

template <int W>
__device__ __forceinline__ int32_t merge_last(int32_t last) {
#pragma unroll
  for (int d = 1; d < W; d <<= 1)
    last = min(last, __shfl_xor_sync(kFull, last, d, W));
  return last;
}

// A lane's ring of symbol tiles (W + 1 slots: a tile in flight at most
// n_win <= W steps, one more being fetched), a slot 20 words apart, so a
// thread reads its tile as four 16-byte loads and the eight threads of a
// quarter warp, reading consecutive slots, hit distinct banks.
constexpr int kBandSlotWords = kWordTile + 4;

// Eq word x of symbol sym: one lane's profile row (s1, nw), in shared
// memory where the block staged it (a pointer into dyn, so the loads are
// shared-memory loads) or in global memory.
struct BandEq {
  const uint32_t* row;
  int nw;

  __device__ __forceinline__ uint32_t word(int32_t sym, int x) const {
    return row[sym * nw + x];
  }
};

// A segment's ring as words a thread of it.
__host__ __device__ constexpr int band_ring_words(int width) {
  return ((width + 1) * kBandSlotWords + width - 1) / width;
}

// Thread j of a lane's segment sweeps its words of the band over every
// column of the lane's target row tg (n_cols >= 1), Eq from eq, calling
// v.take(score, c, live) for the columns c = j (mod W) of each tile's
// bottom word and v.tile(cb, n_cols) after it.  ring: the segment's W *
// band_ring_words(W) words of shared memory.  Every thread of the warp
// calls it.
template <int W, class Visit>
__device__ __forceinline__ void sweep_band(const int32_t* tg, const BandEq& eq,
                                           const Band& band, int n_cols,
                                           int j, int32_t* ring, Visit& v) {
  constexpr uint32_t kMask = (1u << kWordTile) - 1u;
  const int last = n_cols - 1;
  // Tile tau's symbols into its slot, W threads on its 16 columns.
  const auto fetch = [&](int tau) {
    int32_t* slot = ring + (tau % (W + 1)) * kBandSlotWords;
#pragma unroll
    for (int k = j; k < kWordTile; k += W)
      cp_async4(slot + k, tg + min(kWordTile * tau + k, last));
    cp_async_commit();
  };
  BandTiles bt(band.woff, band.chunk, band.n_win, n_cols);
  const int n_steps = bt.n_tiles - 1 +
                      __ldg(band.woff + (bt.n_tiles - 1) / bt.tpc) - bt.off0 +
                      band.n_win;  // the last tile's start + n_win
  int32_t score = (bt.off0 + band.n_win) * 32;
  int off_scored = bt.off0;  // the window offset the score is at
  uint32_t pv = ~0u, mv = 0u, out = 0u;
  int cur = -1;
  fetch(0);
  cp_async_wait<0>();
  __syncwarp();
  for (int s = 0; s < n_steps; ++s) {
    bt.advance(s);
    if (bt.nx.tau < bt.n_tiles && bt.start(bt.nx) == s + 1) fetch(bt.nx.tau);
    const BandWord a = band_word<W>(bt, s, j);
    const int xr = min(max(a.x, 0), band.nw - 1);
    uint32_t e[kWordTile];
    if (a.valid) {
      const int4* t4 = reinterpret_cast<const int4*>(
          ring + (a.tau % (W + 1)) * kBandSlotWords);
#pragma unroll
      for (int q = 0; q < kWordTile / 4; ++q) {
        const int4 x = t4[q];
        e[4 * q] = eq.word(x.x, xr);
        e[4 * q + 1] = eq.word(x.y, xr);
        e[4 * q + 2] = eq.word(x.z, xr);
        e[4 * q + 3] = eq.word(x.w, xr);
      }
    }
    if (a.valid && a.x != cur) {  // a word entering the window
      pv = ~0u;
      mv = 0u;
      cur = a.x;
    }
    const uint32_t y = __shfl_sync(kFull, out, (j + W - 1) & (W - 1), W);
    const uint32_t hp_in = a.top ? kMask : y & kMask;
    const uint32_t hn_in = a.top ? 0u : y >> kWordTile;
    const int c0 = kWordTile * a.tau;
    uint32_t o_p = 0u, o_n = 0u;
    if (a.valid && c0 + kWordTile <= n_cols) {
#pragma unroll
      for (int k = 0; k < kWordTile; ++k) {
        uint32_t hneg = (hn_in >> k) & 1u, hpos = (hp_in >> k) & 1u, ph, mh;
        advance_word_h(pv, mv, e[k], hneg, hpos, ph, mh);
        o_p = __funnelshift_l(ph, o_p, 1);  // the carries out, newest at
        o_n = __funnelshift_l(mh, o_n, 1);  // bit 0
      }
      o_p = __brev(o_p) >> kWordTile;  // bit k: column c0 + k
      o_n = __brev(o_n) >> kWordTile;
    } else if (a.valid) {  // the row's last, ragged tile
#pragma unroll
      for (int k = 0; k < kWordTile; ++k) {
        const bool act = c0 + k <= last;
        uint32_t hneg = (hn_in >> k) & 1u, hpos = (hp_in >> k) & 1u;
        uint32_t p = pv, m = mv;
        advance_word(p, m, e[k], hneg, hpos);
        pv = act ? p : pv;
        mv = act ? m : mv;
        o_p |= (act ? hpos : 0u) << k;
        o_n |= (act ? hneg : 0u) << k;
      }
    }
    out = (o_n << kWordTile) | o_p;
    if (bt.any() && bt.start(bt.lo) + band.n_win - 1 == s) {  // a bottom
      const int ob = bt.lo.off;
      const int jb = (ob + band.n_win - 1) & (W - 1);
      const uint32_t bp = __shfl_sync(kFull, o_p, jb, W);
      const uint32_t bm = __shfl_sync(kFull, o_n, jb, W);
      score += (ob - off_scored) * 32;  // the words slid since
      off_scored = ob;
      const int cb = kWordTile * bt.lo.tau;
      const bool live = ob == band.nw - band.n_win;
#pragma unroll
      for (int i = 0; i < (kWordTile + W - 1) / W; ++i) {
        const int k = j + i * W;
        const uint32_t m = (2u << k) - 1u;
        const int c = cb + k;
        v.take(score + __popc(bp & m) - __popc(bm & m), c,
               live && k < kWordTile && c <= last);
      }
      v.tile(cb, n_cols);
      score += __popc(bp) - __popc(bm);
    }
    cp_async_wait<0>();
    __syncwarp();
  }
}

// A band kernel's lane: the block's rows staged (every thread of the
// block calls it), then thread j = t % W of the segment sweeps lane
// `lane`'s band with visitor v.  Thread t is thread t % W of lane t / W
// (split_place with sp.n_cores = W); the threads past the last lane run
// its sweep (lane = the last) and store nothing.
template <int W, class Visit>
__device__ __forceinline__ void band_lane(const uint32_t* peq, int s1,
                                          const Band& band,
                                          const LaneArgs& a,
                                          const SplitArgs& sp,
                                          const SplitPlace& p,
                                          const int* slot_row, uint32_t* dyn,
                                          int lane, Visit& v) {
  constexpr int kRing = band_ring_words(W);
  stage_rows(peq, s1, band.nw, sp, p, slot_row, dyn, kRing);
  if (a.n_cols <= 0) return;
  const int rw = s1 * band.nw;
  const int j = threadIdx.x % W;
  int32_t* ring = reinterpret_cast<int32_t*>(dyn) + (threadIdx.x - j) * kRing;
  const int32_t* tg = a.targets + (size_t)a.trow[lane] * a.n_cols;
  if (p.n_slots * rw <= sp.peq_words)  // stage_rows staged the rows
    sweep_band<W>(tg, BandEq{dyn + blockDim.x * kRing + p.slot * rw, band.nw},
                  band, a.n_cols, j, ring, v);
  else
    sweep_band<W>(tg, BandEq{peq + (size_t)max(p.row, 0) * rw, band.nw},
                  band, a.n_cols, j, ring, v);
}

// #6 on the word-parallel band: the score at hi - 1 (BandLast), merged
// over the segment.
template <int W>
__global__ void __launch_bounds__(kSplitMaxThreads, 4)
nw_banded_words_kernel(const uint32_t* __restrict__ peq, int s1, Band band,
                       LaneArgs a, SplitArgs sp) {
  extern __shared__ __align__(16) uint32_t dyn[];  // rings, profile rows
  __shared__ int slot_row[kSplitMaxThreads];
  SplitPlace p;
  if (!split_place(a, sp, p, slot_row)) return;
  const int lane = p.active ? p.lane : a.n_lanes - 1;
  BandLast r{a.hi[lane]};
  band_lane<W>(peq, s1, band, a, sp, p, slot_row, dyn, lane, r);
  const int32_t last = merge_last<W>(r.last);
  if (p.active && threadIdx.x % W == 0) a.last[lane] = last;
}

// #7 on the word-parallel band: (best, pfirst, plast) over the live
// columns in [lo, hi).  sweep_band visits every column of the row, so
// WindowReduction's take masks the columns c >= hi that sweep_banded's end
// = min(hi, n_cols) leaves out.  Every thread of the warp merges its
// segment's partial reductions (merge_words); the first thread of an
// active lane stores best, pfirst and plast only: launch_banded points
// kind 1's last at best.
template <int W>
__global__ void __launch_bounds__(kSplitMaxThreads, 4)
shw_banded_words_kernel(const uint32_t* __restrict__ peq, int s1, Band band,
                        LaneArgs a, SplitArgs sp) {
  extern __shared__ __align__(16) uint32_t dyn[];  // rings, profile rows
  __shared__ int slot_row[kSplitMaxThreads];
  SplitPlace p;
  if (!split_place(a, sp, p, slot_row)) return;
  const int lane = p.active ? p.lane : a.n_lanes - 1;
  WindowReduction r;
  r.lo = a.lo[lane];
  r.hi = a.hi[lane];
  band_lane<W>(peq, s1, band, a, sp, p, slot_row, dyn, lane, r);
  merge_words<W>(r);
  if (p.active && threadIdx.x % W == 0) {
    a.best[lane] = r.best;
    a.pfirst[lane] = r.pfirst;
    a.plast[lane] = r.plast;
  }
}

// #8 on the word-parallel band: the hit words of the live columns in [lo,
// min(hi, n_cols)) that score best (WordHits: the segment ORs its bits at
// every tile that ends a hit word or the row, its first thread stores
// them).  sweep_band calls WordHits::tile at most once a step, in tile
// order, at steps that every lane of the launch shares, so its shuffles
// never diverge.
template <int W>
__global__ void __launch_bounds__(kSplitMaxThreads, 4)
shw_banded_hits_words_kernel(const uint32_t* __restrict__ peq, int s1,
                             Band band, LaneArgs a, SplitArgs sp) {
  extern __shared__ __align__(16) uint32_t dyn[];  // rings, profile rows
  __shared__ int slot_row[kSplitMaxThreads];
  SplitPlace p;
  if (!split_place(a, sp, p, slot_row)) return;
  const int lane = p.active ? p.lane : a.n_lanes - 1;
  WordHits<W> v{a.lo[lane], min(a.hi[lane], a.n_cols), a.want[lane],
                a.hits + (size_t)lane * a.n_out,
                p.active && threadIdx.x % W == 0};
  band_lane<W>(peq, s1, band, a, sp, p, slot_row, dyn, lane, v);
}

// ---------------------------------------------------------------------------
// The score stream's long lanes (kWaveMinWords words and up) as warp groups
// linked by per-tile records (csrc/groups.cuh, the schedule of
// myers_wavefront; ops/cuda_kernel.py sweep_scores_groups_plain).  A unit of
// the schedule is one lane: lane i of group g holds word w = 32 g + i and
// advances column d - w at step d over the steps [0, n_cols + nw - 1), from
// the lane's carried Pv and Mv words (or the fresh state), the top group
// taking (0, hin0).  Each group stages its words' rows of the lane's
// profile in shared memory where s1 rows fit.  The bottom group writes the
// score after every column and the exit score, each group its words of the
// exit state.  A lane of more groups than one launch keeps resident runs
// as passes, a launch each, as myers_wavefront's window does: the bottom
// group of a pass writes every record of its lane (bottom_out, n_tiles a
// lane) and the next pass's top group reads them (top_in).
struct ScoreGroupArgs {
  const uint32_t* peq;     // (R_p, s1, nw)
  int s1, nw;
  const int32_t* targets;  // (R_t, n_cols)
  int n_cols;
  const int32_t* prow;
  const int32_t* trow;
  int n_lanes;
  uint32_t hin0;
  int32_t* out;            // (n_cols, n_lanes)
  const uint32_t* pv0;     // (n_lanes, nw), or null: a fresh start
  const uint32_t* mv0;
  const int32_t* sc0;
  uint32_t* pv1;           // (n_lanes, nw), or null: not kept
  uint32_t* mv1;
  int32_t* sc1;
  ulonglong2* links;       // (n_lanes, n_groups, ring) records
  unsigned* cons;          // (n_lanes, n_groups) tiles each reader consumed
  int* next_task;
  const ulonglong2* top_in;  // (n_lanes, n_tiles) records of the pass
  ulonglong2* bottom_out;    // above, for the pass below; or null
  int n_tiles;
  int g_lo, n_groups, g_real;  // groups [g_lo, g_lo + n_groups) of g_real
  int ring, wpb, peq_smem;
};

__device__ __forceinline__ void score_group(const ScoreGroupArgs& a, int l,
                                            int gl, int warp, int lane,
                                            ulonglong2* s_rec,
                                            unsigned* s_cons,
                                            uint32_t* s_peq) {
  const int nw = a.nw;
  const int g = a.g_lo + gl;
  const int w = g * kGroup + lane;
  const bool live = w < nw;
  const int wr = min(w, nw - 1);
  const uint32_t* peq = a.peq + (size_t)a.prow[l] * a.s1 * nw;
  const int32_t* tg = a.targets + (size_t)a.trow[l] * a.n_cols;
  const size_t at = (size_t)l * nw + wr;
  GroupState st{a.pv0 ? a.pv0[at] : ~0u, a.pv0 ? a.mv0[at] : 0u, 0u, 0u,
                a.pv0 ? a.sc0[l] : nw * 32, 0u, 0u};
  const size_t rec = (size_t)l * a.n_tiles;
  const GroupLinks ln = group_links(
      l, gl, warp, a.wpb, a.n_groups, a.ring, g == 0, g + 1 == a.g_real,
      a.links, a.cons, s_rec, s_cons, a.top_in ? a.top_in + rec : nullptr,
      a.bottom_out ? a.bottom_out + rec : nullptr);
  if (a.peq_smem) {
    for (int r = 0; r < a.s1; ++r)
      s_peq[r * kGroup + lane] = peq[(size_t)r * nw + wr];
    __syncwarp();
  }
  const int bl = nw - 1 - g * kGroup;
  const bool bottom_here = bl >= 0 && bl < kGroup;
  int32_t* out = a.out + l;
  // After each tile lane k writes the score after step d0 + k, column
  // d0 + k - (nw - 1) of the lane.
  auto tile = [&](int d0, int nk, int32_t sc0, uint32_t o_p, uint32_t o_n) {
    if (!bottom_here) return;
    const int32_t v = tile_score(sc0, o_p, o_n, bl, lane);
    const int c = d0 + lane - (nw - 1);
    if (lane < nk && c >= 0 && c < a.n_cols) out[(size_t)c * a.n_lanes] = v;
  };
  const GroupSpan sp{tg, peq, a.peq_smem ? s_peq : nullptr, nw, a.n_cols,
                     wr, w, live, g == 0,
                     0, a.n_cols, 0, a.n_cols + nw - 1, a.hin0, a.ring};
  group_sweep(sp, ln, lane, st, tile);
  if (a.pv1 != nullptr) {
    if (live) {
      a.pv1[at] = st.pv;
      a.mv1[at] = st.mv;
    }
    if (bottom_here && lane == bl) a.sc1[l] = st.sc;
  }
}

__global__ void __launch_bounds__(kGroupMaxWarps * 32)
sweep_scores_groups_kernel(ScoreGroupArgs a) {
  auto run = [&](int l, int gl, int warp, int lane, ulonglong2* s_rec,
                 unsigned* s_cons, uint32_t* s_peq) {
    score_group(a, l, gl, warp, lane, s_rec, s_cons, s_peq);
  };
  group_tasks(a.n_lanes, a.n_groups, a.wpb, a.ring, a.s1, a.next_task, run);
}

// K3's rows in shared memory, for K3 and #13 at 1-8 words.  A row is
// n_alts * nb + 1 plane words a query word (the planes, then pad).  Each
// of the block's rows has its planes staged in shared memory after the
// threads' rings (split_config sizes the block so that they fit).  Where
// the rows also fit sp.peq_words with their expanded profiles (2^nb
// symbols x NW words each), each row is expanded once, every Eq word the
// PlaneRows function of its symbol, and the sweep reads one word per word
// and column (EqRows); else Eq is built from the staged planes per
// column.  Every thread of the block calls it; an active thread then runs
// sweep(eq) on its row.
template <int NW, class Sweep>
__device__ __forceinline__ void bitplane_rows(
    const uint32_t* planes, const uint32_t* pad, int nb, int n_alts,
    int wildcard, const SplitArgs& sp, const SplitPlace& p,
    const int* slot_row, uint32_t* dyn, const Sweep& sweep) {
  const int T = blockDim.x;
  const int n_sym = 1 << nb;
  const int pw = n_alts * nb * NW;   // plane words a row, pad after them
  const int rw = pw + NW;
  const int rs = rw | 1;             // an odd row stride: no bank conflicts
  const int prof_w = n_sym * NW;
  const int n = p.n_slots;
  const bool expand = n * (prof_w + rs) <= sp.peq_words;
  uint32_t* profs = dyn + T * kRingWords;
  uint32_t* rows = expand ? profs + n * prof_w : profs;
  for (int i = threadIdx.x; i < n * rw; i += T) {
    const int row = slot_row[i / rw], j = i % rw;
    rows[(i / rw) * rs + j] = j < pw ? planes[(size_t)row * pw + j]
                                     : pad[(size_t)row * NW + j - pw];
  }
  __syncthreads();
  if (expand) {
    for (int i = threadIdx.x; i < n * n_sym; i += T) {
      const int slot = i / n_sym, sym = i % n_sym;
      const uint32_t* r = rows + slot * rs;
      uint32_t e[NW];
      PlaneRows{r, r + pw, nb, n_alts, wildcard}.template load<NW>(e, sym);
#pragma unroll
      for (int w = 0; w < NW; ++w) profs[slot * prof_w + sym * NW + w] = e[w];
    }
    __syncthreads();
  }
  if (!p.active) return;
  if (expand) {
    sweep(EqRows{profs + p.slot * prof_w, NW, 1, n_sym - 1});
    return;
  }
  const uint32_t* r = rows + p.slot * rs;
  sweep(PlaneRows{r, r + pw, nb, n_alts, wildcard});
}

// K3, split-lane: K1's schedule with Eq from the query-id bit planes
// (bitplane_rows).
template <int NW>
__global__ void __launch_bounds__(kSplitMaxThreads, 4)
reduce_bitplane_split_kernel(const uint32_t* __restrict__ planes,
                             const uint32_t* __restrict__ pad, int nb,
                             int n_alts, int wildcard, LaneArgs a,
                             SplitArgs sp) {
  extern __shared__ __align__(16) uint32_t dyn[];  // rings, profiles, planes
  __shared__ int slot_row[kSplitMaxThreads];
  SplitPlace p;
  if (!split_place(a, sp, p, slot_row)) return;
  bitplane_rows<NW>(planes, pad, nb, n_alts, wildcard, sp, p, slot_row, dyn,
                    [&](const auto& eq) { split_sweep<NW>(a, sp, p, dyn, eq); });
}

// #13 (myers_hits_bitplane) at 1-8 words: #5's hit words (split_hits, cores
// that own whole hit words, plain stores) on K3's staged rows, in K3's
// launch shape.  Where no lane has two cores (offsets null) thread t is lane
// t; at hin0 = 1 that is one core a lane swept from column 0.
template <int NW>
__global__ void __launch_bounds__(kSplitMaxThreads, 4)
hits_bitplane_split_kernel(const uint32_t* __restrict__ planes,
                           const uint32_t* __restrict__ pad, int nb,
                           int n_alts, int wildcard, LaneArgs a,
                           SplitArgs sp) {
  extern __shared__ __align__(16) uint32_t dyn[];  // rings, profiles, planes
  __shared__ int slot_row[kSplitMaxThreads];
  SplitPlace p;
  if (!split_place(a, sp, p, slot_row)) return;
  bitplane_rows<NW>(planes, pad, nb, n_alts, wildcard, sp, p, slot_row, dyn,
                    [&](const auto& eq) { split_hits<NW>(a, sp, p, dyn, eq); });
}

// K2, split-lane: n_cores cores a lane, thread t is core t % n_cores of lane
// t / n_cores.
template <int NW>
__global__ void __launch_bounds__(kSplitMaxThreads, 4)
sweep_shared_split_kernel(const uint32_t* __restrict__ peq, int s1,
                          int n_lanes, const int32_t* __restrict__ target,
                          int n_cols, uint32_t hin_pos, int col_lo,
                          int col_hi, int n_cores, SplitArgs sp,
                          unsigned long long* key) {
  extern __shared__ __align__(16) uint32_t dyn[];  // rings, profiles
  const int T = blockDim.x;
  const long long total = (long long)n_lanes * n_cores;
  const long long t0 = (long long)blockIdx.x * T;
  const int first = static_cast<int>(t0 / n_cores);
  const int nl = static_cast<int>((min(total, t0 + T) - 1) / n_cores) - first + 1;
  const int rw = s1 * NW;
  uint32_t* rows = dyn + T * kRingWords;
  const bool in_smem = nl * rw <= sp.peq_words;
  if (in_smem)  // lane-fastest reads of (S1, NW, B): coalesced
    for (int i = threadIdx.x; i < nl * rw; i += T)
      rows[(i % nl) * rw + i / nl] = peq[(size_t)(i / nl) * n_lanes + first + i % nl];
  __syncthreads();
  const long long t = t0 + threadIdx.x;
  if (t >= total) return;
  const int lane = static_cast<int>(t / n_cores);
  const EqRows eq = in_smem ? EqRows{rows + (lane - first) * rw, NW, 1}
                            : EqRows{peq + lane, NW * n_lanes, n_lanes};
  const Core k(col_lo, col_hi, n_cols, static_cast<int>(t % n_cores), sp.core,
               sp.halo, hin_pos);
  const SymStream st(dyn, target + k.start, target + n_cols, k.c_hi - k.start);
  Reduction r{max(col_lo, k.c_lo), col_hi};
  sweep_core<NW>(st, eq, hin_pos, k.start, r);
  if (r.pfirst >= 0) atomicMin(key + lane, first_key(r.best, r.pfirst));
}

// K2 past 8 words: every lane against one target, a thread a lane, its
// state in scratch.  The block stages kChunk symbols at a time in shared
// memory; Peq is laid out (S1, NW, B) so a warp's 32 lanes read 32
// consecutive words of the same row.
__global__ void __launch_bounds__(kThreads)
sweep_shared_kernel(const uint32_t* __restrict__ peq, int nw, int n_lanes,
                    const int32_t* __restrict__ target, int n_cols,
                    uint32_t hin_pos, int col_lo, int col_hi,
                    unsigned long long* key, uint32_t* scratch) {
  __shared__ int32_t stage[kChunk];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < n_lanes;
  const size_t row_stride = (size_t)nw * n_lanes;
  uint32_t* spv = scratch + lane;
  uint32_t* smv = scratch + row_stride + lane;
  if (active) {
    for (int w = 0; w < nw; ++w) {
      spv[(size_t)w * n_lanes] = ~0u;
      smv[(size_t)w * n_lanes] = 0u;
    }
  }
  int32_t score = nw * 32, run_best = kBig, run_pos = -1;
  const int end = min(n_cols, col_hi);
  for (int c0 = 0; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) stage[i] = target[c0 + i];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const uint32_t* row = peq + (size_t)stage[j] * row_stride + lane;
      uint32_t hneg = 0u, hpos = hin_pos;
      for (int w = 0; w < nw; ++w) {
        uint32_t p = spv[(size_t)w * n_lanes], m = smv[(size_t)w * n_lanes];
        advance_word(p, m, row[(size_t)w * n_lanes], hneg, hpos);
        spv[(size_t)w * n_lanes] = p;
        smv[(size_t)w * n_lanes] = m;
      }
      score += static_cast<int32_t>(hpos) - static_cast<int32_t>(hneg);
      const int c = c0 + j;
      if (score < run_best && c >= col_lo) {
        run_best = score;
        run_pos = c;
      }
    }
  }
  if (active) key[lane] = first_key(run_best, run_pos);
}

// ---------------------------------------------------------------------------
// Column capture (#14, myers_capture): every column's state stored instead
// of reduced.  Lane b's word w after column c lands at (c * nw + w) *
// n_lanes + b of each output: lane-minor, the layout the batched PATH
// decode reads (ops/cuda_kernel.py capture_words_plain is the same
// schedule in PyTorch).
//
// Word groups over lanes.  A block holds `lanes` consecutive lanes (8, 16
// or 32) and all their words: thread t is lane t % lanes of group t /
// lanes, a group holds K consecutive words (1, 2, 4 or 8) in
// registers.  Group g advances the kWordTile columns [kWordTile (s - g),
// + kWordTile) at step s, its K words in order a column; the tile's
// horizontal carries out of its bottom word, two kWordTile-bit masks
// (hneg above hpos), reach group g + 1 at step s + 1 through shared
// memory (double-buffered, one barrier a step); the top group takes (0,
// hin0).  So a store instruction of a warp writes one word of `lanes`
// consecutive lanes: whole 32-byte sectors (a whole 128-byte line at 32
// lanes) of each output, where n_lanes is a multiple of 8.  Nothing is
// read back from the outputs.  The block brings its lanes' tiles of
// symbols into a ring in shared memory two steps ahead (cp.async,
// coalesced: a lane's 16 symbols are 64 contiguous bytes), where every
// group reads them as its tile comes; Eq comes from the block's lanes'
// profile rows, staged in shared memory where they fit kCapSmemWords
// (else read from global memory).  A group of 1 or 2 words loads its
// tile's symbols and Eq words into registers before the tile's columns,
// so no load sits on a column's chain.  The wrapper plans the shape
// (cuda_kernel.capture_plan): the most lanes a block that still gives
// every SM a block, then the fewest words a group that keep a block
// within kCapMaxThreads threads; a window of more than 8 *
// kCapMaxThreads / 8 = 512 words (a tall, narrow PATH window of 513 to
// 1,023 words: the batched route caps a window at 32,767 rows and 2^18
// cells) keeps the read-back form below, one thread a lane (groups of 16
// words took the build a quarter of its time and spilled).
//
// What bounds it: the stores, 8 bytes a word-column (16 with Ph and Mh)
// against 13 operations: at 3.35 TB/s and 16.7e12 operations/s the bytes
// take 2.4-4.8 ps and the operations 0.78 ps a word-column, so the bytes
// bind, at phase 12's shape (Ph and Mh kept) by six times.  The work a
// launch offers is one chain of columns a (lane, word): a 512-lane slab
// of 16-word windows is 8,192 threads, 64 blocks of 128 on 64 SMs, one
// warp a scheduler, so a launch runs far from that bound on latency.
constexpr int kCapMaxThreads = 512;
constexpr int kCapMaxWords = 8;      // words a group holds, at most
constexpr int kCapSmemWords = 8192;  // profile words a block may stage

// p + i as one wide multiply-add (the compiler would otherwise rebuild each
// output's 64-bit address from a shared 64-bit index, column by column).
__device__ __forceinline__ uint32_t* word_at(uint32_t* p, uint32_t i) {
  uint32_t* q;
  asm("mad.wide.u32 %0, %1, 4, %2;" : "=l"(q) : "r"(i), "l"(p));
  return q;
}

// One column of a capture group: its K words advanced from the carry bits
// (hneg, hpos), word i's state stored at word o + i * L of each output
// (pv, mv; WANT_H: ph, mh, all offset to the tile's first column, the
// group's first word and the lane), the bottom word's horizontal deltas
// shifted into (o_p, o_n) (bit 0 the newest column).
template <int K, bool WANT_H>
__device__ __forceinline__ void capture_column(
    uint32_t (&pv)[K], uint32_t (&mv)[K], const uint32_t (&e)[K],
    int n_words, uint32_t hneg, uint32_t hpos, uint32_t* const (&q)[4],
    uint32_t o, uint32_t L, uint32_t& o_p, uint32_t& o_n) {
  uint32_t ph = 0u, mh = 0u;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (K == 1 || i < n_words) {
      advance_word_h(pv[i], mv[i], e[i], hneg, hpos, ph, mh);
      const uint32_t oi = o + i * L;
      *word_at(q[0], oi) = pv[i];
      *word_at(q[1], oi) = mv[i];
      if constexpr (WANT_H) {
        *word_at(q[2], oi) = ph;
        *word_at(q[3], oi) = mh;
      }
    }
  }
  o_p = __funnelshift_l(ph, o_p, 1);
  o_n = __funnelshift_l(mh, o_n, 1);
}

// The Eq words of a group's K words for symbol sym: from the registers
// loaded before the tile (1-2 words) or from the profile row.
template <int K, int P>
__device__ __forceinline__ void capture_eq(uint32_t (&e)[K],
                                           const uint32_t (&pre)[P],
                                           const uint32_t* prof, int32_t sym,
                                           int nw, int w0) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if constexpr (K <= 2)
      e[i] = pre[i];
    else
      e[i] = prof[sym * nw + min(w0 + i, nw - 1)];
  }
}

template <int K, bool WANT_H>
__global__ void __launch_bounds__(kCapMaxThreads)
capture_words_kernel(const uint32_t* __restrict__ peq, int s1, int nw,
                     const int32_t* __restrict__ targets, int n_cols,
                     int n_lanes, uint32_t hin_pos, int lanes, int staged,
                     uint32_t* __restrict__ pvo, uint32_t* __restrict__ mvo,
                     uint32_t* __restrict__ pho,
                     uint32_t* __restrict__ mho) {
  extern __shared__ __align__(16) uint32_t dyn[];  // symbol ring, profiles
  __shared__ uint32_t link[2][kCapMaxThreads];    // [buffer][thread]
  constexpr uint32_t kMask = (1u << kWordTile) - 1u;
  constexpr int kPre = K <= 2 ? K : 1;  // Eq words loaded before a tile
  const int l = threadIdx.x % lanes, g = threadIdx.x / lanes;
  const int n_groups = blockDim.x / lanes;
  const int b0 = blockIdx.x * lanes;
  // Threads past the last lane run its sweep and store its words, as the
  // lane's own thread does in the same instruction.
  const int b = min(b0 + l, n_lanes - 1);
  const int last = n_cols - 1;
  const int n_tiles = (n_cols + kWordTile - 1) / kWordTile;
  // The ring holds tiles s - n_groups + 1 .. s + 2 at step s: tile tau's
  // symbol k of lane l at slot(tau) + k * lanes + l, a slot padded by
  // `lanes` words so that the four groups of a warp read distinct banks.
  const int ring_n = n_groups + 2, slot_words = (kWordTile + 1) * lanes;
  int32_t* ring = reinterpret_cast<int32_t*>(dyn);
  const int rw = s1 * nw;
  if (staged) {
    uint32_t* rows = dyn + ring_n * slot_words;
    const int n = min(lanes, n_lanes - b0) * rw;
    const uint32_t* src = peq + (size_t)b0 * rw;
    for (int i = threadIdx.x; i < n; i += blockDim.x) rows[i] = src[i];
  }
  const uint32_t* prof = staged ? dyn + ring_n * slot_words + (b - b0) * rw
                                : peq + (size_t)b * rw;
  // Tile tau's symbols of the block's lanes into ring slot `slot`, 16
  // consecutive threads on one lane's tile, as one commit group (empty
  // past the row).
  const auto fetch = [&](int tau, int slot) {
    if (tau < n_tiles)
      for (int i = threadIdx.x; i < kWordTile * lanes; i += blockDim.x) {
        const int li = i / kWordTile, k = i % kWordTile;
        cp_async4(ring + slot * slot_words + k * lanes + li,
                  targets + (size_t)min(b0 + li, n_lanes - 1) * n_cols +
                      min(kWordTile * tau + k, last));
      }
    cp_async_commit();
  };
  fetch(0, 0);
  fetch(1, 1);
  cp_async_wait<1>();
  __syncthreads();
  const int w0 = g * K;
  const int n_words = min(K, nw - w0);  // this group's words
  const int n_steps = n_tiles + n_groups - 1;
  const uint32_t L = n_lanes;
  const uint32_t col = nw * L;  // a column's words (16 of them fit 32
                                // bits: the launch checks)
  uint32_t pv[K], mv[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    pv[i] = ~0u;
    mv[i] = 0u;
  }
  int fetch_slot = 2 % ring_n;                // tile s + 2's slot
  int slot = (ring_n - g % ring_n) % ring_n;  // tile s - g's slot
  for (int s = 0; s < n_steps; ++s) {
    fetch(s + 2, fetch_slot);
    fetch_slot = fetch_slot + 1 == ring_n ? 0 : fetch_slot + 1;
    const int tau = s - g;
    const uint32_t y = g > 0 ? link[s & 1][threadIdx.x - lanes] : 0u;
    const uint32_t hp_in = g > 0 ? y & kMask : (hin_pos ? kMask : 0u);
    const uint32_t hn_in = g > 0 ? y >> kWordTile : 0u;
    uint32_t o_p = 0u, o_n = 0u;
    if (tau >= 0 && tau < n_tiles) {
      // The tile's symbols, and with 1-2 words a group their Eq words, in
      // registers before any column's stores.
      const int32_t* ts = ring + slot * slot_words + l;
      int32_t sym[kWordTile];
      uint32_t pre[kWordTile][kPre];
#pragma unroll
      for (int k = 0; k < kWordTile; ++k) {
        sym[k] = ts[k * lanes];
        if constexpr (K <= 2) {
#pragma unroll
          for (int i = 0; i < K; ++i)
            pre[k][i] = prof[sym[k] * nw + min(w0 + i, nw - 1)];
        }
      }
      const int c0 = kWordTile * tau;
      const size_t at = (size_t)c0 * col + (size_t)w0 * L + b;
      uint32_t* const q[4] = {pvo + at, mvo + at, pho + at, mho + at};
      if (c0 + kWordTile <= n_cols) {
#pragma unroll
        for (int k = 0; k < kWordTile; ++k) {
          uint32_t e[K];
          capture_eq<K>(e, pre[k], prof, sym[k], nw, w0);
          capture_column<K, WANT_H>(pv, mv, e, n_words, (hn_in >> k) & 1u,
                                    (hp_in >> k) & 1u, q, k * col, L, o_p,
                                    o_n);
        }
      } else {  // the row's last, ragged tile
#pragma unroll
        for (int k = 0; k < kWordTile; ++k) {
          if (c0 + k <= last) {
            uint32_t e[K];
            capture_eq<K>(e, pre[k], prof, sym[k], nw, w0);
            capture_column<K, WANT_H>(pv, mv, e, n_words,
                                      (hn_in >> k) & 1u, (hp_in >> k) & 1u,
                                      q, k * col, L, o_p, o_n);
          } else {  // past the row: no delta
            o_p <<= 1;
            o_n <<= 1;
          }
        }
      }
      o_p = __brev(o_p) >> kWordTile;  // bit k: column c0 + k
      o_n = __brev(o_n) >> kWordTile;
    }
    link[(s + 1) & 1][threadIdx.x] = (o_n << kWordTile) | o_p;
    slot = slot + 1 == ring_n ? 0 : slot + 1;
    cp_async_wait<1>();
    __syncthreads();
  }
  cp_async_wait<0>();
}

// The read-back form, one thread a lane: windows past the word groups'
// 512 words.  The previous column's state is read back from the lane's
// own pv/mv output (no scratch).
template <bool WANT_H>
__global__ void __launch_bounds__(kThreads)
capture_kernel(const uint32_t* __restrict__ peq, int s1, int nw,
               const int32_t* __restrict__ targets, int n_cols, int n_lanes,
               uint32_t hin_pos, uint32_t* pvo, uint32_t* mvo, uint32_t* pho,
               uint32_t* mho) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const uint32_t* prof = peq + (size_t)lane * s1 * nw;
  const int32_t* tg = targets + (size_t)lane * n_cols;
  const size_t L = n_lanes;
  for (int c = 0; c < n_cols; ++c) {
    const uint32_t* row = prof + (size_t)tg[c] * nw;
    const size_t o = (size_t)c * nw * L + lane;
    uint32_t hneg = 0u, hpos = hin_pos, ph, mh;
    for (int w = 0; w < nw; ++w) {
      const size_t at = o + w * L;
      uint32_t p = c ? pvo[at - nw * L] : ~0u;
      uint32_t m = c ? mvo[at - nw * L] : 0u;
      advance_word_h(p, m, row[w], hneg, hpos, ph, mh);
      pvo[at] = p;
      mvo[at] = m;
      if constexpr (WANT_H) {
        pho[at] = ph;
        mho[at] = mh;
      }
    }
  }
}

// The value-adaptive banded reduce (myers_hw_adaptive), replacing
// pallas_kernel._hw_adaptive_kernel (:1469).  Each 1,024-lane tile of the
// TPU kernel shares one live word band [0, whi): the TPU kernel's jnp.min
// reduces over its whole (8, 128) tile, so its raw outputs (overestimates
// above k included) are those of 1,024 lanes in lockstep.  Every `group`
// columns the band moves by the reference's rules at group granularity
// (edlib.cpp:601-642, see pallas_kernel.py:1374-1430): shrink to the last
// word whose tile-wide min bottom - keff is below 32 + group, grow past the
// last live word while its min is within group, and every strong_every
// groups an exact min-cell strong reduce; whi rounds up to a width class,
// and rejoining words restart on the ramp below the last live word.  keff =
// min(k, the lane's best so far).  The columns of a lane are scored only
// while the band reaches the bottom word.
//
// What bounds it: integer issue, 13 operations a live word-column, as the
// per-lane sweeps.  The band leaves one kind of parallelism: a tile's lanes,
// independent between group boundaries, where they need one reduction.  A
// lane's columns cannot be split (the band at a boundary depends on every
// column before it) and its words cannot be lagged as in the word-parallel
// lane (the decision at column c1 needs every live word's bottom at c1).
// So a tile is 32 warps, and a launch of a few tiles in one block each
// leaves most SMs idle.
//
// The design (hw_adaptive_cluster_kernel): a tile's 1,024 lanes over a
// thread-block cluster of C blocks (16, 8, 4, 2 or 1, the largest the card
// admits: cuda_kernel.adaptive_plan and myers_hw_adaptive_clusters), one
// thread a lane, cluster rank r holding lanes [r * 1024 / C, (r + 1) * 1024
// / C) of its tile, so T tiles run on T * C SMs.  A lane's Pv, Mv and bottom
// score live in registers, the kernel templated on a word capacity NWC of
// 1-32 and its word loop unrolled to NWC, guarded by the band a block of
// kAdaptiveBlock words at a time (whi is the same for every thread of the
// tile, so no guard diverges; dead words past the band cost nothing beyond
// their block); past 32 words, or where the card admits no cluster of the
// register form, NWC = 0 keeps them in global scratch, (tile, plane, word,
// lane).  The block's profile rows are staged once in shared memory,
// lane-minor ([symbol][word][lane], so a warp's Eq read is 32 consecutive
// words, free of bank conflicts) where they fit the block's budget, else
// read from global memory (EqRows either way), a column's words loaded
// before its carry chain starts.  The target's symbols are read directly,
// one column ahead: a shared row is one broadcast line a warp, a per-lane
// row each lane's own line.  At a group boundary each warp reduces bottom -
// keff (and on strong groups the exact min cell) with __reduce_min_sync for
// each live word, lane i keeping word i's, and merges them into its block's
// minima with one shared-memory atomicMin a lane; one cluster barrier
// publishes them; then every warp reads the C blocks' minima through
// distributed shared memory and takes the same decision (integer minima are
// exact, so every block agrees).  The minima rotate over three buffers: a block resets
// the buffer of the next barrier before it arrives at this one, which no
// block may still read by then, so one barrier a group suffices (one a pass
// of kAdaptivePassWords words, past that width).
// A cluster barrier at the start publishes the tile's last column, and one
// at the end keeps every block until no other reads its shared memory.
constexpr int kTile = 1024;
constexpr int kAdaptiveMaxClasses = 32;
// Words whose minima a barrier publishes: a band wider than this takes a
// barrier for every kAdaptivePassWords of it.
constexpr int kAdaptivePassWords = 2048;
// A block's shared memory on the H100 (the opt-in maximum); the planner's
// budget (cuda_kernel._ADAPTIVE_SMEM).
constexpr int kAdaptiveSmemMax = 232448;

// Exact minimum cell value of one word from its bit deltas
// (pallas_kernel._min_cells_exact): the bottom minus the largest suffix sum
// of (Pv bit - Mv bit) taken from bit 31 down to bit 0, the empty suffix
// included.  A rolled loop: it runs once every strong_every groups, and
// unrolled for each of 32 words it would swell the kernel's code.
__device__ __forceinline__ int32_t min_cells_exact(uint32_t pv, uint32_t mv,
                                                   int32_t bottom) {
  int32_t total = 0, best = 0;
#pragma unroll 1
  for (int i = 31; i >= 0; --i) {
    total += static_cast<int32_t>((pv >> i) & 1u) -
             static_cast<int32_t>((mv >> i) & 1u);
    best = max(best, total);
  }
  return bottom - best;
}

// The smallest width class >= raw (classes ascending, the last = nw).
__device__ __forceinline__ int class_at_least(const int32_t* classes,
                                              int n_classes, int raw) {
  for (int i = 0; i + 1 < n_classes; ++i)
    if (raw <= classes[i]) return classes[i];
  return classes[n_classes - 1];
}

// The band's parameters and the launch's plan (cuda_kernel.adaptive_plan):
// C blocks of `lanes` threads a tile, the profile rows staged or not.
struct AdaptiveArgs {
  int k, group, strong_every, n_classes;
  const int32_t* classes;
  long long* live;  // (tiles,) or null
  int cluster, lanes, staged;
};

// A lane's words in registers (NWC of them, indexed only by unrolled
// constants) ...
template <int NWC>
struct RegWords {
  uint32_t p[NWC], m[NWC];
  int32_t s[NWC];
  __device__ __forceinline__ uint32_t& pv(int w) { return p[w]; }
  __device__ __forceinline__ uint32_t& mv(int w) { return m[w]; }
  __device__ __forceinline__ int32_t& sw(int w) { return s[w]; }
};

// ... or in global scratch, a tile's planes (Pv, Mv, bottom) of nw words of
// 1,024 lanes each, so a warp's access is one 128-byte line.
struct ScratchWords {
  uint32_t* base;  // this lane's Pv word 0
  int nw;
  __device__ __forceinline__ uint32_t& pv(int w) {
    return base[(size_t)w * kTile];
  }
  __device__ __forceinline__ uint32_t& mv(int w) {
    return base[(size_t)(nw + w) * kTile];
  }
  __device__ __forceinline__ int32_t& sw(int w) {
    return reinterpret_cast<int32_t&>(base[(size_t)(2 * nw + w) * kTile]);
  }
};

template <int NWC>
struct AdaptiveWordsOf {
  using type = RegWords<NWC>;
};
template <>
struct AdaptiveWordsOf<0> {
  using type = ScratchWords;
};

// Words of a pass: min(nw, kAdaptivePassWords).
__host__ __device__ inline int adaptive_pass_words(int nw) {
  return nw < kAdaptivePassWords ? nw : kAdaptivePassWords;
}

// Dynamic shared memory of a launch (int32 words): the minima, 3 buffers x
// (bottom, min cell) x a pass's words, then the staged profile rows, s1 x
// nw x lanes.
__host__ __device__ inline size_t adaptive_smem_words(int s1, int nw,
                                                      int lanes, int staged) {
  return (size_t)6 * adaptive_pass_words(nw) +
         (staged ? (size_t)s1 * nw * lanes : 0);
}

// Words the register form sweeps under one guard: the band's guard is a
// uniform branch, and every branch ends a block the compiler schedules on
// its own, so a word a guard serialises the words' carry chains.  Words
// past the band are swept too: their state is stale and never read (a
// rejoining word is reset), and the carry runs from word 0 down, so they
// never reach a live word.
template <int NWC>
constexpr int kAdaptiveBlock = NWC < 4 ? NWC : 4;

// One column of a lane's live words [0, cw) (Pv, Mv and bottoms in st) of
// nw; returns word cw - 1's bottom.  The register form loads the column's
// Eq words before the carry chain starts (words past nw read word nw - 1's),
// so that no load waits inside it.
template <int NWC, class Words>
__device__ __forceinline__ int32_t adaptive_column(Words& st, const EqRows& eq,
                                                   int32_t sym, int cw, int nw,
                                                   uint32_t hin_pos) {
  uint32_t hneg = 0u, hpos = hin_pos;
  int32_t bottom = 0;
  if constexpr (NWC > 0) {
    constexpr int B = kAdaptiveBlock<NWC>;
    uint32_t e[NWC];
#pragma unroll
    for (int w0 = 0; w0 < NWC; w0 += B) {
      if (w0 < cw) {
#pragma unroll
        for (int w = w0; w < w0 + B; ++w) e[w] = eq.word(sym, min(w, nw - 1));
      }
    }
#pragma unroll
    for (int w0 = 0; w0 < NWC; w0 += B) {
      if (w0 < cw) {
#pragma unroll
        for (int w = w0; w < w0 + B; ++w) {
          advance_word(st.pv(w), st.mv(w), e[w], hneg, hpos);
          const int32_t s = st.sw(w) + static_cast<int32_t>(hpos) -
                            static_cast<int32_t>(hneg);
          st.sw(w) = s;
          if (w == cw - 1) bottom = s;
        }
      }
    }
  } else {
    for (int w = 0; w < cw; ++w) {
      uint32_t p = st.pv(w), m = st.mv(w);
      advance_word(p, m, eq.word(sym, w), hneg, hpos);
      st.pv(w) = p;
      st.mv(w) = m;
      bottom = st.sw(w) + static_cast<int32_t>(hpos) -
               static_cast<int32_t>(hneg);
      st.sw(w) = bottom;
    }
  }
  return bottom;
}

template <int NWC>
__global__ void hw_adaptive_cluster_kernel(const uint32_t* __restrict__ peq,
                                           int s1, int nw, LaneArgs a,
                                           AdaptiveArgs ad) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint32_t dyn[];  // minima, profile rows
  __shared__ int32_t classes[kAdaptiveMaxClasses];
  __shared__ int32_t warp_end[32];
  __shared__ int32_t block_end;
  const int L = ad.lanes, C = ad.cluster;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / C;
  const int lane = tile * kTile + rank * L + tid;
  const int W = adaptive_pass_words(nw);
  int32_t* mins = reinterpret_cast<int32_t*>(dyn);  // [3][2][W]
  if (tid < ad.n_classes) classes[tid] = ad.classes[tid];
  for (int i = tid; i < 6 * W; i += L) mins[i] = INT_MAX;
  const int lo = a.lo[lane], hi = a.hi[lane];
  // The tile's last column: the furthest window end of its lanes.
  const int e = __reduce_max_sync(~0u, min(hi, a.n_cols));
  if (wl == 0) warp_end[warp] = e;
  // This lane's profile rows, staged lane-minor where the plan says so.
  const int rw = s1 * nw;
  const uint32_t* prof = peq + (size_t)a.prow[lane] * rw;
  EqRows eq{prof, nw, 1};
  if (ad.staged) {
    uint32_t* rows = dyn + 6 * W;
    for (int j = 0; j < rw; ++j) rows[j * L + tid] = prof[j];
    eq = EqRows{rows + tid, nw * L, L};
  }
  typename AdaptiveWordsOf<NWC>::type st;
  if constexpr (NWC == 0)
    st = ScratchWords{a.scratch + (size_t)tile * 3 * nw * kTile + rank * L +
                          tid,
                      nw};
#pragma unroll
  for (int w = 0; w < (NWC ? NWC : nw); ++w) {
    st.pv(w) = ~0u;
    st.mv(w) = 0u;
    st.sw(w) = 32 * (w + 1);
  }
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int i = 0; i < L / 32; ++i) m = max(m, warp_end[i]);
    block_end = m;
  }
  cluster.sync();
  int end = 0;
  for (int r = 0; r < C; ++r)
    end = max(end, *cluster.map_shared_rank(&block_end, r));
  const int32_t* tg = a.targets + (size_t)a.trow[lane] * a.n_cols;
  int32_t rb = kBig, rpf = -1, rpl = -1;
  // Initial band: ceil((k+1)/32) words (edlib.cpp:562), up to a class.
  int whi = class_at_least(classes, ad.n_classes,
                           min(max((ad.k + 32) / 32, 1), nw));
  long long live = 0;  // word-columns the tile swept
  int q = 0;           // barriers of the minima so far
  int32_t sym = end > 0 ? tg[0] : 0;
  for (int g = 0, c0 = 0; c0 < end; ++g, c0 += ad.group) {
    const int cw = whi;
    const int c1 = min(c0 + ad.group, end);
    live += (long long)cw * (c1 - c0);
    int32_t bottom = 0;  // word cw - 1's bottom
    for (int c = c0; c < c1; ++c) {
      const int32_t next = c + 1 < end ? tg[c + 1] : 0;
      bottom = adaptive_column<NWC>(st, eq, sym, cw, nw, a.hin_pos);
      if (cw == nw && c >= lo && c < hi) {
        if (bottom <= rb) rpl = c;
        if (bottom < rb) {
          rb = bottom;
          rpf = c;
        }
      }
      sym = next;
    }
    if (c1 >= end) break;
    // The band for the next group, from the tile-wide minima of the live
    // words (dead words' state is stale and never read), a pass of W words
    // a barrier: this block's warps merge theirs into buffer q % 3 (lane i
    // of a warp the min of word cb + i, so one atomicMin a lane merges 32
    // words) and reset the next barrier's.  Then every warp reads the C
    // blocks' minima and takes the same decision: keep_hi (kh) the last
    // word past 0 whose min (min cell) keeps it, mlast word whi - 1's min.
    // Guards go by blocks of words, as in the sweep.
    const int32_t keff = min(ad.k, rb);
    const bool strong =
        ad.strong_every > 0 && (g + 1) % ad.strong_every == 0;
    int keep_hi = 1, kh = 1;
    int32_t mlast = 0;
    for (int pb = 0; pb < whi; pb += W, ++q) {
      const int pe = min(whi, pb + W);
      int32_t* buf = mins + (q % 3) * 2 * W;
      int32_t* next_buf = mins + ((q + 1) % 3) * 2 * W;
      for (int cb = pb; cb < pe; cb += 32) {
        const int ce = min(cb + 32, pe);
        int32_t mine = INT_MAX, mine_cell = INT_MAX;
        if constexpr (NWC > 0) {
          constexpr int B = kAdaptiveBlock<NWC>;
#pragma unroll
          for (int w0 = 0; w0 < NWC; w0 += B) {
            if (w0 < ce) {
#pragma unroll
              for (int w = w0; w < w0 + B; ++w) {
                const int32_t v = __reduce_min_sync(~0u, st.sw(w) - keff);
                if (wl == w) mine = v;
              }
            }
          }
          if (strong) {
#pragma unroll
            for (int w0 = 0; w0 < NWC; w0 += B) {
              if (w0 < ce) {
#pragma unroll
                for (int w = w0; w < w0 + B; ++w) {
                  const int32_t v = __reduce_min_sync(
                      ~0u,
                      min_cells_exact(st.pv(w), st.mv(w), st.sw(w)) - keff);
                  if (wl == w && w > 0) mine_cell = v;
                }
              }
            }
          }
        } else {
          for (int w = cb; w < ce; ++w) {
            const int32_t v = __reduce_min_sync(~0u, st.sw(w) - keff);
            if (wl == w - cb) mine = v;
            if (strong && w > 0) {
              const int32_t mc = __reduce_min_sync(
                  ~0u, min_cells_exact(st.pv(w), st.mv(w), st.sw(w)) - keff);
              if (wl == w - cb) mine_cell = mc;
            }
          }
        }
        if (cb + wl < ce) {
          atomicMin(buf + cb + wl - pb, mine);
          if (strong) atomicMin(buf + W + cb + wl - pb, mine_cell);
        }
      }
      for (int i = tid; i < 2 * W; i += L) next_buf[i] = INT_MAX;
      cluster.sync();
      for (int base = pb; base < pe; base += 32) {
        // Every lane reads (a word past pe reads word pe - 1, masked out).
        const int t = base + wl, at = min(t, pe - 1) - pb;
        int32_t m = INT_MAX, mc = INT_MAX;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int32_t* rm =
              cluster.map_shared_rank(buf, r < C ? r : 0);
          m = min(m, rm[at]);
          if (strong) mc = min(mc, rm[W + at]);
        }
        const unsigned keep =
            __ballot_sync(~0u, t >= 1 && t < pe && m < 32 + ad.group);
        if (keep) keep_hi = base + 32 - __clz(keep);
        const unsigned skeep = __ballot_sync(
            ~0u, strong && t >= 1 && t < pe && mc <= ad.group);
        if (skeep) kh = base + 32 - __clz(skeep);
        if (whi - 1 - base < 32) mlast = __shfl_sync(~0u, m, whi - 1 - base);
      }
    }
    const bool grow = mlast <= ad.group;
    const int grown =
        min(nw, whi + (grow ? (ad.group - mlast) / 32 + 1 : 0));
    int raw = grow ? grown : keep_hi;
    if (strong) raw = min(raw, max(kh, grow ? grown : 1));
    const int whi_new = class_at_least(classes, ad.n_classes, raw);
    if (whi_new > whi) {
      // Rejoining words restart on the ramp below the last live word (an
      // upper bound, edlib.cpp:606-608); word whi - 1's bottom is the last
      // column's.  Selects, not branches, in the register form.
#pragma unroll
      for (int w = NWC ? 0 : whi; w < (NWC ? NWC : whi_new); ++w) {
        const bool rejoin = w >= whi && w < whi_new;
        st.pv(w) = rejoin ? ~0u : st.pv(w);
        st.mv(w) = rejoin ? 0u : st.mv(w);
        st.sw(w) = rejoin ? bottom + 32 * (w - whi + 1) : st.sw(w);
      }
    }
    whi = whi_new;
  }
  a.best[lane] = rb;
  a.pfirst[lane] = rpf;
  a.plast[lane] = rpl;
  if (ad.live && rank == 0 && tid == 0) ad.live[tile] = live;
  cluster.sync();
}

using AdaptiveKernel = void (*)(const uint32_t*, int, int, LaneArgs,
                                AdaptiveArgs);

// A launch of the adaptive reduce by its plan.
struct AdaptiveLaunch {
  AdaptiveKernel kernel = nullptr;
  int cluster = 0, lanes = 0, staged = 0;
  size_t smem = 0;  // bytes
};

// plan int32 (5,) as cuda_kernel.adaptive_plan makes it: form (0: registers,
// 1: scratch), C, lanes a block, whether the profile rows are staged, NWC
// (0 in the scratch form).  kernel = nullptr where it is not a plan for nw
// words and s1 profile rows.
AdaptiveLaunch adaptive_launch(const void* plan, int s1, int nw) {
  AdaptiveLaunch l;
  if (plan == nullptr) return l;
  const int32_t* p = static_cast<const int32_t*>(plan);
  const int form = p[0], nwc = p[4];
  l.cluster = p[1];
  l.lanes = p[2];
  l.staged = p[3];
  if ((l.cluster & (l.cluster - 1)) || l.cluster < 1 || l.cluster > 16 ||
      l.lanes * l.cluster != kTile || (l.staged != 0 && l.staged != 1) ||
      (form == 1 ? nwc != 0 : form != 0 || nwc < nw))
    return l;
  l.smem = adaptive_smem_words(s1, nw, l.lanes, l.staged) * sizeof(int32_t);
  if (l.smem > (size_t)kAdaptiveSmemMax) return l;
  switch (nwc) {
#define CASE(N)                                  \
  case N:                                        \
    l.kernel = hw_adaptive_cluster_kernel<N>;    \
    break;
    CASE(0) CASE(1) CASE(2) CASE(4) CASE(8) CASE(16) CASE(32)
#undef CASE
  }
  return l;
}

// The cluster launch of `tiles` tiles (C blocks a tile), the kernel's
// attributes set for it: clusters past 8 blocks, shared memory past 48 KB.
cudaError_t adaptive_config(const AdaptiveLaunch& l, int tiles,
                            cudaStream_t st, cudaLaunchConfig_t& cfg,
                            cudaLaunchAttribute& attr) {
  if (l.cluster > 8)
    if (const cudaError_t e = cudaFuncSetAttribute(
            l.kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
      return e;
  if (const cudaError_t e = cudaFuncSetAttribute(
          l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(l.smem)))
    return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(tiles * l.cluster);
  cfg.blockDim = dim3(l.lanes);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = l.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

int blocks_for(int n_lanes) { return (n_lanes + kThreads - 1) / kThreads; }

struct Config {
  int blocks, threads;
};

// Launch shape of a per-lane kernel: kThreads lanes a block, except that
// past 8 words (template word count 0) a lane of kWaveMinWords to
// kWaveWords * kWaveThreads words is a block of its own (the wave form,
// a.wave).
Config lane_config(int nw_template, int nw, LaneArgs& a) {
  a.wave = nw_template == 0 && nw >= kWaveMinWords &&
           nw <= kWaveWords * kWaveThreads;
  if (a.wave) return Config{a.n_lanes, (nw + kWaveWords - 1) / kWaveWords};
  return Config{blocks_for(a.n_lanes), kThreads};
}

LaneArgs lane_args(const void* targets, int n_cols, const void* lo,
                   const void* hi, const void* prow, const void* trow,
                   int n_lanes, int hin0, void* scratch) {
  LaneArgs a{};
  a.targets = static_cast<const int32_t*>(targets);
  a.n_cols = n_cols;
  a.lo = static_cast<const int32_t*>(lo);
  a.hi = static_cast<const int32_t*>(hi);
  a.prow = static_cast<const int32_t*>(prow);
  a.trow = static_cast<const int32_t*>(trow);
  a.n_lanes = n_lanes;
  a.hin_pos = hin0 ? 1u : 0u;
  a.scratch = static_cast<uint32_t*>(scratch);
  return a;
}

void set_reduction(LaneArgs& a, void* best, void* pfirst, void* plast,
                   void* last) {
  a.best = static_cast<int32_t*>(best);
  a.pfirst = static_cast<int32_t*>(pfirst);
  a.plast = static_cast<int32_t*>(plast);
  a.last = static_cast<int32_t*>(last);
}

void set_hits(LaneArgs& a, const void* want, void* hits, int n_out) {
  a.want = static_cast<const int32_t*>(want);
  a.hits = static_cast<int32_t*>(hits);
  a.n_out = n_out;
}

void set_carry(LaneArgs& a, const void* pv0, const void* mv0, const void* s0,
               void* pv1, void* mv1, void* s1) {
  a.pv0 = static_cast<const uint32_t*>(pv0);
  a.mv0 = static_cast<const uint32_t*>(mv0);
  a.s0 = static_cast<const int32_t*>(s0);
  a.pv1 = static_cast<uint32_t*>(pv1);
  a.mv1 = static_cast<uint32_t*>(mv1);
  a.s1 = static_cast<int32_t*>(s1);
}

}  // namespace

// Word counts 1-8 get register-resident state; any other count takes the
// generic scratch path (template argument 0).  LANE_LAUNCH launches per-lane
// kernel K<N> in lane_config's shape; its arguments include `a`.
#define LANE_LAUNCH(N, K, ...)                              \
  do {                                                      \
    const Config cfg = lane_config(N, nw, a);               \
    K<N><<<cfg.blocks, cfg.threads, 0, st>>>(__VA_ARGS__);  \
  } while (0)

#define MYERS_DISPATCH_NW(nw, LAUNCH) \
  switch (nw) {                       \
    case 1: LAUNCH(1); break;         \
    case 2: LAUNCH(2); break;         \
    case 3: LAUNCH(3); break;         \
    case 4: LAUNCH(4); break;         \
    case 5: LAUNCH(5); break;         \
    case 6: LAUNCH(6); break;         \
    case 7: LAUNCH(7); break;         \
    case 8: LAUNCH(8); break;         \
    default: LAUNCH(0); break;        \
  }

// The split-lane kernels take 1-8 words.
#define MYERS_DISPATCH_SPLIT(nw, LAUNCH) \
  switch (nw) {                          \
    case 1: LAUNCH(1); break;            \
    case 2: LAUNCH(2); break;            \
    case 3: LAUNCH(3); break;            \
    case 4: LAUNCH(4); break;            \
    case 5: LAUNCH(5); break;            \
    case 6: LAUNCH(6); break;            \
    case 7: LAUNCH(7); break;            \
    default: LAUNCH(8); break;           \
  }

// Band windows are 1, 2 or a multiple of 4 words wide
// (pallas_kernel._WIN_ROUND), or the whole profile: these widths get
// register-resident windows, any other the scratch path.
#define MYERS_DISPATCH_WIN(n_win, LAUNCH) \
  switch (n_win) {                        \
    case 1: LAUNCH(1); break;             \
    case 2: LAUNCH(2); break;             \
    case 4: LAUNCH(4); break;             \
    case 8: LAUNCH(8); break;             \
    case 12: LAUNCH(12); break;           \
    case 16: LAUNCH(16); break;           \
    default: LAUNCH(0); break;            \
  }

namespace {

// Launch shape of a split-lane kernel: the largest block (of 32, 64 or
// kSplitMaxThreads threads) that still gives every SM two blocks, so that a
// launch of few threads spreads over the SMs; and the profile words its
// shared memory holds after the threads' rings of ring_words words (whole
// rows of s1 * nw words, at most one a thread, or one a lane_threads
// threads: the word-parallel lane's segment).
// With whole_words (K3's staged planes) every row a block can hold, one a
// thread, also gets that many words: the block drops to fewer threads
// until they fit the budget, and past it at 32 threads takes the words
// anyway (the launch raises where the card's shared memory cannot).
struct SplitConfig {
  unsigned blocks;
  int threads, peq_words;
  size_t smem;
};

// Threads a block: the largest of 32, 64 and kSplitMaxThreads that still
// gives every SM two blocks.
int fill_threads(int device, long long n_threads) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int t = kSplitMaxThreads;
  while (t > 32 && n_threads < 2LL * sms * t) t /= 2;
  return t;
}

SplitConfig split_config(int device, long long n_threads, int max_rows,
                         int row_words, int budget = kPeqSmemWords,
                         int whole_words = 0, int lane_threads = 1,
                         int ring_words = kRingWords) {
  int t = fill_threads(device, n_threads);
  while (t > 32 && std::min(t, max_rows) * whole_words > budget) t /= 2;
  const int rows =
      std::min({t / lane_threads, max_rows, budget / row_words});
  SplitConfig c;
  c.blocks = static_cast<unsigned>((n_threads + t - 1) / t);
  c.threads = t;
  c.peq_words = std::max(rows * row_words,
                         std::min(t, max_rows) * whole_words);
  c.smem = (size_t)(t * ring_words + c.peq_words) * sizeof(uint32_t);
  return c;
}

// The word-parallel lane's launch shape: a segment of word_width(nw)
// threads a lane, blocks by split_config, no rings.
SplitConfig words_config(int device, int n_lanes, int s1, int nw) {
  const int width = word_width(nw);
  return split_config(device, (long long)n_lanes * width, n_lanes, s1 * nw,
                      kPeqSmemWords, 0, width, 0);
}

// The word-parallel lane in the shape cfg (words_config; every lane of `a`
// sweeps all n_cols columns); STREAM: the score stream into out.
template <int NW, bool STREAM>
int launch_words(const SplitConfig& cfg, const uint32_t* peq, int s1,
                 const LaneArgs& a, int32_t* out, cudaStream_t st) {
  const SplitArgs sp{nullptr, 0, 0, cfg.peq_words, word_threads<NW>()};
  words_kernel<NW, STREAM><<<cfg.blocks, cfg.threads, cfg.smem, st>>>(
      peq, s1, a, sp, out);
  return static_cast<int>(cudaGetLastError());
}

// What a call of myers_sweep_scores or myers_reduce_resume launches, as
// the entry reports it (kPlanFields int64 words, in this order): the form,
// the blocks and threads a block of its (first) launch, and the form's own
// figures.
enum PlanForm {
  kFormThread = 0,     // a thread a lane
  kFormWords = 1,      // the word-parallel lane
  kFormGroups = 2,     // warp groups
  kFormCores = 3,      // the split-lane cores
  kFormWave = 4,       // a block a lane (sweep_wave)
  kFormLaneWords = 5,  // word groups over lanes (capture_words_kernel)
  kFormBand = 6,       // the word-parallel band (band_lane)
};
constexpr int kPlanFields = 10;

// The lane words form reports its lanes a block in width's place and its
// words a group in cores' (cuda_kernel._PLAN_FORM_KEYS reads them so).
struct LaunchPlan {
  long long form = kFormThread, blocks = 0, threads = 0;
  long long width = 0;             // words, band: threads a lane's segment
  long long cores = 0, core = 0;   // reduce: cores a lane, their columns
  long long groups = 0, ring = 0;  // groups: a lane's groups, ring tiles,
  long long passes = 0, pass_groups = 0;  // launches, groups a launch

  void write(void* out) const {
    if (out == nullptr) return;
    const long long v[kPlanFields] = {form,  blocks, threads, width,
                                      cores, core,   groups,  ring,
                                      passes, pass_groups};
    std::copy(v, v + kPlanFields, static_cast<long long*>(out));
  }
};

// #6, #7 and #8 (launch_banded's kinds 0, 1 and 2) on the word-parallel
// band in W = width threads a lane, blocks by split_config (words_config's
// shape), the block's rows staged.
int launch_band_words(int kind, int device, const uint32_t* peq, int s1,
                      const Band& band, const LaneArgs& a, int width,
                      void* plan, cudaStream_t st) {
  if (kind < 0 || kind > 2 || width != band_width(band.n_win) ||
      band.n_win < 2 || band.n_win > kBandMaxWidth ||
      band.chunk % kWordTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitConfig cfg =
      split_config(device, (long long)a.n_lanes * width, a.n_lanes,
                   s1 * band.nw, kPeqSmemWords, 0, width,
                   band_ring_words(width));
  const SplitArgs sp{nullptr, 0, 0, cfg.peq_words, width};
  void (*kernel)(const uint32_t*, int, Band, LaneArgs, SplitArgs) = nullptr;
  switch (width) {
#define LAUNCH(N)                                                \
  case N:                                                        \
    kernel = kind == 0   ? nw_banded_words_kernel<N>             \
             : kind == 1 ? shw_banded_words_kernel<N>            \
                         : shw_banded_hits_words_kernel<N>;      \
    break;
    LAUNCH(2) LAUNCH(4) LAUNCH(8) LAUNCH(16)
#undef LAUNCH
  }
  kernel<<<cfg.blocks, cfg.threads, cfg.smem, st>>>(peq, s1, band, a, sp);
  LaunchPlan lp;
  lp.form = kFormBand;
  lp.blocks = cfg.blocks;
  lp.threads = cfg.threads;
  lp.width = width;
  lp.write(plan);
  return static_cast<int>(cudaGetLastError());
}

// The three banded kernels' common launch.  kind 0: NW (out0 = last);
// 1: SHW reduce (out0..2 = best, pfirst, plast); 2: SHW hits.  width: the
// word-parallel band's threads a lane (band_width(n_win) for n_win
// 2-kBandMaxWidth and a chunk of whole tiles), or 0: a thread a lane.
// plan int64 (kPlanFields,), or null: what the call launched.
int launch_banded(int kind, int device, const void* peq, int s1, int nw,
                  const void* targets, int n_cols, const void* woff,
                  int n_chunks, int chunk, int n_win, const void* lo,
                  const void* hi, const void* prow, const void* trow,
                  int n_lanes, void* out0, void* out1, void* out2,
                  const void* want, void* hits, int n_out, void* scratch,
                  int width, void* plan, void* stream) {
  if (n_lanes <= 0) return 0;
  if (n_win < 1 || n_win > nw || chunk < 1 || n_chunks < 1 ||
      (long long)n_chunks * chunk < n_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  LaneArgs a = lane_args(targets, n_cols, lo, hi, prow, trow, n_lanes, 1,
                         scratch);
  set_reduction(a, out0, out1, out2, out0);
  set_hits(a, want, hits, n_out);
  const Band band{static_cast<const int32_t*>(woff), chunk, n_win, nw};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(peq);
  if (width)
    return launch_band_words(kind, device, p, s1, band, a, width, plan, st);
  const int blocks = blocks_for(n_lanes);
  LaunchPlan lp;
  lp.blocks = blocks;
  lp.threads = kThreads;
  lp.write(plan);
  if (kind == 0) {
#define LAUNCH(N) nw_banded_kernel<N><<<blocks, kThreads, 0, st>>>(p, s1, band, a)
    MYERS_DISPATCH_WIN(n_win, LAUNCH)
#undef LAUNCH
  } else if (kind == 1) {
#define LAUNCH(N) shw_banded_kernel<N><<<blocks, kThreads, 0, st>>>(p, s1, band, a)
    MYERS_DISPATCH_WIN(n_win, LAUNCH)
#undef LAUNCH
  } else {
#define LAUNCH(N) shw_banded_hits_kernel<N><<<blocks, kThreads, 0, st>>>(p, s1, band, a)
    MYERS_DISPATCH_WIN(n_win, LAUNCH)
#undef LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

// #14 as word groups over lanes: `lanes` lanes a block (8, 16 or 32),
// `words` words a group (1-kCapMaxWords, a power of two), as the wrapper
// planned it (cuda_kernel.capture_plan); lanes = 0: the read-back form.
template <bool WANT_H>
int launch_capture(const uint32_t* peq, int s1, int nw, const int32_t* t,
                   int n_cols, int n_lanes, uint32_t hp, int lanes, int words,
                   uint32_t* o_pv, uint32_t* o_mv, uint32_t* o_ph,
                   uint32_t* o_mh, void* plan, cudaStream_t st) {
  LaunchPlan lp;
  if (lanes == 0) {
    lp.blocks = blocks_for(n_lanes);
    lp.threads = kThreads;
    capture_kernel<WANT_H><<<static_cast<unsigned>(lp.blocks), kThreads, 0,
                             st>>>(
        peq, s1, nw, t, n_cols, n_lanes, hp, o_pv, o_mv, o_ph, o_mh);
  } else {
    const int groups = (nw + words - 1) / words;
    if ((lanes != 8 && lanes != 16 && lanes != 32) || words < 1 ||
        words > kCapMaxWords || (words & (words - 1)) != 0 ||
        lanes * groups > kCapMaxThreads ||
        (long long)nw * n_lanes * kWordTile >= (1LL << 32))
      return static_cast<int>(cudaErrorInvalidValue);
    const int rw = s1 * nw;
    const int staged = (long long)lanes * rw <= kCapSmemWords;
    const size_t smem =
        ((size_t)(groups + 2) * (kWordTile + 1) * lanes +
         (staged ? (size_t)lanes * rw : 0)) * sizeof(uint32_t);
    lp.form = kFormLaneWords;
    lp.blocks = (n_lanes + lanes - 1) / lanes;
    lp.threads = lanes * groups;
    lp.width = lanes;
    lp.cores = words;
    switch (words) {
#define LAUNCH(K)                                                      \
  case K:                                                              \
    cudaFuncSetAttribute(capture_words_kernel<K, WANT_H>,              \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                         static_cast<int>(smem));                      \
    capture_words_kernel<K, WANT_H>                                    \
        <<<static_cast<unsigned>(lp.blocks),                           \
           static_cast<unsigned>(lp.threads), smem, st>>>(             \
            peq, s1, nw, t, n_cols, n_lanes, hp, lanes, staged, o_pv,  \
            o_mv, o_ph, o_mh);                                         \
    break;
      LAUNCH(1) LAUNCH(2) LAUNCH(4) LAUNCH(8)
#undef LAUNCH
    }
  }
  lp.write(plan);
  return static_cast<int>(cudaGetLastError());
}

// The shape of one launch of the score stream's groups: the fewest warps
// on the busiest SM (group_geometry), or blocks of kGroupMaxWarps where
// that shape does not fit (a pass as large as group_capacity).
int score_geometry(int device, int n_lanes, int n_groups, int s1, int ring,
                   GroupGeometry* g) {
  if (group_geometry(sweep_scores_groups_kernel, device, n_lanes, n_groups,
                     s1, ring, 0, g) == 0)
    return 0;
  cudaGetLastError();
  return group_geometry(sweep_scores_groups_kernel, device, n_lanes,
                        n_groups, s1, ring, kGroupMaxWarps, g);
}

// A myers_sweep_scores call's plan and the int32 words of scratch it
// takes (its layout in launch_score_groups).
struct ScorePlan {
  LaunchPlan lp;
  SplitConfig words{};
  int n_tiles = 0;
  long long scratch_words = 1;
};

int score_plan(int device, int s1, int nw, int n_cols, int n_lanes,
               int ring, int pass_groups, ScorePlan* q) {
  if (nw < 1 || s1 < 1 || n_lanes < 0 || n_cols < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LaunchPlan& lp = q->lp;
  if (nw >= kWaveMinWords) {
    if (ring < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int G = (nw + kGroup - 1) / kGroup;
    int cap = 0;
    if (const int e = group_capacity(sweep_scores_groups_kernel, device, s1,
                                     ring, &cap))
      return e;
    if (pass_groups > 0) cap = std::min(cap, pass_groups);
    const int P = std::min(G, std::max(cap, 1));
    GroupGeometry geo;
    if (const int e = score_geometry(device, n_lanes, P, s1, ring, &geo))
      return e;
    lp.form = kFormGroups;
    lp.blocks = geo.blocks;
    lp.threads = geo.wpb * 32;
    lp.groups = G;
    lp.ring = ring;
    lp.pass_groups = P;
    lp.passes = (G + P - 1) / P;
    q->n_tiles = (n_cols + nw - 1 + kGroupTile - 1) / kGroupTile;
    const long long links = (long long)n_lanes * P;
    q->scratch_words = links * ring * 4 + links + 1 +
                       (lp.passes > 1 ? 8LL * n_lanes * q->n_tiles : 0);
  } else if (nw >= 2 && nw <= 8) {
    q->words = words_config(device, n_lanes, s1, nw);
    lp.form = kFormWords;
    lp.blocks = q->words.blocks;
    lp.threads = q->words.threads;
    lp.width = word_width(nw);
  } else {
    lp.blocks = blocks_for(n_lanes);
    lp.threads = kThreads;
    if (nw > 8) q->scratch_words = 2LL * nw * n_lanes;
  }
  return 0;
}

// The score stream's groups, pass by pass, in scratch laid out as: with
// more than one pass two buffers of pass records (n_lanes, n_tiles) a
// pass writes and the next reads in turn; then the links of a pass
// (n_lanes, pass_groups, ring), their consumed counts and the task
// counter, zeroed before each launch.
int launch_score_groups(int device, ScoreGroupArgs g, const ScorePlan& q,
                        void* scratch, cudaStream_t st) {
  const int P = static_cast<int>(q.lp.pass_groups);
  const int passes = static_cast<int>(q.lp.passes);
  const size_t recs = (size_t)g.n_lanes * q.n_tiles;
  ulonglong2* buf = static_cast<ulonglong2*>(scratch);
  ulonglong2* const pass_rec[2] = {buf, buf + recs};
  g.links = passes > 1 ? buf + 2 * recs : buf;
  g.n_tiles = q.n_tiles;
  g.g_real = static_cast<int>(q.lp.groups);
  for (int p = 0; p < passes; ++p) {
    g.g_lo = p * P;
    g.n_groups = std::min(P, g.g_real - g.g_lo);
    const size_t links = (size_t)g.n_lanes * g.n_groups;
    g.cons = reinterpret_cast<unsigned*>(g.links + links * g.ring);
    g.next_task = reinterpret_cast<int*>(g.cons + links);
    g.top_in = p > 0 ? pass_rec[(p - 1) & 1] : nullptr;
    g.bottom_out = p + 1 < passes ? pass_rec[p & 1] : nullptr;
    if (const cudaError_t e = cudaMemsetAsync(
            g.links, 0,
            links * g.ring * sizeof(ulonglong2) +
                (links + 1) * sizeof(unsigned),
            st))
      return static_cast<int>(e);
    GroupGeometry geo;
    if (const int e = score_geometry(device, g.n_lanes, g.n_groups, g.s1,
                                     g.ring, &geo))
      return e;
    if (const int e = launch_groups(sweep_scores_groups_kernel, g, geo, st))
      return e;
  }
  return 0;
}

#define MYERS_DISPATCH_WORDS(nw, LAUNCH) \
  switch (nw) {                          \
    case 2: LAUNCH(2); break;            \
    case 3: LAUNCH(3); break;            \
    case 4: LAUNCH(4); break;            \
    case 5: LAUNCH(5); break;            \
    case 6: LAUNCH(6); break;            \
    case 7: LAUNCH(7); break;            \
    default: LAUNCH(8); break;           \
  }

// The eq-stream kernels' launch (#10 the reduce, #11 with hits): at 2-8
// words and n_cols > 0 the word-parallel lane, word_width(nw) threads a
// lane in blocks of fill_threads; else one thread a lane or the wave form.
// plan as LaunchPlan.
int launch_eqstream(bool hits, int device, const uint32_t* q, int nw,
                    LaneArgs& a, void* plan, cudaStream_t st) {
  LaunchPlan lp;
  if (nw >= 2 && nw <= 8 && a.n_cols > 0) {
    const long long n_threads = (long long)a.n_lanes * word_width(nw);
    const int t = fill_threads(device, n_threads);
    lp.form = kFormWords;
    lp.blocks = (n_threads + t - 1) / t;
    lp.threads = t;
    lp.width = word_width(nw);
    lp.write(plan);
    const unsigned blocks = static_cast<unsigned>(lp.blocks);
#define LAUNCH(N)                                                  \
  if (hits)                                                        \
    hits_eqstream_words_kernel<N><<<blocks, t, 0, st>>>(q, a);     \
  else                                                             \
    reduce_eqstream_words_kernel<N><<<blocks, t, 0, st>>>(q, a)
    MYERS_DISPATCH_WORDS(nw, LAUNCH)
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
  }
  LaneArgs probe = a;
  const Config cfg = lane_config(nw > 8 ? 0 : nw, nw, probe);
  lp.form = probe.wave ? kFormWave : kFormThread;
  lp.blocks = cfg.blocks;
  lp.threads = cfg.threads;
  lp.write(plan);
#define LAUNCH(N)                                        \
  if (hits)                                              \
    LANE_LAUNCH(N, hits_eqstream_kernel, q, nw, a);      \
  else                                                   \
    LANE_LAUNCH(N, reduce_eqstream_kernel, q, nw, a)
  MYERS_DISPATCH_NW(nw, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry point takes the CUDA device of its operands first (the
// library's runtime keeps its own current device) and the stream last.
//
// peq uint32 (R_p, s1, nw); targets int32 (R_t, n_cols), 16-byte aligned;
// lo, hi, prow, trow int32 (n_lanes,).  Outputs over scan columns [lo, hi):
// key_first, key_last uint64 (n_lanes,) (first_key(best, pfirst) and
// last_key(best, plast), started by the caller at first_key(kBig, -1) and
// last_key(kBig, -1)) and last int32 (n_lanes,) (the score at hi - 1,
// started at kBig).  At 1-8 words the split-lane schedule: offsets int32
// (n_lanes + 1,) each lane's first thread (an exclusive prefix sum of its
// core count, the total last) or null for one core a lane, n_threads >= the
// total, core columns a core, halo columns before it (hin0 = 0).  Past 8
// words offsets, n_threads, core and halo are not read and scratch holds
// 2 * nw * n_lanes words.
int myers_reduce_lanes(int device, const void* peq, int s1, int nw,
                       const void* targets, int n_cols, const void* lo,
                       const void* hi, const void* prow, const void* trow,
                       int n_lanes, int hin0, const void* offsets,
                       long long n_threads, int core, int halo,
                       void* key_first, void* key_last, void* last,
                       void* scratch, void* stream) {
  if (n_lanes <= 0) return 0;
  if (nw < 1 || s1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  LaneArgs a = lane_args(targets, n_cols, lo, hi, prow, trow, n_lanes, hin0,
                         scratch);
  a.key_first = static_cast<unsigned long long*>(key_first);
  a.key_last = static_cast<unsigned long long*>(key_last);
  a.last = static_cast<int32_t*>(last);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(peq);
  if (nw > 8) {
    LANE_LAUNCH(0, reduce_lanes_kernel, p, s1, nw, a);
    return static_cast<int>(cudaGetLastError());
  }
  if (n_threads <= 0) return 0;
  if (core < 1 || halo < 0) return static_cast<int>(cudaErrorInvalidValue);
  const SplitConfig cfg = split_config(device, n_threads, n_lanes, s1 * nw);
  const SplitArgs sp{static_cast<const int32_t*>(offsets), core, halo,
                     cfg.peq_words};
#define LAUNCH(N)                                                  \
  reduce_split_kernel<N><<<cfg.blocks, cfg.threads, cfg.smem, st>>>( \
      p, s1, a, sp)
  MYERS_DISPATCH_SPLIT(nw, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// planes uint32 (R_p, n_alts * nb * nw); pad uint32 (R_p, nw); wildcard:
// the target symbol that matches every row; targets in [0, 2^nb).  The rest
// as myers_reduce_lanes, split-lane at 1-8 words.
int myers_reduce_bitplane(int device, const void* planes, const void* pad,
                          int nw, int nb, int n_alts, int wildcard,
                          const void* targets, int n_cols, const void* lo,
                          const void* hi, const void* prow, const void* trow,
                          int n_lanes, int hin0, const void* offsets,
                          long long n_threads, int core, int halo,
                          void* key_first, void* key_last, void* last,
                          void* scratch, void* stream) {
  if (n_lanes <= 0) return 0;
  if (nw < 1 || n_alts < 1 || nb < 1 || nb > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  LaneArgs a = lane_args(targets, n_cols, lo, hi, prow, trow, n_lanes, hin0,
                         scratch);
  a.key_first = static_cast<unsigned long long*>(key_first);
  a.key_last = static_cast<unsigned long long*>(key_last);
  a.last = static_cast<int32_t*>(last);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* pl = static_cast<const uint32_t*>(planes);
  const uint32_t* pd = static_cast<const uint32_t*>(pad);
  if (nw > 8) {
    LANE_LAUNCH(0, reduce_bitplane_kernel, pl, pd, nw, nb, n_alts, wildcard,
                a);
    return static_cast<int>(cudaGetLastError());
  }
  if (n_threads <= 0) return 0;
  if (core < 1 || halo < 0) return static_cast<int>(cudaErrorInvalidValue);
  // Whole rows with their expanded profiles where they fit; the planes of
  // every row a block holds always.
  const int rs = ((n_alts * nb + 1) * nw) | 1;  // the kernel's row stride
  const SplitConfig cfg = split_config(device, n_threads, n_lanes,
                                       (1 << nb) * nw + rs,
                                       kBitplaneSmemWords, rs);
  const SplitArgs sp{static_cast<const int32_t*>(offsets), core, halo,
                     cfg.peq_words};
#define LAUNCH(N)                                                          \
  do {                                                                     \
    if (const cudaError_t e = cudaFuncSetAttribute(                        \
            reduce_bitplane_split_kernel<N>,                               \
            cudaFuncAttributeMaxDynamicSharedMemorySize,                   \
            static_cast<int>(cfg.smem)))                                   \
      return static_cast<int>(e);                                          \
    reduce_bitplane_split_kernel<N><<<cfg.blocks, cfg.threads, cfg.smem,   \
                                      st>>>(pl, pd, nb, n_alts, wildcard,  \
                                            a, sp);                        \
  } while (0)
  MYERS_DISPATCH_SPLIT(nw, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Operands as myers_reduce_lanes plus want int32 (n_lanes,), the best each
// lane marks; hits int32 (n_lanes, n_out), n_out = ceil(n_cols / 32), zeroed
// by the caller.  At 1-8 words and hin0 = 0 with offsets non-null the
// split-lane schedule with word-aligned cores (hits_lanes_split_kernel):
// offsets, n_threads and halo as myers_reduce_lanes, core a multiple of 32
// and each lane's cores counted from its s rounded down to a multiple of
// 32 (ops/cuda_kernel.py hits_core, split_cores with word_aligned).  Else
// (hin0 = 1, past 8 words, lanes shorter than a core: offsets null) one
// thread a lane, or the wave form; offsets, n_threads, core and halo are
// not read.  plan int64 (kPlanFields,), or null: what the call launched
// (LaunchPlan; the split form's cores: n_threads / n_lanes, the most a
// lane has).
int myers_hits_lanes(int device, const void* peq, int s1, int nw,
                     const void* targets, int n_cols, const void* lo,
                     const void* hi, const void* prow, const void* trow,
                     int n_lanes, int hin0, const void* offsets,
                     long long n_threads, int core, int halo,
                     const void* want, void* hits, int n_out, void* scratch,
                     void* plan, void* stream) {
  if (n_lanes <= 0) return 0;
  if (nw < 1 || s1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  LaneArgs a = lane_args(targets, n_cols, lo, hi, prow, trow, n_lanes, hin0,
                         scratch);
  set_hits(a, want, hits, n_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(peq);
  LaunchPlan lp;
  if (offsets == nullptr || nw > 8 || hin0) {
    LaneArgs probe = a;
    const Config cfg = lane_config(nw > 8 ? 0 : nw, nw, probe);
    lp.form = probe.wave ? kFormWave : kFormThread;
    lp.blocks = cfg.blocks;
    lp.threads = cfg.threads;
    lp.write(plan);
#define LAUNCH(N) LANE_LAUNCH(N, hits_lanes_kernel, p, s1, nw, a)
    MYERS_DISPATCH_NW(nw, LAUNCH)
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
  }
  if (n_threads <= 0) {
    lp.write(plan);
    return 0;
  }
  if (core < 32 || core % 32 || halo < 0 || halo % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitConfig cfg = split_config(device, n_threads, n_lanes, s1 * nw);
  lp.form = kFormCores;
  lp.blocks = cfg.blocks;
  lp.threads = cfg.threads;
  lp.cores = (n_threads + n_lanes - 1) / n_lanes;
  lp.core = core;
  lp.write(plan);
  const SplitArgs sp{static_cast<const int32_t*>(offsets), core, halo,
                     cfg.peq_words};
#define LAUNCH(N)                                                       \
  hits_lanes_split_kernel<N><<<cfg.blocks, cfg.threads, cfg.smem, st>>>( \
      p, s1, a, sp)
  MYERS_DISPATCH_SPLIT(nw, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Operands as myers_reduce_bitplane; want and hits as myers_hits_lanes.
// At 1-8 words hits_bitplane_split_kernel: offsets, n_threads, core and
// halo as myers_hits_lanes' split-lane form (at hin0 = 0 core and halo
// multiples of 32 and the word-aligned plan), but null offsets here mean
// one core a lane on the same kernel, thread t lane t (no lane has two
// cores, or hin0 = 1: swept from column 0), as K3 takes them.  Past 8
// words one thread a lane or the wave form; offsets, n_threads, core and
// halo are not read.  plan as myers_hits_lanes.
int myers_hits_bitplane(int device, const void* planes, const void* pad,
                        int nw, int nb, int n_alts, int wildcard,
                        const void* targets, int n_cols, const void* lo,
                        const void* hi, const void* prow, const void* trow,
                        int n_lanes, int hin0, const void* offsets,
                        long long n_threads, int core, int halo,
                        const void* want, void* hits, int n_out,
                        void* scratch, void* plan, void* stream) {
  if (n_lanes <= 0) return 0;
  if (nw < 1 || n_alts < 1 || nb < 1 || nb > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  LaneArgs a = lane_args(targets, n_cols, lo, hi, prow, trow, n_lanes, hin0,
                         scratch);
  set_hits(a, want, hits, n_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* pl = static_cast<const uint32_t*>(planes);
  const uint32_t* pd = static_cast<const uint32_t*>(pad);
  LaunchPlan lp;
  if (nw > 8) {
    LaneArgs probe = a;
    const Config cfg = lane_config(0, nw, probe);
    lp.form = probe.wave ? kFormWave : kFormThread;
    lp.blocks = cfg.blocks;
    lp.threads = cfg.threads;
    lp.write(plan);
    LANE_LAUNCH(0, hits_bitplane_kernel, pl, pd, nw, nb, n_alts, wildcard,
                a);
    return static_cast<int>(cudaGetLastError());
  }
  if (n_threads <= 0) {
    lp.write(plan);
    return 0;
  }
  if (core < 1 || halo < 0 || (!hin0 && (core % 32 || halo % 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  // K3's shape: whole rows with their expanded profiles where they fit,
  // the planes of every row a block holds always.
  const int rs = ((n_alts * nb + 1) * nw) | 1;  // the kernel's row stride
  const SplitConfig cfg = split_config(device, n_threads, n_lanes,
                                       (1 << nb) * nw + rs,
                                       kBitplaneSmemWords, rs);
  lp.form = kFormCores;
  lp.blocks = cfg.blocks;
  lp.threads = cfg.threads;
  lp.cores = (n_threads + n_lanes - 1) / n_lanes;
  lp.core = core;
  lp.write(plan);
  const SplitArgs sp{static_cast<const int32_t*>(offsets), core, halo,
                     cfg.peq_words};
#define LAUNCH(N)                                                          \
  do {                                                                     \
    if (const cudaError_t e = cudaFuncSetAttribute(                        \
            hits_bitplane_split_kernel<N>,                                 \
            cudaFuncAttributeMaxDynamicSharedMemorySize,                   \
            static_cast<int>(cfg.smem)))                                   \
      return static_cast<int>(e);                                          \
    hits_bitplane_split_kernel<N><<<cfg.blocks, cfg.threads, cfg.smem,     \
                                    st>>>(pl, pd, nb, n_alts, wildcard, a, \
                                          sp);                             \
  } while (0)
  MYERS_DISPATCH_SPLIT(nw, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The banded kernels: peq, targets, lo, hi, prow, trow as
// myers_reduce_lanes (hin is +1); woff int32 (n_chunks,) nondecreasing in
// [0, nw - n_win], n_chunks * chunk >= n_cols.  width: the word-parallel
// band's threads a lane (band_width(n_win), for n_win 2-kBandMaxWidth and
// a chunk of whole tiles), or 0: a thread a lane.  plan int64
// (kPlanFields,), or null: what the call launched.
//
// myers_nw_banded: last int32 (n_lanes,), the score at hi-1 (no lo).
int myers_nw_banded(int device, const void* peq, int s1, int nw,
                    const void* targets, int n_cols, const void* woff,
                    int n_chunks, int chunk, int n_win, const void* hi,
                    const void* prow, const void* trow, int n_lanes,
                    void* last, void* scratch, int width, void* plan,
                    void* stream) {
  return launch_banded(0, device, peq, s1, nw, targets, n_cols, woff,
                       n_chunks, chunk, n_win, nullptr, hi, prow, trow,
                       n_lanes, last, nullptr, nullptr, nullptr, nullptr, 0,
                       scratch, width, plan, stream);
}

// myers_shw_banded: best, pfirst, plast int32 (n_lanes,) over [lo, hi).
int myers_shw_banded(int device, const void* peq, int s1, int nw,
                     const void* targets, int n_cols, const void* woff,
                     int n_chunks, int chunk, int n_win, const void* lo,
                     const void* hi, const void* prow, const void* trow,
                     int n_lanes, void* best, void* pfirst, void* plast,
                     void* scratch, int width, void* plan, void* stream) {
  return launch_banded(1, device, peq, s1, nw, targets, n_cols, woff,
                       n_chunks, chunk, n_win, lo, hi, prow, trow, n_lanes,
                       best, pfirst, plast, nullptr, nullptr, 0, scratch,
                       width, plan, stream);
}

// myers_shw_banded_hits: want and hits as myers_hits_lanes, over the
// columns where the window has reached the bottom word.
int myers_shw_banded_hits(int device, const void* peq, int s1, int nw,
                          const void* targets, int n_cols, const void* woff,
                          int n_chunks, int chunk, int n_win, const void* lo,
                          const void* hi, const void* prow, const void* trow,
                          int n_lanes, const void* want, void* hits,
                          int n_out, void* scratch, int width, void* plan,
                          void* stream) {
  return launch_banded(2, device, peq, s1, nw, targets, n_cols, woff,
                       n_chunks, chunk, n_win, lo, hi, prow, trow, n_lanes,
                       nullptr, nullptr, nullptr, want, hits, n_out, scratch,
                       width, plan, stream);
}

// peq uint32 (s1, nw, n_lanes); target int32 (n_cols,), 16-byte aligned;
// key uint64 (n_lanes,): first_key(best, pos) over scan columns
// [col_lo, col_hi), started by the caller at first_key(kBig, -1).  At 1-8
// words the split-lane schedule, n_cores cores of `core` columns a lane
// (halo as myers_reduce_lanes); past 8 words scratch holds 2 * nw * n_lanes
// words.
int myers_sweep_shared(int device, const void* peq, int s1, int nw,
                       int n_lanes, const void* target, int n_cols, int hin0,
                       int col_lo, int col_hi, int n_cores, int core,
                       int halo, void* key, void* scratch, void* stream) {
  if (n_lanes <= 0) return 0;
  if (nw < 1 || s1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(peq);
  const int32_t* t = static_cast<const int32_t*>(target);
  unsigned long long* k = static_cast<unsigned long long*>(key);
  const uint32_t hp = hin0 ? 1u : 0u;
  if (nw > 8) {
    sweep_shared_kernel<<<blocks_for(n_lanes), kThreads, 0, st>>>(
        p, nw, n_lanes, t, n_cols, hp, col_lo, col_hi, k,
        static_cast<uint32_t*>(scratch));
    return static_cast<int>(cudaGetLastError());
  }
  if (n_cores <= 0) return 0;
  if (core < 1 || halo < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_threads = (long long)n_lanes * n_cores;
  const int t_max = static_cast<int>(
      std::min<long long>(kSplitMaxThreads, n_threads));
  const SplitConfig cfg = split_config(
      device, n_threads,
      std::min(n_lanes, (t_max + n_cores - 1) / n_cores + 1), s1 * nw);
  const SplitArgs sp{nullptr, core, halo, cfg.peq_words};
#define LAUNCH(N)                                                        \
  sweep_shared_split_kernel<N><<<cfg.blocks, cfg.threads, cfg.smem, st>>>( \
      p, s1, n_lanes, t, n_cols, hp, col_lo, col_hi, n_cores, sp, k)
  MYERS_DISPATCH_SPLIT(nw, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// peq uint32 (n_lanes, s1, nw); targets int32 (n_lanes, n_cols), symbols in
// [0, s1); pv, mv (and with ph, mh non-null also ph, mh) uint32
// (n_cols, nw, n_lanes): lane b's word w after column c.  hin0 as
// myers_reduce_lanes.  lanes, words: the word groups' shape (lanes a block,
// words a group; cuda_kernel.capture_plan), lanes = 0 for the read-back
// form.  plan int64 (kPlanFields,), or null: what the call launched.
int myers_capture(int device, const void* peq, int s1, int nw,
                  const void* targets, int n_cols, int n_lanes, int hin0,
                  int lanes, int words, void* pv, void* mv, void* ph,
                  void* mh, void* plan, void* stream) {
  if (n_lanes <= 0 || n_cols <= 0) return 0;
  if (nw < 1 || (ph == nullptr) != (mh == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(peq);
  const int32_t* t = static_cast<const int32_t*>(targets);
  uint32_t* o_pv = static_cast<uint32_t*>(pv);
  uint32_t* o_mv = static_cast<uint32_t*>(mv);
  uint32_t* o_ph = static_cast<uint32_t*>(ph);
  uint32_t* o_mh = static_cast<uint32_t*>(mh);
  const uint32_t hp = hin0 ? 1u : 0u;
  if (ph != nullptr)
    return launch_capture<true>(p, s1, nw, t, n_cols, n_lanes, hp, lanes,
                                words, o_pv, o_mv, o_ph, o_mh, plan, st);
  return launch_capture<false>(p, s1, nw, t, n_cols, n_lanes, hp, lanes,
                               words, o_pv, o_mv, o_ph, o_mh, plan, st);
}

// peq, targets, prow, trow as myers_reduce_lanes; every lane sweeps all
// n_cols columns.  out int32 (n_cols, n_lanes): lane b's score after column
// c at c * n_lanes + b.  pv0, mv0 uint32 (n_lanes, nw) and sc0 int32
// (n_lanes,): the carried state to start from (null: a fresh start); pv1,
// mv1, sc1 the same shapes: the state after the last column (null: not
// kept).  pv0/mv0/sc0 and pv1/mv1/sc1 are each all null or all set.  One
// thread a lane at 1 word; the word-parallel lane at 2-8; one thread a
// lane with its state in scratch at 9 to kWaveMinWords - 1; past that
// warp groups, groups = ceil(nw / 32) a lane, each link a ring of `ring`
// tiles, in passes of at most the groups one launch keeps resident
// (pass_groups > 0: at most that many).  scratch: the int32 words that
// myers_sweep_scores_plan gives.  plan int64 (kPlanFields,), or null: what
// the call launched (LaunchPlan).
int myers_sweep_scores(int device, const void* peq, int s1, int nw,
                       const void* targets, int n_cols, const void* prow,
                       const void* trow, int n_lanes, int hin0, void* out,
                       const void* pv0, const void* mv0, const void* sc0,
                       void* pv1, void* mv1, void* sc1, void* scratch,
                       int ring, int pass_groups, void* plan, void* stream) {
  if (n_lanes <= 0 || n_cols <= 0) return 0;
  if (nw < 1 || (pv0 == nullptr) != (mv0 == nullptr) ||
      (pv0 == nullptr) != (sc0 == nullptr) ||
      (pv1 == nullptr) != (mv1 == nullptr) ||
      (pv1 == nullptr) != (sc1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  ScorePlan q;
  if (const int e = score_plan(device, s1, nw, n_cols, n_lanes, ring,
                               pass_groups, &q))
    return e;
  q.lp.write(plan);
  LaneArgs a = lane_args(targets, n_cols, nullptr, nullptr, prow, trow,
                         n_lanes, hin0, scratch);
  set_carry(a, pv0, mv0, sc0, pv1, mv1, sc1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(peq);
  int32_t* o = static_cast<int32_t*>(out);
  if (q.lp.form == kFormGroups) {
    ScoreGroupArgs g{};
    g.peq = p;
    g.s1 = s1;
    g.nw = nw;
    g.targets = a.targets;
    g.n_cols = n_cols;
    g.prow = a.prow;
    g.trow = a.trow;
    g.n_lanes = n_lanes;
    g.hin0 = a.hin_pos;
    g.out = o;
    g.pv0 = a.pv0;
    g.mv0 = a.mv0;
    g.sc0 = a.s0;
    g.pv1 = a.pv1;
    g.mv1 = a.mv1;
    g.sc1 = a.s1;
    g.ring = ring;
    return launch_score_groups(device, g, q, scratch, st);
  }
  if (q.lp.form == kFormWords) {
#define LAUNCH(N) return launch_words<N, true>(q.words, p, s1, a, o, st)
    MYERS_DISPATCH_WORDS(nw, LAUNCH)
#undef LAUNCH
  }
  if (nw == 1)
    LANE_LAUNCH(1, sweep_scores_kernel, p, s1, nw, a, o);
  else
    LANE_LAUNCH(0, sweep_scores_kernel, p, s1, nw, a, o);
  return static_cast<int>(cudaGetLastError());
}

// The plan of a myers_sweep_scores call of these operands (plan, as that
// entry writes it) and the int32 words of scratch it takes.
int myers_sweep_scores_plan(int device, int s1, int nw, int n_cols,
                            int n_lanes, int ring, int pass_groups,
                            void* plan, long long* scratch_words) {
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  ScorePlan q;
  if (const int e = score_plan(device, s1, nw, n_cols, n_lanes, ring,
                               pass_groups, &q))
    return e;
  q.lp.write(plan);
  *scratch_words = q.scratch_words;
  return 0;
}

// The resumable reduce: peq, targets (16-byte aligned), lo, hi, prow, trow
// as myers_reduce_lanes, but every lane sweeps all n_cols columns of its
// row (the reduction still covers [lo, hi) only) from the carried state
// pv0, mv0 uint32 (n_lanes, nw), sc0 int32 (n_lanes,), and writes the state
// after the last column to pv1, mv1, sc1 (the same shapes).  At 1-8 words
// the split-lane schedule: n_cores cores of `core` columns a lane from
// column 0 (halo as myers_reduce_lanes; hin0 = 1 takes one core); one core
// a lane is the word-parallel lane at 2-8 words.  The reduction: with
// n_cores > 1 key_first, key_last and last as myers_reduce_lanes; else
// (and past 8 words, where n_cores, core and halo are not read and scratch
// holds 2 * nw * n_lanes words) best, pfirst, plast, last int32 (n_lanes,),
// written for every lane.  plan int64 (kPlanFields,), or null: what the
// call launched (LaunchPlan).
int myers_reduce_resume(int device, const void* peq, int s1, int nw,
                        const void* targets, int n_cols, const void* lo,
                        const void* hi, const void* prow, const void* trow,
                        int n_lanes, int hin0, const void* pv0,
                        const void* mv0, const void* sc0, int n_cores,
                        int core, int halo, void* key_first, void* key_last,
                        void* best, void* pfirst, void* plast, void* last,
                        void* pv1, void* mv1, void* sc1, void* scratch,
                        void* plan, void* stream) {
  if (n_lanes <= 0 || n_cols <= 0) return 0;
  if (nw < 1 || s1 < 1 || !pv0 || !mv0 || !sc0 || !pv1 || !mv1 || !sc1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  LaneArgs a = lane_args(targets, n_cols, lo, hi, prow, trow, n_lanes, hin0,
                         scratch);
  a.key_first = static_cast<unsigned long long*>(key_first);
  a.key_last = static_cast<unsigned long long*>(key_last);
  set_reduction(a, best, pfirst, plast, last);
  set_carry(a, pv0, mv0, sc0, pv1, mv1, sc1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(peq);
  LaunchPlan lp;
  if (nw > 8) {
    LaneArgs probe = a;
    const Config cfg = lane_config(0, nw, probe);
    lp.form = probe.wave ? kFormWave : kFormThread;
    lp.blocks = cfg.blocks;
    lp.threads = cfg.threads;
    lp.write(plan);
    LANE_LAUNCH(0, reduce_resume_kernel, p, s1, nw, a);
    return static_cast<int>(cudaGetLastError());
  }
  if (n_cores < 1 || core < 1 || halo < 0 ||
      (long long)n_cores * core < n_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  lp.cores = n_cores;
  lp.core = core;
  if (n_cores == 1 && nw >= 2) {
    const SplitConfig cfg = words_config(device, n_lanes, s1, nw);
    lp.form = kFormWords;
    lp.blocks = cfg.blocks;
    lp.threads = cfg.threads;
    lp.width = word_width(nw);
    lp.write(plan);
#define LAUNCH(N) return launch_words<N, false>(cfg, p, s1, a, nullptr, st)
    MYERS_DISPATCH_WORDS(nw, LAUNCH)
#undef LAUNCH
  }
  const long long n_threads = (long long)n_lanes * n_cores;
  const SplitConfig cfg = split_config(device, n_threads, n_lanes, s1 * nw);
  lp.form = n_cores > 1 ? kFormCores : kFormThread;
  lp.blocks = cfg.blocks;
  lp.threads = cfg.threads;
  lp.write(plan);
  const SplitArgs sp{nullptr, core, halo, cfg.peq_words, n_cores};
#define LAUNCH(N)                                                         \
  reduce_resume_split_kernel<N><<<cfg.blocks, cfg.threads, cfg.smem, st>>>( \
      p, s1, a, sp)
  MYERS_DISPATCH_SPLIT(nw, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// eq uint32 (n_cols, nw, n_lanes): lane b's Eq word w of column c at
// (c * nw + w) * n_lanes + b; lo, hi and the outputs as myers_reduce_lanes.
// At 2-8 words and n_cols > 0 the word-parallel lane
// (reduce_eqstream_words_kernel), else one thread a lane or the wave form.
// plan int64 (kPlanFields,), or null: what the call launched (LaunchPlan).
int myers_reduce_eqstream(int device, const void* eq, int nw, int n_cols,
                          const void* lo, const void* hi, int n_lanes,
                          int hin0, void* best, void* pfirst, void* plast,
                          void* last, void* scratch, void* plan,
                          void* stream) {
  if (n_lanes <= 0) return 0;
  if (nw < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  LaneArgs a = lane_args(nullptr, n_cols, lo, hi, nullptr, nullptr, n_lanes,
                         hin0, scratch);
  set_reduction(a, best, pfirst, plast, last);
  return launch_eqstream(false, device, static_cast<const uint32_t*>(eq), nw,
                         a, plan, static_cast<cudaStream_t>(stream));
}

// eq, lo, hi as myers_reduce_eqstream; want and hits as myers_hits_lanes.
// At 2-8 words the word-parallel lane (hits_eqstream_words_kernel), else one
// thread a lane or the wave form.  plan as myers_reduce_eqstream.
int myers_hits_eqstream(int device, const void* eq, int nw, int n_cols,
                        const void* lo, const void* hi, int n_lanes, int hin0,
                        const void* want, void* hits, int n_out,
                        void* scratch, void* plan, void* stream) {
  if (n_lanes <= 0 || n_cols <= 0) return 0;
  if (nw < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  LaneArgs a = lane_args(nullptr, n_cols, lo, hi, nullptr, nullptr, n_lanes,
                         hin0, scratch);
  set_hits(a, want, hits, n_out);
  return launch_eqstream(true, device, static_cast<const uint32_t*>(eq), nw,
                         a, plan, static_cast<cudaStream_t>(stream));
}

// The value-adaptive banded reduce: peq, targets, lo, hi, prow, trow as
// myers_reduce_lanes, with n_lanes a multiple of 1,024 (each 1,024 lanes
// share one band; pad lanes take part in its minima); k >= 0 the band's
// threshold; group columns between band updates; strong_every groups
// between strong reduces (0: none); classes int32 (n_classes,) the
// ascending width classes, the last nw; best, pfirst, plast int32
// (n_lanes,); live int64 (n_lanes / 1024,) or null: the word-columns each
// tile swept; scratch 3 * nw * n_lanes words in the scratch form (else not
// read); plan int32 (5,): the launch (adaptive_launch), which the caller
// takes from cuda_kernel.adaptive_plan where myers_hw_adaptive_clusters
// admits it.
int myers_hw_adaptive(int device, const void* peq, int s1, int nw,
                      const void* targets, int n_cols, const void* lo,
                      const void* hi, const void* prow, const void* trow,
                      int n_lanes, int k, int hin0, int group,
                      int strong_every, const void* classes, int n_classes,
                      void* best, void* pfirst, void* plast, void* live,
                      void* scratch, const void* plan, void* stream) {
  if (n_lanes <= 0) return 0;
  const AdaptiveLaunch l = adaptive_launch(plan, s1, nw);
  if (n_lanes % kTile || nw < 1 || s1 < 1 || group < 1 || k < 0 ||
      strong_every < 0 || n_classes < 1 || n_classes > nw ||
      n_classes > kAdaptiveMaxClasses || !l.kernel ||
      (static_cast<const int32_t*>(plan)[0] == 1 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  LaneArgs a = lane_args(targets, n_cols, lo, hi, prow, trow, n_lanes, hin0,
                         scratch);
  set_reduction(a, best, pfirst, plast, nullptr);
  const AdaptiveArgs ad{k,
                        group,
                        strong_every,
                        n_classes,
                        static_cast<const int32_t*>(classes),
                        static_cast<long long*>(live),
                        l.cluster,
                        l.lanes,
                        l.staged};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (const cudaError_t e = adaptive_config(
          l, n_lanes / kTile, static_cast<cudaStream_t>(stream), cfg, attr))
    return static_cast<int>(e);
  if (const cudaError_t e =
          cudaLaunchKernelEx(&cfg, l.kernel, static_cast<const uint32_t*>(peq),
                             s1, nw, a, ad))
    return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of a plan (as myers_hw_adaptive takes it) the card
// holds at once, into clusters int32 (1,): 0 where it holds none (a block
// past an SM's registers or shared memory, or a cluster size it does not
// take).
int myers_hw_adaptive_clusters(int device, int s1, int nw, const void* plan,
                               void* clusters) {
  const AdaptiveLaunch l = adaptive_launch(plan, s1, nw);
  if (nw < 1 || s1 < 1 || !clusters || !l.kernel)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t e = adaptive_config(l, 1, nullptr, cfg, attr);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, l.kernel, &cfg);
  if (e != cudaSuccess) {
    n = 0;
    cudaGetLastError();  // a refused shape is an answer, not a fault
  }
  *static_cast<int*>(clusters) = n;
  return 0;
}

const char* myers_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
