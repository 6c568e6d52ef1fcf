// Myers bit-vector sweeps for NVIDIA Hopper (sm_90a), bound from Python with
// ctypes (edlib_tpu_torch/ops/_build.py).  Plain C interface: every pointer and
// the stream arrive as void*, every function returns the cudaError_t of its
// launch (0 = cudaSuccess) and never synchronises or allocates.
//
// Three kernels, one thread per alignment lane:
//
//   myers_reduce_lanes     replaces edlib_tpu/ops/pallas_kernel.py
//                          _reduce_kernel (:434), per-lane form, launched by
//                          _sweep_reduce_call (:580, pallas_call :605) through
//                          reduce_flat_device (:1761).
//   myers_reduce_bitplane  replaces the bit-plane form of the same kernel
//                          (_bitplane_tb :407, _bitplane_eq :415), launched by
//                          _sweep_reduce_bitplane_call (:2013, pallas_call
//                          :2040) through reduce_flat_device_bitplane (:2105).
//   myers_sweep_shared     replaces _shared_kernel (:249), launched by
//                          sweep_best_pallas_shared (:325, pallas_call :342).
//
// What bounds them on this card: integer issue.  advance_word below is 20
// two-input operations as written, 13 as Hopper issues them (a logic function
// of up to three inputs is one LOP3, (x << 1) | bit one LEA): eq|hneg, the
// AND, the add, xh, ph, mh, xv, pv, mv, two shifts out, two LEAs in.  The
// carried score and the windowed reduction add about 6 per column, and the
// H100 SXM issues 64 INT32 operations per SM per clock: 132 SMs x 64 x
// 1.98 GHz, about 16.7e12 operations/s.  The bytes are small beside that: one
// symbol (4 B) per lane-column, the Eq words come from a few KB per lane that
// stay in L1/L2.
//
// What this first design does about it: nothing yet.  Each thread keeps its
// lane's Pv/Mv words and running reduction in registers (templated on the
// word count for 1-8 words; more words keep their state in a global scratch
// buffer laid out (NW, lanes) so a warp's accesses coalesce), loops over the
// columns itself, and loads each column's symbol and Eq words from memory.  A
// lane stops at its own window end hi, so padded candidates (hi = 0) cost
// nothing.  The per-column loads are latency-bound when few lanes are
// resident (a shared sweep of 32 stragglers runs on one warp); splitting the
// target across blocks and a register-blocked Eq prefetch are later work.
//
// Semantics are the TPU kernels' exactly:
//   score starts at NW*32 (the padded bottom cell of column -1), hin of the
//   top word is 0 (HW: free leading gap) or +1 (SHW/NW), and for scan columns
//   c in [lo, hi):  best = min score, pfirst = first column reaching it,
//   plast = last column reaching it; last = score at column hi-1.
//   Columns past the row length are not scanned (callers keep hi <= T).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 0x3FFFFFFF;  // pallas_kernel._BIG: "no column seen"
constexpr int kThreads = 64;          // lanes per block
constexpr int kChunk = 2048;          // shared-target symbols staged per step
constexpr int kMaxPlanes = 9;         // bit planes for symbols up to 256 + sentinel

// One Myers block update (edlib.cpp:412-447; pallas_kernel._advance_word).
// hneg/hpos carry the horizontal delta into the word (1 where it is -1/+1)
// and return the delta out of its top cell.
__device__ __forceinline__ void advance_word(uint32_t& pv, uint32_t& mv,
                                             uint32_t eq, uint32_t& hneg,
                                             uint32_t& hpos) {
  const uint32_t xv = eq | mv;
  eq |= hneg;
  const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
  uint32_t ph = mv | ~(xh | pv);
  uint32_t mh = pv & xh;
  const uint32_t out_pos = ph >> 31;
  const uint32_t out_neg = mh >> 31;
  ph = (ph << 1) | hpos;
  mh = (mh << 1) | hneg;
  pv = mh | ~(xv | ph);
  mv = ph & xv;
  hneg = out_neg;
  hpos = out_pos;
}

struct Reduction {
  int32_t best = kBig, pfirst = -1, plast = -1, last = kBig;

  // Called for every scanned column c < hi.
  __device__ __forceinline__ void update(int32_t score, int c, int lo, int hi) {
    if (c >= lo) {
      if (score <= best) plast = c;
      if (score < best) {
        best = score;
        pfirst = c;
      }
    }
    if (c == hi - 1) last = score;
  }
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

// Sweep one lane over columns [0, min(hi, n_cols)).  NW > 0: the word count,
// state in registers.  NW == 0: nw words, state in scratch (stride apart).
template <int NW, class Eq>
__device__ __forceinline__ Reduction sweep_lane(Eq eq, int nw, int n_cols,
                                                int lo, int hi,
                                                uint32_t hin_pos,
                                                uint32_t* spv, uint32_t* smv,
                                                size_t stride) {
  Reduction red;
  const int end = min(hi, n_cols);
  if constexpr (NW > 0) {
    uint32_t pv[NW], mv[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      pv[w] = ~0u;
      mv[w] = 0u;
    }
    int32_t score = NW * 32;
    for (int c = 0; c < end; ++c) {
      eq.at(c);
      uint32_t hneg = 0u, hpos = hin_pos;
#pragma unroll
      for (int w = 0; w < NW; ++w) advance_word(pv[w], mv[w], eq.word(w), hneg, hpos);
      score += static_cast<int32_t>(hpos) - static_cast<int32_t>(hneg);
      red.update(score, c, lo, hi);
    }
  } else {
    for (int w = 0; w < nw; ++w) {
      spv[w * stride] = ~0u;
      smv[w * stride] = 0u;
    }
    int32_t score = nw * 32;
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
      red.update(score, c, lo, hi);
    }
  }
  return red;
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
  uint32_t* scratch;  // 2 * nw * n_lanes words when NW == 0
};

__device__ __forceinline__ void store(const LaneArgs& a, int lane,
                                      const Reduction& r) {
  a.best[lane] = r.best;
  a.pfirst[lane] = r.pfirst;
  a.plast[lane] = r.plast;
  a.last[lane] = r.last;
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
reduce_lanes_kernel(const uint32_t* __restrict__ peq, int s1, int nw, LaneArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  PeqEq eq{peq + (size_t)a.prow[lane] * s1 * nw,
           a.targets + (size_t)a.trow[lane] * a.n_cols, nw, nullptr};
  const Reduction r = sweep_lane<NW>(
      eq, nw, a.n_cols, a.lo[lane], a.hi[lane], a.hin_pos, a.scratch + lane,
      a.scratch + (size_t)nw * a.n_lanes + lane, (size_t)a.n_lanes);
  store(a, lane, r);
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
reduce_bitplane_kernel(const uint32_t* __restrict__ planes,
                       const uint32_t* __restrict__ pad, int nw, int nb,
                       int n_alts, int wildcard, LaneArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  const int row = a.prow[lane];
  BitplaneEq eq;
  eq.planes = planes + (size_t)row * n_alts * nb * nw;
  eq.pad = pad + (size_t)row * nw;
  eq.tg = a.targets + (size_t)a.trow[lane] * a.n_cols;
  eq.nw = nw;
  eq.nb = nb;
  eq.n_alts = n_alts;
  eq.wildcard = wildcard;
  const Reduction r = sweep_lane<NW>(
      eq, nw, a.n_cols, a.lo[lane], a.hi[lane], a.hin_pos, a.scratch + lane,
      a.scratch + (size_t)nw * a.n_lanes + lane, (size_t)a.n_lanes);
  store(a, lane, r);
}

// Every lane against one target.  The block stages kChunk symbols at a time in
// shared memory; Peq is laid out (S1, NW, B) so a warp's 32 lanes read 32
// consecutive words of the same row.
template <int NW>
__global__ void __launch_bounds__(kThreads)
sweep_shared_kernel(const uint32_t* __restrict__ peq, int nw, int n_lanes,
                    const int32_t* __restrict__ target, int n_cols,
                    uint32_t hin_pos, int col_lo, int col_hi, int32_t* best,
                    int32_t* pos, uint32_t* scratch) {
  __shared__ int32_t stage[kChunk];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < n_lanes;
  const size_t row_stride = (size_t)nw * n_lanes;
  uint32_t pv[NW > 0 ? NW : 1], mv[NW > 0 ? NW : 1];
  uint32_t* spv = scratch + lane;
  uint32_t* smv = scratch + row_stride + lane;
  if constexpr (NW > 0) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      pv[w] = ~0u;
      mv[w] = 0u;
    }
  } else if (active) {
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
      if constexpr (NW > 0) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
          advance_word(pv[w], mv[w], row[(size_t)w * n_lanes], hneg, hpos);
      } else {
        for (int w = 0; w < nw; ++w) {
          uint32_t p = spv[(size_t)w * n_lanes], m = smv[(size_t)w * n_lanes];
          advance_word(p, m, row[(size_t)w * n_lanes], hneg, hpos);
          spv[(size_t)w * n_lanes] = p;
          smv[(size_t)w * n_lanes] = m;
        }
      }
      score += static_cast<int32_t>(hpos) - static_cast<int32_t>(hneg);
      const int c = c0 + j;
      if (score < run_best && c >= col_lo) {
        run_best = score;
        run_pos = c;
      }
    }
  }
  if (active) {
    best[lane] = run_best;
    pos[lane] = run_pos;
  }
}

int blocks_for(int n_lanes) { return (n_lanes + kThreads - 1) / kThreads; }

LaneArgs lane_args(const void* targets, int n_cols, const void* lo,
                   const void* hi, const void* prow, const void* trow,
                   int n_lanes, int hin0, void* best, void* pfirst,
                   void* plast, void* last, void* scratch) {
  return LaneArgs{static_cast<const int32_t*>(targets), n_cols,
                  static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
                  static_cast<const int32_t*>(prow), static_cast<const int32_t*>(trow),
                  n_lanes, hin0 ? 1u : 0u, static_cast<int32_t*>(best),
                  static_cast<int32_t*>(pfirst), static_cast<int32_t*>(plast),
                  static_cast<int32_t*>(last), static_cast<uint32_t*>(scratch)};
}

}  // namespace

// Word counts 1-8 get register-resident state; any other count takes the
// generic scratch path (template argument 0).
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

extern "C" {

// Every entry point takes the CUDA device of its operands first (the
// library's runtime keeps its own current device) and the stream last.
//
// peq uint32 (R_p, s1, nw); targets int32 (R_t, n_cols); lo, hi, prow, trow
// and the outputs int32 (n_lanes,).
int myers_reduce_lanes(int device, const void* peq, int s1, int nw,
                       const void* targets, int n_cols, const void* lo,
                       const void* hi, const void* prow, const void* trow,
                       int n_lanes, int hin0, void* best, void* pfirst,
                       void* plast, void* last, void* scratch, void* stream) {
  if (n_lanes <= 0) return 0;
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const LaneArgs a = lane_args(targets, n_cols, lo, hi, prow, trow, n_lanes,
                               hin0, best, pfirst, plast, last, scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(peq);
#define LAUNCH(N) reduce_lanes_kernel<N><<<blocks_for(n_lanes), kThreads, 0, st>>>(p, s1, nw, a)
  MYERS_DISPATCH_NW(nw, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// planes uint32 (R_p, n_alts * nb * nw); pad uint32 (R_p, nw); the rest as
// myers_reduce_lanes.  wildcard: the target symbol that matches every row.
int myers_reduce_bitplane(int device, const void* planes, const void* pad,
                          int nw, int nb, int n_alts, int wildcard,
                          const void* targets, int n_cols, const void* lo,
                          const void* hi, const void* prow, const void* trow,
                          int n_lanes, int hin0, void* best, void* pfirst,
                          void* plast, void* last, void* scratch, void* stream) {
  if (n_lanes <= 0) return 0;
  if (nb < 1 || nb > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const LaneArgs a = lane_args(targets, n_cols, lo, hi, prow, trow, n_lanes,
                               hin0, best, pfirst, plast, last, scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* pl = static_cast<const uint32_t*>(planes);
  const uint32_t* pd = static_cast<const uint32_t*>(pad);
#define LAUNCH(N)                                                         \
  reduce_bitplane_kernel<N><<<blocks_for(n_lanes), kThreads, 0, st>>>( \
      pl, pd, nw, nb, n_alts, wildcard, a)
  MYERS_DISPATCH_NW(nw, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// peq uint32 (s1, nw, n_lanes); target int32 (n_cols,); best/pos int32
// (n_lanes,) over scan columns [col_lo, col_hi).
int myers_sweep_shared(int device, const void* peq, int nw, int n_lanes,
                       const void* target, int n_cols, int hin0, int col_lo,
                       int col_hi, void* best, void* pos, void* scratch,
                       void* stream) {
  if (n_lanes <= 0) return 0;
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(peq);
  const int32_t* t = static_cast<const int32_t*>(target);
  int32_t* b = static_cast<int32_t*>(best);
  int32_t* q = static_cast<int32_t*>(pos);
  uint32_t* s = static_cast<uint32_t*>(scratch);
  const uint32_t hp = hin0 ? 1u : 0u;
#define LAUNCH(N)                                                       \
  sweep_shared_kernel<N><<<blocks_for(n_lanes), kThreads, 0, st>>>( \
      p, nw, n_lanes, t, n_cols, hp, col_lo, col_hi, b, q, s)
  MYERS_DISPATCH_NW(nw, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

const char* myers_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
