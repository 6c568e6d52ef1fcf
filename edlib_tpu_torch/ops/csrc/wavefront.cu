// Anti-diagonal wavefront sweeps of ONE long pair for NVIDIA Hopper (sm_90a),
// compiled into the same library as myers.cu (edlib_tpu_torch/ops/_build.py)
// and bound with ctypes.  Plain C interface: every pointer and the stream
// arrive as void*, each entry point returns the cudaError_t of its launch
// (0 = cudaSuccess) and never synchronises or allocates.
//
// Two entry points over three kernels: myers_wavefront runs warp groups
// linked by per-tile records (wavefront_groups_kernel, below), the banded
// entry the step form (wavefront_kernel) or its tile schedule
// (wavefront_tiles_kernel).  Each entry replaces a kernel of
// edlib_tpu/ops/wavefront.py:
//
//   myers_wavefront         _wf_kernel (:66), launched by _wavefront_call
//                           (:185, pallas_call :205): all query words of the
//                           pair, or the pinned word window [word0,
//                           word0 + ns) of the banded run's tail.
//   myers_wavefront_banded  _wfb_kernel (:422), launched by _wfb_call (:566,
//                           pallas_call :573): a window of ns word slots that
//                           slides down the query one word at a time along
//                           the band.
//
// The recurrence (wavefront.py:104-139).  At step d, query word w (32 DP rows)
// advances target column c = d - w, so every word of an anti-diagonal is
// independent: its horizontal input is the hout that word w-1 produced at
// step d-1.  The window's top word takes the boundary (hneg, hpos) = (0,
// hin0).  A word advances only while 0 <= c < t_scan and w < n_words; an idle
// word emits hout 0.  Per slot the state is Pv, Mv, the hout pair, the score
// of the word's bottom row, and (bottom word only) the running (min, first
// argmin) of that score over scan columns [col_lo, col_hi).  With a stream
// the bottom word's score after every step is written out.
//
// The banded window's base (its top word) follows base_of(d) = min(max(
// floor((d + lo - 31) / 33), 0), base_cap), base_cap = max(0, n_words - ns).
// On a step where it advances, the window slides first (wavefront.py:473-492):
// the top word leaves, and word base + ns - 1 enters at the bottom with
// Pv = ~0, Mv = 0, hout 0 and score = (bottom score - bottom hout + 32) of the
// step before, the "cell above + 1" upper bound; then the step runs as above.
// Every value <= k is exact, the standard banded-Myers contract.
//
// Layout.  The state crosses the interface in logical slot order (slot s =
// word base + s, the JAX planes flattened, without the symbol plane: a thread
// reads target[c] itself).  Inside the kernel word w lives in physical slot
// w mod ns, so a slide moves no data: the slot of the leaving word takes the
// entering one.  Loads and stores rotate between the two orders.
//
// What bounds the step form on this card: the step barrier.  A step is 13
// integer operations per advanced word (advance_word, myers.cu), a few
// hundred words to a few thousands, against a barrier that every step must
// cross, because word w's input is word w-1's output one step earlier.  The
// windows of the banded ladder (<= 4,096 slots) run as ONE block: 1,024
// threads of one slot each up to 1,024 slots, else 512 threads of up to 8
// slots, the hand-off through shared memory and __syncthreads() per step.
// Wider windows spread over the co-resident blocks of a cooperative launch
// with one grid.sync() per step and the hand-off through a global buffer
// read past L1 (__ldcg).  The launch checks the occupancy and fails rather
// than run with blocks that are not all resident.  The banded entry
// amortises the barrier with the tile schedule below (one barrier a
// super-step of 32 columns) from 6,144 steps and up to 4,096 slots.
// myers_wavefront has no barrier at all: a warp group's words hand on
// their hout by shuffles and the groups by records, once a tile.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "groups.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kWfBig = 0x3FFFFFFF;  // wavefront._BIG: "no column seen"
constexpr int kWideBlock = 1024;        // one block, one slot a thread
constexpr int kBlockThreads = 512;      // one block, up to kMaxSlots a thread
constexpr int kGridThreads = 256;       // blocks of the cooperative form
constexpr int kMaxSlots = 8;            // slots a thread at most

// The banded entry's operands (its top word takes hin (0, +1)).
struct WfArgs {
  const int32_t* t;      // scan-column symbols, index < t_scan
  const uint32_t* peq;   // (s1, peq_words) profile bit words
  int peq_words;
  int32_t* state;        // (7, ns) logical slots, updated in place
  int32_t* hand;         // (2, ns) hand-off words (cooperative form)
  int d_base, n_steps, ns, n_words, t_scan;
  int col_lo, col_hi;
  int lo, base_cap;
  int s1;                // profile rows (tile schedule)
  int peq_smem;          // tile schedule: slots keep their profile words
};

__device__ __forceinline__ int floor_div33(int x) {
  return x >= 0 ? x / 33 : -((-x + 32) / 33);
}

__device__ __forceinline__ int base_of(const WfArgs& a, int d) {
  return min(max(floor_div33(d + a.lo - 31), 0), a.base_cap);
}

__device__ __forceinline__ int mod_ns(int x, int ns) {
  x %= ns;
  return x < 0 ? x + ns : x;
}

// A slot's hand-off word: score << 2 | hneg << 1 | hpos (scores stay below
// 2^29, which the wrapper checks).
__device__ __forceinline__ int32_t pack(int32_t score, uint32_t hn,
                                        uint32_t hp) {
  return (score << 2) | static_cast<int32_t>((hn << 1) | hp);
}

template <bool GRID>
__device__ __forceinline__ int32_t load_hand(const int32_t* p) {
  if constexpr (GRID) return __ldcg(p);
  return *p;
}

template <bool GRID>
__device__ __forceinline__ void barrier() {
  if constexpr (GRID) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// GRID: the cooperative form; MAXS: slots a thread holds in registers.
template <bool GRID, int MAXS>
__global__ void __launch_bounds__(GRID ? kGridThreads
                                       : (MAXS == 1 ? kWideBlock
                                                    : kBlockThreads))
wavefront_kernel(WfArgs a) {
  extern __shared__ int32_t smem_hand[];
  int32_t* hand = GRID ? a.hand : smem_hand;
  const int ns = a.ns;
  const int nthreads = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t pv[MAXS], mv[MAXS], hn[MAXS], hp[MAXS];
  int32_t sc[MAXS], rmin[MAXS], rpos[MAXS];

  int base = base_of(a, a.d_base - 1);
  {
    int32_t* first = hand + ((a.d_base - 1) & 1) * ns;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      const int p = j * nthreads + g;
      if (p >= ns) continue;
      const int s = mod_ns(p - base, ns);
      const int32_t* st = a.state + s;
      pv[j] = static_cast<uint32_t>(st[0]);
      mv[j] = static_cast<uint32_t>(st[ns]);
      hn[j] = static_cast<uint32_t>(st[2 * ns]) & 1u;
      hp[j] = static_cast<uint32_t>(st[3 * ns]) & 1u;
      sc[j] = st[4 * ns];
      rmin[j] = st[5 * ns];
      rpos[j] = st[6 * ns];
      first[p] = pack(sc[j], hn[j], hp[j]);
    }
  }
  barrier<GRID>();

  const int bottom = a.n_words - 1;
  const bool track = a.col_hi > a.col_lo;
  for (int i = 0; i < a.n_steps; ++i) {
    const int d = a.d_base + i;
    const int nb = base_of(a, d);
    const int32_t* prev = hand + ((d - 1) & 1) * ns;
    int32_t* cur = hand + (d & 1) * ns;
    const bool slide = nb != base;
    const int top = mod_ns(nb, ns);
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      const int p = j * nthreads + g;
      if (p >= ns) continue;
      const int r = p >= top ? p - top : p - top + ns;  // logical slot
      const int word = nb + r;
      if (slide && r == ns - 1) {
        // The entering word: the cell above + 1 for each of its rows,
        // from the old bottom word's state after step d-1.
        const int32_t bot = load_hand<GRID>(prev + mod_ns(base + ns - 1, ns));
        const int32_t bh = (bot & 1) - ((bot >> 1) & 1);
        pv[j] = ~0u;
        mv[j] = 0u;
        hn[j] = hp[j] = 0u;
        sc[j] = (bot >> 2) - bh + 32;
        rmin[j] = kWfBig;
        rpos[j] = -1;
      }
      uint32_t in_n = 0u, in_p = 1u;
      if (r > 0) {
        const int32_t v = load_hand<GRID>(prev + (p == 0 ? ns - 1 : p - 1));
        in_n = (v >> 1) & 1;
        in_p = v & 1;
      }
      const int col = d - word;
      if (col >= 0 && col < a.t_scan && word < a.n_words) {
        const uint32_t eq =
            __ldg(a.peq + (size_t)__ldg(a.t + col) * a.peq_words + word);
        const uint32_t xv = eq | mv[j];
        const uint32_t e2 = eq | in_n;
        const uint32_t xh = (((e2 & pv[j]) + pv[j]) ^ pv[j]) | e2;
        const uint32_t ph = mv[j] | ~(xh | pv[j]);
        const uint32_t mh = pv[j] & xh;
        hp[j] = ph >> 31;
        hn[j] = mh >> 31;
        const uint32_t phs = (ph << 1) | in_p;
        const uint32_t mhs = (mh << 1) | in_n;
        pv[j] = mhs | ~(xv | phs);
        mv[j] = phs & xv;
        sc[j] += static_cast<int32_t>(hp[j]) - static_cast<int32_t>(hn[j]);
        if (track && word == bottom && col >= a.col_lo && col < a.col_hi &&
            sc[j] < rmin[j]) {
          rmin[j] = sc[j];
          rpos[j] = col;
        }
      } else {
        hn[j] = hp[j] = 0u;
      }
      cur[p] = pack(sc[j], hn[j], hp[j]);
    }
    base = nb;
    barrier<GRID>();
  }

#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    const int p = j * nthreads + g;
    if (p >= ns) continue;
    int32_t* st = a.state + mod_ns(p - base, ns);
    st[0] = static_cast<int32_t>(pv[j]);
    st[ns] = static_cast<int32_t>(mv[j]);
    st[2 * ns] = static_cast<int32_t>(hn[j]);
    st[3 * ns] = static_cast<int32_t>(hp[j]);
    st[4 * ns] = sc[j];
    st[5 * ns] = rmin[j];
    st[6 * ns] = rpos[j];
  }
}

// ---------------------------------------------------------------------------
// The banded entry's tile schedule (ops/cuda_kernel.py
// wavefront_banded_tiles_plain is the same schedule in PyTorch).
//
// Cell (w, c) needs only (w, c-1), its own word's state, and (w-1, c), for
// its horizontal input; the band's rules are functions of the
// anti-diagonal d = c + w alone: the window holds word w for the steps
// d in [first_step(w - ns + 1), first_step(w + 1)), first_step(x) being the
// first step whose base_of is >= x; word w is the window's top, input
// (0, +1), from step first_step(w) on; and a word that enters the window
// at step E starts at column E - w from Pv = ~0, Mv = 0 and the score of
// word w-1 before that column + 32 (the old "bottom score - hout + 32" of
// step E - 1).  So in a segment word w sweeps one interval of columns
// [c_lo, c_hi), and it may sweep it in tiles of kTile columns aligned to
// absolute columns: tile j at super-step j + w, one tile behind word w-1.
// A tile hands on its horizontal deltas as two 32-bit masks (hp, hn; bit i
// = column 32j + i) and the word's score after the tile, from which the
// entering word w+1 subtracts the deltas of columns >= its entry column.
// The loaded state's hout belongs to the column before a word's first one;
// it is handed on as the record of that column's tile.
//
// One block of kTileThreads threads; thread g holds the word slots
// g, g + kTileThreads, ... (word w in slot w mod ns, as the step form), so
// a thread takes its slot's next word when the last one has left.  The
// band slopes 32 columns a word, so while the window slides about
// ns / 2 words have a tile at a super-step.  Per super-step a thread runs
// the tiles of its live slots (state in shared memory between tiles) and
// the block crosses one __syncthreads(); records are double-buffered by
// super-step parity.  Neighbouring threads hold neighbouring words, which
// run neighbouring tiles, so the symbols come as 16-bit values (the
// wrapper's copy): a tile is four 16-byte loads and a warp's 32 tiles one
// contiguous 2 KB run.  Each slot keeps its word's s1 profile words in
// shared memory where they fit (s1 <= kTilePeqRows), else they are read
// from the operand.  A tile loads its 32 symbols and Eq words ahead of the
// dependent chain; the per-word interval and boundary columns are a
// multiply and a shift, with no division or % in the column loop.  Whole
// untracked tiles (most of them) run a branch-free loop; a tile cut by the
// word's interval, the scan's end or the tracked bottom word runs the
// column-predicated one.
//
// What bounds it: still one SM.  A segment costs about n_steps / 16 + ns
// super-steps, so the wrapper (cuda_kernel.wavefront_banded_form) keeps a
// step a barrier for segments under 6,144 steps, where the pipeline's fill
// and drain cost more than the barriers saved, and past 4,096 slots (the
// cooperative grid).

constexpr int kTile = 32;
constexpr int kTileThreads = 512;
constexpr int kTileMaxSlots = 4096;
constexpr int kTileStateWords = 14;    // shared words a slot (state, records)
constexpr int kTilePeqRows = 8;        // profile rows a slot may keep there
constexpr size_t kTileSmemMax = 232448;  // an H100 block's opt-in maximum
constexpr long long kFar = 1LL << 40;

__device__ __forceinline__ long long first_step(const WfArgs& a, int x) {
  if (x <= 0) return -kFar;
  if (x > a.base_cap) return kFar;
  return 33LL * x + 31 - a.lo;
}

// Word w's columns [c_lo, c_hi) in the segment [d_base, d_end), and its
// super-steps [s_a, s_b] (s_a > s_b where it has none).
struct TileSpan {
  int c_lo, c_hi, s_a, s_b;
  __device__ __forceinline__ TileSpan(const WfArgs& a, int w, int d_end) {
    const long long lo = max((long long)a.d_base, first_step(a, w - a.ns + 1));
    const long long hi = min((long long)d_end, first_step(a, w + 1));
    c_lo = static_cast<int>(lo - w);
    c_hi = static_cast<int>(max(hi, lo) - w);
    if (c_lo < c_hi) {
      s_a = (c_lo >> 5) + w;  // arithmetic shift: floor for c < 0
      s_b = ((c_hi - 1) >> 5) + w;
    } else {
      s_a = INT_MAX;
      s_b = INT_MIN;
    }
  }
};

// Bits [lo, hi) of a word (clamped to [0, 32)).
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, kTile);
  if (hi <= lo) return 0u;
  return (~0u >> (kTile - (hi - lo))) << lo;
}

__global__ void __launch_bounds__(kTileThreads)
wavefront_tiles_kernel(WfArgs a) {
  extern __shared__ int32_t sm[];
  const int ns = a.ns;
  // Per slot: the word's state between its tiles, and its super-steps.
  uint32_t* s_pv = reinterpret_cast<uint32_t*>(sm);
  uint32_t* s_mv = s_pv + ns;
  int32_t* s_sc = sm + 2 * ns;
  int32_t* s_rmin = sm + 3 * ns;
  int32_t* s_rpos = sm + 4 * ns;
  int32_t* s_w = sm + 5 * ns;
  int32_t* s_a = sm + 6 * ns;
  int32_t* s_b = sm + 7 * ns;
  // Records [parity][slot]: hp mask, hn mask, score after the tile.
  uint32_t* r_hp = reinterpret_cast<uint32_t*>(sm + 8 * ns);
  uint32_t* r_hn = r_hp + 2 * ns;
  int32_t* r_sc = sm + 12 * ns;
  // The slots' profile words [row][slot], where they fit.
  const bool peq_smem = a.peq_smem;
  uint32_t* s_peq = reinterpret_cast<uint32_t*>(sm + kTileStateWords * ns);
  const int n_tiles = (a.t_scan + kTile - 1) / kTile;
  __shared__ int step_lo, step_hi;
  const int T = blockDim.x, g = threadIdx.x;
  const int d_end = a.d_base + a.n_steps;
  const int b0 = base_of(a, a.d_base - 1), b_end = base_of(a, d_end - 1);
  const int bottom = a.n_words - 1;
  if (g == 0) {
    step_lo = INT_MAX;
    step_hi = INT_MIN;
  }
  // Load the window of step d_base - 1; each word's hout there is the
  // record of the column before its first one.
  for (int p = g; p < ns; p += T) {
    const int w = b0 + mod_ns(p - b0, ns);
    const int32_t* st = a.state + (w - b0);
    s_pv[p] = static_cast<uint32_t>(st[0]);
    s_mv[p] = static_cast<uint32_t>(st[ns]);
    s_sc[p] = st[4 * ns];
    s_rmin[p] = st[5 * ns];
    s_rpos[p] = st[6 * ns];
    s_w[p] = w;
    if (peq_smem)
      for (int r = 0; r < a.s1; ++r)
        s_peq[r * ns + p] =
            a.peq[(size_t)r * a.peq_words + min(w, a.n_words - 1)];
    const TileSpan sp(a, w, d_end);
    s_a[p] = sp.s_a;
    s_b[p] = sp.s_b;
    const int cp = a.d_base - 1 - w;
    const int q = (((cp >> 5) + w) & 1) * ns + p;
    r_hp[q] = (static_cast<uint32_t>(st[3 * ns]) & 1u) << (cp & 31);
    r_hn[q] = (static_cast<uint32_t>(st[2 * ns]) & 1u) << (cp & 31);
    r_sc[q] = st[4 * ns];
  }
  __syncthreads();
  {
    int lo = INT_MAX, hi = INT_MIN;
    for (int p = g; p < ns; p += T)
      for (int w = s_w[p]; w < b_end + ns; w += ns) {
        const TileSpan sp(a, w, d_end);
        lo = min(lo, sp.s_a);
        hi = max(hi, sp.s_b);
      }
    atomicMin(&step_lo, lo);
    atomicMax(&step_hi, hi);
  }
  __syncthreads();
  const bool track = a.col_hi > a.col_lo;
  const int s_end = step_hi;
  for (int s = step_lo; s <= s_end; ++s) {
    const int par = s & 1;
    for (int p = g; p < ns; p += T) {
      int w = s_w[p];
      if (s > s_b[p] && w + 1 <= b_end) {
        // The slot takes its next word (the one after may follow at once
        // where a word entered and left inside the segment).
        TileSpan sp(a, w + ns, d_end);
        w += ns;
        while (s > sp.s_b && w + 1 <= b_end) {
          w += ns;
          sp = TileSpan(a, w, d_end);
        }
        s_w[p] = w;
        s_a[p] = sp.s_a;
        s_b[p] = sp.s_b;
        s_pv[p] = ~0u;
        s_mv[p] = 0u;
        s_rmin[p] = kWfBig;
        s_rpos[p] = -1;
        if (peq_smem)
          for (int r = 0; r < a.s1; ++r)
            s_peq[r * ns + p] =
                a.peq[(size_t)r * a.peq_words + min(w, a.n_words - 1)];
      }
      if (s < s_a[p] || s > s_b[p]) continue;
      const TileSpan sp(a, w, d_end);
      const int jt = s - w;
      const int c0 = jt * kTile;
      const uint32_t act =
          w < a.n_words ? bit_range(max(sp.c_lo, 0) - c0,
                                    min(sp.c_hi, a.t_scan) - c0)
                        : 0u;
      const long long top_at =
          w <= a.base_cap ? first_step(a, w) - w : kFar;
      const long long tp = top_at - c0;
      const uint32_t top = tp <= 0 ? ~0u : tp >= kTile ? 0u : ~0u << tp;
      const int rq = (par ^ 1) * ns + (p == 0 ? ns - 1 : p - 1);
      const uint32_t p_hp = r_hp[rq], p_hn = r_hn[rq];
      int32_t sc = s_sc[p];
      if (w >= b0 + ns && (sp.c_lo >> 5) == jt) {
        // Entered in this segment: word w-1's score before this column.
        const int k = sp.c_lo - c0;
        sc = r_sc[rq] - __popc(p_hp >> k) + __popc(p_hn >> k) + 32;
      }
      const uint32_t in_p = p_hp | top, in_n = p_hn & ~top;
      // The tile's 32 symbols (16-bit, 64 bytes: four vector loads, a
      // warp's 32 neighbouring tiles one contiguous run) and Eq words
      // (shared memory where the slot keeps its profile words), ahead of
      // the dependent chain.
      uint32_t eq[kTile];
      {
        uint32_t pair[kTile / 2];
        if (jt >= 0 && jt < n_tiles) {
          const int4* tv = reinterpret_cast<const int4*>(a.t) + 4 * jt;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int4 x = __ldg(tv + v);
            pair[4 * v] = x.x;
            pair[4 * v + 1] = x.y;
            pair[4 * v + 2] = x.z;
            pair[4 * v + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int v = 0; v < kTile / 2; ++v) pair[v] = 0u;
        }
        const uint32_t* pg = a.peq + min(w, a.n_words - 1);
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const uint32_t sym = (pair[i / 2] >> (16 * (i & 1))) & 0xFFFFu;
          eq[i] = peq_smem ? s_peq[sym * ns + p]
                           : __ldg(pg + (size_t)sym * a.peq_words);
        }
      }
      uint32_t pv = s_pv[p], mv = s_mv[p];
      int32_t rmin = s_rmin[p], rpos = s_rpos[p];
      const bool trk = track && w == bottom;
      uint32_t o_hp = 0u, o_hn = 0u;
      if (act == ~0u && !trk) {
        // A whole tile, untracked: the input bits come in at the top of
        // bit-reversed masks through funnel shifts, the hout bits leave
        // through funnel shifts (reversed back after the tile), and the
        // score moves once by the counts.
        const uint32_t rp = __brev(in_p), rn = __brev(in_n);
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const uint32_t e = eq[i];
          const uint32_t xv = e | mv;
          const uint32_t e2 = e | ((in_n >> i) & 1u);
          const uint32_t xh = (((e2 & pv) + pv) ^ pv) | e2;
          const uint32_t ph = mv | ~(xh | pv);
          const uint32_t mh = pv & xh;
          const uint32_t phs = __funnelshift_l(rp << i, ph, 1);
          const uint32_t mhs = __funnelshift_l(rn << i, mh, 1);
          o_hp = __funnelshift_l(ph, o_hp, 1);
          o_hn = __funnelshift_l(mh, o_hn, 1);
          pv = mhs | ~(xv | phs);
          mv = phs & xv;
        }
        o_hp = __brev(o_hp);
        o_hn = __brev(o_hn);
        sc += __popc(o_hp) - __popc(o_hn);
      } else {
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          if ((act >> i) & 1u) {
            const uint32_t hn_in = (in_n >> i) & 1u;
            const uint32_t hp_in = (in_p >> i) & 1u;
            const uint32_t e = eq[i];
            const uint32_t xv = e | mv;
            const uint32_t e2 = e | hn_in;
            const uint32_t xh = (((e2 & pv) + pv) ^ pv) | e2;
            const uint32_t ph = mv | ~(xh | pv);
            const uint32_t mh = pv & xh;
            const uint32_t hp = ph >> 31, hn = mh >> 31;
            const uint32_t phs = (ph << 1) | hp_in;
            const uint32_t mhs = (mh << 1) | hn_in;
            pv = mhs | ~(xv | phs);
            mv = phs & xv;
            sc += static_cast<int32_t>(hp) - static_cast<int32_t>(hn);
            o_hp |= hp << i;
            o_hn |= hn << i;
            if (trk) {
              const int c = c0 + i;
              if (c >= a.col_lo && c < a.col_hi && sc < rmin) {
                rmin = sc;
                rpos = c;
              }
            }
          }
        }
      }
      const int o = par * ns + p;
      if (w < b0 + ns && ((a.d_base - 1 - w) >> 5) == jt) {
        // The first tile of a word of the loaded window keeps the record
        // of the column before it.
        o_hp |= r_hp[o];
        o_hn |= r_hn[o];
      }
      r_hp[o] = o_hp;
      r_hn[o] = o_hn;
      r_sc[o] = sc;
      s_pv[p] = pv;
      s_mv[p] = mv;
      s_sc[p] = sc;
      s_rmin[p] = rmin;
      s_rpos[p] = rpos;
    }
    __syncthreads();
  }
  // Every slot holds a word of step d_end - 1's window; its hout is the
  // bit of its last column in its last tile's record.
  for (int p = g; p < ns; p += T) {
    const int w = s_w[p];
    const int cl = d_end - 1 - w;
    const int o = (((cl >> 5) + w) & 1) * ns + p;
    int32_t* st = a.state + (w - b_end);
    st[0] = static_cast<int32_t>(s_pv[p]);
    st[ns] = static_cast<int32_t>(s_mv[p]);
    st[2 * ns] = static_cast<int32_t>((r_hn[o] >> (cl & 31)) & 1u);
    st[3 * ns] = static_cast<int32_t>((r_hp[o] >> (cl & 31)) & 1u);
    st[4 * ns] = s_sc[p];
    st[5 * ns] = s_rmin[p];
    st[6 * ns] = s_rpos[p];
  }
}

int launch_wavefront_tiles(int device, WfArgs a, void* stream) {
  if (a.n_steps <= 0) return 0;
  if (a.ns < 1 || a.ns > kTileMaxSlots || a.n_words < 1 ||
      a.peq_words < a.n_words)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  size_t smem = kTileStateWords * (size_t)a.ns * sizeof(int32_t);
  a.peq_smem = a.s1 <= kTilePeqRows &&
               smem + (size_t)a.s1 * a.ns * sizeof(int32_t) <=
                   kTileSmemMax - 1024;
  if (a.peq_smem) smem += (size_t)a.s1 * a.ns * sizeof(int32_t);
  if (const cudaError_t e = cudaFuncSetAttribute(
          wavefront_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)))
    return static_cast<int>(e);
  wavefront_tiles_kernel<<<1, min(kTileThreads, a.ns), smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// myers_wavefront's schedule: warp groups linked by per-tile records
// (csrc/groups.cuh; ops/cuda_kernel.py wavefront_groups_plain is the same
// schedule in PyTorch, group by group and tile by tile).  A unit of the
// schedule is one column core of the call (below); lane i of group g holds
// word w = word0 + 32 g + i of the window.
//
// A window past the groups one launch keeps resident runs as passes, a
// launch each: the bottom group of a pass writes every record of the
// segment (bottom_out) and the next pass's top group reads them (top_in).
//
// HW column cores (n_cores > 1, hin0 = 0, word0 = 0, from step 0): core k
// owns columns [k * core, (k + 1) * core), the first from -inf, the last to
// +inf, and sweeps from the fresh state (Pv = ~0, Mv = 0, slot s's score
// (s + 1) * 32, hout 0) at column max(0, k * core - halo), the first core
// from the loaded state.  This is exact for every word, not only the bottom
// row: in HW every cell of row i is <= i + 1 (it can start anywhere), so an
// optimal path to a cell (i, c) costs <= i + 1 and spans at most 2 (i + 1)
// columns: it starts at or after column c - 2 (i + 1) + 1, which for
// c >= k * core and every row of the window (i + 1 <= 32 n_words) is at or
// after the sweep's start when halo = 2 * 32 * n_words
// (cuda_kernel.split_halo).  The DP from the fresh state there holds every
// such path, so every cell, and with it every Pv, Mv, hout and score, is
// exact from column k * core on.  A core stops each word at its last owned
// column; it writes the exit state of the words whose last column (clamped
// into the scan) it owns, the stream of the steps whose bottom column it
// owns, and merges the bottom word's (min, first argmin) over its owned
// columns into a packed 64-bit key (score << 32 | column) with atomicMin.
// HW calls hide the groups' chain behind their column cores.

struct GroupArgs {
  const int32_t* t;        // scan-column symbols, index < t_scan
  const uint32_t* peq;     // (s1, peq_words) profile bit words
  int peq_words, s1;
  const int32_t* state_in;  // (7, ns) logical slots
  int32_t* state_out;       // (7, ns): the owned words' planes 0-4
  int32_t* stream;          // (n_steps,) bottom-word scores, or null
  unsigned long long* key;  // the bottom word's packed (min, argmin), or null
  ulonglong2* links;        // (n_cores, n_groups, ring) records
  unsigned* cons;           // (n_cores, n_groups) tiles each reader consumed
  int* next_task;
  const ulonglong2* top_in;  // records of the pass above, or null
  ulonglong2* bottom_out;    // records for the pass below, or null
  int d_base, n_steps, ns, n_words, t_scan, word0, col_lo, col_hi;
  uint32_t hin0;
  int g_lo, n_groups, g_real;  // groups [g_lo, g_lo + n_groups) of g_real
  int n_cores, core, halo;
  int ring, wpb, peq_smem;
};

// One warp group of one core: local group gl of this launch, warp `warp`
// of its block; s_rec/s_cons the block's shared links, s_peq this warp's
// profile rows.
__device__ void run_group(const GroupArgs& a, int core, int gl, int warp,
                          int lane, ulonglong2* s_rec, unsigned* s_cons,
                          uint32_t* s_peq) {
  const int g = a.g_lo + gl;
  const int s = g * kGroup + lane;
  const int w = a.word0 + s;
  const bool live = s < a.ns && w < a.n_words;
  const int ns = a.ns;
  const int K = a.n_cores;
  const int w_last = a.word0 + min(a.ns, a.n_words - a.word0) - 1;
  const int d_end = a.d_base + a.n_steps;
  // The core's swept columns [cs, ce) and steps [d_lo, d_hi).
  int cs = 0, ce = a.t_scan, d_lo = a.d_base, d_hi = d_end;
  if (K > 1) {
    const long long c0 = (long long)core * a.core;
    if (core > 0) {
      cs = static_cast<int>(max(0LL, c0 - a.halo));
      d_lo = max(a.d_base, cs + a.word0);
    }
    if (core < K - 1) {
      ce = static_cast<int>(min((long long)a.t_scan, c0 + a.core));
      d_hi = static_cast<int>(min((long long)d_end, (long long)ce + w_last));
    }
  }
  const auto owns = [&](int c) {
    if (K == 1) return true;
    c = min(max(c, 0), a.t_scan - 1);
    return c / a.core == core;
  };
  // The loaded state (the first core) or the fresh one; the carry into the
  // top lane is the hout of the word above at the step before d_lo.
  const int sl = min(s, ns - 1);
  GroupState st{~0u, 0u, 0u, 0u, (s + 1) * 32, 0u, 0u};
  if (core == 0) {
    st.pv = static_cast<uint32_t>(a.state_in[sl]);
    st.mv = static_cast<uint32_t>(a.state_in[ns + sl]);
    st.hn = static_cast<uint32_t>(a.state_in[2 * ns + sl]) & 1u;
    st.hp = static_cast<uint32_t>(a.state_in[3 * ns + sl]) & 1u;
    st.sc = a.state_in[4 * ns + sl];
    if (g > 0) {
      const int q = g * kGroup - 1;
      st.carry_n = static_cast<uint32_t>(a.state_in[2 * ns + q]) & 1u;
      st.carry_p = static_cast<uint32_t>(a.state_in[3 * ns + q]) & 1u;
    }
  }
  const GroupLinks ln = group_links(
      core, gl, warp, a.wpb, a.n_groups, a.ring, g == 0, g + 1 >= a.g_real,
      a.links, a.cons, s_rec, s_cons, a.top_in, a.bottom_out);
  const int wr = min(w, a.n_words - 1);
  if (a.peq_smem) {
    for (int r = 0; r < a.s1; ++r)
      s_peq[r * kGroup + lane] = a.peq[(size_t)r * a.peq_words + wr];
    __syncwarp();
  }
  const int bottom_slot = a.n_words - 1 - a.word0;
  const int bl = bottom_slot - g * kGroup;
  const bool bottom_here = bl >= 0 && bl < kGroup && bottom_slot < ns &&
                           (a.stream != nullptr || a.key != nullptr);
  int32_t rmin = kWfBig;
  int rpos = -1;
  // After each tile: lane k gives the bottom word's score after step d0 + k
  // (the stream of the steps whose bottom column this core owns) and the
  // tile's candidates for the running (min, first argmin).
  auto tile = [&](int d0, int nk, int32_t sc0, uint32_t o_p, uint32_t o_n) {
    if (!bottom_here) return;
    const int32_t v = tile_score(sc0, o_p, o_n, bl, lane);
    const int c = d0 + lane - (a.n_words - 1);
    const bool step = lane < nk && owns(c);
    if (a.stream != nullptr && step) a.stream[d0 + lane - a.d_base] = v;
    if (a.key != nullptr) {
      const bool cand = step && c >= cs && c < ce && c >= a.col_lo &&
                        c < a.col_hi;
      const int32_t best = __reduce_min_sync(kFull, cand ? v : kWfBig);
      if (best < rmin) {
        rmin = best;
        rpos = d0 + __ffs(__ballot_sync(kFull, cand && v == best)) - 1 -
               (a.n_words - 1);
      }
    }
  };
  const GroupSpan sp{a.t, a.peq, a.peq_smem ? s_peq : nullptr,
                     a.peq_words, a.t_scan, wr, w, live, g == 0,
                     cs, ce, d_lo, d_hi, a.hin0, a.ring};
  group_sweep(sp, ln, lane, st, tile);
  if (live && owns(d_end - 1 - w)) {
    a.state_out[s] = static_cast<int32_t>(st.pv);
    a.state_out[ns + s] = static_cast<int32_t>(st.mv);
    a.state_out[2 * ns + s] = static_cast<int32_t>(st.hn);
    a.state_out[3 * ns + s] = static_cast<int32_t>(st.hp);
    a.state_out[4 * ns + s] = st.sc;
  }
  if (bottom_here && a.key != nullptr && lane == 0 && rpos >= 0)
    atomicMin(a.key, (static_cast<unsigned long long>(
                          static_cast<uint32_t>(rmin)) << 32) |
                         static_cast<uint32_t>(rpos));
}

__global__ void __launch_bounds__(kGroupMaxWarps * 32)
wavefront_groups_kernel(GroupArgs a) {
  auto run = [&](int core, int gl, int warp, int lane, ulonglong2* s_rec,
                 unsigned* s_cons, uint32_t* s_peq) {
    run_group(a, core, gl, warp, lane, s_rec, s_cons, s_peq);
  };
  group_tasks(a.n_cores, a.n_groups, a.wpb, a.ring, a.s1, a.next_task, run);
}

int launch_wavefront_groups(int device, GroupArgs a, void* stream) {
  if (a.n_steps <= 0 || a.n_groups <= 0) return 0;
  if (a.ns < 1 || a.n_words < 1 || a.peq_words < a.n_words || a.s1 < 1 ||
      a.ring < 1 || a.n_cores < 1 || a.core < 1 || a.halo < 0 ||
      a.g_lo < 0 || a.g_lo + a.n_groups > a.g_real ||
      (long long)a.n_cores * a.core < a.t_scan ||
      (a.n_cores > 1 && (a.g_lo > 0 || a.top_in != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  GroupGeometry g;
  if (const int e = group_geometry(wavefront_groups_kernel, device, a.n_cores,
                                   a.n_groups, a.s1, a.ring, 0, &g))
    return e;
  return launch_groups(wavefront_groups_kernel, a, g,
                       static_cast<cudaStream_t>(stream));
}

int launch_wavefront(int device, WfArgs a, void* stream) {
  if (a.n_steps <= 0) return 0;
  if (a.ns < 1 || a.n_words < 1 || a.peq_words < a.n_words)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * (size_t)a.ns * sizeof(int32_t);
  if (a.ns <= kWideBlock) {
    // One block, one slot a thread: the hand-off in shared memory,
    // __syncthreads() per step.
    wavefront_kernel<false, 1><<<1, kWideBlock, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.ns <= kBlockThreads * kMaxSlots) {
    if (const cudaError_t e = cudaFuncSetAttribute(
            wavefront_kernel<false, kMaxSlots>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem)))
      return static_cast<int>(e);
    wavefront_kernel<false, kMaxSlots><<<1, kBlockThreads, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // Cooperative grid: every block resident, one grid.sync() per step.
  int coop = 0, n_sm = 0, per_sm = 0;
  if (const cudaError_t e =
          cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device))
    return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (const cudaError_t e = cudaDeviceGetAttribute(
          &n_sm, cudaDevAttrMultiProcessorCount, device))
    return static_cast<int>(e);
  if (const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wavefront_kernel<true, kMaxSlots>, kGridThreads, 0))
    return static_cast<int>(e);
  const int want = (a.ns + kGridThreads - 1) / kGridThreads;
  const int blocks = min(want, per_sm * n_sm);
  if (blocks < 1 || (long long)blocks * kGridThreads * kMaxSlots < a.ns)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* params[] = {&a};
  if (const cudaError_t e = cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(wavefront_kernel<true, kMaxSlots>), dim3(blocks),
          dim3(kGridThreads), params, 0, st))
    return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

WfArgs wf_args(const void* t, const void* peq, int peq_words, void* state,
               void* hand, int d_base, int n_steps, int ns, int n_words,
               int t_scan, int col_lo, int col_hi) {
  WfArgs a{};
  a.t = static_cast<const int32_t*>(t);
  a.peq = static_cast<const uint32_t*>(peq);
  a.peq_words = peq_words;
  a.state = static_cast<int32_t*>(state);
  a.hand = static_cast<int32_t*>(hand);
  a.d_base = d_base;
  a.n_steps = n_steps;
  a.ns = ns;
  a.n_words = n_words;
  a.t_scan = t_scan;
  a.col_lo = col_lo;
  a.col_hi = col_hi;
  return a;
}

}  // namespace

extern "C" {

// Both entry points: t int32 (>= t_scan,) the scan columns' symbols (the
// wildcard past the target where the caller extends it); peq uint32
// (s1, peq_words), peq_words >= n_words; state int32 (7, ns) [Pv, Mv, hneg,
// hpos, score, runmin, runpos] in logical slot order, advanced in place by
// n_steps steps from absolute step d_base; hand int32 (2, ns) scratch.
//
// myers_wavefront: the fixed window [word0, word0 + ns), top hin (0, hin0),
// warp groups linked by per-tile records (above).  state_in is read,
// state_out (a copy of it, its hout planes zeroed from slot n_words - word0
// on) receives planes 0-4 of every word below n_words; stream int32
// (n_steps,) the bottom word's score after each step (null: none); key
// uint64 (1,) the bottom word's (runmin << 32 | runpos), merged with
// atomicMin over the columns [col_lo, col_hi) (null: no tracking).  This
// launch runs groups [g_lo, g_lo + n_groups) of the g_real groups holding a
// word below n_words, ceil(min(ns, n_words - word0) / 32); n_cores cores of
// `core` columns (n_cores * core >= t_scan; n_cores > 1 only for HW from
// step 0 with word0 = 0 and one pass), halo columns before each; scratch
// the zeroed links, consumed counts and task counter (GroupArgs), each link
// `ring` records; top_in / bottom_out: the records between passes (16-byte
// records of ceil(n_steps / 32) tiles), or null.
int myers_wavefront(int device, const void* t, const void* peq, int peq_words,
                    int s1, const void* state_in, void* state_out, int d_base,
                    int n_steps, int ns, int n_words, int t_scan, int hin0,
                    int col_lo, int col_hi, int word0, void* stream_out,
                    void* key, int g_lo, int n_groups, int n_cores, int core,
                    int halo, void* scratch, int ring, const void* top_in,
                    void* bottom_out, void* stream) {
  GroupArgs a{};
  a.t = static_cast<const int32_t*>(t);
  a.peq = static_cast<const uint32_t*>(peq);
  a.peq_words = peq_words;
  a.s1 = s1;
  a.state_in = static_cast<const int32_t*>(state_in);
  a.state_out = static_cast<int32_t*>(state_out);
  a.stream = static_cast<int32_t*>(stream_out);
  a.key = static_cast<unsigned long long*>(key);
  const size_t links = (size_t)n_cores * n_groups;
  a.links = static_cast<ulonglong2*>(scratch);
  a.cons = reinterpret_cast<unsigned*>(a.links + links * ring);
  a.next_task = reinterpret_cast<int*>(a.cons + links);
  a.top_in = static_cast<const ulonglong2*>(top_in);
  a.bottom_out = static_cast<ulonglong2*>(bottom_out);
  a.d_base = d_base;
  a.n_steps = n_steps;
  a.ns = ns;
  a.n_words = n_words;
  a.t_scan = t_scan;
  a.word0 = word0;
  a.col_lo = col_lo;
  a.col_hi = col_hi;
  a.hin0 = hin0 ? 1u : 0u;
  a.g_lo = g_lo;
  a.n_groups = n_groups;
  a.g_real = (min(ns, n_words - word0) + kGroup - 1) / kGroup;
  a.n_cores = n_cores;
  a.core = core;
  a.halo = halo;
  a.ring = ring;
  return launch_wavefront_groups(device, a, stream);
}

// The groups one myers_wavefront launch keeps resident for s1 profile rows
// and rings of `ring` tiles (*groups): a window of more runs as passes.
int myers_wavefront_capacity(int device, int s1, int ring, int* groups) {
  if (s1 < 1 || ring < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  return group_capacity(wavefront_groups_kernel, device, s1, ring, groups);
}

// myers_wavefront_banded: the window slides along the band of lower diagonal
// offset lo; top hin (0, +1); no stream.  tiles: the tile schedule (at most
// 4,096 slots; t then uint16, 16-byte aligned, padded with zeros to a
// multiple of 32 columns; s1 the profile's rows), else a step a barrier.
int myers_wavefront_banded(int device, const void* t, const void* peq,
                           int peq_words, void* state, void* hand, int d_base,
                           int n_steps, int ns, int n_words, int t_scan,
                           int lo, int col_lo, int col_hi, int tiles, int s1,
                           void* stream) {
  WfArgs a = wf_args(t, peq, peq_words, state, hand, d_base, n_steps, ns,
                     n_words, t_scan, col_lo, col_hi);
  a.lo = lo;
  a.base_cap = n_words > ns ? n_words - ns : 0;
  a.s1 = s1;
  if (tiles) return launch_wavefront_tiles(device, a, stream);
  return launch_wavefront(device, a, stream);
}

}  // extern "C"
