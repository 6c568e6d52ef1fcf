// Anti-diagonal wavefront sweeps of ONE long pair for NVIDIA Hopper (sm_90a),
// compiled into the same library as myers.cu (edlib_tpu_torch/ops/_build.py)
// and bound with ctypes.  Plain C interface: every pointer and the stream
// arrive as void*, each entry point returns the cudaError_t of its launch
// (0 = cudaSuccess) and never synchronises or allocates.
//
// Two entry points, one kernel template.  Each replaces a kernel of
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
// What bounds it on this card: the step barrier.  A step is 13 integer
// operations per advanced word (advance_word, myers.cu), a few hundred words
// to a few tens of thousands, against a barrier that every step must cross,
// because word w's input is word w-1's output one step earlier.  The windows
// of the banded ladder (<= 4,096 slots) run as ONE block: 1,024 threads of
// one slot each up to 1,024 slots, else 512 threads of up to 8 slots, the
// hand-off through shared memory and __syncthreads() per step.  Wider
// windows (the unbanded sweep of a long query: 31,744 slots for 1 Mbp)
// spread over the co-resident blocks of a cooperative launch with one
// grid.sync() per step and the hand-off through a global buffer read past
// L1 (__ldcg).  The launch checks the occupancy and fails rather than run
// with blocks that are not all resident.  No attempt is made yet to amortise
// the barrier (several steps per barrier with a halo, or point-to-point
// flags between neighbouring blocks).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kWfBig = 0x3FFFFFFF;  // wavefront._BIG: "no column seen"
constexpr int kWideBlock = 1024;        // one block, one slot a thread
constexpr int kBlockThreads = 512;      // one block, up to kMaxSlots a thread
constexpr int kGridThreads = 256;       // blocks of the cooperative form
constexpr int kMaxSlots = 8;            // slots a thread at most

struct WfArgs {
  const int32_t* t;      // scan-column symbols, index < t_scan
  const uint32_t* peq;   // (s1, peq_words) profile bit words
  int peq_words;
  int32_t* state;        // (7, ns) logical slots, updated in place
  int32_t* stream;       // (n_steps,) bottom-word scores, or null
  int32_t* hand;         // (2, ns) hand-off words (cooperative form)
  int d_base, n_steps, ns, n_words, t_scan;
  uint32_t hin0;
  int col_lo, col_hi;
  int banded, lo, base_cap, word0;
};

__device__ __forceinline__ int floor_div33(int x) {
  return x >= 0 ? x / 33 : -((-x + 32) / 33);
}

__device__ __forceinline__ int base_of(const WfArgs& a, int d) {
  if (!a.banded) return a.word0;
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
      uint32_t in_n = 0u, in_p = a.hin0;
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
      if (a.stream != nullptr && word == bottom) a.stream[i] = sc[j];
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
// myers_wavefront: the fixed window [word0, word0 + ns), top hin (0, hin0);
// stream int32 (n_steps,) receives the bottom word's score after each step
// (null: none).
int myers_wavefront(int device, const void* t, const void* peq, int peq_words,
                    void* state, void* hand, int d_base, int n_steps, int ns,
                    int n_words, int t_scan, int hin0, int col_lo, int col_hi,
                    int word0, void* stream_out, void* stream) {
  WfArgs a = wf_args(t, peq, peq_words, state, hand, d_base, n_steps, ns,
                     n_words, t_scan, col_lo, col_hi);
  a.hin0 = hin0 ? 1u : 0u;
  a.word0 = word0;
  a.stream = static_cast<int32_t*>(stream_out);
  return launch_wavefront(device, a, stream);
}

// myers_wavefront_banded: the window slides along the band of lower diagonal
// offset lo; top hin (0, +1); no stream.
int myers_wavefront_banded(int device, const void* t, const void* peq,
                           int peq_words, void* state, void* hand, int d_base,
                           int n_steps, int ns, int n_words, int t_scan,
                           int lo, int col_lo, int col_hi, void* stream) {
  WfArgs a = wf_args(t, peq, peq_words, state, hand, d_base, n_steps, ns,
                     n_words, t_scan, col_lo, col_hi);
  a.hin0 = 1u;
  a.banded = 1;
  a.lo = lo;
  a.base_cap = n_words > ns ? n_words - ns : 0;
  return launch_wavefront(device, a, stream);
}

}  // extern "C"
