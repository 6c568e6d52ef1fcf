// Warp groups linked by per-tile records: the schedule of myers_wavefront
// (wavefront.cu wavefront_groups_kernel) and of the score stream's long
// lanes (myers.cu sweep_scores_groups_kernel).  Both .cu files include this
// header; ops/_build.py hashes it with the sources.
//
// A group is one warp holding kGroup consecutive words of one sweep, one a
// lane: lane i holds word w and advances column d - w at step d, one column
// behind lane i-1, whose hout of step d-1 it takes from a warp vote
// (__ballot_sync; __shfl_up_sync in the predicated loop): no barrier inside
// a group.  The first group's top lane takes (0, hin0).  A group runs its
// steps in tiles of kGroupTile.  Each lane loads the symbols of its next
// tile's 32 columns while the current tile runs (a symbol and its Eq word
// are two dependent loads; on the chain they cost more than the step),
// reads the tile's Eq words at its start (the profile rows of its 32 words
// in shared memory where s1 rows fit, else through L1), then runs the 32
// dependent steps; hout crosses lanes as two votes (the top lane's input
// spliced in below bit 0), so a step's chain is a vote, a shift, the
// update and a compare.  Where every lane is active for the whole tile the
// step is the bare update, the score moving once by the popcounts of the
// hout bits, collected in funnel shifts (a tile cut by the sweep's columns
// or steps runs the predicated loop).  After each tile the caller reads the
// bottom word's scores from its lane's hout bits (tile_score).
//
// Between groups: the bottom lane of group g hands on each tile's hout bits
// as one 16-byte record, two 64-bit words (hp mask, tag) and (hn mask,
// tag), tag = tile + 1, each written with one relaxed 64-bit store, so a
// record needs no flag of its own: the top lane of group g+1 polls the two
// words (relaxed loads at device scope) until both carry its tile's tag,
// one tile behind group g (bit k of tile j is step d0 + k; the input of
// step d is step d - 1's hout, so the previous record's bit 31 carries over,
// and before the first the state's hout of the word above).  The next
// record is loaded while the tile runs.  Records go into a ring of `ring`
// tiles, in shared memory between the warps of a block and in global
// memory between blocks; the reader publishes its consumed count (release)
// every max(1, ring / 4) tiles and the writer waits (acquire) only while
// the ring is full, so in steady state no group waits on a slower reader.
//
// Placement: a unit (a column core of a wavefront call, a lane of the score
// stream) is n_groups groups; a task is one block's groups (wpb <= 8
// consecutive groups of one unit); blocks are persistent and take tasks in
// increasing order (unit-major) from an atomic counter.  The launch checks
// the occupancy: every block of the grid is resident and one unit's blocks
// fit at once, else it returns an error (it never waits on a block that
// cannot run).  Because tasks are taken in order, a task that waits for the
// next task of its unit to start is never waited on by an earlier unit,
// whose tasks are all running or done: no deadlock.  A unit of more groups
// than one launch keeps resident (group_capacity) runs as passes, a launch
// each: the bottom group of a pass writes one record a tile for the pass
// below (bottom_out) and the next pass's top group reads them (top_in).
//
// What bounds it: the dependent chain of a step, about ten integer
// operations and a vote a word-step, one group per warp, and on the card
// more than that count (0.08-0.12 us a step, slower with more warps on an
// SM: not broken down); with the records' hand-off once a tile a group
// waits only to fill the pipeline, 32 steps a group, at each launch's
// start.

#pragma once

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 32;         // words a warp group
constexpr int kGroupTile = 32;     // steps a tile
constexpr int kGroupMaxWarps = 8;  // groups a block
constexpr size_t kGroupPeqSmem = 64 * 1024;  // profile bytes a block keeps
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A wait that a correct schedule ends in microseconds to milliseconds; past
// kSpinLimitNs of the global timer it traps, so a fault fails the launch
// (the wrapper raises) instead of holding the card.
constexpr unsigned long long kSpinLimitNs = 60ull * 1000 * 1000 * 1000;

struct Spin {
  unsigned long long t0 = 0;
  unsigned n = 0;

  __device__ __forceinline__ void tick() {
    if ((++n & 1023u) != 0) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > kSpinLimitNs) {
      __trap();
    }
  }
};

__device__ __forceinline__ unsigned long long record_word(uint32_t bits,
                                                          int tile) {
  return (static_cast<unsigned long long>(bits) << 32) |
         static_cast<unsigned>(tile + 1);
}

// One group's links: the ring its top lane reads (in_rec, the reader's
// consumed count in_cons, in_depth records; a pass's records from the pass
// above have no count and one record a tile) and the ring its bottom lane
// writes (out_*); null where no group lies above or below.
struct GroupLinks {
  const ulonglong2* in_rec = nullptr;
  unsigned* in_cons = nullptr;
  int in_depth = INT_MAX;
  ulonglong2* out_rec = nullptr;
  const unsigned* out_cons = nullptr;
  int out_depth = INT_MAX;
};

// The links of local group gl of unit u, warp `warp` of a block of wpb:
// rings in the block's shared memory (s_rec [wpb][ring], s_cons [wpb])
// between its own warps, in global memory (links (n_units, n_groups, ring),
// cons (n_units, n_groups)) between blocks; top_in / bottom_out the records
// from the pass above and for the pass below (null: none).  first / last:
// no group of the sweep lies above / below.
__device__ __forceinline__ GroupLinks group_links(
    int u, int gl, int warp, int wpb, int n_groups, int ring, bool first,
    bool last, ulonglong2* links, unsigned* cons, ulonglong2* s_rec,
    unsigned* s_cons, const ulonglong2* top_in, ulonglong2* bottom_out) {
  GroupLinks ln;
  if (!first) {
    if (gl == 0) {
      ln.in_rec = top_in;
    } else if (warp == 0) {
      const size_t l = (size_t)u * n_groups + gl;
      ln.in_rec = links + l * ring;
      ln.in_cons = cons + l;
      ln.in_depth = ring;
    } else {
      ln.in_rec = s_rec + warp * ring;
      ln.in_cons = s_cons + warp;
      ln.in_depth = ring;
    }
  }
  if (!last) {
    if (gl + 1 == n_groups) {
      ln.out_rec = bottom_out;
    } else if (warp + 1 == wpb) {
      const size_t l = (size_t)u * n_groups + gl + 1;
      ln.out_rec = links + l * ring;
      ln.out_cons = cons + l;
      ln.out_depth = ring;
    } else {
      ln.out_rec = s_rec + (warp + 1) * ring;
      ln.out_cons = s_cons + warp + 1;
      ln.out_depth = ring;
    }
  }
  return ln;
}

// What one group sweeps.  Its lane holds word w (live: a word of the
// sweep; wr: the word its Eq reads take, clamped into the profile) of the
// profile rows (s1, peq_words) at peq, or this warp's copy of its words'
// rows in shared memory, s_peq[row * kGroup + lane] (null: none); the
// symbols t of columns [0, t_scan).  It advances columns [cs, ce) over the
// steps [d_lo, d_hi); the top group (top) takes (0, hin0) into its top
// lane; ring: the depth of its links (for the reader's publishing period).
struct GroupSpan {
  const int32_t* t;
  const uint32_t* peq;
  const uint32_t* s_peq;
  int peq_words, t_scan;
  int wr, w;
  bool live, top;
  int cs, ce, d_lo, d_hi;
  uint32_t hin0;
  int ring;
};

// A lane's word state: Pv, Mv, the hout of its last step (hn, hp) and its
// bottom row's score; and the hout of the word above the top lane at the
// step before d_lo (carry_n, carry_p).
struct GroupState {
  uint32_t pv, mv, hn, hp;
  int32_t sc;
  uint32_t carry_n, carry_p;
};

// Lane k's value: the score of lane bl's word after step d0 + k of a tile,
// from its score sc0 before the tile and its hout bits (inactive steps have
// none).  Every lane of the warp calls it.
__device__ __forceinline__ int32_t tile_score(int32_t sc0, uint32_t o_p,
                                              uint32_t o_n, int bl,
                                              int lane) {
  const int32_t s0b = __shfl_sync(kFull, sc0, bl);
  const uint32_t bp = __shfl_sync(kFull, o_p, bl);
  const uint32_t bn = __shfl_sync(kFull, o_n, bl);
  const uint32_t m = (2u << lane) - 1u;
  return s0b + __popc(bp & m) - __popc(bn & m);
}

// Run one group over its steps in tiles (see the header), reading records
// through ln and writing them; after each tile every lane calls
// tile(d0, nk, sc0, o_p, o_n): the tile's first step and its step count,
// the lane's score before the tile and its hout bits (bit k: step d0 + k).
// st is updated in place.
template <class Tile>
__device__ __forceinline__ void group_sweep(const GroupSpan& a,
                                            const GroupLinks& ln, int lane,
                                            GroupState& st, Tile& tile) {
  uint32_t pv = st.pv, mv = st.mv, hn = st.hn, hp = st.hp;
  uint32_t carry_n = st.carry_n, carry_p = st.carry_p;
  int32_t sc = st.sc;
  const int w = a.w;
  const int every = max(1, a.ring / 4);
  const int n_tiles =
      a.d_hi > a.d_lo ? (a.d_hi - a.d_lo + kGroupTile - 1) / kGroupTile : 0;
  long long seen = 0;  // the reader's consumed count, as last read
  unsigned long long px = 0ull, py = 0ull;
  if (!a.top && n_tiles > 0) {
    px = ld_relaxed(&ln.in_rec[0].x);
    py = ld_relaxed(&ln.in_rec[0].y);
  }
  // The symbols of this lane's columns in the next tile, loaded a tile
  // ahead (clamped into the scan; columns outside it are inactive).
  int32_t sym[kGroupTile];
#pragma unroll
  for (int k = 0; k < kGroupTile; ++k)
    sym[k] = __ldg(a.t + min(max(a.d_lo - w + k, 0), a.t_scan - 1));
  for (int j = 0; j < n_tiles; ++j) {
    const int d0 = a.d_lo + kGroupTile * j;
    const int nk = min(kGroupTile, a.d_hi - d0);
    uint32_t tin_p = a.hin0 ? ~0u : 0u, tin_n = 0u;
    if (!a.top) {
      const ulonglong2* r = ln.in_rec + (j % ln.in_depth);
      const unsigned tag = static_cast<unsigned>(j + 1);
      Spin spin;
      while (static_cast<unsigned>(px) != tag) {
        spin.tick();
        px = ld_relaxed(&r->x);
      }
      while (static_cast<unsigned>(py) != tag) {
        spin.tick();
        py = ld_relaxed(&r->y);
      }
      const uint32_t rp = static_cast<uint32_t>(px >> 32);
      const uint32_t rn = static_cast<uint32_t>(py >> 32);
      tin_p = (rp << 1) | carry_p;
      tin_n = (rn << 1) | carry_n;
      carry_p = rp >> 31;
      carry_n = rn >> 31;
      if (ln.in_cons != nullptr && (j + 1) % every == 0 && lane == 0)
        st_release(ln.in_cons, static_cast<unsigned>(j + 1));
      if (j + 1 < n_tiles) {  // the next record, while this tile runs
        const ulonglong2* q = ln.in_rec + ((j + 1) % ln.in_depth);
        px = ld_relaxed(&q->x);
        py = ld_relaxed(&q->y);
      }
    }
    const int cb = d0 - w;  // this lane's column at step d0
    const bool any = __any_sync(kFull, a.live && cb + nk > a.cs && cb < a.ce);
    const bool whole =
        __all_sync(kFull, a.live && cb >= a.cs && cb + kGroupTile <= a.ce) &&
        nk == kGroupTile;
    const int32_t sc0 = sc;
    uint32_t o_p = 0u, o_n = 0u;
    // The tile's Eq words from the symbols loaded during the last tile, then
    // the next tile's symbols, in flight while this tile's chain runs.
    uint32_t eq[kGroupTile];
    if (a.s_peq != nullptr) {
#pragma unroll
      for (int k = 0; k < kGroupTile; ++k)
        eq[k] = a.s_peq[sym[k] * kGroup + lane];
    } else {
#pragma unroll
      for (int k = 0; k < kGroupTile; ++k)
        eq[k] = __ldg(a.peq + (size_t)sym[k] * a.peq_words + a.wr);
    }
#pragma unroll
    for (int k = 0; k < kGroupTile; ++k)
      sym[k] = __ldg(a.t + min(max(cb + kGroupTile + k, 0), a.t_scan - 1));
    if (!any) {
      hn = hp = 0u;
    } else if (whole) {
      // The lanes' hout as two votes: lane i takes bit i - 1, the top lane
      // the tile's input bit spliced in below bit 0.
      uint32_t bn = __ballot_sync(kFull, hn != 0u);
      uint32_t bp = __ballot_sync(kFull, hp != 0u);
#pragma unroll
      for (int k = 0; k < kGroupTile; ++k) {
        const uint32_t in_n = (((bn << 1) | ((tin_n >> k) & 1u)) >> lane) & 1u;
        const uint32_t in_p = (((bp << 1) | ((tin_p >> k) & 1u)) >> lane) & 1u;
        const uint32_t e = eq[k];
        const uint32_t xv = e | mv;
        const uint32_t e2 = e | in_n;
        const uint32_t xh = (((e2 & pv) + pv) ^ pv) | e2;
        const uint32_t ph = mv | ~(xh | pv);
        const uint32_t mh = pv & xh;
        const uint32_t phs = (ph << 1) | in_p;
        const uint32_t mhs = (mh << 1) | in_n;
        pv = mhs | ~(xv | phs);
        mv = phs & xv;
        bn = __ballot_sync(kFull, static_cast<int32_t>(mh) < 0);
        bp = __ballot_sync(kFull, static_cast<int32_t>(ph) < 0);
        o_p = __funnelshift_l(ph, o_p, 1);
        o_n = __funnelshift_l(mh, o_n, 1);
      }
      hn = o_n & 1u;  // the last step's, before the reversal
      hp = o_p & 1u;
      o_p = __brev(o_p);
      o_n = __brev(o_n);
      sc += __popc(o_p) - __popc(o_n);
    } else {
      // hout crosses lanes by shuffles, each step predicated on the lane's
      // column.
#pragma unroll
      for (int k = 0; k < kGroupTile; ++k) {
        if (k >= nk) break;
        uint32_t in_n = __shfl_up_sync(kFull, hn, 1);
        uint32_t in_p = __shfl_up_sync(kFull, hp, 1);
        if (lane == 0) {
          in_n = (tin_n >> k) & 1u;
          in_p = (tin_p >> k) & 1u;
        }
        const int c = cb + k;
        const bool act = a.live && c >= a.cs && c < a.ce;
        const uint32_t e = eq[k];
        const uint32_t xv = e | mv;
        const uint32_t e2 = e | in_n;
        const uint32_t xh = (((e2 & pv) + pv) ^ pv) | e2;
        const uint32_t ph = mv | ~(xh | pv);
        const uint32_t mh = pv & xh;
        const uint32_t phs = (ph << 1) | in_p;
        const uint32_t mhs = (mh << 1) | in_n;
        if (act) {
          pv = mhs | ~(xv | phs);
          mv = phs & xv;
          hp = ph >> 31;
          hn = mh >> 31;
          sc += static_cast<int32_t>(hp) - static_cast<int32_t>(hn);
          o_p |= hp << k;
          o_n |= hn << k;
        } else {
          hn = hp = 0u;
        }
      }
    }
    tile(d0, nk, sc0, o_p, o_n);
    if (ln.out_rec != nullptr) {
      Spin spin;
      while (ln.out_cons != nullptr && j - seen >= ln.out_depth) {
        spin.tick();
        seen = ld_acquire(ln.out_cons);
      }
      if (lane == kGroup - 1) {
        ulonglong2* r = ln.out_rec + (j % ln.out_depth);
        st_relaxed(&r->x, record_word(o_p, j));
        st_relaxed(&r->y, record_word(o_n, j));
      }
    }
  }
  st.pv = pv;
  st.mv = mv;
  st.hn = hn;
  st.hp = hp;
  st.sc = sc;
  st.carry_n = carry_n;
  st.carry_p = carry_p;
}

// A persistent block's loop: tasks (unit, a block's groups) taken in
// increasing order from the counter next_task, ceil(n_groups / wpb) tasks
// a unit; warp `warp` of the block runs local group gl of the task's unit
// where gl < n_groups, as run(unit, gl, warp, lane, s_rec, s_cons, s_peq).
// The block's shared links are zeroed before each task.  Shared memory
// (group_smem): [wpb][ring] records, [wpb] counts, then each warp's
// [s1][kGroup] profile words.  Every thread of the block calls it.
template <class Run>
__device__ __forceinline__ void group_tasks(int n_units, int n_groups,
                                            int wpb, int ring, int s1,
                                            int* next_task, Run& run) {
  extern __shared__ __align__(16) unsigned char gsm[];
  ulonglong2* s_rec = reinterpret_cast<ulonglong2*>(gsm);  // [wpb][ring]
  unsigned* s_cons = reinterpret_cast<unsigned*>(s_rec + wpb * ring);
  uint32_t* s_peq = reinterpret_cast<uint32_t*>(s_cons + wpb);
  __shared__ int task_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bpc = (n_groups + wpb - 1) / wpb;  // tasks a unit
  const int n_tasks = n_units * bpc;
  for (;;) {
    __syncthreads();
    if (threadIdx.x == 0) task_s = atomicAdd(next_task, 1);
    for (int i = threadIdx.x; i < wpb * ring; i += blockDim.x)
      s_rec[i] = make_ulonglong2(0ull, 0ull);
    for (int i = threadIdx.x; i < wpb; i += blockDim.x) s_cons[i] = 0u;
    __syncthreads();
    const int task = task_s;
    if (task >= n_tasks) return;
    const int gl = (task % bpc) * wpb + warp;
    if (gl < n_groups)
      run(task / bpc, gl, warp, lane, s_rec, s_cons,
          s_peq + (size_t)warp * s1 * kGroup);
  }
}

size_t group_smem(int wpb, int ring, int s1, bool peq_smem) {
  return (size_t)wpb * ring * sizeof(ulonglong2) + wpb * sizeof(unsigned) +
         (peq_smem ? (size_t)wpb * s1 * kGroup * sizeof(uint32_t) : 0);
}

bool group_peq_smem(int s1) {
  return (size_t)kGroupMaxWarps * s1 * kGroup * sizeof(uint32_t) <=
         kGroupPeqSmem;
}

// Blocks of `wpb` warps of `kernel` that stay resident on the card at once
// (*blocks).
template <class Args>
int group_residency(void (*kernel)(Args), int device, int wpb, size_t smem,
                    int* blocks) {
  int n_sm = 0, per_sm = 0;
  if (const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)))
    return static_cast<int>(e);
  if (const cudaError_t e = cudaDeviceGetAttribute(
          &n_sm, cudaDevAttrMultiProcessorCount, device))
    return static_cast<int>(e);
  if (const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, wpb * 32, smem))
    return static_cast<int>(e);
  *blocks = per_sm * n_sm;
  return 0;
}

// The warps a block: a group-step slows as warps share an SM (and its
// schedulers), so the fewest warps on the busiest SM when every task's block
// is spread one a SM in turn, the larger block (more links in shared
// memory) among equals.
int group_block_warps(int device, int n_groups, int n_units) {
  int n_sm = 132;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  int best = kGroupMaxWarps;
  long long best_load = LLONG_MAX;
  for (int wpb = kGroupMaxWarps; wpb >= 1; --wpb) {
    const long long blocks =
        (long long)n_units * ((n_groups + wpb - 1) / wpb);
    const long long load = (blocks + n_sm - 1) / n_sm * wpb;
    if (load < best_load) {
      best_load = load;
      best = wpb;
    }
  }
  return best;
}

// A group launch's shape: warps a block, persistent blocks, and the
// block's shared memory (group_smem), profile rows staged or not.
struct GroupGeometry {
  int wpb = 0, blocks = 0, peq_smem = 0;
  size_t smem = 0;
};

// The shape of a launch of `kernel` on n_units units of n_groups groups as
// persistent blocks (group_tasks) of wpb warps (0: group_block_warps):
// every block of the grid is resident and one unit's blocks fit at once,
// else cudaErrorCooperativeLaunchTooLarge rather than a launch that would
// wait on a block that cannot run.
template <class Args>
int group_geometry(void (*kernel)(Args), int device, int n_units,
                   int n_groups, int s1, int ring, int wpb,
                   GroupGeometry* g) {
  g->peq_smem = group_peq_smem(s1);
  g->wpb = wpb > 0 ? wpb : group_block_warps(device, n_groups, n_units);
  g->smem = group_smem(g->wpb, ring, s1, g->peq_smem);
  int capacity = 0;
  if (const int e = group_residency(kernel, device, g->wpb, g->smem,
                                    &capacity))
    return e;
  const int bpc = (n_groups + g->wpb - 1) / g->wpb;
  if (capacity < 1 || bpc > capacity)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  g->blocks = static_cast<int>(
      std::min((long long)n_units * bpc, (long long)capacity));
  return 0;
}

// The groups one launch keeps resident at kGroupMaxWarps warps a block
// (*groups): a unit of more groups runs as passes of at most that many.
template <class Args>
int group_capacity(void (*kernel)(Args), int device, int s1, int ring,
                   int* groups) {
  int blocks = 0;
  if (const int e = group_residency(
          kernel, device, kGroupMaxWarps,
          group_smem(kGroupMaxWarps, ring, s1, group_peq_smem(s1)), &blocks))
    return e;
  *groups = blocks * kGroupMaxWarps;
  return 0;
}

// Launch `kernel` in the shape g (group_geometry), setting a.wpb and
// a.peq_smem.
template <class Args>
int launch_groups(void (*kernel)(Args), Args a, const GroupGeometry& g,
                  cudaStream_t stream) {
  a.wpb = g.wpb;
  a.peq_smem = g.peq_smem;
  kernel<<<g.blocks, g.wpb * 32, g.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
