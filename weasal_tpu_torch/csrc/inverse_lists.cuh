// Inverse neighbor lists and fixed-order row sums: the deterministic
// second stage of the dX of kernels C (kpconv_bwd.cu) and D
// (maxpool_bwd.cu), and of the other sums on the training path whose
// plain PyTorch form is a scatter-add (inverse_lists.cu).
//
// The TPU kernels that C and D replace never scatter: they sum each
// support's contributions by membership matrix products in a fixed order
// (weasal_tpu/ops/pallas/kpconv_banded.py:20-29, maxpool_banded.py:1-19),
// so a seeded run repeats bit for bit. Blocks on the H100 run in no
// order, and an f32 atomicAdd adds in the order the blocks reach it. So
// dX is taken in two stages: a first kernel writes each (query row, slot)
// contribution into a workspace [rows * K, C], and `inverse_sum_kernel`
// adds a support's contributions in ascending (row, slot) order, walking
// its inverse neighbor list, a CSR transpose of the neighbor indices.
//
// The build. The inverse lists of an index tensor nb [B, Nq, ld] (its
// first K columns, an index outside 0..Ns-1 a shadow that is skipped) are
// the slots (b*Nq + q)*K + k, the workspace's rows, stably sorted by
// support: offsets [B*Ns + 1] and entries. Two launches that read nothing
// back to the host, so a CUDA graph captures them: a memset of the
// scratch's control words, tile sums and counts, then one kernel,
// `inverse_build_kernel`, in four phases. Each block takes a ticket (an
// atomic counter) and the ticket names its phase and its unit of work;
// a phase's blocks wait for the phases before it, spinning (one thread
// a block, acquire loads) on a count of the earlier phase's finished
// blocks, to which each adds with release semantics after its barrier.
// A block waits only for tickets taken before its own, by blocks already
// running, so the wait always ends, whatever order the hardware starts
// the blocks in and however few fit at once.
//  0. count: each slot adds 1 to its support's count (an int atomic,
//     exact in any order) and keeps the count it found, its arrival: a
//     place in its segment, unique, in whatever order the atomics give;
//  1. scan: each tile of 2048 counts, all at once, scans its counts,
//     publishes their sum, and adds the sums of the tiles before it (a
//     look-back over published sums, exact in int32) to its offsets;
//  2. fill: each slot goes to its segment's offset plus its arrival, in
//     a scratch copy;
//  3. order: a warp takes 2 consecutive segments, loads the first 32
//     slots of each from the scratch copy at once, and writes each slot
//     at its rank, the number of the segment's slots below it (slot ids
//     are distinct, so the ranks are a permutation): the lists come out
//     as the stable sort's, with no sort through global memory. Ranks
//     are counted 32 slots a pass by warp shuffles, so a segment of L
//     slots costs ceil(L / 32)^2 passes of 32 shuffles: segments on the
//     main path hold tens of slots.
// Each hand-off between phases is a release, an acquire poll and a few
// round trips to L2, whatever the phase's work: the chain of the four
// phases, not their bytes, bounds the build.
//
// The row sums: the sum of rows src[e] for e in a row's list [lo, hi)
// (through entries when given) starts at 0.0 and adds in ascending e
// order, the order of a sequential index_add_ on the CPU. A row is served
// by a group of G lanes: the whole warp (G = 32) when C > 16, its lanes
// across channels (VEC consecutive floats a lane, P chunks of 32 * VEC
// channels a lane so that one pass over the list covers C <= 512), the
// list's entries loaded 32 at a time and shared by shuffles; 4, 2 or 1
// lanes when C <= 16, so that one warp serves 8 to 32 rows (the voxel
// sums have C = 3, the region gathers C = 9), each lane loading the
// entries itself. Either way the loads of the next U entries are issued
// before their adds (U = 4, or 2 where a lane holds 16 floats), so that
// several requests are in flight; the order of the adds does not change.
// Three kernels share the body, so that
// profiles tell them apart: `inverse_sum_kernel` (C's and D's stage 2),
// `list_sum_kernel` (the standalone sums over lists) and `run_sum_kernel`
// (the voxel sums: a row's bounds are the lower bounds of j and j + 1 in
// its sphere's non-decreasing seg row, found by binary search in the
// kernel, which also writes the run's length). Each writes every row, so
// dst needs no zeroing. Bounded by bytes: each source row read once, each
// destination row written once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace inverse_lists {

constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r.v[0] = t.x; r.v[1] = t.y;
  } else {
    r.v[0] = *p;
  }
  return r;
}

// VEC bf16 values as floats (C's bf16 workspace; 8-, 4- or 2-byte loads)
template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const __nv_bfloat16* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.y));
    r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = hi.x; r.v[3] = hi.y;
  } else if constexpr (VEC == 2) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    r.v[0] = t.x; r.v[1] = t.y;
  } else {
    r.v[0] = __bfloat162float(*p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r.v[0], r.v[1]);
  } else {
    *p = r.v[0];
  }
}

// ---------------------------------------------------------------------------
// Row sums

constexpr int kSumThreads = 256;

struct SumArgs {
  const int32_t* off;     // lists: offsets [rows + 1]
  const int32_t* ent;     // lists: entries (null: entry e is row e of src)
  const int64_t* seg;     // runs: [B, n] non-decreasing (values >= n_out
  int n;                  //   dropped); row r = b * n_out + j
  int n_out;
  const void* src;        // [*, c_dim], f32 (or bf16: C's bf16 stage 2)
  long long rows;
  int c_dim;
  float* dst;             // [rows, c_dim]
  float* counts;          // runs: [rows], each run's length
};

// dst[row, :] = sum over e in [lo, hi) of src[ent ? ent[e] : e, :], by a
// group of G lanes, P chunks of VEC channels a lane, U entries in flight;
// src of type S (bf16 values are added as f32, in the same order).
template <int VEC, int G, int P, bool RUNS, typename S = float>
__device__ __forceinline__ void row_sum(const SumArgs& a) {
  constexpr int U = P * VEC >= 16 ? 2 : 4;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const long long row =
      ((long long)blockIdx.x * (kSumThreads / 32) + (threadIdx.x >> 5))
          * (32 / G) + lane / G;
  if (row >= a.rows) return;                 // G = 32: the whole warp
  int e0, e1;
  const int32_t* ent = a.ent;
  if constexpr (RUNS) {
    const int b = (int)(row / a.n_out);
    const int j = (int)(row - (long long)b * a.n_out);
    const int64_t* s = a.seg + (size_t)b * a.n;
    // lower bounds of j and j + 1, searched side by side
    int lo0 = 0, hi0 = a.n, lo1 = 0, hi1 = a.n;
    while (lo0 < hi0 || lo1 < hi1) {
      if (lo0 < hi0) {
        const int m = (lo0 + hi0) >> 1;
        if (s[m] < j) lo0 = m + 1; else hi0 = m;
      }
      if (lo1 < hi1) {
        const int m = (lo1 + hi1) >> 1;
        if (s[m] <= j) lo1 = m + 1; else hi1 = m;
      }
    }
    if (g == 0) a.counts[row] = (float)(lo1 - lo0);
    e0 = b * a.n + lo0;
    e1 = b * a.n + lo1;
    ent = nullptr;
  } else {
    e0 = a.off[row];
    e1 = a.off[row + 1];
  }
  const int c_dim = a.c_dim;
  const S* __restrict__ src = static_cast<const S*>(a.src);
  for (int c0 = 0; c0 < c_dim; c0 += G * P * VEC) {
    int c[P];
    bool on[P];
    Vec<VEC> acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      c[p] = c0 + (p * G + g) * VEC;
      on[p] = c[p] < c_dim;                  // c_dim % VEC == 0
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[p].v[v] = 0.f;
    }
    // adds the U entries idx[0..m) in order, their loads issued first
    auto add = [&](const int* idx, int m) {
      Vec<VEC> val[U][P];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (u < m && on[p])
            val[u][p] = load_vec<VEC>(src + (size_t)idx[u] * c_dim + c[p]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (u < m && on[p]) {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[p].v[v] = __fadd_rn(acc[p].v[v], val[u][p].v[v]);
          }
    };
    if constexpr (G == 32) {
      // 32 entries at a time, one a lane, shared by shuffles
      for (int base = e0; base < e1; base += 32) {
        const int n = min(32, e1 - base);
        int mine = 0;
        if (lane < n) mine = ent ? ent[base + lane] : base + lane;
        // whole groups of U, then the rest one at a time: no predicate
        // inside a group
        int j = 0;
        for (; j + U <= n; j += U) {
          int idx[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            idx[u] = __shfl_sync(kFull, mine, j + u);
          add(idx, U);
        }
        for (; j < n; ++j) {
          int idx[U] = {};
          idx[0] = __shfl_sync(kFull, mine, j);
          add(idx, 1);
        }
      }
    } else {
      for (int e = e0; e < e1; e += U) {
        const int m = min(U, e1 - e);
        int idx[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          idx[u] = u < m ? (ent ? ent[e + u] : e + u) : 0;
        add(idx, m);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (on[p]) store_vec<VEC>(a.dst + (size_t)row * c_dim + c[p], acc[p]);
  }
}

template <int VEC, int G, int P, typename S = float>
__global__ void __launch_bounds__(kSumThreads)
    inverse_sum_kernel(const SumArgs a) {
  row_sum<VEC, G, P, false, S>(a);
}

template <int VEC, int G, int P>
__global__ void __launch_bounds__(kSumThreads)
    list_sum_kernel(const SumArgs a) {
  row_sum<VEC, G, P, false>(a);
}

template <int VEC, int G, int P>
__global__ void __launch_bounds__(kSumThreads)
    run_sum_kernel(const SumArgs a) {
  row_sum<VEC, G, P, true>(a);
}

enum class SumKind { kStage2, kLists, kRuns };

template <int N>
using Int = std::integral_constant<int, N>;

// Calls f(Int<VEC>, Int<G>, Int<P>) for the row shape of C: C <= 16 a
// group of 1, 2 or 4 lanes a row, one float a lane and chunk; wider rows
// the whole warp, with the widest vector that divides C, fills the warp
// and is aligned.
template <class F>
inline void with_row_shape(const void* src, const float* dst, int c_dim,
                           F&& f) {
  if (c_dim == 1) return f(Int<1>{}, Int<1>{}, Int<1>{});
  if (c_dim == 2) return f(Int<1>{}, Int<2>{}, Int<1>{});
  if (c_dim <= 4) return f(Int<1>{}, Int<4>{}, Int<1>{});
  if (c_dim <= 8) return f(Int<1>{}, Int<4>{}, Int<2>{});
  if (c_dim <= 16) return f(Int<1>{}, Int<4>{}, Int<4>{});
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst);
  int vec = 1;
  if (c_dim % 4 == 0 && c_dim >= 128 && addr % 16 == 0) vec = 4;
  else if (c_dim % 2 == 0 && c_dim >= 64 && addr % 8 == 0) vec = 2;
  const int chunks = (c_dim + 32 * vec - 1) / (32 * vec);
  const int p = chunks <= 1 ? 1 : chunks <= 2 ? 2 : 4;
  if (vec == 4) {
    if (p == 1) return f(Int<4>{}, Int<32>{}, Int<1>{});
    if (p == 2) return f(Int<4>{}, Int<32>{}, Int<2>{});
    return f(Int<4>{}, Int<32>{}, Int<4>{});
  }
  if (vec == 2) {
    if (p == 1) return f(Int<2>{}, Int<32>{}, Int<1>{});
    if (p == 2) return f(Int<2>{}, Int<32>{}, Int<2>{});
    return f(Int<2>{}, Int<32>{}, Int<4>{});
  }
  if (p == 1) return f(Int<1>{}, Int<32>{}, Int<1>{});
  if (p == 2) return f(Int<1>{}, Int<32>{}, Int<2>{});
  return f(Int<1>{}, Int<32>{}, Int<4>{});
}

template <SumKind KIND, typename S = float>
inline int launch_row_sums(const SumArgs& a, cudaStream_t st) {
  if (a.rows <= 0) return 0;
  with_row_shape(a.src, a.dst, a.c_dim, [&](auto vec, auto g, auto p) {
    constexpr int V = decltype(vec)::value, G = decltype(g)::value,
                  P = decltype(p)::value;
    constexpr int rows_per_block = (kSumThreads / 32) * (32 / G);
    const unsigned blocks =
        (unsigned)((a.rows + rows_per_block - 1) / rows_per_block);
    if constexpr (KIND == SumKind::kStage2)
      inverse_sum_kernel<V, G, P, S><<<blocks, kSumThreads, 0, st>>>(a);
    else if constexpr (KIND == SumKind::kLists)
      list_sum_kernel<V, G, P><<<blocks, kSumThreads, 0, st>>>(a);
    else
      run_sum_kernel<V, G, P><<<blocks, kSumThreads, 0, st>>>(a);
  });
  return (int)cudaGetLastError();
}

// dst [rows, C] = each row r's list [off[r], off[r + 1]) of src rows
// ent[e], summed in order: C's and D's stage 2, or (kLists) the
// standalone sums.
template <SumKind KIND = SumKind::kStage2, typename S = float>
inline int launch_inverse_sum(const int32_t* off, const int32_t* ent,
                              const S* src, long long rows, int c_dim,
                              float* dst, cudaStream_t st) {
  SumArgs a{};
  a.off = off;
  a.ent = ent;
  a.src = src;
  a.rows = rows;
  a.c_dim = c_dim;
  a.dst = dst;
  return launch_row_sums<KIND, S>(a, st);
}

// ---------------------------------------------------------------------------
// The build (see the header comment). Slot i = row * k + j of nb (row =
// b * nq + q, column j < k of a row of ld columns); its support
// b * ns + nb[row * ld + j].

// The units of the phases (the chain of phases, not their size, sets the
// build's time: see the header comment)
constexpr int kBuildThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kSlotUnit = kBuildThreads * kSlotsPerThread;   // phases 0, 2
constexpr int kScanPerThread = 8;
constexpr int kScanTile = kBuildThreads * kScanPerThread;    // phase 1
constexpr int kSegsPerWarp = 2;
constexpr int kSegUnit = (kBuildThreads / 32) * kSegsPerWarp;  // phase 3
// Control words at the head of the scratch, each on a 128-byte line of
// its own: the ticket counter and the counts of finished blocks of phases
// 0, 1 and 2, on which the next phases' blocks wait
constexpr int kLine = 32;
enum { kTicket = 0, kDone = kLine };
constexpr int kCtrlWords = 4 * kLine;

inline long long scan_tiles(long long segs) {
  return segs > 0 ? (segs + kScanTile - 1) / kScanTile : 1;
}

// Scratch words of a build: control words, the tiles' published sums and
// the counts (zeroed by the build's memset), then each slot's arrival in
// its segment and a copy of the entries in fill order.
inline long long build_scratch_words(long long segs, long long slots) {
  return kCtrlWords + scan_tiles(segs) + segs + 2 * slots;
}

struct BuildArgs {
  const int32_t* nb;
  int nq, k, ld, ns;
  int slots, segs;
  int units_slots, units_tiles, units_segs;
  int* ctrl;
  int* tile_sum;                // a tile's count sum + 1, once published
  int* count;
  int* arrival;                 // each slot's place in its segment's count
  int32_t* fill;
  int32_t* off;
  int32_t* ent;
};

__device__ __forceinline__ int slot_support(const BuildArgs& a, int i) {
  const unsigned row = (unsigned)i / (unsigned)a.k;
  const int j = i - (int)(row * (unsigned)a.k);
  const int s = a.nb[(size_t)row * a.ld + j];
  if (s < 0 || s >= a.ns) return -1;
  return (int)(row / (unsigned)a.nq) * a.ns + s;
}

// A finished block of phase p: counted with release semantics after the
// block's barrier, so that its writes are visible to whoever sees the
// count (the arrival of CUTLASS's GenericBarrier).
__device__ __forceinline__ void arrive(const BuildArgs& a, int p) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
                 :: "l"(a.ctrl + kDone + p * kLine), "r"(1) : "memory");
  }
}

// Wait until n blocks of phase p have arrived. Data that other blocks
// wrote is then read with __ldcg (from L2, never a stale L1 line).
__device__ __forceinline__ void wait_for(const BuildArgs& a, int p, int n) {
  if (threadIdx.x == 0) {
    const int* done = a.ctrl + kDone + p * kLine;
    int seen;
    for (;;) {
      asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
                   : "=r"(seen) : "l"(done) : "memory");
      if (seen >= n) break;
      __nanosleep(100);
    }
  }
  __syncthreads();
}

// Exclusive scan of one int a thread over the block; *total gets the sum.
__device__ __forceinline__ int block_scan(int mine, int* warp_sums,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBuildThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += u;
    }
    if (lane < kBuildThreads / 32) warp_sums[lane] = w;   // inclusive
  }
  __syncthreads();
  const int excl = incl - mine + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kBuildThreads / 32 - 1];
  __syncthreads();                                 // warp_sums reused
  return excl;
}

// The supports of a thread's kSlotsPerThread slots of a unit, their
// index loads issued together.
__device__ __forceinline__ void unit_supports(const BuildArgs& a, int unit,
                                              int* slot, int* sup) {
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r) {
    slot[r] = unit * kSlotUnit + r * kBuildThreads + (int)threadIdx.x;
    sup[r] = slot[r] < a.slots ? slot_support(a, slot[r]) : -1;
  }
}

__device__ __forceinline__ void count_phase(const BuildArgs& a, int unit) {
  int slot[kSlotsPerThread], sup[kSlotsPerThread], arrival[kSlotsPerThread];
  unit_supports(a, unit, slot, sup);
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r)
    arrival[r] = sup[r] >= 0 ? atomicAdd(a.count + sup[r], 1) : 0;
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r)
    if (sup[r] >= 0) a.arrival[slot[r]] = arrival[r];
}

// A tile scans its counts, publishes its sum at once, then adds the sums
// of the tiles before it as they appear (each published by a block with
// an earlier ticket, before that block waits for anything).
__device__ __forceinline__ void scan_phase(const BuildArgs& a, int tile,
                                           int* warp_sums) {
  const int j0 = tile * kScanTile + threadIdx.x * kScanPerThread;
  int v[kScanPerThread], mine = 0, before = 0, tile_total;
#pragma unroll
  for (int e = 0; e < kScanPerThread; ++e) {
    v[e] = j0 + e < a.segs ? __ldcg(a.count + j0 + e) : 0;
    mine += v[e];
  }
  const int excl = block_scan(mine, warp_sums, &tile_total);
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.b32 [%0], %1;"
                 :: "l"(a.tile_sum + tile), "r"(tile_total + 1) : "memory");
  for (int u = threadIdx.x; u < tile; u += kBuildThreads) {
    int seen;
    for (;;) {
      asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
                   : "=r"(seen) : "l"(a.tile_sum + u) : "memory");
      if (seen) break;
      __nanosleep(32);
    }
    before += seen - 1;
  }
  block_scan(before, warp_sums, &before);          // the tiles before
  int run = before + excl;
#pragma unroll
  for (int e = 0; e < kScanPerThread; ++e) {
    if (j0 + e < a.segs) a.off[j0 + e] = run;
    run += v[e];
  }
  if (tile == a.units_tiles - 1 && threadIdx.x == kBuildThreads - 1)
    a.off[a.segs] = run;                           // the total
}

__device__ __forceinline__ void fill_phase(const BuildArgs& a, int unit) {
  int slot[kSlotsPerThread], sup[kSlotsPerThread], lo[kSlotsPerThread],
      arrival[kSlotsPerThread];
  unit_supports(a, unit, slot, sup);
  // each slot's offset and arrival, all loads in flight, then the stores
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r) {
    lo[r] = sup[r] >= 0 ? __ldcg(a.off + sup[r]) : 0;
    arrival[r] = sup[r] >= 0 ? __ldcg(a.arrival + slot[r]) : 0;
  }
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r)
    if (sup[r] >= 0) a.fill[lo[r] + arrival[r]] = slot[r];
}

// Each of a warp's kSegsPerWarp consecutive segments: its slots written
// at their ranks. The warp loads the segments' offsets at once, then the
// first 32 slots of every segment, before it ranks them.
__device__ __forceinline__ void order_phase(const BuildArgs& a, int unit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = (unit * (kBuildThreads / 32) + warp) * kSegsPerWarp;
  if (s0 >= a.segs) return;                        // the whole warp
  const int nseg = min(kSegsPerWarp, a.segs - s0);
  const int32_t* __restrict__ fill = a.fill;
  const int offs = lane <= nseg ? __ldcg(a.off + s0 + lane) : 0;
  int first[kSegsPerWarp];
#pragma unroll
  for (int q = 0; q < kSegsPerWarp; ++q) {
    const int lo = __shfl_sync(kFull, offs, q);
    const int len = __shfl_sync(kFull, offs, q + 1) - lo;
    first[q] = q < nseg && lane < len ? __ldcg(fill + lo + lane) : INT_MAX;
  }
#pragma unroll
  for (int q = 0; q < kSegsPerWarp; ++q) {
    if (q >= nseg) break;
    const int lo = __shfl_sync(kFull, offs, q);
    const int len = __shfl_sync(kFull, offs, q + 1) - lo;
    for (int b0 = 0; b0 < len; b0 += 32) {
      const int mine = b0 == 0 ? first[q]
                               : (b0 + lane < len ? __ldcg(fill + lo + b0
                                                           + lane)
                                                  : INT_MAX);
      int rank = 0;
      for (int c0 = 0; c0 < len; c0 += 32) {
        const int y = c0 == b0 ? mine
                               : (c0 == 0 ? first[q]
                                          : (c0 + lane < len
                                                 ? __ldcg(fill + lo + c0
                                                          + lane)
                                                 : INT_MAX));
        // lanes past the segment hold INT_MAX and count for no one, so
        // the 32 shuffles need no bound and issue back to back
#pragma unroll
        for (int j = 0; j < 32; ++j)
          rank += __shfl_sync(kFull, y, j) < mine ? 1 : 0;
      }
      if (b0 + lane < len) a.ent[lo + rank] = mine;
    }
  }
}

__global__ void __launch_bounds__(kBuildThreads)
    inverse_build_kernel(const BuildArgs a) {
  __shared__ int ticket;
  __shared__ int warp_sums[kBuildThreads / 32];
  if (threadIdx.x == 0) ticket = atomicAdd(a.ctrl + kTicket, 1);
  __syncthreads();
  int t = ticket;
  if (t < a.units_slots) {
    count_phase(a, t);
    arrive(a, 0);
    return;
  }
  t -= a.units_slots;
  if (t < a.units_tiles) {
    wait_for(a, 0, a.units_slots);
    scan_phase(a, t, warp_sums);
    arrive(a, 1);
    return;
  }
  t -= a.units_tiles;
  if (t < a.units_slots) {
    wait_for(a, 1, a.units_tiles);
    fill_phase(a, t);
    arrive(a, 2);
    return;
  }
  t -= a.units_slots;
  wait_for(a, 1, a.units_tiles);                   // with no slots, the
  wait_for(a, 2, a.units_slots);                   // offsets only
  order_phase(a, t);
}

// scratch: build_scratch_words(b * ns, b * nq * k) ints; off: b * ns + 1;
// ent: b * nq * k (the first off[b * ns] hold the lists).
inline int build(const int32_t* nb, int b, int nq, int k, int ld, int ns,
                 int32_t* scratch, long long scratch_words, int32_t* off,
                 int32_t* ent, cudaStream_t st) {
  const long long segs = (long long)b * ns;
  const long long slots = (long long)b * nq * k;
  if (segs >= (1LL << 30) || slots >= (1LL << 30) ||
      scratch_words < build_scratch_words(segs, slots))
    return (int)cudaErrorInvalidValue;
  BuildArgs a{};
  a.nb = nb;
  a.nq = nq;
  a.k = k;
  a.ld = ld;
  a.ns = ns;
  a.slots = (int)slots;
  a.segs = (int)segs;
  a.units_slots = (int)((slots + kSlotUnit - 1) / kSlotUnit);
  a.units_tiles = (int)scan_tiles(segs);
  a.units_segs = (int)((segs + kSegUnit - 1) / kSegUnit);
  a.ctrl = scratch;
  a.tile_sum = scratch + kCtrlWords;
  a.count = a.tile_sum + a.units_tiles;
  a.arrival = a.count + segs;
  a.fill = a.arrival + slots;
  a.off = off;
  a.ent = ent;
  int err = (int)cudaMemsetAsync(
      scratch, 0, (size_t)(kCtrlWords + a.units_tiles + segs) * sizeof(int),
      st);
  if (err) return err;
  const unsigned blocks =
      2u * a.units_slots + a.units_tiles + a.units_segs;
  inverse_build_kernel<<<blocks, kBuildThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace inverse_lists
