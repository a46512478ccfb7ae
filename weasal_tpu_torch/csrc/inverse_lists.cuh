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
// The inverse lists of an index tensor nb [B, Nq, ld] (its first K
// columns, an index outside 0..Ns-1 a shadow that is skipped) are built in
// five launches that read nothing back to the host, so a CUDA graph can
// capture them: zero the counts; count each support's slots (an int
// atomicAdd, exact in any order); one block scans the counts into the
// offsets [B * Ns + 1]; each slot takes a place in its support's segment
// by an atomic cursor; each segment is then sorted (insertion sort, one
// thread a segment: the segments hold tens of slots), which makes the
// order the same on every run. An entry is the flat slot (b*Nq + q)*K + k,
// the workspace's row.
//
// inverse_sum_kernel: one warp per destination row r, lanes across
// channels (VEC consecutive floats a lane); the sum of rows src[e] for e
// in its segment [lo[r], hi[r]) (through entries when given) starts at
// 0.0 and adds in ascending e order, the order of a sequential
// index_add_ on the CPU. It writes every row, so dst needs no zeroing.
// Bounded by bytes: each source row read once, each destination row
// written once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace inverse_lists {

constexpr int kRowsPerBlock = 8;                     // one warp per row
constexpr int kScanThreads = 1024;
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

// dst[r, :] = sum over e in [lo[r], hi[r]) of src[ent ? ent[e] : e, :]
template <int VEC>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    inverse_sum_kernel(const int32_t* __restrict__ lo,
                       const int32_t* __restrict__ hi,
                       const int32_t* __restrict__ ent,
                       const float* __restrict__ src, long long rows,
                       int c_dim, float* __restrict__ dst) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;                           // whole warp
  const int lane = threadIdx.x & 31;
  const int e0 = lo[row], e1 = hi[row];
  for (int c0 = 0; c0 < c_dim; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool on = c < c_dim;                       // c_dim % VEC == 0
    Vec<VEC> acc;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc.v[e] = 0.f;
    // The warp loads 32 entries at a time, one a lane, and shares them
    for (int base = e0; base < e1; base += 32) {
      const int n = min(32, e1 - base);
      int mine = 0;
      if (lane < n) mine = ent ? ent[base + lane] : base + lane;
      for (int j = 0; j < n; ++j) {
        const int i = __shfl_sync(kFull, mine, j);
        if (on) {
          const Vec<VEC> v = load_vec<VEC>(src + (size_t)i * c_dim + c);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc.v[e] = __fadd_rn(acc.v[e],
                                                             v.v[e]);
        }
      }
    }
    if (on) store_vec<VEC>(dst + (size_t)row * c_dim + c, acc);
  }
}

// The widest vector that divides C, fills the warp and is aligned.
inline int sum_vec_width(const float* src, const float* dst, int c_dim) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst);
  if (c_dim % 4 == 0 && c_dim >= 128 && addr % 16 == 0) return 4;
  if (c_dim % 2 == 0 && c_dim >= 64 && addr % 8 == 0) return 2;
  return 1;
}

inline int launch_inverse_sum(const int32_t* lo, const int32_t* hi,
                              const int32_t* ent, const float* src,
                              long long rows, int c_dim, float* dst,
                              cudaStream_t st) {
  if (rows <= 0) return 0;
  const unsigned blocks =
      (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const int vec = sum_vec_width(src, dst, c_dim);
  if (vec == 4)
    inverse_sum_kernel<4><<<blocks, kRowsPerBlock * 32, 0, st>>>(
        lo, hi, ent, src, rows, c_dim, dst);
  else if (vec == 2)
    inverse_sum_kernel<2><<<blocks, kRowsPerBlock * 32, 0, st>>>(
        lo, hi, ent, src, rows, c_dim, dst);
  else
    inverse_sum_kernel<1><<<blocks, kRowsPerBlock * 32, 0, st>>>(
        lo, hi, ent, src, rows, c_dim, dst);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The build. Slot i = row * k + j of nb (row = b * nq + q, column j < k of
// a row of ld columns); its support b * ns + nb[row * ld + j].

__device__ __forceinline__ int slot_support(const int32_t* __restrict__ nb,
                                            long long i, int nq, int k,
                                            int ld, int ns) {
  const long long row = i / k;
  const int j = (int)(i - row * k);
  const int s = nb[row * ld + j];
  if (s < 0 || s >= ns) return -1;
  return (int)(row / nq) * ns + s;
}

__global__ void inverse_count_kernel(const int32_t* __restrict__ nb,
                                     long long slots, int nq, int k, int ld,
                                     int ns, int* __restrict__ count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= slots) return;
  const int seg = slot_support(nb, i, nq, k, ld, ns);
  if (seg >= 0) atomicAdd(count + seg, 1);
}

// One block: off[j] = sum of count[0..j), off[n] = the total; the counts
// become each segment's fill cursor (= its offset). The block walks tiles
// of 4 * kScanThreads counts (4 consecutive ones a thread, so a warp's
// loads are contiguous), scans each tile's thread sums by warp shuffles
// and carries the tile's total into the next.
__global__ void __launch_bounds__(kScanThreads)
    inverse_scan_kernel(int* __restrict__ count, int n,
                        int* __restrict__ off) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += 4 * kScanThreads) {
    int v[4], mine = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = base + 4 * t + e;
      v[e] = j < n ? count[j] : 0;
      mine += v[e];
    }
    int incl = mine;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += u;
      }
      warp_sums[lane] = w;                           // inclusive by warp
    }
    __syncthreads();
    int run = carry + incl - mine + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = base + 4 * t + e;
      if (j < n) {
        off[j] = run;
        count[j] = run;
      }
      run += v[e];
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();                                 // warp_sums reused
  }
  if (t == 0) off[n] = carry;
}

__global__ void inverse_fill_kernel(const int32_t* __restrict__ nb,
                                    long long slots, int nq, int k, int ld,
                                    int ns, int* __restrict__ cursor,
                                    int32_t* __restrict__ ent) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= slots) return;
  const int seg = slot_support(nb, i, nq, k, ld, ns);
  if (seg >= 0) ent[atomicAdd(cursor + seg, 1)] = (int32_t)i;
}

__global__ void inverse_sort_kernel(const int32_t* __restrict__ off, int n,
                                    int32_t* __restrict__ ent) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int a = off[j], z = off[j + 1];
  for (int i = a + 1; i < z; ++i) {
    const int32_t v = ent[i];
    int m = i - 1;
    while (m >= a && ent[m] > v) {
      ent[m + 1] = ent[m];
      --m;
    }
    ent[m + 1] = v;
  }
}

// count: b * ns ints of scratch; off: b * ns + 1; ent: b * nq * k.
inline int build(const int32_t* nb, int b, int nq, int k, int ld, int ns,
                 int* count, int32_t* off, int32_t* ent, cudaStream_t st) {
  const long long segs = (long long)b * ns;
  const long long slots = (long long)b * nq * k;
  if (segs >= (1LL << 31) || slots >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(count, 0, (size_t)segs * sizeof(int), st);
  if (err) return err;
  const int threads = 256;
  const unsigned slot_blocks = (unsigned)((slots + threads - 1) / threads);
  if (slots > 0) {
    inverse_count_kernel<<<slot_blocks, threads, 0, st>>>(nb, slots, nq, k,
                                                          ld, ns, count);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  inverse_scan_kernel<<<1, kScanThreads, 0, st>>>(count, (int)segs, off);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (slots > 0) {
    inverse_fill_kernel<<<slot_blocks, threads, 0, st>>>(nb, slots, nq, k,
                                                         ld, ns, count, ent);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (segs > 0) {
    inverse_sort_kernel<<<(unsigned)((segs + threads - 1) / threads),
                          threads, 0, st>>>(off, (int)segs, ent);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace inverse_lists
