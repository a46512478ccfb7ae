// Neighborhood max-pool backward: the VJP of out[q, c] = max_k xs[q, k, c]
// with xs[q, k, c] = x[nb[q, k], c] for a support and 0.0 for a shadow
// slot (nb >= Ns).
//
// Replaces the Pallas TPU kernel weasal_tpu/ops/pallas/maxpool_banded.py
// (`_bwd_kernel` behind `maxpool_bwd_banded`, the custom VJP of
// `max_pool_banded`), whose semantics are jnp.max's VJP:
//
//   dX[nb[q, k], c] += g[q, c] / ties[q, c]   for every slot k with
//                                              xs[q, k, c] == out[q, c]
//
// Ties split the gradient equally. A shadow slot takes part with 0.0: where
// the maximum is 0.0 the shadow slots count among the ties and their
// shares are dropped.
//
// The TPU kernel consumed a winner mask [B, Nq, K, C] that the forward
// built, and turned the scatter into membership matrix products over a
// window of sorted supports, summing in a fixed order. Here the maximum
// and the tie count are recomputed from x and nb, so the mask is never
// built, and dX takes two stages that keep the order fixed
// (inverse_lists.cuh): the kernel below writes each real slot's share,
// or 0.0, into a workspace [rows * K, C], and `inverse_sum_kernel` adds
// each support's slots in ascending (row, slot) order over the pool
// edge's inverse neighbor list (a support is pooled by several rows);
// the neighbor list is exact, so there is no window.
//
// What bounds it on the H100: memory. The least traffic is x, nb and g
// read once and dX written once; the workspace adds rows * K * C floats
// written and read once. Design: one warp per query row, 8 rows per
// block. The warp loads the row's K indices once (lane j holds slot j)
// and shares them with __shfl_sync; the lanes run across channels, VEC
// consecutive channels a lane (float2 at C = 64, float4 at C = 128, one
// load each).
// One pass over the K slots gathers each value once and keeps, per
// channel, the running maximum, its tie count and a bit mask of the slots
// that hold it (reset when the maximum rises); the second pass writes the
// masked slots' shares, so nothing is gathered twice and the K values
// need no registers. Slots past the mask's MAXK bits (K > 64; never on the
// main path) are gathered again in the second pass, in the same kernel.
// Measured on the main path's pools (H100, before the workspace, when the
// shares went to dX by f32 atomics;
// weasal_tpu_torch/tools/kernel_variants.py): the kernel's time was
// neither its gathers nor its atomics (without both it took 90-94 % as
// long) but the per-slot stream of shuffles, compares and mask updates
// over 34k and 17k short warps. So the updates are selects, not branches
// that split the warp (branches: 1.14x the time), and the masks are 32
// bits wide where K <= 32 (64-bit masks: 1.2x).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "inverse_lists.cuh"

namespace {

constexpr int kRowsPerBlock = 8;                     // one warp per row
constexpr unsigned kFull = 0xffffffffu;

using inverse_lists::load_vec;
using inverse_lists::store_vec;
using inverse_lists::Vec;

// MASK: uint32_t or uint64_t, one bit per slot below MAXK = its width.
template <typename MASK, int VEC>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    maxpool_bwd_kernel(const float* __restrict__ x,
                       const int32_t* __restrict__ nb,
                       const float* __restrict__ g, long long rows, int nq,
                       int ns, int k, int c_dim, float* __restrict__ ws) {
  constexpr int MAXK = 8 * sizeof(MASK);
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;                           // whole warp
  const int lane = threadIdx.x & 31;
  const int b = (int)(row / nq);
  const int32_t* nrow = nb + row * k;
  // Slot lane and slot 32 + lane of the row; -1 for a shadow slot
  int n_lo = -1, n_hi = -1;
  if (lane < k) {
    const int n = nrow[lane];
    n_lo = (n >= 0 && n < ns) ? n : -1;
  }
  if (MAXK > 32 && 32 + lane < k) {
    const int n = nrow[32 + lane];
    n_hi = (n >= 0 && n < ns) ? n : -1;
  }
  const float* xb = x + (size_t)b * ns * c_dim;

  for (int c0 = 0; c0 < c_dim; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool on = c < c_dim;                       // c_dim % VEC == 0
    Vec<VEC> gv;
    bool any = false;
#pragma unroll
    for (int e = 0; e < VEC; ++e) gv.v[e] = 0.f;
    if (on) {
      gv = load_vec<VEC>(g + row * c_dim + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) any |= gv.v[e] != 0.f;
    }
    float m[VEC];
    int ties[VEC];
    MASK win[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      m[e] = -INFINITY;
      ties[e] = 0;
      win[e] = 0;
    }
    // Pass 1: maximum, tie count and winning slots (all lanes shuffle)
    for (int j = 0; j < k; ++j) {
      int n;
      if (j < MAXK) {
        n = __shfl_sync(kFull, j < 32 ? n_lo : n_hi, j & 31);
      } else {
        n = nrow[j];
        n = (n >= 0 && n < ns) ? n : -1;
      }
      if (!any) continue;
      Vec<VEC> v;
      if (n >= 0) {
        v = load_vec<VEC>(xb + (size_t)n * c_dim + c);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v.v[e] = 0.f;
      }
      const MASK bit = j < MAXK ? (MASK)1 << j : (MASK)0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {               // selects, no branches
        const bool above = v.v[e] > m[e], tie = v.v[e] == m[e];
        m[e] = above ? v.v[e] : m[e];
        ties[e] = above ? 1 : ties[e] + (int)tie;
        win[e] = above ? bit : (tie ? win[e] | bit : win[e]);
      }
    }
    float share[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      share[e] = __fdiv_rn(gv.v[e], (float)(ties[e] > 0 ? ties[e] : 1));
    // Pass 2: every real slot's share or 0.0 into the workspace, the
    // masked slots from their bits, the slots past them gathered again
    float* out = ws + (size_t)row * k * c_dim + c;
    for (int j = 0; j < k; ++j) {
      int n;
      if (j < MAXK) {
        n = __shfl_sync(kFull, j < 32 ? n_lo : n_hi, j & 31);
      } else {
        n = nrow[j];
        n = (n >= 0 && n < ns) ? n : -1;
      }
      if (n < 0 || !on) continue;                    // not in any list
      Vec<VEC> w;
      if (j < MAXK) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          w.v[e] = (gv.v[e] != 0.f && ((win[e] >> j) & 1)) ? share[e] : 0.f;
      } else {
        Vec<VEC> v;
#pragma unroll
        for (int e = 0; e < VEC; ++e) v.v[e] = 0.f;
        if (any) v = load_vec<VEC>(xb + (size_t)n * c_dim + c);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          w.v[e] = (gv.v[e] != 0.f && v.v[e] == m[e]) ? share[e] : 0.f;
      }
      store_vec<VEC>(out + (size_t)j * c_dim, w);
    }
  }
}

template <typename MASK, int VEC>
void launch(const float* x, const int32_t* nb, const float* g,
            long long rows, int nq, int ns, int k, int c_dim, float* ws,
            cudaStream_t st) {
  const unsigned blocks =
      (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  maxpool_bwd_kernel<MASK, VEC><<<blocks, kRowsPerBlock * 32, 0, st>>>(
      x, nb, g, rows, nq, ns, k, c_dim, ws);
}

template <typename MASK>
void launch_vec(const float* x, const int32_t* nb, const float* g,
                long long rows, int nq, int ns, int k, int c_dim, float* ws,
                cudaStream_t st) {
  // The widest vector that divides C, fills the warp and is aligned
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(ws);
  if (c_dim % 4 == 0 && c_dim >= 128 && addr % 16 == 0)
    launch<MASK, 4>(x, nb, g, rows, nq, ns, k, c_dim, ws, st);
  else if (c_dim % 2 == 0 && c_dim >= 64 && addr % 8 == 0)
    launch<MASK, 2>(x, nb, g, rows, nq, ns, k, c_dim, ws, st);
  else
    launch<MASK, 1>(x, nb, g, rows, nq, ns, k, c_dim, ws, st);
}

}  // namespace

// x [B,Ns,C], nb [B,Nq,K] i32, g [B,Nq,C]; the inverse lists of nb
// (inv_off [B*Ns+1], inv_ent, inverse_lists.cuh); scratch ws
// [B*Nq*K, C]; output dx [B,Ns,C]; f32, contiguous. Writes every row of
// dx. Returns cudaGetLastError() after the last launch.
extern "C" int maxpool_bwd_launch(const float* x, const int32_t* nb,
                                  const float* g, int b, int nq, int ns,
                                  int k, int c_dim, const int32_t* inv_off,
                                  const int32_t* inv_ent, float* ws,
                                  float* dx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || c_dim < 1 || b < 0 || nq < 0 || ns < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * nq;
  if (rows > 0) {
    if (k <= 32)
      launch_vec<uint32_t>(x, nb, g, rows, nq, ns, k, c_dim, ws, st);
    else
      launch_vec<uint64_t>(x, nb, g, rows, nq, ns, k, c_dim, ws, st);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return inverse_lists::launch_inverse_sum(inv_off, inv_off + 1, inv_ent, ws,
                                           (long long)b * ns, c_dim, dx, st);
}
