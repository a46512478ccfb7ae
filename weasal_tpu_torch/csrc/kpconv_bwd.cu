// Rigid KPConv backward (sum aggregation): the VJP of kernel B.
//
// Replaces the Pallas TPU kernel weasal_tpu/ops/pallas/kpconv_banded.py
// (`_bwd_kernel` behind `_bwd_rule`, the custom VJP of `kpconv_banded`):
//
//   dr[q, p, :] = g[q] @ W_p^T                       [rows, Kp*Cin]
//   dX[b, s]   += sum_p h_p(s - q) * dr[q, p, :]      for every (q, k)
//                                                     with nb[q, k] = s < Ns
//   dW_p        = y_p^T @ g                          y = forward aggregate
//
// Shadows (nb >= Ns) contribute nothing. Points and kernel points get no
// gradient (the TPU kernel returned zeros for them).
//
// The TPU kernel kept dX free of scatters by accumulating a membership-
// weighted influence matrix product into a per-sphere slab, one query
// tile after another, so its sums ran in a fixed order. Blocks on the
// H100 run in parallel and in no order, so dX takes two stages that keep
// the order fixed (inverse_lists.cuh): `dx_contrib_kernel`, one block per
// query row, recomputes its Kp x K influences exactly as kernel B does
// (kpconv_common.cuh); each thread owns channels c, holds the Kp values
// dr[q, :, c] in registers and writes sum_p h_p * dr_p for every real
// slot k into the workspace xws[(row * K + k), c] (zeros included); then
// `inverse_sum_kernel` adds each support's slots in ascending (row, slot)
// order over its inverse neighbor list, which the caller builds once per
// pyramid edge and shares among the convs on it. Each thread of the first
// stage owns 1, 2 or 4 consecutive channels (by Cin), so one shared-memory
// read of an influence serves that many multiply-adds. dW reuses the y that
// kernel B wrote in the forward (the autograd Function keeps it).
//
// What bounds it on the H100: the two contractions, 2 x 2 * rows * Kp*Cin
// * Cout operations, at the wide levels; at level 0 the workspace's
// traffic (rows * K * Cin floats written and read once). Launches on one
// stream:
//  1. dr = g @ W^T by the GEMM core of kpconv_common.cuh (3xTF32 on the
//     tensor cores, both operands K-major);
//  2. `dx_contrib_kernel`, then `inverse_sum_kernel` into dX (1 and 2 are
//     skipped when x needs no gradient);
//  3. dW = y^T @ g by the same core, y read M-major as it lies. Its depth
//     (rows, 17k-49k) is long and its output small (<= 7680 x 256, at
//     most 240 tiles for 264 resident blocks), so plan_gemm splits the
//     depth over enough blocks to fill the card; the blocks write partial
//     sums to the caller's workspace and a second launch adds them in a
//     fixed order, so dW is deterministic.
// f32 in and out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inverse_lists.cuh"
#include "kpconv_common.cuh"

namespace {

using kpconv_common::kMaxKp;

// VEC consecutive channels a thread: each influence read from shared
// memory serves VEC multiply-adds (one channel a thread was bound by those
// reads), and the workspace gets VEC-wide stores.
template <int VEC>
__global__ void dx_contrib_kernel(const float* __restrict__ q,
                                  const float* __restrict__ s,
                                  const int32_t* __restrict__ nb,
                                  const float* __restrict__ kp,
                                  const float* __restrict__ dr, int nq,
                                  int ns, int k, int n_kp, int cin, float ext,
                                  int influence, float gauss_den,
                                  float* __restrict__ xws) {
  extern __shared__ float smem[];
  float* h = smem;                                   // [n_kp * k]
  int* nbs = reinterpret_cast<int*>(smem + n_kp * k);  // [k]

  const size_t row = blockIdx.x;                     // b * nq + qi
  const int b = (int)(row / nq);
  kpconv_common::row_influences(row, b, q, s, nb, kp, ns, k, n_kp, ext,
                                influence, gauss_den, h, nbs);

  const float* drr = dr + row * (size_t)n_kp * cin;
  float* out = xws + row * (size_t)k * cin;
  for (int c = threadIdx.x * VEC; c < cin; c += blockDim.x * VEC) {
    inverse_lists::Vec<VEC> d[kMaxKp];
#pragma unroll
    for (int p = 0; p < kMaxKp; ++p) {
      if (p < n_kp) {
        d[p] = inverse_lists::load_vec<VEC>(drr + (size_t)p * cin + c);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) d[p].v[v] = 0.f;
      }
    }
    for (int j = 0; j < k; ++j) {
      if (nbs[j] < 0) continue;                      // not in any list
      inverse_lists::Vec<VEC> acc;
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc.v[v] = 0.f;
#pragma unroll
      for (int p = 0; p < kMaxKp; ++p) {
        if (p < n_kp) {
          const float hp = h[p * k + j];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc.v[v] = fmaf(hp, d[p].v[v],
                                                        acc.v[v]);
        }
      }
      inverse_lists::store_vec<VEC>(out + (size_t)j * cin + c, acc);
    }
  }
}

template <int VEC>
void launch_contrib(const float* q, const float* s, const int32_t* nb,
                    const float* kp, const float* dr, long long rows, int nq,
                    int ns, int k, int n_kp, int cin, float ext,
                    int influence, float gauss_den, float* xws, size_t smem,
                    cudaStream_t st) {
  int threads = ((cin / VEC + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  dx_contrib_kernel<VEC><<<(unsigned)rows, threads, smem, st>>>(
      q, s, nb, kp, dr, nq, ns, k, n_kp, cin, ext, influence, gauss_den,
      xws);
}

}  // namespace

// Floats of workspace that kpconv_bwd_launch needs for its split-K GEMMs
// at these sizes (0: none); the two products run in turn and share it.
extern "C" long long kpconv_bwd_workspace(long long rows, int kdim, int cout,
                                          int need_dx) {
  if (rows <= 0) return 0;
  long long ws = kpconv_common::plan_gemm(kdim, cout, (int)rows).ws_floats;
  if (need_dx) {
    const long long dr =
        kpconv_common::plan_gemm((int)rows, kdim, cout).ws_floats;
    if (dr > ws) ws = dr;
  }
  return ws;
}

// q [B,Nq,3], s [B,Ns,3], nb [B,Nq,K] i32, y [B*Nq, Kp*Cin] (kernel B's
// aggregate), kp [Kp,3], w [Kp,Cin,Cout], g [B,Nq,Cout]; with dX also the
// inverse lists of nb (inv_off [B*Ns+1], inv_ent, inverse_lists.cuh) and
// scratch dr [B*Nq, Kp*Cin] and xws [B*Nq*K, Cin]; scratch ws (ws_floats
// floats, at least kpconv_bwd_workspace); outputs dx [B,Ns,Cin] (written
// only when need_dx) and dw [Kp,Cin,Cout]. f32, contiguous. influence:
// 0 constant, 1 linear, 2 gaussian. Returns cudaGetLastError() after the
// last launch, cudaErrorInvalidValue for a workspace too short.
extern "C" int kpconv_bwd_launch(const float* q, const float* s,
                                 const int32_t* nb, const float* y,
                                 const float* kp, const float* w,
                                 const float* g, int b, int nq, int ns,
                                 int k, int n_kp, int cin, int cout,
                                 float ext, int influence, float gauss_den,
                                 int need_dx, const int32_t* inv_off,
                                 const int32_t* inv_ent, float* dr,
                                 float* xws, float* dx, float* dw,
                                 float* ws, long long ws_floats,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_kp < 1 || n_kp > kMaxKp || k < 1 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kpconv_common::influence_smem_bytes(n_kp, k);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * nq;
  const int kdim = n_kp * cin;
  int err = 0;

  if (need_dx) {
    if (rows > 0) {
      err = kpconv_common::gemm_tf32x3<true, true>(
          g, w, dr, ws, ws_floats, (int)rows, kdim, cout, st);
      if (err) return err;
      // dr and xws come from the allocator (256-byte aligned), so with
      // Cin a multiple of VEC every VEC-wide access is aligned
      if (cin % 4 == 0 && cin >= 128)
        launch_contrib<4>(q, s, nb, kp, dr, rows, nq, ns, k, n_kp, cin, ext,
                          influence, gauss_den, xws, smem, st);
      else if (cin % 2 == 0 && cin >= 64)
        launch_contrib<2>(q, s, nb, kp, dr, rows, nq, ns, k, n_kp, cin, ext,
                          influence, gauss_den, xws, smem, st);
      else
        launch_contrib<1>(q, s, nb, kp, dr, rows, nq, ns, k, n_kp, cin, ext,
                          influence, gauss_den, xws, smem, st);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
    // Every support row of dX is written, an empty list as zeros
    err = inverse_lists::launch_inverse_sum(inv_off, inv_off + 1, inv_ent,
                                            xws, (long long)b * ns, cin, dx,
                                            st);
    if (err) return err;
  }
  // With rows = 0 the depth is empty and the core writes zeros.
  return kpconv_common::gemm_tf32x3<false, false>(
      y, g, dw, ws, ws_floats, kdim, cout, (int)rows, st);
}
