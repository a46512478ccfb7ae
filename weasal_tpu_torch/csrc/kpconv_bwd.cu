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
// tile after another. Blocks on the H100 run in parallel and in no order,
// so dX is a scatter here: one block per query row recomputes its Kp x K
// influences exactly as kernel B does (kpconv_common.cuh), each thread
// owns channels c, holds the Kp values dr[q, :, c] in registers and adds
// sum_p h_p * dr_p into dX[nb_k, c] with an f32 atomic, skipping exact
// zeros (most of the linear influences are zero). dW reuses the y that
// kernel B wrote in the forward (the autograd Function keeps it).
//
// What bounds it on the H100: the two contractions, 2 x 2 * rows * Kp*Cin
// * Cout operations, at the wide levels; the scatter's atomics (rows *
// K * Cin at most) at level 0. Launches on one stream:
//  1. dr = g @ W^T by the GEMM core of kpconv_common.cuh (3xTF32 on the
//     tensor cores, both operands K-major);
//  2. zero dX, then `scatter_dx` (1 and 2 are skipped when x needs no
//     gradient);
//  3. dW = y^T @ g by the same core, y read M-major as it lies. Its depth
//     (rows, 17k-49k) is long and its output small (<= 7680 x 256, at
//     most 240 tiles for 264 resident blocks), so plan_gemm splits the
//     depth over enough blocks to fill the card; the blocks write partial
//     sums to the caller's workspace and a second launch adds them in a
//     fixed order, so dW is deterministic.
// f32 in and out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kpconv_common.cuh"

namespace {

using kpconv_common::kMaxKp;

__global__ void scatter_dx_kernel(const float* __restrict__ q,
                                  const float* __restrict__ s,
                                  const int32_t* __restrict__ nb,
                                  const float* __restrict__ kp,
                                  const float* __restrict__ dr, int nq,
                                  int ns, int k, int n_kp, int cin, float ext,
                                  int influence, float gauss_den,
                                  float* __restrict__ dx) {
  extern __shared__ float smem[];
  float* h = smem;                                   // [n_kp * k]
  int* nbs = reinterpret_cast<int*>(smem + n_kp * k);  // [k]

  const size_t row = blockIdx.x;                     // b * nq + qi
  const int b = (int)(row / nq);
  kpconv_common::row_influences(row, b, q, s, nb, kp, ns, k, n_kp, ext,
                                influence, gauss_den, h, nbs);

  const float* drr = dr + row * (size_t)n_kp * cin;
  float* dxb = dx + (size_t)b * ns * cin;
  for (int c = threadIdx.x; c < cin; c += blockDim.x) {
    float d[kMaxKp];
#pragma unroll
    for (int p = 0; p < kMaxKp; ++p)
      d[p] = p < n_kp ? drr[(size_t)p * cin + c] : 0.f;
    for (int j = 0; j < k; ++j) {
      const int n = nbs[j];
      if (n < 0) continue;
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < kMaxKp; ++p) {
        if (p < n_kp) acc = fmaf(h[p * k + j], d[p], acc);
      }
      if (acc != 0.f) atomicAdd(dxb + (size_t)n * cin + c, acc);
    }
  }
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
// aggregate), kp [Kp,3], w [Kp,Cin,Cout], g [B,Nq,Cout]; scratch dr
// [B*Nq, Kp*Cin] and ws (ws_floats floats, at least kpconv_bwd_workspace);
// outputs dx [B,Ns,Cin] (written only when need_dx) and dw [Kp,Cin,Cout].
// f32, contiguous. influence: 0 constant, 1 linear, 2 gaussian. Returns
// cudaGetLastError() after the last launch, cudaErrorInvalidValue for a
// workspace too short.
extern "C" int kpconv_bwd_launch(const float* q, const float* s,
                                 const int32_t* nb, const float* y,
                                 const float* kp, const float* w,
                                 const float* g, int b, int nq, int ns,
                                 int k, int n_kp, int cin, int cout,
                                 float ext, int influence, float gauss_den,
                                 int need_dx, float* dr, float* dx,
                                 float* dw, float* ws, long long ws_floats,
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
    err = (int)cudaMemsetAsync(dx, 0, (size_t)b * ns * cin * sizeof(float),
                               st);
    if (err) return err;
    if (rows > 0) {
      err = kpconv_common::gemm_tf32x3<true, true>(
          g, w, dr, ws, ws_floats, (int)rows, kdim, cout, st);
      if (err) return err;
      int threads = ((cin + 31) / 32) * 32;
      threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
      scatter_dx_kernel<<<(unsigned)rows, threads, smem, st>>>(
          q, s, nb, kp, dr, nq, ns, k, n_kp, cin, ext, influence, gauss_den,
          dx);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
  }
  // With rows = 0 the depth is empty and the core writes zeros.
  return kpconv_common::gemm_tf32x3<false, false>(
      y, g, dw, ws, ws_floats, kdim, cout, (int)rows, st);
}
