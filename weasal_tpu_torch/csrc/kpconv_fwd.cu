// Rigid KPConv forward (sum aggregation), gather-based.
//
// Replaces the Pallas TPU kernel weasal_tpu/ops/pallas/kpconv_banded.py
// (`_fwd_kernel` behind `kpconv_banded_pallas` / `kpconv_banded`):
//
//   out[b,q] = sum_p ( sum_k h_p(s[nb_k] - q) * x[b, nb_k] ) @ W_p
//   h_p(d)   = relu(1 - |d - kp_p| / ext)     (linear; constant: 1;
//                                              gaussian: exp(-|d-kp_p|^2/den))
//
// Neighbors with nb >= Ns are shadows and contribute nothing.
//
// The TPU kernel avoided gathers by rebuilding a membership-weighted
// influence matrix over a window of sorted supports; on Hopper a gather of
// the K neighbor rows is cheap, so the kernel gathers and needs no window:
// it is exact, and `oob` is always zero.
//
// What bounds it on the H100: the contraction y @ W, 2 * rows * Kp*Cin *
// Cout operations, dominates at the wide levels (up to 67 GFLOP at
// multi_att.simple1, 512 -> 256); the aggregation step reads K neighbor
// rows of Cin floats per query and does 2*Kp*K*Cin operations. Design,
// two steps on one stream:
//  1. `aggregate`: one block per query row. The block computes the Kp x K
//     influences into shared memory (kpconv_common.cuh: direct differences
//     s - q - kp_p, each axis rounded separately, no fused multiply-add, as
//     the plain version), then each thread owns channels c and keeps all
//     Kp partial sums in registers, so every gathered x[nb_k, c] is read
//     once and used Kp times. It writes y [rows, Kp*Cin] (kernel point
//     major), which the autograd Function keeps for kernel C's dW.
//  2. out = y @ W, W [Kp*Cin, Cout] read N-major as it lies, by the GEMM
//     core of kpconv_common.cuh: 3xTF32 on the tensor cores (wgmma tf32),
//     128 x 64 tiles, 2 blocks per SM. At rows 17136 and Cout 256 the 536
//     tiles leave a last wave of 8 on the 264 resident blocks, so the
//     depth is split (plan_gemm) and the partial sums, written to the
//     caller's workspace, are added by a second launch.
// f32 in and out; bf16 inputs are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kpconv_common.cuh"

namespace {

using kpconv_common::kMaxKp;

__global__ void aggregate_kernel(const float* __restrict__ q,
                                 const float* __restrict__ s,
                                 const int32_t* __restrict__ nb,
                                 const float* __restrict__ x,
                                 const float* __restrict__ kp, int nq, int ns,
                                 int k, int n_kp, int cin, float ext,
                                 int influence, float gauss_den,
                                 float* __restrict__ y) {
  extern __shared__ float smem[];
  float* h = smem;                                   // [n_kp * k]
  int* nbs = reinterpret_cast<int*>(smem + n_kp * k);  // [k]

  const size_t row = blockIdx.x;                     // b * nq + qi
  const int b = (int)(row / nq);
  kpconv_common::row_influences(row, b, q, s, nb, kp, ns, k, n_kp, ext,
                                influence, gauss_den, h, nbs);

  float* yr = y + row * (size_t)n_kp * cin;
  for (int c = threadIdx.x; c < cin; c += blockDim.x) {
    float acc[kMaxKp];
#pragma unroll
    for (int p = 0; p < kMaxKp; ++p) acc[p] = 0.f;
    for (int j = 0; j < k; ++j) {
      const int n = nbs[j];
      if (n < 0) continue;
      const float v = x[((size_t)b * ns + n) * cin + c];
#pragma unroll
      for (int p = 0; p < kMaxKp; ++p) {
        if (p < n_kp) acc[p] = fmaf(h[p * k + j], v, acc[p]);
      }
    }
#pragma unroll
    for (int p = 0; p < kMaxKp; ++p) {
      if (p < n_kp) yr[(size_t)p * cin + c] = acc[p];
    }
  }
}

}  // namespace

// Floats of workspace that kpconv_fwd_launch needs for its split-K GEMM
// at these sizes (0: none).
extern "C" long long kpconv_fwd_workspace(long long rows, int kdim,
                                          int cout) {
  if (rows <= 0) return 0;
  return kpconv_common::plan_gemm((int)rows, cout, kdim).ws_floats;
}

// q [B,Nq,3], s [B,Ns,3], nb [B,Nq,K] i32, x [B,Ns,Cin], kp [Kp,3],
// w [Kp,Cin,Cout], scratch y [B*Nq, Kp*Cin] and ws (ws_floats floats, at
// least kpconv_fwd_workspace), out [B,Nq,Cout]; f32, contiguous.
// influence: 0 constant, 1 linear, 2 gaussian. Returns cudaGetLastError()
// after the launches, cudaErrorInvalidValue for a workspace too short.
extern "C" int kpconv_fwd_launch(const float* q, const float* s,
                                 const int32_t* nb, const float* x,
                                 const float* kp, const float* w, int b,
                                 int nq, int ns, int k, int n_kp, int cin,
                                 int cout, float ext, int influence,
                                 float gauss_den, float* y, float* out,
                                 float* ws, long long ws_floats,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_kp < 1 || n_kp > kMaxKp || k < 1 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kpconv_common::influence_smem_bytes(n_kp, k);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * nq;
  if (rows == 0) return 0;
  int threads = ((cin + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  aggregate_kernel<<<(unsigned)rows, threads, smem, st>>>(
      q, s, nb, x, kp, nq, ns, k, n_kp, cin, ext, influence, gauss_den, y);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return kpconv_common::gemm_tf32x3<true, false>(
      y, w, out, ws, ws_floats, (int)rows, cout, n_kp * cin, st);
}
