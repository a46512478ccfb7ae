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
// Cout f32 operations, dominates at the wide levels; the aggregation step
// reads K neighbor rows of Cin floats per query and does 2*Kp*K*Cin
// operations. Design, two launches on one stream:
//  1. `aggregate`: one block per query row. The block computes the Kp x K
//     influences into shared memory (kpconv_common.cuh: direct differences
//     s - q - kp_p, each axis rounded separately, no fused multiply-add, as
//     the plain version), then each thread owns channels c and keeps all
//     Kp partial sums in registers, so every gathered x[nb_k, c] is read
//     once and used Kp times. It writes y [rows, Kp*Cin] (kernel point
//     major), which the autograd Function keeps for kernel C's dW.
//  2. `sgemm` (kpconv_common.cuh): a shared-memory-tiled f32 GEMM, 64x64
//     output tiles, depth 16 per stage, 4x4 outputs per thread:
//     out = y @ W, W [Kp*Cin, Cout].
// f32 only; bf16 inputs with wgmma are later work.

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

// q [B,Nq,3], s [B,Ns,3], nb [B,Nq,K] i32, x [B,Ns,Cin], kp [Kp,3],
// w [Kp,Cin,Cout], scratch y [B*Nq, Kp*Cin], out [B,Nq,Cout]; f32,
// contiguous. influence: 0 constant, 1 linear, 2 gaussian.
// Returns cudaGetLastError() after both launches.
extern "C" int kpconv_fwd_launch(const float* q, const float* s,
                                 const int32_t* nb, const float* x,
                                 const float* kp, const float* w, int b,
                                 int nq, int ns, int k, int n_kp, int cin,
                                 int cout, float ext, int influence,
                                 float gauss_den, float* y, float* out,
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
  return kpconv_common::sgemm<false, false>(y, w, out, (int)rows, cout,
                                            n_kp * cin, 1, st);
}
