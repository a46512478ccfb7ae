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
// The block holds kKpChunk kernel points' sums in registers at a time and
// runs larger Kp in chunks, reading its neighbor rows again for each; the
// influence tile takes up to the card's opt-in shared memory (227 KB on an
// H100), which sets the largest Kp x K.
// f32 in and out. compute_dtype "bfloat16" (kpconv_fwd_bf16_launch) puts
// bf16 where the JAX package's XLA path puts it
// (weasal_tpu/ops/kpconv.py:206-233): the aggregate rounds h and x to bf16,
// sums their exact products in f32 and writes y rounded to bf16; then
// out = y @ bf(W) in f32 on the bf16 core (wgmma bf16, one pass).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kpconv_common.cuh"

namespace {

using kpconv_common::kKpChunk;

// One chunk of np <= kKpChunk kernel points of a row at channel c: their
// sums over the neighbors in registers, each gathered x read once.
template <bool kBf16, typename YT>
__device__ __forceinline__ void aggregate_chunk(
    const float* hc, const int* nbs, const float* __restrict__ xb, int k,
    int cin, int c, int np, YT* __restrict__ yc) {
  float acc[kKpChunk];
#pragma unroll
  for (int p = 0; p < kKpChunk; ++p) acc[p] = 0.f;
  for (int j = 0; j < k; ++j) {
    const int n = nbs[j];
    if (n < 0) continue;
    float v = xb[(size_t)n * cin + c];
    if constexpr (kBf16) v = kpconv_common::bf16_round(v);
#pragma unroll
    for (int p = 0; p < kKpChunk; ++p) {
      if (p < np) acc[p] = fmaf(hc[p * k + j], v, acc[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < kKpChunk; ++p) {
    if (p < np) {
      if constexpr (kBf16)
        yc[(size_t)p * cin + c] = __float2bfloat16_rn(acc[p]);
      else
        yc[(size_t)p * cin + c] = acc[p];
    }
  }
}

// y [rows, Kp*Cin] = sum_j h_p(j) * x[nb_j, c], as f32 (YT float) or, in
// bf16 mode (kBf16, YT __nv_bfloat16), from h and x rounded to bf16 and
// written rounded to bf16. kChunked (past kKpChunk kernel points): the
// chunks read the neighbor rows again, one chunk after another; without
// it the kernel holds only the one-chunk loop (with both paths in one
// kernel the one-chunk case ran slower on an H100).
template <bool kBf16, typename YT, bool kChunked>
__global__ void aggregate_kernel(const float* __restrict__ q,
                                 const float* __restrict__ s,
                                 const int32_t* __restrict__ nb,
                                 const float* __restrict__ x,
                                 const float* __restrict__ kp, int nq, int ns,
                                 int k, int n_kp, int cin, float inv_ext,
                                 int influence, float inv_den,
                                 YT* __restrict__ y) {
  extern __shared__ float smem[];
  float* h = smem;                                   // [n_kp * k]
  int* nbs = reinterpret_cast<int*>(smem + (size_t)n_kp * k);  // [k]

  const size_t row = blockIdx.x;                     // b * nq + qi
  const int b = (int)(row / nq);
  kpconv_common::row_influences(row, b, q, s, nb, kp, ns, k, n_kp, inv_ext,
                                influence, inv_den, h, nbs);
  if constexpr (kBf16) {
    for (int i = threadIdx.x; i < n_kp * k; i += blockDim.x)
      h[i] = kpconv_common::bf16_round(h[i]);
    __syncthreads();
  }

  const float* xb = x + (size_t)b * ns * cin;
  YT* yr = y + row * (size_t)n_kp * cin;
  for (int c = threadIdx.x; c < cin; c += blockDim.x) {
    if constexpr (!kChunked) {
      aggregate_chunk<kBf16, YT>(h, nbs, xb, k, cin, c, n_kp, yr);
    } else {
      for (int p0 = 0; p0 < n_kp; p0 += kKpChunk)
        aggregate_chunk<kBf16, YT>(h + (size_t)p0 * k, nbs, xb, k, cin, c,
                                   min(kKpChunk, n_kp - p0),
                                   yr + (size_t)p0 * cin);
    }
  }
}

template <bool kBf16, typename YT, bool kChunked>
int launch_aggregate_as(const float* q, const float* s, const int32_t* nb,
                        const float* x, const float* kp, long long rows,
                        int nq, int ns, int k, int n_kp, int cin,
                        float inv_ext, int influence, float inv_den, YT* y,
                        cudaStream_t st) {
  const size_t smem = kpconv_common::influence_smem_bytes(n_kp, k);
  const int err = kpconv_common::allow_influence_smem<
      aggregate_kernel<kBf16, YT, kChunked>>(smem);
  if (err) return err;
  int threads = ((cin + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  aggregate_kernel<kBf16, YT, kChunked>
      <<<(unsigned)rows, threads, smem, st>>>(q, s, nb, x, kp, nq, ns, k,
                                              n_kp, cin, inv_ext, influence,
                                              inv_den, y);
  return (int)cudaGetLastError();
}

template <bool kBf16, typename YT>
int launch_aggregate(const float* q, const float* s, const int32_t* nb,
                     const float* x, const float* kp, long long rows, int nq,
                     int ns, int k, int n_kp, int cin, float inv_ext,
                     int influence, float inv_den, YT* y, cudaStream_t st) {
  return n_kp <= kKpChunk
             ? launch_aggregate_as<kBf16, YT, false>(
                   q, s, nb, x, kp, rows, nq, ns, k, n_kp, cin, inv_ext,
                   influence, inv_den, y, st)
             : launch_aggregate_as<kBf16, YT, true>(
                   q, s, nb, x, kp, rows, nq, ns, k, n_kp, cin, inv_ext,
                   influence, inv_den, y, st);
}

}  // namespace

// The most shared memory the card gives a block: a launch whose
// influence tile needs more is refused.
extern "C" long long kpconv_smem_limit() {
  return (long long)kpconv_common::smem_optin_bytes();
}

// Floats of workspace that kpconv_fwd_launch needs for its split-K GEMM
// at these sizes (0: none).
extern "C" long long kpconv_fwd_workspace(long long rows, int kdim,
                                          int cout) {
  if (rows <= 0) return 0;
  return kpconv_common::plan_gemm((int)rows, cout, kdim).ws_floats;
}

// The same for kpconv_fwd_bf16_launch (the bf16 core's stages).
extern "C" long long kpconv_fwd_bf16_workspace(long long rows, int kdim,
                                               int cout) {
  if (rows <= 0) return 0;
  return kpconv_common::plan_gemm_bf16((int)rows, cout, kdim).ws_floats;
}

// q [B,Nq,3], s [B,Ns,3], nb [B,Nq,K] i32, x [B,Ns,Cin], kp [Kp,3],
// w [Kp,Cin,Cout], scratch y [B*Nq, Kp*Cin] and ws (ws_floats floats, at
// least kpconv_fwd_workspace), out [B,Nq,Cout]; f32, contiguous.
// influence: 0 constant, 1 linear, 2 gaussian; inv_ext and inv_den:
// 1 / ext and 1 / den computed in double, rounded to f32. Returns
// cudaGetLastError() after the launches, cudaErrorInvalidValue for a
// workspace too short or an influence tile past kpconv_smem_limit().
extern "C" int kpconv_fwd_launch(const float* q, const float* s,
                                 const int32_t* nb, const float* x,
                                 const float* kp, const float* w, int b,
                                 int nq, int ns, int k, int n_kp, int cin,
                                 int cout, float inv_ext, int influence,
                                 float inv_den, float* y, float* out,
                                 float* ws, long long ws_floats,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!kpconv_common::sizes_ok(n_kp, k, cin, cout))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * nq;
  if (rows == 0) return 0;
  const int err = launch_aggregate<false, float>(
      q, s, nb, x, kp, rows, nq, ns, k, n_kp, cin, inv_ext, influence, inv_den,
      y, st);
  if (err) return err;
  return kpconv_common::gemm_tf32x3<true, false>(
      y, w, out, ws, ws_floats, (int)rows, cout, n_kp * cin, st);
}

// compute_dtype "bfloat16": as kpconv_fwd_launch with y [B*Nq, Kp*Cin]
// bf16 (bf(sum_j bf(h) * bf(x))), out = y @ bf(W) in f32, wt scratch of
// Cout * Kp*Cin bf16 values (the cast W, transposed) and ws at least
// kpconv_fwd_bf16_workspace.
extern "C" int kpconv_fwd_bf16_launch(const float* q, const float* s,
                                      const int32_t* nb, const float* x,
                                      const float* kp, const float* w, int b,
                                      int nq, int ns, int k, int n_kp,
                                      int cin, int cout, float inv_ext,
                                      int influence, float inv_den,
                                      void* y, void* wt, float* out,
                                      float* ws, long long ws_floats,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!kpconv_common::sizes_ok(n_kp, k, cin, cout))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * nq;
  if (rows == 0) return 0;
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  const int err = launch_aggregate<true, __nv_bfloat16>(
      q, s, nb, x, kp, rows, nq, ns, k, n_kp, cin, inv_ext, influence, inv_den,
      yb, st);
  if (err) return err;
  return kpconv_common::gemm_bf16(yb, w, static_cast<__nv_bfloat16*>(wt),
                                  out, ws, ws_floats, (int)rows, cout,
                                  n_kp * cin, st);
}
