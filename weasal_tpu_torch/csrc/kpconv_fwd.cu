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
//     influences into shared memory (direct differences s - q - kp_p, each
//     axis rounded separately, no fused multiply-add, as the plain version),
//     then each thread owns channels c and keeps all Kp partial sums in
//     registers, so every gathered x[nb_k, c] is read once and used Kp
//     times. It writes y [rows, Kp*Cin] (kernel point major).
//  2. `sgemm`: a shared-memory-tiled f32 GEMM, 64x64 output tiles, depth
//     16 per stage, 4x4 outputs per thread: out = y @ W, W [Kp*Cin, Cout].
// f32 only; bf16 inputs with wgmma are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxKp = 16;

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
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int n = nb[row * k + j];
    nbs[j] = (n >= 0 && n < ns) ? n : -1;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_kp * k; i += blockDim.x) {
    const int p = i / k;
    const int j = i - p * k;
    const int n = nbs[j];
    float w = 0.f;
    if (n >= 0) {
      const float* sp = s + ((size_t)b * ns + n) * 3;
      const float dx = __fsub_rn(__fsub_rn(sp[0], qx), kp[p * 3 + 0]);
      const float dy = __fsub_rn(__fsub_rn(sp[1], qy), kp[p * 3 + 1]);
      const float dz = __fsub_rn(__fsub_rn(sp[2], qz), kp[p * 3 + 2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (influence == 0) {
        w = 1.f;
      } else if (influence == 1) {
        w = fmaxf(__fsub_rn(1.f, __fdiv_rn(sqrtf(d2), ext)), 0.f);
      } else {
        w = expf(__fdiv_rn(-d2, gauss_den));
      }
    }
    h[i] = w;
  }
  __syncthreads();

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

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;

// C [M, N] = A [M, K] @ B [K, N], all row-major f32; 256 threads.
__global__ void sgemm_kernel(const float* __restrict__ A,
                             const float* __restrict__ B,
                             float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += blockDim.x) {
      const int m = i / kBK, kk = i % kBK;
      const int gr = row0 + m, gk = k0 + kk;
      As[kk][m] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += blockDim.x) {
      const int kk = i / kBN, n = i % kBN;
      const int gk = k0 + kk, gc = col0 + n;
      Bs[kk][n] = (gk < K && gc < N) ? B[(size_t)gk * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc < N) C[(size_t)gr * N + gc] = acc[i][j];
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
  const size_t smem = (size_t)(n_kp * k + k) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * nq;
  if (rows == 0) return 0;
  int threads = ((cin + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  aggregate_kernel<<<(unsigned)rows, threads, smem, st>>>(
      q, s, nb, x, kp, nq, ns, k, n_kp, cin, ext, influence, gauss_den, y);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int kdim = n_kp * cin;
  dim3 grid((cout + kBN - 1) / kBN, (unsigned)((rows + kBM - 1) / kBM));
  sgemm_kernel<<<grid, 256, 0, st>>>(y, w, out, (int)rows, cout, kdim);
  return (int)cudaGetLastError();
}
