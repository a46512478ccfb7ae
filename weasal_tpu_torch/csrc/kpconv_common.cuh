// Device code shared by kernel B (kpconv_fwd.cu) and kernel C
// (kpconv_bwd.cu): the kernel-point influences of one query row, and a
// shared-memory-tiled f32 GEMM with optional transposed operands and
// split-K. Both kernels must compute bit-identical influences, so they
// take them from this one place.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kpconv_common {

constexpr int kMaxKp = 16;

// Shared memory that row_influences needs: h [n_kp * k] floats, then the
// k neighbor indices.
inline size_t influence_smem_bytes(int n_kp, int k) {
  return (size_t)(n_kp * k + k) * sizeof(float);
}

// Loads the k neighbor indices of query `row` (sphere b) into nbs, -1 for
// a shadow (nb >= ns), and the influences h[p * k + j] = h_p(s[nb_j] - q)
// into h; both in shared memory, each pass ended by a barrier. Direct
// differences s - q - kp_p with each axis rounded separately and no fused
// multiply-add, as the plain PyTorch version computes them.
//   linear: relu(1 - |d| / ext); constant: 1; gaussian: exp(-|d|^2 / den)
__device__ __forceinline__ void row_influences(
    size_t row, int b, const float* __restrict__ q,
    const float* __restrict__ s, const int32_t* __restrict__ nb,
    const float* __restrict__ kp, int ns, int k, int n_kp, float ext,
    int influence, float gauss_den, float* h, int* nbs) {
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
}

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;

// C [M, N] = op(A) @ op(B), f32; 256 threads, a 64x64 output tile per
// block, 4x4 outputs per thread, depth 16 per shared-memory stage.
// op(A) is A stored [M, K] row-major, or with TA the transpose of A
// stored [K, M]; op(B) is B stored [K, N], or with TB the transpose of B
// stored [N, K]. Block z sums depth [z * k_chunk, (z + 1) * k_chunk); with
// more than one z, C must hold zeros and every block adds its partial
// sums with atomics (split-K, for products with a long depth and a small
// output).
template <bool TA, bool TB>
__global__ void sgemm_kernel(const float* __restrict__ A,
                             const float* __restrict__ B,
                             float* __restrict__ C, int M, int N, int K,
                             int k_chunk) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  float acc[4][4] = {};

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // Neighbouring threads read neighbouring addresses in either layout.
    for (int i = threadIdx.x; i < kBM * kBK; i += blockDim.x) {
      const int m = TA ? i % kBM : i / kBK;
      const int kk = TA ? i / kBM : i % kBK;
      const int gr = row0 + m, gk = k0 + kk;
      float v = 0.f;
      if (gr < M && gk < k_end)
        v = TA ? A[(size_t)gk * M + gr] : A[(size_t)gr * K + gk];
      As[kk][m] = v;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += blockDim.x) {
      const int n = TB ? i / kBK : i % kBN;
      const int kk = TB ? i % kBK : i / kBN;
      const int gk = k0 + kk, gc = col0 + n;
      float v = 0.f;
      if (gk < k_end && gc < N)
        v = TB ? B[(size_t)gc * K + gk] : B[(size_t)gk * N + gc];
      Bs[kk][n] = v;
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
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc >= N) continue;
      if (split) {
        atomicAdd(&C[(size_t)gr * N + gc], acc[i][j]);
      } else {
        C[(size_t)gr * N + gc] = acc[i][j];
      }
    }
  }
}

// Launches sgemm_kernel with the depth cut into `splits` chunks (1: no
// split, C is overwritten; more: C must hold zeros). Returns
// cudaGetLastError().
template <bool TA, bool TB>
inline int sgemm(const float* A, const float* B, float* C, int M, int N,
                 int K, int splits, cudaStream_t st) {
  if (M <= 0 || N <= 0) return 0;
  int k_chunk = K;
  if (splits > 1) {
    k_chunk = (K + splits - 1) / splits;
    k_chunk = ((k_chunk + kBK - 1) / kBK) * kBK;
    splits = (K + k_chunk - 1) / k_chunk;
  } else {
    splits = 1;
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  sgemm_kernel<TA, TB><<<grid, 256, 0, st>>>(A, B, C, M, N, K, k_chunk);
  return (int)cudaGetLastError();
}

}  // namespace kpconv_common
