// Device code shared by kernel B (kpconv_fwd.cu) and kernel C
// (kpconv_bwd.cu): the kernel-point influences of one query row, and the
// GEMM core that runs their three products on the tensor cores (3xTF32,
// described below). Both kernels must compute bit-identical influences,
// so they take them from this one place.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kpconv_common {

// Kernel points a thread holds in registers at once: the per-row kernels
// of B and C run the kernel points in chunks of this many, so Kp has no
// limit of its own; the influence tile in shared memory sets the limit.
constexpr int kKpChunk = 16;

// Shared memory that row_influences needs: h [n_kp * k] floats, then the
// k neighbor indices.
inline size_t influence_smem_bytes(int n_kp, int k) {
  return (size_t)((long long)n_kp * k + k) * sizeof(float);
}

// The most dynamic shared memory a block may take on this device (227 KB
// on an H100), once a kernel opts in.
inline size_t smem_optin_bytes() {
  static const size_t n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return (size_t)(v > 0 ? v : 48 * 1024);
  }();
  return n;
}

// Lets `kernel` take up to smem_optin_bytes() of dynamic shared memory
// (the influence tile past 48 KB), once per kernel; an influence tile
// larger than that is refused (cudaErrorInvalidValue).
template <auto Kernel>
inline int allow_influence_smem(size_t smem) {
  if (smem > smem_optin_bytes()) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_optin_bytes());
  return (int)err;
}

// Sizes a launch of B or C takes: at least one kernel point, neighbor,
// input and output channel, and an influence tile the card can hold.
inline bool sizes_ok(int n_kp, int k, int cin, int cout) {
  return n_kp >= 1 && k >= 1 && cin >= 1 && cout >= 1 &&
         influence_smem_bytes(n_kp, k) <= smem_optin_bytes();
}

// bf(x): x rounded to the nearest bf16 (ties to even) and back to f32,
// the cast that compute_dtype "bfloat16" puts on the products' inputs.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Loads the k neighbor indices of query `row` (sphere b) into nbs, -1 for
// a shadow (nb >= ns), and the influences h[p * k + j] = h_p(s[nb_j] - q)
// into h; both in shared memory, each pass ended by a barrier. Each step
// rounded as the plain PyTorch version rounds it on the card, so that the
// influences are its own bit for bit: direct differences s - q - kp_p with
// each axis rounded separately, no fused multiply-add, and a division by
// ext or den as a product with its reciprocal, which the caller computes
// in double and rounds to f32 (inv_ext, inv_den: PyTorch's CUDA division
// by a Python scalar). A true division put the kernel's influences one ulp
// off theirs on many pairs, a bias of one sign in y (-5e-8 against their
// +9e-8, relative, on an H100) that the training step's BatchNorm
// gradients amplified; the f32 reciprocal of f32 ext differs from theirs
// at extents such as 0.24, 0.48 and 0.96 (2.5 % of the pairs an ulp or
// more off at the WL model's 0.24), which bf16 rounding of h turns into
// flips of 2^-8.
//   linear: relu(1 - |d| / ext); constant: 1; gaussian: exp(-|d|^2 / den)
__device__ __forceinline__ void row_influences(
    size_t row, int b, const float* __restrict__ q,
    const float* __restrict__ s, const int32_t* __restrict__ nb,
    const float* __restrict__ kp, int ns, int k, int n_kp, float inv_ext,
    int influence, float inv_den, float* h, int* nbs) {
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
        w = fmaxf(__fsub_rn(1.f, __fmul_rn(sqrtf(d2), inv_ext)), 0.f);
      } else {
        w = expf(__fmul_rn(-d2, inv_den));
      }
    }
    h[i] = w;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The GEMM core of kernels B and C: C [M, N] = op(A) @ op(B), f32 in and
// out, on the tensor cores through the 3xTF32 split.
//
// It computes the contractions of the TPU kernels `_fwd_kernel`
// (weasal_tpu/ops/pallas/kpconv_banded.py:247, out = sum_p y_p @ W_p) and
// `_bwd_kernel` (:295, dr_p = g @ W_p^T and dW_p = y_p^T @ g), folded over
// the kernel points into one product each:
//   B  out = y @ W    A = y [rows, Kp*Cin] K-major, B = W [Kp*Cin, Cout]
//                     N-major                        <AK=true,  BK=false>
//   C  dr  = g @ W^T  A = g [rows, Cout] K-major, B = W K-major
//                                                    <AK=true,  BK=true>
//   C  dW  = y^T @ g  A = y M-major, B = g [rows, Cout] N-major, the depth
//                     (rows) split over blocks       <AK=false, BK=false>
// Nothing is transposed in device memory: each layout is read as it lies.
//
// What bounds it on the H100: operations. At the MPRM level (rows 17136,
// Kp*Cin 3840-7680, Cout 256) each product is ~181 GFLOP per training
// step, far above the card's ridge point. f32 FMAs on the CUDA cores peak
// at 67 TFLOP/s; TF32 on the tensor cores at 495 TFLOP/s but keeps 10
// mantissa bits, which misses an f32 tolerance (rtol 1e-4) at depth 3840.
// The 3xTF32 split keeps f32-grade error: a = big + small with big =
// tf32(a), small = tf32(a - big) (round half away from zero, as
// cvt.rna.tf32.f32), and a @ b ~ small_a @ big_b + big_a @ small_b +
// big_a @ big_b, the small products first; only small_a @ small_b
// (relative 2^-22) is dropped. Its operation bound is 3 x 2MNK / 495e12 s,
// 2.5x below the f32 one.
// The tensor cores add each wgmma's products to its f32 accumulator with
// truncation (round toward zero), not round-to-nearest, so a sum drifts
// toward zero by about half an ulp of the accumulator per wgmma: over
// depth 960 one accumulator drifts by ~8e-6, relative, on operands of one
// sign in the CPU emulation of tests/test_torch_gemm_split.py, against
// ~1e-9 for cuBLAS f32 on the card. A drift of one sign in B's outputs
// is what BatchNorm's gradients, sums over every point, amplify: with the
// twelve wgmmas of a 32-deep stage in one chain (-2.2e-7 on an H100) a
// training step at the loop's shapes landed past its f64 allowance. So
// no chain holds more than one big product: a stage sums its small
// products and its first big one from zero, then each other big product
// from zero, and each of the four results goes into a second register set
// in f32 round-to-nearest, after `untruncate` (below) has undone its
// truncation on average. The small products' own truncations are 2^-11
// smaller. The emulation puts the drift at ~1e-9; chip_smoke.py's phase 2
// measures it on the card.
//
// Design: a block of 2 warpgroups computes 128 x BN outputs (BN = 32 for
// N <= 32, else 64), depth 32 a stage:
// - Raw tiles: a ring of kRawStages = 2 f32 tiles of A and B, filled by
//   16-byte cp.async two stages ahead (zero-filled past the ragged edges:
//   rows not a multiple of 128, Kp*Cin = 60 not a multiple of 32, Cout
//   narrower than the tile). Operands whose contiguous extent is not a
//   multiple of 4 floats, or not 16-byte aligned, use 4-byte cp.async.
// - Split: each thread reads its A fragments straight from the raw tile
//   and splits them in registers; B is split once per block into two
//   planes (big, small) in the K-major 128-byte-swizzled layout that
//   wgmma reads from shared memory. tf32 wgmma takes only K-major shared
//   operands, so this pass also does the transposes: of W for y @ W, of
//   y and g for y^T @ g; nothing is transposed in device memory.
// - MMA: wgmma.mma_async m64nBNk8 tf32, A from registers, B from the
//   planes; each warpgroup owns 64 rows and runs 3 x 4 wgmmas a stage
//   in four chains (9, 1, 1, 1) into the stage accumulator (BN / 2
//   floats a thread), adding each chain's result to the running sum
//   (BN / 2 more) before the next starts.
// - Overlap: the planes and fragments are single-buffered, so a block
//   alternates between its wgmmas and its next split (two barriers a
//   stage). <= 128 registers a thread (__launch_bounds__(256, 2); the two
//   accumulator sets and the A fragments take 96 at BN = 64, which is why
//   BN stops there) and <= 72 KB of shared memory put 2 blocks on an SM,
//   and one block's split runs under the other's wgmmas. (On an H100 this
//   beat one block with double-buffered planes, whose split pass, with 2
//   warps a scheduler, was latency-bound; a third raw stage gained
//   nothing; A from shared memory too, with both operands' planes
//   double-buffered and fed by plain loads through registers so that 2
//   blocks still fit, ran slower.)
// - Split-K (plan_gemm): the depth is cut into s chunks of whole stages
//   when that shortens the modelled schedule. That serves dW (depth
//   17k-49k rows, output <= 7680 x 256, at most 240 tiles) and the
//   forward's last wave (y @ W at rows 17136 and Cout 256 is 536 tiles on
//   264 resident blocks). (On an H100 the model's splits made the three
//   products' GEMM parts 3-4 % faster per training step than a target of
//   4 waves of resident blocks: dW at the wide convs by 8-10 %, y @ W by
//   2-5 %; PERF.md.)
//   Blocks write partial sums to a workspace [s, M, N] that the caller
//   allocates and whose length it passes in (a launch with less returns
//   cudaErrorInvalidValue), and `splitk_sum_kernel` adds them in a fixed
//   order: deterministic, no atomics.
// ---------------------------------------------------------------------------

constexpr int kTileM = 128;     // 2 warpgroups of 64 rows
constexpr int kTileK = 32;      // 128 bytes of f32: one swizzle row
constexpr int kRawStages = 2;
constexpr int kGemmThreads = 256;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxSplits = 1024;
// Split-K cost model (plan_gemm), in units of one stage of a 128-wide
// block at 2 blocks per SM (~2.5 us on an H100): the workspace bytes
// written and read back that take as long as one unit, and the reduction
// launch's cost.
constexpr double kReduceBytesPerUnit = 8.0e6;
constexpr double kReduceLaunchUnits = 4.0;

__host__ __device__ inline int ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// Shared-memory layout of one raw operand tile: Rows (A: 128, B: the
// tile width BN) along M or N by kTileK along the depth. K-major:
// [Rows][kTileK + 4]; MN-major: [kTileK][Rows + 8]. The pads keep the
// 16-byte copies and the split pass's reads free of bank conflicts.
template <bool KMajor, int Rows>
struct TileLayout {
  static constexpr int kStride = KMajor ? kTileK + 4 : Rows + 8;
  static constexpr int kFloats = KMajor ? Rows * kStride : kTileK * kStride;
  __device__ __forceinline__ static int at(int r, int k) {
    return KMajor ? r * kStride + k : k * kStride + r;
  }
};

template <bool AK, bool BK, int BN>
__host__ __device__ constexpr int stage_floats() {
  return TileLayout<AK, kTileM>::kFloats + TileLayout<BK, BN>::kFloats;
}

// A split plane: BN x kTileK TF32 values of B, K-major with the 128-byte
// swizzle: row r at r * 128 bytes, its 16-byte chunk c at chunk
// c ^ (r % 8). A buffer holds B big and B small.
template <int BN>
__host__ __device__ constexpr int plane_buffer_floats() {
  return 2 * BN * kTileK;
}

__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kTileK + ((c ^ (r & 7)) << 2);
}

template <bool AK, bool BK, int BN>
constexpr size_t gemm_smem_bytes() {
  // + 1 KB to align the planes to the 1024-byte swizzle atom
  return 1024 + (size_t)(plane_buffer_floats<BN>() +
                         kRawStages * stage_floats<AK, BK, BN>()) *
                    sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies the (r0.., k0..) tile of an operand with `extent` rows along M or
// N and depth K into shared memory; K-major src[r * K + k], MN-major
// src[k * extent + r]. Elements past either edge are zero-filled.
template <bool KMajor, bool kVec, int Rows>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int extent, int K, int r0,
                                          int k0) {
  using L = TileLayout<KMajor, Rows>;
  if constexpr (kVec) {
    // 16-byte chunks; the contiguous extent is a multiple of 4, so a chunk
    // lies wholly inside or wholly outside the operand. Each thread copies
    // kPer chunks that step by 32 rows (K-major) or 8 depths (MN-major),
    // so only one pointer and one bound change from stage to stage.
    constexpr int kPer = Rows * kTileK / 4 / kGemmThreads;
    static_assert(kPer * 4 * kGemmThreads == Rows * kTileK,
                  "whole chunks a thread");
    if constexpr (KMajor) {
      const int r = threadIdx.x / (kTileK / 4);
      const int k = (threadIdx.x % (kTileK / 4)) * 4;
      constexpr int kStep = kGemmThreads / (kTileK / 4);
      const bool k_ok = k0 + k < K;
      const float* p = src + (size_t)(r0 + r) * K + k0 + k;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool ok = k_ok && r0 + r + j * kStep < extent;
        cp_async16(dst + L::at(r + j * kStep, k),
                   ok ? p + (size_t)j * kStep * K : src, ok);
      }
    } else {
      const int k = threadIdx.x / (Rows / 4);
      const int r = (threadIdx.x % (Rows / 4)) * 4;
      constexpr int kStep = kGemmThreads / (Rows / 4);
      const bool r_ok = r0 + r < extent;
      const float* p = src + (size_t)(k0 + k) * extent + r0 + r;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool ok = r_ok && k0 + k + j * kStep < K;
        cp_async16(dst + L::at(r, k + j * kStep),
                   ok ? p + (size_t)j * kStep * extent : src, ok);
      }
    }
  } else {
    constexpr int kElems = Rows * kTileK;
    static_assert(kElems % kGemmThreads == 0, "whole elements a thread");
#pragma unroll 4
    for (int j = 0; j < kElems / kGemmThreads; ++j) {
      const int e = threadIdx.x + j * kGemmThreads;
      const int r = KMajor ? e / kTileK : e % Rows;
      const int k = KMajor ? e % kTileK : e / Rows;
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gr < extent && gk < K;
      const float* g = !ok ? src
                       : KMajor ? src + (size_t)gr * K + gk
                                : src + (size_t)gk * extent + gr;
      cp_async4(dst + L::at(r, k), g, ok);
    }
  }
}

// cvt.rna.tf32.f32 in two integer operations: the low 13 mantissa bits
// rounded half away from zero (a carry moves into the exponent), then
// cleared. The same as the PTX instruction for finite values, which is
// all this core sees; on sm_90 the instruction itself compiles to a
// longer sequence that also screens NaNs.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A wgmma's result x is its exact sum rounded toward zero: it lies up to
// one ulp short of the sum, half an ulp on average. Adding half an ulp of
// x away from zero and rounding to nearest-even gives x + ulp when x's last
// bit is 1 and x when it is 0: half an ulp on average, as one integer add
// of that bit (a carry moves into the exponent; 0 stays 0).
__device__ __forceinline__ float untruncate(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float(u + (u & 1u));
}

// x = big + small (+ a remainder below 2^-22 |x|), both TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(__fsub_rn(x, __uint_as_float(big)));
}

// Splits the raw tile into the big and small planes (see `swizzled`).
// A thread takes 4 chunks of 4 depths of one row: K-major raws give them
// as one 16-byte read, MN-major ones as 4 reads along which neighbouring
// threads read neighbouring rows. kRoundBf16: each value rounded to bf16
// instead (a TF32 value too), into the big plane only; the small half is
// zero and no product reads it.
template <bool KMajor, int Rows, bool kRoundBf16 = false>
__device__ __forceinline__ void split_tile(const float* raw, float* big,
                                           float* small) {
  using L = TileLayout<KMajor, Rows>;
  constexpr int kChunks = Rows * kTileK / 4;
  static_assert(kChunks % kGemmThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < kChunks / kGemmThreads; ++j) {
    const int q = threadIdx.x + j * kGemmThreads;
    const int r = KMajor ? q / (kTileK / 4) : q % Rows;
    const int c = KMajor ? q % (kTileK / 4) : q / Rows;
    float v[4];
    if constexpr (KMajor) {
      const float4 x = *reinterpret_cast<const float4*>(raw + L::at(r, 4 * c));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = raw[L::at(r, 4 * c + e)];
    }
    uint4 b, s;
    if constexpr (kRoundBf16) {
      b = make_uint4(__float_as_uint(bf16_round(v[0])),
                     __float_as_uint(bf16_round(v[1])),
                     __float_as_uint(bf16_round(v[2])),
                     __float_as_uint(bf16_round(v[3])));
      *reinterpret_cast<uint4*>(big + swizzled(r, c)) = b;
    } else {
      split_tf32(v[0], b.x, s.x);
      split_tf32(v[1], b.y, s.y);
      split_tf32(v[2], b.z, s.z);
      split_tf32(v[3], b.w, s.w);
      *reinterpret_cast<uint4*>(big + swizzled(r, c)) = b;
      *reinterpret_cast<uint4*>(small + swizzled(r, c)) = s;
    }
  }
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand
// at p: start address >> 4, leading byte offset 1 (unused with this
// swizzle), stride byte offset 1024 (between 8-row atoms) >> 4, swizzle
// mode 1 (128 bytes) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x BN of this warpgroup] += A[64 x 8] @ B[8 x BN]: A from registers
// (each warp 16 rows, the m16n8k8 .tf32 A fragment: a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), g = lane / 4, t = lane %
// 4), B from shared memory (descriptor; stored K-major, [BN][8]), f32
// accumulators, BN / 2 a thread.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulators (emits nothing): the compiler may neither move
// them to other registers between wgmmas, which would serialize the
// wgmmas, nor read them across a wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments in registers, which a wgmma reads until the
// wait that retires it.
__device__ __forceinline__ void fence_operands(uint32_t (&a)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2 * 4 * 4; ++i)
    asm volatile("" : "+r"(a[i / 16][(i / 4) % 4][i % 4])::"memory");
}

// A's fragments of one stage for this thread: [big, small][depth step kk
// / 8][a0..a3], split from the raw tile (rows wg * 64 + warp * 16 + g and
// + 8, depths kk + t and + 4). Neighbouring threads read distinct banks
// in either raw layout. kBf16: the raw tile holds bf16 values (M-major,
// the f32 layout's strides in 2-byte elements), exact in TF32: big is the
// value, small is zero and no product reads it.
template <bool AK, bool kBf16 = false>
__device__ __forceinline__ void split_a_fragments(const float* raw,
                                                  uint32_t (&a)[2][4][4]) {
  using L = TileLayout<AK, kTileM>;
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 16 + lane / 4, t = lane % 4;
  if constexpr (kBf16) {
    const __nv_bfloat16* rb = reinterpret_cast<const __nv_bfloat16*>(raw);
    auto at = [&](int rr, int kk) {
      return __float_as_uint(__bfloat162float(rb[L::at(rr, kk)]));
    };
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = s * 8 + t;
      a[0][s][0] = at(r, k);
      a[0][s][1] = at(r + 8, k);
      a[0][s][2] = at(r, k + 4);
      a[0][s][3] = at(r + 8, k + 4);
    }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = s * 8 + t;
      split_tf32(raw[L::at(r, k)], a[0][s][0], a[1][s][0]);
      split_tf32(raw[L::at(r + 8, k)], a[0][s][1], a[1][s][1]);
      split_tf32(raw[L::at(r, k + 4)], a[0][s][2], a[1][s][2]);
      split_tf32(raw[L::at(r + 8, k + 4)], a[0][s][3], a[1][s][3]);
    }
  }
}

// load_tile for a bf16 M-major A operand src[k * extent + r] (kernel C's
// dW = y^T @ g in bf16 mode, y kept as bf16): the raw tile takes the f32
// tile's layout in 2-byte elements (row pitch 272 bytes, 16-byte aligned).
// kVec: 16-byte chunks of 8 values along M (extent a multiple of 8);
// else one value a load, stored synchronously.
template <bool kVec>
__device__ __forceinline__ void load_tile_bf16_mn(
    float* dst_f, const __nv_bfloat16* __restrict__ src, int extent, int K,
    int r0, int k0) {
  using L = TileLayout<false, kTileM>;
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(dst_f);
  if constexpr (kVec) {
    constexpr int kPer = kTileM * kTileK / 8 / kGemmThreads;
    const int k = threadIdx.x / (kTileM / 8);
    const int r = (threadIdx.x % (kTileM / 8)) * 8;
    constexpr int kStep = kGemmThreads / (kTileM / 8);
    const bool r_ok = r0 + r < extent;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool ok = r_ok && k0 + k + j * kStep < K;
      const __nv_bfloat16* p =
          ok ? src + (size_t)(k0 + k + j * kStep) * extent + r0 + r : src;
      const unsigned d =
          (unsigned)__cvta_generic_to_shared(dst + L::at(r, k + j * kStep));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(p), "r"(ok ? 16 : 0));
    }
  } else {
    constexpr int kElems = kTileM * kTileK;
#pragma unroll 4
    for (int j = 0; j < kElems / kGemmThreads; ++j) {
      const int e = threadIdx.x + j * kGemmThreads;
      const int r = e % kTileM, k = e / kTileM;
      const bool ok = r0 + r < extent && k0 + k < K;
      dst[L::at(r, k)] = ok ? src[(size_t)(k0 + k) * extent + r0 + r]
                            : __float2bfloat16_rn(0.f);
    }
  }
}

// The operands of the core (compute_dtype "bfloat16" puts its products'
// inputs in bf16, and a bf16 value is a TF32 value with a zero small half,
// so its products with the other, split, operand need two passes):
//   kF32:        both f32, each split: 3 products a depth step;
//   kBRoundBf16: B rounded to bf16 as it is split (C's dr = g @ bf(W)^T):
//                small_a @ big_b + big_a @ big_b;
//   kABf16:      A bf16 in memory, M-major (C's dW = bf(y)^T @ g):
//                big_a @ small_b + big_a @ big_b.
enum CoreMode : int { kF32 = 0, kBRoundBf16 = 1, kABf16 = 2 };

// One block: the 128 x BN output tile (blockIdx.y, blockIdx.x) summed over
// the depth stages [z * kt_per_split, (z + 1) * kt_per_split) with z =
// blockIdx.z. Without a split it writes C; with one it writes the partial
// sums to C + z * M * N (a workspace slice). A is [M, K] (AK) or [K, M];
// B is [N, K] (BK) or [K, N]. vec2: N even and C 8-byte aligned.
// round_out: C written rounded to bf16 (not the workspace's partial sums).
template <bool AK, bool BK, bool kVec, int BN, int kMode>
__global__ void __launch_bounds__(kGemmThreads, kBlocksPerSm)
    tf32x3_gemm_kernel(const float* __restrict__ A,
                       const float* __restrict__ B, float* __restrict__ C,
                       int M, int N, int K, int kt_per_split, bool vec2,
                       bool round_out) {
  static_assert(kMode != kABf16 || !AK, "bf16 A operands are M-major");
  using LA = TileLayout<AK, kTileM>;
  constexpr int kB = BN * kTileK;  // floats of a plane
  constexpr int kBuf = plane_buffer_floats<BN>();
  constexpr int kStage = stage_floats<AK, BK, BN>();
  extern __shared__ float smem_raw[];
  // B planes [big, small], then the raw ring
  float* planes = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  float* raw = planes + kBuf;

  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * BN;
  const int kt_total = ceil_div(K, kTileK);
  const int kt_begin = blockIdx.z * kt_per_split;
  const int n_kt = min(kt_total, kt_begin + kt_per_split) - kt_begin;
  float* out = C + (size_t)blockIdx.z * M * N;

  // acc: one chain's products, summed by the tensor cores; sum: the
  // chains' results, added in f32 round-to-nearest (see the note above)
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;
  uint32_t fa[2][4][4];  // A's split fragments of the current stage

  auto load_stage = [&](int i) {  // raw tile of local stage i, if any
    if (i < n_kt) {
      float* r = raw + (i % kRawStages) * kStage;
      const int k0 = (kt_begin + i) * kTileK;
      if constexpr (kMode == kABf16)
        load_tile_bf16_mn<kVec>(r, reinterpret_cast<const __nv_bfloat16*>(A),
                                M, K, m0, k0);
      else
        load_tile<AK, kVec, kTileM>(r, A, M, K, m0, k0);
      load_tile<BK, kVec, BN>(r + LA::kFloats, B, N, K, n0, k0);
    }
    cp_async_commit();
  };
  // raw stage i -> A fragments, B planes
  auto split_stage = [&](int i) {
    const float* r = raw + (i % kRawStages) * kStage;
    split_a_fragments<AK, kMode == kABf16>(r, fa);
    split_tile<BK, BN, kMode == kBRoundBf16>(r + LA::kFloats, planes,
                                             planes + kB);
    // make the generic-proxy stores visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  load_stage(0);
  load_stage(1);
  cp_async_wait<1>();
  __syncthreads();
  split_stage(0);
  __syncthreads();
  load_stage(2);

  for (int i = 0; i < n_kt; ++i) {
    // Four chains, each from zero: the small products of the 4 depth steps
    // of 8 (8 depths = 32 bytes further along the swizzled rows) with the
    // first big one, then each other big product alone
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      fence_operands(acc);
      fence_operands(fa);
      wgmma_fence();
      if (s == 0) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if constexpr (kMode != kABf16)
            wgmma_tf32<BN>(acc, fa[1][t], sw128_desc(planes + t * 8), t > 0);
          if constexpr (kMode != kBRoundBf16)
            wgmma_tf32<BN>(acc, fa[0][t], sw128_desc(planes + kB + t * 8),
                           kMode == kABf16 ? t > 0 : 1);
        }
      }
      wgmma_tf32<BN>(acc, fa[0][s], sw128_desc(planes + s * 8), s == 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(fa);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j)
        sum[j] = __fadd_rn(sum[j], untruncate(acc[j]));
    }
    if (i + 1 < n_kt) {
      // Both warpgroups' wgmmas are done with the planes after this
      // barrier, and raw stage i + 1 has landed (only stage i + 2's copies
      // may still be in flight). The SM's other block runs its wgmmas
      // while this one splits.
      cp_async_wait<1>();
      __syncthreads();
      split_stage(i + 1);
      __syncthreads();
      load_stage(i + 3);
    }
  }
  cp_async_wait<0>();

  const int wg = threadIdx.x / 128;
  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + wg * 64 + w4 * 16 + g + half * 8;
    if (r >= M) continue;
    float* row = out + (size_t)r * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + j * 8 + 2 * t;
      float v0 = sum[4 * j + 2 * half], v1 = sum[4 * j + 2 * half + 1];
      if (round_out) {
        v0 = bf16_round(v0);
        v1 = bf16_round(v1);
      }
      if (vec2 && c + 1 < N) {
        *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
      } else {
        if (c < N) row[c] = v0;
        if (c + 1 < N) row[c + 1] = v1;
      }
    }
  }
}

// C[i] = sum_z ws[z * mn + i], z in order (rounded to bf16: round_out).
__global__ void splitk_sum_kernel(const float* __restrict__ ws,
                                  float* __restrict__ C, long long mn,
                                  int splits, bool vec4, bool round_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec4) {
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    float4* c4 = reinterpret_cast<float4*>(C);
    const long long n4 = mn / 4;
    for (; i < n4; i += stride) {
      float4 s = w4[i];
      for (int z = 1; z < splits; ++z) {
        const float4 v = w4[(size_t)z * n4 + i];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      if (round_out) {
        s.x = bf16_round(s.x); s.y = bf16_round(s.y);
        s.z = bf16_round(s.z); s.w = bf16_round(s.w);
      }
      c4[i] = s;
    }
  } else {
    for (; i < mn; i += stride) {
      float s = ws[i];
      for (int z = 1; z < splits; ++z) s += ws[(size_t)z * mn + i];
      C[i] = round_out ? bf16_round(s) : s;
    }
  }
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

struct GemmSchedule {
  int bn;               // tile width: 32 or 64 outputs along N
  int splits;           // chunks of the depth (1: no split, no workspace)
  int kt_per_split;     // depth stages per chunk
  long long ws_floats;  // splits * M * N when split, else 0
};

// The tile width: 32 where that covers N (Cout 16, 32), so that narrow
// outputs spend few MMAs on columns past N, else 64; then the
// split of the depth with the shortest modelled time: the busiest SM runs
// ceil(tiles * s / SMs) blocks, kBlocksPerSm at a time, each over
// ceil(kt / s) stages; a split adds the workspace traffic and the
// reduction launch. tile_k: the depth of a stage (the bf16 core's is 64).
inline GemmSchedule plan_gemm(int M, int N, int K, int tile_k = kTileK) {
  const int bn = N <= 32 ? 32 : 64;
  const long long tiles = (long long)ceil_div(M, kTileM) * ceil_div(N, bn);
  const int kt = ceil_div(K, tile_k);
  const long long sms = sm_count();
  // a stage's time relative to a 128-wide one: the split pass and the
  // loads of A do not shrink with the tile width
  const double stage = (kTileM + bn) / (2.0 * kTileM);
  GemmSchedule best{bn, 1, kt, 0};
  double best_cost = -1.0;
  const int max_s = kt < kMaxSplits ? kt : kMaxSplits;
  for (int s = 1; s <= max_s; ++s) {
    const int per = ceil_div(kt, s);
    if (ceil_div(kt, per) != s) continue;  // same schedule as a smaller s
    long long per_sm = (tiles * s + sms - 1) / sms;
    if (per_sm < kBlocksPerSm) per_sm = kBlocksPerSm;
    double cost = (double)per_sm / kBlocksPerSm * per * stage;
    if (s > 1)
      cost += kReduceLaunchUnits +
              (double)(s + 1) * M * N * sizeof(float) / kReduceBytesPerUnit;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = GemmSchedule{bn, s, per, s > 1 ? (long long)s * M * N : 0};
    }
  }
  return best;
}

template <typename Kernel>
inline cudaError_t gemm_attributes(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <bool AK, bool BK, bool kVec, int BN, int kMode>
inline int launch_tf32x3(const float* A, const float* B, float* out, int M,
                         int N, int K, int kt_per_split, int splits,
                         bool vec2, bool round_out, cudaStream_t st) {
  constexpr size_t smem = gemm_smem_bytes<AK, BK, BN>();
  static const cudaError_t attr =
      gemm_attributes(tf32x3_gemm_kernel<AK, BK, kVec, BN, kMode>, smem);
  if (attr) return (int)attr;
  const dim3 grid(ceil_div(N, BN), ceil_div(M, kTileM), splits);
  tf32x3_gemm_kernel<AK, BK, kVec, BN, kMode>
      <<<grid, kGemmThreads, smem, st>>>(A, B, out, M, N, K, kt_per_split,
                                         vec2, round_out);
  return (int)cudaGetLastError();
}

template <bool AK, bool BK, bool kVec, int kMode>
inline int launch_tf32x3(const GemmSchedule& plan, const float* A,
                         const float* B, float* out, int M, int N, int K,
                         bool vec2, bool round_out, cudaStream_t st) {
  if (plan.bn == 32)
    return launch_tf32x3<AK, BK, kVec, 32, kMode>(
        A, B, out, M, N, K, plan.kt_per_split, plan.splits, vec2, round_out,
        st);
  return launch_tf32x3<AK, BK, kVec, 64, kMode>(
      A, B, out, M, N, K, plan.kt_per_split, plan.splits, vec2, round_out,
      st);
}

// Adds the split-K partial sums of ws [splits, M, N] into C in a fixed
// order (rounded to bf16: round_out).
inline int splitk_sum(const float* ws, float* C, int M, int N, int splits,
                      bool round_out, cudaStream_t st) {
  const long long mn = (long long)M * N;
  const bool vec4 = mn % 4 == 0 && (((uintptr_t)ws | (uintptr_t)C) & 15) == 0;
  long long blocks = ((vec4 ? mn / 4 : mn) + 255) / 256;
  const long long cap = (long long)sm_count() * 8;
  if (blocks > cap) blocks = cap;
  splitk_sum_kernel<<<(unsigned)blocks, 256, 0, st>>>(ws, C, mn, splits,
                                                      vec4, round_out);
  return (int)cudaGetLastError();
}

// C [M, N] = op(A) @ op(B) with the schedule of plan_gemm(M, N, K); `ws`
// holds ws_floats floats (null when 0), cudaErrorInvalidValue when that is
// fewer than the schedule's ws_floats. kMode (CoreMode): the operands'
// types; A is a bf16 array under kABf16. round_out: C rounded to bf16.
// Returns cudaGetLastError() after the launches.
template <bool AK, bool BK, int kMode = kF32>
inline int gemm_tf32x3(const void* A_, const float* B, float* C, float* ws,
                       long long ws_floats, int M, int N, int K,
                       cudaStream_t st, bool round_out = false) {
  const float* A = static_cast<const float*>(A_);
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0)
    return (int)cudaMemsetAsync(C, 0, (size_t)M * N * sizeof(float), st);
  const GemmSchedule plan = plan_gemm(M, N, K);
  if (plan.ws_floats > 0 && (ws == nullptr || ws_floats < plan.ws_floats))
    return (int)cudaErrorInvalidValue;
  // 16-byte chunks need each operand's contiguous extent to be a multiple
  // of 4 floats (8 bf16 values) and 16-byte aligned bases.
  const int a_extent = AK ? K : M, b_extent = BK ? K : N;
  const bool vec = a_extent % (kMode == kABf16 ? 8 : 4) == 0 &&
                   b_extent % 4 == 0 &&
                   (((uintptr_t)A | (uintptr_t)B) & 15) == 0;
  float* out = plan.splits > 1 ? ws : C;
  const bool vec2 = N % 2 == 0 && ((uintptr_t)out & 7) == 0;
  // the workspace's partial sums stay f32; the reduction rounds
  const bool round_tile = round_out && plan.splits == 1;
  const int err =
      vec ? launch_tf32x3<AK, BK, true, kMode>(plan, A, B, out, M, N, K, vec2,
                                               round_tile, st)
          : launch_tf32x3<AK, BK, false, kMode>(plan, A, B, out, M, N, K,
                                                vec2, round_tile, st);
  if (err || plan.splits == 1) return err;
  return splitk_sum(ws, C, M, N, plan.splits, round_out, st);
}

// ---------------------------------------------------------------------------
// The bf16 core of kernel B (compute_dtype "bfloat16"): out [M, N] =
// bf(y) @ bf(W) with y [M, K] bf16 as the aggregate wrote it and W [K, N]
// f32, cast to bf16 and transposed to Wt [N, K] once a call
// (`cast_transpose_bf16_kernel`, a 32 x 32 tile through shared memory), so
// that both operands are K-major, as wgmma reads them without transposing.
// f32 out, f32 accumulators: the products of bf16 values are exact, so
// only the order of the sums differs from JAX's XLA dot.
// Design: 2 warpgroups, 128 x BN outputs (BN 32 or 64, as plan_gemm), a
// stage 64 deep (128 bytes of bf16: one 128-byte swizzle row), a ring of
// kBfStages stages that cp.async fills in the swizzled layout itself
// (16-byte chunks; a depth not a multiple of 8, or an unaligned base,
// takes value-by-value loads), both operands read by wgmma
// m64nBNk16.bf16 from shared memory, one pass. The tensor cores truncate
// as they accumulate here too, so each stage's 4 wgmmas are one chain from
// zero whose result, untruncated, is added to the running sums in f32
// round-to-nearest, as the TF32 core does. Split-K as the TF32 core, in
// stages of 64.
constexpr int kBfTileK = 64;
constexpr int kBfStages = 4;

template <int BN>
constexpr size_t bf16_gemm_smem_bytes() {
  return 1024 + (size_t)kBfStages * (kTileM + BN) * kBfTileK *
                    sizeof(__nv_bfloat16);
}

// d[64 x BN of this warpgroup] += A[64 x 16] @ B[16 x BN], both from
// shared memory (descriptors; K-major, 128-byte swizzle), f32 accumulators.
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Copies rows [r0, r0 + Rows) x depths [k0, k0 + 64) of a K-major bf16
// operand src[r * K + k] into dst (1024-byte aligned) in the 128-byte
// swizzled layout: row r at r * 128 bytes, its 16-byte chunk c (8 values)
// at chunk c ^ (r % 8). Values past either edge are zero.
template <bool kVec, int Rows>
__device__ __forceinline__ void load_bf16_swizzled(
    uint8_t* dst, const __nv_bfloat16* __restrict__ src, int extent, int K,
    int r0, int k0) {
  constexpr int kChunks = Rows * kBfTileK / 8;
  static_assert(kChunks % kGemmThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < kChunks / kGemmThreads; ++j) {
    const int q = threadIdx.x + j * kGemmThreads;
    const int r = q >> 3, c = q & 7;
    const int gr = r0 + r, gk = k0 + c * 8;
    uint8_t* d = dst + r * 128 + ((c ^ (r & 7)) << 4);
    if constexpr (kVec) {
      const bool ok = gr < extent && gk < K;
      const unsigned ds = (unsigned)__cvta_generic_to_shared(d);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(ds),
                   "l"(ok ? src + (size_t)gr * K + gk : src),
                   "r"(ok ? 16 : 0));
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = gr < extent && gk + e < K ? src[(size_t)gr * K + gk + e]
                                         : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Wt [N, K] = bf16(W [K, N]), rounded to nearest even.
__global__ void cast_transpose_bf16_kernel(const float* __restrict__ W,
                                           __nv_bfloat16* __restrict__ Wt,
                                           int K, int N) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    const int k = k0 + j, n = n0 + threadIdx.x;
    tile[j][threadIdx.x] = k < K && n < N ? W[(size_t)k * N + n] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    const int n = n0 + j, k = k0 + threadIdx.x;
    if (n < N && k < K)
      Wt[(size_t)n * K + k] = __float2bfloat16_rn(tile[threadIdx.x][j]);
  }
}

template <bool kVec, int BN>
__global__ void __launch_bounds__(kGemmThreads, kBlocksPerSm)
    bf16_gemm_kernel(const __nv_bfloat16* __restrict__ A,
                     const __nv_bfloat16* __restrict__ Bt,
                     float* __restrict__ C, int M, int N, int K,
                     int kt_per_split, bool vec2) {
  constexpr int kA = kTileM * kBfTileK * 2, kB = BN * kBfTileK * 2;
  constexpr int kStage = kA + kB;  // bytes, a multiple of 1024
  extern __shared__ float smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);

  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * BN;
  const int kt_total = ceil_div(K, kBfTileK);
  const int kt_begin = blockIdx.z * kt_per_split;
  const int n_kt = min(kt_total, kt_begin + kt_per_split) - kt_begin;
  float* out = C + (size_t)blockIdx.z * M * N;

  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;

  auto load_stage = [&](int i) {
    if (i < n_kt) {
      uint8_t* st = ring + (i % kBfStages) * kStage;
      const int k0 = (kt_begin + i) * kBfTileK;
      load_bf16_swizzled<kVec, kTileM>(st, A, M, K, m0, k0);
      load_bf16_swizzled<kVec, BN>(st + kA, Bt, N, K, n0, k0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kBfStages - 1; ++i) load_stage(i);

  const int wg = threadIdx.x / 128;
  for (int i = 0; i < n_kt; ++i) {
    // stage i has landed (later ones may be in flight); the fence makes
    // this thread's copies and stores visible to wgmma's async proxy
    cp_async_wait<kBfStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // every warpgroup has retired stage i - 1's wgmmas: refill its slot
    load_stage(i + kBfStages - 1);
    const uint8_t* st = ring + (i % kBfStages) * kStage;
    const float* a = reinterpret_cast<const float*>(st + wg * 64 * 128);
    const float* b = reinterpret_cast<const float*>(st + kA);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)  // depth steps of 16 = 32 bytes
      wgmma_bf16<BN>(acc, sw128_desc(a + s * 8), sw128_desc(b + s * 8),
                     s > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j)
      sum[j] = __fadd_rn(sum[j], untruncate(acc[j]));
  }
  cp_async_wait<0>();

  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + wg * 64 + w4 * 16 + g + half * 8;
    if (r >= M) continue;
    float* row = out + (size_t)r * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + j * 8 + 2 * t;
      const float v0 = sum[4 * j + 2 * half], v1 = sum[4 * j + 2 * half + 1];
      if (vec2 && c + 1 < N) {
        *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
      } else {
        if (c < N) row[c] = v0;
        if (c + 1 < N) row[c + 1] = v1;
      }
    }
  }
}

template <bool kVec, int BN>
inline int launch_bf16(const __nv_bfloat16* A, const __nv_bfloat16* Bt,
                       float* out, int M, int N, int K, int kt_per_split,
                       int splits, bool vec2, cudaStream_t st) {
  constexpr size_t smem = bf16_gemm_smem_bytes<BN>();
  static const cudaError_t attr =
      gemm_attributes(bf16_gemm_kernel<kVec, BN>, smem);
  if (attr) return (int)attr;
  const dim3 grid(ceil_div(N, BN), ceil_div(M, kTileM), splits);
  bf16_gemm_kernel<kVec, BN><<<grid, kGemmThreads, smem, st>>>(
      A, Bt, out, M, N, K, kt_per_split, vec2);
  return (int)cudaGetLastError();
}

// The split-K schedule of the bf16 core (stages 64 deep).
inline GemmSchedule plan_gemm_bf16(int M, int N, int K) {
  return plan_gemm(M, N, K, kBfTileK);
}

// C [M, N] = A @ bf(W) with A [M, K] bf16 and W [K, N] f32; wt: scratch of
// N * K bf16 values for the cast W; ws as gemm_tf32x3 (plan_gemm_bf16).
inline int gemm_bf16(const __nv_bfloat16* A, const float* W,
                     __nv_bfloat16* wt, float* C, float* ws,
                     long long ws_floats, int M, int N, int K,
                     cudaStream_t st) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0)
    return (int)cudaMemsetAsync(C, 0, (size_t)M * N * sizeof(float), st);
  const GemmSchedule plan = plan_gemm_bf16(M, N, K);
  if (plan.ws_floats > 0 && (ws == nullptr || ws_floats < plan.ws_floats))
    return (int)cudaErrorInvalidValue;
  if (wt == nullptr) return (int)cudaErrorInvalidValue;
  cast_transpose_bf16_kernel<<<dim3(ceil_div(N, 32), ceil_div(K, 32)),
                               dim3(32, 8), 0, st>>>(W, wt, K, N);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const bool vec = K % 8 == 0 && (((uintptr_t)A | (uintptr_t)wt) & 15) == 0;
  float* out = plan.splits > 1 ? ws : C;
  const bool vec2 = N % 2 == 0 && ((uintptr_t)out & 7) == 0;
  if (plan.bn == 32)
    err = vec ? launch_bf16<true, 32>(A, wt, out, M, N, K, plan.kt_per_split,
                                      plan.splits, vec2, st)
              : launch_bf16<false, 32>(A, wt, out, M, N, K,
                                       plan.kt_per_split, plan.splits, vec2,
                                       st);
  else
    err = vec ? launch_bf16<true, 64>(A, wt, out, M, N, K, plan.kt_per_split,
                                      plan.splits, vec2, st)
              : launch_bf16<false, 64>(A, wt, out, M, N, K,
                                       plan.kt_per_split, plan.splits, vec2,
                                       st);
  if (err || plan.splits == 1) return err;
  return splitk_sum(ws, C, M, N, plan.splits, false, st);
}

}  // namespace kpconv_common
