// Device code shared by kernel B (kpconv_fwd.cu) and kernel C
// (kpconv_bwd.cu): the kernel-point influences of one query row, and the
// GEMM core that runs their three products on the tensor cores (3xTF32,
// described below). Both kernels must compute bit-identical influences,
// so they take them from this one place.

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
// into h; both in shared memory, each pass ended by a barrier. Each step
// rounded as the plain PyTorch version rounds it on the card, so that the
// influences are its own bit for bit: direct differences s - q - kp_p with
// each axis rounded separately, no fused multiply-add, and a division by
// ext or den as a product with the reciprocal rounded to f32 (PyTorch's
// CUDA division by a Python scalar). A true division put the kernel's
// influences one ulp off theirs on many pairs, a bias of one sign in y
// (-5e-8 against their +9e-8, relative, on an H100) that the training
// step's BatchNorm gradients amplified.
//   linear: relu(1 - |d| / ext); constant: 1; gaussian: exp(-|d|^2 / den)
__device__ __forceinline__ void row_influences(
    size_t row, int b, const float* __restrict__ q,
    const float* __restrict__ s, const int32_t* __restrict__ nb,
    const float* __restrict__ kp, int ns, int k, int n_kp, float ext,
    int influence, float gauss_den, float* h, int* nbs) {
  const float inv_ext = __frcp_rn(ext), inv_den = __frcp_rn(gauss_den);
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
// threads read neighbouring rows.
template <bool KMajor, int Rows>
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
    split_tf32(v[0], b.x, s.x);
    split_tf32(v[1], b.y, s.y);
    split_tf32(v[2], b.z, s.z);
    split_tf32(v[3], b.w, s.w);
    *reinterpret_cast<uint4*>(big + swizzled(r, c)) = b;
    *reinterpret_cast<uint4*>(small + swizzled(r, c)) = s;
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
// in either raw layout.
template <bool AK>
__device__ __forceinline__ void split_a_fragments(const float* raw,
                                                  uint32_t (&a)[2][4][4]) {
  using L = TileLayout<AK, kTileM>;
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 16 + lane / 4, t = lane % 4;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int k = s * 8 + t;
    split_tf32(raw[L::at(r, k)], a[0][s][0], a[1][s][0]);
    split_tf32(raw[L::at(r + 8, k)], a[0][s][1], a[1][s][1]);
    split_tf32(raw[L::at(r, k + 4)], a[0][s][2], a[1][s][2]);
    split_tf32(raw[L::at(r + 8, k + 4)], a[0][s][3], a[1][s][3]);
  }
}

// One block: the 128 x BN output tile (blockIdx.y, blockIdx.x) summed over
// the depth stages [z * kt_per_split, (z + 1) * kt_per_split) with z =
// blockIdx.z. Without a split it writes C; with one it writes the partial
// sums to C + z * M * N (a workspace slice). A is [M, K] (AK) or [K, M];
// B is [N, K] (BK) or [K, N]. vec2: N even and C 8-byte aligned.
template <bool AK, bool BK, bool kVec, int BN>
__global__ void __launch_bounds__(kGemmThreads, kBlocksPerSm)
    tf32x3_gemm_kernel(const float* __restrict__ A,
                       const float* __restrict__ B, float* __restrict__ C,
                       int M, int N, int K, int kt_per_split, bool vec2) {
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
      load_tile<AK, kVec, kTileM>(r, A, M, K, m0, k0);
      load_tile<BK, kVec, BN>(r + LA::kFloats, B, N, K, n0, k0);
    }
    cp_async_commit();
  };
  // raw stage i -> A fragments, B planes
  auto split_stage = [&](int i) {
    const float* r = raw + (i % kRawStages) * kStage;
    split_a_fragments<AK>(r, fa);
    split_tile<BK, BN>(r + LA::kFloats, planes, planes + kB);
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
          wgmma_tf32<BN>(acc, fa[1][t], sw128_desc(planes + t * 8), t > 0);
          wgmma_tf32<BN>(acc, fa[0][t], sw128_desc(planes + kB + t * 8), 1);
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

// C[i] = sum_z ws[z * mn + i], z in order.
__global__ void splitk_sum_kernel(const float* __restrict__ ws,
                                  float* __restrict__ C, long long mn,
                                  int splits, bool vec4) {
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
      c4[i] = s;
    }
  } else {
    for (; i < mn; i += stride) {
      float s = ws[i];
      for (int z = 1; z < splits; ++z) s += ws[(size_t)z * mn + i];
      C[i] = s;
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
// reduction launch.
inline GemmSchedule plan_gemm(int M, int N, int K) {
  const int bn = N <= 32 ? 32 : 64;
  const long long tiles = (long long)ceil_div(M, kTileM) * ceil_div(N, bn);
  const int kt = ceil_div(K, kTileK);
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

template <bool AK, bool BK, bool kVec, int BN>
inline int launch_tf32x3(const float* A, const float* B, float* out, int M,
                         int N, int K, int kt_per_split, int splits,
                         bool vec2, cudaStream_t st) {
  constexpr size_t smem = gemm_smem_bytes<AK, BK, BN>();
  static const cudaError_t attr =
      gemm_attributes(tf32x3_gemm_kernel<AK, BK, kVec, BN>, smem);
  if (attr) return (int)attr;
  const dim3 grid(ceil_div(N, BN), ceil_div(M, kTileM), splits);
  tf32x3_gemm_kernel<AK, BK, kVec, BN><<<grid, kGemmThreads, smem, st>>>(
      A, B, out, M, N, K, kt_per_split, vec2);
  return (int)cudaGetLastError();
}

template <bool AK, bool BK, bool kVec>
inline int launch_tf32x3(const GemmSchedule& plan, const float* A,
                         const float* B, float* out, int M, int N, int K,
                         bool vec2, cudaStream_t st) {
  if (plan.bn == 32)
    return launch_tf32x3<AK, BK, kVec, 32>(A, B, out, M, N, K,
                                           plan.kt_per_split, plan.splits,
                                           vec2, st);
  return launch_tf32x3<AK, BK, kVec, 64>(A, B, out, M, N, K,
                                         plan.kt_per_split, plan.splits, vec2,
                                         st);
}

// C [M, N] = op(A) @ op(B) with the schedule of plan_gemm(M, N, K); `ws`
// holds ws_floats floats (null when 0), cudaErrorInvalidValue when that is
// fewer than the schedule's ws_floats. Returns cudaGetLastError() after
// the launches.
template <bool AK, bool BK>
inline int gemm_tf32x3(const float* A, const float* B, float* C, float* ws,
                       long long ws_floats, int M, int N, int K,
                       cudaStream_t st) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0)
    return (int)cudaMemsetAsync(C, 0, (size_t)M * N * sizeof(float), st);
  const GemmSchedule plan = plan_gemm(M, N, K);
  if (plan.ws_floats > 0 && (ws == nullptr || ws_floats < plan.ws_floats))
    return (int)cudaErrorInvalidValue;
  // 16-byte chunks need each operand's contiguous extent to be a multiple
  // of 4 floats and 16-byte aligned bases.
  const int a_extent = AK ? K : M, b_extent = BK ? K : N;
  const bool vec = a_extent % 4 == 0 && b_extent % 4 == 0 &&
                   (((uintptr_t)A | (uintptr_t)B) & 15) == 0;
  float* out = plan.splits > 1 ? ws : C;
  const bool vec2 = N % 2 == 0 && ((uintptr_t)out & 7) == 0;
  const int err =
      vec ? launch_tf32x3<AK, BK, true>(plan, A, B, out, M, N, K, vec2, st)
          : launch_tf32x3<AK, BK, false>(plan, A, B, out, M, N, K, vec2, st);
  if (err || plan.splits == 1) return err;
  const long long mn = (long long)M * N;
  const bool vec4 = mn % 4 == 0 && (((uintptr_t)ws | (uintptr_t)C) & 15) == 0;
  long long blocks = ((vec4 ? mn / 4 : mn) + 255) / 256;
  const long long cap = (long long)sm_count() * 8;
  if (blocks > cap) blocks = cap;
  splitk_sum_kernel<<<(unsigned)blocks, 256, 0, st>>>(ws, C, mn,
                                                      plan.splits, vec4);
  return (int)cudaGetLastError();
}

}  // namespace kpconv_common
