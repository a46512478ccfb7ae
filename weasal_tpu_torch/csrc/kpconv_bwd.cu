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
// The per-row stage holds kKpChunk kernel points' dr in registers at a
// time; past that it runs the kernel points in chunks, each adding to the
// slot sums that the chunk before wrote to the workspace (f32), so a slot
// sum is the same as in one pass; the influence tile takes up to the
// card's opt-in shared memory. f32 in and out.
// compute_dtype "bfloat16" (kpconv_bwd_bf16_launch) rounds where JAX's VJP
// of its XLA path rounds (weasal_tpu/ops/kpconv.py:206-233 under
// jax.grad): g is not rounded; dr = bf(g @ bf(W)^T) and dW = bf(bf(y)^T @
// g), each on the TF32 core in two passes (the bf16 operand is exact in
// TF32, its small half zero) and rounded as written; each slot's gradient
// bf(sum_p bf(h_p) * dr_p), rounded before the slots are added into dX in
// f32. Its workspace is bf16 (half the bytes) where one chunk covers Kp.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "inverse_lists.cuh"
#include "kpconv_common.cuh"

namespace {

using kpconv_common::kKpChunk;
using inverse_lists::Vec;

template <int VEC>
__device__ __forceinline__ void store_out(float* p, const Vec<VEC>& r) {
  inverse_lists::store_vec<VEC>(p, r);
}

// VEC values, already rounded to bf16, as bf16 (8-, 4- or 2-byte stores)
template <int VEC>
__device__ __forceinline__ void store_out(__nv_bfloat16* p,
                                          const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(r.v[0], r.v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(r.v[2], r.v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const uint32_t*>(&lo);
    t.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = t;
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(r.v[0], r.v[1]);
  } else {
    *p = __float2bfloat16_rn(r.v[0]);
  }
}

// One chunk of np <= kKpChunk kernel points of a row at channels c..c+VEC:
// their dr in registers, then each real slot's sum over them, added to
// the partial sum an earlier chunk wrote (kFirst: none) and, in bf16 mode
// at the last chunk (kLast), rounded to bf16 before it is stored.
template <int VEC, bool kBf16, typename OT, bool kFirst, bool kLast>
__device__ __forceinline__ void contrib_chunk(
    const float* hc, const int* nbs, const float* __restrict__ drc, int k,
    int cin, int c, int np, OT* __restrict__ out) {
  static_assert(kFirst || std::is_same<OT, float>::value,
                "partial sums are f32");
  Vec<VEC> d[kKpChunk];
#pragma unroll
  for (int p = 0; p < kKpChunk; ++p) {
    if (p < np) {
      d[p] = inverse_lists::load_vec<VEC>(drc + (size_t)p * cin + c);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[p].v[v] = 0.f;
    }
  }
  for (int j = 0; j < k; ++j) {
    if (nbs[j] < 0) continue;                      // not in any list
    Vec<VEC> acc;
    if constexpr (kFirst) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc.v[v] = 0.f;
    } else {
      acc = inverse_lists::load_vec<VEC>(out + (size_t)j * cin + c);
    }
#pragma unroll
    for (int p = 0; p < kKpChunk; ++p) {
      if (p < np) {
        const float hp = hc[p * k + j];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc.v[v] = fmaf(hp, d[p].v[v],
                                                      acc.v[v]);
      }
    }
    if constexpr (kBf16 && kLast) {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc.v[v] = kpconv_common::bf16_round(acc.v[v]);
    }
    store_out<VEC>(out + (size_t)j * cin + c, acc);
  }
}

// VEC consecutive channels a thread: each influence read from shared
// memory serves VEC multiply-adds (one channel a thread was bound by those
// reads), and the workspace gets VEC-wide stores. kBf16: h rounded to
// bf16, each slot's sum rounded to bf16 (dr comes rounded from its GEMM);
// OT, the workspace's type, is bf16 only where one chunk covers Kp, since
// later chunks add to the f32 sums of earlier ones; kChunked: more than
// one chunk (without it the kernel holds only the one-chunk loop).
template <int VEC, bool kBf16, typename OT, bool kChunked>
__global__ void dx_contrib_kernel(const float* __restrict__ q,
                                  const float* __restrict__ s,
                                  const int32_t* __restrict__ nb,
                                  const float* __restrict__ kp,
                                  const float* __restrict__ dr, int nq,
                                  int ns, int k, int n_kp, int cin,
                                  float inv_ext, int influence, float inv_den,
                                  OT* __restrict__ xws) {
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

  const float* drr = dr + row * (size_t)n_kp * cin;
  OT* out = xws + row * (size_t)k * cin;
  for (int c = threadIdx.x * VEC; c < cin; c += blockDim.x * VEC) {
    if constexpr (!kChunked) {
      contrib_chunk<VEC, kBf16, OT, true, true>(h, nbs, drr, k, cin, c,
                                                n_kp, out);
    } else {
      contrib_chunk<VEC, kBf16, OT, true, false>(h, nbs, drr, k, cin, c,
                                                 kKpChunk, out);
      int p0 = kKpChunk;
      for (; p0 + kKpChunk < n_kp; p0 += kKpChunk)
        contrib_chunk<VEC, kBf16, OT, false, false>(
            h + (size_t)p0 * k, nbs, drr + (size_t)p0 * cin, k, cin, c,
            kKpChunk, out);
      contrib_chunk<VEC, kBf16, OT, false, true>(
          h + (size_t)p0 * k, nbs, drr + (size_t)p0 * cin, k, cin, c,
          n_kp - p0, out);
    }
  }
}

template <int VEC, bool kBf16, typename OT, bool kChunked>
int launch_contrib_as(const float* q, const float* s, const int32_t* nb,
                      const float* kp, const float* dr, long long rows,
                      int nq, int ns, int k, int n_kp, int cin,
                      float inv_ext, int influence, float inv_den, OT* xws,
                      cudaStream_t st) {
  const size_t smem = kpconv_common::influence_smem_bytes(n_kp, k);
  const int err = kpconv_common::allow_influence_smem<
      dx_contrib_kernel<VEC, kBf16, OT, kChunked>>(smem);
  if (err) return err;
  int threads = ((cin / VEC + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  dx_contrib_kernel<VEC, kBf16, OT, kChunked>
      <<<(unsigned)rows, threads, smem, st>>>(q, s, nb, kp, dr, nq, ns, k,
                                              n_kp, cin, inv_ext, influence,
                                              inv_den, xws);
  return (int)cudaGetLastError();
}

// OT bf16 comes with one chunk only (kpconv_bwd_bf16_launch)
template <int VEC, bool kBf16, typename OT>
int launch_contrib(const float* q, const float* s, const int32_t* nb,
                   const float* kp, const float* dr, long long rows, int nq,
                   int ns, int k, int n_kp, int cin, float inv_ext,
                   int influence, float inv_den, OT* xws, cudaStream_t st) {
  if constexpr (std::is_same<OT, float>::value) {
    if (n_kp > kKpChunk)
      return launch_contrib_as<VEC, kBf16, OT, true>(
          q, s, nb, kp, dr, rows, nq, ns, k, n_kp, cin, inv_ext, influence,
          inv_den, xws, st);
  }
  return launch_contrib_as<VEC, kBf16, OT, false>(
      q, s, nb, kp, dr, rows, nq, ns, k, n_kp, cin, inv_ext, influence,
      inv_den, xws, st);
}

// The first stage of dX into the workspace, with the widest VEC that Cin
// allows: dr and xws come from the allocator (256-byte aligned), so with
// Cin a multiple of VEC every VEC-wide access is aligned
template <bool kBf16, typename OT>
int contrib(const float* q, const float* s, const int32_t* nb,
            const float* kp, const float* dr, long long rows, int nq, int ns,
            int k, int n_kp, int cin, float inv_ext, int influence,
            float inv_den, OT* xws, cudaStream_t st) {
  if (cin % 4 == 0 && cin >= 128)
    return launch_contrib<4, kBf16, OT>(q, s, nb, kp, dr, rows, nq, ns, k,
                                        n_kp, cin, inv_ext, influence, inv_den,
                                        xws, st);
  if (cin % 2 == 0 && cin >= 64)
    return launch_contrib<2, kBf16, OT>(q, s, nb, kp, dr, rows, nq, ns, k,
                                        n_kp, cin, inv_ext, influence, inv_den,
                                        xws, st);
  return launch_contrib<1, kBf16, OT>(q, s, nb, kp, dr, rows, nq, ns, k, n_kp,
                                      cin, inv_ext, influence, inv_den, xws,
                                      st);
}

}  // namespace

// The most shared memory the card gives a block (the influence tile's
// limit), as kernel B's library reports it.
extern "C" long long kpconv_smem_limit() {
  return (long long)kpconv_common::smem_optin_bytes();
}

// Floats of workspace that kpconv_bwd_launch (and kpconv_bwd_bf16_launch)
// needs for its split-K GEMMs at these sizes (0: none); the two products
// run in turn and share it.
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
// 0 constant, 1 linear, 2 gaussian; inv_ext and inv_den: 1 / ext and
// 1 / den computed in double, rounded to f32. Returns cudaGetLastError()
// after the last launch, cudaErrorInvalidValue for a workspace too short
// or an influence tile past kpconv_smem_limit().
extern "C" int kpconv_bwd_launch(const float* q, const float* s,
                                 const int32_t* nb, const float* y,
                                 const float* kp, const float* w,
                                 const float* g, int b, int nq, int ns,
                                 int k, int n_kp, int cin, int cout,
                                 float inv_ext, int influence, float inv_den,
                                 int need_dx, const int32_t* inv_off,
                                 const int32_t* inv_ent, float* dr,
                                 float* xws, float* dx, float* dw,
                                 float* ws, long long ws_floats,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!kpconv_common::sizes_ok(n_kp, k, cin, cout))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * nq;
  const int kdim = n_kp * cin;
  int err = 0;

  if (need_dx) {
    if (rows > 0) {
      err = kpconv_common::gemm_tf32x3<true, true>(
          g, w, dr, ws, ws_floats, (int)rows, kdim, cout, st);
      if (err) return err;
      err = contrib<false, float>(q, s, nb, kp, dr, rows, nq, ns, k, n_kp,
                                  cin, inv_ext, influence, inv_den, xws, st);
      if (err) return err;
    }
    // Every support row of dX is written, an empty list as zeros
    err = inverse_lists::launch_inverse_sum(inv_off, inv_ent, xws,
                                            (long long)b * ns, cin, dx, st);
    if (err) return err;
  }
  // With rows = 0 the depth is empty and the core writes zeros.
  return kpconv_common::gemm_tf32x3<false, false>(
      y, g, dw, ws, ws_floats, kdim, cout, (int)rows, st);
}

// compute_dtype "bfloat16": as kpconv_bwd_launch with y bf16 (kernel B's
// bf16 aggregate), dr = bf(g @ bf(W)^T) (f32 storage), the slot sums
// rounded to bf16 into xws, bf16 [B*Nq*K, Cin] when Kp <= kKpChunk and f32
// otherwise, and dW = bf(y^T @ g) (f32 storage).
extern "C" int kpconv_bwd_bf16_launch(const float* q, const float* s,
                                      const int32_t* nb, const void* y,
                                      const float* kp, const float* w,
                                      const float* g, int b, int nq, int ns,
                                      int k, int n_kp, int cin, int cout,
                                      float inv_ext, int influence,
                                      float inv_den, int need_dx,
                                      const int32_t* inv_off,
                                      const int32_t* inv_ent, float* dr,
                                      void* xws, float* dx, float* dw,
                                      float* ws, long long ws_floats,
                                      void* stream) {
  using kpconv_common::kABf16;
  using kpconv_common::kBRoundBf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!kpconv_common::sizes_ok(n_kp, k, cin, cout))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * nq;
  const int kdim = n_kp * cin;
  const bool ws_bf16 = n_kp <= kKpChunk;
  int err = 0;

  if (need_dx) {
    if (rows > 0) {
      err = kpconv_common::gemm_tf32x3<true, true, kBRoundBf16>(
          g, w, dr, ws, ws_floats, (int)rows, kdim, cout, st, true);
      if (err) return err;
      err = ws_bf16
                ? contrib<true, __nv_bfloat16>(
                      q, s, nb, kp, dr, rows, nq, ns, k, n_kp, cin, inv_ext,
                      influence, inv_den,
                      static_cast<__nv_bfloat16*>(xws), st)
                : contrib<true, float>(q, s, nb, kp, dr, rows, nq, ns, k,
                                       n_kp, cin, inv_ext, influence, inv_den,
                                       static_cast<float*>(xws), st);
      if (err) return err;
    }
    err = ws_bf16
              ? inverse_lists::launch_inverse_sum(
                    inv_off, inv_ent, static_cast<const __nv_bfloat16*>(xws),
                    (long long)b * ns, cin, dx, st)
              : inverse_lists::launch_inverse_sum(
                    inv_off, inv_ent, static_cast<const float*>(xws),
                    (long long)b * ns, cin, dx, st);
    if (err) return err;
  }
  return kpconv_common::gemm_tf32x3<false, false, kABf16>(
      y, g, dw, ws, ws_floats, kdim, cout, (int)rows, st, true);
}
