// The deformable KPConv chain's pair work, forward and backward.
//
// Replaces no Pallas kernel: the JAX package runs the deformable chain in
// plain jnp (weasal_tpu/ops/kpconv.py:171-236), and the port ran it as the
// plain PyTorch chain `ops/kpconv.kpconv_dense`, which stays the route of
// 'closest' aggregation, of compute_dtype "bfloat16" and of the CPU.
// For one query row q (row = b * Nq + q) with neighbors nb_j, j < K, and
// Kp kernel points kp_p moved by the row's offsets:
//
//   deformed_p  = kp_p + off[row, p]                  (each axis rounded)
//   d2[p, j]    = |(s[nb_j] - q) - deformed_p|^2      (each axis rounded
//                 separately, no fused multiply-add; a shadow nb_j >= Ns
//                 sits at `shadow` on every axis, as the plain gather's
//                 pad row)
//   in_j        = any_p d2[p, j] < ext^2              (`ops.in_range`)
//   min_sq[p]   = min_j d2[p, j], shadows included    (`ops.nearest`)
//   hm[p, j]    = in_j ? h(d2[p, j]) : 0              linear: relu(1 -
//                 sqrt(d2) / ext); constant: 1; gaussian: exp(-d2 / den)
//   y[row, p, :] = sum_j hm[p, j] * x[b, nb_j, :]     (a shadow's row: 0)
//
// Each step is rounded as the plain chain rounds it on the card, with the
// divisions by ext and den as products with reciprocals computed in double
// (the caller's, as kernel B takes them), so d2, the in-range flags and
// the minima are the plain chain's bit for bit. What follows the
// aggregate (the modulations' product, y @ W) stays plain PyTorch.
//
// The backward takes dY = dL/dy [rows, Kp, Cin] and dmin = dL/dmin_sq
// (null: none) and gives
//   ws[(row, j), :]  = sum_p hm[p, j] * dY[row, p, :]  for each real slot
//                      (zeros outside the range), which the caller adds
//                      into dX in the fixed order of the edge's inverse
//                      lists (inverse_sum), as kernel C's dX;
//   doff[row, p, :]  = -sum_j 2 * g2[p, j] * ((s[nb_j] - q) - deformed_p)
//   g2[p, j]         = in_j * dh/dd2 * <dY[row, p], x[nb_j]>
//                      + [d2[p, j] == min_sq[p]] * dmin[p] / ties_p
// with autograd's own expressions at the kinks: clamp passes the gradient
// where 1 - sqrt(d2) / ext >= 0, the strict in-range test passes none,
// tied minima share it equally (amin's backward), and sqrt's is
// grad / (2 * sqrt(d2)). At d2 = 0 (a neighbor on its deformed kernel
// point, inside the range) that is a division by zero, whose inf or NaN
// times the zero differences gives NaN in doff, as the plain chain does.
//
// What bounds it on the H100. The plain chain wrote every pair
// intermediate to device memory ([B, Nq, K, Kp, 3] differences, the
// [B, Nq, K, Kp] distances, influences and masks, the gathered [B, Nq, K,
// Cin] features) and autograd kept most of them for the backward; the
// work itself is rows * K * Kp * Cin multiply-adds a product, and the
// bytes are the inputs and outputs. Here nothing of size K * Kp leaves the
// block: one block a row builds its geometry in shared memory, so the
// forward is bound by the aggregate's multiply-adds and its reads of the
// gathered rows (x stays in L2 at these widths), and the backward by the
// same two products plus the dX workspace [rows * K, Cin], written once
// and read once by the row sums: the one pair-sized tensor left, which
// keeps dX's sum order fixed with no atomics. (At the deformable cell's
// shapes 13-16 % of the real slots lie in range, so most of it is zeros
// that the edge's lists still read.)
// Design, per row (block):
//  - geometry: each thread owns slots j and runs all Kp kernel points for
//    them, so in_j is its own; the minima go through one warp reduction
//    (__reduce_min_sync on the bits: d2 >= 0, so the bits order as the
//    values) and one shared atomicMin a warp and kernel point. The masked
//    influences are stored slot-major, hT[j][p] (Kp padded to a multiple
//    of 4), so a thread reads a slot's 16 kernel points as 4 vector loads.
//  - the slots inside the range, ascending, are listed by one warp
//    (ballot); the aggregate and the dot products run only over them.
//  - forward aggregate: a thread a channel holds 16 kernel points' sums in
//    registers and reads each listed neighbor's x once (coalesced across
//    the warp); past 16 kernel points it runs them in chunks.
//  - backward slot sums: a thread holds VEC channels of 16 kernel points'
//    dY in registers and loops over the slots (several threads a channel
//    group where Cin / VEC is below the block); past 16 kernel points the
//    chunks add to the partial sums the chunk before wrote.
//  - backward dots: a thread a listed slot reads its neighbor's x row once
//    (VEC wide) against dY staged in shared memory (every lane of a warp
//    reads the same dY element: broadcast), 16 kernel points at a time.
//  - backward offsets: a warp a kernel point, lanes over the slots, the
//    three sums reduced by shuffles: a fixed order, so a seeded step
//    repeats bit for bit.
// f32 in and out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kpconv_common.cuh"

namespace {

// Kernel points whose sums a thread holds in registers at once
constexpr int kPointChunk = 16;

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// The shared memory of a block, in 4-byte words, in this order: hT
// (slot-major masked influences [k][pad4(n_kp)], 16 words of slack for
// the last slot's vector reads past Kp; the backward's dot products
// [n_kp][k] reuse it), then the backward's dY [n_kp][cin] and distances
// d2 [n_kp][k], then rel [k][3] (s - q), dkp [n_kp][3] (the deformed
// kernel points), nbs, ins, act [k] (the neighbor or -1, the in-range
// flags, the listed slots), mn [n_kp] (minima as bits) and the list's
// length.
struct Layout {
  long long ht, dy, d2, rel, dkp, nbs, ins, act, mn, nact, words;
  __host__ __device__ Layout(int n_kp, int k, int cin, bool backward) {
    long long o = 0;
    ht = o;
    o += (long long)k * pad4(n_kp) + kPointChunk;   // a multiple of 4
    dy = o;
    if (backward) o += (((long long)n_kp * cin) + 3) & ~3LL;
    d2 = o;
    if (backward) o += (long long)n_kp * k;
    rel = o;
    o += 3LL * k;
    dkp = o;
    o += 3LL * n_kp;
    nbs = o;
    o += k;
    ins = o;
    o += k;
    act = o;
    o += k;
    mn = o;
    o += n_kp;
    nact = o;
    o += 1;
    words = o;
  }
  __host__ __device__ size_t bytes() const { return (size_t)words * 4; }
};

// The row's neighbors (nbs: the index, -1 for a shadow), their
// coordinates relative to the query (rel = s - q, a shadow at `shadow`),
// the deformed kernel points (dkp = kp + off), the minima at +inf and the
// in-range flags at 0. Ends with a barrier.
__device__ __forceinline__ void load_row(
    size_t row, int b, const float* __restrict__ q,
    const float* __restrict__ s, const int32_t* __restrict__ nb,
    const float* __restrict__ kp, const float* __restrict__ off, int ns,
    int k, int n_kp, float shadow, float* rel, float* dkp, int* nbs,
    int* ins, int* mn) {
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int n = nb[row * k + j];
    const bool real = n >= 0 && n < ns;
    nbs[j] = real ? n : -1;
    ins[j] = 0;
    const float* sp = s + ((size_t)b * ns + (real ? n : 0)) * 3;
    rel[j * 3 + 0] = __fsub_rn(real ? sp[0] : shadow, qx);
    rel[j * 3 + 1] = __fsub_rn(real ? sp[1] : shadow, qy);
    rel[j * 3 + 2] = __fsub_rn(real ? sp[2] : shadow, qz);
  }
  for (int i = threadIdx.x; i < n_kp * 3; i += blockDim.x)
    dkp[i] = __fadd_rn(kp[i], off[row * (size_t)n_kp * 3 + i]);
  for (int p = threadIdx.x; p < n_kp; p += blockDim.x) mn[p] = 0x7f800000;
  __syncthreads();
}

// The plain chain's squared distance of slot j to deformed kernel point
// p, and its differences
__device__ __forceinline__ float pair_d2(const float* rel, const float* dkp,
                                         int j, int p, float& dx, float& dy,
                                         float& dz) {
  dx = __fsub_rn(rel[j * 3 + 0], dkp[p * 3 + 0]);
  dy = __fsub_rn(rel[j * 3 + 1], dkp[p * 3 + 1]);
  dz = __fsub_rn(rel[j * 3 + 2], dkp[p * 3 + 2]);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// h(d2) as the plain chain computes it (influence_weights)
__device__ __forceinline__ float influence_of(float d2, int influence,
                                              float inv_ext, float inv_den) {
  if (influence == 0) return 1.f;
  if (influence == 1)
    return fmaxf(__fsub_rn(1.f, __fmul_rn(sqrtf(d2), inv_ext)), 0.f);
  return expf(__fmul_rn(-d2, inv_den));
}

// Every pair of the row: d2 (into d2s [n_kp][k] when given), the in-range
// flags, the minima (bits, one warp reduction and one shared atomic a
// warp and kernel point) and the masked influences hT [k][pad4(n_kp)]
// (the padding zero). Each thread owns whole slots, so in_j is its own;
// the loop runs whole warps, lanes past k taking no part. Ends with a
// barrier.
__device__ __forceinline__ void pair_pass(
    const float* rel, const float* dkp, int k, int n_kp, float thr,
    int influence, float inv_ext, float inv_den, float* ht, float* d2s,
    int* ins, int* mn) {
  const int lane = threadIdx.x & 31;
  const int kp4 = pad4(n_kp);
  for (int base = threadIdx.x - lane; base < k; base += blockDim.x) {
    const int j = base + lane;
    const bool live = j < k;
    bool inside = false;
    for (int p = 0; p < n_kp; ++p) {
      float dx, dy, dz;
      const float d2 = live ? pair_d2(rel, dkp, j, p, dx, dy, dz)
                            : __int_as_float(0x7f800000);
      if (live) {
        ht[(size_t)j * kp4 + p] = d2;
        if (d2s) d2s[(size_t)p * k + j] = d2;
      }
      inside |= d2 < thr;
      const int m = __reduce_min_sync(0xffffffffu, __float_as_int(d2));
      if (lane == 0) atomicMin(&mn[p], m);
    }
    if (live) {
      ins[j] = inside;
      float* hj = ht + (size_t)j * kp4;
      for (int p = 0; p < n_kp; ++p)
        hj[p] = inside ? influence_of(hj[p], influence, inv_ext, inv_den)
                       : 0.f;
      for (int p = n_kp; p < kp4; ++p) hj[p] = 0.f;
    }
  }
  __syncthreads();
}

// The real slots inside the range, ascending, into act, and their number
// into *nact, by warp 0 (ballots over 32 slots at a time). No barrier.
__device__ __forceinline__ void list_slots(const int* nbs, const int* ins,
                                           int k, int* act, int* nact) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int count = 0;
  for (int base = 0; base < k; base += 32) {
    const int j = base + lane;
    const bool on = j < k && nbs[j] >= 0 && ins[j];
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (on) act[count + __popc(ballot & ((1u << lane) - 1u))] = j;
    count += __popc(ballot);
  }
  if (lane == 0) *nact = count;
}

// ---------------------------------------------------------------------------
// Forward

// One chunk of np <= kPointChunk kernel points at channel c: the sums over
// the listed slots in registers, each gathered x read once.
__device__ __forceinline__ void aggregate_points(
    const float* ht, int kp4, int p0, const int* act, int nact,
    const int* nbs, const float* __restrict__ xb, int cin, int c, int np,
    float* __restrict__ yc) {
  float acc[kPointChunk];
#pragma unroll
  for (int p = 0; p < kPointChunk; ++p) acc[p] = 0.f;
#pragma unroll 2
  for (int i = 0; i < nact; ++i) {
    const int j = act[i];
    const float v = xb[(size_t)nbs[j] * cin + c];
    const float4* h4 =
        reinterpret_cast<const float4*>(ht + (size_t)j * kp4 + p0);
#pragma unroll
    for (int t = 0; t < kPointChunk / 4; ++t) {
      const float4 h = h4[t];
      acc[4 * t + 0] = fmaf(h.x, v, acc[4 * t + 0]);
      acc[4 * t + 1] = fmaf(h.y, v, acc[4 * t + 1]);
      acc[4 * t + 2] = fmaf(h.z, v, acc[4 * t + 2]);
      acc[4 * t + 3] = fmaf(h.w, v, acc[4 * t + 3]);
    }
  }
#pragma unroll
  for (int p = 0; p < kPointChunk; ++p)
    if (p < np) yc[(size_t)p * cin + c] = acc[p];
}

__global__ void __launch_bounds__(256) deform_pairs_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ s,
    const int32_t* __restrict__ nb, const float* __restrict__ x,
    const float* __restrict__ kp, const float* __restrict__ off, int nq,
    int ns, int k, int n_kp, int cin, float inv_ext, int influence,
    float inv_den, float thr, float shadow, float* __restrict__ y,
    float* __restrict__ min_sq, uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(n_kp, k, cin, false);
  float* ht = smem + L.ht;
  float* rel = smem + L.rel;
  float* dkp = smem + L.dkp;
  int* nbs = reinterpret_cast<int*>(smem + L.nbs);
  int* ins = reinterpret_cast<int*>(smem + L.ins);
  int* act = reinterpret_cast<int*>(smem + L.act);
  int* mn = reinterpret_cast<int*>(smem + L.mn);
  int* nact = reinterpret_cast<int*>(smem + L.nact);

  const size_t row = blockIdx.x;
  const int b = (int)(row / nq);
  load_row(row, b, q, s, nb, kp, off, ns, k, n_kp, shadow, rel, dkp, nbs,
           ins, mn);
  pair_pass(rel, dkp, k, n_kp, thr, influence, inv_ext, inv_den, ht,
            nullptr, ins, mn);
  list_slots(nbs, ins, k, act, nact);
  for (int p = threadIdx.x; p < n_kp; p += blockDim.x)
    min_sq[row * n_kp + p] = __int_as_float(mn[p]);
  if (mask)
    for (int j = threadIdx.x; j < k; j += blockDim.x)
      mask[row * k + j] = (uint8_t)ins[j];
  __syncthreads();

  const int kp4 = pad4(n_kp);
  const int na = *nact;
  const float* xb = x + (size_t)b * ns * cin;
  float* yr = y + row * (size_t)n_kp * cin;
  for (int c = threadIdx.x; c < cin; c += blockDim.x)
    for (int p0 = 0; p0 < n_kp; p0 += kPointChunk)
      aggregate_points(ht, kp4, p0, act, na, nbs, xb, cin, c,
                       min(kPointChunk, n_kp - p0), yr + (size_t)p0 * cin);
}

// ---------------------------------------------------------------------------
// Backward

template <int VEC>
struct Lanes {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Lanes<VEC> load_lanes(const float* p) {
  Lanes<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x, r.v[1] = t.y, r.v[2] = t.z, r.v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = p[i];
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_lanes(float* p, const Lanes<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = r.v[i];
  }
}

// The slot sums of one chunk of np <= kPointChunk kernel points (from
// p0) at channels c..c+VEC, for the slots jl, jl + jstep, ...: the
// chunk's dY in registers; the first chunk writes each real slot's sum
// (zeros outside the range), a later one adds to it.
template <int VEC>
__device__ __forceinline__ void slot_sums(const float* ht, int kp4, int p0,
                                          int np, const float* dys,
                                          const int* nbs, const int* ins,
                                          int k, int cin, int c, int jl,
                                          int jstep, float* __restrict__ out) {
  Lanes<VEC> d[kPointChunk];
#pragma unroll
  for (int p = 0; p < kPointChunk; ++p) {
    if (p < np) {
      d[p] = load_lanes<VEC>(dys + (size_t)(p0 + p) * cin + c);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[p].v[v] = 0.f;
    }
  }
  for (int j = jl; j < k; j += jstep) {
    if (nbs[j] < 0) continue;                      // in no inverse list
    float* o = out + (size_t)j * cin + c;
    Lanes<VEC> acc;
    if (p0 == 0) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc.v[v] = 0.f;
    } else {
      acc = load_lanes<VEC>(o);
    }
    if (ins[j]) {
      const float4* h4 =
          reinterpret_cast<const float4*>(ht + (size_t)j * kp4 + p0);
#pragma unroll
      for (int t = 0; t < kPointChunk / 4; ++t) {
        const float4 h = h4[t];
        const float hp[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (4 * t + u < np) {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc.v[v] = fmaf(hp[u], d[4 * t + u].v[v], acc.v[v]);
          }
        }
      }
    }
    store_lanes<VEC>(o, acc);
  }
}

// The dot products <dY[row, p], x[nb_j]> of one listed slot j for the
// kernel points p0..p0+np, into dots [n_kp][k]; x read VEC wide, dY from
// shared memory (all lanes of a warp at the same element).
template <int VEC>
__device__ __forceinline__ void slot_dots(const float* __restrict__ xr,
                                          const float* dys, int cin, int p0,
                                          int np, int k, int j,
                                          float* dots) {
  float acc[kPointChunk];
#pragma unroll
  for (int p = 0; p < kPointChunk; ++p) acc[p] = 0.f;
  for (int c = 0; c < cin; c += VEC) {
    const Lanes<VEC> xv = load_lanes<VEC>(xr + c);
#pragma unroll
    for (int p = 0; p < kPointChunk; ++p) {
      if (p < np) {
        const Lanes<VEC> dv = load_lanes<VEC>(dys + (size_t)(p0 + p) * cin
                                              + c);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[p] = fmaf(dv.v[v], xv.v[v], acc[p]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPointChunk; ++p)
    if (p < np) dots[(size_t)(p0 + p) * k + j] = acc[p];
}

// VEC consecutive channels a thread in the slot sums and VEC-wide reads
// of x and dY in the dot products (Cin a multiple of VEC). ws: the dX
// workspace [rows * k, cin] (null: no dX); doff [rows, n_kp, 3] (null: no
// offset gradient); dmin (null: the minima take no gradient).
template <int VEC>
__global__ void __launch_bounds__(256) deform_pairs_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ s,
    const int32_t* __restrict__ nb, const float* __restrict__ x,
    const float* __restrict__ kp, const float* __restrict__ off,
    const float* __restrict__ dy, const float* __restrict__ dmin, int nq,
    int ns, int k, int n_kp, int cin, float inv_ext, int influence,
    float inv_den, float thr, float shadow, float* __restrict__ ws,
    float* __restrict__ doff) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(n_kp, k, cin, true);
  float* ht = smem + L.ht;
  float* dys = smem + L.dy;
  float* d2s = smem + L.d2;
  float* rel = smem + L.rel;
  float* dkp = smem + L.dkp;
  int* nbs = reinterpret_cast<int*>(smem + L.nbs);
  int* ins = reinterpret_cast<int*>(smem + L.ins);
  int* act = reinterpret_cast<int*>(smem + L.act);
  int* mn = reinterpret_cast<int*>(smem + L.mn);
  int* nact = reinterpret_cast<int*>(smem + L.nact);

  const size_t row = blockIdx.x;
  const int b = (int)(row / nq);
  const float* dyr = dy + row * (size_t)n_kp * cin;
  for (int i = threadIdx.x * VEC; i < n_kp * cin; i += blockDim.x * VEC)
    store_lanes<VEC>(dys + i, load_lanes<VEC>(dyr + i));
  load_row(row, b, q, s, nb, kp, off, ns, k, n_kp, shadow, rel, dkp, nbs,
           ins, mn);
  pair_pass(rel, dkp, k, n_kp, thr, influence, inv_ext, inv_den, ht, d2s,
            ins, mn);
  list_slots(nbs, ins, k, act, nact);

  const int kp4 = pad4(n_kp);
  if (ws) {
    // a thread a channel group, and several a group where the groups are
    // fewer than the threads, each over its own slots
    const int groups = cin / VEC;
    const int jstep = groups < (int)blockDim.x ? blockDim.x / groups : 1;
    float* out = ws + row * (size_t)k * cin;
    for (int t = threadIdx.x; t < groups * jstep; t += blockDim.x) {
      const int c = (t % groups) * VEC;
      for (int p0 = 0; p0 < n_kp; p0 += kPointChunk)
        slot_sums<VEC>(ht, kp4, p0, min(kPointChunk, n_kp - p0), dys, nbs,
                       ins, k, cin, c, t / groups, jstep, out);
    }
  }
  if (!doff) return;
  __syncthreads();                                  // ht read, list made

  float* dots = ht;                                 // [n_kp][k]
  const int na = *nact;
  const float* xb = x + (size_t)b * ns * cin;
  for (int i = threadIdx.x; i < na; i += blockDim.x) {
    const int j = act[i];
    for (int p0 = 0; p0 < n_kp; p0 += kPointChunk)
      slot_dots<VEC>(xb + (size_t)nbs[j] * cin, dys, cin, p0,
                     min(kPointChunk, n_kp - p0), k, j, dots);
  }
  __syncthreads();

  // a warp a kernel point: its ties, then the three sums over the slots
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < n_kp; p += blockDim.x >> 5) {
    const float* d2p = d2s + (size_t)p * k;
    const int least = mn[p];
    float share = 0.f;
    if (dmin) {
      int ties = 0;
      for (int j = lane; j < k; j += 32)
        ties += __float_as_int(d2p[j]) == least;
      ties = __reduce_add_sync(0xffffffffu, ties);
      share = __fdiv_rn(dmin[row * n_kp + p], (float)ties);
    }
    float gx = 0.f, gy = 0.f, gz = 0.f;
    for (int j = lane; j < k; j += 32) {
      const float d2 = d2p[j];
      float g = 0.f;
      bool any = false;
      if (nbs[j] >= 0 && ins[j] && influence != 0) {
        const float gh = dots[(size_t)p * k + j];
        if (influence == 1) {
          const float r = sqrtf(d2);
          if (__fsub_rn(1.f, __fmul_rn(r, inv_ext)) >= 0.f) {
            // rsub, the division by ext, sqrt: -gh * (1/ext) / (2 r)
            g = __fdiv_rn(__fmul_rn(-gh, inv_ext), __fmul_rn(2.f, r));
            any = true;
          }
        } else {
          // exp, the division by den, the negation
          const float e = expf(__fmul_rn(-d2, inv_den));
          g = -__fmul_rn(__fmul_rn(gh, e), inv_den);
          any = true;
        }
      }
      if (dmin && __float_as_int(d2) == least) {
        g = any ? __fadd_rn(g, share) : share;
        any = true;
      }
      if (any) {
        float dx, dy_, dz;
        pair_d2(rel, dkp, j, p, dx, dy_, dz);
        // sq = diffs * diffs: grad * d + grad * d = 2 (grad * d)
        gx = __fadd_rn(gx, __fmul_rn(2.f, __fmul_rn(g, dx)));
        gy = __fadd_rn(gy, __fmul_rn(2.f, __fmul_rn(g, dy_)));
        gz = __fadd_rn(gz, __fmul_rn(2.f, __fmul_rn(g, dz)));
      }
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      gx = __fadd_rn(gx, __shfl_xor_sync(0xffffffffu, gx, m));
      gy = __fadd_rn(gy, __shfl_xor_sync(0xffffffffu, gy, m));
      gz = __fadd_rn(gz, __shfl_xor_sync(0xffffffffu, gz, m));
    }
    if (lane == 0) {
      float* o = doff + (row * n_kp + p) * 3;
      o[0] = -gx;
      o[1] = -gy;
      o[2] = -gz;
    }
  }
}

// Threads a block: a channel a thread in the forward's aggregate (up to
// 256); 128 in the backward (106 registers a thread: 4 blocks an SM; on
// an H100 at the deformable cell's shapes its time fell 19-28 % from 256,
// where 2 blocks fit and the slots in range, 13-16 % of K, left most
// threads of the dot products idle)
inline int fwd_threads(int cin) {
  int t = ((cin + 31) / 32) * 32;
  return t < 64 ? 64 : (t > 256 ? 256 : t);
}
constexpr int kBwdThreads = 128;

template <auto Kernel>
int allow_smem(size_t smem) {
  return kpconv_common::allow_influence_smem<Kernel>(smem);
}

bool sizes_ok(int n_kp, int k, int cin, size_t smem) {
  return n_kp >= 1 && k >= 1 && cin >= 1 &&
         smem <= kpconv_common::smem_optin_bytes();
}

}  // namespace

// The most shared memory the card gives a block
extern "C" long long deform_kpconv_smem_limit() {
  return (long long)kpconv_common::smem_optin_bytes();
}

// Bytes of shared memory a block of the forward (backward = 0) or the
// backward (1) takes at these sizes; a launch past
// deform_kpconv_smem_limit() is refused.
extern "C" long long deform_kpconv_smem(int n_kp, int k, int cin,
                                        int backward) {
  return (long long)Layout(n_kp, k, cin, backward != 0).bytes();
}

// q [B,Nq,3], s [B,Ns,3], nb [B,Nq,K] i32, x [B,Ns,Cin], kp [Kp,3],
// off [B,Nq,Kp,3]; outputs y [B,Nq,Kp,Cin], min_sq [B,Nq,Kp] and, when
// not null, mask [B,Nq,K] u8 (the in-range flags); f32, contiguous.
// influence: 0 constant, 1 linear, 2 gaussian; inv_ext, inv_den: 1 / ext
// and 1 / den computed in double, rounded to f32; thr: ext^2 rounded to
// f32; shadow: a shadow neighbor's coordinate. Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for sizes past the card's
// shared memory.
extern "C" int deform_kpconv_fwd_launch(
    const float* q, const float* s, const int32_t* nb, const float* x,
    const float* kp, const float* off, int b, int nq, int ns, int k, int n_kp,
    int cin, float inv_ext, int influence, float inv_den, float thr,
    float shadow, float* y, float* min_sq, uint8_t* mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = Layout(n_kp, k, cin, false).bytes();
  if (!sizes_ok(n_kp, k, cin, smem)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * nq;
  if (rows == 0) return 0;
  const int err = allow_smem<deform_pairs_fwd_kernel>(smem);
  if (err) return err;
  deform_pairs_fwd_kernel<<<(unsigned)rows, fwd_threads(cin), smem, st>>>(
      q, s, nb, x, kp, off, nq, ns, k, n_kp, cin, inv_ext, influence, inv_den,
      thr, shadow, y, min_sq, mask);
  return (int)cudaGetLastError();
}

// The backward of deform_kpconv_fwd_launch at its inputs: dy [B,Nq,Kp,Cin]
// and dmin [B,Nq,Kp] (null: the minima take no gradient) in; ws
// [B*Nq*K, Cin] (null: no dX), each real slot's sum over the kernel
// points, for the inverse lists' row sums; doff [B,Nq,Kp,3] (null: none).
// The same sizes, arguments and return values as the forward.
extern "C" int deform_kpconv_bwd_launch(
    const float* q, const float* s, const int32_t* nb, const float* x,
    const float* kp, const float* off, const float* dy, const float* dmin,
    int b, int nq, int ns, int k, int n_kp, int cin, float inv_ext,
    int influence, float inv_den, float thr, float shadow, float* ws,
    float* doff, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = Layout(n_kp, k, cin, true).bytes();
  if (!sizes_ok(n_kp, k, cin, smem)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * nq;
  if (rows == 0 || (!ws && !doff)) return 0;
  // x, dy and ws come from the allocator: with Cin a multiple of 4 (and
  // 16-byte aligned x), every 4-wide access is aligned
  const bool vec4 = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                    && reinterpret_cast<uintptr_t>(dy) % 16 == 0
                    && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  int err;
  if (vec4) {
    err = allow_smem<deform_pairs_bwd_kernel<4>>(smem);
    if (err) return err;
    deform_pairs_bwd_kernel<4><<<(unsigned)rows, kBwdThreads, smem, st>>>(
        q, s, nb, x, kp, off, dy, dmin, nq, ns, k, n_kp, cin, inv_ext,
        influence, inv_den, thr, shadow, ws, doff);
  } else {
    err = allow_smem<deform_pairs_bwd_kernel<1>>(smem);
    if (err) return err;
    deform_pairs_bwd_kernel<1><<<(unsigned)rows, kBwdThreads, smem, st>>>(
        q, s, nb, x, kp, off, dy, dmin, nq, ns, k, n_kp, cin, inv_ext,
        influence, inv_den, thr, shadow, ws, doff);
  }
  return (int)cudaGetLastError();
}
