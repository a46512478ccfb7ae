// Exact fixed-width radius search over a batch of padded spheres, by
// columns of a 2-D grid.
//
// Replaces the Pallas TPU kernel weasal_tpu/ops/pallas/radius_pallas.py
// (`_search_kernel` behind `radius_search_banded`). For every valid query
// it returns up to K valid supports of the same sphere with d2 <= r2,
// sorted by distance, ties to the lowest support index, missing slots = Ns;
// an invalid query gets an all-Ns row.
//
// What bounds it on the H100: the function needs only the in-radius pairs
// (about K per query) and moves few bytes (two point sets in, K indices
// out), so a search that tests all pairs wastes > 99 % of its work. The
// TPU kernel cut the candidates with a window over an x-sorted order,
// which can miss neighbors; here the supports are binned into columns and
// a query tests only the columns its reach overlaps, so the candidates are
// cut exactly. Two launches:
//
// 1. bin_supports_kernel, one block of 1024 threads per sphere: the (x, y)
//    bounding box of the valid supports, the column side
//    h = max(reach, extent / kGridSide), a count of the supports per
//    column (shared-memory atomics on kGridSide^2 counters, 64 KB of
//    dynamic shared memory), an exclusive scan, and a scatter of
//    (x, y, z, original index) into a column-ordered copy. The column
//    starts [B, kGridSide^2 + 1] and the grid parameters [B] (x0, y0,
//    1/h, reach) go to scratch. Every size is static: the host never
//    synchronises.
// 2. The search, over all B * Nq queries (they arrive in voxel order, so
//    neighbouring queries visit the same columns): for each of the rows
//    col(yq - reach) .. col(yq + reach) it scans the contiguous range of
//    columns col(xq - reach) .. col(xq + reach), tests d2 exactly as the
//    plain version does (per axis, on the original coordinates, the copy
//    holding bit copies, with round-to-nearest intrinsics so that no fused
//    multiply-add moves a point across the boundary), and ranks the hits
//    under the total order (d2, original index) as 64-bit keys
//    (d2 bits << 32 | index; monotone because d2 >= 0). Two kernels:
//    - K <= 16, search_kernel<4 | 16>: one thread a query, kBatch
//      candidate loads in flight, the K best sorted in 4 or 16 registers
//      with a compare-exchange pass over constant indices per hit.
//    - K > 16, warp_search_kernel: one warp a query. The lanes test 32
//      consecutive candidates of a row's range at a time (kWarpBatch
//      chunks of loads in flight, coalesced: a column's supports are
//      contiguous in the copy); __ballot_sync / __popc compact the hits
//      into the warp's buffer of cap keys in shared memory (cap the power
//      of two >= K + 32, at most 1024 keys, 8 KB, so a block holds
//      kSearchThreads / 32 warps at any K). A chunk that would overflow
//      the buffer first cuts it to its K smallest (a bitonic sort by the
//      warp), the K-th key becomes the limit, and keys above it are
//      refused from then on. At the end a bitonic sort of the remaining
//      keys (padded with kNoKey to a power of two) gives the row, which
//      the lanes write coalesced, missing slots = Ns. The work is linear
//      in the candidates and n log^2 n in the hits, spread over 32 lanes.
//    What bounds it: each query is a dependent chain of candidate loads
//    (L2 latency), ballots and a sort's shared-memory steps; the card
//    hides that latency only with many warps in flight, which is why no
//    design here keeps a query's list in one thread (the former
//    per-thread lists ranked in quadratic time and, at K 266, left 2 warps
//    an SM: 9.4 ms a call where the plain all-pairs search takes 3.2).
//    The split at K = 16 was measured (H100 80GB HBM3 at 700 W, device
//    time a call, weasal_tpu_torch/tools/kernel_variants.py; PERF.md): at
//    K = 1-15 the warp path takes 0.7-2.1x the registers' time a call,
//    1.34-1.36x summed over those edges (32 lanes for a few hits); at the
//    main path's K = 22-34 it takes 0.020-0.078 ms where registers up to
//    K 48 take 1.7-6.5x as long and the former per-thread lists 1.1-4.5x;
//    at the deformable layers' K of 215-302 it takes 0.029-0.082 ms where
//    the lists took 1.8-22.6 ms.
//    Candidates arrive in no fixed order, and the scatter's order within
//    a column varies from run to run, but the order is total and the cut
//    keeps exactly the K smallest keys, so the output is deterministic.
//
// Exactness. col(v) = clamp(floor((v - x0) * (1/h)), 0, kGridSide - 1),
// each operation in f32 round-to-nearest, is monotone in v, and queries
// and supports go through the same function; so a support whose x lies in
// [fl(xq - reach), fl(xq + reach)] has a column in the visited range,
// whatever the rounding of the column index. It remains to show that
// every support the f32 test accepts lies in that interval (and the same
// for y). If fl(fl(dx^2) + fl(dy^2) + fl(dz^2)) <= r2 then fl(dx^2) <= r2,
// so |xq - xs| <= sqrt(r2) (1 + 2^-22) (the rounding of dx, of dx^2 and of
// the sum). The reach is fl(sqrt(r2) * kReachScale) + fl(m * kAbsSlack),
// with m the largest |coordinate| of the sphere's valid supports, and at
// least kMinReach:
// - kReachScale = 1 + delta, delta = 1e-3, covers the relative rounding
//   of d2, 2^-22, 4000 times over;
// - the rounding of fl(xq -/+ reach), at most 2^-24 (|xq| + reach) with
//   |xq| <= m + sqrt(r2)(1 + 2^-22) for a support in range, is covered by
//   delta for the sqrt(r2) part and by kAbsSlack = 2^-20 (16 times
//   2^-24) for the m part;
// - kMinReach = 2^-60 covers d2 terms that underflow (|dx| < 2^-63),
//   where the relative argument does not hold.
// So the candidates include every support the plain version accepts, for
// any finite coordinates and radius, and the search is exact. The cost
// of the margin: at level 0 (r = 0.6 m) it widens the reach by 0.6 mm.
//
// 2-D columns, not 3-D cells: aerial LiDAR is 2.5-D. On chip_smoke.py's
// synthetic Vaihingen spheres the PyTorch emulation of this column rule
// (radius_search_binned_reference) gives a query 47 candidates on average
// at level 0 (75 at most) against the sphere's 16k, 125 at level 1 and 242
// at level 2 (its reach spans 2-3 columns a side); 10-16 % of them are in
// radius. chip_smoke.py reports the emulation's count at each edge.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kGridSide = 128;                       // columns per axis
constexpr int kCells = kGridSide * kGridSide;        // 64 KB of counters
constexpr float kReachScale = 1.001f;                // 1 + delta
constexpr float kAbsSlack = 0x1p-20f;                // times max |coord|
constexpr float kMinReach = 0x1p-60f;
constexpr int kBinThreads = 1024;
constexpr int kBinWarps = kBinThreads / 32;
constexpr int kCellsPerWarp = kCells / kBinWarps;
constexpr int kSearchThreads = 128;  // both search kernels' block
constexpr int kSearchWarps = kSearchThreads / 32;
constexpr int kBatch = 4;          // candidate loads a thread keeps in flight
constexpr int kWarpBatch = 2;      // chunks of 32 loads a warp keeps in flight
constexpr int kRegisterK = 16;     // largest K kept in registers
constexpr int kMaxK = 768;
constexpr int kMaxCap = 1024;      // a warp's buffer at kMaxK: 8 KB
static_assert(kMaxCap >= kMaxK + 32, "a cut must leave room for a chunk");
static_assert(kSearchWarps * kMaxCap * 8 <= 48 * 1024,
              "the buffers fit the default shared-memory limit");
constexpr int kMaxDevices = 64;    // devices whose attributes are cached
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

static_assert(kCells % (kBinWarps * 32) == 0, "scan layout");

__device__ __forceinline__ int column(float v, float origin, float inv_h) {
  const float t = floorf(__fmul_rn(__fsub_rn(v, origin), inv_h));
  return (int)fminf(fmaxf(t, 0.f), (float)(kGridSide - 1));
}

// (x0, y0, 1/h, reach) of a sphere from its valid supports' bounding box
// (lo > hi: no valid support).
__device__ float4 grid_params(float lo_x, float lo_y, float hi_x,
                              float hi_y, float r2) {
  if (!(lo_x <= hi_x)) lo_x = lo_y = hi_x = hi_y = 0.f;
  const float m = fmaxf(fmaxf(fabsf(lo_x), fabsf(hi_x)),
                        fmaxf(fabsf(lo_y), fabsf(hi_y)));
  float reach = __fadd_rn(__fmul_rn(__fsqrt_rn(r2), kReachScale),
                          __fmul_rn(m, kAbsSlack));
  reach = fmaxf(reach, kMinReach);
  const float extent = fmaxf(__fsub_rn(hi_x, lo_x), __fsub_rn(hi_y, lo_y));
  const float h = fmaxf(reach, __fmul_rn(extent, 1.0f / kGridSide));
  return make_float4(lo_x, lo_y, __fdiv_rn(1.0f, h), reach);
}

__device__ __forceinline__ int cell_of(float x, float y, float4 g) {
  return column(y, g.y, g.z) * kGridSide + column(x, g.x, g.z);
}

// The key (d2 bits << 32 | index) of support p when its f32 d2 to the
// query is within r2, else kNoKey: per axis, each operation rounded.
__device__ __forceinline__ unsigned long long hit_key(float4 p, float qx,
                                                      float qy, float qz,
                                                      float r2) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  float d2 = __fmul_rn(dx, dx);
  d2 = __fadd_rn(d2, __fmul_rn(dy, dy));
  d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
  if (!(d2 <= r2)) return kNoKey;
  return ((unsigned long long)__float_as_uint(d2) << 32) |
         (unsigned)__float_as_int(p.w);
}

__global__ void __launch_bounds__(kBinThreads)
    bin_supports_kernel(const float* __restrict__ s,
                        const uint8_t* __restrict__ s_mask, int ns, float r2,
                        float4* __restrict__ sorted,
                        float4* __restrict__ params,
                        int* __restrict__ starts) {
  extern __shared__ int cell[];                      // [kCells]
  __shared__ float box[4][kBinWarps];
  __shared__ int warp_base[kBinWarps];
  __shared__ float4 grid_s;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* sb = s + (size_t)b * ns * 3;
  const uint8_t* mb = s_mask + (size_t)b * ns;

  float lo_x = INFINITY, lo_y = INFINITY, hi_x = -INFINITY, hi_y = -INFINITY;
  // Each loop over the supports loads before it branches and is
  // unrolled, so that several loads are in flight per thread.
#pragma unroll 4
  for (int i = threadIdx.x; i < ns; i += kBinThreads) {
    const bool valid = mb[i];
    const float x = sb[3 * i], y = sb[3 * i + 1];
    if (valid) {
      lo_x = fminf(lo_x, x);
      lo_y = fminf(lo_y, y);
      hi_x = fmaxf(hi_x, x);
      hi_y = fmaxf(hi_y, y);
    }
  }
  for (int off = 16; off; off >>= 1) {
    lo_x = fminf(lo_x, __shfl_xor_sync(kFull, lo_x, off));
    lo_y = fminf(lo_y, __shfl_xor_sync(kFull, lo_y, off));
    hi_x = fmaxf(hi_x, __shfl_xor_sync(kFull, hi_x, off));
    hi_y = fmaxf(hi_y, __shfl_xor_sync(kFull, hi_y, off));
  }
  if (lane == 0) {
    box[0][warp] = lo_x;
    box[1][warp] = lo_y;
    box[2][warp] = hi_x;
    box[3][warp] = hi_y;
  }
  for (int c = threadIdx.x; c < kCells; c += kBinThreads) cell[c] = 0;
  __syncthreads();
  if (warp == 0) {
    lo_x = box[0][lane];
    lo_y = box[1][lane];
    hi_x = box[2][lane];
    hi_y = box[3][lane];
    for (int off = 16; off; off >>= 1) {
      lo_x = fminf(lo_x, __shfl_xor_sync(kFull, lo_x, off));
      lo_y = fminf(lo_y, __shfl_xor_sync(kFull, lo_y, off));
      hi_x = fmaxf(hi_x, __shfl_xor_sync(kFull, hi_x, off));
      hi_y = fmaxf(hi_y, __shfl_xor_sync(kFull, hi_y, off));
    }
    if (lane == 0) grid_s = grid_params(lo_x, lo_y, hi_x, hi_y, r2);
  }
  __syncthreads();
  const float4 grid = grid_s;

#pragma unroll 4
  for (int i = threadIdx.x; i < ns; i += kBinThreads) {
    const bool valid = mb[i];
    const float x = sb[3 * i], y = sb[3 * i + 1];
    if (valid) atomicAdd(&cell[cell_of(x, y, grid)], 1);
  }
  __syncthreads();

  // Exclusive scan: warp w scans cells [w, w + 1) * kCellsPerWarp, 32 at a
  // time, then adds the exclusive sum of the warps before it.
  const int first = warp * kCellsPerWarp;
  int carry = 0;
  for (int c = first + lane; c < first + kCellsPerWarp; c += 32) {
    const int v = cell[c];
    int incl = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    cell[c] = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) warp_base[warp] = carry;
  __syncthreads();
  int* st = starts + (size_t)b * (kCells + 1);
  if (warp == 0) {
    const int v = warp_base[lane];
    int incl = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    warp_base[lane] = incl - v;
    if (lane == 31) st[kCells] = incl;
  }
  __syncthreads();
  const int base = warp_base[warp];
  for (int c = first + lane; c < first + kCellsPerWarp; c += 32) {
    const int v = cell[c] + base;
    cell[c] = v;                                     // the column's cursor
    st[c] = v;
  }
  __syncthreads();

  float4* out = sorted + (size_t)b * ns;
#pragma unroll 4
  for (int i = threadIdx.x; i < ns; i += kBinThreads) {
    const bool valid = mb[i];
    const float x = sb[3 * i], y = sb[3 * i + 1], z = sb[3 * i + 2];
    if (valid) {
      const int pos = atomicAdd(&cell[cell_of(x, y, grid)], 1);
      out[pos] = make_float4(x, y, z, __int_as_float(i));
    }
  }
  if (threadIdx.x == 0) params[b] = grid;
}

// The K best of one query in registers, sorted, with a compare-exchange
// pass over constant indices per hit (K <= MAXK <= kRegisterK); one thread
// a query.
template <int MAXK>
__global__ void __launch_bounds__(kSearchThreads)
    search_kernel(const float* __restrict__ q,
                  const uint8_t* __restrict__ q_mask,
                  const float4* __restrict__ sorted,
                  const float4* __restrict__ params,
                  const int* __restrict__ starts, long long n_queries,
                  int nq, int ns, int k, float r2,
                  int32_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_queries) return;
  int32_t* o = out + row * k;
  if (!q_mask[row]) {
    for (int i = 0; i < k; ++i) o[i] = ns;
    return;
  }
  const int b = (int)(row / nq);
  const float qx = q[row * 3 + 0], qy = q[row * 3 + 1], qz = q[row * 3 + 2];
  const float4 g = params[b];
  const int cx0 = column(__fsub_rn(qx, g.w), g.x, g.z);
  const int cx1 = column(__fadd_rn(qx, g.w), g.x, g.z);
  const int cy0 = column(__fsub_rn(qy, g.w), g.y, g.z);
  const int cy1 = column(__fadd_rn(qy, g.w), g.y, g.z);
  const int* st = starts + (size_t)b * (kCells + 1);
  const float4* sp = sorted + (size_t)b * ns;

  unsigned long long best[MAXK];
#pragma unroll
  for (int i = 0; i < MAXK; ++i) best[i] = kNoKey;

  for (int cy = cy0; cy <= cy1; ++cy) {
    const int lo = st[cy * kGridSide + cx0];
    const int hi = st[cy * kGridSide + cx1 + 1];
    for (int j0 = lo; j0 < hi; j0 += kBatch) {
      // kBatch independent loads in flight before the first test
      float4 batch[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j0 + u < hi) batch[u] = sp[j0 + u];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u >= hi) break;
        unsigned long long key = hit_key(batch[u], qx, qy, qz, r2);
        if (key < best[MAXK - 1]) {
#pragma unroll
          for (int i = 0; i < MAXK; ++i) {
            const unsigned long long lo_key = min(best[i], key);
            key = max(best[i], key);
            best[i] = lo_key;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MAXK; ++i)
    if (i < k)
      o[i] = best[i] == kNoKey ? ns : (int32_t)(unsigned)(best[i] & kFull);
}

// Sorts keys[0, n) ascending, n a power of two: a bitonic network run by
// the 32 lanes of a warp, n / 2 compare-exchanges a step, each lane's
// writes visible to the others at the next step.
__device__ void warp_sort(unsigned long long* keys, int n, int lane) {
  __syncwarp();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1));   // pair (i, i + stride)
        const unsigned long long a = keys[i], b = keys[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[i + stride] = a;
        }
      }
      __syncwarp();
    }
  }
}

// The K best of one query by a warp (K > kRegisterK): hits compacted into
// the warp's buffer of cap keys (a power of two >= K + 32), cut to the K
// smallest when a chunk would overflow it, sorted at the end.
__global__ void __launch_bounds__(kSearchThreads)
    warp_search_kernel(const float* __restrict__ q,
                       const uint8_t* __restrict__ q_mask,
                       const float4* __restrict__ sorted,
                       const float4* __restrict__ params,
                       const int* __restrict__ starts, long long n_queries,
                       int nq, int ns, int k, int cap, float r2,
                       int32_t* __restrict__ out) {
  extern __shared__ unsigned long long buffers[];    // [kSearchWarps][cap]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kSearchWarps + warp;
  if (row >= n_queries) return;                      // the whole warp
  int32_t* o = out + row * k;
  if (!q_mask[row]) {
    for (int i = lane; i < k; i += 32) o[i] = ns;
    return;
  }
  const int b = (int)(row / nq);
  const float qx = q[row * 3 + 0], qy = q[row * 3 + 1], qz = q[row * 3 + 2];
  const float4 g = params[b];
  const int cx0 = column(__fsub_rn(qx, g.w), g.x, g.z);
  const int cx1 = column(__fadd_rn(qx, g.w), g.x, g.z);
  const int cy0 = column(__fsub_rn(qy, g.w), g.y, g.z);
  const int cy1 = column(__fadd_rn(qy, g.w), g.y, g.z);
  const int* st = starts + (size_t)b * (kCells + 1);
  const float4* sp = sorted + (size_t)b * ns;
  unsigned long long* keys = buffers + (size_t)warp * cap;
  const unsigned below = (1u << lane) - 1u;          // the lanes before
  int count = 0;                     // keys in the buffer, warp-uniform
  unsigned long long limit = kNoKey;  // keys above it are not among the K

  for (int cy = cy0; cy <= cy1; ++cy) {
    const int lo = st[cy * kGridSide + cx0];
    const int hi = st[cy * kGridSide + cx1 + 1];
    for (int j0 = lo; j0 < hi; j0 += 32 * kWarpBatch) {
      float4 batch[kWarpBatch];
#pragma unroll
      for (int u = 0; u < kWarpBatch; ++u) {
        const int j = j0 + 32 * u + lane;
        if (j < hi) batch[u] = sp[j];
      }
#pragma unroll
      for (int u = 0; u < kWarpBatch; ++u) {
        const int j = j0 + 32 * u + lane;
        const unsigned long long key =
            j < hi ? hit_key(batch[u], qx, qy, qz, r2) : kNoKey;
        unsigned hits = __ballot_sync(kFull, key < limit);
        if (!hits) continue;
        if (count + __popc(hits) > cap) {
          // a full buffer: its K smallest stay, the K-th is the limit
          for (int i = count + lane; i < cap; i += 32) keys[i] = kNoKey;
          warp_sort(keys, cap, lane);
          limit = keys[k - 1];
          count = k;
          hits = __ballot_sync(kFull, key < limit);
        }
        if (key < limit) keys[count + __popc(hits & below)] = key;
        count += __popc(hits);
      }
    }
  }

  if (count > 1) {
    int n = 2;
    while (n < count) n <<= 1;
    for (int i = count + lane; i < n; i += 32) keys[i] = kNoKey;
    warp_sort(keys, n, lane);
  } else {
    __syncwarp();
  }
  for (int i = lane; i < k; i += 32)
    o[i] = i < count ? (int32_t)(unsigned)(keys[i] & kFull) : ns;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` once per device
// (the attribute then holds for the process), so that a launch makes no
// CUDA call for it; done[d] records device d.
template <typename Kernel>
int allow_shared_once(Kernel kernel, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <int MAXK>
int launch_search(const float* q, const uint8_t* qm, const float4* sorted,
                  const float4* params, const int* starts, long long n,
                  int nq, int ns, int k, float r2, int32_t* out,
                  cudaStream_t st) {
  if constexpr (MAXK == 0) {
    return (int)cudaErrorInvalidValue;   // no slots (kRegisterK = 0)
  } else {
    const unsigned blocks = (unsigned)((n + kSearchThreads - 1) /
                                       kSearchThreads);
    search_kernel<MAXK><<<blocks, kSearchThreads, 0, st>>>(
        q, qm, sorted, params, starts, n, nq, ns, k, r2, out);
    return (int)cudaGetLastError();
  }
}

int launch_warp_search(const float* q, const uint8_t* qm,
                       const float4* sorted, const float4* params,
                       const int* starts, long long n, int nq, int ns, int k,
                       float r2, int32_t* out, cudaStream_t st) {
  int cap = 64;
  while (cap < k + 32) cap <<= 1;
  const unsigned blocks = (unsigned)((n + kSearchWarps - 1) / kSearchWarps);
  warp_search_kernel<<<blocks, kSearchThreads,
                       kSearchWarps * cap * sizeof(unsigned long long), st>>>(
      q, qm, sorted, params, starts, n, nq, ns, k, cap, r2, out);
  return (int)cudaGetLastError();
}

long long sorted_words(int b, int ns) { return 4LL * b * ns; }

}  // namespace

// 4-byte words of scratch that radius_search_launch needs: the
// column-ordered supports [B, Ns] float4, the grid parameters [B] float4,
// the column starts [B, kGridSide^2 + 1] int32.
extern "C" long long radius_search_scratch_words(int b, int ns) {
  if (b < 0 || ns < 0) return -1;
  return sorted_words(b, ns) + 4LL * b + (long long)b * (kCells + 1);
}

// q [B, Nq, 3] f32, s [B, Ns, 3] f32, q_mask [B, Nq] u8, s_mask [B, Ns] u8,
// out [B, Nq, K] i32, all contiguous; scratch of scratch_words 4-byte
// words, 16-byte aligned, at least radius_search_scratch_words(B, Ns).
// Returns cudaGetLastError() after the two launches,
// cudaErrorInvalidValue for a K outside 1..768 or a scratch too short or
// misaligned.
extern "C" int radius_search_launch(const float* q, const float* s,
                                    const uint8_t* q_mask,
                                    const uint8_t* s_mask, int b, int nq,
                                    int ns, int k, float r2, int32_t* out,
                                    void* scratch, long long scratch_words,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || b < 1 || nq < 0 || ns < 0)
    return (int)cudaErrorInvalidValue;
  if (scratch_words < radius_search_scratch_words(b, ns) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)b * nq;
  if (n == 0) return 0;
  float4* sorted = static_cast<float4*>(scratch);
  float4* params = sorted + (size_t)b * ns;
  int* starts = reinterpret_cast<int*>(params + b);

  const int smem = kCells * (int)sizeof(int);
  static std::atomic<bool> done[kMaxDevices];
  int err = allow_shared_once(bin_supports_kernel, smem, done);
  if (err) return err;
  bin_supports_kernel<<<b, kBinThreads, smem, st>>>(s, s_mask, ns, r2,
                                                    sorted, params, starts);
  err = (int)cudaGetLastError();
  if (err) return err;

  if (k <= 4)
    return launch_search<4>(q, q_mask, sorted, params, starts, n, nq, ns, k,
                            r2, out, st);
  if (k <= kRegisterK)
    return launch_search<kRegisterK>(q, q_mask, sorted, params, starts, n,
                                     nq, ns, k, r2, out, st);
  return launch_warp_search(q, q_mask, sorted, params, starts, n, nq, ns, k,
                            r2, out, st);
}
