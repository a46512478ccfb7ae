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
// 2. search_kernel, one thread per query over all B * Nq queries (the
//    queries arrive in voxel order, so a warp visits the same columns):
//    for each of the rows col(yq - reach) .. col(yq + reach) it scans the
//    contiguous range of columns col(xq - reach) .. col(xq + reach), tests
//    d2 exactly as the plain version does (per axis, on the original
//    coordinates, the copy holding bit copies, with round-to-nearest
//    intrinsics so that no fused multiply-add moves a point across the
//    boundary), with kBatch candidate loads in flight, and ranks the hits
//    under the total order (d2, original index) as 64-bit keys
//    (d2 bits << 32 | index; monotone because d2 >= 0). Up to K = 16 the
//    K best stay sorted in registers, 4 or 16 slots of them, with a
//    compare-exchange pass over constant indices per hit. Above it a hit
//    is appended to the query's own list in shared memory (column
//    threadIdx.x of a [K + kSpare][threads] array); a full list is cut to
//    its K smallest, and keys above the K-th are then refused; at the end
//    each listed key's rank in the list is its slot in the output row.
//    The split was measured on the main path's edges (H100,
//    weasal_tpu_torch/tools/kernel_variants.py): a warp pays a whole
//    register pass on every candidate step where any lane hits, which
//    made K = 29-34 (125-242 candidates per query) 1.1-1.7x slower than
//    the lists; the lists' quadratic cut and rank made K = 1 (20-27 hits
//    per query) 3.3-7.5x slower than registers; at K = 1, 4 register
//    slots take 0.54-0.6x the time of 16. Candidates arrive in no fixed
//    order, and the scatter's order within a column varies from run to
//    run, but the order is total, so the output is deterministic.
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
constexpr int kSearchThreads = 128;
constexpr int kBatch = 4;          // candidate loads a thread keeps in flight
constexpr int kRegisterK = 16;     // largest K kept in registers
constexpr int kSpare = 32;         // list room beyond K before a cut to K
// A search block's lists: its thread count halves until they fit in
// kListBytes, down to one warp, whose lists at kMaxK take kMaxListBytes
// (the deformable layers' wide searches: K of several hundred)
constexpr int kListBytes = 96 * 1024;
constexpr int kMaxK = 768;
constexpr int kMaxListBytes = 32 * (kMaxK + kSpare) * 8;   // 200 KB
static_assert(kMaxListBytes <= 227 * 1024, "over the H100's block limit");
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

// The K smallest of a thread's n listed keys: the key of rank K - 1 (keys
// are distinct), after which the list keeps only the keys up to it, in
// place. list[i * stride] is the thread's i-th key.
__device__ unsigned long long keep_k_smallest(unsigned long long* list,
                                              int stride, int n, int k) {
  unsigned long long kth = kNoKey;
  for (int i = 0; i < n; ++i) {
    const unsigned long long key = list[i * stride];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += list[j * stride] < key;
    if (rank == k - 1) kth = key;
  }
  int w = 0;
  for (int i = 0; i < n; ++i) {
    const unsigned long long key = list[i * stride];
    if (key <= kth) list[w++ * stride] = key;
  }
  return kth;
}

// MAXK > 0: the K best in registers, sorted, with a compare-exchange pass
// over constant indices per hit (K <= MAXK <= kRegisterK). MAXK = 0: each
// query's hits in its own column of a shared-memory list
// [cap = K + kSpare][threads], ranked at the end.
template <int MAXK>
__global__ void __launch_bounds__(kSearchThreads)
    search_kernel(const float* __restrict__ q,
                  const uint8_t* __restrict__ q_mask,
                  const float4* __restrict__ sorted,
                  const float4* __restrict__ params,
                  const int* __restrict__ starts, long long n_queries,
                  int nq, int ns, int k, int cap, float r2,
                  int32_t* __restrict__ out) {
  extern __shared__ unsigned long long lists[];
  const int stride = blockDim.x;
  const long long row = (long long)blockIdx.x * stride + threadIdx.x;
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

  unsigned long long best[MAXK > 0 ? MAXK : 1];
#pragma unroll
  for (int i = 0; i < (MAXK > 0 ? MAXK : 1); ++i) best[i] = kNoKey;
  unsigned long long* list = lists + threadIdx.x;    // this query's column
  int count = 0;
  unsigned long long limit = kNoKey;  // keys above it are not among the K

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
        const float4 p = batch[u];
        const float dx = __fsub_rn(qx, p.x);
        const float dy = __fsub_rn(qy, p.y);
        const float dz = __fsub_rn(qz, p.z);
        float d2 = __fmul_rn(dx, dx);
        d2 = __fadd_rn(d2, __fmul_rn(dy, dy));
        d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
        if (!(d2 <= r2)) continue;
        unsigned long long key =
            ((unsigned long long)__float_as_uint(d2) << 32) |
            (unsigned)__float_as_int(p.w);
        if constexpr (MAXK > 0) {
          if (key < best[MAXK - 1]) {
#pragma unroll
            for (int i = 0; i < MAXK; ++i) {
              const unsigned long long lo_key = min(best[i], key);
              key = max(best[i], key);
              best[i] = lo_key;
            }
          }
        } else {
          if (key > limit) continue;
          if (count == cap) {
            limit = keep_k_smallest(list, stride, count, k);
            count = k;
            if (key > limit) continue;
          }
          list[count++ * stride] = key;
        }
      }
    }
  }

  if constexpr (MAXK > 0) {
#pragma unroll
    for (int i = 0; i < MAXK; ++i)
      if (i < k)
        o[i] = best[i] == kNoKey ? ns : (int32_t)(unsigned)(best[i] & kFull);
  } else {
    // Each listed key's rank among the list is its slot in the row
    for (int i = 0; i < count; ++i) {
      const unsigned long long key = list[i * stride];
      int rank = 0;
      for (int j = 0; j < count; ++j) rank += list[j * stride] < key;
      if (rank < k) o[rank] = (int32_t)(unsigned)(key & kFull);
    }
    for (int i = count; i < k; ++i) o[i] = ns;
  }
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
  const int cap = k + kSpare;
  int threads = kSearchThreads;
  while (MAXK == 0 && threads > 32 &&
         (size_t)threads * cap * 8 > kListBytes)
    threads >>= 1;
  const int list_bytes = MAXK > 0 ? 0 : threads * cap * 8;
  if constexpr (MAXK == 0) {
    // the lists of any K take at most kMaxListBytes
    static std::atomic<bool> done[kMaxDevices];
    const int err =
        allow_shared_once(search_kernel<MAXK>, kMaxListBytes, done);
    if (err) return err;
  }
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  search_kernel<MAXK><<<blocks, threads, list_bytes, st>>>(
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
  return launch_search<0>(q, q_mask, sorted, params, starts, n, nq, ns, k,
                          r2, out, st);
}
