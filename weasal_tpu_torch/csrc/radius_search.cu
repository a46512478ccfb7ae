// Exact fixed-width radius search over a batch of padded spheres.
//
// Replaces the Pallas TPU kernel weasal_tpu/ops/pallas/radius_pallas.py
// (`_search_kernel` behind `radius_search_banded`). For every valid query
// it returns up to K valid supports of the same sphere with d2 <= r2,
// sorted by distance, ties to the lowest support index, missing slots = Ns;
// an invalid query gets an all-Ns row.
//
// What bounds it on the H100: the pairwise distance work, Nq x Ns x 8 f32
// operations per sphere (memory traffic is only the two point sets and
// the K-wide output). The TPU kernel fetched a window of supports around
// each query tile to avoid gathers; on Hopper the whole support set of a
// sphere streams through shared memory in tiles, so the search is exact
// without windows or a calibrated band. Design: one thread per query, a
// block of 128 queries of one sphere; supports are staged 256 at a time in
// shared memory in ascending index order; each thread keeps a sorted K-best
// list (distance, index) in local memory and inserts only on a strict `<`
// against larger entries, so equal distances keep the lower index, which
// is the order of a stable sort.
//
// d2 is summed per axis, x then y then z, from 0, with round-to-nearest
// intrinsics: no fused multiply-add may change which points lie on the
// sphere's boundary, so the result equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;

template <int MAXK>
__global__ void radius_search_kernel(const float* __restrict__ q,
                                     const float* __restrict__ s,
                                     const uint8_t* __restrict__ q_mask,
                                     const uint8_t* __restrict__ s_mask,
                                     int nq, int ns, int k, float r2,
                                     int32_t* __restrict__ out) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  __shared__ uint8_t sv[kTile];

  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t qrow = (size_t)b * nq + qi;
  const bool active = qi < nq && q_mask[qrow];
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[qrow * 3 + 0];
    qy = q[qrow * 3 + 1];
    qz = q[qrow * 3 + 2];
  }

  float best_d[MAXK];
  int best_i[MAXK];
  int count = 0;

  for (int t0 = 0; t0 < ns; t0 += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
      const int sj = t0 + j;
      if (sj < ns) {
        const size_t srow = (size_t)b * ns + sj;
        sx[j] = s[srow * 3 + 0];
        sy[j] = s[srow * 3 + 1];
        sz[j] = s[srow * 3 + 2];
        sv[j] = s_mask[srow];
      } else {
        sv[j] = 0;
      }
    }
    __syncthreads();
    if (!active) continue;
    const int lim = min(kTile, ns - t0);
    for (int j = 0; j < lim; ++j) {
      if (!sv[j]) continue;
      const float dx = __fsub_rn(qx, sx[j]);
      const float dy = __fsub_rn(qy, sy[j]);
      const float dz = __fsub_rn(qz, sz[j]);
      float d2 = __fmul_rn(dx, dx);
      d2 = __fadd_rn(d2, __fmul_rn(dy, dy));
      d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
      if (d2 > r2) continue;
      if (count == k && !(d2 < best_d[k - 1])) continue;
      int pos = count < k ? count : k - 1;
      while (pos > 0 && best_d[pos - 1] > d2) {
        best_d[pos] = best_d[pos - 1];
        best_i[pos] = best_i[pos - 1];
        --pos;
      }
      best_d[pos] = d2;
      best_i[pos] = t0 + j;
      if (count < k) ++count;
    }
  }

  if (qi < nq) {
    int32_t* o = out + qrow * k;
    for (int i = 0; i < k; ++i) o[i] = (active && i < count) ? best_i[i] : ns;
  }
}

template <int MAXK>
void launch(const float* q, const float* s, const uint8_t* qm,
            const uint8_t* sm, int b, int nq, int ns, int k, float r2,
            int32_t* out, cudaStream_t stream) {
  dim3 grid((nq + kThreads - 1) / kThreads, b);
  radius_search_kernel<MAXK><<<grid, kThreads, 0, stream>>>(
      q, s, qm, sm, nq, ns, k, r2, out);
}

}  // namespace

// q [B, Nq, 3] f32, s [B, Ns, 3] f32, q_mask [B, Nq] u8, s_mask [B, Ns] u8,
// out [B, Nq, K] i32; all contiguous. Returns cudaGetLastError().
extern "C" int radius_search_launch(const float* q, const float* s,
                                    const uint8_t* q_mask,
                                    const uint8_t* s_mask, int b, int nq,
                                    int ns, int k, float r2, int32_t* out,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  if (k <= 32) {
    launch<32>(q, s, q_mask, s_mask, b, nq, ns, k, r2, out, st);
  } else if (k <= 64) {
    launch<64>(q, s, q_mask, s_mask, b, nq, ns, k, r2, out, st);
  } else if (k <= 128) {
    launch<128>(q, s, q_mask, s_mask, b, nq, ns, k, r2, out, st);
  } else if (k <= 256) {
    launch<256>(q, s, q_mask, s_mask, b, nq, ns, k, r2, out, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
