// Neighborhood max-pool backward: the VJP of out[q, c] = max_k xs[q, k, c]
// with xs[q, k, c] = x[nb[q, k], c] for a support and 0.0 for a shadow
// slot (nb >= Ns).
//
// Replaces the Pallas TPU kernel weasal_tpu/ops/pallas/maxpool_banded.py
// (`_bwd_kernel` behind `maxpool_bwd_banded`, the custom VJP of
// `max_pool_banded`), whose semantics are jnp.max's VJP:
//
//   dX[nb[q, k], c] += g[q, c] / ties[q, c]   for every slot k with
//                                              xs[q, k, c] == out[q, c]
//
// Ties split the gradient equally. A shadow slot takes part with 0.0: where
// the maximum is 0.0 the shadow slots count among the ties and their
// shares are dropped.
//
// The TPU kernel consumed a winner mask [B, Nq, K, C] that the forward
// built, and turned the scatter into membership matrix products over a
// window of sorted supports. Here one block per query row recomputes the
// maximum and the tie count per channel from x and nb, so the mask is
// never built, and adds each share into dX with an f32 atomic; the
// neighbor list is exact, so there is no window.
//
// What bounds it on the H100: memory. It reads x at the neighbor rows
// (cached: the K rows of one query are read twice, once for the maximum
// and once for the winners), nb and g, and writes dX; the arithmetic is a
// few compares per gathered value. f32 only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void maxpool_bwd_kernel(const float* __restrict__ x,
                                   const int32_t* __restrict__ nb,
                                   const float* __restrict__ g, int nq,
                                   int ns, int k, int c_dim,
                                   float* __restrict__ dx) {
  extern __shared__ int nbs[];                       // [k]
  const size_t row = blockIdx.x;                     // b * nq + qi
  const int b = (int)(row / nq);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int n = nb[row * k + j];
    nbs[j] = (n >= 0 && n < ns) ? n : -1;
  }
  __syncthreads();

  const float* xb = x + (size_t)b * ns * c_dim;
  float* dxb = dx + (size_t)b * ns * c_dim;
  for (int c = threadIdx.x; c < c_dim; c += blockDim.x) {
    const float gv = g[row * c_dim + c];
    if (gv == 0.f) continue;
    float m = -INFINITY;
    int ties = 0;
    for (int j = 0; j < k; ++j) {
      const int n = nbs[j];
      const float v = n >= 0 ? xb[(size_t)n * c_dim + c] : 0.f;
      if (v > m) {
        m = v;
        ties = 1;
      } else if (v == m) {
        ++ties;
      }
    }
    const float share = __fdiv_rn(gv, (float)ties);
    for (int j = 0; j < k; ++j) {
      const int n = nbs[j];
      if (n >= 0 && xb[(size_t)n * c_dim + c] == m)
        atomicAdd(dxb + (size_t)n * c_dim + c, share);
    }
  }
}

}  // namespace

// x [B,Ns,C], nb [B,Nq,K] i32, g [B,Nq,C]; output dx [B,Ns,C]; f32,
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int maxpool_bwd_launch(const float* x, const int32_t* nb,
                                  const float* g, int b, int nq, int ns,
                                  int k, int c_dim, float* dx,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || c_dim < 1 || (size_t)k * sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(dx, 0, (size_t)b * ns * c_dim *
                                            sizeof(float), st);
  if (err) return err;
  const long long rows = (long long)b * nq;
  if (rows == 0) return 0;
  int threads = ((c_dim + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  maxpool_bwd_kernel<<<(unsigned)rows, threads, k * sizeof(int), st>>>(
      x, nb, g, nq, ns, k, c_dim, dx);
  return (int)cudaGetLastError();
}
