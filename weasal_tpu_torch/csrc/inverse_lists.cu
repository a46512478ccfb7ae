// Inverse neighbor lists and fixed-order row sums (inverse_lists.cuh),
// behind a plain C interface: the build, shared by the dX of kernels C and
// D among the convs and pools of one pyramid edge, and the row sums that
// take the place of the scatter-adds on the training path: the backward
// of the row gathers (nearest upsampling, the region loss's member
// gather) and the voxel sums of the pyramid's grid subsample.
//
// The JAX package sums these in a fixed order too: XLA's segment sums and
// scatter-adds on one TPU core, and the membership products of its Pallas
// kernels (weasal_tpu/ops/pallas/kpconv_banded.py:20-29). What bounds them
// on the H100: bytes (indices and rows read once, rows written once); the
// build's insertion sort touches each entry a few times in its segment.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inverse_lists.cuh"

// nb [B, Nq, ld] i32 (columns 0..k-1 used; an index outside 0..Ns-1 is a
// shadow); scratch count [B*Ns] i32; outputs off [B*Ns+1] and ent
// [B*Nq*k] i32 (the first off[B*Ns] entries hold the lists). Returns
// cudaGetLastError() after the last launch.
extern "C" int inverse_lists_build_launch(const int32_t* nb, int b, int nq,
                                          int k, int ld, int ns,
                                          int32_t* count, int32_t* off,
                                          int32_t* ent, void* stream) {
  if (b < 0 || nq < 0 || k < 1 || ld < k || ns < 0)
    return (int)cudaErrorInvalidValue;
  return inverse_lists::build(nb, b, nq, k, ld, ns, count, off, ent,
                              static_cast<cudaStream_t>(stream));
}

// dst [rows, C] = for each row r the sum over e in [lo[r], hi[r]) of
// src[ent ? ent[e] : e, :] in ascending e order; f32, contiguous.
extern "C" int inverse_sum_launch(const int32_t* lo, const int32_t* hi,
                                  const int32_t* ent, const float* src,
                                  long long rows, int c_dim, float* dst,
                                  void* stream) {
  if (rows < 0 || c_dim < 1) return (int)cudaErrorInvalidValue;
  return inverse_lists::launch_inverse_sum(
      lo, hi, ent, src, rows, c_dim, dst, static_cast<cudaStream_t>(stream));
}
