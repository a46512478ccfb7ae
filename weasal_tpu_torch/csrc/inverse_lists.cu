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
// on the H100: bytes (indices and rows read once, rows written once).

#include <cuda_runtime.h>
#include <stdint.h>

#include "inverse_lists.cuh"

// Scratch ints that a build of b * nq * k slots over b * ns supports takes.
extern "C" long long inverse_lists_build_scratch_words(long long segs,
                                                       long long slots) {
  return inverse_lists::build_scratch_words(segs, slots);
}

// nb [B, Nq, ld] i32 (columns 0..k-1 used; an index outside 0..Ns-1 is a
// shadow); scratch of scratch_words i32 (at least
// inverse_lists_build_scratch_words); outputs off [B*Ns+1] and ent
// [B*Nq*k] i32 (the first off[B*Ns] entries hold the lists). Returns
// cudaGetLastError() after the last launch.
extern "C" int inverse_lists_build_launch(const int32_t* nb, int b, int nq,
                                          int k, int ld, int ns,
                                          int32_t* scratch,
                                          long long scratch_words,
                                          int32_t* off, int32_t* ent,
                                          void* stream) {
  if (b < 0 || nq < 0 || k < 1 || ld < k || ns < 0)
    return (int)cudaErrorInvalidValue;
  return inverse_lists::build(nb, b, nq, k, ld, ns, scratch, scratch_words,
                              off, ent, static_cast<cudaStream_t>(stream));
}

// dst [rows, C] = for each row r the sum over e in [off[r], off[r + 1])
// of src[ent[e], :] in ascending e order; f32, contiguous.
extern "C" int inverse_sum_launch(const int32_t* off, const int32_t* ent,
                                  const float* src, long long rows,
                                  int c_dim, float* dst, void* stream) {
  if (rows < 0 || c_dim < 1) return (int)cudaErrorInvalidValue;
  return inverse_lists::launch_inverse_sum<inverse_lists::SumKind::kLists>(
      off, ent, src, rows, c_dim, dst, static_cast<cudaStream_t>(stream));
}

// The runs of equal values of each row of a non-decreasing seg [B, N]
// i64 (values >= n_out dropped): sums [B * n_out, C] = each run j's rows
// of src [B * N, C] summed in row order from 0.0, counts [B * n_out] its
// length (0.0 where j is absent); f32, contiguous.
extern "C" int run_sums_launch(const int64_t* seg, int b, int n, int n_out,
                               const float* src, int c_dim, float* sums,
                               float* counts, void* stream) {
  if (b < 0 || n < 0 || n_out < 0 || c_dim < 1 ||
      (long long)b * n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  inverse_lists::SumArgs a{};
  a.seg = seg;
  a.n = n;
  a.n_out = n_out;
  a.src = src;
  a.rows = (long long)b * n_out;
  a.c_dim = c_dim;
  a.dst = sums;
  a.counts = counts;
  return inverse_lists::launch_row_sums<inverse_lists::SumKind::kRuns>(
      a, static_cast<cudaStream_t>(stream));
}
