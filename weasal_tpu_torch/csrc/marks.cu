// Marks on the device's clock: empty kernels whose names bracket a span
// of the stream's work in a device trace, a CUDA graph's replay included
// (ops/cuda/marks.py). Each does nothing; its launch is the mark.

#include <cuda_runtime.h>

extern "C" __global__ void deform_fwd_begin() {}
extern "C" __global__ void deform_fwd_end() {}
extern "C" __global__ void deform_bwd_begin() {}
extern "C" __global__ void deform_bwd_end() {}

// Launches mark `which` (0-3, in the order above) on `stream`, one block
// of one thread. Returns cudaGetLastError() after it, or
// cudaErrorInvalidValue for another `which`.
extern "C" int mark_launch(int which, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: deform_fwd_begin<<<1, 1, 0, st>>>(); break;
    case 1: deform_fwd_end<<<1, 1, 0, st>>>(); break;
    case 2: deform_bwd_begin<<<1, 1, 0, st>>>(); break;
    case 3: deform_bwd_end<<<1, 1, 0, st>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
