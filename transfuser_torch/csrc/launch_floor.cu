// An empty kernel, built and loaded like the port's kernels. Its device
// time is the floor under any launch on the card: the time a kernel whose
// bound is far below a microsecond cannot get under. chip_smoke.py
// measures it; nothing on the main path calls it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).
int tf_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
