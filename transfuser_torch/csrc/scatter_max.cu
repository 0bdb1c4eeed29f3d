// Per-segment max of float32 rows (the PointPillars pillar pooling), for
// Hopper.
//
// Replaces the Pallas TPU kernel experiments/pallas_scatter_max.py
// (`kernel`, launched by `pallas_scatter_max`), and with it the XLA
// scatter-max that transfuser_tpu/ops/pillars.py:segment_max lowers to.
// Same result: out[s, c] = max of vals[p, c] over the points p with
// ids[p] == s, starting from NEG_INF = -1e30; every entry still
// <= NEG_INF / 2 afterwards (a segment no point reached, or only points
// that carry NEG_INF) becomes 0.
//
// Why the TPU design does not carry over: the Pallas kernel sorts the
// points by cell, tiles the canvas through VMEM and does a serial
// read-modify-write per point, because a TPU has no cheap random-access
// update; it came out slower than XLA's scatter there. Hopper has
// hardware atomics in L2 and 132 SMs, so no sort is needed: the canvas
// (8.4 MB per sample at 65,537 cells x 32 channels) is updated in place.
//
// Design: three launches on the caller's stream.
//   1. fill: out = NEG_INF.
//   2. scatter: one thread per (point, channel); a warp covers one
//      point's 32 channels, so the value reads are coalesced and the id
//      read is one broadcast. A thread first reads the current entry and
//      does the atomic only if its value is larger: entries only grow,
//      so a value that is not above what the read sees is not above the
//      final max either, and skipping it cannot change the result. The
//      padded points carry NEG_INF and so never reach the atomic.
//      Float atomic max by sign: a float with the sign bit clear orders
//      like its int bit pattern (atomicMax on int); one with the sign bit
//      set orders reversed as unsigned (atomicMin on unsigned). Each
//      leaves entries of the other sign correctly ordered.
//   3. epilogue: entries <= NEG_INF / 2 become 0.
// Max is order-free, so the result does not depend on the order the
// atomics land in: it equals a sequential max bit for bit (up to the
// sign of a zero that ties with a zero).
//
// Bound on the card: bytes. A call reads N * (C + 1) * 4 bytes of values
// and ids and writes S * C * 4 bytes of canvas: at the pillar shape
// (40,000 points, C = 32, 65,537 cells per sample) about 13.5 MB per
// sample, 4 us at 3.35 TB/s. This version moves the canvas three times
// (fill, atomics, epilogue): simple first, fused later.
//
// Ids outside [0, S) are dropped, as XLA drops out-of-range scatter
// updates.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

int grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  // grid-stride loops below; 64 blocks per SM keeps all 132 SMs busy
  return (int)(blocks < 132 * 64 ? (blocks > 0 ? blocks : 1) : 132 * 64);
}

__global__ void __launch_bounds__(kThreads)
    fill_neg(float* __restrict__ out, long long total) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads)
    out[i] = kNegInf;
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!signbit(v))
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void __launch_bounds__(kThreads)
    scatter_max(const float* __restrict__ vals, const int* __restrict__ ids,
                float* out, long long n, int c, long long segments) {
  const long long total = n * c;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const long long p = i / c;
    const int ch = (int)(i - p * c);
    const int s = ids[p];
    if (s < 0 || s >= segments) continue;
    const float v = vals[i];
    float* dst = out + (long long)s * c + ch;
    if (v > *dst) atomic_max_float(dst, v);
  }
}

__global__ void __launch_bounds__(kThreads)
    zero_empty(float* __restrict__ out, long long total) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    if (out[i] <= kNegInf * 0.5f) out[i] = 0.f;
  }
}

}  // namespace

extern "C" {

// vals (n, c) float32 and ids (n,) int32, both contiguous; out (segments,
// c) float32, contiguous, written whole. Returns a cudaError_t (0 =
// launched).
int tf_scatter_max_forward(const float* vals, const int* ids, float* out,
                           long long n, int c, long long segments,
                           void* stream) {
  if (n < 0 || c < 1 || segments < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long canvas = segments * c;
  fill_neg<<<grid_for(canvas), kThreads, 0, s>>>(out, canvas);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    scatter_max<<<grid_for(n * c), kThreads, 0, s>>>(vals, ids, out, n, c,
                                                     segments);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  zero_empty<<<grid_for(canvas), kThreads, 0, s>>>(out, canvas);
  return (int)cudaGetLastError();
}

}  // extern "C"
