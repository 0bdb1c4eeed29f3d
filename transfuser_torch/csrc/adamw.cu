// AdamW's update of fp32 parameters and moments in one pass, for Hopper.
//
// Replaces no Pallas kernel: the JAX package's update is optax's adamw,
// which XLA fuses on its own. It was added because the port's plain
// update (train/train_state.py `plain_update`, 16 torch._foreach_ passes)
// reads 84 and writes 64 bytes per element, 24.9 GB a step over the
// flagship's 168,018,327 trainable elements (924 tensors), where the
// update needs 28: p, g, mu and nu read once, p, mu and nu written once.
//
// Arithmetic, per element, in fp32 and in the plain passes' order:
//   mu = b1 mu + (1 - b1) g
//   nu = b2 nu + (1 - b2) (g g)
//   u  = (mu / bc1) / (sqrt(nu / bc2) + eps)  [+ wd p where wd != 0]
//   p  = p - lr u
// with lr, bc1 = 1 - b1^t and bc2 = 1 - b2^t read from the optimizer's
// device tensor of scalars (AdamW.advance writes it before each update),
// so a captured graph follows the schedule; b1, 1 - b1, b2, 1 - b2, eps
// and wd are the Python floats rounded to fp32, as PyTorch's _foreach
// kernels round a scalar to their fp32 math type. Every operation rounds
// on its own (the __f*_rn intrinsics: nvcc contracts none of them into an
// FMA), and PyTorch's _foreach kernels also round each operation on its
// own: a scalar or a 0-dim tensor operand enters as the same fp32 value,
// and division and square root are IEEE-rounded (div.rn, sqrt.rn). So the
// result equals the plain passes bit for bit.
//
// What bounds it on this card: bytes. An update does about 12 operations
// per 28 bytes, some 700 times below the bf16 ridge of 295 per byte; the
// flagship's 4.70 GB take 1.40 ms at 3.35 TB/s. On an H100 80GB HBM3 it
// takes 1.67 ms (2.82 TB/s, 84% of that bound; a plain device-to-device
// copy reaches 2.98 TB/s there), where the 16 passes took 11.2 ms.
// Chunks of 1K-8K elements, 128-512 threads, one contiguous run of chunks
// per block, streaming cache hints and a grid twice the resident blocks
// all measured 1.67-1.74 ms.
//
// Design: the tensors' pointers and sizes travel in the kernel's
// parameter space (up to 32,764 bytes on sm_90 with CUDA 12.1 or later),
// as PyTorch's multi_tensor_apply passes its lists, so a launch reads no
// table from device memory and a CUDA graph keeps the addresses in its
// node: nothing is copied to the card. kMaxTensors tensors fit one launch
// (the caller, train_state.py `launch_plan`, splits a longer list). Each
// tensor is cut into chunks of kChunk elements, numbered across the
// launch (`chunk_start`: the first chunk of each tensor, and the total);
// a persistent grid of as many blocks as the card keeps resident walks
// the chunks with a block stride, so tensors of 1 to 9M elements spread
// evenly over the 132 SMs, and a block finds its chunk's tensor by a
// binary search in the parameter space. A thread issues the 16-byte
// loads of its kVec groups of 4 elements from all four arrays before it
// computes any; a chunk whose four pointers are not all 16-byte aligned,
// and the last len % 4 elements of a tensor, take 4-byte accesses.
// Moments and master weights stay fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // elements of one tensor a block takes at once
constexpr int kVec = kChunk / 4 / kThreads;  // 16-byte groups per thread
constexpr int kMaxTensors = 800;             // tensors of one launch
constexpr int kMaxParamBytes = 32764;        // sm_90's parameter space

struct AdamWArgs {
  const float* scalars;  // lr, 1 - b1^t, 1 - b2^t
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
  int count;
  int chunk_start[kMaxTensors + 1];
  int numel[kMaxTensors];
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
};
static_assert(sizeof(AdamWArgs) <= kMaxParamBytes,
              "the launch's tensors must fit the parameter space");

struct Step {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, lr, bc1, bc2;

  __device__ __forceinline__ void operator()(float& p, float g, float& m,
                                             float& v) const {
    m = __fadd_rn(__fmul_rn(m, b1), __fmul_rn(g, one_minus_b1));
    v = __fadd_rn(__fmul_rn(v, b2), __fmul_rn(__fmul_rn(g, g), one_minus_b2));
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps);
    float u = __fdiv_rn(__fdiv_rn(m, bc1), denom);
    if (weight_decay != 0.f) u = __fadd_rn(u, __fmul_rn(p, weight_decay));
    p = __fsub_rn(p, __fmul_rn(u, lr));
  }

  __device__ __forceinline__ void operator()(float4& p, const float4& g,
                                             float4& m, float4& v) const {
    (*this)(p.x, g.x, m.x, v.x);
    (*this)(p.y, g.y, m.y, v.y);
    (*this)(p.z, g.z, m.z, v.z);
    (*this)(p.w, g.w, m.w, v.w);
  }
};

// the tensor that holds chunk c: the last t with chunk_start[t] <= c (a
// tensor of 0 elements has no chunk and is never found)
__device__ __forceinline__ int tensor_of(const AdamWArgs& a, int c) {
  int lo = 0, hi = a.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.chunk_start[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
tf_adamw_step(const __grid_constant__ AdamWArgs a) {
  const Step step{a.b1, a.one_minus_b1, a.b2, a.one_minus_b2, a.eps,
                  a.weight_decay, a.scalars[0], a.scalars[1], a.scalars[2]};
  const int chunks = a.chunk_start[a.count];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int t = tensor_of(a, c);
    const long long off = (long long)(c - a.chunk_start[t]) * kChunk;
    const int len = (int)min((long long)kChunk, a.numel[t] - off);
    float* p = a.p[t] + off;
    const float* g = a.g[t] + off;
    float* m = a.m[t] + off;
    float* v = a.v[t] + off;
    int done = 0;
    if (((uintptr_t)p | (uintptr_t)g | (uintptr_t)m | (uintptr_t)v) % 16 ==
        0) {
      const int n4 = len >> 2;
      float4 pv[kVec], gv[kVec], mv[kVec], vv[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < n4) {
          pv[k] = reinterpret_cast<const float4*>(p)[i];
          gv[k] = __ldg(reinterpret_cast<const float4*>(g) + i);
          mv[k] = reinterpret_cast<const float4*>(m)[i];
          vv[k] = reinterpret_cast<const float4*>(v)[i];
        }
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < n4) {
          step(pv[k], gv[k], mv[k], vv[k]);
          reinterpret_cast<float4*>(p)[i] = pv[k];
          reinterpret_cast<float4*>(m)[i] = mv[k];
          reinterpret_cast<float4*>(v)[i] = vv[k];
        }
      }
      done = n4 * 4;
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads) {
      float pi = p[i], mi = m[i], vi = v[i];
      step(pi, __ldg(g + i), mi, vi);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
  }
}

// blocks the card keeps resident at once, per device (found once)
int resident_blocks() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tf_adamw_step,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 0;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

extern "C" {

// One launch over `count` tensors: `ptrs` holds p, g, mu and nu of each
// tensor in turn (4 * count addresses), `numel` their sizes and
// `chunk_start` (count + 1 entries) the first chunk of each and the
// total. Returns a cudaError_t (0 = launched).
int tf_adamw_step_launch(int count, const unsigned long long* ptrs,
                         const int* numel, const int* chunk_start,
                         const float* scalars, float b1, float one_minus_b1,
                         float b2, float one_minus_b2, float eps,
                         float weight_decay, void* stream) {
  if (count < 1 || count > kMaxTensors || chunk_start[count] < 1)
    return (int)cudaErrorInvalidValue;
  const int resident = resident_blocks();
  if (resident < 1) return (int)cudaErrorInvalidDevice;
  AdamWArgs a;
  a.scalars = scalars;
  a.b1 = b1;
  a.one_minus_b1 = one_minus_b1;
  a.b2 = b2;
  a.one_minus_b2 = one_minus_b2;
  a.eps = eps;
  a.weight_decay = weight_decay;
  a.count = count;
  for (int t = 0; t < count; ++t) {
    a.chunk_start[t] = chunk_start[t];
    a.numel[t] = numel[t];
    a.p[t] = reinterpret_cast<float*>(ptrs[4 * t]);
    a.g[t] = reinterpret_cast<const float*>(ptrs[4 * t + 1]);
    a.m[t] = reinterpret_cast<float*>(ptrs[4 * t + 2]);
    a.v[t] = reinterpret_cast<float*>(ptrs[4 * t + 3]);
  }
  a.chunk_start[count] = chunk_start[count];
  const int chunks = chunk_start[count];
  const int grid = chunks < resident ? chunks : resident;
  tf_adamw_step<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
