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
// What bounds it on this card: bytes. A call must read N * (C + 1) * 4
// bytes of values and ids and write S * C * 4 bytes of canvas: at batch 12
// (480,000 points, C = 32, 786,444 cells) 164 MB, 49 us at 3.35 TB/s; the
// canvas alone is twice the 50 MB L2.
//
// Design: the canvas is written once in full, and only the cells a point
// reaches are touched again. Three launches on the caller's stream:
//   1. one memset clears the canvas and, behind it in the same buffer, a
//      bitmap of touched cells (1 bit per cell: 98 KB at batch 12).
//   2. scatter: a warp takes 4 points at a time, its lanes along the
//      channels: the value reads are coalesced, the id reads broadcast,
//      and the 4 points' loads are all in flight before their atomics.
//      Values and ids are read once, with evict-first loads. Each entry
//      holds an order-preserving key: ~bits for a float whose sign bit is
//      set, bits | 0x80000000 otherwise, so unsigned order is float order,
//      and the update is one atomicMax on unsigned with no sign branch.
//      Key 0 is below every key, so the cleared canvas is the empty max. A
//      value <= NEG_INF / 2 (the padding) is skipped outright: a cell it
//      could raise still ends <= NEG_INF / 2 and so at 0 either way. A
//      lane reads the entry first and does the atomic only if its key is
//      larger: keys only grow, so skipping cannot change the result. Lane
//      0 sets each point's cell bit, reading the word first and skipping a
//      point whose id repeats the one before it: the 20,000 padding points
//      of a sample share one sentinel cell, and accesses to one word
//      queue at one L2 slice.
//   3. decode: one warp per bitmap word turns the touched cells' keys back
//      into floats, 4 cells at a time at C = 32 with one 16-byte piece per
//      lane (key 0, a channel no value reached, becomes +0.0). Untouched
//      cells hold 0 bits, which is +0.0, already the right output.
// Why not write the canvas only at the end (a bitmap memset, a pass that
// clears the touched cells, the scatter, one write of the whole canvas):
// measured on an H100 at batch 12 it took more device time than this
// layout, each of its three kernels about as long as the memset here.
// Max is order-free, so the result does not depend on the order the
// atomics land in: it equals a sequential max bit for bit (-0.0 orders
// below +0.0 here).
//
// Ids outside [0, S) are dropped, as XLA drops out-of-range scatter
// updates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

int grid_for(long long threads) {
  const long long blocks = (threads + kThreads - 1) / kThreads;
  // grid-stride loops below; 64 blocks per SM keeps all 132 SMs busy
  return (int)(blocks < 132 * 64 ? (blocks > 0 ? blocks : 1) : 132 * 64);
}

__device__ __forceinline__ unsigned encode_key(float v) {
  const unsigned bits = __float_as_uint(v);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ unsigned decode_key(unsigned key) {
  if (key == 0u) return 0u;  // no value reached this entry: +0.0
  return (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
}

constexpr int kPointsPerStep = 4;  // points a warp has in flight

__global__ void __launch_bounds__(kThreads)
    scatter_keys(const float* __restrict__ vals, const int* __restrict__ ids,
                 unsigned* keys, unsigned* touched, long long n, int c,
                 long long segments) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long p0 = ((blockIdx.x * (long long)kThreads + threadIdx.x) >>
                       5) * kPointsPerStep;
       p0 < n; p0 += warps * kPointsPerStep) {
    int s[kPointsPerStep];  // the same ids in every lane
#pragma unroll
    for (int j = 0; j < kPointsPerStep; ++j) {
      s[j] = p0 + j < n ? __ldcs(ids + p0 + j) : -1;
      if (s[j] >= segments) s[j] = -1;
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kPointsPerStep; ++j) {
        if (s[j] < 0 || (j > 0 && s[j] == s[j - 1])) continue;
        unsigned* word = touched + (s[j] >> 5);
        const unsigned bit = 1u << (s[j] & 31);
        if (!(__ldcg(word) & bit)) atomicOr(word, bit);
      }
    }
    for (int ch = lane; ch - lane < c; ch += 32) {
      // all loads of the step first, then the atomics
      unsigned key[kPointsPerStep], cur[kPointsPerStep];
#pragma unroll
      for (int j = 0; j < kPointsPerStep; ++j) {
        const float v =
            s[j] >= 0 && ch < c ? __ldcs(vals + (p0 + j) * c + ch) : kNegInf;
        key[j] = v > kNegInf * 0.5f ? encode_key(v) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kPointsPerStep; ++j)
        cur[j] = key[j] ? __ldcg(keys + (long long)s[j] * c + ch) : ~0u;
#pragma unroll
      for (int j = 0; j < kPointsPerStep; ++j)
        if (key[j] > cur[j])
          atomicMax(keys + (long long)s[j] * c + ch, key[j]);
    }
  }
}

__device__ __forceinline__ uint4 decode_key4(uint4 k) {
  return make_uint4(decode_key(k.x), decode_key(k.y), decode_key(k.z),
                    decode_key(k.w));
}

// One warp per bitmap word. With c a multiple of 4 and at most 128, a
// step decodes 32 / (c / 4) set cells at once (4 at c = 32), one 16-byte
// piece per lane; otherwise one cell at a time, lanes along it.
__global__ void __launch_bounds__(kThreads)
    decode_touched(unsigned* keys, const unsigned* __restrict__ touched,
                   long long words, int c) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const int vecs = c % 4 == 0 && c <= 128 ? c / 4 : 0;  // pieces per cell
  const int cells_per_step = vecs ? 32 / vecs : 1;
  for (long long w = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
       w < words; w += warps) {
    unsigned bits = touched[w];  // the same word in every lane
    while (bits) {
      if (vecs) {
        // lane -> (its cell: the slot-th set bit left, its piece)
        const int slot = lane / vecs;
        unsigned mine = bits;
        for (int i = 0; i < slot && mine; ++i) mine &= mine - 1;
        if (slot < cells_per_step && mine) {
          uint4* piece = reinterpret_cast<uint4*>(
                             keys + (w * 32 + __ffs(mine) - 1) * c) +
                         lane % vecs;
          *piece = decode_key4(*piece);
        }
        for (int i = 0; i < cells_per_step && bits; ++i) bits &= bits - 1;
      } else {
        unsigned* cell = keys + (w * 32 + __ffs(bits) - 1) * c;
        for (int ch = lane; ch < c; ch += 32) cell[ch] = decode_key(cell[ch]);
        bits &= bits - 1;
      }
    }
  }
}

}  // namespace

extern "C" {

// vals (n, c) float32 and ids (n,) int32, both contiguous; buf holds the
// (segments, c) float32 canvas, contiguous and written whole, followed by
// ceil(segments / 32) 32-bit words of scratch (the touched-cell bitmap).
// Returns a cudaError_t (0 = launched).
int tf_scatter_max_forward(const float* vals, const int* ids, float* buf,
                           long long n, int c, long long segments,
                           void* stream) {
  if (n < 0 || c < 1 || segments < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long canvas = segments * c;
  const long long words = (segments + 31) / 32;
  unsigned* keys = reinterpret_cast<unsigned*>(buf);
  unsigned* touched = keys + canvas;
  cudaError_t err = cudaMemsetAsync(buf, 0, (canvas + words) * 4, s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const long long steps = (n + kPointsPerStep - 1) / kPointsPerStep;
  scatter_keys<<<grid_for(steps * 32), kThreads, 0, s>>>(
      vals, ids, keys, touched, n, c, segments);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_touched<<<grid_for(words * 32), kThreads, 0, s>>>(keys, touched,
                                                           words, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
