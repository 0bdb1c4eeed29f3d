// Fused attention softmax(q k^T / sqrt(D)) v, forward only, for Hopper.
//
// Replaces the Pallas TPU kernel transfuser_tpu/ops/attention.py
// (`_attn_kernel`, launched by `pallas_attention`). Same arithmetic: fp32
// logits q.k * (1/sqrt(D)), an exact two-pass softmax over the whole
// resident logit row (row max, exp, divide by the row sum), fp32 P.V, one
// cast to the input dtype at the store. q/k/v/o are read and written in
// place through their (B, T, H, D) strides: no transpose copies.
//
// Why the TPU design does not carry over: the Pallas kernel holds a whole
// (T, D) q/k/v block per (batch, head) program in VMEM, one program per
// (batch, head). On Hopper that is 4 blocks on 132 SMs at batch 1, and an
// fp32 K block (263 KB at T=174, D=378) exceeds a block's 227 KB.
//
// What bounds it on this card: at the fusion GPT's shapes (T=174, H=4,
// D in {18, 54, 144, 378}, batch 1) a call moves at most ~2 MB and does at
// most ~0.2 GFLOP: under a microsecond of HBM or tensor-core time. So
// latency bounds it: how many SMs work, how long each block's serial chain
// of loads, products and the softmax is, and the launch itself.
//
// Two designs, chosen by dtype (an explicit dispatch, not a fallback):
//
// bf16 (the main path), `attention_tc_bf16`: tensor cores.
//   - Grid (B*H, ceil(T/16), n_chunks): a block owns 16 query rows of one
//     (batch, head) and one chunk of output columns. The chunk width is
//     chosen on the host so that the grid reaches about one block per SM
//     (132 blocks at every main-path shape: chunks of 8/24/48/128 columns
//     at D = 18/54/144/378). Each block recomputes its 16 logit rows,
//     which costs little against the latency it hides.
//   - All of the head's K (bf16, D padded with zeros to a multiple of 16)
//     stays resident in shared memory (138 KB at D=378), beside the 16 q
//     rows, the block's V column chunk and P.
//   - Loads: 16-byte `cp.async`, Q and K in one group and V in a second
//     one that lands while the logits and the softmax run. A head slice
//     starts at h*D*2 bytes, which is not 16-byte aligned (36/108/756
//     bytes at D = 18/54/378), so a block copies the 16-byte-aligned span
//     of each row that covers its slice (rows are aligned: 8*D bytes; the
//     wrapper checks) and reads the slice at its offset in shared memory.
//     The span's extra columns are zeroed where they would enter a sum.
//     (Measured on an H100, 4-byte copies, one warp per row, would take
//     the block most of its time.)
//   - Both products are `mma.sync.m16n8k16` bf16 with fp32 accumulators.
//     q.k^T on bf16 operands is exact in fp32 accumulation (only the
//     summation order differs from the fp32 reference). Keys are padded
//     to a multiple of 16 and masked.
//   - Softmax: exact, over the whole row, on the logits where the MMAs
//     leave them (registers): row max and row sum go across the quad's
//     lanes by shuffles and across the 8 warps through shared memory.
//   - P stays effectively fp32 through P.V: it is stored as P = hi + lo,
//     both bf16, and multiplied in two MMAs. The split keeps ~16 bits of
//     P (relative error ~2^-17); one bf16 P would keep 8 and break the
//     Pallas kernel's fp32 P.V.
//   - With fewer 8-column output tiles than warps (D=18, 54), several
//     warps share a tile, each over an interleaved share of the keys, and
//     their partial sums are added in a fixed order.
// fp32 (only in card-vs-CPU checks), `attention_fwd_f32`: CUDA cores.
//   TF32 tensor cores would break the fp32 tolerance of 1e-5. Grid
//   (B*H, ceil(T/16)); fp32 q rows and logit rows in shared memory, K and
//   V streamed in 32-row tiles, P.V accumulated in registers.
//
// Limits: 1 <= T <= 1024, 1 <= D <= 512; bf16 also needs D even and K to
// fit in shared memory (T=174 takes any D up to 512). The Python wrapper
// checks the first and raises when the call returns an error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQTile = 16;  // query rows per block
constexpr int kMaxD = 512;
constexpr int kMaxT = 1024;
constexpr int kMaxDevices = 64;
constexpr int kSmemMax = 232448;  // a Hopper block's dynamic shared memory

struct Strides {
  long long b, t, h;  // in elements; the D stride is 1
};

// ---------------------------------------------------------------- fp32

constexpr int kThreads = 128;
constexpr int kKTile = 32;  // key / value rows per shared-memory tile
constexpr int kAccPerThread = kQTile * kMaxD / kThreads;  // 64

// Odd row pitch: the 32 lanes of a warp walk 32 different rows at the same
// column without bank conflicts.
__host__ __device__ __forceinline__ int row_pitch(int d) { return d | 1; }

__host__ __device__ __forceinline__ size_t smem_bytes_f32(int t, int d) {
  return sizeof(float) *
         ((size_t)(kQTile + kKTile) * row_pitch(d) + (size_t)kQTile * t);
}

// Copy `rows` rows of D elements (row stride `st`) into shared memory.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int rows, int d,
                                          int ld) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ld + c] = src[r * st + c];
  }
}

__global__ void __launch_bounds__(kThreads)
    attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int t_len, int n_head, int d, Strides sq, Strides sk,
                      Strides sv, Strides so, float scale) {
  extern __shared__ float smem[];
  const int ld = row_pitch(d);
  float* q_s = smem;                   // kQTile x ld
  float* kv_s = q_s + kQTile * ld;     // kKTile x ld
  float* p_s = kv_s + kKTile * ld;     // kQTile x t_len

  const int b = blockIdx.x / n_head;
  const int h = blockIdx.x - b * n_head;
  const int t0 = blockIdx.y * kQTile;
  const int rows = min(kQTile, t_len - t0);
  const int tid = threadIdx.x;

  const float* qb = q + b * sq.b + h * sq.h + t0 * sq.t;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h + t0 * so.t;

  load_tile(q_s, qb, sq.t, rows, d, ld);

  // ---- logits: p_s[r][s] = (q_r . k_s) * scale
  for (int s0 = 0; s0 < t_len; s0 += kKTile) {
    const int cols = min(kKTile, t_len - s0);
    __syncthreads();  // q_s written / previous K tile consumed
    load_tile(kv_s, kb + s0 * sk.t, sk.t, cols, d, ld);
    __syncthreads();
    for (int p = tid; p < kQTile * kKTile; p += kThreads) {
      const int r = p / kKTile;  // one query row per warp
      const int c = p - r * kKTile;
      if (r < rows && c < cols) {
        const float* qr = q_s + r * ld;
        const float* kr = kv_s + c * ld;
        float acc = 0.f;
        for (int i = 0; i < d; ++i) acc = fmaf(qr[i], kr[i], acc);
        p_s[r * t_len + s0 + c] = acc * scale;
      }
    }
  }
  __syncthreads();

  // ---- exact softmax over each full row, one warp per row
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* row = p_s + r * t_len;
    float m = -INFINITY;
    for (int j = lane; j < t_len; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = lane; j < t_len; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < t_len; j += 32) row[j] = row[j] / sum;
  }

  // ---- out = P . V, fp32 accumulators in registers: thread `tid` owns
  // the flattened outputs e = tid + a * kThreads of the (rows, d) tile
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.f;
  const int n_out = rows * d;

  for (int s0 = 0; s0 < t_len; s0 += kKTile) {
    const int cols = min(kKTile, t_len - s0);
    __syncthreads();  // softmax done / previous V tile consumed
    load_tile(kv_s, vb + s0 * sv.t, sv.t, cols, d, ld);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int e = tid + a * kThreads;
      if (e < n_out) {
        const int r = e / d;
        const int c = e - r * d;
        const float* pr = p_s + r * t_len + s0;
        float x = acc[a];
        for (int j = 0; j < cols; ++j) x = fmaf(pr[j], kv_s[j * ld + c], x);
        acc[a] = x;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int e = tid + a * kThreads;
    if (e < n_out) {
      const int r = e / d;
      const int c = e - r * d;
      ob[r * so.t + c] = acc[a];
    }
  }
}

// ---------------------------------------------------------------- bf16

constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kMaxKeyTiles = kMaxT / 8 / kTcWarps;  // 8-key tiles a warp
constexpr int kRedCols = 64;  // P.V partial sums: key groups x chunk width

// Padded sizes and shared-memory pitches of one bf16 launch. The bf16
// pitches are 4 mod 8 in 32-bit words, so the 8 rows x 4 words that a warp
// reads for one MMA fragment fall in 32 different banks, and a multiple of
// 16 bytes, so 16-byte copies land aligned.
struct TcShape {
  int t_pad;     // keys padded to a multiple of 16 (the k step of P.V)
  int d_pad;     // D padded to a multiple of 16 (the k step of q.k)
  int d_chunk;   // output columns per block, a multiple of 8
  int k_groups;  // warps that share one 8-column output tile
  int ldk;       // q_s / k_s row pitch: d_pad + 8
  int ldv;       // v_s row pitch: d_chunk + 8
  int ldp;       // p_hi / p_lo row pitch: t_pad + 8
};

__host__ __device__ __forceinline__ size_t smem_bytes_tc(const TcShape& s) {
  return 2 * ((size_t)(kQTile + s.t_pad) * s.ldk + (size_t)s.t_pad * s.ldv +
              2 * (size_t)kQTile * s.ldp) +
         4 * (size_t)(2 * kTcWarps * kQTile + kQTile * kRedCols);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage `rows` rows of `cols` bf16 columns, the first at element `off` of
// each row (row stride `st`), into shared memory of pitch `ld`, with
// 16-byte copies of the aligned span that covers them. Row starts are
// 16-byte aligned (the wrapper checks), a head slice need not be: column j
// of row r lands at dst[r * ld + (off % 8) + j]. The span's extra columns
// (a neighbouring head's) are never read as data.
__device__ __forceinline__ void stage_span(__nv_bfloat16* dst,
                                           const __nv_bfloat16* row0,
                                           long long off, long long st,
                                           int rows, int cols, int ld) {
  const int e0 = (int)(off & 7);
  const int per_row = (e0 + cols + 7) >> 3;
  const __nv_bfloat16* src = row0 + (off - e0);
  for (int i = threadIdx.x; i < rows * per_row; i += kTcThreads) {
    const int r = i / per_row;
    const int v = i - r * per_row;
    cp_async16(dst + r * ld + 8 * v, src + r * st + 8 * v);
  }
}

// Zero whole rows [r0, r1) of a tile of pitch `ld` (16-byte stores).
__device__ __forceinline__ void zero_rows(__nv_bfloat16* dst, int r0, int r1,
                                          int ld) {
  const int per_row = ld >> 3;
  for (int i = threadIdx.x; i < (r1 - r0) * per_row; i += kTcThreads) {
    const int r = r0 + i / per_row;
    const int v = i % per_row;
    *reinterpret_cast<uint4*>(dst + r * ld + 8 * v) = make_uint4(0, 0, 0, 0);
  }
}

// Zero columns [c0, c1) (both even) of rows [0, rows) of a tile, one
// thread per row.
__device__ __forceinline__ void zero_cols(__nv_bfloat16* dst, int rows,
                                          int ld, int c0, int c1) {
  for (int r = threadIdx.x; r < rows; r += kTcThreads)
    for (int c = c0; c < c1; c += 2)
      *reinterpret_cast<uint32_t*>(dst + r * ld + c) = 0u;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b for one 16x8x16 tile: bf16 operands, fp32 accumulators.
// a: row-major 16x16 fragment; b: 16x8 column-major fragment.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two neighbouring fp32 probabilities -> their bf16 roundings (hi) and the
// bf16 roundings of what is left (lo; x - hi is exact in fp32), stored as
// bf16 pairs.
__device__ __forceinline__ void store_split(float x0, float x1,
                                            __nv_bfloat16* hi,
                                            __nv_bfloat16* lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  *reinterpret_cast<uint32_t*>(hi) = pack_bf16(h0, h1);
  *reinterpret_cast<uint32_t*>(lo) =
      pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

__device__ __forceinline__ void store_out(__nv_bfloat16* ob, long long st,
                                          int r, int col, int rows, int d,
                                          float x0, float x1) {
  if (r < rows && col < d)  // d is even: col + 1 < d too
    *reinterpret_cast<__nv_bfloat162*>(ob + r * st + col) =
        __floats2bfloat162_rn(x0, x1);
}

// kTiles: the 8-key tiles each warp owns (at least ceil(T / 64)); a
// compile-time count, so that no unrolled step is issued only to be
// predicated off.
template <int kTiles>
__global__ void __launch_bounds__(kTcThreads)
    attention_tc_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int t_len, int n_head,
                      int d, Strides sq, Strides sk, Strides sv, Strides so,
                      float scale, TcShape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kQTile * sh.ldk;      // t_pad x ldk
  __nv_bfloat16* v_s = k_s + sh.t_pad * sh.ldk;    // t_pad x ldv
  __nv_bfloat16* p_hi = v_s + sh.t_pad * sh.ldv;   // 16 x ldp
  __nv_bfloat16* p_lo = p_hi + kQTile * sh.ldp;    // 16 x ldp
  float* red_max = reinterpret_cast<float*>(p_lo + kQTile * sh.ldp);
  float* red_sum = red_max + kTcWarps * kQTile;    // warps x 16
  float* red_pv = red_sum + kTcWarps * kQTile;     // 16 x kRedCols

  const int b = blockIdx.x / n_head;
  const int h = blockIdx.x - b * n_head;
  const int t0 = blockIdx.y * kQTile;
  const int c0 = blockIdx.z * sh.d_chunk;
  const int rows = min(kQTile, t_len - t0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // MMA fragment row (and column of B / C)
  const int tg = lane & 3;   // MMA fragment column pair

  // group 0: this block's q rows and the head's whole K; group 1: the V
  // columns [c0, c0 + d_chunk) of every key, in flight during the logits.
  // Rows no copy fills are zeroed; K's padded rows are masked instead.
  const long long qo = h * sq.h, ko = h * sk.h, vo = h * sv.h + c0;
  const int eq = (int)(qo & 7), ek = (int)(ko & 7), ev = (int)(vo & 7);
  stage_span(q_s, q + b * sq.b + t0 * sq.t, qo, sq.t, rows, d, sh.ldk);
  stage_span(k_s, k + b * sk.b, ko, sk.t, t_len, d, sh.ldk);
  cp_async_commit();
  stage_span(v_s, v + b * sv.b, vo, sv.t, t_len, min(sh.d_chunk, d - c0),
             sh.ldv);
  cp_async_commit();
  zero_rows(q_s, rows, kQTile, sh.ldk);
  zero_rows(v_s, t_len, sh.t_pad, sh.ldv);
  cp_async_wait<1>();
  __syncthreads();
  // D's padding (and whatever the covering span brought there) -> 0
  zero_cols(q_s, kQTile, sh.ldk, eq + d, eq + sh.d_pad);
  zero_cols(k_s, t_len, sh.ldk, ek + d, ek + sh.d_pad);
  __syncthreads();

  // ---- logits in registers: warp w owns the key tiles w, w + 8, ... of
  // 8 keys each; acc[j] holds rows g and g + 8 of its tile j
  const int n_key_tiles = sh.t_pad / 8;
  float acc[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const __nv_bfloat16* qa = q_s + g * sh.ldk + eq + 2 * tg;
  const __nv_bfloat16* kb = k_s + g * sh.ldk + ek + 2 * tg;
  for (int kk = 0; kk < sh.d_pad; kk += 16) {
    const uint32_t a[4] = {ld32(qa + kk), ld32(qa + 8 * sh.ldk + kk),
                           ld32(qa + kk + 8), ld32(qa + 8 * sh.ldk + kk + 8)};
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int nt = warp + kTcWarps * j;
      if (nt < n_key_tiles) {
        const __nv_bfloat16* kr = kb + nt * 8 * sh.ldk + kk;
        mma_bf16(acc[j], a, ld32(kr), ld32(kr + 8));
      }
    }
  }

  // ---- exact softmax over each row's t_len real keys: scale, mask the
  // padded keys, row max and row sum across the quad's lanes, then across
  // the warps through shared memory (in warp order)
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int key = (warp + kTcWarps * j) * 8 + 2 * tg;
    if (key < sh.t_pad) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = key + e < t_len;
        acc[j][e] = live ? acc[j][e] * scale : -INFINITY;
        acc[j][2 + e] = live ? acc[j][2 + e] * scale : -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(acc[j][0], acc[j][1]));
      m1 = fmaxf(m1, fmaxf(acc[j][2], acc[j][3]));
    }
  }
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  if (tg == 0) {
    red_max[warp * kQTile + g] = m0;
    red_max[warp * kQTile + g + 8] = m1;
  }
  __syncthreads();
  m0 = red_max[g];
  m1 = red_max[g + 8];
  for (int w = 1; w < kTcWarps; ++w) {
    m0 = fmaxf(m0, red_max[w * kQTile + g]);
    m1 = fmaxf(m1, red_max[w * kQTile + g + 8]);
  }
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    if ((warp + kTcWarps * j) * 8 < sh.t_pad) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[j][e] = expf(acc[j][e] - m0);
        acc[j][2 + e] = expf(acc[j][2 + e] - m1);
        s0 += acc[j][e];
        s1 += acc[j][2 + e];
      }
    }
  }
  for (int off = 1; off < 4; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  if (tg == 0) {
    red_sum[warp * kQTile + g] = s0;
    red_sum[warp * kQTile + g + 8] = s1;
  }
  __syncthreads();
  s0 = s1 = 0.f;
  for (int w = 0; w < kTcWarps; ++w) {
    s0 += red_sum[w * kQTile + g];
    s1 += red_sum[w * kQTile + g + 8];
  }
  // P = e / sum, kept as bf16 hi + lo (padded keys: e = 0)
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int col = (warp + kTcWarps * j) * 8 + 2 * tg;
    if (col < sh.t_pad) {
      const int r0 = g * sh.ldp + col, r1 = (g + 8) * sh.ldp + col;
      store_split(acc[j][0] / s0, acc[j][1] / s0, p_hi + r0, p_lo + r0);
      store_split(acc[j][2] / s1, acc[j][3] / s1, p_hi + r1, p_lo + r1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- out = (P_hi + P_lo) . V over this block's column chunk. A task is
  // one 8-column output tile and one of k_groups interleaved key ranges;
  // with fewer tiles than warps several warps share a tile and their
  // partial sums are added in group order afterwards.
  const int n_out_tiles = sh.d_chunk / 8;
  const int kg = sh.k_groups;
  const int kstep = 16 * kg;
  const unsigned short* vs =
      reinterpret_cast<const unsigned short*>(v_s) + ev;
  const __nv_bfloat16* pa_hi = p_hi + g * sh.ldp + 2 * tg;
  const __nv_bfloat16* pa_lo = p_lo + g * sh.ldp + 2 * tg;
  __nv_bfloat16* ob = o + b * so.b + h * so.h + t0 * so.t;
  for (int task = warp; task < n_out_tiles * kg; task += kTcWarps) {
    const int nt = task % n_out_tiles;
    const int grp = task / n_out_tiles;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 16 * grp; kk < sh.t_pad; kk += kstep) {
      const uint32_t hi[4] = {
          ld32(pa_hi + kk), ld32(pa_hi + 8 * sh.ldp + kk),
          ld32(pa_hi + kk + 8), ld32(pa_hi + 8 * sh.ldp + kk + 8)};
      const uint32_t lo[4] = {
          ld32(pa_lo + kk), ld32(pa_lo + 8 * sh.ldp + kk),
          ld32(pa_lo + kk + 8), ld32(pa_lo + 8 * sh.ldp + kk + 8)};
      // B fragment: V[key][col] for keys kk + 2*tg + {0, 1, 8, 9}
      const unsigned short* vb = vs + (kk + 2 * tg) * sh.ldv + nt * 8 + g;
      const uint32_t b0 = vb[0] | ((uint32_t)vb[sh.ldv] << 16);
      const uint32_t b1 = vb[8 * sh.ldv] | ((uint32_t)vb[9 * sh.ldv] << 16);
      mma_bf16(c, lo, b0, b1);
      mma_bf16(c, hi, b0, b1);
    }
    const int col = nt * 8 + 2 * tg;
    if (kg == 1) {
      store_out(ob, so.t, g, c0 + col, rows, d, c[0], c[1]);
      store_out(ob, so.t, g + 8, c0 + col, rows, d, c[2], c[3]);
    } else {
      float* red = red_pv + (grp * kQTile + g) * sh.d_chunk + col;
      red[0] = c[0];
      red[1] = c[1];
      red[8 * sh.d_chunk] = c[2];
      red[8 * sh.d_chunk + 1] = c[3];
    }
  }
  if (kg > 1) {
    __syncthreads();
    const int pairs = sh.d_chunk / 2;
    for (int i = threadIdx.x; i < kQTile * pairs; i += kTcThreads) {
      const int r = i / pairs;
      const int col = 2 * (i - r * pairs);
      float x0 = 0.f, x1 = 0.f;
      for (int grp = 0; grp < kg; ++grp) {
        x0 += red_pv[(grp * kQTile + r) * sh.d_chunk + col];
        x1 += red_pv[(grp * kQTile + r) * sh.d_chunk + col + 1];
      }
      store_out(ob, so.t, r, c0 + col, rows, d, x0, x1);
    }
  }
}

// ---------------------------------------------------------------- host

int round_up(int x, int m) { return (x + m - 1) / m * m; }
int ceil_div(int x, int m) { return (x + m - 1) / m; }

// Raise a kernel's shared-memory ceiling once per device (idempotent, so
// a race between threads is harmless).
template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, unsigned long long* raised, int dev,
                       int bytes) {
  const unsigned long long bit = dev < kMaxDevices ? 1ull << dev : 0;
  if (*raised & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *raised |= bit;
  return err;
}

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* o, int batch, int t_len, int n_head, int d,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int dev, cudaStream_t stream) {
  static unsigned long long raised = 0;
  const cudaError_t err = raise_smem(attention_fwd_f32, &raised, dev,
                                     (int)smem_bytes_f32(kMaxT, kMaxD));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_head, ceil_div(t_len, kQTile));
  attention_fwd_f32<<<grid, kThreads, smem_bytes_f32(t_len, d), stream>>>(
      q, k, v, o, t_len, n_head, d, sq, sk, sv, so, scale);
  return cudaGetLastError();
}

template <int kTiles>
cudaError_t launch_tc(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, __nv_bfloat16* o, int t_len,
                      int n_head, int d, Strides sq, Strides sk, Strides sv,
                      Strides so, float scale, const TcShape& sh, dim3 grid,
                      int dev, cudaStream_t stream) {
  static unsigned long long raised = 0;
  const cudaError_t err =
      raise_smem(attention_tc_bf16<kTiles>, &raised, dev, kSmemMax);
  if (err != cudaSuccess) return err;
  attention_tc_bf16<kTiles><<<grid, kTcThreads, smem_bytes_tc(sh), stream>>>(
      q, k, v, o, t_len, n_head, d, sq, sk, sv, so, scale, sh);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, __nv_bfloat16* o, int batch,
                        int t_len, int n_head, int d, Strides sq, Strides sk,
                        Strides sv, Strides so, float scale, int dev,
                        cudaStream_t stream) {
  if (d % 2 != 0) return cudaErrorInvalidValue;
  TcShape sh;
  sh.t_pad = round_up(t_len, 16);
  sh.d_pad = round_up(d, 16);
  sh.ldk = sh.d_pad + 8;
  sh.ldp = sh.t_pad + 8;
  // the widest column chunk that fits beside Q, K, P and the reductions
  sh.ldv = 8;
  const long long fixed = (long long)smem_bytes_tc(sh) - 2LL * sh.t_pad * 8;
  const long long room = (kSmemMax - fixed) / (2LL * sh.t_pad) - 8;
  if (room < 8) return cudaErrorInvalidValue;  // K does not fit
  const int max_chunk = (int)(room < kMaxD ? room : kMaxD) / 8 * 8;
  // enough column chunks for about one block per SM
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int d8 = round_up(d, 8);
  const int base = batch * n_head * ceil_div(t_len, kQTile);
  int n_chunks = ceil_div(sms, base);
  n_chunks = n_chunks < 1 ? 1 : (n_chunks > d8 / 8 ? d8 / 8 : n_chunks);
  sh.d_chunk = round_up(ceil_div(d8, n_chunks), 8);
  if (sh.d_chunk > max_chunk) sh.d_chunk = max_chunk;
  n_chunks = ceil_div(d8, sh.d_chunk);
  sh.ldv = sh.d_chunk + 8;
  const int n_out_tiles = sh.d_chunk / 8;
  sh.k_groups = n_out_tiles >= kTcWarps ? 1 : kTcWarps / n_out_tiles;

  const dim3 grid(batch * n_head, ceil_div(t_len, kQTile), n_chunks);
  const int tiles = ceil_div(sh.t_pad / 8, kTcWarps);
  if (tiles <= 1)
    return launch_tc<1>(q, k, v, o, t_len, n_head, d, sq, sk, sv, so, scale,
                        sh, grid, dev, stream);
  if (tiles <= 2)
    return launch_tc<2>(q, k, v, o, t_len, n_head, d, sq, sk, sv, so, scale,
                        sh, grid, dev, stream);
  if (tiles <= 3)
    return launch_tc<3>(q, k, v, o, t_len, n_head, d, sq, sk, sv, so, scale,
                        sh, grid, dev, stream);
  if (tiles <= 4)
    return launch_tc<4>(q, k, v, o, t_len, n_head, d, sq, sk, sv, so, scale,
                        sh, grid, dev, stream);
  if (tiles <= 8)
    return launch_tc<8>(q, k, v, o, t_len, n_head, d, sq, sk, sv, so, scale,
                        sh, grid, dev, stream);
  return launch_tc<kMaxKeyTiles>(q, k, v, o, t_len, n_head, d, sq, sk, sv,
                                 so, scale, sh, grid, dev, stream);
}

}  // namespace

extern "C" {

// One call's arguments, packed by the wrapper (ops/attention.py) in this
// order. Strides are in elements, for (b, t, h); the D stride must be 1.
// dtype: 0 = float32, 1 = bfloat16. bf16 needs D even, 16-byte aligned
// data, batch and row strides that are multiples of 8 and an even head
// stride.
struct AttentionArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st,
      o_sh;
  int batch, t_len, n_head, d, dtype;
};

// Returns a cudaError_t (0 = launched).
int tf_attention_forward(const AttentionArgs* a, void* stream) {
  const int batch = a->batch, t_len = a->t_len, n_head = a->n_head, d = a->d;
  if (batch < 1 || n_head < 1 || t_len < 1 || t_len > kMaxT || d < 1 ||
      d > kMaxD)
    return (int)cudaErrorInvalidValue;
  const Strides sq{a->q_sb, a->q_st, a->q_sh}, sk{a->k_sb, a->k_st, a->k_sh},
      sv{a->v_sb, a->v_st, a->v_sh}, so{a->o_sb, a->o_st, a->o_sh};
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0)
    return (int)launch_f32(
        static_cast<const float*>(a->q), static_cast<const float*>(a->k),
        static_cast<const float*>(a->v), static_cast<float*>(a->o), batch,
        t_len, n_head, d, sq, sk, sv, so, scale, dev, s);
  if (a->dtype == 1)
    return (int)launch_bf16(static_cast<const __nv_bfloat16*>(a->q),
                            static_cast<const __nv_bfloat16*>(a->k),
                            static_cast<const __nv_bfloat16*>(a->v),
                            static_cast<__nv_bfloat16*>(a->o), batch, t_len,
                            n_head, d, sq, sk, sv, so, scale, dev, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
