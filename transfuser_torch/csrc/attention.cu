// Fused attention softmax(q k^T / sqrt(D)) v, forward only, for Hopper.
//
// Replaces the Pallas TPU kernel transfuser_tpu/ops/attention.py
// (`_attn_kernel`, launched by `pallas_attention`). Same arithmetic: fp32
// logits q.k * (1/sqrt(D)), an exact two-pass softmax over the whole
// resident logit row (row max, exp, divide by the row sum; the key-tiled
// kernel takes one pass with a running max and sum, the same function up
// to rounding), fp32 P.V, one cast to the input dtype at the store.
// q/k/v/o are read and written in place through their (B, T, H, D)
// strides: no transpose copies.
//
// Why the TPU design does not carry over: the Pallas kernel holds a whole
// (T, D) q/k/v block per (batch, head) program in VMEM, one program per
// (batch, head). On Hopper that is 4 blocks on 132 SMs at batch 1, and an
// fp32 K block (263 KB at T=174, D=378) exceeds a block's 227 KB.
//
// What bounds it on this card: at the fusion GPT's shapes (T=174, H=4,
// D in {18, 54, 144, 378}, batch 1) a call moves at most ~4.2 MB (fp32;
// 2.1 MB bf16) and does at most ~0.2 GFLOP (0.55 as fp32's three TF32
// products): about a microsecond of HBM or tensor-core time. So latency
// bounds it: how many SMs work, how long each block's serial chain of
// loads, products and the softmax is, the L2-to-SM traffic of every block
// reading its head's whole K, and the launch itself.
//
// Three kernels, chosen by a rule on the shape, dtype and layout (an
// explicit dispatch, not a retry; `tf_attention_route` below):
//   - the resident kernels take T <= 1024 and D <= 512: fp32 always, bf16
//     where D is even, the rows are 16-byte aligned (see the wrapper's
//     `_bf16_rows`) and the head's whole K fits in shared memory (T = 174
//     at any D up to 512);
//   - the key-tiled kernel takes every shape, in either dtype.
// Where both take a shape, the rule picks the one that ran faster in run
// BT of chip_smoke.py (NVIDIA H100 80GB HBM3 at 700 W, profiler device
// time, both kernels timed at each of the 65 rows of shapes and layouts
// both take):
//   - the resident kernels at T <= 384: faster at 49 of the 57 such rows,
//     the main path's included (bf16 (1,174,4,D), D = 18 / 54 / 144 /
//     378: 0.0061 / 0.0070 / 0.0079 / 0.0133 ms against 0.0066 / 0.0074
//     / 0.0094 / 0.0180; fp32 0.0072 / 0.0095 / 0.0161 / 0.0359 against
//     0.0098 / 0.0122 / 0.0198 / 0.0467), except
//   - fp32 at D >= 144 over 8 or more (batch, head) pairs: the key-tiled
//     kernel, faster at (4,174,2,144) 0.0204 against 0.0265 ms,
//     (4,174,2,378) 0.0562 against 0.0826 and (1,174,8,189) 0.0294
//     against 0.0347 (the resident fp32 kernel runs its 132 blocks at
//     one 16-row tile and one column chunk each);
//   - the key-tiled kernel above T = 384, but for fp32 at D > 384:
//     faster at all 7 such rows, bf16 (1,696,4,18) 0.0147 against 0.0251
//     ms, (1,696,4,54) 0.0201 against 0.0472; fp32 (1,696,4,D), D = 18 /
//     54 / 144 / 378, 0.0250 / 0.0388 / 0.0709 / 0.2120 against 0.0350 /
//     0.0689 / 0.1902 / 0.4528; (1,1024,4,64) 0.0587 against 0.1014; the
//     resident fp32 kernel at (1,1024,2,512), 0.3955 against 0.4001.
// Of the 8 rows at T <= 384 where the key-tiled kernel ran faster, 6
// were within 9% (bf16 (2,174,4,18), (1,174,8,72), (4,174,2,144) and
// (4,174,2,378); fp32 (1,17,4,64) and (1,174,8,72)); the other 2 are the
// bf16 tensor-parallel shards (4,174,2,18) and (4,174,2,54), 0.0072 and
// 0.0088 against 0.0131 and 0.0147 ms, where the resident kernel's time
// includes the three copies into padded rows. No plain rule on the
// shape separates these from their neighbours, so they stay resident.

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
// fp32 (fp32 forwards, eval steps and checks), `attention_tc_f32`: the
// tensor cores as split TF32 (3xTF32; CUTLASS's OpMultiplyAddFastF32).
//   - Why split: one TF32 product keeps 10 mantissa bits and misses the
//     fp32 tolerance of 1e-5 by 40-54x (emulated below). Each operand x
//     is split where its fragment is loaded: big = tf32(x), small =
//     tf32(x - big), rounded as cvt.rna rounds (x - big is exact). A tile
//     takes three `mma.sync.m16n8k8` TF32 MMAs with fp32 accumulators,
//     big.big, big.small and small.big; small.small (~2^-22 of the
//     product) is dropped. The cross products sum apart from big.big
//     (the tensor core's sum would drop their low bits). P (fp32 after
//     the softmax) is split the same way for P.V. Emulated on seeded randn
//     inputs at (1,174,4,D), D = 16-512 (`PYTHONPATH=. python
//     tests/test_torch_attention.py`): max abs error 0.6e-6 to 1.7e-6
//     against the plain version, 0.4e-6 to 1.2e-6 against fp64 (the plain
//     version's own: 0.4e-6 to 1.0e-6); one TF32 product 4.0e-4 to
//     5.4e-4 against the plain version.
//   - Grid (B*H, ceil(T/16), n_chunks): column chunks as in launch_bf16,
//     but as many as keep the grid within one block per SM, since a
//     block's registers fill its SM (132 blocks at every main-path
//     shape, where the CUDA-core kernel this design replaced ran 44
//     blocks of 4 warps). Each block recomputes its 16 logit rows.
//   - K streamed, logits in registers: an fp32 K does not fit in shared
//     memory (270 KB at T=174, D=378), so Q and K go through it in
//     chunks of up to 64 columns, double-buffered with cp.async (chunk
//     i + 1 lands while chunk i's MMAs run). The 16 x T logits stay in
//     registers, each warp owning whole 8-key tiles. The tile loop has
//     no branch (a warp short of tiles repeats its last one, left out by
//     the softmax), so every tile's fragment loads issue together, and
//     each tile keeps three accumulators: independent MMA chains where
//     the CUDA-core kernel ran one serial chain of D fmaf per logit.
//   - V's column chunk follows as later cp.async groups that land during
//     the last MMAs and the softmax: resident where it fits, else
//     streamed in key chunks through two buffers (long T), so the column
//     chunks never shrink to make room. The softmax reduces across the
//     quad by shuffles and across warps through shared memory; P goes to
//     shared memory in fp32, over the dead K buffers, and each P fragment
//     is loaded once for all of a warp's P.V tiles.
//   - Keys padded to a multiple of 8 and masked, D zero-padded to a
//     multiple of 8, query rows past T zero: the copies zero-fill
//     (cp.async's src-size), with no extra pass or barrier.
//   - Any alignment: the host picks each tensor's copy width, 16, 8 or 4
//     bytes, the widest to which every row start is aligned, and copies
//     cover the aligned span of each row as in the bf16 kernel. The GPT's
//     tensors take 16-byte copies (their head slices start only 8-byte
//     aligned at D = 18, 54, 378: the span covers them); a tensor that
//     starts one float into a buffer takes 4-byte copies.
//   - Pitches keep every fragment load free of bank conflicts.
//   - Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
//     kernels phase): device time 0.0071 / 0.0094 / 0.0159 / 0.0360 ms
//     at (1,174,4,D), D = 18 / 54 / 144 / 378, against 0.0216 / 0.0227 /
//     0.0310 / 0.0319 ms for fp32 SDPA; max abs error against the plain
//     version 0.7e-6 to 3.6e-6, against fp64 0.6e-6 to 3.1e-6 (the plain
//     version's own 0.4e-6 to 1.5e-6). What bounds it at D = 378: every
//     block reads its head's whole K (288 KB with Q) and its V chunk
//     (90 KB) from L2, 50 MB over the 132 blocks, which
//     tools/attention_ablation.py shows to take most of the time; the
//     logits' MMAs come second.
//
// Key-tiled (any T, any D, either dtype, any alignment), `attention_kt`,
// FlashAttention-2's structure on mma.sync:
//   - Grid (B*H, ceil(T/64), column chunks): a block owns 64 query rows of
//     one (batch, head) and one chunk of output columns; warp w of a key
//     group owns 16 rows and keeps in registers, for a key tile (64 keys
//     bf16, 32 fp32), its logits, P, the running row max and sum (in log2
//     units) and its output columns. The row statistics reduce across the
//     quad's lanes only (shuffles): no barrier, no shared memory.
//   - One pass over the key tiles: m' = max(m, the tile's max), the sums
//     and the output rescaled by 2^(m - m'), P = 2^(s - m'), out / l once
//     at the end; the same function as the Pallas kernel's exact two-pass
//     softmax, up to rounding (emulated on the CPU:
//     tests/test_torch_attention.py `_key_tiled_emulation`, fp32 within
//     4.5e-7 of the plain version at (1,2016,4,378), 1.0e-6 at
//     (1,174,1,1512)). A tile always holds a key below T, so the first
//     rescale is 2^-inf = 0, never 2^(-inf - -inf).
//   - P.V straight from the logits' registers: bf16 P as hi + lo pairs
//     (the m16n8 C layout of two 8-key tiles is the m16n8k16 A layout),
//     fp32 P split for TF32 with the A fragment's keys permuted within
//     each 8-key step to match the C layout, V's rows read in that order.
//     fp32 products leave the accumulators into fp32 sums once a stage
//     (logits) or a tile (P.V); split TF32 here rounds big and leaves
//     small for the tensor core to truncate (split_kt).
//   - 2-4 key groups of 4 warps a block (as many as the warps' registers
//     allow: 4 up to 4 bf16 / 2 fp32 output tiles a warp, 3 up to 8, else
//     2) take key tiles in turn and merge their (m, l, out) in group order
//     at the end: the 64-row grid of a long T has only B*H*T/64 blocks
//     (128 at (1,2016,4,D)), so the groups supply the warps, and each
//     group's serial chain is 1/groups of the keys.
//   - Q resident in shared memory (or streamed beside K where it does not
//     fit), K streamed in stages of D columns (all of D where they fit,
//     one barrier a key tile) through a 2-3 slot cp.async ring, V in
//     buffers of its own issued a stage or more before its use; copy
//     plans computed once a block (no division in the stage loop).
//   - Output columns a block: at most 24 8-column tiles a warp (192), more
//     chunks while the grid leaves a tenth of the SMs idle; each chunk
//     computes the logits again. At (1,174,1,1512) that is 38 chunks of
//     40 columns over 3 row blocks (114 blocks), each computing the 64 x
//     174 logits over all 1512 columns: 38x the logits' work of one
//     block, which the grid runs side by side.
//   - Copies of 16, 8, 4 or 2 bytes, the widest every row start allows:
//     bf16 head slices of odd D start at odd elements, read as 16-bit
//     pairs; 2-byte rows, which cp.async cannot copy, are plain loads.
//   - Measured (run BT, device ms at (1,2016,4,D), D = 18 / 54 / 144 /
//     378): bf16 0.0429 / 0.0700 (CUDA events; the profiler under-read)
//     / 0.1598 / 0.5106 against SDPA's 0.0326 / 0.0422 / 0.0426 /
//     0.8242; fp32 0.0765 / 0.1368 / 0.3622 / 1.3524 against 0.2829 /
//     0.3173 / 0.3718 / 0.7460. Where the time goes at D = 378
//     (tools/attention_ablation.py, BT): bf16 0.52 ms, of which P.V's
//     MMAs (hi and lo) 0.18, the logits' 0.08, the K / V copies 0.17;
//     fp32 1.38 ms, of which the logits' split-TF32 MMAs 0.53 (over two
//     column chunks of 192), P.V's 0.43, the copies 0.34. ptxas: no
//     spill but 16 bytes at fp32 with 24 output tiles and 4 at 8.

// Limits: the grid's (B*H < 2^31, ceil(T/16) (resident) or ceil(T/64)
// (key-tiled) and the column chunks at most 65535 each) and 32-bit
// element offsets within a row's span (T and D below 2^31); strides are
// 64-bit. The D stride must be 1 (the wrapper
// copies a tensor whose D stride is not). A launch that fails returns its
// error, and the wrapper raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQTile = 16;  // query rows per block
// the shape domain of the resident-K (bf16) and register-logit (fp32)
// kernels, whose compile-time tile counts it sets; the key-tiled path
// takes every shape outside it
constexpr int kResidentMaxD = 512;
constexpr int kResidentMaxT = 1024;
// the dispatch rule's boundaries (header): above this T the key-tiled
// kernel takes what the resident ones would, in fp32 up to this D
constexpr int kKtMinT = 384;
constexpr int kKtMaxF32D = 384;
constexpr int kMaxDevices = 64;
constexpr int kSmemMax = 232448;  // a Hopper block's dynamic shared memory

struct Strides {
  long long b, t, h;  // in elements; the D stride is 1
};

// ---------------------------------------------------------------- bf16

constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
// 8-key tiles a warp
constexpr int kMaxKeyTiles = kResidentMaxT / 8 / kTcWarps;
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

// ---------------------------------------------------------------- fp32

// Padded sizes, pitches and copy widths of one fp32 launch, in floats. ldc
// and ldp are 4 mod 8, so the 8 rows x 4 columns that a warp reads for an
// A fragment (Q, P) or K's B fragment fall in 32 different banks; ldv is
// 8 mod 16, so V's 4 rows x 8 columns do too. All are multiples of 4, so
// 16-byte copies land aligned.
struct F32Shape {
  int t_pad;       // keys padded to a multiple of 8 (the k step of P.V)
  int d_pad;       // D padded to a multiple of 8 (the k step of q.k)
  int kc;          // Q / K columns per streamed chunk, a multiple of 8
  int d_chunk;     // output columns per block, a multiple of 8
  int k_groups;    // warps that share one 8-column output tile
  int kv;          // keys per V chunk: t_pad (V resident), or a multiple of
                   // 8 * k_groups streamed through two buffers
  int ldc;         // chunk buffer pitch: kc + 4
  int ldv;         // v_s pitch: round_up(d_chunk, 16) + 8
  int ldp;         // P pitch: t_pad + 4
  int v_off;       // floats before v_s: the K chunk buffers, which P reuses
  int wq, wk, wv;  // copy width of q, k and v in floats: 4, 2 or 1
};

// the most P.V tasks a warp takes: D = 512 in one column chunk
constexpr int kMaxTasks = kResidentMaxD / 8 / kTcWarps;

__host__ __device__ __forceinline__ int v_buffers(const F32Shape& s) {
  return s.kv < s.t_pad ? 2 : 1;
}

__host__ __device__ __forceinline__ size_t smem_bytes_f32(const F32Shape& s) {
  return 4 * ((size_t)s.v_off + (size_t)v_buffers(s) * s.kv * s.ldv +
              2 * kTcWarps * kQTile + kQTile * kRedCols);
}

// cp.async of w elements (16, 8 or 4 bytes: w = 4, 2 or 1 floats, 8, 4
// or 2 bf16); the first n come from src, the rest are zero-filled.
template <typename T>
__device__ __forceinline__ void cp_async_elems(T* dst, const T* src, int w,
                                               int n) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = w * (int)sizeof(T), n_bytes = n * (int)sizeof(T);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n_bytes));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(n_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n_bytes));
}

// Wait until at most n (0 to 3) of the latest cp.async groups are still
// in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 3)
    cp_async_wait<3>();
  else if (n == 2)
    cp_async_wait<2>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// Stage `rows_fill` rows x `width` columns into shared memory of pitch
// `ld`: row r < rows takes columns [0, cols) of source row r (whose first
// column is element `off` of the row; row stride `st`); columns [cols,
// width) and rows [rows, rows_fill) are zero-filled. The copies, w
// elements each, cover the w-aligned span of every row (row starts are
// w-aligned: the host picks w), so column j of row r lands at
// dst[r * ld + off % w + j]; the span's leading extra columns are never
// read. A copy of one bf16 (rows only 2-byte aligned) has no cp.async
// form: it is a plain load and store, visible after the next barrier as
// the others are.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* row0,
                                           long long off, long long st,
                                           int rows, int rows_fill, int cols,
                                           int width, int ld, int w) {
  const int e0 = (int)(off % w);
  const int per_row = (e0 + width + w - 1) / w;
  const T* src = row0 + (off - e0);
  for (int i = threadIdx.x; i < rows_fill * per_row; i += kTcThreads) {
    const int r = i / per_row;
    const int j = (i - r * per_row) * w;  // the copy's first span column
    const int n = r < rows ? max(0, min(w, e0 + cols - j)) : 0;
    const T* from = n > 0 ? src + r * st + j : src;
    if (sizeof(T) == 2 && w == 1)
      *reinterpret_cast<unsigned short*>(dst + r * ld + j) =
          n > 0 ? *reinterpret_cast<const unsigned short*>(from) : 0;
    else
      cp_async_elems(dst + r * ld + j, from, w, n);
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest,
// ties away from zero), in two integer operations; cvt.rna adds guards
// for Inf and NaN, which the inputs never hold, to every split.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32; x - big is exact in fp32, so the pair keeps
// about 22 bits of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// The split A fragment (rows g, g + 8; columns tg, tg + 4) of a row-major
// fp32 tile; p points at row g, column tg.
__device__ __forceinline__ void load_a_split(const float* p, int ld,
                                             uint32_t (&big)[4],
                                             uint32_t (&small)[4]) {
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * ld], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * ld + 4], big[3], small[3]);
}

// c += a . b for one 16x8x8 tile: TF32 operands, fp32 accumulators.
// a: row-major 16x8 fragment; b: 8x8 column-major fragment.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 3xTF32 tile product: big.big into c[0], big.small and small.big
// into c[1] and c[2] (kAcc = 3: no MMA waits for another) or both into
// c[1] (kAcc = 2). The cross products keep an accumulator apart from
// big.big: added into it, the tensor core's sum would drop their low
// bits. small.small (about 2^-22 of the product) is dropped. The B
// fragment is b[0], b[b_step].
template <int kAcc>
__device__ __forceinline__ void mma_split(float (&c)[kAcc][4],
                                          const uint32_t (&a_big)[4],
                                          const uint32_t (&a_small)[4],
                                          const float* b, int b_step) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b[0], bb0, bs0);
  split_tf32(b[b_step], bb1, bs1);
  mma_tf32(c[kAcc - 1], a_big, bs0, bs1);
  mma_tf32(c[kAcc / 2], a_small, bb0, bb1);
  mma_tf32(c[0], a_big, bb0, bb1);
}

// big.big + (big.small + small.big) of mma_split's accumulators
template <int kAcc>
__device__ __forceinline__ float split_sum(const float (&c)[kAcc][4], int e) {
  return kAcc == 3 ? c[0][e] + (c[1][e] + c[2][e]) : c[0][e] + c[1][e];
}

__device__ __forceinline__ void store_out_f32(float* ob, long long st, int r,
                                              int col, int rows, int d,
                                              float x0, float x1) {
  if (r < rows) {
    if (col < d) ob[r * st + col] = x0;
    if (col + 1 < d) ob[r * st + col + 1] = x1;
  }
}

// kTiles: the 8-key tiles each warp owns (at least ceil(T / 64)), as in
// attention_tc_bf16; kTasks: the P.V tasks each warp takes at most (2 or
// kMaxTasks). Compile-time counts keep the accumulators in registers.
template <int kTiles, int kTasks>
__global__ void __launch_bounds__(kTcThreads)
    attention_tc_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int t_len, int n_head, int d, Strides sq, Strides sk,
                     Strides sv, Strides so, float scale, F32Shape sh) {
  extern __shared__ __align__(16) float smem_f32[];
  const int buf_floats = (kQTile + sh.t_pad) * sh.ldc;  // 16 q + t_pad keys
  float* p_s = smem_f32;  // 16 x ldp, over the chunk buffers after q.k
  float* v_s = smem_f32 + sh.v_off;  // 1 or 2 V buffers of kv x ldv
  float* red_max = v_s + v_buffers(sh) * sh.kv * sh.ldv;  // warps x 16
  float* red_sum = red_max + kTcWarps * kQTile;       // warps x 16
  float* red_pv = red_sum + kTcWarps * kQTile;        // 16 x kRedCols

  const int b = blockIdx.x / n_head;
  const int h = blockIdx.x - b * n_head;
  const int t0 = blockIdx.y * kQTile;
  const int c0 = blockIdx.z * sh.d_chunk;
  const int rows = min(kQTile, t_len - t0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // MMA fragment row (and column of B / C)
  const int tg = lane & 3;   // MMA fragment column

  // Chunks start at multiples of 8 columns, so a head slice's offset in
  // its span (eq, ek) is the same in every chunk.
  const float* q0 = q + b * sq.b + t0 * sq.t;
  const float* k0 = k + b * sk.b;
  const long long qo = h * sq.h, ko = h * sk.h, vo = h * sv.h + c0;
  const int eq = (int)(qo % sh.wq), ek = (int)(ko % sh.wk),
            ev = (int)(vo % sh.wv);
  const int n_kc = (sh.d_pad + sh.kc - 1) / sh.kc;  // K chunks
  const int n_vc = (sh.t_pad + sh.kv - 1) / sh.kv;  // V chunks
  const int n_v_early = min(2, n_vc);  // issued with the last K chunk

  // One cp.async group per chunk i: columns [i*kc, i*kc + kc) of this
  // block's q rows (rows past T zero) and of every key; D's padding zero.
  auto stage_chunk = [&](int i) {
    float* buf = smem_f32 + (i & 1) * buf_floats;
    const int c = i * sh.kc;
    const int width = min(sh.kc, sh.d_pad - c), cols = min(sh.kc, d - c);
    stage_rows(buf, q0, qo + c, sq.t, rows, kQTile, cols, width, sh.ldc,
               sh.wq);
    stage_rows(buf + kQTile * sh.ldc, k0, ko + c, sk.t, t_len, t_len, cols,
               width, sh.ldc, sh.wk);
    cp_async_commit();
  };
  // One group per V chunk j: the V columns [c0, c0 + d_chunk) of the keys
  // [j*kv, j*kv + kv) (padded keys zero).
  auto stage_v = [&](int j) {
    const int key0 = j * sh.kv;
    stage_rows(v_s + (j & 1) * sh.kv * sh.ldv, v + b * sv.b + key0 * sv.t,
               vo, sv.t, min(sh.kv, t_len - key0),
               min(sh.kv, sh.t_pad - key0), min(sh.d_chunk, d - c0),
               sh.d_chunk, sh.ldv, sh.wv);
    cp_async_commit();
  };
  auto stage_v_early = [&]() {
    stage_v(0);
    if (n_vc > 1) stage_v(1);
  };

  // Groups in order: K chunks 0 and 1, then chunk i + 2 once chunk i's
  // MMAs are done; V chunks 0 and 1 right after the last K chunk, so that
  // they land during the last MMAs and the softmax; V chunk j + 2 once
  // chunk j's P.V is done.
  stage_chunk(0);
  if (n_kc > 1) stage_chunk(1);
  if (n_kc <= 2) stage_v_early();

  // ---- logits in registers: warp w owns the key tiles w, w + 8, ... of
  // 8 keys each; acc[j] holds the three products' rows g and g + 8 of its
  // tile j. A warp with fewer than kTiles tiles repeats its last one (no
  // branch in the loop, so the compiler can hoist every tile's loads);
  // the softmax leaves the repeats out.
  const int n_key_tiles = sh.t_pad / 8;
  constexpr int kAcc = kTiles <= 8 ? 3 : 2;  // 3 while registers allow
  float acc[kTiles][kAcc][4];
  int k_off[kTiles];  // row offset of tile j's first key in a chunk buffer
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4 * kAcc; ++e) acc[j][e / 4][e % 4] = 0.f;
    k_off[j] = min(warp + kTcWarps * j, n_key_tiles - 1) * 8 * sh.ldc;
  }
  for (int i = 0; i < n_kc; ++i) {
    // in flight behind chunk i: chunk i + 1, and V's first chunks once
    // they are issued
    cp_async_wait_upto((i + 1 < n_kc) + (i + 2 >= n_kc ? n_v_early : 0));
    __syncthreads();
    const float* buf = smem_f32 + (i & 1) * buf_floats;
    const float* qa = buf + g * sh.ldc + eq + tg;
    const float* kb = buf + (kQTile + g) * sh.ldc + ek + tg;
    const int width = min(sh.kc, sh.d_pad - i * sh.kc);
#pragma unroll 2
    for (int kk = 0; kk < width; kk += 8) {
      uint32_t a_big[4], a_small[4];
      load_a_split(qa + kk, sh.ldc, a_big, a_small);
      // B fragment: K[key of tile j + g][columns kk + tg, kk + tg + 4]
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        mma_split(acc[j], a_big, a_small, kb + k_off[j] + kk, 4);
    }
    __syncthreads();  // chunk i consumed: its buffer takes chunk i + 2
    if (i + 2 < n_kc) {
      stage_chunk(i + 2);
      if (i + 3 == n_kc) stage_v_early();
    }
  }

  // ---- exact softmax over each row's t_len real keys: scale, mask the
  // padded keys, row max and row sum across the quad's lanes, then across
  // the warps through shared memory (in warp order)
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8
  float x[kTiles][4];                    // the scaled logits, then e
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int key = (warp + kTcWarps * j) * 8 + 2 * tg;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = key + (e & 1) < t_len;
      x[j][e] = live ? split_sum(acc[j], e) * scale : -INFINITY;
    }
    if (key < sh.t_pad) {
      m0 = fmaxf(m0, fmaxf(x[j][0], x[j][1]));
      m1 = fmaxf(m1, fmaxf(x[j][2], x[j][3]));
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
        x[j][e] = expf(x[j][e] - m0);
        x[j][2 + e] = expf(x[j][2 + e] - m1);
        s0 += x[j][e];
        s1 += x[j][2 + e];
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
  // P = e / sum in fp32 (padded keys: e = 0), split again at its loads
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int col = (warp + kTcWarps * j) * 8 + 2 * tg;
    if (col < sh.t_pad) {
      float* r0 = p_s + g * sh.ldp + col;
      float* r1 = r0 + 8 * sh.ldp;
      r0[0] = x[j][0] / s0;
      r0[1] = x[j][1] / s0;
      r1[0] = x[j][2] / s1;
      r1[1] = x[j][3] / s1;
    }
  }

  // ---- out = P . V over this block's column chunk, 3xTF32, one V chunk
  // at a time. A task is one 8-column output tile and one of k_groups
  // interleaved ranges of 8-key steps; warp w takes the tasks w, w + 8,
  // ... and keeps their sums in registers across the V chunks. With fewer
  // tiles than warps several warps share a tile and their partial sums
  // are added in group order afterwards.
  const int n_out_tiles = sh.d_chunk / 8;
  const int kg = sh.k_groups;
  const int n_tasks = n_out_tiles * kg;
  const int grp = warp / n_out_tiles;  // this warp's key range
  const float* pa = p_s + g * sh.ldp + tg;
  constexpr int kAccPV = kTasks <= 2 ? 3 : 2;  // 3 while registers allow
  float cc[kTasks][kAccPV][4] = {};
  for (int j = 0; j < n_vc; ++j) {
    cp_async_wait_upto(j + 1 < n_vc);  // chunk j + 1 may stay in flight
    __syncthreads();                   // (and, at j = 0, P is stored)
    const int key0 = j * sh.kv, key1 = min(sh.t_pad, key0 + sh.kv);
    const float* vs = v_s + (j & 1) * sh.kv * sh.ldv + ev + tg * sh.ldv + g;
    // A warp's tasks share one key range (k_groups > 1 leaves one task a
    // warp), so each P fragment is loaded once for all of them.
#pragma unroll 2
    for (int kk = key0 + 8 * grp; kk < key1 && warp < n_tasks;
         kk += 8 * kg) {
      uint32_t a_big[4], a_small[4];
      load_a_split(pa + kk, sh.ldp, a_big, a_small);
#pragma unroll
      for (int t = 0; t < kTasks; ++t) {
        const int task = warp + kTcWarps * t;
        // B fragment: V[keys kk + tg, kk + tg + 4][column task's tile + g]
        if (task < n_tasks)
          mma_split(cc[t], a_big, a_small,
                    vs + (kk - key0) * sh.ldv + task % n_out_tiles * 8,
                    4 * sh.ldv);
      }
    }
    if (j + 2 < n_vc) {
      __syncthreads();  // chunk j consumed: its buffer takes chunk j + 2
      stage_v(j + 2);
    }
  }
  float* ob = o + b * so.b + h * so.h + t0 * so.t;
#pragma unroll
  for (int t = 0; t < kTasks; ++t) {
    const int task = warp + kTcWarps * t;
    if (task < n_tasks) {
      const int nt = task % n_out_tiles;
      float c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = split_sum(cc[t], i);
      const int col = nt * 8 + 2 * tg;
      if (kg == 1) {
        store_out_f32(ob, so.t, g, c0 + col, rows, d, c[0], c[1]);
        store_out_f32(ob, so.t, g + 8, c0 + col, rows, d, c[2], c[3]);
      } else {
        float* red = red_pv + (grp * kQTile + g) * sh.d_chunk + col;
        red[0] = c[0];
        red[1] = c[1];
        red[8 * sh.d_chunk] = c[2];
        red[8 * sh.d_chunk + 1] = c[3];
      }
    }
  }
  if (kg > 1) {
    __syncthreads();
    const int pairs = sh.d_chunk / 2;
    for (int i = threadIdx.x; i < kQTile * pairs; i += kTcThreads) {
      const int r = i / pairs;
      const int col = 2 * (i - r * pairs);
      float x0 = 0.f, x1 = 0.f;
      for (int gi = 0; gi < kg; ++gi) {
        x0 += red_pv[(gi * kQTile + r) * sh.d_chunk + col];
        x1 += red_pv[(gi * kQTile + r) * sh.d_chunk + col + 1];
      }
      store_out_f32(ob, so.t, r, c0 + col, rows, d, x0, x1);
    }
  }
}

// ----------------------------------------------------- key-tiled (any T, D)

// Keys a tile and the MMA's k step, by input type: fp32 takes 32-key tiles,
// so that a warp's split-TF32 logits (two accumulators), their fp32 sums,
// P.V's products and the output sums fit in its registers together.
template <typename T>
struct KtKeys;
template <>
struct KtKeys<float> {
  static constexpr int kKeys = 32;
  static constexpr int kStep = 8;
};
template <>
struct KtKeys<__nv_bfloat16> {
  static constexpr int kKeys = 64;
  static constexpr int kStep = 16;
};
constexpr int kKtWarps = 4;             // warps a key group, 16 rows each
constexpr int kKtRows = 16 * kKtWarps;  // query rows a block
constexpr int kKtThreads = 32 * kKtWarps;

// Key groups a block of kN output tiles a warp may have, as many as its
// registers allow: 4 (512 threads, at most 128 registers a thread: bf16 up
// to 4 tiles, fp32 up to 2), 3 (384 threads, 168: up to 8), else 2.
template <typename T>
__host__ __device__ constexpr int kt_max_groups(int n_tiles) {
  return n_tiles <= (std::is_same<T, float>::value ? 2 : 4) ? 4
         : n_tiles <= 8                                     ? 3
                                                            : 2;
}

// Padded sizes, pitches, copy widths and the ring of one key-tiled launch,
// in elements of the input type. Pitches keep the fragment loads free of
// bank conflicts (Q and K: 4 mod 8 words; V: rows 2 apart in distinct
// banks) and 16-byte copies aligned.
struct KtShape {
  int d_pad;    // D padded to the MMA's k step
  int kc;       // Q / K columns a stage, a multiple of the k step
  int n_kc;     // stages a key tile: ceil(d_pad / kc)
  int d_chunk;  // output columns a block, a multiple of 8
  int groups;   // key groups: 1 to 4 (group g takes the key tiles g, g +
                // groups, ...)
  int q_res;    // 1: the block's Q rows stay in shared memory, all of D;
                // 0: each stage brings its Q columns beside K's
  int ldq;      // Q pitch: d_pad + pad (resident) or kc + pad
  int ldc;      // K chunk pitch: kc + pad
  int ldv;      // V tile pitch
  int n_slots;  // stages in the Q / K ring: 2 or 3
  int slot;     // elements a ring slot: Q chunk (streamed), then each
                // group's K chunk
  int n_vbuf;   // V buffers, each holding every group's V tiles: 1 to 3
  int i_v;      // the stage of a key tile whose group brings its V tiles
  int wq, wk, wv;  // copy width of q, k and v in elements
};

// Floats a thread of groups 1-3 hands group 0 at the end: m, l of its two
// rows and its kN output tiles.
__host__ __device__ constexpr int kt_merge_floats(int n_tiles) {
  return 4 + 4 * n_tiles;
}

template <typename T>
__host__ __device__ __forceinline__ size_t smem_bytes_kt(const KtShape& s,
                                                         int n_tiles) {
  const size_t ring =
      sizeof(T) * ((size_t)(s.q_res ? kKtRows * s.ldq : 0) +
                   (size_t)s.n_slots * s.slot +
                   (size_t)s.n_vbuf * s.groups * KtKeys<T>::kKeys * s.ldv);
  const size_t merge = 4 * (size_t)(s.groups - 1) * kKtThreads *
                       kt_merge_floats(n_tiles);
  return ring > merge ? ring : merge;
}

// Which copies of a staged tile a thread makes: its first (row, copy) and
// the step to its next, for rows of `width` columns starting `e0`
// elements into their w-aligned span. Computed once a block, so that
// staging divides nothing.
struct CopyPlan {
  int per_row, r, c, dr, dc;
};

__device__ __forceinline__ CopyPlan copy_plan(int e0, int width, int w) {
  CopyPlan p;
  p.per_row = (e0 + width + w - 1) / w;
  p.dr = blockDim.x / p.per_row;
  p.dc = blockDim.x - p.dr * p.per_row;
  p.r = threadIdx.x / p.per_row;
  p.c = threadIdx.x - p.r * p.per_row;
  return p;
}

// As stage_rows, for any block size: rows [0, rows_fill) of a tile whose
// w-aligned spans start at `span` (row stride st), the slice `e0`
// elements in; row r < rows takes the slice's columns [0, cols), the rest
// is zero-filled. Each thread walks its copies by the plan.
template <typename T>
__device__ __forceinline__ void stage_kt(T* dst, const T* span, long long st,
                                         int e0, CopyPlan p, int rows,
                                         int rows_fill, int cols, int ld,
                                         int w) {
  int r = p.r, c = p.c;
  while (r < rows_fill) {
    const int j = c * w;  // the copy's first span column
    const int n = r < rows ? max(0, min(w, e0 + cols - j)) : 0;
    const T* from = n > 0 ? span + r * st + j : span;
    if (sizeof(T) == 2 && w == 1)
      *reinterpret_cast<unsigned short*>(dst + r * ld + j) =
          n > 0 ? *reinterpret_cast<const unsigned short*>(from) : 0;
    else
      cp_async_elems(dst + r * ld + j, from, w, n);
    r += p.dr;
    c += p.dc;
    if (c >= p.per_row) {
      c -= p.per_row;
      ++r;
    }
  }
}

// Two neighbouring bf16 values as one 32-bit MMA operand: one 32-bit load,
// or two 16-bit loads where a head slice of odd D starts at an odd element
// (kOdd).
template <bool kOdd>
__device__ __forceinline__ uint32_t ld_op(const __nv_bfloat16* p) {
  if constexpr (kOdd) {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    return (uint32_t)u[0] | ((uint32_t)u[1] << 16);
  } else {
    return ld32(p);
  }
}

// Two fp32 probabilities as bf16 pairs: hi, their bf16 roundings, and lo,
// the bf16 roundings of what is left (x - hi is exact in fp32).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(x0 - __low2float(h2),
                                                  x1 - __high2float(h2));
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// The key-tiled kernel's split TF32: big = tf32(x), rounded as cvt.rna
// rounds; small = x - big, left in fp32 for the tensor core, which reads
// its top 19 bits (a truncation to TF32). Two operations a split fewer
// than split_tf32, at up to twice its error in small (emulated: within
// 1.1e-6 of the plain version at (1,174,1,1512), 1e-5 allowed).
__device__ __forceinline__ void split_kt(float x, uint32_t& big,
                                         uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// load_a_split and mma_split with split_kt
__device__ __forceinline__ void load_a_kt(const float* p, int ld,
                                          uint32_t (&big)[4],
                                          uint32_t (&small)[4]) {
  split_kt(p[0], big[0], small[0]);
  split_kt(p[8 * ld], big[1], small[1]);
  split_kt(p[4], big[2], small[2]);
  split_kt(p[8 * ld + 4], big[3], small[3]);
}

template <int kAcc>
__device__ __forceinline__ void mma_kt(float (&c)[kAcc][4],
                                       const uint32_t (&a_big)[4],
                                       const uint32_t (&a_small)[4],
                                       const float* b, int b_step) {
  uint32_t bb0, bs0, bb1, bs1;
  split_kt(b[0], bb0, bs0);
  split_kt(b[b_step], bb1, bs1);
  mma_tf32(c[kAcc - 1], a_big, bs0, bs1);
  mma_tf32(c[kAcc / 2], a_small, bb0, bb1);
  mma_tf32(c[0], a_big, bb0, bb1);
}

// Grid (B*H, ceil(T/64), n_chunks): a block owns 64 query rows of one
// (batch, head) and one chunk of output columns. Its warps form 1 or 2 key
// groups of 4; group g takes the key tiles j = g (mod groups), and warp w
// of a group owns rows 16w to 16w + 15 and keeps everything of them in
// registers: the logits of one key tile, P, the running row max and sum,
// and its output columns (kN 8-column tiles). One pass over the key tiles:
//   - stage s brings columns [i*kc, i*kc + kc) of K for the groups' next
//     key tiles (i = s % n_kc; Q's too where Q is not resident) into ring
//     slot s % n_slots and, with chunk i_v, their V columns [c0, c0 +
//     d_chunk) into a V buffer of their own, which lands during the
//     tiles' logits: one cp.async group, issued n_slots - 1 stages ahead,
//     one barrier a stage (a stage a tile where K's whole D fits);
//   - a tile's logits (bf16 MMAs accumulating over the chunks; fp32:
//     split TF32, each chunk's sum added into fp32 sums), times scale *
//     log2(e), keys past T masked; the row max across the quad (two
//     shuffles), m' = max(m, it), alpha = 2^(m - m'), P = 2^(s - m'); each
//     lane's sum l = l alpha + its P, the output rescaled by alpha;
//   - P.V straight from the logits' registers: bf16 as hi + lo pairs (the
//     m16n8 C layout of two 8-key tiles is the m16n8k16 A layout); fp32 as
//     split TF32 with the A fragment's key order permuted within each
//     8-key step (column tg is key 2tg, tg + 4 is 2tg + 1: the C layout)
//     and V's rows read in that order, each tile's products added into
//     fp32 sums.
// At the end groups 1-3 hand their (m, l, out) to group 0 through shared
// memory, which merges them in group order (m = max, each side scaled by
// 2^(m_side - m)), sums l across the quad and stores out / l, cast once.
// Every sum is taken in a fixed order.
template <typename T, int kN, bool kOdd>
__global__ void __launch_bounds__(kKtThreads * kt_max_groups<T>(kN))
    attention_kt(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int t_len,
                 int n_head, int d, Strides sq, Strides sk, Strides sv,
                 Strides so, float scale, KtShape sh) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kKeys = KtKeys<T>::kKeys;
  constexpr int kStep = KtKeys<T>::kStep;
  constexpr int kSt = kKeys / 8;  // 8-key MMA tiles of a key tile
  constexpr int kAcc = kF32 ? 2 : 1;  // accumulators of one product tile
  // fp32 folds P.V's products into the output sums kGroup tiles at a time
  constexpr int kGroup = kF32 && kN > 4 ? 4 : kN;
  extern __shared__ __align__(16) unsigned char smem_kt[];
  T* q_res = reinterpret_cast<T*>(smem_kt);  // kKtRows x ldq (q_res)
  T* ring = q_res + (sh.q_res ? kKtRows * sh.ldq : 0);
  T* vring = ring + sh.n_slots * sh.slot;  // n_vbuf x groups V tiles
  const int q_len = sh.q_res ? 0 : kKtRows * sh.ldq;  // a slot's Q chunk
  const int k_len = kKeys * sh.ldc, v_len = kKeys * sh.ldv;

  const int b = blockIdx.x / n_head;
  const int h = blockIdx.x - b * n_head;
  const int t0 = blockIdx.y * kKtRows;
  const int c0 = blockIdx.z * sh.d_chunk;
  const int rows = min(kKtRows, t_len - t0);
  const int grp = threadIdx.x / kKtThreads;  // this warp's key group
  const int warp = (threadIdx.x >> 5) & (kKtWarps - 1);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // MMA fragment row (and column of B / C)
  const int tg = lane & 3;  // MMA fragment column (pair)

  const T* q0 = q + b * sq.b + t0 * sq.t;
  const T* k0 = k + b * sk.b;
  const T* v0 = v + b * sv.b;
  const long long qo = h * sq.h, ko = h * sk.h, vo = h * sv.h + c0;
  const int eq = (int)(qo % sh.wq), ek = (int)(ko % sh.wk),
            ev = (int)(vo % sh.wv);
  const int n_kt = (t_len + kKeys - 1) / kKeys;
  const int n_stages = (n_kt + sh.groups - 1) / sh.groups * sh.n_kc;
  const int n_out = sh.d_chunk / 8;
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)

  // copy plans: Q and K chunks (all but the last, and the last, which may
  // be narrower), V tiles, resident Q
  const int last_w = sh.d_pad - (sh.n_kc - 1) * sh.kc;
  const CopyPlan pq = copy_plan(eq, sh.kc, sh.wq);
  const CopyPlan pq_last = copy_plan(eq, last_w, sh.wq);
  const CopyPlan pk = copy_plan(ek, sh.kc, sh.wk);
  const CopyPlan pk_last = copy_plan(ek, last_w, sh.wk);
  const CopyPlan pv = copy_plan(ev, sh.d_chunk, sh.wv);
  // the w-aligned spans of this block's Q rows, the head's K and V rows
  const T* q_span = q0 + (qo - eq);
  const T* k_span = k0 + (ko - ek);
  const T* v_span = v0 + (vo - ev);

  // One cp.async group a stage (an empty one past the last); keys and
  // query rows past T and D's padding are zero-filled. Chunks start at
  // multiples of 8 columns, so a slice's place in its span is the same in
  // every chunk.
  int next = 0, n_jj = 0, n_i = 0, n_slot = 0, n_vb = 0;  // the next stage
  auto issue = [&]() {
    const bool copy = next < n_stages;
    if (copy) {
      const int jj = n_jj, i = n_i;
      T* slot = ring + n_slot * sh.slot;
      const int c = i * sh.kc;
      const int cols = min(sh.kc, d - c);
      const bool last = i == sh.n_kc - 1;
      if (!sh.q_res)
        stage_kt(slot, q_span + c, sq.t, eq, last ? pq_last : pq, rows,
                 kKtRows, cols, sh.ldq, sh.wq);
      for (int gi = 0; gi < sh.groups; ++gi) {
        const int key0 = (jj * sh.groups + gi) * kKeys;
        if (key0 >= t_len) break;
        const int keys = min(kKeys, t_len - key0);
        stage_kt(slot + q_len + gi * k_len, k_span + key0 * sk.t + c, sk.t,
                 ek, last ? pk_last : pk, keys, kKeys, cols, sh.ldc, sh.wk);
        if (i == sh.i_v)
          stage_kt(vring + (n_vb * sh.groups + gi) * v_len,
                   v_span + key0 * sv.t, sv.t, ev, pv, keys, kKeys,
                   min(sh.d_chunk, d - c0), sh.ldv, sh.wv);
      }
    }
    cp_async_commit();
    ++next;
    if (++n_slot == sh.n_slots) n_slot = 0;
    if (++n_i == sh.n_kc) {
      n_i = 0;
      ++n_jj;
      if (++n_vb == sh.n_vbuf) n_vb = 0;
    }
  };

  if (sh.q_res)  // the block's Q rows, all of D, in stage 0's group
    stage_kt(q_res, q_span, sq.t, eq, copy_plan(eq, sh.d_pad, sh.wq), rows,
             kKtRows, d, sh.ldq, sh.wq);
  for (int s = 0; s + 1 < sh.n_slots; ++s) issue();

  float acc[kSt][kAcc][4];        // this warp's logits of the key tile
  float xs[kF32 ? kSt : 1][4];    // fp32: the chunks' logits, summed
  float oacc[kN][4];              // this warp's output columns
#pragma unroll
  for (int t = 0; t < kN; ++t)
    oacc[t][0] = oacc[t][1] = oacc[t][2] = oacc[t][3] = 0.f;
  // running row max (log2 units), rows g and g + 8, and the running sums
  // over this lane's keys
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int qrow = warp * 16 + g;

  // stage s is key tiles jj * groups + (0, 1, ...), chunk i, ring slot
  // s % n_slots, V buffer jj % n_vbuf: counted, not divided
  int jj = 0, i = -1, s_slot = -1, vb = 0;
  for (int s = 0; s < n_stages; ++s) {
    if (++s_slot == sh.n_slots) s_slot = 0;
    if (++i == sh.n_kc) {
      i = 0;
      ++jj;
      if (++vb == sh.n_vbuf) vb = 0;
    }
    cp_async_wait_upto(sh.n_slots - 2);  // stage s has landed
    __syncthreads();  // ... for every thread; stage s - 1's slot is free
    issue();          // stage s + n_slots - 1
    const int j = jj * sh.groups + grp;  // this group's key tile
    if (j >= n_kt) continue;             // (a group's last stages)
    const T* slot = ring + s_slot * sh.slot;
    const int width = min(sh.kc, sh.d_pad - i * sh.kc);

    // ---- this stage's columns of the key tile's logits
    if (kF32 || i == 0) {
#pragma unroll
      for (int e = 0; e < kSt * kAcc * 4; ++e)
        acc[e / (kAcc * 4)][e / 4 % kAcc][e % 4] = 0.f;
    }
    const T* qa = (sh.q_res ? q_res + i * sh.kc : slot) + qrow * sh.ldq +
                  eq + (kF32 ? tg : 2 * tg);
    const T* kb =
        slot + q_len + grp * k_len + g * sh.ldc + ek + (kF32 ? tg : 2 * tg);
    for (int kk = 0; kk < width; kk += kStep) {
      if constexpr (kF32) {
        uint32_t a_big[4], a_small[4];
        load_a_kt(qa + kk, sh.ldq, a_big, a_small);
        // B fragment: K[key n*8 + g][columns kk + tg, kk + tg + 4]
#pragma unroll
        for (int n = 0; n < kSt; ++n)
          mma_kt<kAcc>(acc[n], a_big, a_small, kb + n * 8 * sh.ldc + kk, 4);
      } else {
        const uint32_t a[4] = {
            ld_op<kOdd>(qa + kk), ld_op<kOdd>(qa + 8 * sh.ldq + kk),
            ld_op<kOdd>(qa + kk + 8), ld_op<kOdd>(qa + 8 * sh.ldq + kk + 8)};
#pragma unroll
        for (int n = 0; n < kSt; ++n) {
          const T* kr = kb + n * 8 * sh.ldc + kk;
          mma_bf16(acc[n][0], a, ld_op<kOdd>(kr), ld_op<kOdd>(kr + 8));
        }
      }
    }
    if constexpr (kF32) {
#pragma unroll
      for (int n = 0; n < kSt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float part = split_sum<kAcc>(acc[n], e);
          xs[n][e] = i == 0 ? part : xs[n][e] + part;
        }
    }
    if (i < sh.n_kc - 1) continue;

    // ---- the tile's logits are complete: scale, mask the keys past T,
    // update the running max (the quad holds the tile's keys of a row)
    float x[kSt][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kSt; ++n) {
      const int key = j * kKeys + n * 8 + 2 * tg;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float raw;
        if constexpr (kF32)
          raw = xs[n][e];
        else
          raw = acc[n][0][e];
        x[n][e] = key + (e & 1) < t_len ? raw * sl2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(x[n][0], x[n][1]));
      mx1 = fmaxf(mx1, fmaxf(x[n][2], x[n][3]));
    }
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds a key below T, so the new max is finite: alpha is
    // 2^-inf = 0 at a group's first tile, never 2^(-inf - -inf)
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kSt; ++n) {
      x[n][0] = exp2f(x[n][0] - mn0);
      x[n][1] = exp2f(x[n][1] - mn0);
      x[n][2] = exp2f(x[n][2] - mn1);
      x[n][3] = exp2f(x[n][3] - mn1);
      ps0 += x[n][0] + x[n][1];
      ps1 += x[n][2] + x[n][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      oacc[t][0] *= al0;
      oacc[t][1] *= al0;
      oacc[t][2] *= al1;
      oacc[t][3] *= al1;
    }

    // ---- P.V over the tile's keys into this warp's output columns
    const T* vt = vring + (vb * sh.groups + grp) * v_len;
#pragma unroll
    for (int t0g = 0; t0g < kN; t0g += kGroup) {
      float cc[kF32 ? kGroup : 1][kAcc][4];  // fp32: this tile's products
      if constexpr (kF32) {
#pragma unroll
        for (int e = 0; e < kGroup * kAcc * 4; ++e)
          cc[e / (kAcc * 4)][e / 4 % kAcc][e % 4] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kKeys; ks += kStep) {
        const int st = ks / 8;  // the step's first 8-key MMA tile
        if constexpr (kF32) {
          // A: rows g, g + 8; column tg is key 2tg, column tg + 4 is key
          // 2tg + 1 of the step
          uint32_t a_big[4], a_small[4];
          split_kt(x[st][0], a_big[0], a_small[0]);
          split_kt(x[st][2], a_big[1], a_small[1]);
          split_kt(x[st][1], a_big[2], a_small[2]);
          split_kt(x[st][3], a_big[3], a_small[3]);
          // B: V[keys ks + 2tg, ks + 2tg + 1][column tile*8 + g]
          const float* vb = vt + ev + (ks + 2 * tg) * sh.ldv + g;
#pragma unroll
          for (int t = 0; t < kGroup; ++t)
            if (t0g + t < n_out)
              mma_kt<kAcc>(cc[t], a_big, a_small, vb + (t0g + t) * 8,
                           sh.ldv);
        } else {
          // A: rows g, g + 8; keys 2tg, 2tg + 1 and 2tg + 8, 2tg + 9
          uint32_t hi[4], lo[4];
          split_pair(x[st][0], x[st][1], hi[0], lo[0]);
          split_pair(x[st][2], x[st][3], hi[1], lo[1]);
          split_pair(x[st + 1][0], x[st + 1][1], hi[2], lo[2]);
          split_pair(x[st + 1][2], x[st + 1][3], hi[3], lo[3]);
          // B: V[keys ks + 2tg + {0, 1, 8, 9}][column tile*8 + g]
          const unsigned short* vb =
              reinterpret_cast<const unsigned short*>(vt) + ev +
              (ks + 2 * tg) * sh.ldv + g;
#pragma unroll
          for (int t = 0; t < kGroup; ++t)
            if (t0g + t < n_out) {
              const unsigned short* vc = vb + (t0g + t) * 8;
              const uint32_t b0 = vc[0] | ((uint32_t)vc[sh.ldv] << 16);
              const uint32_t b1 =
                  vc[8 * sh.ldv] | ((uint32_t)vc[9 * sh.ldv] << 16);
              mma_bf16(oacc[t0g + t], lo, b0, b1);
              mma_bf16(oacc[t0g + t], hi, b0, b1);
            }
        }
      }
      if constexpr (kF32) {
#pragma unroll
        for (int t = 0; t < kGroup; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oacc[t0g + t][e] += split_sum<kAcc>(cc[t], e);
      }
    }
  }

  // ---- groups 1-3's (m, l, out) into group 0's, in group order, through
  // shared memory over the ring (a thread of group g holds the same rows
  // and fragment places as its counterpart in group 0)
  if (sh.groups > 1) {
    cp_async_wait<0>();
    __syncthreads();  // every stage consumed: the ring is free
    float* side = reinterpret_cast<float*>(smem_kt) +
                  (threadIdx.x & (kKtThreads - 1)) * kt_merge_floats(kN);
    constexpr int kSide = kKtThreads * kt_merge_floats(kN);
    if (grp > 0) {
      float* mine = side + (grp - 1) * kSide;
      mine[0] = m0;
      mine[1] = m1;
      mine[2] = l0;
      mine[3] = l1;
#pragma unroll
      for (int t = 0; t < kN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[4 + 4 * t + e] = oacc[t][e];
    }
    __syncthreads();
    if (grp > 0) return;
    // group 0 has tile 0, so m0, m1 stay finite; another group's are -inf
    // where it had no tile, and its side then weighs 2^-inf = 0
    for (int gi = 1; gi < sh.groups; ++gi) {
      const float* other = side + (gi - 1) * kSide;
      const float mo0 = other[0], mo1 = other[1];
      const float mn0 = fmaxf(m0, mo0), mn1 = fmaxf(m1, mo1);
      const float a0 = exp2f(m0 - mn0), b0 = exp2f(mo0 - mn0);
      const float a1 = exp2f(m1 - mn1), b1 = exp2f(mo1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 = l0 * a0 + other[2] * b0;
      l1 = l1 * a1 + other[3] * b1;
#pragma unroll
      for (int t = 0; t < kN; ++t) {
        oacc[t][0] = oacc[t][0] * a0 + other[4 + 4 * t] * b0;
        oacc[t][1] = oacc[t][1] * a0 + other[5 + 4 * t] * b0;
        oacc[t][2] = oacc[t][2] * a1 + other[6 + 4 * t] * b1;
        oacc[t][3] = oacc[t][3] * a1 + other[7 + 4 * t] * b1;
      }
    }
  }

  // ---- out = sums / l, the row's l summed across the quad; one cast at
  // the store, element by element (any D, any output strides)
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  T* ob = o + b * so.b + h * so.h + t0 * so.t;
  auto store = [&](int r, int col, float val) {
    if (r < rows && col < d) {
      if constexpr (kF32)
        ob[r * so.t + col] = val;
      else
        ob[r * so.t + col] = __float2bfloat16_rn(val);
    }
  };
#pragma unroll
  for (int t = 0; t < kN; ++t) {
    if (t < n_out) {
      const int col = c0 + t * 8 + 2 * tg;
      store(qrow, col, oacc[t][0] / l0);
      store(qrow, col + 1, oacc[t][1] / l0);
      store(qrow + 8, col, oacc[t][2] / l1);
      store(qrow + 8, col + 1, oacc[t][3] / l1);
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

// The padded sizes and pitches of launch_bf16 that do not depend on the
// column chunk; returns the widest chunk of V columns that fits in shared
// memory beside Q, K, P and the reductions (under 8: K does not fit).
long long tc_room(int t_len, int d, TcShape& sh) {
  sh.t_pad = round_up(t_len, 16);
  sh.d_pad = round_up(d, 16);
  sh.ldk = sh.d_pad + 8;
  sh.ldp = sh.t_pad + 8;
  sh.ldv = 8;
  const long long fixed = (long long)smem_bytes_tc(sh) - 2LL * sh.t_pad * 8;
  return (kSmemMax - fixed) / (2LL * sh.t_pad) - 8;
}

cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, __nv_bfloat16* o, int batch,
                        int t_len, int n_head, int d, Strides sq, Strides sk,
                        Strides sv, Strides so, float scale, int dev,
                        cudaStream_t stream) {
  if (d % 2 != 0) return cudaErrorInvalidValue;
  TcShape sh;
  const long long room = tc_room(t_len, d, sh);
  if (room < 8) return cudaErrorInvalidValue;  // K does not fit
  const int max_chunk =
      (int)(room < kResidentMaxD ? room : kResidentMaxD) / 8 * 8;
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

// Copy width in elements of one tensor (16, 8, 4 or 2 bytes; 4 bytes at
// least for fp32): the widest to which every row start is aligned (the
// data pointer, and the batch and row strides where there is more than
// one batch or row).
template <typename T>
int copy_width(const void* p, const Strides& s, int batch, int t_len) {
  for (int w = 16 / (int)sizeof(T); w > 1; w >>= 1)
    if (reinterpret_cast<uintptr_t>(p) % (sizeof(T) * w) == 0 &&
        (batch == 1 || s.b % w == 0) && (t_len == 1 || s.t % w == 0))
      return w;
  return 1;
}

// Pitches and the K chunk buffers' size (double-buffered when D takes
// more than one chunk; P reuses them, so they are at least P's size).
void f32_layout(F32Shape& s) {
  s.ldc = s.kc + 4;
  s.ldv = round_up(s.d_chunk, 16) + 8;
  const int bufs = (s.d_pad > s.kc ? 2 : 1) * (kQTile + s.t_pad) * s.ldc;
  const int p = kQTile * s.ldp;
  s.v_off = bufs > p ? bufs : p;
}

template <int kTiles, int kTasks>
cudaError_t launch_tc_f32(const float* q, const float* k, const float* v,
                          float* o, int t_len, int n_head, int d, Strides sq,
                          Strides sk, Strides sv, Strides so, float scale,
                          const F32Shape& sh, dim3 grid, int dev,
                          cudaStream_t stream) {
  static unsigned long long raised = 0;
  const cudaError_t err =
      raise_smem(attention_tc_f32<kTiles, kTasks>, &raised, dev, kSmemMax);
  if (err != cudaSuccess) return err;
  attention_tc_f32<kTiles, kTasks>
      <<<grid, kTcThreads, smem_bytes_f32(sh), stream>>>(
          q, k, v, o, t_len, n_head, d, sq, sk, sv, so, scale, sh);
  return cudaGetLastError();
}

// kTasks = 2 up to 16 P.V tasks (128 output columns per block), else
// kMaxTasks
template <int kTiles>
cudaError_t launch_tiles_f32(const float* q, const float* k, const float* v,
                             float* o, int t_len, int n_head, int d,
                             Strides sq, Strides sk, Strides sv, Strides so,
                             float scale, const F32Shape& sh, dim3 grid,
                             int dev, cudaStream_t stream) {
  if (sh.d_chunk / 8 * sh.k_groups <= 2 * kTcWarps)
    return launch_tc_f32<kTiles, 2>(q, k, v, o, t_len, n_head, d, sq, sk, sv,
                                    so, scale, sh, grid, dev, stream);
  return launch_tc_f32<kTiles, kMaxTasks>(q, k, v, o, t_len, n_head, d, sq,
                                          sk, sv, so, scale, sh, grid, dev,
                                          stream);
}

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* o, int batch, int t_len, int n_head, int d,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int dev, cudaStream_t stream) {
  F32Shape sh;
  sh.t_pad = round_up(t_len, 8);
  sh.d_pad = round_up(d, 8);
  sh.ldp = sh.t_pad + 4;
  sh.wq = copy_width<float>(q, sq, batch, t_len);
  sh.wk = copy_width<float>(k, sk, batch, t_len);
  sh.wv = copy_width<float>(v, sv, batch, t_len);
  // as many column chunks as keep the grid within one block per SM: a
  // block's registers leave no room for a second one, so where
  // launch_bf16 rounds up, a grid past the SM count would run a second
  // wave (176 blocks at (4,174,2,D))
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int base = batch * n_head * ceil_div(t_len, kQTile);
  int n_chunks = sms / base;
  n_chunks = n_chunks < 1 ? 1
                          : (n_chunks > sh.d_pad / 8 ? sh.d_pad / 8 : n_chunks);
  sh.d_chunk = round_up(ceil_div(sh.d_pad, n_chunks), 8);
  n_chunks = ceil_div(sh.d_pad, sh.d_chunk);
  const int n_out_tiles = sh.d_chunk / 8;
  sh.k_groups = n_out_tiles >= kTcWarps ? 1 : kTcWarps / n_out_tiles;
  // 64-column K chunks and V resident; until the block fits in shared
  // memory, K chunks down to 16 columns, then V in chunks of fewer keys,
  // then K chunks of 8 columns (T = 1024 fits at any D with 16 and 8)
  sh.kc = sh.d_pad < 64 ? sh.d_pad : 64;
  sh.kv = sh.t_pad;
  for (f32_layout(sh); smem_bytes_f32(sh) > (size_t)kSmemMax;
       f32_layout(sh)) {
    const int kv = round_up(sh.kv / 2, 8 * sh.k_groups);
    if (sh.kc > 16)
      sh.kc = round_up(sh.kc / 2, 8);
    else if (kv < sh.kv)
      sh.kv = kv;
    else if (sh.kc > 8)
      sh.kc = 8;
    else
      return cudaErrorInvalidValue;
  }

  const dim3 grid(batch * n_head, ceil_div(t_len, kQTile), n_chunks);
  const int tiles = ceil_div(sh.t_pad / 8, kTcWarps);
  if (tiles <= 1)
    return launch_tiles_f32<1>(q, k, v, o, t_len, n_head, d, sq, sk, sv, so,
                               scale, sh, grid, dev, stream);
  if (tiles <= 2)
    return launch_tiles_f32<2>(q, k, v, o, t_len, n_head, d, sq, sk, sv, so,
                               scale, sh, grid, dev, stream);
  if (tiles <= 3)
    return launch_tiles_f32<3>(q, k, v, o, t_len, n_head, d, sq, sk, sv, so,
                               scale, sh, grid, dev, stream);
  if (tiles <= 4)
    return launch_tiles_f32<4>(q, k, v, o, t_len, n_head, d, sq, sk, sv, so,
                               scale, sh, grid, dev, stream);
  if (tiles <= 8)
    return launch_tiles_f32<8>(q, k, v, o, t_len, n_head, d, sq, sk, sv, so,
                               scale, sh, grid, dev, stream);
  return launch_tiles_f32<kMaxKeyTiles>(q, k, v, o, t_len, n_head, d, sq, sk,
                                        sv, so, scale, sh, grid, dev, stream);
}

// kN: the fewest 8-column output tiles a warp (2, 4, 8, 16 or 24) that
// hold `tiles`.
int kt_tiles(int tiles) {
  return tiles <= 2 ? 2 : tiles <= 4 ? 4 : tiles <= 8 ? 8 : tiles <= 16 ? 16
                                                                        : 24;
}

// The key-tiled kernel's shared memory, among the layouts that fit a
// block: the fewest stages a key tile (K chunks as wide as fit: all of D
// where they can, one barrier a tile), then Q resident over Q streamed,
// then three ring slots over two. False where nothing fits. (A block's
// registers leave no room for a second one on its SM.)
template <typename T>
bool kt_layout(KtShape& s, int n_tiles) {
  constexpr int step = KtKeys<T>::kStep, keys = KtKeys<T>::kKeys;
  constexpr int pad = std::is_same<T, float>::value ? 4 : 8;
  KtShape best = s;
  long long best_key = -1;
  for (int q_res = 1; q_res >= 0; --q_res)
    for (int kc = s.d_pad;; kc = round_up(kc / 2, step)) {
      for (int slots = 3; slots >= 2; --slots) {
        KtShape c = s;
        c.kc = kc;
        c.n_kc = ceil_div(s.d_pad, kc);
        c.q_res = q_res;
        c.ldc = kc + pad;
        c.ldq = q_res ? s.d_pad + pad : c.ldc;
        c.n_slots = slots;
        c.slot = (q_res ? 0 : kKtRows * c.ldq) + s.groups * keys * c.ldc;
        // V tiles j + n_vbuf go out with stage i_v of their tile, n_slots
        // - 1 stages ahead, so after tile j's last stage only where
        // (n_vbuf - 1) * n_kc + i_v > n_slots - 2: one buffer, issued
        // with stage n_slots - 1, where a tile has that many stages; else
        // with stage 0 into 2 buffers, or 3 (one-stage tiles, 3 slots)
        c.n_vbuf = c.n_kc >= slots ? 1 : c.n_kc >= slots - 1 ? 2 : 3;
        c.i_v = c.n_vbuf == 1 ? slots - 1 : 0;
        const size_t bytes = smem_bytes_kt<T>(c, n_tiles);
        if (bytes > (size_t)kSmemMax) continue;
        // smaller is better: stages a tile, Q streamed, two slots
        const long long key =
            (long long)c.n_kc * 4 + (1 - q_res) * 2 + (slots == 2);
        if (best_key < 0 || key < best_key) {
          best_key = key;
          best = c;
        }
      }
      if (kc <= step) break;
    }
  if (best_key < 0) return false;
  s = best;
  return true;
}

template <typename T, int kN, bool kOdd>
cudaError_t launch_kt_n(const T* q, const T* k, const T* v, T* o, int t_len,
                        int n_head, int d, Strides sq, Strides sk, Strides sv,
                        Strides so, float scale, const KtShape& sh, dim3 grid,
                        int dev, cudaStream_t stream) {
  static unsigned long long raised = 0;
  const cudaError_t err =
      raise_smem(attention_kt<T, kN, kOdd>, &raised, dev, kSmemMax);
  if (err != cudaSuccess) return err;
  attention_kt<T, kN, kOdd>
      <<<grid, kKtThreads * sh.groups, smem_bytes_kt<T>(sh, kN), stream>>>(
          q, k, v, o, t_len, n_head, d, sq, sk, sv, so, scale, sh);
  return cudaGetLastError();
}

template <typename T, bool kOdd>
cudaError_t launch_kt_odd(const T* q, const T* k, const T* v, T* o,
                          int t_len, int n_head, int d, Strides sq,
                          Strides sk, Strides sv, Strides so, float scale,
                          const KtShape& sh, int n_tiles, dim3 grid, int dev,
                          cudaStream_t stream) {
  if (n_tiles == 2)
    return launch_kt_n<T, 2, kOdd>(q, k, v, o, t_len, n_head, d, sq, sk, sv,
                                   so, scale, sh, grid, dev, stream);
  if (n_tiles == 4)
    return launch_kt_n<T, 4, kOdd>(q, k, v, o, t_len, n_head, d, sq, sk, sv,
                                   so, scale, sh, grid, dev, stream);
  if (n_tiles == 8)
    return launch_kt_n<T, 8, kOdd>(q, k, v, o, t_len, n_head, d, sq, sk, sv,
                                   so, scale, sh, grid, dev, stream);
  if (n_tiles == 16)
    return launch_kt_n<T, 16, kOdd>(q, k, v, o, t_len, n_head, d, sq, sk, sv,
                                    so, scale, sh, grid, dev, stream);
  return launch_kt_n<T, 24, kOdd>(q, k, v, o, t_len, n_head, d, sq, sk, sv,
                                  so, scale, sh, grid, dev, stream);
}

// Whether a tensor's head slices may start at an odd element of its copy
// span (bf16 of odd head stride, copied more than one element at a time).
bool odd_slices(const Strides& s, int n_head, int w) {
  return w > 1 && n_head > 1 && s.h % 2 != 0;
}

template <typename T>
cudaError_t launch_kt(const T* q, const T* k, const T* v, T* o, int batch,
                      int t_len, int n_head, int d, Strides sq, Strides sk,
                      Strides sv, Strides so, float scale, int dev,
                      cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int max_tiles = 24;  // output tiles a warp at most
  KtShape sh;
  sh.d_pad = round_up(d, KtKeys<T>::kStep);
  sh.wq = copy_width<T>(q, sq, batch, t_len);
  sh.wk = copy_width<T>(k, sk, batch, t_len);
  sh.wv = copy_width<T>(v, sv, batch, t_len);
  // the fewest column chunks whose accumulators fit a warp's registers;
  // more, down to 8 columns, while the grid would leave a tenth of the
  // card's SMs without a block (each chunk computes the logits again)
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = ceil_div(d, 8);
  const long long rows = ceil_div(t_len, kKtRows);
  const long long base = (long long)batch * n_head * rows;
  long long n_chunks = (tiles + max_tiles - 1) / max_tiles;
  const long long fill = (sms * 9 / 10 + base - 1) / base;
  if (fill > n_chunks) n_chunks = fill < tiles ? fill : tiles;
  sh.d_chunk = (int)((tiles + n_chunks - 1) / n_chunks) * 8;
  n_chunks = (8 * tiles + sh.d_chunk - 1) / sh.d_chunk;
  sh.ldv = f32 ? round_up(sh.d_chunk, 16) + 4 : round_up(sh.d_chunk, 32) + 8;
  const int n_tiles = kt_tiles(sh.d_chunk / 8);
  // key groups: as many as the kernel's registers allow and the key tiles
  // fill, fewer where their stages do not fit
  const int n_kt = ceil_div(t_len, KtKeys<T>::kKeys);
  sh.groups = kt_max_groups<T>(n_tiles);
  if (sh.groups > n_kt) sh.groups = n_kt;
  while (!kt_layout<T>(sh, n_tiles))
    if (--sh.groups < 1) return cudaErrorInvalidValue;
  // the grid's limits: 2^31 - 1 blocks along x, 65535 along y and z
  if ((long long)batch * n_head > 2147483647LL || rows > 65535 ||
      n_chunks > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(batch * n_head, (unsigned)rows, (unsigned)n_chunks);
  if constexpr (!f32) {
    if (odd_slices(sq, n_head, sh.wq) || odd_slices(sk, n_head, sh.wk))
      return launch_kt_odd<T, true>(q, k, v, o, t_len, n_head, d, sq, sk, sv,
                                    so, scale, sh, n_tiles, grid, dev,
                                    stream);
  }
  return launch_kt_odd<T, false>(q, k, v, o, t_len, n_head, d, sq, sk, sv,
                                 so, scale, sh, n_tiles, grid, dev, stream);
}

// Row starts and strides the resident-K bf16 kernel reads: 16-byte
// aligned rows (batch and row strides multiples of 8 elements), an even
// head stride; the output stored as bf16 pairs.
bool bf16_rows_readable(const void* p, const Strides& s, int batch,
                        int t_len, int align, int mult) {
  return reinterpret_cast<uintptr_t>(p) % align == 0 && s.h % 2 == 0 &&
         (batch == 1 || s.b % mult == 0) && (t_len == 1 || s.t % mult == 0);
}

}  // namespace

extern "C" {

// One call's arguments, packed by the wrapper (ops/attention.py) in this
// order. Strides are in elements, for (b, t, h); the D stride must be 1
// (the wrapper copies a tensor whose D stride is not). dtype: 0 =
// float32, 1 = bfloat16. force: 0 = the rule in the header, 1 = the
// key-tiled kernel at any shape, 2 = the resident kernels wherever they
// take the shape (for measuring the kernels against each other).
struct AttentionArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st,
      o_sh;
  int batch, t_len, n_head, d, dtype, force;
};

// The dispatch rule (header): 1 = the resident kernels; 2 = key-tiled,
// which alone takes the shape; 3 = key-tiled, faster where the resident
// kernels take it too; -1 for arguments no kernel takes. The resident
// kernels' domain: T <= 1024 and D <= 512; bf16 also an even D, K within
// shared memory and rows the kernel reads.
int tf_attention_route(const AttentionArgs* a) {
  const int batch = a->batch, t_len = a->t_len, d = a->d;
  if (batch < 1 || a->n_head < 1 || t_len < 1 || d < 1 ||
      (a->dtype != 0 && a->dtype != 1))
    return -1;
  if (t_len > kResidentMaxT || d > kResidentMaxD) return 2;
  if (a->dtype == 1) {
    const Strides sq{a->q_sb, a->q_st, a->q_sh},
        sk{a->k_sb, a->k_st, a->k_sh}, sv{a->v_sb, a->v_st, a->v_sh},
        so{a->o_sb, a->o_st, a->o_sh};
    TcShape unused;
    const bool resident =
        d % 2 == 0 && tc_room(t_len, d, unused) >= 8 &&
        bf16_rows_readable(a->q, sq, batch, t_len, 16, 8) &&
        bf16_rows_readable(a->k, sk, batch, t_len, 16, 8) &&
        bf16_rows_readable(a->v, sv, batch, t_len, 16, 8) &&
        bf16_rows_readable(a->o, so, batch, t_len, 4, 2);
    if (!resident) return 2;
  }
  // the key-tiled kernel where it ran faster at the shapes both take
  // (header): T above 384 (but fp32 at D above 384), and fp32 at D of 144
  // and more over 8 or more (batch, head) pairs
  const bool long_t = t_len > kKtMinT && (a->dtype == 1 || d <= kKtMaxF32D);
  const bool wide_f32 =
      a->dtype == 0 && (long long)batch * a->n_head >= 8 && d >= 144;
  return long_t || wide_f32 ? 3 : 1;
}

// Returns a cudaError_t (0 = launched).
int tf_attention_forward(const AttentionArgs* a, void* stream) {
  const int batch = a->batch, t_len = a->t_len, n_head = a->n_head, d = a->d;
  const int rule = tf_attention_route(a);
  if (rule < 0 || (a->force == 2 && rule == 2))
    return (int)cudaErrorInvalidValue;
  const bool resident = a->force == 2 || (rule == 1 && a->force == 0);
  const Strides sq{a->q_sb, a->q_st, a->q_sh}, sk{a->k_sb, a->k_st, a->k_sh},
      sv{a->v_sb, a->v_st, a->v_sh}, so{a->o_sb, a->o_st, a->o_sh};
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = a->dtype == 0;
  if (f32) {
    const float *q = static_cast<const float*>(a->q),
                *k = static_cast<const float*>(a->k),
                *v = static_cast<const float*>(a->v);
    float* o = static_cast<float*>(a->o);
    return (int)(resident ? launch_f32(q, k, v, o, batch, t_len, n_head, d,
                                       sq, sk, sv, so, scale, dev, s)
                          : launch_kt<float>(q, k, v, o, batch, t_len, n_head,
                                             d, sq, sk, sv, so, scale, dev,
                                             s));
  }
  const __nv_bfloat16 *q = static_cast<const __nv_bfloat16*>(a->q),
                      *k = static_cast<const __nv_bfloat16*>(a->k),
                      *v = static_cast<const __nv_bfloat16*>(a->v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a->o);
  return (int)(resident ? launch_bf16(q, k, v, o, batch, t_len, n_head, d, sq,
                                      sk, sv, so, scale, dev, s)
                        : launch_kt<__nv_bfloat16>(q, k, v, o, batch, t_len,
                                                   n_head, d, sq, sk, sv, so,
                                                   scale, dev, s));
}

}  // extern "C"
