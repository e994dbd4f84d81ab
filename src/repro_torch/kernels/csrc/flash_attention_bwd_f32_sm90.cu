// Flash-attention backward for Hopper tensor cores (3xTF32 wgmma + TMA),
// f32.
//
// The JAX package has no Pallas counterpart: it trains through its
// pure-JAX chunked attention (src/repro/models/attention.py:26,
// flash_attention) and lets jax.grad differentiate it.  The port's f32
// forward is flash_attention_f32_sm90.cu, and this file computes the
// gradient of the function it computes, the one ref.flash_attention_bwd_ref
// defines for f32, with FlashAttention-2's formula, from q, k, v, the
// forward's output o, its row statistic lse = m + log(l) and dO:
//
//   qs   = f32(q * f32(D^-1/2))                (the forward's scaled q)
//   S    = qs k^T, masked where key >= S_len or, causal, key > query
//          (aligned at the top left), or key <= query - window with a
//          window
//   P    = exp(S - lse), 0 where masked
//   dV   = P^T dO,  dP = dO v^T
//   Drow = rowsum(P * dP)                       (= rowsum(dO * O))
//   dS   = P (dP - Drow)
//   dK   = dS^T qs,  dQ = scale * dS k
//
// Drow is summed from the kernel's own P and dP, not from the forward's O
// (FlashAttention-2's rowsum(dO * O), the plain version's): dP - Drow
// cancels where a row's attention is spread over keys whose values are
// nearly alike (whisper-small's encoder at random weights, 1500 frames),
// and there the forward's 3xTF32 output, within ~3e-6 of the plain one,
// put the kernels' dQ ~1% of max|g| from the f64 gradient, 50x the plain
// path's error at one leaf (chip_smoke.py phase 3p); from P and dP the
// row's common error cancels in dP - Drow.
//
// q, o, dO, dq (B, T, H, D); k, v, dk, dv (B, S, HK, D); all f32; lse
// (B, H, T) f32; D in {16, 32, 64, 112, 128}, H % HK == 0, ragged T and S.
// Within 2e-5 max|g| of the plain version, not bitwise: the f32 sums run
// in another order.  Head dim 112 runs D = 128 instances compiled for a
// true width of 112 (HD; D = 128 keeps its own): the
// preprocess reads the inputs at their true width and writes its scratch
// 128 columns wide, zeros past 112 (exact zeros in every product), and
// the stores stop at 112.  With a window (``window`` > 0) the dQ kernel
// starts at its first key tile inside its first query's window and the
// dK / dV kernel stops at the last query tile that sees its last key;
// masked keys take P = 0.  The bf16 gradient is flash_attention_bwd_sm90.cu.
//
// 3xTF32, as the f32 forward: every operand x is split as hi =
// cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x - hi), and every 8-deep
// k-step issues three wgmma into one f32 accumulator, lo.hi, hi.lo, hi.hi
// (lo.lo dropped).  One TF32 product is about 1e-3 off at D = 64, far over
// the bar (tests/test_torch_flash_attention.py,
// test_one_tf32_product_misses_the_backward_bar).
//
// What bounds it on this card: operations.  The gradient needs 2.5x the
// forward's products (4 B H T S D / 2 FLOPs causal): 85.9 GFLOP at
// (4, 2048, 16, 64), three TF32 products each at 495 TFLOP/s = 0.52 ms,
// against 0.08 ms to move its tensors once at 3.35 TB/s.  This design runs
// 7 tile-products where the bound counts 5 (S and dP in both kernels): its
// floor is 1.4x the bound, and the Drow pass adds S and dP once more.
// Four launches:
//   * preprocess (fa_bwd_f32_prep_kernel): one pass over q, dO, k and
//     v, 32 rows of one head a block; writes lse log2(e) and Drow's zeros
//     as (B, H, T_pad) f32 (T_pad: T rounded up to 128, zeros past T), and
//     every operand the products read, already split into TF32 hi and lo
//     (stored as batches b and B + b of one tensor, so one tensor map
//     serves both): qs, dO, k, v as they lie, and qs^T, dO^T (B, H, D,
//     T_pad) and k^T (B, HK, D, S_pad), zeros past T or S.  TF32 wgmma
//     takes only K-major operands (no transpose bit for tf32), and three of
//     the five products have an MN-major B operand as the tensors lie: dQ
//     += dS k needs k^T, dV += P^T dO needs dO^T, dK += dS^T qs needs qs^T.
//     Writing them here (through shared memory, coalesced both ways) keeps
//     the product kernels to TMA loads and wgmma, where a transposing split
//     pass in shared memory (the f32 forward's V^T) would take their
//     threads or a producer warpgroup.  Within each 8-group of queries or
//     keys the transposed copies hold the order TF32_KEY_ORDER (0 2 4 6 1
//     3 5 7, kernels/flash_attention.py): the accumulator a thread holds
//     (columns 2c, 2c + 1) is fed as the TF32 A fragment (columns c, c + 4)
//     without a shuffle, as the f32 forward feeds P.  At (4, 2048, 16, 64)
//     the scratch is 14 tensors of 32 MB, about 0.18 ms of writes;
//   * Drow (fa_bwd_f32_dq_kernel, kRowsum): the dQ kernel's loop over its
//     key tiles without ring B, summing P dP per row;
//   * dQ (fa_bwd_f32_dq_kernel): one block per (b * h, 128 queries; 64 at
//     D = 128), heaviest causal tiles first; qs and dO (hi, lo) loaded once,
//     then a ring of key tiles (A: k and v hi / lo, B: k^T hi / lo).  Each
//     warpgroup owns 64 queries (wgmma's M).  S = qs k^T and dP = dO v^T
//     are SS wgmmas; P and dS in f32 in the accumulators' registers; dQ +=
//     dS k^T is an RS wgmma (dS split in registers);
//   * dK / dV (fa_bwd_f32_dkv_kernel): one block per (b * hk, 128 keys; 64
//     at D = 128); k and v (hi, lo) loaded once, then a ring of query tiles
//     (A: qs and dO hi / lo with their rows of lse log2(e) and Drow; B:
//     qs^T and dO^T hi / lo).  Each warpgroup owns 64 keys; S^T = k qs^T and
//     dP^T = v dO^T are SS wgmmas whose accumulators, split, are the A
//     fragments of dV += P^T dO and dK += dS^T qs (RS, with dO^T and qs^T
//     the B operands).  The block loops over the H / HK query heads of its
//     KV head (GQA summed in the block) and over the query tiles from the
//     causal start.
// dQ, dK and dV sum each tile's products in a fresh wgmma accumulator and
// add it to their running sums in f32 (__fadd_rn), PN columns at a time:
// the tensor core does not round its adds to nearest, and with one running
// wgmma accumulator the first bring-up on the card drifted past the bar
// where a key's dK and dV sum a thousand queries, while dQ and the short
// sums stayed well inside it.
// Shared memory is what sets the tiles: hi and lo double every f32 tile,
// and the block-resident operands of 128 rows (qs, dO or k, v) take 128 KB
// at D = 64.  So the streamed tiles are small there (32 keys or queries),
// the two rings have their own depths (a ring-A stage is freed once S and
// dP are read, a ring-B stage after the products that accumulate), and at
// D = 128 a block is one warpgroup of 64 rows with 16 or 32-row tiles
// (see DqCfg and DkvCfg for the bytes).  Blocks of at most two warpgroups
// (256 threads): ptxas holds a 384-thread block to 168 registers whatever
// setmaxnreg asks (as the bf16 backward found).  No producer
// warpgroup: the warpgroup that releases a stage last (an atomic count in
// shared memory) refills it with the TMA load of the step the ring's depth
// ahead, so neither warpgroup waits for the other to reach a fixed point.
// ptxas (CUDA 12.9): dQ 168 / 173 / 179 / 206 registers and dK / dV 170 /
// 254 / 201 / 255 at D = 16 / 32 / 64 / 128, no spill but 360 bytes of
// dK / dV's at D = 128, no serialized wgmma (C7512, C7520); the
// preprocess 48-64.  (dK / dV partial sums of 16 columns at D = 128
// spilled less and ran slower on the card.)  mbar_wait traps after about 10 s instead of hanging.
// exp is ex2.approx.ftz on s log2(e) - lse log2(e) (one MUFU instruction;
// within the bar in the CPU emulation).  Masks are applied only on the causal
// diagonal and the ragged last tile; a warpgroup whose rows see none of a
// tile's columns skips its products (it still waits for the tile and
// releases it).  Deterministic: no atomics on data, fixed sum orders
// (Drow over a quad in a fixed shuffle tree), so two runs are bitwise
// equal.  Softmax and products do not overlap inside a warpgroup, only
// across the two.  The build passes --fmad=false: the multiply-adds are
// written as fmaf.
#include "flash_bwd_work.cuh"
#include "sm90_common.cuh"
#include "sm90_tf32.cuh"

namespace {

constexpr int kRowPad = FA_BWD_ROW_PAD;  // T_pad, S_pad: lengths rounded up
constexpr int kPrepRows = 32;    // rows of one head a preprocess block
constexpr int kPrepThreads = 256;
constexpr float kLog2e = 1.44269504088896340736f;

// 2^x on the MUFU unit (one instruction; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A tile of Rows rows x Cols f32 columns (K-major: the columns are the
// product's K dimension) as TMA writes it: boxes of up to 32 columns
// (128-byte rows) of all Rows rows, in the swizzle wgmma reads: 128B for
// rows of 128 bytes, 64B for rows of 64 bytes (16 columns).
template <int Rows, int Cols>
struct Tile {
  static constexpr int kBoxCols = Cols < 32 ? Cols : 32;
  static constexpr int kRowBytes = 4 * kBoxCols;
  static constexpr int kBoxes = Cols / kBoxCols;
  static constexpr int kBoxBytes = Rows * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static constexpr int kStepsPerBox = kRowBytes / 32;  // k8 steps a row
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B;
  static_assert(Cols % 16 == 0 && Rows % 8 == 0, "tile shape");

  // the byte offset of the k8 step kk along the columns
  __device__ static uint32_t k_step(int kk) {
    return (kk / kStepsPerBox) * kBoxBytes + (kk % kStepsPerBox) * 32;
  }
  // rows are M or N: 8-row groups 8 * kRowBytes apart; the leading offset
  // is unused
  __device__ static uint64_t desc(uint32_t addr) {
    return make_desc(addr, 16, 8 * kRowBytes, kLayout);
  }
};

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

template <int N>
__device__ __forceinline__ void fence_all(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_reg(r[i][j]);
}

template <int N>
__device__ __forceinline__ void zero_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// An f32 accumulator (64 x N) as the hi / lo TF32 A fragments of the N / 8
// k-steps over its columns: A column c is accumulator column 2c and column
// c + 4 is 2c + 1 (TF32_KEY_ORDER), so a0..a3 = d[4n], d[4n + 2],
// d[4n + 1], d[4n + 3].
template <int N>
__device__ __forceinline__ void split_fragments(const float (&d)[N / 2],
                                                uint32_t (&hi)[N / 8][4],
                                                uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    split_tf32(d[4 * n], hi[n][0], lo[n][0]);
    split_tf32(d[4 * n + 2], hi[n][1], lo[n][1]);
    split_tf32(d[4 * n + 1], hi[n][2], lo[n][2]);
    split_tf32(d[4 * n + 3], hi[n][3], lo[n][3]);
  }
}

// S (64 x N) = A B^T over D in 3xTF32 k-steps: A (64 rows of an M-row
// tile, at row offset a_row) and B (N rows) both from shared memory, hi
// and lo tiles at *_hi / *_lo.
template <int D, int N, class AT, class BT>
__device__ __forceinline__ void ss_3xtf32(float (&s)[N / 2], uint32_t a_hi,
                                          uint32_t a_lo, uint32_t b_hi,
                                          uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t ao = AT::k_step(kk), bo = BT::k_step(kk);
    const uint64_t ah = AT::desc(a_hi + ao), bh = BT::desc(b_hi + bo);
    wgmma_tf32_ss<N>(s, AT::desc(a_lo + ao), bh, kk > 0);
    wgmma_tf32_ss<N>(s, ah, BT::desc(b_lo + bo), 1);
    wgmma_tf32_ss<N>(s, ah, bh, 1);
  }
}

// part (64 x PN) = A B over the K dimension of K rows, for columns c * PN
// .. of the D-column product: A as hi / lo fragments in registers
// (split_fragments), B (D rows of K columns, the transposed operand) from
// shared memory, rows c * PN ...  part must be zeroed.
template <int PN, int K, class BT>
__device__ __forceinline__ void rs_3xtf32(float (&part)[PN / 2], int c,
                                          const uint32_t (&hi)[K / 8][4],
                                          const uint32_t (&lo)[K / 8][4],
                                          uint32_t b_hi, uint32_t b_lo) {
  const uint32_t rows = c * PN * BT::kRowBytes;
#pragma unroll
  for (int n = 0; n < K / 8; ++n)
    wgmma_3xtf32<PN>(part, hi[n], lo[n],
                     BT::desc(b_hi + rows + BT::k_step(n)),
                     BT::desc(b_lo + rows + BT::k_step(n)), 1);
}

// acc's columns c * PN .. += part, in IEEE f32 adds
template <int D, int PN>
__device__ __forceinline__ void add_part(float (&acc)[D / 2],
                                         const float (&part)[PN / 2],
                                         int c) {
#pragma unroll
  for (int i = 0; i < PN / 2; ++i)
    acc[c * PN / 2 + i] = __fadd_rn(acc[c * PN / 2 + i], part[i]);
}

// The warpgroup ``wg`` has finished with a ring stage (every thread's
// reads of it done: wgmma waited for, generic loads before the barrier):
// true in one thread of the warpgroup that releases it last, which then
// refills it.  ``claim`` counts the releases of the stage.
template <int kWGs>
__device__ __forceinline__ bool released_last(uint32_t* claim, int wg,
                                              int t) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (t != 0) return false;
  if constexpr (kWGs == 1) {
    return true;
  } else {
    __threadfence_block();
    const bool last = (atomicAdd(claim, 1u) & 1u) != 0;
    __threadfence_block();
    return last;
  }
}

// store rows row0 / row1 (< len) of a 64 x D accumulator, times ``mul``,
// into dst rows of ``row_stride`` elements
// (columns < hd, the true head dim)
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float* base, int row0, int row1,
                                           int len, size_t row_stride,
                                           float mul, int hd) {
  if (row0 < len) {
    float* dst = base + (size_t)row0 * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n < hd)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(
            __fmul_rn(acc[4 * n], mul), __fmul_rn(acc[4 * n + 1], mul));
  }
  if (row1 < len) {
    float* dst = base + (size_t)row1 * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n < hd)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(
            __fmul_rn(acc[4 * n + 2], mul), __fmul_rn(acc[4 * n + 3], mul));
  }
}

// --------------------------------------------------------------- scratch
// The preprocess pass's outputs, f32 (TF32 values where split; lo at batch
// B + b, i.e. one batch-sized block after hi).
struct Work {
  float* lse2;  // (B, H, T_pad): lse log2(e), 0 past T
  float* drow;  // (B, H, T_pad): rowsum(P dP), 0 past T
  float* qs;    // (2B, T, H, D)
  float* dout;  // (2B, T, H, D)
  float* qst;   // (2B, H, D, T_pad), queries in TF32_KEY_ORDER
  float* dot;   // (2B, H, D, T_pad), likewise
  float* k;     // (2B, S, HK, D)
  float* v;     // (2B, S, HK, D)
  float* kt;    // (2B, HK, D, S_pad), keys in TF32_KEY_ORDER
};

__host__ __device__ __forceinline__ int pad_of(int len) {
  return (len + kRowPad - 1) / kRowPad * kRowPad;
}

// the scratch's width for a head dim: 112 runs the 128 instances
int scratch_dim(int head_dim) { return fa_bwd_f32_scratch_dim(head_dim); }

Work carve(void* work, int batch, int t_len, int s_len, int heads,
           int kv_heads, int head_dim) {
  const size_t rows = (size_t)batch * heads * pad_of(t_len);
  const size_t qn = 2 * (size_t)batch * t_len * heads * head_dim;
  const size_t qtn = 2 * (size_t)batch * heads * head_dim * pad_of(t_len);
  const size_t kn = 2 * (size_t)batch * s_len * kv_heads * head_dim;
  Work w;
  w.lse2 = static_cast<float*>(work);
  w.drow = w.lse2 + rows;
  w.qs = w.drow + rows;
  w.dout = w.qs + qn;
  w.qst = w.dout + qn;
  w.dot = w.qst + qtn;
  w.k = w.dot + qtn;
  w.v = w.k + kn;
  w.kt = w.v + kn;
  return w;
}

size_t work_floats(int batch, int t_len, int s_len, int heads, int kv_heads,
                   int head_dim) {
  return fa_bwd_f32_work_floats(batch, t_len, s_len, heads, kv_heads,
                                head_dim);
}

// --------------------------------------------------------- preprocess
// Grid: (B * H + B * HK, max(T_pad, S_pad) / 32).  blockIdx.x < B * H: 32
// query rows of head h (qs, dO and their transposes, lse log2(e), Drow's
// zeros);
// else 32 key rows of KV head hk (k, v, k^T).  One warp per row at a time,
// its lanes over D (neighbouring columns: coalesced); the transposes go
// through shared memory, each warp writing 32 neighbouring rows of one
// column.
template <int D, int HD>
__global__ void __launch_bounds__(kPrepThreads)
    fa_bwd_f32_prep_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ lse,
                           const float* __restrict__ dout, Work w, int batch,
                           int t_len, int s_len, int heads, int kv_heads,
                           float scale) {
  __shared__ float x0[kPrepRows][D + 1], x1[kPrepRows][D + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * kPrepRows;
  const bool q_side = (int)blockIdx.x < batch * heads;
  const int hb = q_side ? blockIdx.x : blockIdx.x - batch * heads;
  const int nh = q_side ? heads : kv_heads;
  const int b = hb / nh, h = hb - b * nh;
  const int len = q_side ? t_len : s_len;
  const int pad = pad_of(len);
  if (r0 >= pad) return;
  // hi at batch b, lo one batch-sized block later
  const size_t lo_nat = (size_t)batch * len * nh * D;
  const size_t lo_tr = (size_t)batch * nh * D * pad;
  float* nat0 = q_side ? w.qs : w.k;
  float* nat1 = q_side ? w.dout : w.v;
  for (int rr = warp; rr < kPrepRows; rr += kPrepThreads / 32) {
    const int row = r0 + rr;
    const bool live = row < len;
#pragma unroll
    for (int d = lane; d < (D < 32 ? 32 : D); d += 32) {
      if (d >= D) break;
      float a = 0.f, c = 0.f;
      if (live) {
        // the input at its width HD, the scratch at D (zeros past HD)
        const size_t in = (((size_t)b * len + row) * nh + h) * HD + d;
        const size_t off = (((size_t)b * len + row) * nh + h) * D + d;
        if (d < HD) {
          if (q_side) {
            a = __fmul_rn(q[in], scale);
            c = dout[in];
          } else {
            a = k[in];
            c = v[in];
          }
        }
        uint32_t hi, lo;
        split_tf32(a, hi, lo);
        nat0[off] = __uint_as_float(hi);
        nat0[off + lo_nat] = __uint_as_float(lo);
        split_tf32(c, hi, lo);
        nat1[off] = __uint_as_float(hi);
        nat1[off + lo_nat] = __uint_as_float(lo);
      }
      x0[rr][d] = a;
      x1[rr][d] = c;
    }
    if (q_side) {
      // Drow is the dQ kernel's row-sum pass's; zero past T
      if (lane == 0) {
        const size_t bh = (size_t)b * heads + h;
        w.drow[bh * pad + row] = 0.f;
        w.lse2[bh * pad + row] =
            live ? __fmul_rn(lse[bh * t_len + row], kLog2e) : 0.f;
      }
    }
  }
  __syncthreads();
  // the transposes: column d of the tile's rows, position p of each
  // 8-group holding row TF32_KEY_ORDER[p] = 2 (p % 4) + p / 4 (p < 8)
  float* tr0 = q_side ? w.qst : w.kt;
  float* tr1 = q_side ? w.dot : nullptr;
  for (int i = threadIdx.x; i < D * kPrepRows; i += kPrepThreads) {
    const int d = i / kPrepRows, p = i % kPrepRows;
    const int e = p & 7;
    const int rr = (p & ~7) + 2 * (e & 3) + (e >> 2);
    const size_t off = (((size_t)b * nh + h) * D + d) * pad + r0 + p;
    uint32_t hi, lo;
    split_tf32(x0[rr][d], hi, lo);
    tr0[off] = __uint_as_float(hi);
    tr0[off + lo_tr] = __uint_as_float(lo);
    if (q_side) {
      split_tf32(x1[rr][d], hi, lo);
      tr1[off] = __uint_as_float(hi);
      tr1[off + lo_tr] = __uint_as_float(lo);
    }
  }
}

// ----------------------------------------------------------------- dQ
// Tiles by head dim (bytes: resident 4 x RT, ring A stage 4 x KT, ring B
// stage 2 x TT):
//   D = 16: 2 warpgroups, 64-key steps, rings 3 / 3: 32K + 48K + 24K;
//   D = 32: 2, 64, 2 / 2: 64K + 64K + 32K;
//   D = 64: 2, 32, 2 / 2: 128K + 64K + 32K;
//   D = 128: 1 warpgroup (64 queries), 32, 1 / 1: 128K + 64K + 32K.
template <int D>
struct DqCfg {
  static constexpr int kWGs = D == 128 ? 1 : 2;
  static constexpr int kRows = 64 * kWGs;  // queries a block
  static constexpr int BK = D <= 32 ? 64 : 32;
  static constexpr int kStagesA = D == 16 ? 3 : (D == 128 ? 1 : 2);
  static constexpr int kStagesB = kStagesA;
  // dQ's columns a partial sum (accumulate)
  static constexpr int PN = D < 64 ? D : 64;
  using RT = Tile<kRows, D>;  // qs, dO: hi and lo, resident
  using KT = Tile<BK, D>;     // k, v: hi and lo, ring A
  using TT = Tile<D, BK>;     // k^T: hi and lo, ring B
  static constexpr int kStageA = 4 * KT::kBytes;
  static constexpr int kStageB = 2 * TT::kBytes;
  static constexpr int kTiles =
      4 * RT::kBytes + kStagesA * kStageA + kStagesB * kStageB;
  // barriers (resident, A, B) and the release counts (A, B)
  static constexpr int kBars =
      8 * (1 + kStagesA + kStagesB) + 4 * (kStagesA + kStagesB);
  static constexpr size_t kSmem = kTiles + kBars + 1024;
  static_assert(kSmem <= 232448, "over the block's shared memory");
};

struct DqMaps {
  CUtensorMap qs, dout, k, v, kt;
};

// Grid: (B * H, ceil(T / kRows)); blockIdx.y counts the query tiles from
// the last, so that the causal tiles with the most key tiles start first.
// kRowsum: the pass before dQ's, over the same key tiles (ring A alone),
// writing Drow = rowsum(P dP) (each thread's columns in order, then the
// quad's four partial sums) in place of dq.
template <int D, int HD, bool kWindow, bool kRowsum>
__global__ void __launch_bounds__(DqCfg<D>::kWGs * 128, 1)
    fa_bwd_f32_dq_kernel(const __grid_constant__ DqMaps maps,
                         const float* __restrict__ lse2,
                         float* __restrict__ drow,
                         float* __restrict__ dq, int batch, int t_len,
                         int t_pad, int s_len, int heads, int kv_heads,
                         int causal, float scale, int window) {
  if (!kWindow) window = 0;  // the instance without a window's terms
  using C = DqCfg<D>;
  using RT = typename C::RT;
  using KT = typename C::KT;
  using TT = typename C::TT;
  constexpr int BK = C::BK, NA = C::kStagesA, NB = C::kStagesB;
  constexpr int PN = C::PN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // the swizzle patterns repeat every 1024 bytes: align the tiles to it
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_res = base;  // qs hi, qs lo, dO hi, dO lo
  const uint32_t s_a = s_res + 4 * RT::kBytes;   // + st * kStageA
  const uint32_t s_b = s_a + NA * C::kStageA;    // + st * kStageB
  const uint32_t res_full = s_b + NB * C::kStageB;
  const uint32_t full_a = res_full + 8;          // + 8 * st
  const uint32_t full_b = full_a + 8 * NA;       // + 8 * st
  uint32_t* claim_a = reinterpret_cast<uint32_t*>(
      smem_raw + (full_b + 8 * NB - raw));
  uint32_t* claim_b = claim_a + NA;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;
  int n_kv = (s_len + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + C::kRows - 1) / BK + 1);
  // with a window, ring step i is key tile j_first + i, the first that
  // holds a key in the window of the block's first query
  const int j_first = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  const int n_steps = max(n_kv - j_first, 0);

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int st = 0; st < NA; ++st) {
      mbar_init(full_a + 8 * st, 1);
      claim_a[st] = 0;
    }
    for (int st = 0; st < NB; ++st) {
      mbar_init(full_b + 8 * st, 1);
      claim_b[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ring step i (keys (j_first + i) * BK ..): A = k hi, k lo, v hi, v lo;
  // B = k^T hi, lo
  const auto load_a = [&](int i) {
    const int j = j_first + i;
    const int st = i % NA;
    const uint32_t bar = full_a + 8 * st;
    const uint32_t dst = s_a + st * C::kStageA;
    mbar_expect_tx(bar, C::kStageA);
    for (int x = 0; x < KT::kBoxes; ++x)
      for (int part = 0; part < 2; ++part) {
        const int bb = b + part * batch;
        tma_load(dst + part * KT::kBytes + x * KT::kBoxBytes, &maps.k, bar,
                 x * KT::kBoxCols, hk, j * BK, bb);
        tma_load(dst + (2 + part) * KT::kBytes + x * KT::kBoxBytes, &maps.v,
                 bar, x * KT::kBoxCols, hk, j * BK, bb);
      }
  };
  const auto load_b = [&](int i) {
    const int j = j_first + i;
    const int st = i % NB;
    const uint32_t bar = full_b + 8 * st;
    const uint32_t dst = s_b + st * C::kStageB;
    mbar_expect_tx(bar, C::kStageB);
    for (int x = 0; x < TT::kBoxes; ++x)
      for (int part = 0; part < 2; ++part)
        tma_load(dst + part * TT::kBytes + x * TT::kBoxBytes, &maps.kt, bar,
                 j * BK + x * TT::kBoxCols, 0, hk, b + part * batch);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(res_full, 4 * RT::kBytes);
    for (int x = 0; x < RT::kBoxes; ++x)
      for (int part = 0; part < 2; ++part) {
        const int bb = b + part * batch;
        tma_load(s_res + part * RT::kBytes + x * RT::kBoxBytes, &maps.qs,
                 res_full, x * RT::kBoxCols, h, q0, bb);
        tma_load(s_res + (2 + part) * RT::kBytes + x * RT::kBoxBytes,
                 &maps.dout, res_full, x * RT::kBoxCols, h, q0, bb);
      }
    for (int i = 0; i < min(NA, n_steps); ++i) load_a(i);
    if (!kRowsum)
      for (int i = 0; i < min(NB, n_steps); ++i) load_b(i);
  }

  const int wg = threadIdx.x / 128;       // queries wg * 64 .. of the tile
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int c0 = (lane & 3) * 2;          // first column of an 8-group
  const int first = q0 + wg * 64;
  const int row0 = first + (t >> 5) * 16 + (lane >> 2);
  const int row1 = row0 + 8;              // the accumulators' two rows
  // rows < T_pad (a multiple of 128); rows past T read the zero padding
  const float l0 = lse2[(size_t)bh * t_pad + row0];
  const float l1 = lse2[(size_t)bh * t_pad + row1];
  const float d0 = kRowsum ? 0.f : drow[(size_t)bh * t_pad + row0];
  const float d1 = kRowsum ? 0.f : drow[(size_t)bh * t_pad + row1];
  float rsum[2] = {0.f, 0.f};  // kRowsum: this thread's part of Drow
  const uint32_t a_row = wg * 64 * RT::kRowBytes;  // this warpgroup's rows
  const uint32_t qs_hi = s_res + a_row, qs_lo = qs_hi + RT::kBytes;
  const uint32_t do_hi = qs_hi + 2 * RT::kBytes, do_lo = qs_hi + 3 * RT::kBytes;

  float acc[D / 2];
  zero_all(acc);
  mbar_wait(res_full, 0);
  for (int j = 0; j < n_steps; ++j) {  // ring step j: tile j_first + j
    const int sa = j % NA, sb = j % NB;
    const int k0 = (j_first + j) * BK;
    // else every key of the tile lies above the warpgroup's rows, or
    // before their windows
    const bool work = (!causal || k0 <= first + 63) &&
                      (window == 0 || k0 + BK - 1 > first - window);
    const uint32_t k_hi = s_a + sa * C::kStageA;
    const uint32_t kt_hi = s_b + sb * C::kStageB;
    float s[BK / 2], dp[BK / 2];
    mbar_wait(full_a + 8 * sa, (j / NA) & 1);
    if (work) {
      wgmma_fence();
      ss_3xtf32<D, BK, RT, KT>(s, qs_hi, qs_lo, k_hi, k_hi + KT::kBytes);
      ss_3xtf32<D, BK, RT, KT>(dp, do_hi, do_lo, k_hi + 2 * KT::kBytes,
                               k_hi + 3 * KT::kBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_all(s);
      fence_all(dp);
    }
    if (released_last<C::kWGs>(claim_a + sa, wg, t) && j + NA < n_steps)
      load_a(j + NA);
    uint32_t hi[BK / 8][4], lo[BK / 8][4];
    if (work) {
      // P = exp(S - lse), 0 past S and above the diagonal; dS = P (dP -
      // Drow) in dp
      const bool edge = k0 + BK > s_len || (causal && k0 + BK - 1 > first) ||
                        (window > 0 && k0 <= first + 63 - window);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * n + 2 * r + e;
            float p = ex2(__fmaf_rn(s[i], kLog2e, -(r ? l1 : l0)));
            if (edge) {
              const int col = k0 + 8 * n + c0 + e;
              const int row = r ? row1 : row0;
              if (col >= s_len || (causal && col > row) ||
                  (window > 0 && col <= row - window))
                p = 0.f;
            }
            if (kRowsum)
              rsum[r] = __fmaf_rn(p, dp[i], rsum[r]);
            else
              dp[i] = __fmul_rn(p, __fsub_rn(dp[i], r ? d1 : d0));
          }
      if (!kRowsum) split_fragments<BK>(dp, hi, lo);
    }
    if (kRowsum) continue;
    mbar_wait(full_b + 8 * sb, (j / NB) & 1);
    if (work) {
      // dQ += dS k (k^T the K-major B operand), the tile's products in a
      // partial sum of PN columns at a time
      fence_all(hi);
      fence_all(lo);
#pragma unroll
      for (int c = 0; c < D / PN; ++c) {
        float part[PN / 2];
        zero_all(part);
        fence_all(part);
        wgmma_fence();
        rs_3xtf32<PN, BK, TT>(part, c, hi, lo, kt_hi, kt_hi + TT::kBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_all(part);
        add_part<D, PN>(acc, part, c);
      }
    }
    if (released_last<C::kWGs>(claim_b + sb, wg, t) && j + NB < n_steps)
      load_b(j + NB);
  }
  if (kRowsum) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] = __fadd_rn(rsum[r], __shfl_xor_sync(0xffffffffu, rsum[r], 1));
      rsum[r] = __fadd_rn(rsum[r], __shfl_xor_sync(0xffffffffu, rsum[r], 2));
    }
    if ((lane & 3) == 0) {
      if (row0 < t_len) drow[(size_t)bh * t_pad + row0] = rsum[0];
      if (row1 < t_len) drow[(size_t)bh * t_pad + row1] = rsum[1];
    }
    return;
  }
  // dq = scale dQ; rows past T are not stored
  store_rows<D>(acc, dq + ((size_t)b * t_len * heads + h) * HD + c0, row0,
                row1, t_len, (size_t)heads * HD, scale, HD);
}

// ------------------------------------------------------------- dK, dV
// Tiles by head dim (bytes: resident 4 x RT, ring A stage 4 x QT + the
// rows, ring B stage 4 x TT):
//   D = 16: 2 warpgroups, 64-query steps, rings 3 / 3: 32K + 48K + 48K;
//   D = 32: 2, 64, 2 / 2: 64K + 64K + 64K;
//   D = 64: 2, 32, 2 / 1: 128K + 64K + 32K;
//   D = 128: 1 warpgroup (64 keys), 16, 2 / 1: 128K + 64K + 32K.
template <int D>
struct DkvCfg {
  static constexpr int kWGs = D == 128 ? 1 : 2;
  static constexpr int kRows = 64 * kWGs;  // keys a block
  static constexpr int BQ = D <= 32 ? 64 : (D == 64 ? 32 : 16);
  static constexpr int kStagesA = D == 16 ? 3 : 2;
  static constexpr int kStagesB = D == 16 ? 3 : (D == 32 ? 2 : 1);
  // dK's and dV's columns a partial sum (accumulate)
  static constexpr int PN = D <= 64 ? D : 32;
  using RT = Tile<kRows, D>;  // k, v: hi and lo, resident
  using QT = Tile<BQ, D>;     // qs, dO: hi and lo, ring A
  using TT = Tile<D, BQ>;     // qs^T, dO^T: hi and lo, ring B
  static constexpr int kRowsBytes = 8 * BQ;  // lse log2(e), Drow
  static constexpr int kStageA = 4 * QT::kBytes;
  static constexpr int kStageB = 4 * TT::kBytes;
  static constexpr int kTiles =
      4 * RT::kBytes + kStagesA * kStageA + kStagesB * kStageB;
  static constexpr int kBars = kStagesA * kRowsBytes +
                               8 * (1 + kStagesA + kStagesB) +
                               4 * (kStagesA + kStagesB);
  static constexpr size_t kSmem = kTiles + kBars + 1024;
  static_assert(kSmem <= 232448, "over the block's shared memory");
};

struct DkvMaps {
  CUtensorMap k, v, qs, dout, qst, dot;
};

// Grid: (B * HK, ceil(S / kRows)); blockIdx.y counts the key tiles from
// the first, whose causal query range is the longest.
template <int D, int HD, bool kWindow>
__global__ void __launch_bounds__(DkvCfg<D>::kWGs * 128, 1)
    fa_bwd_f32_dkv_kernel(const __grid_constant__ DkvMaps maps,
                          const float* __restrict__ lse2,
                          const float* __restrict__ drow,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int batch, int t_len, int t_pad, int s_len,
                          int heads, int kv_heads, int causal,
                          int window) {
  if (!kWindow) window = 0;  // the instance without a window's terms
  using C = DkvCfg<D>;
  using RT = typename C::RT;
  using QT = typename C::QT;
  using TT = typename C::TT;
  constexpr int BQ = C::BQ, NA = C::kStagesA, NB = C::kStagesB;
  constexpr int PN = C::PN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_res = base;  // k hi, k lo, v hi, v lo
  const uint32_t s_a = s_res + 4 * RT::kBytes;   // + st * kStageA
  const uint32_t s_b = s_a + NA * C::kStageA;    // + st * kStageB
  const uint32_t s_rows = s_b + NB * C::kStageB; // + st * kRowsBytes
  const uint32_t res_full = s_rows + NA * C::kRowsBytes;
  const uint32_t full_a = res_full + 8;
  const uint32_t full_b = full_a + 8 * NA;
  uint32_t* claim_a = reinterpret_cast<uint32_t*>(
      smem_raw + (full_b + 8 * NB - raw));
  uint32_t* claim_b = claim_a + NA;
  const float* rows_ptr =
      reinterpret_cast<const float*>(smem_raw + (s_rows - raw));

  const int bhk = blockIdx.x;
  const int b = bhk / kv_heads;
  const int hk = bhk - b * kv_heads;
  const int group = heads / kv_heads;
  const int k0 = blockIdx.y * C::kRows;
  const int n_q = (t_len + BQ - 1) / BQ;
  // causal: query tiles before k0 see none of these keys; with a window,
  // nor do those from key k0 + kRows - 1 + window on
  const int i0 = causal ? min(k0 / BQ, n_q) : 0;
  const int i1 =
      window > 0 ? min(n_q, (k0 + C::kRows - 1 + window - 1) / BQ + 1) : n_q;
  // ring step it is query tile i0 + it % per_head of query head
  // hk * group + it / per_head
  const int per_head = max(i1 - i0, 0);
  const int n_it = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int st = 0; st < NA; ++st) {
      mbar_init(full_a + 8 * st, 1);
      claim_a[st] = 0;
    }
    for (int st = 0; st < NB; ++st) {
      mbar_init(full_b + 8 * st, 1);
      claim_b[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A = qs hi, qs lo, dO hi, dO lo and the rows; B = qs^T hi, lo, dO^T hi,
  // lo
  const auto load_a = [&](int it) {
    const int st = it % NA;
    const int g = it / per_head;
    const int h = hk * group + g;
    const int q0 = (i0 + it - g * per_head) * BQ;
    const uint32_t bar = full_a + 8 * st;
    const uint32_t dst = s_a + st * C::kStageA;
    mbar_expect_tx(bar, C::kStageA + C::kRowsBytes);
    for (int x = 0; x < QT::kBoxes; ++x)
      for (int part = 0; part < 2; ++part) {
        const int bb = b + part * batch;
        tma_load(dst + part * QT::kBytes + x * QT::kBoxBytes, &maps.qs, bar,
                 x * QT::kBoxCols, h, q0, bb);
        tma_load(dst + (2 + part) * QT::kBytes + x * QT::kBoxBytes,
                 &maps.dout, bar, x * QT::kBoxCols, h, q0, bb);
      }
    const size_t row_off = ((size_t)b * heads + h) * t_pad + q0;
    const uint32_t rows_st = s_rows + st * C::kRowsBytes;
    bulk_load(rows_st, lse2 + row_off, 4 * BQ, bar);
    bulk_load(rows_st + 4 * BQ, drow + row_off, 4 * BQ, bar);
  };
  const auto load_b = [&](int it) {
    const int st = it % NB;
    const int g = it / per_head;
    const int h = hk * group + g;
    const int q0 = (i0 + it - g * per_head) * BQ;
    const uint32_t bar = full_b + 8 * st;
    const uint32_t dst = s_b + st * C::kStageB;
    mbar_expect_tx(bar, C::kStageB);
    for (int x = 0; x < TT::kBoxes; ++x)
      for (int part = 0; part < 2; ++part) {
        const int bb = b + part * batch;
        tma_load(dst + part * TT::kBytes + x * TT::kBoxBytes, &maps.qst,
                 bar, q0 + x * TT::kBoxCols, 0, h, bb);
        tma_load(dst + (2 + part) * TT::kBytes + x * TT::kBoxBytes,
                 &maps.dot, bar, q0 + x * TT::kBoxCols, 0, h, bb);
      }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(res_full, 4 * RT::kBytes);
    for (int x = 0; x < RT::kBoxes; ++x)
      for (int part = 0; part < 2; ++part) {
        const int bb = b + part * batch;
        tma_load(s_res + part * RT::kBytes + x * RT::kBoxBytes, &maps.k,
                 res_full, x * RT::kBoxCols, hk, k0, bb);
        tma_load(s_res + (2 + part) * RT::kBytes + x * RT::kBoxBytes,
                 &maps.v, res_full, x * RT::kBoxCols, hk, k0, bb);
      }
    for (int it = 0; it < min(NA, n_it); ++it) load_a(it);
    for (int it = 0; it < min(NB, n_it); ++it) load_b(it);
  }

  const int wg = threadIdx.x / 128;        // keys wg * 64 .. of the tile
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int c0 = (lane & 3) * 2;
  const int kw = k0 + wg * 64;             // the warpgroup's first key
  const int key0 = kw + (t >> 5) * 16 + (lane >> 2);
  const int key1 = key0 + 8;               // the accumulators' two rows
  const uint32_t a_row = wg * 64 * RT::kRowBytes;
  const uint32_t k_hi = s_res + a_row, k_lo = k_hi + RT::kBytes;
  const uint32_t v_hi = k_hi + 2 * RT::kBytes, v_lo = k_hi + 3 * RT::kBytes;

  float dk_acc[D / 2], dv_acc[D / 2];
  zero_all(dk_acc);
  zero_all(dv_acc);
  mbar_wait(res_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int sa = it % NA, sb = it % NB;
    const int q0 = (i0 + it % per_head) * BQ;
    // else every query of the tile lies before the warpgroup's keys, or
    // past their windows
    const bool work = (!causal || q0 + BQ - 1 >= kw) &&
                      (window == 0 || q0 <= kw + 63 + window - 1);
    const uint32_t q_hi = s_a + sa * C::kStageA;
    const uint32_t qt_hi = s_b + sb * C::kStageB;
    float s[BQ / 2], dp[BQ / 2];
    uint32_t p_hi[BQ / 8][4], p_lo[BQ / 8][4];
    uint32_t ds_hi[BQ / 8][4], ds_lo[BQ / 8][4];
    mbar_wait(full_a + 8 * sa, (it / NA) & 1);
    if (work) {
      wgmma_fence();
      ss_3xtf32<D, BQ, RT, QT>(s, k_hi, k_lo, q_hi, q_hi + QT::kBytes);
      ss_3xtf32<D, BQ, RT, QT>(dp, v_hi, v_lo, q_hi + 2 * QT::kBytes,
                               q_hi + 3 * QT::kBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_all(s);
      fence_all(dp);
      // P^T = exp(S^T - lse) with queries on the columns, 0 past T and
      // where the query is before the key; dS^T = P^T (dP^T - Drow)
      const float* lse_st = rows_ptr + sa * (C::kRowsBytes / 4);
      const float* drow_st = lse_st + BQ;
      const bool edge = q0 + BQ > t_len || (causal && q0 < kw + 63) ||
                        (window > 0 && q0 + BQ - 1 >= kw + window);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + c0 + e;
          const float l = lse_st[col], dr = drow_st[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * n + 2 * r + e;
            float p = ex2(__fmaf_rn(s[i], kLog2e, -l));
            if (edge) {
              const int query = q0 + col;
              const int key = r ? key1 : key0;
              if (query >= t_len || (causal && query < key) ||
                  (window > 0 && query >= key + window))
                p = 0.f;
            }
            s[i] = p;
            dp[i] = __fmul_rn(p, __fsub_rn(dp[i], dr));
          }
        }
      split_fragments<BQ>(s, p_hi, p_lo);
      split_fragments<BQ>(dp, ds_hi, ds_lo);
    }
    if (released_last<C::kWGs>(claim_a + sa, wg, t) && it + NA < n_it)
      load_a(it + NA);
    mbar_wait(full_b + 8 * sb, (it / NB) & 1);
    if (work) {
      // dV += P^T dO, dK += dS^T qs (dO^T, qs^T the K-major B operands),
      // the tile's products in partial sums of PN columns at a time
      fence_all(p_hi);
      fence_all(p_lo);
      fence_all(ds_hi);
      fence_all(ds_lo);
#pragma unroll
      for (int c = 0; c < D / PN; ++c) {
        float pv[PN / 2], pk[PN / 2];
        zero_all(pv);
        zero_all(pk);
        fence_all(pv);
        fence_all(pk);
        wgmma_fence();
        rs_3xtf32<PN, BQ, TT>(pv, c, p_hi, p_lo, qt_hi + 2 * TT::kBytes,
                              qt_hi + 3 * TT::kBytes);
        rs_3xtf32<PN, BQ, TT>(pk, c, ds_hi, ds_lo, qt_hi,
                              qt_hi + TT::kBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_all(pv);
        fence_all(pk);
        add_part<D, PN>(dv_acc, pv, c);
        add_part<D, PN>(dk_acc, pk, c);
      }
    }
    if (released_last<C::kWGs>(claim_b + sb, wg, t) && it + NB < n_it)
      load_b(it + NB);
  }
  // dk, dv; keys past S are not stored
  const size_t row_stride = (size_t)kv_heads * HD;
  const size_t off = ((size_t)b * s_len * kv_heads + hk) * HD + c0;
  store_rows<D>(dk_acc, dk + off, key0, key1, s_len, row_stride, 1.f, HD);
  store_rows<D>(dv_acc, dv + off, key0, key1, s_len, row_stride, 1.f, HD);
}

// -------------------------------------------------------------- host
// A 4-D map of a contiguous f32 tensor of dims (innermost first) d0..d3,
// box (c, r1, r2, 1), in the tile's swizzle.  Coordinates past a dim read
// as 0.
int encode(CUtensorMap* map, const void* ptr, int d0, int d1, int d2, int d3,
           int c, int r1, int r2, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {4ull * d0, 4ull * d0 * d1,
                                 4ull * d0 * d1 * d2};
  const cuuint32_t box[4] = {(cuuint32_t)c, (cuuint32_t)r1, (cuuint32_t)r2,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed - (int)r;
}

// a (2B, len, heads, D) tensor as Tile<Rows, D> tiles of Rows rows
template <int Rows, int D>
int encode_rows(CUtensorMap* map, const void* ptr, int batch2, int len,
                int heads) {
  using G = Tile<Rows, D>;
  return encode(map, ptr, D, heads, len, batch2, G::kBoxCols, 1, Rows,
                G::kSwizzle);
}

// a (2B, heads, D, len_pad) tensor as Tile<D, Cols> tiles of Cols columns
template <int D, int Cols>
int encode_cols(CUtensorMap* map, const void* ptr, int batch2, int len_pad,
                int heads) {
  using G = Tile<D, Cols>;
  return encode(map, ptr, len_pad, D, heads, batch2, G::kBoxCols, D, 1,
                G::kSwizzle);
}

template <int D, int HD, bool kWindow>
int launch_impl(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* dk,
                void* dv, void* work, int batch, int t_len, int s_len,
                int heads, int kv_heads, int causal, float scale, int window,
                cudaStream_t stream) {
  using QC = DqCfg<D>;
  using KC = DkvCfg<D>;
  // set once per instance (thread-safe static initialisation)
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      fa_bwd_f32_dq_kernel<D, HD, kWindow, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)QC::kSmem);
  static const cudaError_t attr_rows = cudaFuncSetAttribute(
      fa_bwd_f32_dq_kernel<D, HD, kWindow, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)QC::kSmem);
  if (attr_rows != cudaSuccess) return (int)attr_rows;
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      fa_bwd_f32_dkv_kernel<D, HD, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)KC::kSmem);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  const int t_pad = pad_of(t_len), s_pad = pad_of(s_len);
  const Work w = carve(work, batch, t_len, s_len, heads, kv_heads, D);

  const dim3 prep_grid(batch * heads + batch * kv_heads,
                       (t_pad > s_pad ? t_pad : s_pad) / kPrepRows);
  fa_bwd_f32_prep_kernel<D, HD><<<prep_grid, kPrepThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(dout), w,
      batch, t_len, s_len, heads, kv_heads, scale);
  cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;

  const int b2 = 2 * batch;
  DqMaps mq;
  int err = encode_rows<QC::kRows, D>(&mq.qs, w.qs, b2, t_len, heads);
  if (err == 0)
    err = encode_rows<QC::kRows, D>(&mq.dout, w.dout, b2, t_len, heads);
  if (err == 0) err = encode_rows<QC::BK, D>(&mq.k, w.k, b2, s_len, kv_heads);
  if (err == 0) err = encode_rows<QC::BK, D>(&mq.v, w.v, b2, s_len, kv_heads);
  if (err == 0)
    err = encode_cols<D, QC::BK>(&mq.kt, w.kt, b2, s_pad, kv_heads);
  DkvMaps mk;
  if (err == 0)
    err = encode_rows<KC::kRows, D>(&mk.k, w.k, b2, s_len, kv_heads);
  if (err == 0)
    err = encode_rows<KC::kRows, D>(&mk.v, w.v, b2, s_len, kv_heads);
  if (err == 0) err = encode_rows<KC::BQ, D>(&mk.qs, w.qs, b2, t_len, heads);
  if (err == 0)
    err = encode_rows<KC::BQ, D>(&mk.dout, w.dout, b2, t_len, heads);
  if (err == 0)
    err = encode_cols<D, KC::BQ>(&mk.qst, w.qst, b2, t_pad, heads);
  if (err == 0)
    err = encode_cols<D, KC::BQ>(&mk.dot, w.dot, b2, t_pad, heads);
  if (err != 0) return err;

  const dim3 grid_q(batch * heads, (t_len + QC::kRows - 1) / QC::kRows);
  fa_bwd_f32_dq_kernel<D, HD, kWindow, true>
      <<<grid_q, QC::kWGs * 128, QC::kSmem, stream>>>(
          mq, w.lse2, w.drow, nullptr, batch, t_len, t_pad, s_len, heads,
          kv_heads, causal, scale, window);
  launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  fa_bwd_f32_dq_kernel<D, HD, kWindow, false>
      <<<grid_q, QC::kWGs * 128, QC::kSmem, stream>>>(
          mq, w.lse2, w.drow, static_cast<float*>(dq), batch, t_len, t_pad,
          s_len, heads, kv_heads, causal, scale, window);
  launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  const dim3 grid_k(batch * kv_heads, (s_len + KC::kRows - 1) / KC::kRows);
  fa_bwd_f32_dkv_kernel<D, HD, kWindow>
      <<<grid_k, KC::kWGs * 128, KC::kSmem, stream>>>(
          mk, w.lse2, w.drow, static_cast<float*>(dk),
          static_cast<float*>(dv), batch, t_len, t_pad, s_len, heads,
          kv_heads, causal, window);
  return (int)cudaGetLastError();
}

// a call without a window runs instances with none of the window's terms
template <int D, int HD = D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* work, int batch, int t_len, int s_len, int heads,
           int kv_heads, int causal, float scale, int window,
           cudaStream_t stream) {
  return window > 0
             ? launch_impl<D, HD, true>(q, k, v, o, lse, dout, dq, dk, dv,
                                        work, batch, t_len, s_len, heads,
                                        kv_heads, causal, scale, window,
                                        stream)
             : launch_impl<D, HD, false>(q, k, v, o, lse, dout, dq, dk, dv,
                                         work, batch, t_len, s_len, heads,
                                         kv_heads, causal, scale, 0, stream);
}

}  // namespace

extern "C" {

// Bytes of the scratch ``work`` that flash_attention_bwd_f32_sm90_launch
// takes for these sizes (struct Work: the row statistics and the split,
// padded and transposed operands).
size_t flash_attention_bwd_f32_sm90_work_bytes(int batch, int t_len,
                                               int s_len, int heads,
                                               int kv_heads, int head_dim) {
  return 4 * work_floats(batch, t_len, s_len, heads, kv_heads, head_dim);
}

// q, o, dout, dq: (batch, t_len, heads, head_dim); k, v, dk, dv: (batch,
// s_len, kv_heads, head_dim); all contiguous f32, 16-byte aligned.  lse
// (the forward's m + log(l)) is (batch, heads, t_len) f32; ``work`` is
// scratch of flash_attention_bwd_f32_sm90_work_bytes(...) bytes, 16-byte
// aligned, written here.  head_dim in {16, 32, 64, 112, 128}; heads %
// kv_heads == 0; t_len, s_len >= 1; batch * (heads + kv_heads) < 2^31 and
// ceil(t_len / 32), ceil(s_len / 32) <= 65535.  ``scale`` is the forward's
// f32(head_dim^-1/2); ``window`` the forward's (0 is none).  Launches the
// three kernels on ``stream`` and
// returns the first nonzero cudaGetLastError(), cudaErrorInvalidValue for
// an unsupported head_dim, -1 if the driver has no cuTensorMapEncodeTiled,
// or -1000 - r if it returned CUresult r.
int flash_attention_bwd_f32_sm90_launch(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* lse, const void* dout,
                                        void* dq, void* dk, void* dv,
                                        void* work, int batch, int t_len,
                                        int s_len, int heads, int kv_heads,
                                        int head_dim, int causal, float scale,
                                        int window, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (window < 0) return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, o, lse, dout, dq, dk, dv, work, batch, t_len,
                        s_len, heads, kv_heads, causal, scale, window, st);
    case 32:
      return launch<32>(q, k, v, o, lse, dout, dq, dk, dv, work, batch, t_len,
                        s_len, heads, kv_heads, causal, scale, window, st);
    case 64:
      return launch<64>(q, k, v, o, lse, dout, dq, dk, dv, work, batch, t_len,
                        s_len, heads, kv_heads, causal, scale, window, st);
    case 112:  // D = 128 instances on a 128-wide scratch
      return launch<128, 112>(q, k, v, o, lse, dout, dq, dk, dv, work,
                              batch, t_len, s_len, heads, kv_heads, causal,
                              scale, window, st);
    case 128:
      return launch<128>(q, k, v, o, lse, dout, dq, dk, dv, work, batch,
                         t_len, s_len, heads, kv_heads, causal, scale,
                         window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of the dQ and dK / dV blocks of ``head_dim``
// (ptxas does not report it), or 0 for an unsupported head_dim.
int flash_attention_bwd_f32_sm90_smem_bytes(int head_dim, int dkv) {
  switch (head_dim) {
    case 16: return (int)(dkv ? DkvCfg<16>::kSmem : DqCfg<16>::kSmem);
    case 32: return (int)(dkv ? DkvCfg<32>::kSmem : DqCfg<32>::kSmem);
    case 64: return (int)(dkv ? DkvCfg<64>::kSmem : DqCfg<64>::kSmem);
    case 112:
    case 128: return (int)(dkv ? DkvCfg<128>::kSmem : DqCfg<128>::kSmem);
    default: return 0;
  }
}

// The streamed tile of ``head_dim``: keys a step of the dQ kernel (dkv 0,
// DqCfg::BK) or queries a step of the dK / dV kernel (dkv 1, DkvCfg::BQ),
// or 0 for an unsupported head_dim.  The CPU emulation of this kernel
// takes the same tiles (flash_attention.py, F32_BWD_TILES).
int flash_attention_bwd_f32_sm90_tile(int head_dim, int dkv) {
  switch (head_dim) {
    case 16: return dkv ? DkvCfg<16>::BQ : DqCfg<16>::BK;
    case 32: return dkv ? DkvCfg<32>::BQ : DqCfg<32>::BK;
    case 64: return dkv ? DkvCfg<64>::BQ : DqCfg<64>::BK;
    case 112:
    case 128: return dkv ? DkvCfg<128>::BQ : DqCfg<128>::BK;
    default: return 0;
  }
}

}  // extern "C"
