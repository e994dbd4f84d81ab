// Flash-attention backward for Hopper tensor cores (wgmma + TMA), bf16.
//
// The JAX package has no Pallas counterpart: it trains through its
// pure-JAX chunked attention (src/repro/models/attention.py:26,
// flash_attention) and lets jax.grad differentiate it.  The port's bf16
// forward is flash_attention_sm90.cu, and this file computes the gradient
// of the function it computes, the one ref.flash_attention_bwd_ref
// defines for bf16, with FlashAttention-2's formula, from q, k, v, the
// forward's output o, its row statistic lse = m + log(l) and dO:
//
//   qs   = bf16(f32(q) * f32(bf16(D^-1/2)))   (the forward's scaled q)
//   S    = qs k^T (f32), masked where key >= S_len or, causal, key > query
//          (aligned at the top left), or key <= query - window with a
//          window
//   P    = exp(S - lse), 0 where masked        (f32)
//   Drow = rowsum(dO * O)                      (f32)
//   dV   = bf16(P)^T dO                        (P rounded as the forward's
//                                               P V rounds it)
//   dP   = dO v^T
//   dS   = P (dP - Drow)                       (f32)
//   dK   = dS^T qs,  dQ = scale * dS k          (dS in f32, see below)
//
// q, o, dO, dq (B, T, H, D); k, v, dk, dv (B, S, HK, D); all bf16; lse
// (B, H, T) f32; D in {16, 32, 64, 112, 128}, H % HK == 0, ragged T and S.
// Head dim 112 runs D = 128 instances compiled for a true width of 112
// (HD; D = 128 keeps its own): the maps of dO, K, V and the
// scratch qs keep the true width (TMA fills columns 112-127 with zeros,
// which add exact zeros to every product) and the stores stop at 112.
// With a window (``window`` > 0) the dQ kernel starts at its first key
// tile inside its first query's window and the dK / dV kernel stops at
// the last query tile that sees its last key (query < key + window);
// masked keys take P = 0 (exp of S - lse, where lse is finite), so a
// tile skipped is a tile of zeros.
// Every sum runs in f32 (wgmma's f32 accumulators) and each output is
// rounded to bf16 once.  The f32 gradient is
// flash_attention_bwd_f32_sm90.cu.
//
// dK and dV sum each query tile's products in a fresh wgmma accumulator
// and add it to their running sums in IEEE f32 adds (__fadd_rn), 64
// columns at a time, as the f32 backward does: the tensor core does not
// round its adds to nearest, and with one running wgmma accumulator a key
// of qwen3-32b's GQA heads (64 / 8 of 128), which sums 8 query heads x T
// queries, drifted past the bar on the card (19 of 8.4 M dK outputs over
// one ulp + 2e-5 max|g| at T = 8192, causal).  dQ keeps one running
// accumulator over its S keys: held on the same cases, it meets the bar.
// The partials cost registers: ptxas (CUDA 12.9) gives the dK / dV kernel
// 121-198 registers at D = 16-64, no spill, and 255 at D = 128 with
// 184-212 bytes of spill (none at HD = 112), no serialized wgmma; the D =
// 128 shapes ran 6-17% slower than with one running accumulator (two
// commit groups a tile), the D = 64 ones within 2%.
//
// dS in f32 on bf16 tensor cores.  The products dS^T qs and dS k take
// bf16 operands, and one bf16 dS (FlashAttention-2's and -3's choice)
// computes another function: on the CPU, 7-11.5% of dQ and dK outputs
// then miss one bf16 ulp + 2e-5 max|g| of the plain version
// (tests/test_torch_flash_attention.py,
// test_one_bf16_ds_misses_the_bar).  So dS is split into two bf16 terms,
// hi = bf16(dS) and lo = bf16(dS - hi), and each product is two wgmmas,
// hi and lo, into one f32 accumulator: dS carries 16 significant bits,
// and every output meets that bar in the emulation
// (test_bf16_backward_emulation_meets_the_bar).
//
// What bounds it on this card: operations.  The gradient needs 2.5x the
// forward's products (4 B H T S D / 2 FLOPs causal): 85.9 GFLOP at
// (4, 2048, 16, 64), 0.087 ms at 989 TFLOP/s bf16, against 0.040 ms to
// move its tensors once at 3.35 TB/s.  This design runs 9 tile-products
// where the bound counts 5 (S and dP in both kernels, dK and dQ twice for
// the split): its floor is 1.8x the bound.  Three launches:
//   * preprocess (fa_bwd_sm90_prep_kernel): one pass over q, o and dO;
//     writes Drow and lse log2(e) as (B, H, T_pad) f32, T padded to 128
//     rows with zeros (the dK / dV kernel bulk-copies whole rows of them),
//     and qs as (B, T, H, D) bf16, so both product kernels TMA-load the
//     scaled q instead of scaling it in shared memory;
//   * dQ (fa_bwd_sm90_dq_kernel): one block per (b * h, 128 queries), the
//     heaviest causal tiles first; qs and dO loaded once, K and V tiles of
//     BK keys (128; 64 at D = 128) in a ring.  Each warpgroup owns 64
//     queries (wgmma's M).  S = qs K^T and dP = dO V^T are SS wgmmas (both
//     K-major); P and dS in f32 in the accumulators' registers; dQ +=
//     dS_hi K + dS_lo K are RS wgmmas (dS's accumulator is its A
//     fragment; K is the MN-major B operand, the transpose bit);
//   * dK / dV (fa_bwd_sm90_dkv_kernel): one block per (b * hk, 128 keys),
//     heaviest causal blocks first; K and V loaded once, the qs and dO
//     tiles of 64 queries, with their rows of lse log2(e) and Drow (bulk
//     copies), in a ring.  Each warpgroup owns 64 keys.  With keys on the
//     accumulator rows, S^T = K qs^T and dP^T = V dO^T are SS wgmmas whose
//     accumulators are already the A fragments of dV += bf16(P^T) dO and
//     dK += dS^T_hi qs + dS^T_lo qs (RS; dO and qs the MN-major B
//     operand), each tile's into fresh accumulators of 64 columns (one
//     box of dO and qs) that are then added to dK and dV (see above).  lse
//     and Drow are read per accumulator column from shared memory.  The
//     block loops over the H / HK query heads of its KV head (GQA summed
//     in the block, in the running sums) and over the query tiles from
//     the causal start.
// Both product kernels are blocks of two warpgroups (256 threads), and
// thread 0 issues the TMA loads, kAhead ring steps ahead: a block with a
// producer warpgroup (384 threads) is held to 168 registers a thread
// whatever setmaxnreg asks, and then the dK / dV kernel spills and ptxas
// serializes its wgmma (C7512); 256 threads leave 255, and the products'
// registers fit (dK and dV alone take 128 a thread at D = 128).  The
// rings have kStages stages under full / empty mbarriers; mbar_wait traps
// after about 10 s instead of hanging.  exp is ex2.approx.ftz (one MUFU
// instruction), where the libm exp2f took a large share of the time.
// Masks are applied only on the causal diagonal and the ragged last tile;
// tiles a warpgroup sees fully masked are skipped (it still releases the
// stage).  TMA's 4-D maps (D, heads, rows, B) zero-fill rows past T or S
// inside a batch; keys past S are masked in dQ (a zero K row times an
// unmasked dS would still be 0, but dS itself need not be finite there),
// queries past T in dK / dV, and rows past T or S are never stored.
// Deterministic: no atomics, fixed sum orders, so two runs are bitwise
// equal and a checkpoint-resumed train step repeats its gradient.
// Softmax and products do not overlap inside a warpgroup, only across the
// two.  Two reworks of the loop ran no faster on the card: the warpgroups
// taking turns on the tensor cores (named barriers), each step's RS
// products issued with the next step's SS products; and each step issuing
// the next tile's SS products before its softmax (two S^T / dP^T register
// sets, 255 registers at D = 64).  The build passes --fmad=false: the
// multiply-adds are written as fmaf.
#include <cuda_bf16.h>

#include "sm90_bf16.cuh"
#include "flash_bwd_work.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;      // two warpgroups, no producer
constexpr int kEmptyArrivals = 8;  // one per warp
constexpr int kStages = 4;
// thread 0 loads ring step it + kAhead at step it, into the stage that
// step it + kAhead - kStages held (two steps back: every warp must have
// released it, and the other warpgroup may still be one step behind)
constexpr int kAhead = kStages - 2;
constexpr int kRowPad = FA_BWD_ROW_PAD;  // T_pad: T rounded up to this
constexpr int kPrepThreads = 256;
constexpr float kLog2e = 1.44269504088896340736f;

// 2^x on the MUFU unit (one instruction; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A tile of Rows rows x D bf16 columns as TMA writes it: boxes of up to 64
// columns (128-byte rows) of all Rows rows, in the swizzle wgmma reads:
// 128B for rows of 64 columns (D = 64, and D = 128 as two boxes), 64B at
// D = 32, 32B at D = 16.
template <int D, int Rows>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kBoxes = D / kCols;
  static constexpr int kBoxBytes = Rows * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static constexpr int kStepsPerBox = kRowBytes / 32;  // k16 steps a row
  static constexpr int kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);

  // the byte offset of the k16 step kk along D
  __device__ static uint32_t k_step(int kk) {
    return (kk / kStepsPerBox) * kBoxBytes + (kk % kStepsPerBox) * 32;
  }
  // D is the K dimension (the operand's rows are M or N): 8-row groups
  // 8 * kRowBytes apart; the leading offset is unused
  __device__ static uint64_t k_major(uint32_t addr) {
    return make_desc(addr, 16, 8 * kRowBytes, kLayout);
  }
  // the rows are the K dimension and D the N dimension (the transpose
  // bit): 8-row groups 8 * kRowBytes apart, 64-column boxes kBoxBytes
  // apart (only D = 128 has two)
  __device__ static uint64_t mn_major(uint32_t addr) {
    return make_desc(addr, kBoxBytes, 8 * kRowBytes, kLayout);
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

// dS (an f32 accumulator, 64 x N) as two bf16 A-fragment sets, hi =
// bf16(dS) and lo = bf16(dS - hi), for the N / 16 k16 steps over its
// columns (the layout of pack_fragments)
template <int N>
__device__ __forceinline__ void split_fragments(const float (&d)[N / 2],
                                                uint32_t (&hi)[N / 16][4],
                                                uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = d[8 * kk + 2 * r], b = d[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack_bf16(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y));
    }
}

// acc's columns c * PN .. += part, in IEEE f32 adds (the tensor core's
// own adds do not round to nearest)
template <int D, int PN>
__device__ __forceinline__ void add_part(float (&acc)[D / 2],
                                         const float (&part)[PN / 2],
                                         int c) {
#pragma unroll
  for (int i = 0; i < PN / 2; ++i)
    acc[c * PN / 2 + i] = __fadd_rn(acc[c * PN / 2 + i], part[i]);
}

// store rows row0 / row1 (< len) of a 64 x D accumulator, times ``mul``,
// as bf16 into dst rows of ``row_stride`` elements
// (columns < hd, the true head dim)
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           __nv_bfloat16* base, int row0,
                                           int row1, int len,
                                           size_t row_stride, float mul,
                                           int hd) {
  if (row0 < len) {
    __nv_bfloat16* dst = base + (size_t)row0 * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(__fmul_rn(acc[4 * n], mul),
                                  __fmul_rn(acc[4 * n + 1], mul));
  }
  if (row1 < len) {
    __nv_bfloat16* dst = base + (size_t)row1 * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(__fmul_rn(acc[4 * n + 2], mul),
                                  __fmul_rn(acc[4 * n + 3], mul));
  }
}

// --------------------------------------------------------- preprocess
// One thread per 8 columns of a (b, t, h) row, t < T_pad, rows in memory
// order; D / 8 threads a row (neighbouring lanes of one warp).  HD is the
// tensors' true head dim (D, or 112 in a D = 128 instance).
template <int D, int HD>
__global__ void __launch_bounds__(kPrepThreads)
    fa_bwd_sm90_prep_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            __nv_bfloat16* __restrict__ qs,
                            float* __restrict__ lse2,
                            float* __restrict__ drow, int batch, int t_len,
                            int t_pad, int heads, float scale) {
  constexpr int kLanes = D / 8;  // the lanes of a row; those past HD idle
  const long long idx = (long long)blockIdx.x * kPrepThreads + threadIdx.x;
  const long long row = idx / kLanes;
  const int part = (int)(idx % kLanes);
  const bool valid = row < (long long)batch * t_pad * heads;
  const int h = (int)(row % heads);
  const long long bt = row / heads;
  const int t = (int)(bt % t_pad);
  const int b = (int)(bt / t_pad);
  const bool live = valid && t < t_len;
  float acc = 0.f;
  if (live && part * 8 < HD) {
    const size_t off = (((size_t)b * t_len + t) * heads + h) * HD + part * 8;
    uint4 qv = *reinterpret_cast<const uint4*>(q + off);
    const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
    __nv_bfloat162* qe = reinterpret_cast<__nv_bfloat162*>(&qv);
    const __nv_bfloat162* oe = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* de = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 f = __bfloat1622float2(qe[c]);
      qe[c] = __floats2bfloat162_rn(__fmul_rn(f.x, scale),
                                    __fmul_rn(f.y, scale));
      const float2 of = __bfloat1622float2(oe[c]);
      const float2 df = __bfloat1622float2(de[c]);
      acc = __fmaf_rn(df.x, of.x, acc);
      acc = __fmaf_rn(df.y, of.y, acc);
    }
    *reinterpret_cast<uint4*>(qs + off) = qv;
  }
  // the row's sum over its D / 8 lanes (whole warps take part)
#pragma unroll
  for (int w = 1; w < kLanes; w <<= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, w));
  if (valid && part == 0) {
    const size_t bh = (size_t)b * heads + h;
    drow[bh * t_pad + t] = live ? acc : 0.f;
    lse2[bh * t_pad + t] =
        live ? __fmul_rn(lse[bh * t_len + t], kLog2e) : 0.f;
  }
}

// ----------------------------------------------------------------- dQ
// Grid: (B * H, ceil(T / 128)); blockIdx.y counts the query tiles from the
// last, so that the causal tiles with the most KV tiles start first.
template <int D>
struct DqSmem {
  // keys a stage: 128, 64 at D = 128, where dQ's 64 f32 registers a
  // thread and S and dP at 128 keys would pass ptxas' 255
  static constexpr int BK = D == 128 ? 64 : 128;
  using QT = Tile<D, 128>;  // qs and dO: 128 queries
  using KT = Tile<D, BK>;   // K and V
  static constexpr size_t kBars = 8 * (1 + 2 * kStages);
  static constexpr size_t kBytes =
      2 * QT::kBytes + 2 * kStages * KT::kBytes + kBars + 1024;
};

template <int D, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_sm90_dq_kernel(const __grid_constant__ CUtensorMap tm_qs,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse2,
                          const float* __restrict__ drow,
                          __nv_bfloat16* __restrict__ dq, int t_len,
                          int t_pad, int s_len, int heads, int kv_heads,
                          int causal, float scale, int window) {
  if (!kWindow) window = 0;  // the instance without a window's terms
  constexpr int BK = DqSmem<D>::BK;
  using QT = typename DqSmem<D>::QT;
  using KT = typename DqSmem<D>::KT;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = sq + QT::kBytes;
  const uint32_t sk = sdo + QT::kBytes;                 // + st * KT::kBytes
  const uint32_t sv = sk + kStages * KT::kBytes;
  const uint32_t q_full = sv + kStages * KT::kBytes;
  const uint32_t kv_full = q_full + 8;                  // + 8 * st
  const uint32_t kv_empty = kv_full + 8 * kStages;      // + 8 * st

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;
  int n_kv = (s_len + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + 127) / BK + 1);
  // with a window, ring step i is key tile j_first + i, the first that
  // holds a key in the window of the tile's first query
  const int j_first = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  const int n_steps = max(n_kv - j_first, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0's load of ring step i (KV tile j_first + i) into its stage,
  // once every warp has released the tile the stage held
  const auto load_kv = [&](int i) {
    const int j = j_first + i;
    const int st = i % kStages;
    mbar_wait(kv_empty + 8 * st, ((i / kStages) & 1) ^ 1);
    mbar_expect_tx(kv_full + 8 * st, 2 * KT::kBytes);
    for (int x = 0; x < KT::kBoxes; ++x) {
      tma_load(sk + st * KT::kBytes + x * KT::kBoxBytes, &tm_k,
               kv_full + 8 * st, x * 64, hk, j * BK, b);
      tma_load(sv + st * KT::kBytes + x * KT::kBoxBytes, &tm_v,
               kv_full + 8 * st, x * 64, hk, j * BK, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * QT::kBytes);
    for (int x = 0; x < QT::kBoxes; ++x) {
      tma_load(sq + x * QT::kBoxBytes, &tm_qs, q_full, x * 64, h, q0, b);
      tma_load(sdo + x * QT::kBoxBytes, &tm_do, q_full, x * 64, h, q0, b);
    }
    for (int i = 0; i < min(kAhead, n_steps); ++i) load_kv(i);
  }

  const int cw = threadIdx.x / 128;       // queries cw * 64 .. of the tile
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int c0 = (lane & 3) * 2;          // first column of an 8-group
  const int first = q0 + cw * 64;
  const int row0 = first + (t >> 5) * 16 + (lane >> 2);
  const int row1 = row0 + 8;              // the accumulators' two rows
  // rows < T_pad (a multiple of 128); rows past T read the zero padding
  const float l0 = lse2[(size_t)bh * t_pad + row0];
  const float l1 = lse2[(size_t)bh * t_pad + row1];
  const float d0 = drow[(size_t)bh * t_pad + row0];
  const float d1 = drow[(size_t)bh * t_pad + row1];
  const uint32_t q_wg = sq + cw * 64 * QT::kRowBytes;
  const uint32_t do_wg = sdo + cw * 64 * QT::kRowBytes;

  float acc[D / 2];
  zero_all(acc);
  mbar_wait(q_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    if (threadIdx.x == 0 && i + kAhead < n_steps) load_kv(i + kAhead);
    const int st = i % kStages;
    const int k0 = (j_first + i) * BK;
    const uint32_t k_st = sk + st * KT::kBytes;
    const uint32_t v_st = sv + st * KT::kBytes;
    mbar_wait(kv_full + 8 * st, (i / kStages) & 1);
    // else every key is above the rows, or before their windows
    if ((!causal || k0 <= first + 63) &&
        (window == 0 || k0 + BK - 1 > first - window)) {
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(s, QT::k_major(q_wg + QT::k_step(kk)),
                     KT::k_major(k_st + KT::k_step(kk)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(dp, QT::k_major(do_wg + QT::k_step(kk)),
                     KT::k_major(v_st + KT::k_step(kk)), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_all(s);
      fence_all(dp);
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
            const int x = 4 * n + 2 * r + e;
            float p = ex2(__fmaf_rn(s[x], kLog2e, -(r ? l1 : l0)));
            if (edge) {
              const int col = k0 + 8 * n + c0 + e;
              const int row = r ? row1 : row0;
              if (col >= s_len || (causal && col > row) ||
                  (window > 0 && col <= row - window))
                p = 0.f;
            }
            dp[x] = __fmul_rn(p, __fsub_rn(dp[x], r ? d1 : d0));
          }
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
      split_fragments<BK>(dp, hi, lo);
      // dQ += dS_hi K + dS_lo K
      fence_all(acc);
      fence_all(hi);
      fence_all(lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = KT::mn_major(k_st + kk * 16 * KT::kRowBytes);
        wgmma_rs<D>(acc, hi[kk], db, 1);
        wgmma_rs<D>(acc, lo[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_all(acc);
    }
    if (lane == 0) mbar_arrive(kv_empty + 8 * st);
  }
  // dq = bf16(scale dQ); rows past T are not stored
  const size_t row_stride = (size_t)heads * HD;
  store_rows<D>(acc, dq + ((size_t)b * t_len * heads + h) * HD + c0, row0,
                row1, t_len, row_stride, scale, HD);
}

// ------------------------------------------------------------- dK, dV
// Grid: (B * HK, ceil(S / 128)); blockIdx.y counts the key tiles from the
// first, whose causal query range is the longest.
template <int D>
struct DkvSmem {
  static constexpr int BQ = 64;                  // queries a stage
  // each tile's dK and dV products go to fresh accumulators of PN columns
  // (one 64-column box of the MN-major operand at most), then into the
  // running sums in IEEE adds
  static constexpr int PN = D < 64 ? D : 64;
  using KT = Tile<D, 128>;                       // K and V: 128 keys
  using QT = Tile<D, BQ>;                        // qs and dO
  static constexpr int kRowsBytes = 8 * BQ;      // lse log2(e), Drow
  static constexpr size_t kBars = 8 * (1 + 2 * kStages);
  static constexpr size_t kBytes = 2 * KT::kBytes +
                                   kStages * (2 * QT::kBytes + kRowsBytes) +
                                   kBars + 1024;
};

template <int D, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_sm90_dkv_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_qs,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse2,
                           const float* __restrict__ drow,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int t_len,
                           int t_pad, int s_len, int heads, int kv_heads,
                           int causal, int window) {
  if (!kWindow) window = 0;  // the instance without a window's terms
  constexpr int BQ = DkvSmem<D>::BQ;
  constexpr int PN = DkvSmem<D>::PN;
  using KT = typename DkvSmem<D>::KT;
  using QT = typename DkvSmem<D>::QT;
  constexpr int kRowsBytes = DkvSmem<D>::kRowsBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = sk + KT::kBytes;
  const uint32_t sq = sv + KT::kBytes;                   // + st * QT::kBytes
  const uint32_t sdo = sq + kStages * QT::kBytes;
  const uint32_t srow = sdo + kStages * QT::kBytes;      // + st * kRowsBytes
  const uint32_t kv_full = srow + kStages * kRowsBytes;
  const uint32_t q_full = kv_full + 8;                   // + 8 * st
  const uint32_t q_empty = q_full + 8 * kStages;         // + 8 * st
  const float* rows_ptr =
      reinterpret_cast<const float*>(smem_raw + (srow - raw));

  const int bhk = blockIdx.x;
  const int b = bhk / kv_heads;
  const int hk = bhk - b * kv_heads;
  const int group = heads / kv_heads;
  const int k0 = blockIdx.y * 128;
  const int n_q = (t_len + BQ - 1) / BQ;
  // causal: query tiles before k0 see none of these keys; with a window,
  // nor do those from key k0 + 127 + window on
  const int i0 = causal ? min(k0 / BQ, n_q) : 0;
  const int i1 =
      window > 0 ? min(n_q, (k0 + 127 + window - 1) / BQ + 1) : n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(q_full + 8 * st, 1);
      mbar_init(q_empty + 8 * st, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ring step it is query tile i0 + it % per_head of query head
  // hk * group + it / per_head; thread 0 loads it into its stage once every
  // warp has released the step the stage held
  const int per_head = max(i1 - i0, 0);
  const int n_it = group * per_head;
  const auto load_q = [&](int it) {
    const int st = it % kStages;
    const int g = it / per_head;
    const int h = hk * group + g;
    const int q0 = (i0 + it - g * per_head) * BQ;
    const size_t row_off = ((size_t)b * heads + h) * t_pad + q0;
    const uint32_t bar = q_full + 8 * st;
    mbar_wait(q_empty + 8 * st, ((it / kStages) & 1) ^ 1);
    mbar_expect_tx(bar, 2 * QT::kBytes + kRowsBytes);
    for (int x = 0; x < QT::kBoxes; ++x) {
      tma_load(sq + st * QT::kBytes + x * QT::kBoxBytes, &tm_qs, bar, x * 64,
               h, q0, b);
      tma_load(sdo + st * QT::kBytes + x * QT::kBoxBytes, &tm_do, bar,
               x * 64, h, q0, b);
    }
    const uint32_t rows_st = srow + st * kRowsBytes;
    bulk_load(rows_st, lse2 + row_off, 4 * BQ, bar);
    bulk_load(rows_st + 4 * BQ, drow + row_off, 4 * BQ, bar);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * KT::kBytes);
    for (int x = 0; x < KT::kBoxes; ++x) {
      tma_load(sk + x * KT::kBoxBytes, &tm_k, kv_full, x * 64, hk, k0, b);
      tma_load(sv + x * KT::kBoxBytes, &tm_v, kv_full, x * 64, hk, k0, b);
    }
    for (int it = 0; it < min(kAhead, n_it); ++it) load_q(it);
  }

  const int cw = threadIdx.x / 128;        // keys cw * 64 .. of the tile
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int c0 = (lane & 3) * 2;
  const int kw = k0 + cw * 64;             // the warpgroup's first key
  const int key0 = kw + (t >> 5) * 16 + (lane >> 2);
  const int key1 = key0 + 8;               // the accumulators' two rows
  const uint32_t k_wg = sk + cw * 64 * KT::kRowBytes;
  const uint32_t v_wg = sv + cw * 64 * KT::kRowBytes;

  float dk_acc[D / 2], dv_acc[D / 2];
  zero_all(dk_acc);
  zero_all(dv_acc);
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    if (threadIdx.x == 0 && it + kAhead < n_it) load_q(it + kAhead);
    const int st = it % kStages;
    const int q0 = (i0 + it % per_head) * BQ;
    mbar_wait(q_full + 8 * st, (it / kStages) & 1);
    // else every query is above the keys, or past their windows
    if ((!causal || q0 + BQ - 1 >= kw) &&
        (window == 0 || q0 <= kw + 63 + window - 1)) {
      const uint32_t q_st = sq + st * QT::kBytes;
      const uint32_t do_st = sdo + st * QT::kBytes;
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(s, KT::k_major(k_wg + KT::k_step(kk)),
                     QT::k_major(q_st + QT::k_step(kk)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dp, KT::k_major(v_wg + KT::k_step(kk)),
                     QT::k_major(do_st + QT::k_step(kk)), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_all(s);
      fence_all(dp);
      // P^T = exp(S^T - lse) with queries on the columns, 0 past T and
      // where the query is before the key; dS^T = P^T (dP^T - Drow)
      const float* lse_st = rows_ptr + st * (kRowsBytes / 4);
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
            const int j = 4 * n + 2 * r + e;
            float p = ex2(__fmaf_rn(s[j], kLog2e, -l));
            if (edge) {
              const int query = q0 + col;
              const int key = r ? key1 : key0;
              if (query >= t_len || (causal && query < key) ||
                  (window > 0 && query >= key + window))
                p = 0.f;
            }
            s[j] = p;
            dp[j] = __fmul_rn(p, __fsub_rn(dp[j], dr));
          }
        }
      uint32_t pf[BQ / 16][4], hi[BQ / 16][4], lo[BQ / 16][4];
      pack_fragments<BQ>(s, pf);
      split_fragments<BQ>(dp, hi, lo);
      // dV += bf16(P^T) dO; dK += dS^T_hi qs + dS^T_lo qs: the tile's
      // products in fresh accumulators of PN columns (box c of dO and qs),
      // added to the running sums in IEEE adds
      fence_all(pf);
      fence_all(hi);
      fence_all(lo);
#pragma unroll
      for (int c = 0; c < D / PN; ++c) {
        const uint32_t box = c * QT::kBoxBytes;
        float pv[PN / 2], pk[PN / 2];
        zero_all(pv);
        zero_all(pk);
        fence_all(pv);
        fence_all(pk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint32_t off = box + kk * 16 * QT::kRowBytes;
          wgmma_rs<PN>(pv, pf[kk], QT::mn_major(do_st + off), 1);
          wgmma_rs<PN>(pk, hi[kk], QT::mn_major(q_st + off), 1);
          wgmma_rs<PN>(pk, lo[kk], QT::mn_major(q_st + off), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_all(pv);
        fence_all(pk);
        add_part<D, PN>(dv_acc, pv, c);
        add_part<D, PN>(dk_acc, pk, c);
      }
    }
    if (lane == 0) mbar_arrive(q_empty + 8 * st);
  }
  // dk, dv in bf16; keys past S are not stored
  const size_t row_stride = (size_t)kv_heads * HD;
  const size_t off = ((size_t)b * s_len * kv_heads + hk) * HD + c0;
  store_rows<D>(dk_acc, dk + off, key0, key1, s_len, row_stride, 1.f, HD);
  store_rows<D>(dv_acc, dv + off, key0, key1, s_len, row_stride, 1.f, HD);
}

// -------------------------------------------------------------- host
int t_pad_of(int t_len) { return (t_len + kRowPad - 1) / kRowPad * kRowPad; }

// A 4-D map of a contiguous (batch, len, heads, hd) bf16 tensor, innermost
// first: (hd, heads, len, batch), box (kCols, 1, rows, 1).  Rows past len,
// and columns past hd (112 in the D = 128 instances), read as 0.
template <int D>
int encode(CUtensorMap* map, const void* ptr, int batch, int len, int heads,
           int hd, int rows) {
  using G = Tile<D, 64>;  // the box's row width and swizzle
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * heads,
                                 2ull * hd * heads * len};
  const cuuint32_t box[4] = {(cuuint32_t)G::kCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed - (int)r;
}

template <int D, int HD, bool kWindow>
int launch_impl(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* dk,
                void* dv, void* work, int batch, int t_len, int s_len,
                int heads, int kv_heads, int causal, float scale, int window,
                cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = DkvSmem<D>::BQ;
  // set once per instance (thread-safe static initialisation)
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      fa_bwd_sm90_dq_kernel<D, HD, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DqSmem<D>::kBytes);
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      fa_bwd_sm90_dkv_kernel<D, HD, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DkvSmem<D>::kBytes);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  const int t_pad = t_pad_of(t_len);
  const size_t rows = (size_t)batch * heads * t_pad;
  float* lse2 = static_cast<float*>(work);
  float* drow = lse2 + rows;
  bf16* qs = reinterpret_cast<bf16*>(drow + rows);

  const long long threads = (long long)rows * (D / 8);
  const unsigned prep_blocks =
      (unsigned)((threads + kPrepThreads - 1) / kPrepThreads);
  fa_bwd_sm90_prep_kernel<D, HD><<<prep_blocks, kPrepThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), qs,
      lse2, drow, batch, t_len, t_pad, heads, scale);
  cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;

  constexpr int BK = DqSmem<D>::BK;
  CUtensorMap tq128, tdo128, tkbk, tvbk, tk128, tv128, tqbq, tdobq;
  int err = encode<D>(&tq128, qs, batch, t_len, heads, HD, 128);
  if (err == 0) err = encode<D>(&tdo128, dout, batch, t_len, heads, HD, 128);
  if (err == 0) err = encode<D>(&tkbk, k, batch, s_len, kv_heads, HD, BK);
  if (err == 0) err = encode<D>(&tvbk, v, batch, s_len, kv_heads, HD, BK);
  if (err == 0) err = encode<D>(&tk128, k, batch, s_len, kv_heads, HD, 128);
  if (err == 0) err = encode<D>(&tv128, v, batch, s_len, kv_heads, HD, 128);
  if (err == 0) err = encode<D>(&tqbq, qs, batch, t_len, heads, HD, BQ);
  if (err == 0) err = encode<D>(&tdobq, dout, batch, t_len, heads, HD, BQ);
  if (err != 0) return err;

  const dim3 grid_q(batch * heads, (t_len + 127) / 128);
  fa_bwd_sm90_dq_kernel<D, HD, kWindow>
      <<<grid_q, kThreads, DqSmem<D>::kBytes, stream>>>(
          tq128, tdo128, tkbk, tvbk, lse2, drow, static_cast<bf16*>(dq),
          t_len, t_pad, s_len, heads, kv_heads, causal, scale, window);
  launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  const dim3 grid_k(batch * kv_heads, (s_len + 127) / 128);
  fa_bwd_sm90_dkv_kernel<D, HD, kWindow>
      <<<grid_k, kThreads, DkvSmem<D>::kBytes, stream>>>(
          tk128, tv128, tqbq, tdobq, lse2, drow, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), t_len, t_pad, s_len, heads, kv_heads,
          causal, window);
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

// Bytes of the scratch ``work`` that flash_attention_bwd_sm90_launch takes
// for these sizes: lse log2(e) and Drow, (batch, heads, T_pad) f32 each
// (T_pad = t_len rounded up to 128), then qs, (batch, t_len, heads,
// head_dim) bf16.  s_len and kv_heads are not needed (the f32 backward's
// function takes the same arguments).
size_t flash_attention_bwd_sm90_work_bytes(int batch, int t_len, int s_len,
                                           int heads, int kv_heads,
                                           int head_dim) {
  return fa_bwd_bf16_work_bytes(batch, t_len, s_len, heads, kv_heads,
                                head_dim);
}

// q, o, dout, dq: (batch, t_len, heads, head_dim); k, v, dk, dv: (batch,
// s_len, kv_heads, head_dim); all contiguous bf16, 16-byte aligned.  lse
// (the forward's m + log(l)) is (batch, heads, t_len) f32; ``work`` is
// scratch of flash_attention_bwd_sm90_work_bytes(batch, t_len, s_len,
// heads, kv_heads, head_dim) bytes, 16-byte aligned, written here.
// head_dim in {16, 32, 64, 112, 128}; heads % kv_heads == 0; t_len, s_len
// >= 1; batch * heads < 2^31 and ceil(t_len / 128), ceil(s_len / 128) <=
// 65535.  ``scale`` is
// the forward's f32(bf16(head_dim^-1/2)); ``window`` the forward's (0 is
// none).  Launches the three kernels on
// ``stream`` and returns the first nonzero cudaGetLastError(),
// cudaErrorInvalidValue for an unsupported head_dim, -1 if libcuda has no
// cuTensorMapEncodeTiled, or -1000 - r if it returned CUresult r.
int flash_attention_bwd_sm90_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* dq, void* dk, void* dv, void* work,
                                    int batch, int t_len, int s_len,
                                    int heads, int kv_heads, int head_dim,
                                    int causal, float scale, int window,
                                    void* stream) {
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
    case 112:  // D = 128 instances, columns past 112 zero-filled
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

}  // extern "C"
