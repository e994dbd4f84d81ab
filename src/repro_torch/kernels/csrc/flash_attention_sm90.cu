// Flash attention for Hopper tensor cores (wgmma + TMA), bf16.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel of
// src/repro/kernels/flash_attention.py (flash_attention_tpu, _kernel),
// and computes what the JAX model's prefill attention,
// src/repro/models/attention.py (flash_attention), computes in bf16:
//
//   qs      = bf16(f32(q) * f32(bf16(D^-1/2)))      (attention.py:46)
//   s[i, j] = qs[i] . k[j], summed in f32            (wgmma, f32 accumulators)
//   s[i, j] = -1e30 where j >= S, or j > i when causal (aligned top left),
//             or j <= i - window with a window (attention.py:81-82)
//   online softmax over spans of the caller's kv_chunk keys (attention.py:
//   84-93): m_span = max(m, row max over the span); p = exp(s - m_span);
//   l = l exp(m - m_span) + sum p, in f32
//   acc     = acc exp(m - m_span) + bf16(p) . v, summed in f32
//                                                    (wgmma, P from registers)
//   out     = bf16_rn(acc / max(l, 1e-30))
//   lse     = m + log(l), f32 (optional: the backward's row statistic)
//
// f32 inputs go to flash_attention_f32_sm90.cu, which keeps the Pallas
// kernel's f32 function.  q (B, T, H, D), k and v (B, S, HK, D), out
// (B, T, H, D), all contiguous bf16, D in {16, 32, 64, 112, 128}, H % HK
// == 0; lse (B, H, T) f32 or null.
//
// Head dim 112 (zamba2-7b) runs a D = 128 instance compiled for a true
// width of 112 (HD; D = 128 keeps its own instance): the tensor maps keep
// the true width, so TMA fills columns 112-127 of every Q, K and V tile
// with zeros, which add exact zeros to Q K^T and give zero columns of O
// that are not stored.  Nothing is padded in device memory.
//
// The sliding window (``window`` > 0; zamba2's shared attention, 4096):
// a query tile's loop starts at the span (of the caller's kv_chunk keys,
// aligned to key 0, as the JAX model's chunks are) that holds its first
// in-window key, so each span covers the keys of one of the JAX model's
// chunks and P takes its bits.  A span wholly outside the window adds
// p = 1 terms in the JAX model, which the next live span multiplies by
// exp(-1e30 - m) = 0: skipping them is exact.  A row whose running max is
// still -1e30 here (every key it has seen lies outside the window) takes
// m log2(e) = 0, so that p and the correction are 0 and not exp2 of the
// rounding error of -1e30 log2(e) (2^72, which is inf): its sums stay 0
// until its first live key, as the JAX model's are multiplied to 0 there.
//
// The span.  P is rounded to bf16 against the running max, so the span
// the max runs over is part of the function: the JAX model takes it from
// the config's kv_chunk (1024 in every full config).  The kernel's KV tile
// stays 128 keys; a span is span_tiles of them.  With one tile a span the
// kernel makes one pass, as it always did.  With more, it makes two passes
// over each span: the first runs only S = qs K^T over the span's tiles for
// m_span (the producer loads K alone), the second recomputes S with the
// same wgmma sequence (the same bits), forms p against m_span, and applies
// the correction to O and l once, at the span's start.  That costs one
// more Q K^T per span: up to 1.5x the forward's products.
//
// What bounds it on this card: operations.  Causal attention is
// 4 B H T S D / 2 FLOPs (two products over the lower triangle): 137 GFLOP
// at (1, 8192, 16, 64), 0.139 ms at the dense bf16 tensor-core rate of
// 989 TFLOP/s, against 0.020 ms to move q, k, v and out once at 3.35 TB/s.
// The design keeps both products on the tensor cores and the loads off
// the threads that compute:
//   * one block of 384 threads per (b * h, 128 query rows), the heaviest
//     causal tiles launched first.  Warpgroup 0 is the producer: one
//     thread issues the TMA loads.  Warpgroups 1 and 2 each own 64 query
//     rows (wgmma's M) and run the softmax on their own accumulators;
//     setmaxnreg moves registers from the producer to them;
//   * K and V tiles of 128 keys x D, bf16, in a 2-stage ring of shared
//     memory guarded by full / empty mbarriers, loaded by TMA in the
//     swizzle that wgmma reads: 128B for rows of 64 columns (D = 64, and
//     D = 128 as two 64-column boxes), 64B at D = 32, 32B at D = 16;
//   * S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory;
//   * O += P V: P goes from the S accumulators to bf16 A fragments in
//     registers (the accumulator's thread / row mapping is the A
//     fragment's), V is the MN-major B operand (the transpose bit);
//   * row max and row sum over the 4 threads of a quad; the correction
//     scales O in registers; only the causal diagonal and the last S tile
//     are masked, and KV tiles above the diagonal are skipped;
//   * ragged T and S: the tensor maps are 4-D, (D, heads, T or S, B), so
//     TMA zero-fills rows past T or S inside a batch; rows past T are
//     never stored; GQA reads KV head h / (H / HK) as a TMA coordinate.
// Softmax and GEMM do not overlap inside a warpgroup and the two
// consumers are not ping-ponged: this is the simple version of the shape.
// The build passes --fmad=false, so the softmax's multiply-adds are
// written as fmaf; exp(x - m) is exp2f(x log2(e) - m log2(e)).
#include <cuda_bf16.h>

#include "sm90_bf16.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kBM = 128;       // query rows per block
constexpr int kBN = 128;       // keys per KV tile
constexpr int kThreads = 384;  // the producer and two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kEmptyArrivals = 8;  // one per consumer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.44269504088896340736f;

template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;          // columns a box
  static constexpr int kRowBytes = 2 * kCols;            // 32, 64, 128
  static constexpr int kBoxes = D / kCols;               // 2 at D = 128
  static constexpr int kBoxBytes = kBN * kRowBytes;      // 128 rows
  static constexpr int kBytes = kBoxes * kBoxBytes;      // 128 x D bf16
  static constexpr int kStepsPerBox = kRowBytes / 32;    // k16 steps a row
  // the wgmma descriptor's layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr int kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  // Q, two K and two V tiles, the barriers, and room to align to 1024
  static constexpr size_t kSmem = 5 * (size_t)kBytes + 64 + 1024;
};

// ------------------------------------------------------------- wgmma
// A K-major operand (Q, K): swizzled rows of kRowBytes, 8-row groups
// 8 * kRowBytes apart; the leading offset is unused.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  using G = Tile<D>;
  return make_desc(addr, 16, 8 * G::kRowBytes, G::kLayout);
}

// The MN-major operand (V): 8-key groups 8 * kRowBytes apart (stride),
// 64-column boxes kBoxBytes apart (leading; only D = 128 has two).
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  using G = Tile<D>;
  return make_desc(addr, G::kBoxBytes, 8 * G::kRowBytes, G::kLayout);
}

// S = qs K^T of the KV tile at key k0 (K at k_st in shared memory), masked
// to -1e30 past S and, when causal, above the diagonal: s[4n + 2i + e] is
// (row i ? row1 : row0, column k0 + 8n + c0 + e).  ``first_row`` is the
// warpgroup's first query row.
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[64], uint32_t q_wg,
                                            uint32_t k_st, int k0, int s_len,
                                            int causal, int window,
                                            int first_row, int row0,
                                            int row1, int c0) {
  using G = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / G::kStepsPerBox) * G::kBoxBytes +
                         (kk % G::kStepsPerBox) * 32;
    wgmma_ss<kBN>(s, desc_k_major<D>(q_wg + off),
                  desc_k_major<D>(k_st + off), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(s[i]);
  if (k0 + kBN > s_len || (causal && k0 + kBN - 1 > first_row) ||
      (window > 0 && k0 <= first_row + 63 - window)) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * n + c0 + e;
        const bool out_s = col >= s_len;
        if (out_s || (causal && col > row0) ||
            (window > 0 && col <= row0 - window))
          s[4 * n + e] = kNegInf;
        if (out_s || (causal && col > row1) ||
            (window > 0 && col <= row1 - window))
          s[4 * n + 2 + e] = kNegInf;
      }
  }
}

// the running row maxima of a thread's two rows over its columns of s
__device__ __forceinline__ void row_max(const float (&s)[64], float& mx0,
                                        float& mx1) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
}

// ------------------------------------------------------------ kernel
// Grid: (B * H, ceil(T / 128)); block: 384 threads.  blockIdx.y counts the
// query tiles from the last, so that the causal tiles with the most KV
// tiles start first.  HD is the tensors' true head dim (D, or 112 in a
// D = 128 instance).
template <int D, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                __nv_bfloat16* __restrict__ out,
                                float* __restrict__ lse, int t_len,
                                int s_len, int heads, int kv_heads,
                                int causal, float scale, int span_tiles,
                                int window) {
  if (!kWindow) window = 0;  // the instance without a window's terms
  using G = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* q_tile_ptr = smem_raw + (base - raw);
  const uint32_t sq = base;                    // Q, 128 x D
  const uint32_t sk = base + G::kBytes;        // K, 2 stages
  const uint32_t sv = base + 3 * G::kBytes;    // V, 2 stages
  const uint32_t q_full = base + 5 * G::kBytes;
  const uint32_t kv_full = q_full + 8;         // + 8 * stage
  const uint32_t kv_empty = q_full + 24;       // + 8 * stage

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int q0 = q_tile * kBM;
  int n_kv = (s_len + kBN - 1) / kBN;
  if (causal) n_kv = min(n_kv, q_tile + 1);  // skip tiles above the diagonal
  // with a window, start at the span that holds the tile's first live key
  const int j_first =
      window > 0 ? max(q0 - window + 1, 0) / kBN / span_tiles * span_tiles
                 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, G::kBytes);
      for (int x = 0; x < G::kBoxes; ++x)
        tma_load(sq + x * G::kBoxBytes, &tm_q, q_full, x * 64, h, q0, b);
      // the consumers' schedule: for each span, its tiles' K alone (the
      // max pass, when a span has more than one tile), then K and V
      int it = 0;  // ring step
      for (int j0 = j_first; j0 < n_kv; j0 += span_tiles) {
        const int j1 = min(j0 + span_tiles, n_kv);
        for (int pass = span_tiles > 1 ? 0 : 1; pass < 2; ++pass)
          for (int j = j0; j < j1; ++j, ++it) {
            const int st = it & 1;
            mbar_wait(kv_empty + 8 * st, ((it >> 1) & 1) ^ 1);
            mbar_expect_tx(kv_full + 8 * st, (1 + pass) * G::kBytes);
            for (int x = 0; x < G::kBoxes; ++x) {
              tma_load(sk + st * G::kBytes + x * G::kBoxBytes, &tm_k,
                       kv_full + 8 * st, x * 64, hk, j * kBN, b);
              if (pass == 1)
                tma_load(sv + st * G::kBytes + x * G::kBoxBytes, &tm_v,
                         kv_full + 8 * st, x * 64, hk, j * kBN, b);
            }
          }
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;                   // rows cw * 64 .. of the tile
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int c0 = (lane & 3) * 2;           // first column of an 8-group
  const int row0 = q0 + cw * 64 + (t >> 5) * 16 + (lane >> 2);
  const int row1 = row0 + 8;               // the accumulators' two rows

  // qs = bf16(q * bf16(D^-1/2)) in place, then hand the tile to wgmma
  mbar_wait(q_full, 0);
  {
    uint4* qv = reinterpret_cast<uint4*>(q_tile_ptr);
    for (int i = threadIdx.x - 128; i < G::kBytes / 16; i += kConsumers) {
      uint4 w = qv[i];
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 f = __bfloat1622float2(e[c]);
        e[c] = __floats2bfloat162_rn(__fmul_rn(f.x, scale),
                                     __fmul_rn(f.y, scale));
      }
      qv[i] = w;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const uint32_t q_wg = sq + cw * 64 * G::kRowBytes;

  int it = 0;  // ring step, as the producer counts it
  for (int j0 = j_first; j0 < n_kv; j0 += span_tiles) {
    const int j1 = min(j0 + span_tiles, n_kv);
    // the span's max: a pass of Q K^T alone when the span has more tiles
    float mx0 = m0, mx1 = m1;
    if (span_tiles > 1) {
      for (int j = j0; j < j1; ++j, ++it) {
        const int st = it & 1;
        mbar_wait(kv_full + 8 * st, (it >> 1) & 1);
        float s[64];
        tile_scores<D>(s, q_wg, sk + st * G::kBytes, j * kBN, s_len, causal,
                       window, q0 + cw * 64, row0, row1, c0);
        if (lane == 0) mbar_arrive(kv_empty + 8 * st);
        row_max(s, mx0, mx1);
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
    }
    float ml0 = 0.f, ml1 = 0.f, corr0 = 1.f, corr1 = 1.f;
    float ls0 = 0.f, ls1 = 0.f;  // the span's sum of p
    for (int j = j0; j < j1; ++j, ++it) {
      const int st = it & 1;
      const uint32_t v_st = sv + st * G::kBytes;
      mbar_wait(kv_full + 8 * st, (it >> 1) & 1);
      float s[64];
      tile_scores<D>(s, q_wg, sk + st * G::kBytes, j * kBN, s_len, causal,
                     window, q0 + cw * 64, row0, row1, c0);
      if (span_tiles == 1) {
        row_max(s, mx0, mx1);
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
      }
      if (j == j0) {
        // once a span: m_span = max(m, max s); O = O exp(m - m_span)
        // (m_span log2(e) = 0 while every key a row has seen is masked)
        ml0 = window > 0 && mx0 <= kNegInf ? 0.f : __fmul_rn(mx0, kLog2e);
        ml1 = window > 0 && mx1 <= kNegInf ? 0.f : __fmul_rn(mx1, kLog2e);
        corr0 = exp2f(__fmaf_rn(m0, kLog2e, -ml0));
        corr1 = exp2f(__fmaf_rn(m1, kLog2e, -ml1));
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n] = __fmul_rn(o[4 * n], corr0);
          o[4 * n + 1] = __fmul_rn(o[4 * n + 1], corr0);
          o[4 * n + 2] = __fmul_rn(o[4 * n + 2], corr1);
          o[4 * n + 3] = __fmul_rn(o[4 * n + 3], corr1);
        }
      }
      // p = exp(s - m_span)
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * n + e] = exp2f(__fmaf_rn(s[4 * n + e], kLog2e, -ml0));
          s[4 * n + 2 + e] =
              exp2f(__fmaf_rn(s[4 * n + 2 + e], kLog2e, -ml1));
          sum0 = __fadd_rn(sum0, s[4 * n + e]);
          sum1 = __fadd_rn(sum1, s[4 * n + 2 + e]);
        }
      ls0 = __fadd_rn(ls0, quad_sum(sum0));
      ls1 = __fadd_rn(ls1, quad_sum(sum1));

      // P in bf16 as the A fragments of the 8 k16 steps over the tile's
      // keys: step kk takes the accumulator columns of 8-groups 2 kk and
      // 2 kk + 1
      uint32_t p[8][4];
      pack_fragments<kBN>(s, p);

      // O += P V
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) fence_reg(p[kk][r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<D>(o, p[kk],
                    desc_mn_major<D>(v_st + kk * 16 * G::kRowBytes), 1);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
      if (lane == 0) mbar_arrive(kv_empty + 8 * st);
    }
    // l = l exp(m - m_span) + the span's sum; m = m_span
    l0 = __fmaf_rn(l0, corr0, ls0);
    l1 = __fmaf_rn(l1, corr1, ls1);
    m0 = mx0;
    m1 = mx1;
  }

  // out = bf16(O / max(l, 1e-30)), lse = m + log(l); rows past T are not
  // stored
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {
    float* lb = lse + ((size_t)b * heads + h) * t_len;
    if (row0 < t_len) lb[row0] = __fadd_rn(m0, logf(l0));
    if (row1 < t_len) lb[row1] = __fadd_rn(m1, logf(l1));
  }
  // out rows of the true head dim HD (columns past it are zeros)
  const size_t row_stride = (size_t)heads * HD;
  __nv_bfloat16* ob = out + ((size_t)b * t_len * heads + h) * HD + c0;
  if (row0 < t_len) {
    __nv_bfloat16* dst = ob + (size_t)row0 * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n < HD)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * n], d0),
                                  __fdiv_rn(o[4 * n + 1], d0));
  }
  if (row1 < t_len) {
    __nv_bfloat16* dst = ob + (size_t)row1 * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n < HD)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * n + 2], d1),
                                  __fdiv_rn(o[4 * n + 3], d1));
  }
}

// -------------------------------------------------------------- host
// A 4-D map of a contiguous (batch, len, heads, hd) bf16 tensor, innermost
// first: (hd, heads, len, batch), box (kCols, 1, 128, 1).  Rows past len,
// and columns past hd (112 in the HD = 112 instance), read as 0.
template <int D>
int encode(CUtensorMap* map, const void* ptr, int batch, int len,
           int heads, int hd) {
  using G = Tile<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * heads,
                                 2ull * hd * heads * len};
  const cuuint32_t box[4] = {(cuuint32_t)G::kCols, 1, (cuuint32_t)kBN, 1};
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
int launch_impl(const void* q, const void* k, const void* v, void* o,
                void* lse, int batch, int t_len, int s_len, int heads,
                int kv_heads, int causal, float scale, int span_tiles,
                int window, cudaStream_t stream) {
  using G = Tile<D>;
  // set once per instance (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D, HD, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  int err = encode<D>(&tq, q, batch, t_len, heads, HD);
  if (err == 0) err = encode<D>(&tk, k, batch, s_len, kv_heads, HD);
  if (err == 0) err = encode<D>(&tv, v, batch, s_len, kv_heads, HD);
  if (err != 0) return err;
  const dim3 grid(batch * heads, (t_len + kBM - 1) / kBM);
  flash_attention_sm90_kernel<D, HD, kWindow><<<grid, kThreads, G::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      t_len, s_len, heads, kv_heads, causal, scale, span_tiles, window);
  return (int)cudaGetLastError();
}

// a call without a window runs an instance with none of the window's terms
template <int D, int HD = D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int t_len, int s_len, int heads, int kv_heads,
           int causal, float scale, int span_tiles, int window,
           cudaStream_t stream) {
  return window > 0
             ? launch_impl<D, HD, true>(q, k, v, o, lse, batch, t_len, s_len,
                                        heads, kv_heads, causal, scale,
                                        span_tiles, window, stream)
             : launch_impl<D, HD, false>(q, k, v, o, lse, batch, t_len,
                                         s_len, heads, kv_heads, causal,
                                         scale, span_tiles, 0, stream);
}

}  // namespace

extern "C" {

// q, o: (batch, t_len, heads, head_dim); k, v: (batch, s_len, kv_heads,
// head_dim); contiguous bf16, 16-byte aligned; head_dim in {16, 32, 64,
// 112, 128}; heads % kv_heads == 0; t_len, s_len >= 1; batch * heads < 2^31 and
// ceil(t_len / 128) <= 65535.  ``lse`` is null or (batch, heads, t_len)
// f32, written with each row's m + log(l).  ``scale`` is
// f32(bf16(head_dim^-1/2)).  P is rounded against the running max of spans
// of ``span_tiles`` 128-key tiles (>= 1).  ``window`` > 0 also masks key j
// for query i where j <= i - window; 0 is no window.  Launches on ``stream`` and
// returns its cudaGetLastError(), or cudaErrorInvalidValue for an
// unsupported head_dim or span, -1 if libcuda has no
// cuTensorMapEncodeTiled, or -1000 - r if it returned CUresult r.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int batch, int t_len,
                                int s_len, int heads, int kv_heads,
                                int head_dim, int causal, float scale,
                                int span_tiles, int window, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (span_tiles < 1 || window < 0) return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, o, lse, batch, t_len, s_len, heads,
                        kv_heads, causal, scale, span_tiles, window, st);
    case 32:
      return launch<32>(q, k, v, o, lse, batch, t_len, s_len, heads,
                        kv_heads, causal, scale, span_tiles, window, st);
    case 64:
      return launch<64>(q, k, v, o, lse, batch, t_len, s_len, heads,
                        kv_heads, causal, scale, span_tiles, window, st);
    case 112:  // a D = 128 instance, columns past 112 zero-filled
      return launch<128, 112>(q, k, v, o, lse, batch, t_len, s_len, heads,
                              kv_heads, causal, scale, span_tiles, window,
                              st);
    case 128:
      return launch<128>(q, k, v, o, lse, batch, t_len, s_len, heads,
                         kv_heads, causal, scale, span_tiles, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
