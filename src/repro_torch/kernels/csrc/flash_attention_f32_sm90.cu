// Flash attention for Hopper tensor cores (3xTF32 wgmma + TMA), f32.
//
// Replaces, for f32 inputs, the Pallas TPU kernel of
// src/repro/kernels/flash_attention.py (flash_attention_tpu, _kernel), and
// computes its f32 function (bf16 inputs go to flash_attention_sm90.cu):
//
//   qs      = f32(q * f32(D^-1/2)), rounded before the product
//   s[i, j] = qs[i] . k[j]          (3xTF32, f32 accumulators)
//   s[i, j] = -1e30 where j >= S, or j > i when causal (aligned top left),
//             or j <= i - window with a window
//   online softmax over KV tiles: m, l, p in f32, p = exp(s - m)
//   acc    += p . v                 (3xTF32: P kept at f32 accuracy)
//   out     = acc / max(l, 1e-30)
//   lse     = m + log(l)            (optional: the backward's row statistic)
//
// q (B, T, H, D), k and v (B, S, HK, D), out (B, T, H, D), all contiguous
// f32, D in {16, 32, 64, 112, 128}, H % HK == 0; lse (B, H, T) f32 or
// null.  Within 2e-5 of the plain version, not bitwise: the f32 sums run
// in another order.  Head dim 112 runs a D = 128 instance compiled for a
// true width of 112 (HD; D = 128 keeps its own), whose K and V
// maps keep the true width (TMA fills columns 112-127 with zeros), whose q
// loads read zeros past 112, and whose stores stop at 112.  With a window
// (``window`` > 0) a block starts at its first tile that holds a key in
// the window of its first row, a warpgroup skips the tiles wholly before
// its rows' windows, and a row whose keys so far are all masked takes
// m log2(e) = 0, so that p and the correction are 0, never exp2 of the
// rounding error of -1e30 log2(e).
//
// 3xTF32.  The tensor cores multiply TF32 (10 stored mantissa bits).  Each
// operand x is split as hi = cvt.rna.tf32.f32(x) and lo =
// cvt.rna.tf32.f32(x - hi) (x - hi is exact; hi + lo is x within 2^-22
// relative), and every 8-deep k-step issues three wgmma into one f32
// accumulator, small terms first: lo.hi, hi.lo, hi.hi (CUTLASS's
// OpMultiplyAddFastF32).  lo.lo (about 2^-22 relative) is dropped.  The
// operands are split here, never handed over as raw f32 for the hardware
// to cut.  One TF32 product alone is about 1e-3 off at D = 64, far over
// the 2e-5 bar; three products are about 2.5e-7 off.
//
// What bounds it on this card: operations.  Causal attention is
// 4 B H T S D / 2 FLOPs, 8.59 GFLOP at (1, 2048, 16, 64); at f32 accuracy
// on the tensor cores that is 3 x 8.59 GFLOP at the dense TF32 rate of
// 495 TFLOP/s = 0.052 ms, against 0.010 ms to move q, k, v and out once at
// 3.35 TB/s (and 0.128 ms for 8.59 GFLOP at the 67 TFLOP/s of f32 FMAs on
// the CUDA cores, the bound of the design this replaced).  The design,
// after flash_attention_sm90.cu's:
//   * one block of 384 threads per (b * h, 128 query rows), the heaviest
//     causal tiles launched first.  Warpgroup 0 is the producer: one
//     thread issues the TMA loads of q once and of f32 K and V tiles
//     into a ring of staging buffers (2 stages, 1 at D = 64 for want of
//     shared memory).  The maps are 4-D, (D, heads, S, B), so
//     rows past S read as 0 and GQA is a KV-head coordinate; a box is one
//     row of 32 f32 columns (16 at D = 16), 2 or 4 boxes at D = 64 or 128.
//     K lands in the 128B swizzle (64B at D = 16) that wgmma reads, V
//     unswizzled;
//   * the producer warpgroup's 128 threads run the split pass: each staged
//     tile becomes a split set, K_hi and K_lo (element for element, so in
//     the swizzle TMA wrote) and V^T_hi and V^T_lo, in a ring of two sets
//     guarded by full / empty mbarriers, so the split of tile j + 1
//     overlaps the products of tile j.  TF32 wgmma takes only K-major
//     operands (there is no transpose bit for tf32), and V (keys x D, D
//     contiguous) is MN-major for P V: the pass writes V^T (D rows of
//     keys) in the 128B swizzle itself, 16-byte chunk c of row d at chunk
//     c ^ (d & 7), which keeps its stores and wgmma's reads free of bank
//     conflicts;
//   * warpgroups 1 and 2 each own 64 query rows (wgmma's M) and split
//     their scaled q once: up to D = 64 into q_hi / q_lo tiles in shared
//     memory, in place where TMA landed it (K's geometry: 64 rows); at
//     D = 128, where the shared memory is spent, into A fragments in
//     registers (D registers a thread, loaded from device memory);
//   * S = Q K^T: wgmma m64nBNk8, A = q_lo / q_hi from shared memory (or
//     registers at D = 128), B = K_hi / K_lo from shared memory;
//   * O += P V: wgmma m64nDk8, A = P split in registers, B = V^T_hi /
//     V^T_lo, in two halves of the tile's keys so that half of P's
//     fragments are live.  The accumulator is not the TF32 A fragment: in
//     an 8-key step a thread holds S columns (2c, 2c + 1) of rows g and
//     g + 8, where the A fragment takes columns (c, c + 4) (c = lane % 4,
//     g = lane / 4; registers a0..a3 = (g, c), (g + 8, c), (g, c + 4),
//     (g + 8, c + 4): CUTLASS's CLayout_64xN and ALayout_64x8 in
//     cute/atom/mma_traits_sm90_gmma.hpp).  So the kernel permutes the
//     keys of each 8-key step instead of shuffling: A column c is key 2c
//     and column c + 4 is key 2c + 1, and the split pass writes V^T's
//     columns in the same order, keys 0 2 4 6 1 3 5 7
//     (kernels/flash_attention.py, TF32_KEY_ORDER).  The sum over keys
//     does not depend on their order;
//   * row max and row sum over the 4 threads of a quad; exp(s - m) is
//     exp2f(s log2(e) - m log2(e)) with one FMA, as in the bf16 kernel
//     (fewer instructions than expf, as accurate against the 2e-5
//     bar); the correction scales O in
//     registers; only the causal diagonal and the last S tile are masked,
//     KV tiles above the diagonal are skipped by the block, and a
//     consumer whose 64 rows lie wholly above a tile skips its products.
//
// Shared memory (bytes): kStages stages of f32 K and V, two split sets
// (K_hi, K_lo, V^T_hi, V^T_lo) and, up to D = 64, q_hi and q_lo of both
// consumers; tiles of BN x D x 4:
//   D = 16, BN = 64: 16 tiles, 65,536;  D = 32, BN = 64: 16, 131,072;
//   D = 64, BN = 64: 14 (one stage), 229,376;
//   D = 128, BN = 32: 12 (no q tiles), 196,608;
// plus 64 for the barriers and 1,024 of alignment.  Registers: ptxas
// allocates every thread within the launch's 168 (65,536 / 384), and it
// does not raise that for code after setmaxnreg (the bf16 kernel spills
// at D = 128), so this kernel leaves setmaxnreg out and its producer
// warpgroup has the registers the split pass needs.  A consumer holds O
// (D / 2), S (BN / 2) and half of P's fragments (BN / 2): 96 at D = 64,
// where q in shared memory keeps ptxas from spilling and from
// serializing the wgmma.  At D = 128 q's fragments add 128: it spills
// about 400 bytes and serializes the wgmma (ptxas C7512), and the KV
// tile is 32 keys to spill less.  Softmax and products do not overlap
// inside a consumer, and the two consumers are not ping-ponged.  The
// build passes --fmad=false, so multiply-adds are written as fmaf.
#include "sm90_common.cuh"
#include "sm90_tf32.cuh"

namespace {

constexpr int kBM = 128;       // query rows per block
constexpr int kThreads = 384;  // the producer and two consumer warpgroups
constexpr int kProducers = 128;    // the split pass's threads
constexpr int kEmptyArrivals = 8;  // one per consumer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.44269504088896340736f;

template <int D>
struct Tile {
  static constexpr int kBN = D == 128 ? 32 : 64;      // keys per KV tile
  static constexpr int kCols = D < 32 ? D : 32;       // f32 columns a box
  static constexpr int kRowBytes = 4 * kCols;         // 64 or 128
  static constexpr int kBoxes = D / kCols;            // 1, 1, 2, 4
  static constexpr int kBoxBytes = kBN * kRowBytes;   // a box of K or V
  static constexpr int kStepsPerBox = kRowBytes / 32; // k8 steps a K row
  static constexpr int kBytes = kBN * D * 4;          // a tile of K or V
  // K's swizzle (wgmma layout type): 128B, or 64B for rows of 64 bytes
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;
  // V^T: D rows of 32 keys (128 bytes) a box, kBN / 32 boxes
  static constexpr int kVtBoxBytes = D * 128;
  // q's hi / lo in shared memory (the A operand from there) up to D = 64;
  // at D = 128 they stay in registers, for want of shared memory
  static constexpr bool kQSmem = D <= 64;
  // staging stages of (K, V): one at D = 64, where two do not fit
  static constexpr int kStages = D == 64 ? 1 : 2;
  // staged (K, V) x kStages; (K_hi, K_lo, V^T_hi, V^T_lo) x 2; q_hi x 2
  // and q_lo x 2 (64 rows = kBN rows each) where kQSmem
  static constexpr int kTiles = 2 * kStages + 8 + (kQSmem ? 4 : 0);
  // the tiles, 8 barriers, alignment
  static constexpr size_t kSmem = kTiles * (size_t)kBytes + 64 + 1024;
  static_assert(!kQSmem || kBN == 64, "a consumer's q is one K tile");
  static_assert(kSmem <= 232448, "over the block's shared memory");
};

// ------------------------------------------------------------- wgmma
// K (BN keys x D, K-major): swizzled rows of kRowBytes, 8-row groups
// 8 * kRowBytes apart; the leading offset is unused.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  using G = Tile<D>;
  return make_desc(addr, 16, 8 * G::kRowBytes, G::kLayout);
}

// V^T (D x BN keys, K-major): 128B-swizzled rows of 32 keys, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_vt(uint32_t addr) {
  return make_desc(addr, 16, 1024, 1);
}

// ------------------------------------------------------------ kernel
// Grid: (B * H, ceil(T / 128)); block: 384 threads.  blockIdx.y counts the
// query tiles from the last, so that the causal tiles with the most KV
// tiles start first.  HD is the tensors' true head dim (D, or 112 in a
// D = 128 instance).
template <int D, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const float* __restrict__ q,
                               float* __restrict__ out,
                               float* __restrict__ lse, int t_len, int s_len,
                               int heads, int kv_heads, int causal,
                               float scale, int window) {
  if (!kWindow) window = 0;  // the instance without a window's terms
  using G = Tile<D>;
  constexpr int kBN = G::kBN;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  // stage st: staged K at base + 2 st kBytes, V one tile after it; split
  // set st: K_hi, K_lo, V^T_hi, V^T_lo at set(st) + 0, 1, 2, 3 kBytes;
  // consumer cw's q_hi and q_lo (kQSmem) after the two sets
  const auto staged = [&](int st) { return base + 2 * st * G::kBytes; };
  const auto split_set = [&](int st) {
    return base + (2 * G::kStages + 4 * st) * G::kBytes;
  };
  const auto q_hi_at = [&](int cw) {
    return base + (2 * G::kStages + 8 + cw) * G::kBytes;
  };
  const auto q_lo_at = [&](int cw) { return q_hi_at(cw) + 2 * G::kBytes; };
  const uint32_t bars = base + G::kTiles * G::kBytes;
  const uint32_t stage_full = bars;        // + 8 * st, TMA bytes landed
  const uint32_t split_full = bars + 16;   // + 8 * st, split set written
  const uint32_t split_empty = bars + 32;  // + 8 * st, split set read
  const uint32_t q_full = bars + 48;       // + 8 * cw, q landed

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int q0 = q_tile * kBM;
  int n_kv = (s_len + kBN - 1) / kBN;
  // skip the tiles above the diagonal
  if (causal) n_kv = min(n_kv, (q0 + kBM - 1) / kBN + 1);
  // with a window, start at the tile that holds the first row's first key
  const int j_first = window > 0 ? max(q0 - window + 1, 0) / kBN : 0;
  const int n_steps = max(n_kv - j_first, 0);  // ring steps; tile j_first + i

  if (threadIdx.x == 0) {
    for (int st = 0; st < 2; ++st) {
      mbar_init(stage_full + 8 * st, 1);
      mbar_init(split_full + 8 * st, kProducers);
      mbar_init(split_empty + 8 * st, kEmptyArrivals);
      mbar_init(q_full + 8 * st, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------ producer
    const int pt = threadIdx.x;
    const auto load = [&](int i) {  // ring step i: tile j_first + i
      const int j = j_first + i;
      const int st = i % G::kStages;
      mbar_expect_tx(stage_full + 8 * st, 2 * G::kBytes);
      for (int x = 0; x < G::kBoxes; ++x) {
        tma_load(staged(st) + x * G::kBoxBytes, &tm_k, stage_full + 8 * st,
                 x * G::kCols, hk, j * kBN, b);
        tma_load(staged(st) + G::kBytes + x * G::kBoxBytes, &tm_v,
                 stage_full + 8 * st, x * G::kCols, hk, j * kBN, b);
      }
    };
    if (pt == 0) {
      if constexpr (G::kQSmem) {
        // each consumer's 64 rows of q, where any lies before T
        for (int cw = 0; cw < 2; ++cw) {
          if (q0 + 64 * cw >= t_len) continue;
          mbar_expect_tx(q_full + 8 * cw, G::kBytes);
          for (int x = 0; x < G::kBoxes; ++x)
            tma_load(q_hi_at(cw) + x * G::kBoxBytes, &tm_q, q_full + 8 * cw,
                     x * G::kCols, h, q0 + 64 * cw, b);
        }
      }
      for (int i = 0; i < min(n_steps, G::kStages); ++i) load(i);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int st = i & 1;           // the split set
      const int sg = i % G::kStages;  // the staging stage
      mbar_wait(stage_full + 8 * sg, (i / G::kStages) & 1);
      mbar_wait(split_empty + 8 * st, ((i >> 1) & 1) ^ 1);
      // split pass: K element for element; V^T chunk by chunk, where
      // chunk ch of row d holds keys 8 (ch / 2) + 2 i + (ch & 1), i = 0..3
      const uint8_t* stage = base_ptr + (staged(sg) - base);
      uint8_t* set = base_ptr + (split_set(st) - base);
      {
        const float4* ks = reinterpret_cast<const float4*>(stage);
        uint4* kh = reinterpret_cast<uint4*>(set);
        uint4* kl = reinterpret_cast<uint4*>(set + G::kBytes);
#pragma unroll 4
        for (int i = pt; i < G::kBytes / 16; i += kProducers) {
          uint4 hi, lo;
          split_tf32(ks[i], hi, lo);
          kh[i] = hi;
          kl[i] = lo;
        }
        const float* vs = reinterpret_cast<const float*>(stage + G::kBytes);
        uint8_t* vh = set + 2 * G::kBytes;
        uint8_t* vl = set + 3 * G::kBytes;
#pragma unroll 4
        for (int i = pt; i < D * kBN / 4; i += kProducers) {
          const int d = i % D;
          const int ch = i / D;
          const int key = 8 * (ch >> 1) + (ch & 1);
          // V staged unswizzled: box d / kCols of kBN rows x kCols
          const float* src = vs + (d / G::kCols) * (kBN * G::kCols) +
                             key * G::kCols + d % G::kCols;
          const float4 x = make_float4(src[0], src[2 * G::kCols],
                                       src[4 * G::kCols], src[6 * G::kCols]);
          const int off = (ch >> 3) * G::kVtBoxBytes + d * 128 +
                          (((ch & 7) ^ (d & 7)) << 4);
          uint4 hi, lo;
          split_tf32(x, hi, lo);
          *reinterpret_cast<uint4*>(vh + off) = hi;
          *reinterpret_cast<uint4*>(vl + off) = lo;
        }
      }
      // the split set to wgmma's proxy and the consumers
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(split_full + 8 * st);
      // every producer thread has read stage sg: refill it
      asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
      if (pt == 0 && i + G::kStages < n_steps) load(i + G::kStages);
    }
    return;
  }

  // -------------------------------------------------------- consumers
  const int cw = wg - 1;                   // rows cw * 64 .. of the tile
  const int t = threadIdx.x & 127;         // thread in its warpgroup
  const int lane = t & 31;
  const int c = lane & 3;
  const int c0 = 2 * c;                    // first column of an 8-group
  const int rw = q0 + cw * 64;             // the warpgroup's first row
  const int row0 = rw + (t >> 5) * 16 + (lane >> 2);
  const int row1 = row0 + 8;               // the accumulators' two rows

  // a consumer whose 64 rows all lie past T only frees the split sets
  const bool live = rw < t_len;

  // qs = f32(q * D^-1/2), split once: in shared memory (kQSmem), split in
  // place where TMA landed it (hi over the f32, lo beside), or as A
  // fragments of the D / 8 k-steps in registers, register r holding
  // (r & 1 ? row1 : row0, column 8 kk + c + 4 (r >> 1))
  uint32_t q_hi[G::kQSmem ? 1 : D / 8][4], q_lo[G::kQSmem ? 1 : D / 8][4];
  if constexpr (G::kQSmem) {
    if (live) {
      mbar_wait(q_full + 8 * cw, 0);
      uint4* qh = reinterpret_cast<uint4*>(base_ptr + (q_hi_at(cw) - base));
      uint4* ql = reinterpret_cast<uint4*>(base_ptr + (q_lo_at(cw) - base));
      for (int i = t; i < G::kBytes / 16; i += 128) {
        const uint4 w = qh[i];
        const float4 x = make_float4(
            __fmul_rn(__uint_as_float(w.x), scale),
            __fmul_rn(__uint_as_float(w.y), scale),
            __fmul_rn(__uint_as_float(w.z), scale),
            __fmul_rn(__uint_as_float(w.w), scale));
        uint4 hi, lo;
        split_tf32(x, hi, lo);
        qh[i] = hi;
        ql[i] = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // this warpgroup's named barrier, 2 or 3 (the producer's is 1)
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
    }
  } else {
    const size_t row_stride = (size_t)heads * HD;
    const float* qb = q + ((size_t)b * t_len * heads + h) * HD + c;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = (r & 1) ? row1 : row0;
        const int col = 8 * kk + c + 4 * (r >> 1);
        const float* src = qb + row * row_stride + col - c;
        const float x = row < t_len && col < HD
                            ? __fmul_rn(__ldg(src), scale) : 0.f;
        split_tf32(x, q_hi[kk][r], q_lo[kk][r]);
      }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    const int k0 = (j_first + i) * kBN;
    const uint32_t k_hi = split_set(st);
    const uint32_t k_lo = k_hi + G::kBytes;
    const uint32_t vt_hi = k_hi + 2 * G::kBytes;
    const uint32_t vt_lo = k_hi + 3 * G::kBytes;
    // wait even for a tile this warpgroup skips, so that its release of
    // set st counts toward tile j's phase and never tile j - 2's
    mbar_wait(split_full + 8 * st, (i >> 1) & 1);
    // a warpgroup whose rows all lie above this causal tile, or whose
    // windows all start after it, or past T, skips it
    if (!live || (causal && k0 > rw + 63) ||
        (window > 0 && k0 + kBN - 1 <= rw - window)) {
      __syncwarp();
      if (lane == 0) mbar_arrive(split_empty + 8 * st);
      continue;
    }

    // S = qs K^T
    float s[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      // q and K tiles share one geometry: kBN = 64 rows of D columns
      const uint32_t off = (kk / G::kStepsPerBox) * G::kBoxBytes +
                           (kk % G::kStepsPerBox) * 32;
      const uint64_t b_hi = desc_k<D>(k_hi + off);
      const uint64_t b_lo = desc_k<D>(k_lo + off);
      if constexpr (G::kQSmem) {
        const uint64_t a_hi = desc_k<D>(q_hi_at(cw) + off);
        wgmma_tf32_ss<64>(s, desc_k<D>(q_lo_at(cw) + off), b_hi, kk > 0);
        wgmma_tf32_ss<64>(s, a_hi, b_lo, 1);
        wgmma_tf32_ss<64>(s, a_hi, b_hi, 1);
      } else {
        wgmma_3xtf32<kBN>(s, q_hi[kk], q_lo[kk], b_hi, b_lo, kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) fence_reg(s[i]);

    // s[4n + 2i + e] is (row i ? row1 : row0, column k0 + 8n + c0 + e)
    if (k0 + kBN > s_len || (causal && k0 + kBN - 1 > rw) ||
        (window > 0 && k0 <= rw + 63 - window)) {
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
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

    // online softmax: m_new = max(m, max s); p = exp(s - m_new);
    // l = l corr + sum p; O = O corr
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // m log2(e) = 0 while every key a row has seen is masked
    const float ml0 =
        window > 0 && mx0 <= kNegInf ? 0.f : __fmul_rn(mx0, kLog2e);
    const float ml1 =
        window > 0 && mx1 <= kNegInf ? 0.f : __fmul_rn(mx1, kLog2e);
    const float corr0 = exp2f(__fmaf_rn(m0, kLog2e, -ml0));
    const float corr1 = exp2f(__fmaf_rn(m1, kLog2e, -ml1));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * n + e] = exp2f(__fmaf_rn(s[4 * n + e], kLog2e, -ml0));
        s[4 * n + 2 + e] = exp2f(__fmaf_rn(s[4 * n + 2 + e], kLog2e, -ml1));
        sum0 = __fadd_rn(sum0, s[4 * n + e]);
        sum1 = __fadd_rn(sum1, s[4 * n + 2 + e]);
      }
    l0 = __fmaf_rn(l0, corr0, quad_sum(sum0));
    l1 = __fmaf_rn(l1, corr1, quad_sum(sum1));
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] = __fmul_rn(o[4 * n], corr0);
      o[4 * n + 1] = __fmul_rn(o[4 * n + 1], corr0);
      o[4 * n + 2] = __fmul_rn(o[4 * n + 2], corr1);
      o[4 * n + 3] = __fmul_rn(o[4 * n + 3], corr1);
    }

    // O += P V in two halves of the tile's kBN / 8 k-steps, so that only
    // half of P's fragments are live.  P as hi / lo A fragments, keys
    // permuted: A column c is key 2c (s[4n], s[4n + 2]), column c + 4 is
    // key 2c + 1 (s[4n + 1], s[4n + 3])
    constexpr int kHalf = kBN / 16;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t p_hi[kHalf][4], p_lo[kHalf][4];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int n = half * kHalf + i;
        split_tf32(s[4 * n], p_hi[i][0], p_lo[i][0]);
        split_tf32(s[4 * n + 2], p_hi[i][1], p_lo[i][1]);
        split_tf32(s[4 * n + 1], p_hi[i][2], p_lo[i][2]);
        split_tf32(s[4 * n + 3], p_hi[i][3], p_lo[i][3]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
#pragma unroll
      for (int i = 0; i < kHalf; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fence_reg(p_hi[i][r]);
          fence_reg(p_lo[i][r]);
        }
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int n = half * kHalf + i;
        const uint32_t off = (n / 4) * G::kVtBoxBytes + (n % 4) * 32;
        wgmma_3xtf32<D>(o, p_hi[i], p_lo[i], desc_vt(vt_hi + off),
                        desc_vt(vt_lo + off), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(split_empty + 8 * st);  // the set is free
  }

  // out = O / max(l, 1e-30), lse = m + log(l); rows past T are not stored
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && c == 0) {
    float* lb = lse + ((size_t)b * heads + h) * t_len;
    if (row0 < t_len) lb[row0] = __fadd_rn(m0, logf(l0));
    if (row1 < t_len) lb[row1] = __fadd_rn(m1, logf(l1));
  }
  // out rows of the true head dim HD (columns past it are zeros)
  const size_t row_stride = (size_t)heads * HD;
  float* ob = out + ((size_t)b * t_len * heads + h) * HD + c0;
  if (row0 < t_len) {
    float* dst = ob + (size_t)row0 * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n < HD)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(
            __fdiv_rn(o[4 * n], d0), __fdiv_rn(o[4 * n + 1], d0));
  }
  if (row1 < t_len) {
    float* dst = ob + (size_t)row1 * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n < HD)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(
            __fdiv_rn(o[4 * n + 2], d1), __fdiv_rn(o[4 * n + 3], d1));
  }
}

// -------------------------------------------------------------- host
// A 4-D map of a contiguous (batch, len, heads, hd) f32 tensor, innermost
// first: (hd, heads, len, batch), box (kCols, 1, kBN, 1).  Rows past len,
// and columns past hd (112 in the HD = 112 instance), read as 0.
template <int D>
int encode(CUtensorMap* map, const void* ptr, int batch, int len, int heads,
           int hd, CUtensorMapSwizzle swizzle) {
  using G = Tile<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {4ull * hd, 4ull * hd * heads,
                                 4ull * hd * heads * len};
  const cuuint32_t box[4] = {(cuuint32_t)G::kCols, 1, (cuuint32_t)G::kBN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed - (int)r;
}

template <int D, int HD, bool kWindow>
int launch_impl(const void* q, const void* k, const void* v, void* o,
                void* lse, int batch, int t_len, int s_len, int heads,
                int kv_heads, int causal, float scale, int window,
                cudaStream_t stream) {
  using G = Tile<D>;
  // set once per instance (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D, HD, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  const CUtensorMapSwizzle swizzle = G::kRowBytes == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  // q's map has K's box (kBN = 64 rows where q goes to shared memory)
  int err = encode<D>(&tq, q, batch, t_len, heads, HD, swizzle);
  if (err == 0)
    err = encode<D>(&tk, k, batch, s_len, kv_heads, HD, swizzle);
  if (err == 0)
    err = encode<D>(&tv, v, batch, s_len, kv_heads, HD,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const dim3 grid(batch * heads, (t_len + kBM - 1) / kBM);
  flash_attention_f32_kernel<D, HD, kWindow><<<grid, kThreads, G::kSmem, stream>>>(
      tq, tk, tv, static_cast<const float*>(q), static_cast<float*>(o),
      static_cast<float*>(lse), t_len, s_len, heads, kv_heads, causal,
      scale, window);
  return (int)cudaGetLastError();
}

// a call without a window runs an instance with none of the window's terms
template <int D, int HD = D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int t_len, int s_len, int heads, int kv_heads,
           int causal, float scale, int window, cudaStream_t stream) {
  return window > 0
             ? launch_impl<D, HD, true>(q, k, v, o, lse, batch, t_len, s_len,
                                        heads, kv_heads, causal, scale,
                                        window, stream)
             : launch_impl<D, HD, false>(q, k, v, o, lse, batch, t_len,
                                         s_len, heads, kv_heads, causal,
                                         scale, 0, stream);
}

}  // namespace

extern "C" {

// q, o: (batch, t_len, heads, head_dim); k, v: (batch, s_len, kv_heads,
// head_dim); contiguous f32, 16-byte aligned; head_dim in {16, 32, 64,
// 112, 128}; heads % kv_heads == 0; t_len, s_len >= 1; batch * heads < 2^31 and
// ceil(t_len / 128) <= 65535.  ``lse`` is null or (batch, heads, t_len)
// f32, written with each row's m + log(l).  ``scale`` is
// f32(head_dim^-1/2).  ``window`` > 0 also masks key j for query i where
// j <= i - window; 0 is no window.  Launches on ``stream`` and returns its cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported head_dim, -1 if the driver has
// no cuTensorMapEncodeTiled, or -1000 - r if it returned CUresult r.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int batch, int t_len,
                           int s_len, int heads, int kv_heads, int head_dim,
                           int causal, float scale, int window,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (window < 0) return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, o, lse, batch, t_len, s_len, heads,
                        kv_heads, causal, scale, window, st);
    case 32:
      return launch<32>(q, k, v, o, lse, batch, t_len, s_len, heads,
                        kv_heads, causal, scale, window, st);
    case 64:
      return launch<64>(q, k, v, o, lse, batch, t_len, s_len, heads,
                        kv_heads, causal, scale, window, st);
    case 112:  // a D = 128 instance, columns past 112 zero-filled
      return launch<128, 112>(q, k, v, o, lse, batch, t_len, s_len, heads,
                              kv_heads, causal, scale, window, st);
    case 128:
      return launch<128>(q, k, v, o, lse, batch, t_len, s_len, heads,
                         kv_heads, causal, scale, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory a block of ``head_dim`` asks for (ptxas does
// not report it), or 0 for an unsupported head_dim.
int flash_attention_f32_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 16: return (int)Tile<16>::kSmem;
    case 32: return (int)Tile<32>::kSmem;
    case 64: return (int)Tile<64>::kSmem;
    case 112:
    case 128: return (int)Tile<128>::kSmem;
    default: return 0;
  }
}

}  // extern "C"
