// The RWKV-6 time recurrence for Hopper: a serial step kernel and a
// chunked forward and backward.  No Pallas counterpart: the JAX package
// runs it as a compiled lax.scan (src/repro/models/rwkv6.py:54,
// _wkv_scan, and its one-token decode at :113-121).
//
// Per (batch b, head h) the state S is K x K f32 (row k: key channel,
// column j: value channel).  Step t, with S the state before it:
//
//   kv[k, j] = k_t[k] v_t[j]
//   y_t[j]   = sum_k r_t[k] (S[k, j] + u[k] kv[k, j])
//   S[k, j]  = S[k, j] w_t[k] + kv[k, j]
//
// Layout: r, k, v, w are (B, T, H, K) (r, k, v in one dtype, f32 or bf16;
// w in its own, since the JAX model's scan rounds the decay to the compute
// dtype and its decode keeps it f32), u (H, K) f32, states (B, H, K, K)
// f32, y and every gradient f32 in the inputs' shapes.
//
// wkv6_step: one block per (b, h), 4K threads, the state in registers (a
// column per 4 threads), the steps walked one by one.  It runs the decode
// step (T = 1 with a state), where a chunk would buy nothing; its state
// updates round each product and sum on its own (__fmul_rn, __fadd_rn), as
// the plain version does, so its states are the plain version's bit for
// bit, and the engine's prefill is its decode chain's.
//
// The chunked kernels (every call with T > 1): chunks of C = kChunk steps,
// sub-chunks of L = kSub.  The decay factors are products of the w the
// kernel receives, each a running product over steps:
//
//   pre_i = prod_{a0 <= m < i} w_m,  suf_j = prod_{j < m <= a1} w_m,
//   tot = prod over the (sub-)chunk,  D_ij = prod_{j < m < i} w_m,
//
// with [a0, a1] the (sub-)chunk of i and j: the e^{G} factors of the GLA
// chunk form (Yang et al., arXiv:2312.06635) with every exponent <= 0, taken
// without a log or an exp, so none overflows however fast the decay, and w
// = 0 resets the state as in the serial form (no log 0, no inf - inf).
// Every sum over steps adds its terms from the most decayed to the least,
// as the serial form does; within a sub-chunk the sums are Horner chains
// over w.  A ragged last chunk is padded with identity steps (r = k = v =
// dy = 0, w = 1), which move nothing.
//
// Forward (wkv6_fwd, three launches):
//  (i)   wkv6_fwd_sum, one block per (b, h, chunk): its contribution
//        dS_c = sum_j (k_j suf_j)^T v_j and decay F_c = prod w, in f64;
//  (ii)  wkv6_fwd_pass, a thread per state element of each (b, h): S_{c+1}
//        = F_c S_c + dS_c over the T / C chunks from the first state, in
//        f64, keeping the state entering each chunk and the final state,
//        each rounded once to f32 (in f32 the kept states' error from f64
//        reached 2.2x the serial form's on the mirror; so they are near
//        the correctly rounded ones);
//  (iii) wkv6_fwd_out, one block per (b, h, chunk), sub-chunk by
//        sub-chunk from S_c: y_i = (r_i pre_i) S_a + sum_{j <= i} A_ij v_j
//        (A_ij = sum_k r_i k_j D_ij, the bonus A_ii = r_i . (u k_i)), then
//        S_{a+1} = tot S_a + sum_j (k_j suf_j)^T v_j.
// Backward (wkv6_bwd, three launches, no atomics: two runs give the same
// bits):
//  (i)   wkv6_bwd_sum: dG_c = sum_i (r_i pre_i)^T dy_i and F_c, in f64;
//  (ii)  wkv6_bwd_pass, in reverse, in f64: the gradient after each chunk
//        from the final state's, dS_{c-1} = F_c dS_c + dG_c; dS0;
//  (iii) wkv6_bwd_grad, one block per (b, h, chunk): the states S_a
//        entering its sub-chunks (recomputed from the forward's chunk state)
//        and the gradients dS_a after them, then per sub-chunk, with P = dy
//        S_a^T, Q = v dS_a^T, Bm = dy v^T:
//          dr_i = pre_i P_i + sum_{j<i} D_ij k_j Bm_ij + u k_i Bm_ii
//          dk_j = suf_j Q_j + sum_{i>j} D_ij r_i Bm_ij + u r_j Bm_jj
//          dv_j = (k_j suf_j) dS_a + sum_{i>=j} A_ij dy_i
//          du  += r_i k_i Bm_ii (a per-chunk partial, summed by the caller)
//        and dw_m = sum_j dS_m[k, j] S_{m-1}[k, j], the serial form's (no
//        division by w: finite at w = 0), split over the sub-chunk as
//          pre_m suf_m rowsum(dS_a * S_a) + suf_m sum_{j<m} D_mj k_j Q_j
//          + pre_m sum_{i>m} D_im r_i P_i
//          + sum_{j<m<i} D_im D_mj r_i k_j Bm_ij.
//        P, Q, Bm and rowsum(dS_a * S_a) accumulate in f64 (exact products
//        of f32; P, Q and Bm rounded once to f32): each output of the
//        chunked form combines several of these sums over K, where the
//        serial form has one, and in f32 they put dr, dk and dw at up to
//        3.3x the serial form's error from f64 (the plain mirror,
//        ref.wkv6_chunked_bwd_ref), past the 2x bar.  dw's double sum runs
//        in f64 on the unrounded Bm and its four terms are added in f64
//        (in f32 it reached 1.8x on the card).  Sums over K of the
//        forward's y and the backward's dv run in four interleaved chains
//        (one chain of 64 reached 2.07x).
//
// What bounds them on the H100: the least time the function allows is set
// by its bytes (r, k, v, w, dy in; y or the gradients and the kept states
// out), well above its operations (5 and 14 K^2 a (b, t, h), at 3xTF32's
// rate); the kernels reach 6-14% of it (PERF.md section 6).  The
// products (about 6 and 12 K^2 a (b, t, h), plus the sub-chunks'
// element-by-element chains) run as register-tiled FMA on the CUDA cores,
// f32, with the accuracy-bearing sums in f64, not on the tensor cores:
// bf16 products would round the decayed operands to 2^-8, and 3xTF32's
// split rounding and the tensor cores' truncating adds cost the accuracy
// the 2x bar asks for.  What holds them back is latency, not a unit's
// throughput: the backward's block holds the chunk's inputs, its
// sub-chunks' states and their f64 operands (212 KiB of shared memory), so
// one block of 8 warps runs on an SM and the latency of its phases shows;
// its f64 products P and Q and the per-column chains take half its time.
// The design's lever against the serial walk is parallelism: B H T / C
// independent blocks (2,048 at the rwkv6 train microbatch, against 64),
// the dependent chain T / C element-wise steps in (ii), not T.
//
// Built with --fmad=false and without --use_fast_math: every fused
// multiply-add is an explicit __fmaf_rn / __fma_rn.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // C: steps per chunk and between kept states
constexpr int kSub = 16;       // L: steps per sub-chunk
constexpr int kThreads = 256;  // threads of a chunk kernel's block
constexpr int kTile = 32;      // steps the step kernel stages at a time

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float quad_sum(float x) {
  // lanes 4m .. 4m + 3 hold the four partial sums; ((x0 + x1) + (x2 + x3))
  // in every lane (the adds commute, so every lane holds the same bits)
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// A sum of products in four interleaved chains of __fmaf_rn (term i into
// chain i % 4), added as ((c0 + c1) + (c2 + c3)).
struct Sum4 {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ void add(int i, float x, float y) {
    c[i & 3] = __fmaf_rn(x, y, c[i & 3]);
  }
  __device__ __forceinline__ float total() const {
    return __fadd_rn(__fadd_rn(c[0], c[1]), __fadd_rn(c[2], c[3]));
  }
};

// Stage steps [t0, t0 + n) of a (B, T, H, K) stream into dst[kTile][K].
template <int K, typename T>
__device__ __forceinline__ void stage(float (*dst)[K], const T* src,
                                      long long base, long long row,
                                      int t0, int n) {
  for (int e = threadIdx.x; e < n * K; e += 4 * K) {
    const int s = e / K, c = e - s * K;
    dst[s][c] = ld(src, base + (long long)(t0 + s) * row + c);
  }
}

// The serial walk: thread (j, q) = (tid / 4, tid % 4) owns column j at
// rows k = 4 i + q; the four partial sums of y[j] meet by two shuffles.
// With `chunks` it also writes the state before every kChunk-th step.
template <int K, typename TI, typename TW>
__global__ void __launch_bounds__(4 * K)
    wkv6_step_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                     const TI* __restrict__ v, const TW* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ s0, float* __restrict__ y,
                     float* __restrict__ s_out, float* __restrict__ chunks,
                     int T, int H) {
  constexpr int R = K / 4;
  __shared__ float sr[kTile][K], sk[kTile][K], sv[kTile][K], sw[kTile][K];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int j = threadIdx.x >> 2, q = threadIdx.x & 3;
  const long long row = (long long)H * K;
  const long long base = (long long)b * T * row + (long long)h * K;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  float S[R], uu[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kk = 4 * i + q;
    uu[i] = u[h * K + kk];
    S[i] = s0 != nullptr ? s0[(long long)bh * K * K + kk * K + j] : 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    __syncthreads();
    stage<K>(sr, r, base, row, t0, n);
    stage<K>(sk, k, base, row, t0, n);
    stage<K>(sv, v, base, row, t0, n);
    stage<K>(sw, w, base, row, t0, n);
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const int t = t0 + s;
      if (chunks != nullptr && t % kChunk == 0) {
        float* c = chunks + ((long long)bh * n_chunks + t / kChunk) * K * K;
#pragma unroll
        for (int i = 0; i < R; ++i) c[(4 * i + q) * K + j] = S[i];
      }
      const float vj = sv[s][j];
      Sum4 acc;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kk = 4 * i + q;
        const float kv = __fmul_rn(sk[s][kk], vj);
        const float a = __fadd_rn(S[i], __fmul_rn(uu[i], kv));
        acc.add(i, sr[s][kk], a);
        S[i] = __fadd_rn(__fmul_rn(S[i], sw[s][kk]), kv);
      }
      const float yj = quad_sum(acc.total());
      if (q == 0) y[base + (long long)t * row + j] = yj;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    s_out[(long long)bh * K * K + (4 * i + q) * K + j] = S[i];
}

// ------------------------------------------------------------ chunked
// A chunk kernel's block is (b, h, c) = blockIdx.x / nc, % nc.  Shared
// arrays are f32 [steps][K] unless named otherwise; the K x K states are
// [k][n] with a row stride of K + 1 (threads of a warp read along k or
// along n without bank conflicts).  Work on a sub-chunk's L x K outputs
// goes to thread tid as column n = tid % K of rows tid / K + G q (G =
// kThreads / K row groups); work on a K x K state as column n of rows
// (tid / K) R .. + R (R = K / G).
template <int K>
struct Shape {
  static constexpr int G = kThreads / K;  // row groups
  static constexpr int R = K / G;         // state rows per thread
  static constexpr int I = kSub / G;      // sub-chunk rows per thread
  static constexpr int KP = K + 1;        // a state's row stride
  static constexpr int KQ = K / 16;       // channels per thread in A
  static constexpr int NS = kChunk / kSub;  // sub-chunks per chunk
  static_assert(kThreads % K == 0 && K % G == 0 && kSub % G == 0 &&
                    K % 16 == 0 && (G & (G - 1)) == 0,
                "head dim");
};

struct Chunk {
  int blk, b, h, c0, nsub;  // nsub: sub-chunks holding a step before T
  long long row, base;
  __device__ Chunk(int T, int H, int K, int nc) {
    blk = blockIdx.x;
    const int bh = blk / nc, c = blk - bh * nc;
    b = bh / H;
    h = bh - b * H;
    c0 = c * kChunk;
    nsub = (min(kChunk, T - c0) + kSub - 1) / kSub;
    row = (long long)H * K;
    base = (long long)b * T * row + (long long)h * K;
  }
};

// The chunk's steps of a (B, T, H, K) stream, staged in two halves so
// that a block issues every array's loads before it waits on any: load()
// reads 16-byte vectors (8 bf16 or 4 f32; the wrapper passes 16-byte
// aligned tensors) into registers, store() writes them to dst[kChunk][K]
// as f32 (or f64), the steps past T as `pad`.
template <int K, typename TT>
struct Stage {
  static constexpr int V = 16 / sizeof(TT);  // elements per vector
  static constexpr int NV = kChunk * K / V;  // vectors in the chunk
  static constexpr int PER = (NV + kThreads - 1) / kThreads;
  uint4 buf[PER];
  bool ok[PER];

  __device__ __forceinline__ void load(const TT* src, const Chunk& ch,
                                       int T) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = threadIdx.x + p * kThreads;
      const int s = (e * V) / K, c = (e * V) % K, t = ch.c0 + s;
      ok[p] = e < NV && t < T;
      if (ok[p])
        buf[p] = __ldg(reinterpret_cast<const uint4*>(
            src + ch.base + (long long)t * ch.row + c));
    }
  }

  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t x[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(TT) == 2) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        f[2 * q] = __uint_as_float(x[q] << 16);
        f[2 * q + 1] = __uint_as_float(x[q] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) f[q] = __uint_as_float(x[q]);
    }
  }

  template <typename TD>
  __device__ __forceinline__ void store(TD* dst, float pad) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = threadIdx.x + p * kThreads;
      if (e < NV) {
        float f[V];
        unpack(buf[p], f);
#pragma unroll
        for (int q = 0; q < V; ++q) dst[e * V + q] = ok[p] ? f[q] : pad;
      }
    }
  }
};

// N consecutive values from shared memory (16-byte loads when N allows:
// every caller's row offset is a multiple of N).
template <int N>
__device__ __forceinline__ void ld_row(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + q);
      dst[q] = t.x;
      dst[q + 1] = t.y;
      dst[q + 2] = t.z;
      dst[q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

template <int N>
__device__ __forceinline__ void ld_row(double (&dst)[N], const double* src) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 2) {
      const double2 t = *reinterpret_cast<const double2*>(src + q);
      dst[q] = t.x;
      dst[q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

// (i) of either direction, in f64: out (K x K) = sum over the chunk's
// steps of (x_i * d_i)^T y_i, d_i the product of w after i (kRev false:
// x = k, y = v) or before i (kRev: x = r, y = dy); F = prod w.  The f32
// inputs are exact in f64, so the kept states carry one rounding each.
template <int K, typename TX, typename TY, typename TW, bool kRev>
__device__ __forceinline__ void chunk_sum(const TX* __restrict__ x,
                                          const TY* __restrict__ y,
                                          const TW* __restrict__ w,
                                          double* __restrict__ out,
                                          double* __restrict__ F, int T,
                                          int H, int nc) {
  using S = Shape<K>;
  extern __shared__ __align__(16) double dsmem[];
  double* sx = dsmem;                         // [kChunk][K]
  double* part = sx + kChunk * K;             // [NS][K]
  float* sy = (float*)(part + S::NS * K);     // [kChunk][K]
  float* sw = sy + kChunk * K;                // [kChunk][K]
  const Chunk ch(T, H, K, nc);
  const int tid = threadIdx.x, kk = tid % K, q4 = tid / K;
  {
    Stage<K, TX> gx;
    Stage<K, TY> gy;
    Stage<K, TW> gw;
    gx.load(x, ch, T);
    gy.load(y, ch, T);
    gw.load(w, ch, T);
    gx.store(sx, 0.f);
    gy.store(sy, 0.f);
    gw.store(sw, 1.f);
  }
  __syncthreads();
  // the products of w after (before) each step, in two levels: thread
  // (q4, k) walks sub-chunk q4 of channel k, then scales it by the
  // product of the sub-chunks after (before) it
  if (q4 < S::NS) {
    double d = 1.0;
    for (int st = 0; st < kSub; ++st) {
      const int i = q4 * kSub + (kRev ? st : kSub - 1 - st);
      sx[i * K + kk] = __dmul_rn(sx[i * K + kk], d);
      d = __dmul_rn(d, (double)sw[i * K + kk]);
    }
    part[q4 * K + kk] = d;
  }
  __syncthreads();
  if (q4 < S::NS) {
    double o = 1.0;
    for (int q = 0; q < S::NS; ++q)
      if (kRev ? q < q4 : q > q4) o = __dmul_rn(o, part[q * K + kk]);
    for (int i = q4 * kSub; i < (q4 + 1) * kSub; ++i)
      sx[i * K + kk] = __dmul_rn(sx[i * K + kk], o);
    if (q4 == 0) {
      double f = 1.0;
      for (int q = 0; q < S::NS; ++q) f = __dmul_rn(f, part[q * K + kk]);
      F[(long long)ch.blk * K + kk] = f;
    }
  }
  __syncthreads();
  const int n = kk, k0 = q4 * S::R;
  double acc[S::R];
#pragma unroll
  for (int q = 0; q < S::R; ++q) acc[q] = 0.0;
  for (int i = 0; i < kChunk; ++i) {
    const double yv = (double)sy[i * K + n];
    double xr[S::R];
    ld_row<S::R>(xr, sx + i * K + k0);
#pragma unroll
    for (int q = 0; q < S::R; ++q) acc[q] = __fma_rn(xr[q], yv, acc[q]);
  }
  double* o = out + (long long)ch.blk * K * K;
#pragma unroll
  for (int q = 0; q < S::R; ++q) o[(k0 + q) * K + n] = acc[q];
}

template <int K>
constexpr size_t sum_smem() {
  // x scaled, f64; the sub-chunks' products, f64; y, w
  return sizeof(double) * (kChunk * K + Shape<K>::NS * K) +
         sizeof(float) * 2 * kChunk * K;
}

template <int K, typename TI, typename TW>
__global__ void __launch_bounds__(kThreads)
    wkv6_fwd_sum_kernel(const TI* __restrict__ k, const TI* __restrict__ v,
                        const TW* __restrict__ w, double* __restrict__ out,
                        double* __restrict__ F, int T, int H, int nc) {
  chunk_sum<K, TI, TI, TW, false>(k, v, w, out, F, T, H, nc);
}

template <int K, typename TI, typename TW>
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_sum_kernel(const TI* __restrict__ r,
                        const float* __restrict__ dy,
                        const TW* __restrict__ w, double* __restrict__ out,
                        double* __restrict__ F, int T, int H, int nc) {
  chunk_sum<K, TI, float, TW, true>(r, dy, w, out, F, T, H, nc);
}

// (ii) of either direction, in f64, a thread per state element (e of B H
// K K): forward, S_{c+1} = F_c S_c + dS_c from s_in (or zeros), states[c]
// the state entering chunk c rounded to f32; reverse (kRev), the
// gradient after chunk c, dS_{c-1} = F_c dS_c + dG_c.  s_out (if not
// null) takes the end, rounded to f32.
template <bool kRev>
__device__ __forceinline__ void chunk_pass(const double* __restrict__ sum,
                                           const double* __restrict__ F,
                                           const float* __restrict__ s_in,
                                           float* __restrict__ states,
                                           float* __restrict__ s_out, int nc,
                                           int K, long long n_elem) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elem) return;
  const int KK = K * K;
  const long long bh = e / KK;
  const int kn = (int)(e - bh * KK), kk = kn / K;
  double S = s_in != nullptr ? (double)s_in[e] : 0.0;
#pragma unroll 4
  for (int st = 0; st < nc; ++st) {
    const long long c = bh * nc + (kRev ? nc - 1 - st : st);
    states[c * KK + kn] = (float)S;
    S = __dadd_rn(__dmul_rn(F[c * K + kk], S), sum[c * KK + kn]);
  }
  if (s_out != nullptr) s_out[e] = (float)S;
}

__global__ void wkv6_fwd_pass_kernel(const double* sum, const double* F,
                                     const float* s_in, float* states,
                                     float* s_out, int nc, int K,
                                     long long n_elem) {
  chunk_pass<false>(sum, F, s_in, states, s_out, nc, K, n_elem);
}

__global__ void wkv6_bwd_pass_kernel(const double* sum, const double* F,
                                     const float* s_in, float* states,
                                     float* s_out, int nc, int K,
                                     long long n_elem) {
  chunk_pass<true>(sum, F, s_in, states, s_out, nc, K, n_elem);
}

// The running products of a sub-chunk starting at a0, the two chains of
// channel k in threads k (pre) and K + k (suf): pre[i][k], suf[i][k] (if
// not null), rt = r pre, kh = k suf, tot[k].
template <int K>
__device__ __forceinline__ void sub_decay(const float* sr, const float* sk,
                                          const float* sw, int a0,
                                          float* pre, float* suf, float* rt,
                                          float* kh, float* tot) {
  const int kk = threadIdx.x % K, role = threadIdx.x / K;
  float d = 1.f;
  if (role == 0) {
    for (int i = 0; i < kSub; ++i) {
      const int o = (a0 + i) * K + kk;
      if (pre != nullptr) pre[i * K + kk] = d;
      rt[i * K + kk] = __fmul_rn(sr[o], d);
      d = __fmul_rn(d, sw[o]);
    }
    tot[kk] = d;
  } else if (role == 1) {
    for (int i = kSub - 1; i >= 0; --i) {
      const int o = (a0 + i) * K + kk;
      if (suf != nullptr) suf[i * K + kk] = d;
      kh[i * K + kk] = __fmul_rn(sk[o], d);
      d = __fmul_rn(d, sw[o]);
    }
  }
}

// A[a][i][j] (j <= i) of the chunk's first nsub sub-chunks a, all at
// once (their shuffle chains interleave): thread (i, g) = (tid / 16, tid %
// 16) sums channels g + 16 q of row i, the 16 partial sums meet by
// shuffles (a fixed tree); D_ij a running product over j from i - 1 down.
template <int K>
__device__ __forceinline__ void chunk_A(const float* sr, const float* sk,
                                        const float* sw, const float* u,
                                        int nsub, float* A) {
  using S = Shape<K>;
  const int i = threadIdx.x / 16, g = threadIdx.x % 16;
  float rr[S::NS][S::KQ], d[S::NS][S::KQ], acc[S::NS];
#pragma unroll
  for (int a = 0; a < S::NS; ++a) {
    acc[a] = 0.f;
#pragma unroll
    for (int q = 0; q < S::KQ; ++q) {
      const int kk = g + 16 * q, o = (a * kSub + i) * K + kk;
      rr[a][q] = sr[o];
      d[a][q] = 1.f;
      acc[a] = __fmaf_rn(rr[a][q], __fmul_rn(u[kk], sk[o]), acc[a]);
    }
  }
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1)
#pragma unroll
    for (int a = 0; a < S::NS; ++a)
      acc[a] = __fadd_rn(acc[a], __shfl_xor_sync(0xffffffffu, acc[a], m));
  if (g == 0)
#pragma unroll
    for (int a = 0; a < S::NS; ++a)
      if (a < nsub) A[(a * kSub + i) * kSub + i] = acc[a];
  for (int j = kSub - 2; j >= 0; --j) {
#pragma unroll
    for (int a = 0; a < S::NS; ++a) {
      acc[a] = 0.f;
      if (j < i && a < nsub) {
#pragma unroll
        for (int q = 0; q < S::KQ; ++q) {
          const int o = (a * kSub + j) * K + g + 16 * q;
          acc[a] = __fmaf_rn(__fmul_rn(rr[a][q], sk[o]), d[a][q], acc[a]);
          d[a][q] = __fmul_rn(d[a][q], sw[o]);
        }
      }
    }
#pragma unroll
    for (int m = 8; m >= 1; m >>= 1)
#pragma unroll
      for (int a = 0; a < S::NS; ++a)
        acc[a] = __fadd_rn(acc[a], __shfl_xor_sync(0xffffffffu, acc[a], m));
    if (g == 0 && j < i)
#pragma unroll
      for (int a = 0; a < S::NS; ++a)
        if (a < nsub) A[(a * kSub + i) * kSub + j] = acc[a];
  }
}

// dst (K x K, stride KP) = tot src + sum_i x[i]^T y[a0 + i] over the
// sub-chunk's steps (x: rows of [.][K], y: [.][K]), i first to last or
// (kRev) last to first; dst may be src.
template <int K, bool kRev>
__device__ __forceinline__ void sub_state(const float* src, float* dst,
                                          const float* tot, const float* x,
                                          const float* y, int a0) {
  using S = Shape<K>;
  const int n = threadIdx.x % K, k0 = (threadIdx.x / K) * S::R;
  float acc[S::R];
#pragma unroll
  for (int q = 0; q < S::R; ++q)
    acc[q] = __fmul_rn(tot[k0 + q], src[(k0 + q) * S::KP + n]);
  for (int s = 0; s < kSub; ++s) {
    const int i = kRev ? kSub - 1 - s : s;
    const float yv = y[(a0 + i) * K + n];
    float xr[S::R];
    ld_row<S::R>(xr, x + i * K + k0);
#pragma unroll
    for (int q = 0; q < S::R; ++q) acc[q] = __fmaf_rn(xr[q], yv, acc[q]);
  }
#pragma unroll
  for (int q = 0; q < S::R; ++q) dst[(k0 + q) * S::KP + n] = acc[q];
}

// out[q] = sum_k x[row_q][k] st[k][n] over k, for the thread's I rows
// row_q = tid / K + G q of x ([.][K], from row a0) and its column n: four
// interleaved chains of __fmaf_rn (k % 4), added as ((c0 + c1) + (c2 +
// c3)); the rows share each load of st.
template <int K>
__device__ __forceinline__ void rows_times_state(float (&out)[Shape<K>::I],
                                                 const float* x,
                                                 const float* st) {
  using S = Shape<K>;
  const int n = threadIdx.x % K, g = threadIdx.x / K;
  float acc[S::I][4];
#pragma unroll
  for (int q = 0; q < S::I; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;
  for (int kk = 0; kk < K; kk += 4) {
    float sv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) sv[c] = st[(kk + c) * S::KP + n];
#pragma unroll
    for (int q = 0; q < S::I; ++q) {
      float xr[4];
      ld_row<4>(xr, x + (g + S::G * q) * K + kk);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[q][c] = __fmaf_rn(xr[c], sv[c], acc[q][c]);
    }
  }
#pragma unroll
  for (int q = 0; q < S::I; ++q)
    out[q] = __fadd_rn(__fadd_rn(acc[q][0], acc[q][1]),
                       __fadd_rn(acc[q][2], acc[q][3]));
}

// Load a (K x K) state from global into st (stride KP), 16 bytes a load.
template <int K>
__device__ __forceinline__ void load_state(float* st, const float* src) {
  using S = Shape<K>;
  constexpr int NV = K * K / 4, PER = (NV + kThreads - 1) / kThreads;
  float4 buf[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p)
    if (threadIdx.x + p * kThreads < NV)
      buf[p] = __ldg(reinterpret_cast<const float4*>(src) + threadIdx.x +
                     p * kThreads);
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    if (threadIdx.x + p * kThreads >= NV) continue;
    const int e = 4 * (threadIdx.x + p * kThreads), row = e / K,
              c = e % K;
    float* d = st + row * S::KP + c;
    d[0] = buf[p].x;
    d[1] = buf[p].y;
    d[2] = buf[p].z;
    d[3] = buf[p].w;
  }
}

template <int K>
constexpr size_t out_smem() {
  using S = Shape<K>;
  // r (then r pre), k (then k suf), v, w; two states; A and tot of each
  // sub-chunk
  return sizeof(float) * (4 * kChunk * K + 2 * K * S::KP +
                          S::NS * (kSub * kSub + K));
}

// (iii) forward: y over the chunk, from its entering state.
template <int K, typename TI, typename TW>
__global__ void __launch_bounds__(kThreads)
    wkv6_fwd_out_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                        const TI* __restrict__ v, const TW* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ chunks,
                        float* __restrict__ y, int T, int H, int nc) {
  using S = Shape<K>;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;
  float* sk = sr + kChunk * K;
  float* sv = sk + kChunk * K;
  float* sw = sv + kChunk * K;
  float* st = sw + kChunk * K;    // [2][K][KP]
  float* A = st + 2 * K * S::KP;  // [NS][kSub][kSub]
  float* tot = A + S::NS * kSub * kSub;  // [NS][K]
  const Chunk ch(T, H, K, nc);
  const int tid = threadIdx.x, n = tid % K, grp = tid / K;
  const float* uh = u + ch.h * K;
  {
    Stage<K, TI> gr, gk, gv;
    Stage<K, TW> gw;
    gr.load(r, ch, T);
    gk.load(k, ch, T);
    gv.load(v, ch, T);
    gw.load(w, ch, T);
    load_state<K>(st, chunks + (long long)ch.blk * K * K);
    gr.store(sr, 0.f);
    gk.store(sk, 0.f);
    gv.store(sv, 0.f);
    gw.store(sw, 1.f);
  }
  __syncthreads();
  chunk_A<K>(sr, sk, sw, uh, ch.nsub, A);
  __syncthreads();
  if (grp < S::NS) {
    // thread (a, k): r <- r pre, k <- k suf over sub-chunk a, in place
    const int a0 = grp * kSub;
    float d = 1.f;
    for (int i = 0; i < kSub; ++i) {
      const int o = (a0 + i) * K + n;
      sr[o] = __fmul_rn(sr[o], d);
      d = __fmul_rn(d, sw[o]);
    }
    tot[grp * K + n] = d;
    d = 1.f;
    for (int i = kSub - 1; i >= 0; --i) {
      const int o = (a0 + i) * K + n;
      sk[o] = __fmul_rn(sk[o], d);
      d = __fmul_rn(d, sw[o]);
    }
  }
  __syncthreads();
  for (int a = 0; a < ch.nsub; ++a) {
    const int a0 = a * kSub;
    const float* cur = st + (a & 1) * K * S::KP;
    const float* Aa = A + a * kSub * kSub;
    float yq[S::I];
    rows_times_state<K>(yq, sr + a0 * K, cur);
#pragma unroll
    for (int q = 0; q < S::I; ++q) {
      const int i = grp + S::G * q, t = ch.c0 + a0 + i;
      float acc = yq[q];
      for (int j = 0; j <= i; ++j)
        acc = __fmaf_rn(Aa[i * kSub + j], sv[(a0 + j) * K + n], acc);
      if (t < T) y[ch.base + (long long)t * ch.row + n] = acc;
    }
    if (a + 1 < ch.nsub)
      sub_state<K, false>(cur, st + ((a + 1) & 1) * K * S::KP, tot + a * K,
                          sk + a0 * K, sv, a0);
    __syncthreads();
  }
}

template <int K>
constexpr size_t grad_smem() {
  using S = Shape<K>;
  // f64: dy, v of the sub-chunk (rows of stride K + 2); rowsum partials;
  // Bm transposed
  // f32: r, k, v, w, dy; the entering states of the sub-chunks and dS;
  // pre, suf, rt, kh of the sub-chunk; P, Q; Bm transposed; A of each
  // sub-chunk; tot; du partials
  return sizeof(double) * (2 * kSub * (K + 2) + S::G * K + kSub * kSub) +
         sizeof(float) * (5 * kChunk * K + (S::NS + 1) * K * S::KP +
                          4 * kSub * K + 2 * kSub * K +
                          (S::NS + 1) * kSub * kSub + K + S::G * K);
}

// (iii) backward: dr, dk, dv, dw and du's partial over the chunk, from the
// forward's chunk state and the gradient after the chunk.
template <int K, typename TI, typename TW>
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_grad_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                         const TI* __restrict__ v, const TW* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ dy,
                         const float* __restrict__ chunks,
                         const float* __restrict__ after,
                         float* __restrict__ dr, float* __restrict__ dk,
                         float* __restrict__ dv, float* __restrict__ dw,
                         float* __restrict__ du_part, int T, int H, int nc) {
  using S = Shape<K>;
  constexpr int KP = S::KP, DP = K + 2, L = kSub;
  extern __shared__ __align__(16) double dsmem[];
  double* dy64 = dsmem;                 // [L][DP]
  double* v64 = dy64 + L * DP;          // [L][DP]
  double* rowpart = v64 + L * DP;       // [G][K]
  double* BT64 = rowpart + S::G * K;    // BT64[j][i] = Bm_ij, unrounded
  float* sr = (float*)(BT64 + L * L);
  float* sk = sr + kChunk * K;
  float* sv = sk + kChunk * K;
  float* sw = sv + kChunk * K;
  float* sdy = sw + kChunk * K;
  float* Ss = sdy + kChunk * K;         // [NS][K][KP]
  float* dS = Ss + S::NS * K * KP;      // [K][KP]
  float* pre = dS + K * KP;
  float* suf = pre + L * K;
  float* rt = suf + L * K;
  float* kh = rt + L * K;
  float* P = kh + L * K;                // P[i][k]
  float* Q = P + L * K;                 // Q[i][k]
  float* BT = Q + L * K;                // BT[j][i] = Bm_ij
  float* A = BT + L * L;                // [NS][L][L]
  float* tot = A + S::NS * L * L;
  float* dupart = tot + K;              // [G][K]
  const Chunk ch(T, H, K, nc);
  const int tid = threadIdx.x, col = tid % K, grp = tid / K;
  const float* uh = u + ch.h * K;
  {
    Stage<K, TI> gr, gk, gv;
    Stage<K, TW> gw;
    Stage<K, float> gdy;
    gr.load(r, ch, T);
    gk.load(k, ch, T);
    gv.load(v, ch, T);
    gw.load(w, ch, T);
    gdy.load(dy, ch, T);
    gr.store(sr, 0.f);
    gk.store(sk, 0.f);
    gv.store(sv, 0.f);
    gw.store(sw, 1.f);
    gdy.store(sdy, 0.f);
  }
  load_state<K>(Ss, chunks + (long long)ch.blk * K * K);
  load_state<K>(dS, after + (long long)ch.blk * K * K);
  __syncthreads();
  chunk_A<K>(sr, sk, sw, uh, ch.nsub, A);
  // the states entering the chunk's later sub-chunks
  for (int a = 0; a + 1 < ch.nsub; ++a) {
    sub_decay<K>(sr, sk, sw, a * L, nullptr, nullptr, rt, kh, tot);
    __syncthreads();
    sub_state<K, false>(Ss + a * K * KP, Ss + (a + 1) * K * KP, tot, kh, sv,
                        a * L);
    __syncthreads();
  }
  float du_acc = 0.f;  // the du of this thread's items (i, col)
  for (int a = ch.nsub - 1; a >= 0; --a) {
    const int a0 = a * L;
    const float* Sa = Ss + a * K * KP;
    const float* Aa = A + a * L * L;
    sub_decay<K>(sr, sk, sw, a0, pre, suf, rt, kh, tot);
    for (int e = tid; e < L * K; e += kThreads) {
      const int i = e / K, c = e - i * K;
      dy64[i * DP + c] = (double)sdy[(a0 + i) * K + c];
      v64[i * DP + c] = (double)sv[(a0 + i) * K + c];
    }
    __syncthreads();
    {
      // P[i][k] = dy_i . S_a[k] (threads of even grp) and Q[i][k] = v_i .
      // dS[k] (odd grp), in f64: thread (k = col, rows (grp / 2) RI ..),
      // two steps n at a time
      constexpr int RI = 2 * L / S::G;
      const bool isq = grp & 1;
      const float* mat = isq ? dS : Sa;
      const double* vec = isq ? v64 : dy64;
      double acc[RI];
#pragma unroll
      for (int q = 0; q < RI; ++q) acc[q] = 0.0;
      for (int nn = 0; nn < K; nn += 2) {
        const double m0 = (double)mat[col * KP + nn];
        const double m1 = (double)mat[col * KP + nn + 1];
#pragma unroll
        for (int q = 0; q < RI; ++q) {
          const double2 x = *reinterpret_cast<const double2*>(
              vec + ((grp >> 1) * RI + q) * DP + nn);
          acc[q] = __fma_rn(x.y, m1, __fma_rn(x.x, m0, acc[q]));
        }
      }
      float* out = isq ? Q : P;
#pragma unroll
      for (int q = 0; q < RI; ++q)
        out[((grp >> 1) * RI + q) * K + col] = (float)acc[q];
      // rowsum(dS * S_a) over grp's part of n
      double rs = 0.0;
      for (int nn = grp * S::R; nn < (grp + 1) * S::R; ++nn)
        rs = __fma_rn((double)dS[col * KP + nn], (double)Sa[col * KP + nn],
                      rs);
      rowpart[grp * K + col] = rs;
      // Bm_ij = dy_i . v_j in f64: thread (i, j) = (tid / 16, tid % 16)
      const int i = tid / L, j = tid % L;
      double bsum = 0.0;
      for (int nn = 0; nn < K; nn += 2) {
        const double2 x = *reinterpret_cast<const double2*>(dy64 + i * DP + nn);
        const double2 z = *reinterpret_cast<const double2*>(v64 + j * DP + nn);
        bsum = __fma_rn(x.y, z.y, __fma_rn(x.x, z.x, bsum));
      }
      BT[j * L + i] = (float)bsum;
      BT64[j * L + i] = bsum;
    }
    __syncthreads();
    {
      double rowdot = 0.0;
      for (int g = 0; g < S::G; ++g)
        rowdot = __dadd_rn(rowdot, rowpart[g * K + col]);
      const float uk = uh[col];
      // column col of the sub-chunk's r, k, w, P, Q in registers
      float kc[L], rc[L], wc[L], pc[L], qc[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int o = (a0 + j) * K + col;
        kc[j] = sk[o];
        rc[j] = sr[o];
        wc[j] = sw[o];
        pc[j] = P[j * K + col];
        qc[j] = Q[j * K + col];
      }
      // dv_i = kh_i dS[:, col] + sum_{m>=i} A_mi dy_m; dr_i, dk_i; du
      float dvk[S::I];
      rows_times_state<K>(dvk, kh, dS);
#pragma unroll
      for (int q = 0; q < S::I; ++q) {
        const int i = grp + S::G * q, t = ch.c0 + a0 + i;
        float dvi = dvk[q];
        for (int m = L - 1; m >= i; --m)
          dvi = __fmaf_rn(Aa[m * L + i], sdy[(a0 + m) * K + col], dvi);
        // dr_i = pre_i P_i + sum_{j<i} D_ij k_j Bm_ij + u k_i Bm_ii
        // dk_i = suf_i Q_i + sum_{m>i} D_mi r_m Bm_mi + u r_i Bm_ii
        float hr = 0.f, hk = 0.f;
#pragma unroll
        for (int j = 0; j < L; ++j)
          if (j < i)
            hr = __fmaf_rn(kc[j], BT[j * L + i], __fmul_rn(hr, wc[j]));
#pragma unroll
        for (int m = L - 1; m >= 0; --m)
          if (m > i)
            hk = __fmaf_rn(rc[m], BT[i * L + m], __fmul_rn(hk, wc[m]));
        const int o = i * K + col;
        const float bii = BT[i * L + i];
        const float ri = sr[(a0 + i) * K + col], ki = sk[(a0 + i) * K + col];
        const float dri = __fadd_rn(__fadd_rn(__fmul_rn(pre[o], P[o]), hr),
                                    __fmul_rn(__fmul_rn(uk, ki), bii));
        const float dki = __fadd_rn(__fadd_rn(__fmul_rn(suf[o], Q[o]), hk),
                                    __fmul_rn(__fmul_rn(uk, ri), bii));
        du_acc = __fmaf_rn(__fmul_rn(ri, ki), bii, du_acc);
        if (t < T) {
          const long long gi = ch.base + (long long)t * ch.row + col;
          dr[gi] = dri;
          dk[gi] = dki;
          dv[gi] = dvi;
        }
      }
      // dw_m = pre_m suf_m rowsum + suf_m sum_{j<m} D_mj k_j Q_j
      //        + pre_m sum_{i>m} D_im r_i P_i
      //        + sum_{j<m<i} D_im D_mj r_i k_j Bm_ij
      // with Z[i] = sum_{j<m} D_mj k_j Bm_ij carried over m in registers;
      // the double sum (Z, tri) in f64 on the unrounded Bm, and the four
      // terms added in f64 (in f32 the double sum put dw near 1.8x the
      // serial form's error from f64 on the card; in f64 the mirror's is
      // 0.8x at most)
      double Z[L];
#pragma unroll
      for (int i = 0; i < L; ++i) Z[i] = 0.0;
#pragma unroll
      for (int m = 0; m < L; ++m) {
        if (m >= grp && ((m - grp) & (S::G - 1)) == 0) {
          float fw = 0.f, rv = 0.f;
          double tri = 0.0;
#pragma unroll
          for (int j = 0; j < m; ++j)
            fw = __fmaf_rn(kc[j], qc[j], __fmul_rn(fw, wc[j]));
#pragma unroll
          for (int i = L - 1; i > m; --i) {
            rv = __fmaf_rn(rc[i], pc[i], __fmul_rn(rv, wc[i]));
            tri = __fma_rn((double)rc[i], Z[i],
                           __dmul_rn(tri, (double)wc[i]));
          }
          const int o = m * K + col, t = ch.c0 + a0 + m;
          const double p64 = pre[o], s64 = suf[o];
          const double dwm = __dadd_rn(
              __dadd_rn(__dadd_rn(__dmul_rn(__dmul_rn(p64, s64), rowdot),
                                  __dmul_rn(s64, (double)fw)),
                        __dmul_rn(p64, (double)rv)),
              tri);
          if (t < T) dw[ch.base + (long long)t * ch.row + col] = (float)dwm;
        }
        double bcol[L];
        ld_row<L>(bcol, BT64 + m * L);
        const double kd = kc[m], wd = wc[m];
#pragma unroll
        for (int i = 0; i < L; ++i)
          Z[i] = __fma_rn(kd, bcol[i], __dmul_rn(Z[i], wd));
      }
    }
    __syncthreads();
    if (a > 0) {
      // the gradient after sub-chunk a - 1
      sub_state<K, true>(dS, dS, tot, rt, sdy, a0);
      __syncthreads();
    }
  }
  dupart[grp * K + col] = du_acc;
  __syncthreads();
  if (tid < K) {
    float s = 0.f;
    for (int g = 0; g < S::G; ++g) s = __fadd_rn(s, dupart[g * K + tid]);
    du_part[(long long)ch.blk * K + tid] = s;
  }
}

template <typename Kern>
int allow_smem(Kern kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int pass(const double* sum, const double* F, const float* s_in,
         float* states, float* s_out, int B, int H, int K, int nc, bool rev,
         cudaStream_t stream) {
  const long long n = (long long)B * H * K * K;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  if (rev)
    wkv6_bwd_pass_kernel<<<blocks, kThreads, 0, stream>>>(
        sum, F, s_in, states, s_out, nc, K, n);
  else
    wkv6_fwd_pass_kernel<<<blocks, kThreads, 0, stream>>>(
        sum, F, s_in, states, s_out, nc, K, n);
  return (int)cudaGetLastError();
}

template <int K, typename TI, typename TW>
int step(const void* r, const void* k, const void* v, const void* w,
         const float* u, const float* s0, float* y, float* s_out,
         float* chunks, int B, int T, int H, cudaStream_t stream) {
  wkv6_step_kernel<K, TI, TW><<<B * H, 4 * K, 0, stream>>>(
      (const TI*)r, (const TI*)k, (const TI*)v, (const TW*)w, u, s0, y,
      s_out, chunks, T, H);
  return (int)cudaGetLastError();
}

template <int K, typename TI, typename TW>
int fwd(const void* r, const void* k, const void* v, const void* w,
        const float* u, const float* s0, float* y, float* s_out,
        float* chunks, double* dsum, double* F, int B, int T, int H,
        cudaStream_t stream) {
  const int nc = (T + kChunk - 1) / kChunk, blocks = B * H * nc;
  constexpr size_t sum_bytes = sum_smem<K>();
  static const int attr =
      allow_smem(wkv6_fwd_sum_kernel<K, TI, TW>, sum_bytes) |
      allow_smem(wkv6_fwd_out_kernel<K, TI, TW>, out_smem<K>());
  if (attr != 0) return attr;
  wkv6_fwd_sum_kernel<K, TI, TW>
      <<<blocks, kThreads, sum_bytes, stream>>>(
          (const TI*)k, (const TI*)v, (const TW*)w, dsum, F, T, H, nc);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = pass(dsum, F, s0, chunks, s_out, B, H, K, nc, false, stream);
  if (err != 0) return err;
  wkv6_fwd_out_kernel<K, TI, TW><<<blocks, kThreads, out_smem<K>(), stream>>>(
      (const TI*)r, (const TI*)k, (const TI*)v, (const TW*)w, u, chunks, y,
      T, H, nc);
  return (int)cudaGetLastError();
}

template <int K, typename TI, typename TW>
int bwd(const void* r, const void* k, const void* v, const void* w,
        const float* u, const float* dy, const float* chunks,
        const float* ds_out, float* dr, float* dk, float* dv, float* dw,
        float* du_part, float* ds0, float* after, double* dsum, double* F,
        int B, int T, int H, cudaStream_t stream) {
  const int nc = (T + kChunk - 1) / kChunk, blocks = B * H * nc;
  constexpr size_t sum_bytes = sum_smem<K>();
  static const int attr =
      allow_smem(wkv6_bwd_sum_kernel<K, TI, TW>, sum_bytes) |
      allow_smem(wkv6_bwd_grad_kernel<K, TI, TW>, grad_smem<K>());
  if (attr != 0) return attr;
  wkv6_bwd_sum_kernel<K, TI, TW>
      <<<blocks, kThreads, sum_bytes, stream>>>(
          (const TI*)r, dy, (const TW*)w, dsum, F, T, H, nc);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = pass(dsum, F, ds_out, after, ds0, B, H, K, nc, true, stream);
  if (err != 0) return err;
  wkv6_bwd_grad_kernel<K, TI, TW><<<blocks, kThreads, grad_smem<K>(), stream>>>(
      (const TI*)r, (const TI*)k, (const TI*)v, (const TW*)w, u, dy, chunks,
      after, dr, dk, dv, dw, du_part, T, H, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// dispatch on (K, input dtype, decay dtype); the bf16 flags are 0 or 1.
// f32 inputs come with an f32 decay on both of the model's paths, so
// (f32 inputs, bf16 decay) has no kernel
#define WKV6_DISPATCH(CALL)                                                 \
  switch (K * 4 + in_bf16 * 2 + w_bf16) {                                   \
    case 16 * 4 + 0: return CALL(16, float, float);                         \
    case 16 * 4 + 2: return CALL(16, __nv_bfloat16, float);                 \
    case 16 * 4 + 3: return CALL(16, __nv_bfloat16, __nv_bfloat16);         \
    case 64 * 4 + 0: return CALL(64, float, float);                         \
    case 64 * 4 + 2: return CALL(64, __nv_bfloat16, float);                 \
    case 64 * 4 + 3: return CALL(64, __nv_bfloat16, __nv_bfloat16);         \
    default: return -2;                                                     \
  }

extern "C" {

// steps per chunk, and between the states the forward keeps
int wkv6_chunk(void) { return kChunk; }

// steps per sub-chunk
int wkv6_sub(void) { return kSub; }

// shared memory of the chunked backward's block at head dim K
size_t wkv6_grad_smem_bytes(int K) {
  return K == 16 ? grad_smem<16>() : K == 64 ? grad_smem<64>() : 0;
}

// The serial walk (the decode step): r, k, v (B, T, H, K) f32 or bf16
// (in_bf16); w the same shape, f32, or bf16 (w_bf16) beside bf16 inputs;
// u (H, K) f32; s0 (B, H, K, K) f32 or null (zeros); y (B, T, H, K) f32;
// s_out (B, H, K, K) f32; chunks (B, H, ceil(T / 64), K, K) f32 or null.
// K in {16, 64}.  Returns 0, -2 for another K or dtype pair, or a CUDA
// error.
int wkv6_step_launch(const void* r, const void* k, const void* v,
                     const void* w, const float* u, const float* s0,
                     float* y, float* s_out, float* chunks, int B, int T,
                     int H, int K, int in_bf16, int w_bf16,
                     cudaStream_t stream) {
#define CALL(KK, TI, TW) \
  step<KK, TI, TW>(r, k, v, w, u, s0, y, s_out, chunks, B, T, H, stream)
  WKV6_DISPATCH(CALL)
#undef CALL
}

// The chunked forward, the arguments as wkv6_step_launch's, chunks (B, H,
// ceil(T / 64), K, K) f32 required (the state entering each chunk); dsum
// (B, H, ceil(T / 64), K, K) and F (B, H, ceil(T / 64), K) f64 scratch.
int wkv6_fwd_launch(const void* r, const void* k, const void* v,
                    const void* w, const float* u, const float* s0,
                    float* y, float* s_out, float* chunks, double* dsum,
                    double* F, int B, int T, int H, int K, int in_bf16,
                    int w_bf16, cudaStream_t stream) {
#define CALL(KK, TI, TW)                                                    \
  fwd<KK, TI, TW>(r, k, v, w, u, s0, y, s_out, chunks, dsum, F, B, T, H,    \
                  stream)
  WKV6_DISPATCH(CALL)
#undef CALL
}

// The chunked backward from dy (B, T, H, K) f32, the forward's chunks and
// ds_out (B, H, K, K) f32 or null (zeros): dr, dk, dv, dw (B, T, H, K)
// f32, du_part (B, H, ceil(T / 64), K) f32 (summed by the caller), ds0
// (B, H, K, K) f32 or null; after (B, H, ceil(T / 64), K, K) f32, dsum
// (the same shape) and F (B, H, ceil(T / 64), K) f64 scratch.
int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                    const void* w, const float* u, const float* dy,
                    const float* chunks, const float* ds_out, float* dr,
                    float* dk, float* dv, float* dw, float* du_part,
                    float* ds0, float* after, double* dsum, double* F, int B,
                    int T, int H, int K, int in_bf16, int w_bf16,
                    cudaStream_t stream) {
#define CALL(KK, TI, TW)                                                     \
  bwd<KK, TI, TW>(r, k, v, w, u, dy, chunks, ds_out, dr, dk, dv, dw,         \
                  du_part, ds0, after, dsum, F, B, T, H, stream)
  WKV6_DISPATCH(CALL)
#undef CALL
}

}  // extern "C"
