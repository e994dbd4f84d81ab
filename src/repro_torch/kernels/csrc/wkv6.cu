// The RWKV-6 time recurrence for Hopper: a forward and a reverse-time
// backward.  No Pallas counterpart: the JAX package runs it as a compiled
// lax.scan (src/repro/models/rwkv6.py:54, _wkv_scan, and its one-token
// decode at :113-121).
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
// wkv6_fwd: one block per (b, h), 4K threads; thread (j, q) = (tid / 4,
// tid % 4) owns column j at rows k = 4 i + q (K / 4 registers), so a
// column's update and its share of y need nothing from other threads;
// the four partial sums of y[j] meet by two shuffles.  The r, k, v, w of
// kTile steps are staged in shared memory at a time.  With `chunks` it
// also writes the state before every kChunk-th step (the JAX model's
// checkpointed chunk), which the backward recomputes from.  At T = 1 with
// S0 it is the decode step.
//
// wkv6_bwd: two kernels, no atomics, so the gradient is the same in
// every run.  With dS the gradient of the state after step t:
//
//   a = S + u kv;   dr[k] = sum_j dy[j] a[k, j];   da = r[k] dy[j]
//   dkv = u da + dS;  dk[k] = sum_j dkv v[j];  dv[j] = sum_k dkv k[k]
//   dw[k] = sum_j dS S[k, j];   du[k] += sum_j da kv;   dS <- dS w[k] + da
//
//  * wkv6_bwd_dv (column layout, as the forward): dv and dS0 need dS
//    alone, which walks back from dS_T with no state at all;
//  * wkv6_bwd_rkw (row layout: thread (k, p) owns row k at columns
//    j = 4 i + p): dr, dk, dw and du reduce over j, inside the thread and
//    two shuffles.  They need the state before each step, walked in
//    reverse: for each chunk, last first, the kernel recomputes the
//    chunk's states from the forward's chunk state into a scratch of
//    kChunk states per (b, h) (each thread reads back only what it
//    wrote), then walks the chunk backward.  du is a per-(b, h) partial,
//    summed over the batch by the caller.
//
// Rounding: the state and dS updates round each product and sum on its
// own (__fmul_rn, __fadd_rn), as the plain PyTorch version does, so the
// states are the plain version's bit for bit; the sums over k or j are
// four interleaved chains of __fmaf_rn per thread added as a tree, then
// two shuffles (Sum4, quad_sum), in an order of their own; du adds each
// step's sum into its chunk's and each chunk's into the total.  Built with
// --fmad=false and without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // steps between the forward's saved states
constexpr int kTile = 32;    // steps staged in shared memory at a time

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
// chain i % 4), added as ((c0 + c1) + (c2 + c3)): chains a quarter as long
// as one, so its rounding error stays near a pairwise sum's.
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

template <int K, typename TI, typename TW>
__global__ void __launch_bounds__(4 * K)
    wkv6_fwd_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
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

// dv and dS0: column layout, dS walked back from dS_T.
template <int K, typename TI, typename TW>
__global__ void __launch_bounds__(4 * K)
    wkv6_bwd_dv_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                       const TW* __restrict__ w, const float* __restrict__ u,
                       const float* __restrict__ dy,
                       const float* __restrict__ ds_out,
                       float* __restrict__ dv, float* __restrict__ ds0,
                       int T, int H) {
  constexpr int R = K / 4;
  __shared__ float sr[kTile][K], sk[kTile][K], sw[kTile][K], sdy[kTile][K];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int j = threadIdx.x >> 2, q = threadIdx.x & 3;
  const long long row = (long long)H * K;
  const long long base = (long long)b * T * row + (long long)h * K;
  float dS[R], uu[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kk = 4 * i + q;
    uu[i] = u[h * K + kk];
    dS[i] = ds_out != nullptr ? ds_out[(long long)bh * K * K + kk * K + j]
                              : 0.f;
  }
  for (int t0 = ((T - 1) / kTile) * kTile; t0 >= 0; t0 -= kTile) {
    const int n = min(kTile, T - t0);
    __syncthreads();
    stage<K>(sr, r, base, row, t0, n);
    stage<K>(sk, k, base, row, t0, n);
    stage<K>(sw, w, base, row, t0, n);
    stage<K>(sdy, dy, base, row, t0, n);
    __syncthreads();
    for (int s = n - 1; s >= 0; --s) {
      const float dyj = sdy[s][j];
      Sum4 acc;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kk = 4 * i + q;
        const float da = __fmul_rn(sr[s][kk], dyj);
        const float dkv = __fadd_rn(__fmul_rn(uu[i], da), dS[i]);
        acc.add(i, dkv, sk[s][kk]);
        dS[i] = __fadd_rn(__fmul_rn(dS[i], sw[s][kk]), da);
      }
      const float dvj = quad_sum(acc.total());
      if (q == 0) dv[base + (long long)(t0 + s) * row + j] = dvj;
    }
  }
  if (ds0 != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      ds0[(long long)bh * K * K + (4 * i + q) * K + j] = dS[i];
  }
}

// dr, dk, dw and du's per-(b, h) partial: row layout, the states
// recomputed chunk by chunk into `scratch` (kChunk states per (b, h)).
template <int K, typename TI, typename TW>
__global__ void __launch_bounds__(4 * K)
    wkv6_bwd_rkw_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                        const TI* __restrict__ v, const TW* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ dy,
                        const float* __restrict__ chunks,
                        const float* __restrict__ ds_out,
                        float* __restrict__ dr, float* __restrict__ dk,
                        float* __restrict__ dw, float* __restrict__ du_part,
                        float* __restrict__ scratch, int T, int H) {
  constexpr int R = K / 4, NT = 4 * K;
  __shared__ float sr[kTile][K], sk[kTile][K], sv[kTile][K], sw[kTile][K],
      sdy[kTile][K];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kk = threadIdx.x >> 2, p = threadIdx.x & 3;
  const long long row = (long long)H * K;
  const long long base = (long long)b * T * row + (long long)h * K;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  float* scr = scratch + (long long)bh * kChunk * K * K;
  const float uk = u[h * K + kk];
  float S[R], dS[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    dS[i] = ds_out != nullptr
                ? ds_out[(long long)bh * K * K + kk * K + 4 * i + p]
                : 0.f;
  float du_acc = 0.f;  // the chunks' du, added once each
  for (int c = n_chunks - 1; c >= 0; --c) {
    float du_chunk = 0.f;  // the chunk's steps' du, added once each
    const int c0 = c * kChunk, len = min(kChunk, T - c0);
    const float* cs = chunks + ((long long)bh * n_chunks + c) * K * K;
#pragma unroll
    for (int i = 0; i < R; ++i) S[i] = cs[kk * K + 4 * i + p];
    // the chunk's states, each written before its step
    for (int t0 = c0; t0 < c0 + len; t0 += kTile) {
      const int n = min(kTile, c0 + len - t0);
      __syncthreads();
      stage<K>(sk, k, base, row, t0, n);
      stage<K>(sv, v, base, row, t0, n);
      stage<K>(sw, w, base, row, t0, n);
      __syncthreads();
      for (int s = 0; s < n; ++s) {
        float* dst = scr + (long long)(t0 + s - c0) * R * NT + threadIdx.x;
        const float ks = sk[s][kk], ws = sw[s][kk];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dst[i * NT] = S[i];
          S[i] = __fadd_rn(__fmul_rn(S[i], ws), __fmul_rn(ks, sv[s][4 * i + p]));
        }
      }
    }
    // walk the chunk backward
    for (int t0 = c0 + ((len - 1) / kTile) * kTile; t0 >= c0; t0 -= kTile) {
      const int n = min(kTile, c0 + len - t0);
      __syncthreads();
      stage<K>(sr, r, base, row, t0, n);
      stage<K>(sk, k, base, row, t0, n);
      stage<K>(sv, v, base, row, t0, n);
      stage<K>(sw, w, base, row, t0, n);
      stage<K>(sdy, dy, base, row, t0, n);
      __syncthreads();
      for (int s = n - 1; s >= 0; --s) {
        const int t = t0 + s;
        const float* src = scr + (long long)(t - c0) * R * NT + threadIdx.x;
        const float rs = sr[s][kk], ks = sk[s][kk], ws = sw[s][kk];
        Sum4 dr_acc, dk_acc, dw_acc, du_acc4;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int jj = 4 * i + p;
          const float Sp = src[i * NT];
          const float vj = sv[s][jj], dyj = sdy[s][jj];
          const float kv = __fmul_rn(ks, vj);
          const float a = __fadd_rn(Sp, __fmul_rn(uk, kv));
          dr_acc.add(i, dyj, a);
          const float da = __fmul_rn(rs, dyj);
          const float dkv = __fadd_rn(__fmul_rn(uk, da), dS[i]);
          du_acc4.add(i, da, kv);
          dk_acc.add(i, dkv, vj);
          dw_acc.add(i, dS[i], Sp);
          dS[i] = __fadd_rn(__fmul_rn(dS[i], ws), da);
        }
        du_chunk = __fadd_rn(du_chunk, du_acc4.total());
        const float drk = quad_sum(dr_acc.total());
        const float dkk = quad_sum(dk_acc.total());
        const float dwk = quad_sum(dw_acc.total());
        if (p == 0) {
          const long long o = base + (long long)t * row + kk;
          dr[o] = drk;
          dk[o] = dkk;
          dw[o] = dwk;
        }
      }
    }
    du_acc = __fadd_rn(du_acc, du_chunk);
  }
  du_acc = quad_sum(du_acc);
  if (p == 0) du_part[(long long)bh * K + kk] = du_acc;
}

template <int K, typename TI, typename TW>
int fwd(const void* r, const void* k, const void* v, const void* w,
        const float* u, const float* s0, float* y, float* s_out,
        float* chunks, int B, int T, int H, cudaStream_t stream) {
  wkv6_fwd_kernel<K, TI, TW><<<B * H, 4 * K, 0, stream>>>(
      (const TI*)r, (const TI*)k, (const TI*)v, (const TW*)w, u, s0, y,
      s_out, chunks, T, H);
  return (int)cudaGetLastError();
}

template <int K, typename TI, typename TW>
int bwd(const void* r, const void* k, const void* v, const void* w,
        const float* u, const float* dy, const float* chunks,
        const float* ds_out, float* dr, float* dk, float* dv, float* dw,
        float* du_part, float* ds0, float* scratch, int B, int T, int H,
        cudaStream_t stream) {
  wkv6_bwd_dv_kernel<K, TI, TW><<<B * H, 4 * K, 0, stream>>>(
      (const TI*)r, (const TI*)k, (const TW*)w, u, dy, ds_out, dv, ds0, T,
      H);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  wkv6_bwd_rkw_kernel<K, TI, TW><<<B * H, 4 * K, 0, stream>>>(
      (const TI*)r, (const TI*)k, (const TI*)v, (const TW*)w, u, dy, chunks,
      ds_out, dr, dk, dw, du_part, scratch, T, H);
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

// steps between the forward's saved states
int wkv6_chunk(void) { return kChunk; }

// bytes of the backward's scratch: kChunk states per (b, h)
size_t wkv6_scratch_bytes(int B, int H, int K) {
  return (size_t)B * H * kChunk * K * K * sizeof(float);
}

// r, k, v (B, T, H, K) f32 or bf16 (in_bf16); w the same shape, f32, or
// bf16 (w_bf16) beside bf16 inputs; u (H, K) f32; s0 (B, H, K, K) f32 or null (zeros); y
// (B, T, H, K) f32; s_out (B, H, K, K) f32; chunks (B, H, ceil(T / 128),
// K, K) f32 or null.  K in {16, 64}.  Returns 0, -2 for another K or
// dtype pair, or a CUDA error.
int wkv6_fwd_launch(const void* r, const void* k, const void* v,
                    const void* w, const float* u, const float* s0,
                    float* y, float* s_out, float* chunks, int B, int T,
                    int H, int K, int in_bf16, int w_bf16,
                    cudaStream_t stream) {
#define CALL(KK, TI, TW) \
  fwd<KK, TI, TW>(r, k, v, w, u, s0, y, s_out, chunks, B, T, H, stream)
  WKV6_DISPATCH(CALL)
#undef CALL
}

// The gradient from dy (B, T, H, K) f32, the forward's chunks and ds_out
// (B, H, K, K) f32 or null (zeros): dr, dk, dv, dw (B, T, H, K) f32,
// du_part (B, H, K) f32 (summed over B by the caller), ds0 (B, H, K, K)
// f32 or null; scratch of wkv6_scratch_bytes.
int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                    const void* w, const float* u, const float* dy,
                    const float* chunks, const float* ds_out, float* dr,
                    float* dk, float* dv, float* dw, float* du_part,
                    float* ds0, float* scratch, int B, int T, int H, int K,
                    int in_bf16, int w_bf16, cudaStream_t stream) {
#define CALL(KK, TI, TW)                                                     \
  bwd<KK, TI, TW>(r, k, v, w, u, dy, chunks, ds_out, dr, dk, dv, dw,         \
                  du_part, ds0, scratch, B, T, H, stream)
  WKV6_DISPATCH(CALL)
#undef CALL
}

}  // extern "C"
