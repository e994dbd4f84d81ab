// Flash-attention backward, f32, on the CUDA cores.
//
// The JAX package has no Pallas counterpart: it trains through its
// pure-JAX chunked attention (src/repro/models/attention.py:26,
// flash_attention) and lets jax.grad differentiate it.  The port's f32
// forward is a kernel (flash_attention_f32_sm90.cu), so its gradient is
// one too: this file computes the gradient of the function
// ops.flash_attention computes in f32, with FlashAttention-2's formula,
// from q, k, v, the forward's output o, its row statistic lse = m +
// log(l) and the output's gradient dO:
//
//   qs   = f32(q * D^-1/2)
//   S    = qs k^T (f32), masked where key >= S_len or, causal, key > query
//          (aligned at the top left)
//   P    = exp(S - lse), 0 where masked
//   Drow = rowsum(dO * O)
//   dV   = P^T dO
//   dP   = dO v^T
//   dS   = P (dP - Drow)
//   dK   = dS^T qs
//   dQ   = scale * dS k
//
// q, o, dO, dq (B, T, H, D); k, v, dk, dv (B, S, HK, D); lse and Drow
// (B, H, T) f32; all f32, D in {16, 32, 64, 128}, H % HK == 0.  Every sum
// runs in f32.  The bf16 gradient is flash_attention_bwd_sm90.cu (wgmma +
// TMA).
//
// Deterministic: two kernels, no atomics.  The first walks one block per
// (b * h, 64 query rows) over its KV tiles: Drow, written for the second,
// and dQ.  The second walks one block per (b * hk, 64 keys) over the
// query tiles of every query head of its KV head (GQA sums dK and dV over
// the G heads inside the block): dK and dV.  A checkpoint-resumed train
// step therefore repeats its gradient bit for bit.
//
// What bounds it on this card: operations.  The gradient needs 2.5x the
// forward's products (4 B H T S D / 2 FLOPs causal): 85.9 GFLOP at
// (4, 2048, 16, 64), 0.52 ms as three TF32 products each (f32 accuracy)
// at 495 TFLOP/s.  This is the simple version: f32 FMAs on the CUDA cores
// (67 TFLOP/s at most), tiles of 64 x 64 in shared memory (rows padded by
// one word, so both the row and the column walks are free of bank
// conflicts), each of 256 threads owning a 4 x (N / 16) block of every
// product, strided by 16 so that the 16 threads of a half warp read
// neighbouring words.  S and dP are recomputed in both kernels.  Moving it
// onto 3xTF32 wgmma and TMA is a later step (ROADMAP.md, kernel
// follow-ups).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // query rows per tile
constexpr int kBN = 64;  // keys per tile
constexpr int kThreads = 256;

// acc[i][j] += sum_k A(r_i, k) B(k, c_j) for this thread's rows r_i =
// tr + 16 i (i < 4) and columns c_j = tc + 16 j (j < NJ); A(r, k) is
// a[r * am + k * ak], B(k, c) is b[k * bk + c * bn], both in shared memory.
template <int K, int NJ>
__device__ __forceinline__ void mm(float (&acc)[4][NJ], const float* a,
                                   int am, int ak, const float* b, int bk,
                                   int bn, int tr, int tc) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(tr + 16 * i) * am + k * ak];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[k * bk + (tc + 16 * j) * bn];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[4][NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// rows [r0, r0 + 64) of a (len, heads, D) slab at head h into a 64 x
// (D + 1) tile, times ``mul`` (rows past len read as 0)
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int len, int heads, int h,
                                          float mul) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] =
        row < len ? __fmul_rn(src[((size_t)row * heads + h) * D + d], mul)
                  : 0.f;
  }
}

// The P and dS tile of query rows q0.. and keys k0..: with qs, dO (rows)
// and K, V (keys) in shared memory, P (as P V takes it) to ``p_out`` when
// given and dS to ``ds_out``, both 64 x (kBN + 1) row-major by query.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* lse_s,
                                         const float* drow_s, float* p_out,
                                         float* ds_out, int q0, int k0,
                                         int t_len, int s_len, int causal,
                                         int tr, int tc) {
  float s[4][4], dp[4][4];
  zero(s);
  zero(dp);
  mm<D, 4>(s, qs, D + 1, 1, ks, 1, D + 1, tr, tc);
  mm<D, 4>(dp, dos, D + 1, 1, vs, 1, D + 1, tr, tc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tr + 16 * i, c = tc + 16 * j;
      const int row = q0 + r, key = k0 + c;
      const bool valid =
          row < t_len && key < s_len && !(causal && key > row);
      const float p = valid ? expf(__fsub_rn(s[i][j], lse_s[r])) : 0.f;
      if (p_out != nullptr) p_out[r * (kBN + 1) + c] = p;
      ds_out[r * (kBN + 1) + c] =
          __fmul_rn(p, __fsub_rn(dp[i][j], drow_s[r]));
    }
}

// ------------------------------------------------------------ dQ, Drow
// Grid: (B * H, ceil(T / 64)); block: 256 threads.
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ lse,
                  const float* __restrict__ dout, float* __restrict__ dq,
                  float* __restrict__ drow, int t_len,
                  int s_len, int heads, int kv_heads, int causal,
                  float scale) {
  extern __shared__ float smem[];
  constexpr int kTile = 64 * (D + 1);
  float* qs = smem;
  float* dos = qs + kTile;
  float* ks = dos + kTile;
  float* vs = ks + kTile;
  float* ds = vs + kTile;                 // 64 x (kBN + 1)
  float* lse_s = ds + kBM * (kBN + 1);
  float* drow_s = lse_s + kBM;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const float* qb = q + (size_t)b * t_len * heads * D;
  const float* ob = o + (size_t)b * t_len * heads * D;
  const float* dob = dout + (size_t)b * t_len * heads * D;
  const float* kb = k + (size_t)b * s_len * kv_heads * D;
  const float* vb = v + (size_t)b * s_len * kv_heads * D;
  const float* lse_b = lse + (size_t)bh * t_len;
  float* drow_b = drow + (size_t)bh * t_len;

  load_rows<D>(qs, qb, q0, t_len, heads, h, scale);
  load_rows<D>(dos, dob, q0, t_len, heads, h, 1.f);
  __syncthreads();
  // Drow = rowsum(dO * O): four threads a row, each a quarter of D, then
  // summed in a fixed order
  {
    const int r = tid >> 2, part = tid & 3;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < t_len) {
      const float* orow = ob + ((size_t)row * heads + h) * D;
      for (int d = part * (D / 4); d < (part + 1) * (D / 4); ++d)
        acc = __fmaf_rn(dos[r * (D + 1) + d], orow[d], acc);
    }
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
    if (part == 0) {
      drow_s[r] = acc;
      lse_s[r] = row < t_len ? lse_b[row] : 0.f;
      if (row < t_len) drow_b[row] = acc;
    }
  }
  __syncthreads();

  constexpr int NJ = D / 16;
  float acc[4][NJ];
  zero(acc);
  int n_kv = (s_len + kBN - 1) / kBN;
  if (causal) n_kv = min(n_kv, (q0 + kBM - 1) / kBN + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBN;
    load_rows<D>(ks, kb, k0, s_len, kv_heads, hk, 1.f);
    load_rows<D>(vs, vb, k0, s_len, kv_heads, hk, 1.f);
    __syncthreads();
    p_and_ds<D>(qs, dos, ks, vs, lse_s, drow_s, nullptr, ds, q0, k0, t_len,
                s_len, causal, tr, tc);
    __syncthreads();
    // dQ += dS K
    mm<kBN, NJ>(acc, ds, kBN + 1, 1, ks, D + 1, 1, tr, tc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= t_len) continue;
    float* dst = dq + (((size_t)b * t_len + row) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dst[tc + 16 * j] = __fmul_rn(scale, acc[i][j]);
  }
}

// ------------------------------------------------------------- dK, dV
// Grid: (B * HK, ceil(S / 64)); block: 256 threads.
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ lse,
                   const float* __restrict__ drow,
                   const float* __restrict__ dout,
                   float* __restrict__ dk, float* __restrict__ dv, int t_len,
                   int s_len, int heads, int kv_heads, int causal,
                   float scale) {
  extern __shared__ float smem[];
  constexpr int kTile = 64 * (D + 1);
  float* qs = smem;
  float* dos = qs + kTile;
  float* ks = dos + kTile;
  float* vs = ks + kTile;
  float* ps = vs + kTile;                 // 64 x (kBN + 1)
  float* ds = ps + kBM * (kBN + 1);
  float* lse_s = ds + kBM * (kBN + 1);
  float* drow_s = lse_s + kBM;

  const int bhk = blockIdx.x;
  const int b = bhk / kv_heads;
  const int hk = bhk - b * kv_heads;
  const int group = heads / kv_heads;
  const int k0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const float* qb = q + (size_t)b * t_len * heads * D;
  const float* dob = dout + (size_t)b * t_len * heads * D;
  const float* kb = k + (size_t)b * s_len * kv_heads * D;
  const float* vb = v + (size_t)b * s_len * kv_heads * D;

  load_rows<D>(ks, kb, k0, s_len, kv_heads, hk, 1.f);
  load_rows<D>(vs, vb, k0, s_len, kv_heads, hk, 1.f);

  constexpr int NJ = D / 16;
  float dk_acc[4][NJ], dv_acc[4][NJ];
  zero(dk_acc);
  zero(dv_acc);
  const int n_q = (t_len + kBM - 1) / kBM;
  // causal: query rows before k0 see none of these keys
  const int i0 = causal ? min(k0 / kBM, n_q) : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* lse_b = lse + ((size_t)b * heads + h) * t_len;
    const float* drow_b = drow + ((size_t)b * heads + h) * t_len;
    for (int i = i0; i < n_q; ++i) {
      const int q0 = i * kBM;
      __syncthreads();  // the previous tile's readers are done
      load_rows<D>(qs, qb, q0, t_len, heads, h, scale);
      load_rows<D>(dos, dob, q0, t_len, heads, h, 1.f);
      if (tid < kBM) {
        const int row = q0 + tid;
        lse_s[tid] = row < t_len ? lse_b[row] : 0.f;
        drow_s[tid] = row < t_len ? drow_b[row] : 0.f;
      }
      __syncthreads();
      p_and_ds<D>(qs, dos, ks, vs, lse_s, drow_s, ps, ds, q0, k0, t_len,
                  s_len, causal, tr, tc);
      __syncthreads();
      // dV += P^T dO, dK += dS^T qs: rows are keys, columns head dims
      mm<kBM, NJ>(dv_acc, ps, 1, kBN + 1, dos, D + 1, 1, tr, tc);
      mm<kBM, NJ>(dk_acc, ds, 1, kBN + 1, qs, D + 1, 1, tr, tc);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr + 16 * i;
    if (key >= s_len) continue;
    const size_t off = (((size_t)b * s_len + key) * kv_heads + hk) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tc + 16 * j] = dk_acc[i][j];
      dv[off + tc + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + kBM * (kBN + 1) + 2 * kBM);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * kBM * (kBN + 1) + 2 * kBM);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* drow, int batch, int t_len, int s_len, int heads,
           int kv_heads, int causal, float scale, cudaStream_t stream) {
  // set once per instance (thread-safe static initialisation)
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem<D>());
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dkv_smem<D>());
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdrow = static_cast<float*>(drow);
  const dim3 grid_q(batch * heads, (t_len + kBM - 1) / kBM);
  bwd_dq_kernel<D><<<grid_q, kThreads, dq_smem<D>(), stream>>>(
      tq, tk, tv, static_cast<const float*>(o), flse, tdo,
      static_cast<float*>(dq), fdrow, t_len, s_len, heads, kv_heads, causal,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k(batch * kv_heads, (s_len + kBN - 1) / kBN);
  bwd_dkv_kernel<D><<<grid_k, kThreads, dkv_smem<D>(), stream>>>(
      tq, tk, tv, flse, fdrow, tdo, static_cast<float*>(dk),
      static_cast<float*>(dv), t_len, s_len, heads, kv_heads, causal, scale);
  return (int)cudaGetLastError();
}

int dispatch(int head_dim, const void* q, const void* k, const void* v,
             const void* o, const void* lse, const void* dout, void* dq,
             void* dk, void* dv, void* drow, int batch, int t_len,
             int s_len, int heads, int kv_heads, int causal, float scale,
             cudaStream_t st) {
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, o, lse, dout, dq, dk, dv, drow, batch,
                        t_len, s_len, heads, kv_heads, causal, scale, st);
    case 32:
      return launch<32>(q, k, v, o, lse, dout, dq, dk, dv, drow, batch,
                        t_len, s_len, heads, kv_heads, causal, scale, st);
    case 64:
      return launch<64>(q, k, v, o, lse, dout, dq, dk, dv, drow, batch,
                        t_len, s_len, heads, kv_heads, causal, scale, st);
    case 128:
      return launch<128>(q, k, v, o, lse, dout, dq, dk, dv, drow, batch,
                         t_len, s_len, heads, kv_heads, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o, dout, dq: (batch, t_len, heads, head_dim); k, v, dk, dv: (batch,
// s_len, kv_heads, head_dim); all contiguous f32.  lse (the forward's m +
// log(l)) and drow (scratch, written here) are (batch, heads, t_len) f32.
// head_dim in {16, 32, 64, 128}; heads % kv_heads == 0; t_len, s_len >= 1;
// batch * heads < 2^31 and ceil(t_len / 64), ceil(s_len / 64) <= 65535.
// ``scale`` is the forward's f32(head_dim^-1/2).  Launches both kernels on
// ``stream`` and returns the first nonzero cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported head_dim.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* lse,
                               const void* dout, void* dq, void* dk,
                               void* dv, void* drow, int batch, int t_len,
                               int s_len, int heads, int kv_heads,
                               int head_dim, int causal, float scale,
                               void* stream) {
  return dispatch(head_dim, q, k, v, o, lse, dout, dq, dk, dv, drow, batch,
                  t_len, s_len, heads, kv_heads, causal, scale,
                  (cudaStream_t)stream);
}

}  // extern "C"
