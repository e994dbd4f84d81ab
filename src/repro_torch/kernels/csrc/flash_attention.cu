// Flash attention (block online softmax) for Hopper, f32.
//
// Replaces, for f32 inputs, the Pallas TPU kernel of
// src/repro/kernels/flash_attention.py:
//   flash_attention_kernel <- flash_attention.flash_attention_tpu (_kernel)
// and takes the layout of its wrapper src/repro/kernels/ops.py
// (flash_attention): q (B, T, H, D), k and v (B, S, HK, D), out
// (B, T, H, D), all contiguous f32.  (bf16 inputs go to
// flash_attention_sm90.cu, which computes the JAX model's bf16 function
// on the tensor cores.)  What it computes is the Pallas kernel's
// function, not its block layout:
//
//   s[i, j] = (f32(q[i]) * D^-1/2) . f32(k[j])     (scaled q rounded to f32)
//   s[i, j] = -1e30 where j >= S, or j > i when causal (aligned top left)
//   running m, l, acc over KV tiles in f32; P stays f32 for P V
//   out[i]  = acc / max(l, 1e-30)
//
// KV tiles that lie wholly above the causal diagonal are skipped.  Rows
// of q past T and of k / v past S load as 0 and are never stored, so
// ragged T and S need no padding or copy.  GQA reads KV head h / (H/HK)
// in place of the wrapper's jnp.repeat.
//
// What bounds it on this card: operations.  Causal attention at T = S =
// 2048, 16 heads, D = 64 is 8.6 GFLOP against 33.6 MB of f32 q, k, v and
// out: 10 us of bytes at 3.35 TB/s, 128 us at the f32 rate outside the
// tensor cores (67 TFLOP/s), which is this kernel's bound: f32 FMAs on
// CUDA cores, written as explicit fmaf (the build passes --fmad=false).
//
// Design: one block of 256 threads per (batch * head, 64-row query
// tile); it loops over 64-row KV tiles staged in shared memory as f32 (K
// and the scaled Q transposed, V as it is).  Each thread computes a 4 x 4
// block of the 64 x 64 score tile from float4 reads of Q^T and K^T (16
// FMAs per two shared loads), reduces its rows' max and sum over the 16
// threads that share them with warp shuffles, writes P^T to shared memory
// and accumulates 4 rows x D/16 columns of the output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per KV tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kPad = 4;        // row padding of the transposed tiles
constexpr int kLQ = kBQ + kPad;
constexpr int kLK = kBK + kPad;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)D * kLQ + (size_t)D * kLK + (size_t)kBK * D +
          (size_t)kBK * kLQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int t_len, int s_len, int heads, int kv_heads,
                           int causal, float scale) {
  constexpr int kCols = D / 16;                  // output columns a thread
  constexpr int kVec = kCols >= 4 ? 4 : kCols;   // width of one V read
  constexpr int kGroups = kCols / kVec;

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                // [D][kLQ]   scaled Q, transposed
  float* kt = qt + D * kLQ;        // [D][kLK]   K, transposed
  float* vs = kt + D * kLK;        // [kBK][D]   V
  float* pt = vs + kBK * D;        // [kBK][kLQ] P, transposed

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;  // score columns tx*4 .. tx*4+3
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kBQ;

  const long long q_stride = (long long)heads * D;
  const long long k_stride = (long long)kv_heads * D;
  const float* qb = q + ((long long)b * t_len * heads + h) * D;
  const float* kb = k + ((long long)b * s_len * kv_heads + hk) * D;
  const float* vb = v + ((long long)b * s_len * kv_heads + hk) * D;
  float* ob = o + ((long long)b * t_len * heads + h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int t = q0 + r;
    qt[d * kLQ + r] =
        t < t_len ? __fmul_rn(qb[t * q_stride + d], scale) : 0.f;
  }

  float m_run[4], l_run[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[i][e] = 0.f;
  }

  int n_kv = (s_len + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (q0 + kBQ - 1) / kBK + 1);  // skip above

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D;
      const int d = i - c * D;
      const int s = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (s < s_len) {
        kv = kb[s * k_stride + d];
        vv = vb[s * k_stride + d];
      }
      kt[d * kLK + c] = kv;
      vs[c * D + d] = vv;
    }
    __syncthreads();

    // S = (scaled Q) K^T: this thread's 4 x 4 block
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qt[d * kLQ + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&kt[d * kLK + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }

    // mask, online softmax update, P^T to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx * 4 + c;
        const bool keep = col < s_len && (!causal || col <= row);
        if (!keep) sc[i][c] = kNegInf;
        mx = fmaxf(mx, sc[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float corr = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sc[i][c] - m_new);
        sum += p;
        pt[(tx * 4 + c) * kLQ + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = fmaf(l_run[i], corr, sum);
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty*4 .. +3, columns g*16*kVec + tx*kVec + w
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&pt[c * kLQ + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[kCols];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float* src = &vs[c * D + g * 16 * kVec + tx * kVec];
        if constexpr (kVec == 4) {
          const float4 va = *reinterpret_cast<const float4*>(src);
          vv[g * 4 + 0] = va.x;
          vv[g * 4 + 1] = va.y;
          vv[g * 4 + 2] = va.z;
          vv[g * 4 + 3] = va.w;
        } else {
#pragma unroll
          for (int w = 0; w < kVec; ++w) vv[g * kVec + w] = src[w];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= t_len) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int w = 0; w < kVec; ++w) {
        const int e = g * 16 * kVec + tx * kVec + w;
        ob[t * q_stride + e] = __fdiv_rn(acc[i][g * kVec + w], l);
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int t_len, int s_len, int heads, int kv_heads, int causal,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // The shared-memory limit is a property of the instance: set it once
  // (thread-safe static initialisation) and keep its status for later calls.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((t_len + kBQ - 1) / kBQ, batch * heads);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), t_len, s_len,
      heads, kv_heads, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (batch, t_len, heads, head_dim); k, v: (batch, s_len, kv_heads,
// head_dim); contiguous f32; head_dim in {16, 32, 64, 128}; heads %
// kv_heads == 0; t_len, s_len >= 1.  ``scale`` is f32(head_dim^-1/2).
// Launches on ``stream`` and returns its cudaGetLastError() (or
// cudaErrorInvalidValue for an unsupported head_dim).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int batch, int t_len, int s_len,
                           int heads, int kv_heads, int head_dim, int causal,
                           float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, o, batch, t_len, s_len, heads, kv_heads,
                        causal, scale, st);
    case 32:
      return launch<32>(q, k, v, o, batch, t_len, s_len, heads, kv_heads,
                        causal, scale, st);
    case 64:
      return launch<64>(q, k, v, o, batch, t_len, s_len, heads, kv_heads,
                        causal, scale, st);
    case 128:
      return launch<128>(q, k, v, o, batch, t_len, s_len, heads, kv_heads,
                         causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
