// Fused homomorphic encode / decode of the aggregate AINQ mechanisms
// (aggregate_gaussian, aggregate_laplace, irwin_hall) for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_agg.py:
//   fused_encode_kernel  <- fused_agg.fused_encode (_encode_kernel,
//                           _quantize_pack)
//   fused_decode_kernel  <- fused_agg.fused_decode (_decode_kernel,
//                           _unpack_affine)
//
// Layout (shared with ops._pad_rows): inputs are (R, G, 128) f32 rows,
// G = 32 / bits fields per int32 word, words are (R, 128).
//
//   encode: m = clamp(floor(x / step + s + 1/2), -m_max, m_max)
//           (scalar step: floor(fma(x, rcp, s) + 1/2), rcp = f32(1/step))
//           word[r, c] = OR_j (m[r, j, c] + m_max) << (bits * j)
//   decode: u_j = (word[r, c] >> (bits * j)) & mask
//           y[r, j, c] = (u_j - s_eff[r, j, c]) * step [+ offset]
//
// What bounds them: both are pure streaming passes, a handful of flops
// per 4-byte element, so they are bound by device-memory bytes (each
// input read once, each output written once).  Design: one thread per
// output word (r, c) loops over the G fields; adjacent threads take
// adjacent lanes c, so every load and store of a warp is one contiguous
// 128-byte segment.  Nothing is staged in shared memory: there is no
// reuse to exploit.
//
// Rounding: the words must equal the plain PyTorch version bitwise, so
// every f32 operation is an explicitly rounded intrinsic in the order of
// the reference as XLA compiles it -- ((x / step) + s) + 0.5 for an
// array step; for a scalar step, a compile-time constant there, XLA
// multiplies by its f32 reciprocal in one fused multiply-add,
// fma(x, rcp, s) + 0.5 -- and ((u - s_eff) * step) + offset; nothing else
// is contracted into an FMA, and the file is built without
// --use_fast_math (and with --fmad=false).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

__global__ void fused_encode_kernel(const float* __restrict__ x,
                                    const float* __restrict__ s,
                                    const float* __restrict__ step_arr,
                                    float rcp, long long n_words, int bits,
                                    int group, int m_max,
                                    int32_t* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_words) return;
  const long long r = t / kLanes;
  const int c = (int)(t - r * kLanes);
  const long long base = r * group * kLanes + c;
  const float lo = (float)(-m_max), hi = (float)m_max;
  uint32_t word = 0u;
  for (int j = 0; j < group; ++j) {
    const long long i = base + (long long)j * kLanes;
    const float d = step_arr != nullptr
                        ? __fadd_rn(__fdiv_rn(x[i], step_arr[i]), s[i])
                        : __fmaf_rn(x[i], rcp, s[i]);
    const float q = __fadd_rn(d, 0.5f);
    const float m = fminf(fmaxf(floorf(q), lo), hi);
    const uint32_t u = (uint32_t)((int32_t)m + m_max);
    word |= u << (bits * j);
  }
  out[t] = (int32_t)word;
}

__global__ void fused_decode_kernel(const int32_t* __restrict__ words,
                                    const float* __restrict__ s_eff,
                                    const float* __restrict__ step_arr,
                                    float step,
                                    const float* __restrict__ offset,
                                    long long n_words, int bits, int group,
                                    float* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_words) return;
  const long long r = t / kLanes;
  const int c = (int)(t - r * kLanes);
  const long long base = r * group * kLanes + c;
  const uint32_t mask = (1u << bits) - 1u;  // bits <= 24
  // unsigned shift + mask: recovers a top field that touches bit 31
  const uint32_t w = (uint32_t)words[t];
  for (int j = 0; j < group; ++j) {
    const long long i = base + (long long)j * kLanes;
    const float u = (float)((w >> (bits * j)) & mask);  // < 2^24: exact
    const float st = step_arr != nullptr ? step_arr[i] : step;
    float y = __fmul_rn(__fsub_rn(u, s_eff[i]), st);
    if (offset != nullptr) y = __fadd_rn(y, offset[i]);
    out[i] = y;
  }
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// x, s, [step_arr]: (rows, group, 128) f32; out: (rows, 128) int32.
// step_arr == nullptr selects a scalar step given by its f32 reciprocal
// ``rcp``.  Returns the launch's cudaGetLastError().
int fused_encode_launch(const float* x, const float* s,
                        const float* step_arr, float rcp, long long rows,
                        int bits, int group, int m_max, int32_t* out,
                        void* stream) {
  const long long n_words = rows * kLanes;
  if (n_words > 0) {
    fused_encode_kernel<<<blocks_for(n_words), kThreads, 0,
                          (cudaStream_t)stream>>>(
        x, s, step_arr, rcp, n_words, bits, group, m_max, out);
  }
  return (int)cudaGetLastError();
}

// words: (rows, 128) int32; s_eff, [step_arr], [offset], out:
// (rows, group, 128) f32.  Null step_arr selects the scalar ``step``;
// null offset adds nothing.  Returns the launch's cudaGetLastError().
int fused_decode_launch(const int32_t* words, const float* s_eff,
                        const float* step_arr, float step,
                        const float* offset, long long rows, int bits,
                        int group, float* out, void* stream) {
  const long long n_words = rows * kLanes;
  if (n_words > 0) {
    fused_decode_kernel<<<blocks_for(n_words), kThreads, 0,
                          (cudaStream_t)stream>>>(
        words, s_eff, step_arr, step, offset, n_words, bits, group, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
