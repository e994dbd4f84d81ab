// Signed subtractive-dither quantize + bit-pack, and unpack + decode, for
// Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dither_pack.py:
//   dither_pack_kernel   <- dither_pack.dither_pack (_encode_kernel)
//   unpack_decode_kernel <- dither_pack.unpack_decode (_decode_kernel)
//
// Layout (shared with ops._pad_rows): inputs are (R, G, 128) f32 rows,
// G = 32 / bits fields per int32 word (bits in {4, 8, 16}), words are
// (R, 128).
//
//   encode: m = clamp(floor(fma(x, inv_w, s) + 1/2), -2^(b-1), 2^(b-1) - 1)
//           word[r, c] = OR_j (m[r, j, c] & mask) << (bits * j)
//   decode: m_j = (int32)(word << (32 - bits (j + 1))) >> (32 - bits)
//           y[r, j, c] = (m_j - s[r, j, c]) * w
//
// inv_w is f32(1.0 / w), the reciprocal the reference multiplies by; XLA
// contracts that multiply with the dither add, so the kernel takes one
// __fmaf_rn there and explicitly rounded intrinsics elsewhere, built with
// --fmad=false and without --use_fast_math: the words equal the plain
// PyTorch version bit for bit.
//
// What bounds them: streaming passes with a few flops per 4-byte element,
// bound by device-memory bytes (each input read once, each output written
// once: 8 + 4/G bytes per coordinate encoding, 8 + 4/G decoding).
// Design: one thread per word (r, c) loops over the G fields; adjacent
// threads take adjacent lanes c, so each warp's loads and stores are
// contiguous 128-byte segments; no shared memory (no reuse).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

__global__ void dither_pack_kernel(const float* __restrict__ x,
                                   const float* __restrict__ s, float inv_w,
                                   long long n_words, int bits,
                                   int32_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_words) return;
  const int group = 32 / bits;
  const long long r = t / kLanes;
  const int c = (int)(t - r * kLanes);
  const long long base = r * group * kLanes + c;
  const float lo = (float)(-(1 << (bits - 1)));
  const float hi = (float)((1 << (bits - 1)) - 1);
  const uint32_t mask = (bits == 32) ? 0xFFFFFFFFu : ((1u << bits) - 1u);
  uint32_t word = 0u;
  for (int j = 0; j < group; ++j) {
    const long long i = base + (long long)j * kLanes;
    const float q = __fadd_rn(__fmaf_rn(x[i], inv_w, s[i]), 0.5f);
    const float m = fminf(fmaxf(floorf(q), lo), hi);
    word |= ((uint32_t)(int32_t)m & mask) << (bits * j);
  }
  out[t] = (int32_t)word;
}

__global__ void unpack_decode_kernel(const int32_t* __restrict__ words,
                                     const float* __restrict__ s, float w,
                                     long long n_words, int bits,
                                     float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_words) return;
  const int group = 32 / bits;
  const long long r = t / kLanes;
  const int c = (int)(t - r * kLanes);
  const long long base = r * group * kLanes + c;
  const uint32_t word = (uint32_t)words[t];
  for (int j = 0; j < group; ++j) {
    const long long i = base + (long long)j * kLanes;
    // left shift as unsigned, then an arithmetic right shift sign-extends
    const int32_t m =
        ((int32_t)(word << (32 - bits * (j + 1)))) >> (32 - bits);
    out[i] = __fmul_rn(__fsub_rn((float)m, s[i]), w);
  }
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// x, s: (rows, 32 / bits, 128) f32; out: (rows, 128) int32.  inv_w =
// f32(1.0 / w).  Returns the launch's cudaGetLastError().
int dither_pack_launch(const float* x, const float* s, float inv_w,
                       long long rows, int bits, int32_t* out, void* stream) {
  const long long n_words = rows * kLanes;
  if (n_words > 0) {
    dither_pack_kernel<<<blocks_for(n_words), kThreads, 0,
                         (cudaStream_t)stream>>>(x, s, inv_w, n_words, bits,
                                                 out);
  }
  return (int)cudaGetLastError();
}

// words: (rows, 128) int32; s, out: (rows, 32 / bits, 128) f32.
// Returns the launch's cudaGetLastError().
int unpack_decode_launch(const int32_t* words, const float* s, float w,
                         long long rows, int bits, float* out, void* stream) {
  const long long n_words = rows * kLanes;
  if (n_words > 0) {
    unpack_decode_kernel<<<blocks_for(n_words), kThreads, 0,
                           (cudaStream_t)stream>>>(words, s, w, n_words, bits,
                                                   out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
