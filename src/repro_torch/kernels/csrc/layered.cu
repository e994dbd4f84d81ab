// Shifted layered quantizer (paper Def. 5) with a Gaussian target,
// encode and decode, for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/layered_encode.py:
//   layered_encode_kernel <- layered_encode.layered_encode (_encode_kernel)
//   layered_decode_kernel <- layered_encode.layered_decode (_decode_kernel)
// but computes what the JAX package's core path computes (core/layered.py
// with Gaussian.step_shifted / offset_shifted), in the order XLA compiles
// it on the CPU, which the reference pins its Pallas kernel to
// (tests/test_kernels.py::test_layered_kernel_matches_core):
//
//   r(v)   = sqrt(max(-2 log(clamp(v * c, 1e-37, 1)), 0)),
//            c = f32(s sqrt(2 pi))
//   encode: step = fma(r(W), s, r(peak - W) * s)
//           m    = floor(x / step + (u - 1/2) + 1/2)
//   decode: bp = r(W) * s,  bm = r(peak - W) * s
//           y  = fma(m - (u - 1/2), bp + bm, 0.5 * (bp - bm))
//
// log is XLA's f32 CPU polynomial (src/repro_torch/core/f32.py: the same
// constants and fused multiply-adds), not CUDA's logf, whose last bits
// differ; sqrt is the correctly rounded __fsqrt_rn.  Every other operation
// is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn,
// __fmaf_rn where XLA contracts), and the file is built with --fmad=false
// and without --use_fast_math, so the results equal the plain PyTorch
// version bit for bit.
//
// What bounds them: a streaming pass over 16 bytes per element (x or m,
// u and W read, the message or value written) with two log/sqrt chains
// (~60 flops) per element: at 3.35 TB/s the bytes take 4.8 ps per
// element, the flops at 67 TFLOP/s f32 about 0.9 ps, so they are bound by
// device-memory bytes.  Design: one thread per element, adjacent threads
// on adjacent elements (coalesced 128-byte warp loads), no shared memory
// (no reuse).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// XLA's f32 log for finite x >= the smallest normal (here x >= 1e-37).
__device__ __forceinline__ float xla_log(float x) {
  const int bits = __float_as_int(x);
  float e = __fadd_rn((float)((bits >> 23) - 127), 1.0f);
  float m = __int_as_float((bits & 0x807FFFFF) | 0x3F000000);
  const bool small = m < 0.707106769084930419921875f;
  if (small) e = __fsub_rn(e, 1.0f);
  m = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float m2 = __fmul_rn(m, m);
  const float m3 = __fmul_rn(m2, m);
  float y = __fmaf_rn(
      __fmaf_rn(0.07037683576345444f, m, -0.11514610052108765f), m,
      0.11676998436450958f);
  const float y1 = __fmaf_rn(
      __fmaf_rn(-0.12420140951871872f, m, 0.14249323308467865f), m,
      -0.16668057441711426f);
  const float y2 = __fmaf_rn(
      __fmaf_rn(0.2000071406364441f, m, -0.24999994039535522f), m,
      0.3333333134651184f);
  y = __fmaf_rn(y, m3, y1);
  y = __fmaf_rn(y, m3, y2);
  y = __fmaf_rn(y, m3, __fmul_rn(e, -0.00021219444170128554f));
  const float r = __fadd_rn(__fmaf_rn(m2, -0.5f, m), y);
  return __fmaf_rn(e, 0.693359375f, r);
}

// r(v) = sqrt(max(-2 log(clamp(v * c, 1e-37, 1)), 0)); b+(v) = s * r(v)
__device__ __forceinline__ float root(float v, float c) {
  const float t = fminf(fmaxf(__fmul_rn(v, c), 1e-37f), 1.0f);
  return __fsqrt_rn(fmaxf(__fmul_rn(-2.0f, xla_log(t)), 0.0f));
}

__global__ void layered_encode_kernel(const float* __restrict__ x,
                                      const float* __restrict__ u,
                                      const float* __restrict__ layer,
                                      float s, float c, float peak,
                                      long long n, int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float w = layer[i];
  const float r1 = root(w, c), r2 = root(__fsub_rn(peak, w), c);
  const float step = __fmaf_rn(r1, s, __fmul_rn(r2, s));
  const float q = __fadd_rn(
      __fadd_rn(__fdiv_rn(x[i], step), __fsub_rn(u[i], 0.5f)), 0.5f);
  out[i] = (int32_t)floorf(q);
}

__global__ void layered_decode_kernel(const int32_t* __restrict__ m,
                                      const float* __restrict__ u,
                                      const float* __restrict__ layer,
                                      float s, float c, float peak,
                                      long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float w = layer[i];
  const float bp = __fmul_rn(root(w, c), s);
  const float bm = __fmul_rn(root(__fsub_rn(peak, w), c), s);
  const float step = __fadd_rn(bp, bm);
  const float offset = __fmul_rn(0.5f, __fsub_rn(bp, bm));
  const float d = __fsub_rn((float)m[i], __fsub_rn(u[i], 0.5f));
  out[i] = __fmaf_rn(d, step, offset);
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// x, u, layer: n f32; out: n int32.  s = f32(sigma), c = f32(s) *
// f32(sqrt(2 pi)) rounded to f32, peak = f32(1 / (sigma sqrt(2 pi))).
// Returns the launch's cudaGetLastError().
int layered_encode_launch(const float* x, const float* u, const float* layer,
                          float s, float c, float peak, long long n,
                          int32_t* out, void* stream) {
  if (n > 0) {
    layered_encode_kernel<<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(x, u, layer, s, c, peak,
                                                    n, out);
  }
  return (int)cudaGetLastError();
}

// m: n int32; u, layer: n f32; out: n f32.  Constants as above.
int layered_decode_launch(const int32_t* m, const float* u,
                          const float* layer, float s, float c, float peak,
                          long long n, float* out, void* stream) {
  if (n > 0) {
    layered_decode_kernel<<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(m, u, layer, s, c, peak,
                                                    n, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
