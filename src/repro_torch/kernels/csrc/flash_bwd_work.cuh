// The flash-attention backwards' scratch sizes, in plain host C++ (no CUDA
// header): flash_attention_bwd_sm90.cu (bf16) and
// flash_attention_bwd_f32_sm90.cu (f32) return them from their
// ``<name>_work_bytes``, and tests/test_torch_dryrun.py compiles this file
// with the host's compiler to hold the dry run's copy
// (flash_attention.bwd_work_bytes, used on meta tensors where no library
// is built) to them.
#pragma once

#include <stddef.h>

// T_pad, S_pad: the lengths rounded up to this
#define FA_BWD_ROW_PAD 128

static inline size_t fa_bwd_pad(int len) {
  return (size_t)((len + FA_BWD_ROW_PAD - 1) / FA_BWD_ROW_PAD) *
         FA_BWD_ROW_PAD;
}

// bf16: lse log2(e) and Drow, (batch, heads, T_pad) f32 each, then qs,
// (batch, t_len, heads, head_dim) bf16.  s_len and kv_heads are not needed.
static inline size_t fa_bwd_bf16_work_bytes(int batch, int t_len, int s_len,
                                            int heads, int kv_heads,
                                            int head_dim) {
  (void)s_len;
  (void)kv_heads;
  const size_t rows = (size_t)batch * heads * fa_bwd_pad(t_len);
  return 2 * rows * sizeof(float) +
         (size_t)batch * t_len * heads * head_dim * 2;
}

// the f32 scratch's width for a head dim: 112 runs the 128 instances
static inline int fa_bwd_f32_scratch_dim(int head_dim) {
  return head_dim == 112 ? 128 : head_dim;
}

// f32, in floats (struct Work): lse log2(e) and Drow (batch, heads, T_pad);
// qs and dO, each as two TF32 halves (2 batch, t_len, heads, D), and their
// transposes (2 batch, heads, D, T_pad); k and v (2 batch, s_len, kv_heads,
// D) and k's transpose (2 batch, kv_heads, D, S_pad).
static inline size_t fa_bwd_f32_work_floats(int batch, int t_len, int s_len,
                                            int heads, int kv_heads,
                                            int head_dim) {
  const size_t d = (size_t)fa_bwd_f32_scratch_dim(head_dim);
  const size_t rows = (size_t)batch * heads * fa_bwd_pad(t_len);
  const size_t qn = 2 * (size_t)batch * t_len * heads * d;
  const size_t qtn = 2 * (size_t)batch * heads * d * fa_bwd_pad(t_len);
  const size_t kn = 2 * (size_t)batch * s_len * kv_heads * d;
  const size_t ktn = 2 * (size_t)batch * kv_heads * d * fa_bwd_pad(s_len);
  return 2 * rows + 2 * qn + 2 * qtn + 2 * kn + ktn;
}
