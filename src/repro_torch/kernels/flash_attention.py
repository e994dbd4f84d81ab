"""Wrappers of the two CUDA flash-attention kernels, one per dtype, which
replace the Pallas TPU kernel of the JAX package's
``kernels/flash_attention.py``:

* bf16 -> ``csrc/flash_attention_sm90.cu`` (``flash_attention_sm90``):
  wgmma and TMA on the tensor cores, computing the JAX model's bf16
  attention (``repro.models.attention.flash_attention``): q scaled by
  bf16(D^-1/2) and rounded to bf16, scores summed in f32, P rounded to
  bf16 for P V, l summed from the f32 p.  Plain version:
  ``ref.flash_attention_bf16_ref``.
* f32 -> ``csrc/flash_attention_f32_sm90.cu`` (``flash_attention_f32``):
  the Pallas kernel's f32 function on the tensor cores, each product as
  three TF32 products of hi / lo splits (3xTF32, f32 accuracy), wgmma and
  TMA as the bf16 kernel.  Plain version: ``ref.flash_attention_ref``.

q (B, T, H, D), k / v (B, S, HK, D), all contiguous on one CUDA device,
one dtype, D in {16, 32, 64, 128}, H % HK == 0.  Returns (B, T, H, D) in
q's dtype.  The kernels mask the ragged edges of T and S and index the
KV head of each query head (GQA) themselves, so nothing is padded,
repeated or copied.  The wrapper checks its inputs, allocates the
output, launches on the current stream, raises if the launch failed, and
adds one to the kernel's ``LAUNCHES`` entry.  ``ops.flash_attention``
picks between kernel and plain version by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64, 128)
# dtype -> (kernel name, C library, launch function)
KERNELS = {
    torch.bfloat16: ("flash_attention_sm90", "flash_attention_sm90",
                     "flash_attention_sm90_launch"),
    torch.float32: ("flash_attention_f32", "flash_attention_f32_sm90",
                    "flash_attention_launch"),
}
# both kernels run b * h along the grid's x dimension and the query tiles
# of 128 rows along y
_MAX_Q_TILES = 65535
_TILE = 128
# The f32 kernel's key order inside each 8-key step of P V: TF32 wgmma's
# A fragment takes columns (c, c + 4) where the accumulator holds (2c,
# 2c + 1), so A column i is key TF32_KEY_ORDER[i], and the kernel writes
# V^T's columns in the same order.
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)

# launches since the last reset (a plain dict of ints)
LAUNCHES = {name: 0 for name, _, _ in KERNELS.values()}

_P = ctypes.c_void_p
_I = ctypes.c_int
_TYPED: set = set()


def _launcher(dtype: torch.dtype):
    _, lib_name, fn_name = KERNELS[dtype]
    fn = getattr(build.load(lib_name), fn_name)
    if id(fn) not in _TYPED:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _P]
        fn.restype = ctypes.c_int
        _TYPED.add(id(fn))
    return fn


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, T, S, H, HK, D) of a supported call, else raise."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, T, H, D) q and "
                         "(B, S, HK, D) k, v")
    B, T, H, D = q.shape
    S, HK = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, S, HK, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if HK < 1 or H % HK:
        raise ValueError(f"{H} query heads are not a multiple of {HK} "
                         f"KV heads")
    if T < 1 or S < 1:
        raise ValueError(f"empty sequence: T={T}, S={S}")
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{list(KERNELS)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    return B, T, S, H, HK, D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Launch q's dtype's kernel: (B, T, H, D) attention output in q's
    dtype."""
    B, T, S, H, HK, D = check_shapes(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches on CUDA, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    name = KERNELS[q.dtype][0]
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{label} must be 16-byte aligned for TMA")
    if B * H >= 2 ** 31 or -(-T // _TILE) > _MAX_Q_TILES:
        raise ValueError(f"B * H = {B * H} or T = {T} exceeds the grid's "
                         f"limits")
    if q.dtype == torch.bfloat16:
        scale = ref.bf16_scale(D)
    else:
        scale = float(D) ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T,
            S, H, HK, D, int(causal), scale, stream)
    if err == -1:
        raise RuntimeError(f"{name}: the CUDA driver has no "
                           f"cuTensorMapEncodeTiled")
    if err <= -1000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {-1000 - err}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out
