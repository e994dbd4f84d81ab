"""Wrapper of the CUDA kernel in ``csrc/flash_attention.cu``: block
online-softmax attention in f32 arithmetic, replacing the Pallas TPU
kernel of the JAX package's ``kernels/flash_attention.py``.

q (B, T, H, D), k / v (B, S, HK, D), all contiguous on one CUDA device,
one dtype (f32 or bf16), D in {16, 32, 64, 128}, H % HK == 0.  Returns
(B, T, H, D) in q's dtype.  The kernel masks the ragged edges of T and S
and indexes the KV head of each query head (GQA) itself, so nothing is
padded, repeated or copied.  The wrapper checks its inputs, allocates
the output, launches on the current stream, raises if the launch
failed, and adds one to ``LAUNCHES``.  The plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` picks between the
two by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches since the last reset (a plain dict of ints)
LAUNCHES = {"flash_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_TYPED: set = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if id(lib) not in _TYPED:
        lib.flash_attention_launch.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
            _P]
        lib.flash_attention_launch.restype = ctypes.c_int
        _TYPED.add(id(lib))
    return lib


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
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{list(DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    return B, T, S, H, HK, D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Launch the kernel: (B, T, H, D) attention output in q's dtype."""
    B, T, S, H, HK, D = check_shapes(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches on CUDA, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's 65535")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T,
            S, H, HK, D, int(causal), float(D) ** -0.5, DTYPES[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
