"""Wrappers of the CUDA kernels in ``csrc/fused_agg.cu``: fused
homomorphic encode / decode for the aggregate AINQ mechanisms.

They replace the Pallas TPU kernels of the JAX package's
``kernels/fused_agg.py``:

    m      = clamp(floor(x / step + s + 1/2), -m_max, m_max)
             (a scalar step: floor(fma(x, f32(1/step), s) + 1/2), as XLA
             compiles the reference's division by a constant)
    word_c = sum_j (m[j, c] + m_max) << (bits * j)     G = 32//bits

    u_j = (word_sum >> (bits * j)) & mask              (unsigned)
    y   = (u - s_eff) * step_dec [+ offset]

Both take (R, G, 128) f32 rows and (R, 128) int32 words on a CUDA
device; the step is a python scalar (a kernel argument) or an (R, G, 128)
tensor.  Each wrapper checks its inputs, allocates its output, launches
on the current stream, raises if the launch failed, and adds one to its
count in ``LAUNCHES``; on meta tensors (the dry run) it checks and
allocates alike and charges its bytes to ``kernels.meta`` in place of the
launch.  The plain versions are ``ref.fused_encode_ref`` /
``ref.fused_decode_ref``; ``ops`` picks between the two by device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.core.f32 import rcp
from repro_torch.kernels import build, meta

LANES = 128

# launches of each kernel since the last reset (a plain dict of ints)
LAUNCHES = {"fused_encode": 0, "fused_decode": 0}

_P = ctypes.c_void_p


_TYPED: set = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_agg")
    if id(lib) not in _TYPED:
        lib.fused_encode_launch.argtypes = [
            _P, _P, _P, ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _P, _P]
        lib.fused_encode_launch.restype = ctypes.c_int
        lib.fused_decode_launch.argtypes = [
            _P, _P, _P, ctypes.c_float, _P, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, _P, _P]
        lib.fused_decode_launch.restype = ctypes.c_int
        _TYPED.add(id(lib))
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _step_args(step, shape, device):
    """(tensor, scalar) pair of a scalar or (R, G, 128) tensor step."""
    if isinstance(step, torch.Tensor):
        _check("step", step, torch.float32, shape, device)
        return step, 0.0
    return None, float(step)


def _ptr(t):
    return None if t is None else t.data_ptr()


def on_card(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` is on CUDA (or meta: the dry run)."""
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} launches on CUDA, got {t.device}")


def _group(bits: int) -> int:
    if not 2 <= bits <= 24:
        raise ValueError(f"packed field width must be in [2, 24], got {bits}")
    return max(32 // bits, 1)


def fused_encode(x: torch.Tensor, s: torch.Tensor,
                 step: Union[float, torch.Tensor], bits: int,
                 m_max: int) -> torch.Tensor:
    """x, s: (R, G, 128) f32 CUDA with G = 32 // bits; ``step`` a python
    scalar or an (R, G, 128) tensor -> packed biased int32 words (R, 128).
    """
    g = _group(bits)
    on_card("fused_encode", x)
    R = x.shape[0]
    shape = (R, g, LANES)
    for name, t in (("x", x), ("s", s)):
        _check(name, t, torch.float32, shape, x.device)
    step_t, step_val = _step_args(step, shape, x.device)
    if step_t is None:
        step_val = rcp(step_val)
    out = torch.empty((R, LANES), dtype=torch.int32, device=x.device)
    if x.device.type == "meta":  # the dry run: no launch, the cost charged
        meta.charge("fused_encode", 0, (x, s, step_t), (out,))
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().fused_encode_launch(
            x.data_ptr(), s.data_ptr(), _ptr(step_t), step_val, R, bits, g,
            int(m_max), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_encode launch failed: CUDA error {err}")
    LAUNCHES["fused_encode"] += 1
    return out


def fused_decode(word: torch.Tensor, s_eff: torch.Tensor,
                 step: Union[float, torch.Tensor],
                 offset: Optional[torch.Tensor], bits: int) -> torch.Tensor:
    """Summed packed words (R, 128) int32 + effective dither s_eff =
    dither_sum + r * m_max (R, G, 128) -> f32 (R, G, 128).  ``step`` is
    the decode step (scalar or (R, G, 128)); ``offset`` the additive
    shared offset (R, G, 128) or None."""
    g = _group(bits)
    on_card("fused_decode", word)
    R = word.shape[0]
    shape = (R, g, LANES)
    _check("word", word, torch.int32, (R, LANES), word.device)
    _check("s_eff", s_eff, torch.float32, shape, word.device)
    step_t, step_val = _step_args(step, shape, word.device)
    if offset is not None:
        _check("offset", offset, torch.float32, shape, word.device)
    out = torch.empty(shape, dtype=torch.float32, device=word.device)
    if word.device.type == "meta":
        meta.charge("fused_decode", 0, (word, s_eff, step_t, offset), (out,))
        return out
    with torch.cuda.device(word.device):
        stream = torch.cuda.current_stream(word.device).cuda_stream
        err = _lib().fused_decode_launch(
            word.data_ptr(), s_eff.data_ptr(), _ptr(step_t), step_val,
            _ptr(offset),
            R, bits, g, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_decode launch failed: CUDA error {err}")
    LAUNCHES["fused_decode"] += 1
    return out
