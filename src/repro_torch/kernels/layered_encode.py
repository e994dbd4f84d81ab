"""Wrappers of the CUDA kernels in ``csrc/layered.cu``: the Gaussian
shifted layered quantizer's encode and decode (paper Def. 5).

They replace the Pallas TPU kernels of the JAX package's
``kernels/layered_encode.py`` (``layered_encode`` / ``layered_decode``),
but compute what the JAX package's core path computes
(``core/layered.py`` with ``Gaussian.step_shifted``), in its compiled
order, which the reference pins its kernel to
(``tests/test_kernels.py::test_layered_kernel_matches_core``):

    r(v)   = sqrt(max(-2 log(clip(v * f32(s sqrt(2 pi)), 1e-37, 1)), 0))
    encode: step = fma(r(W), s, r(peak - W) * s)
            m = floor(x / step + (u - 1/2) + 1/2)
    decode: bp = r(W) * s, bm = r(peak - W) * s
            y = fma(m - (u - 1/2), bp + bm, 0.5 * (bp - bm))

with XLA's f32 ``log`` (``core/f32.log``).  Inputs are (R, 128) f32 rows
(int32 messages for the decode) on a CUDA device.  Each wrapper checks
its inputs, allocates its output, launches on the current stream,
raises if the launch failed, and adds one to its count in ``LAUNCHES``;
on meta tensors (the dry run) it checks and allocates alike and charges
its bytes to ``kernels.meta`` in place of the launch.  The plain
versions are ``ref.layered_encode_ref`` / ``ref.layered_decode_ref``;
``ops`` picks between the two by device.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.fused_agg import _check, on_card

LANES = 128

# launches of each kernel since the last reset (a plain dict of ints)
LAUNCHES = {"layered_encode": 0, "layered_decode": 0}

_P = ctypes.c_void_p
_F = ctypes.c_float
_TYPED: set = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("layered")
    if id(lib) not in _TYPED:
        for fn in (lib.layered_encode_launch, lib.layered_decode_launch):
            fn.argtypes = [_P, _P, _P, _F, _F, _F, ctypes.c_longlong, _P, _P]
            fn.restype = ctypes.c_int
        _TYPED.add(id(lib))
    return lib


def _constants(sigma: float):
    """(s, c, peak) as the kernels take them: f32(sigma), the folded f32
    product f32(sigma) * f32(sqrt(2 pi)), and f32(peak)."""
    s = np.float32(sigma)
    c = s * np.float32(math.sqrt(2.0 * math.pi))
    peak = np.float32(1.0 / (sigma * math.sqrt(2.0 * math.pi)))
    return float(s), float(c), float(peak)


def _launch(name: str, a: torch.Tensor, u: torch.Tensor, layer: torch.Tensor,
            sigma: float, a_dtype, out_dtype) -> torch.Tensor:
    on_card(name, a)
    if a.dim() != 2 or a.shape[1] != LANES:
        raise ValueError(f"{name} takes (R, {LANES}) rows, got "
                         f"{tuple(a.shape)}")
    shape = tuple(a.shape)
    _check("input", a, a_dtype, shape, a.device)
    _check("u", u, torch.float32, shape, a.device)
    _check("layer", layer, torch.float32, shape, a.device)
    out = torch.empty(shape, dtype=out_dtype, device=a.device)
    if a.device.type == "meta":  # the dry run: no launch, the cost charged
        meta.charge(name, 0, (a, u, layer), (out,))
        return out
    s, c, peak = _constants(sigma)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        fn = getattr(_lib(), f"{name}_launch")
        err = fn(a.data_ptr(), u.data_ptr(), layer.data_ptr(), s, c, peak,
                 a.numel(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def layered_encode(x: torch.Tensor, u: torch.Tensor, layer: torch.Tensor,
                   sigma: float) -> torch.Tensor:
    """x, u, layer: (R, 128) f32 CUDA -> int32 messages (R, 128)."""
    return _launch("layered_encode", x, u, layer, sigma, torch.float32,
                   torch.int32)


def layered_decode(m: torch.Tensor, u: torch.Tensor, layer: torch.Tensor,
                   sigma: float) -> torch.Tensor:
    """int32 messages + shared (u, layer), (R, 128) CUDA -> f32 (R, 128)."""
    return _launch("layered_decode", m, u, layer, sigma, torch.int32,
                   torch.float32)
