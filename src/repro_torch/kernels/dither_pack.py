"""Wrappers of the CUDA kernels in ``csrc/dither_pack.cu``: signed
subtractive-dither quantize + bit-pack, and unpack + decode.

They replace the Pallas TPU kernels of the JAX package's
``kernels/dither_pack.py`` (``dither_pack`` / ``unpack_decode``):

    m      = clip(floor(fma(x, f32(1/w), s) + 1/2), -2^(b-1), 2^(b-1) - 1)
    word_c = OR_j (m[j, c] & mask) << (b * j)          G = 32 // b
    m_j    = (word << (32 - b (j + 1))) >> (32 - b)     (sign-extend)
    y      = (m - s) * f32(w)

Inputs are (R, G, 128) f32 rows and (R, 128) int32 words on a CUDA
device, b in {4, 8, 16}.  Each wrapper checks its inputs, allocates its
output, launches on the current stream, raises if the launch failed, and
adds one to its count in ``LAUNCHES``; on meta tensors (the dry run) it
checks and allocates alike and charges its bytes to ``kernels.meta`` in
place of the launch.  The plain versions are
``ref.dither_pack_ref`` / ``ref.unpack_decode_ref``; ``ops`` picks
between the two by device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.fused_agg import _check, on_card

LANES = 128

# launches of each kernel since the last reset (a plain dict of ints)
LAUNCHES = {"dither_pack": 0, "unpack_decode": 0}

_P = ctypes.c_void_p
_TYPED: set = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("dither_pack")
    if id(lib) not in _TYPED:
        for fn in (lib.dither_pack_launch, lib.unpack_decode_launch):
            fn.argtypes = [_P, _P, ctypes.c_float, ctypes.c_longlong,
                           ctypes.c_int, _P, _P]
            fn.restype = ctypes.c_int
        _TYPED.add(id(lib))
    return lib


def _group(bits: int) -> int:
    if bits not in (4, 8, 16):
        raise ValueError(
            f"signed packing takes bits in (4, 8, 16), got {bits}")
    return 32 // bits


def dither_pack(x: torch.Tensor, s: torch.Tensor, w: float,
                bits: int) -> torch.Tensor:
    """x, s: (R, G, 128) f32 CUDA with G = 32 // bits -> packed int32
    words (R, 128)."""
    g = _group(bits)
    on_card("dither_pack", x)
    R = x.shape[0]
    shape = (R, g, LANES)
    _check("x", x, torch.float32, shape, x.device)
    _check("s", s, torch.float32, shape, x.device)
    out = torch.empty((R, LANES), dtype=torch.int32, device=x.device)
    if x.device.type == "meta":  # the dry run: no launch, the cost charged
        meta.charge("dither_pack", 0, (x, s), (out,))
        return out
    # the reference multiplies by the python float 1.0 / w, cast to f32
    inv_w = float(np.float32(1.0 / w))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().dither_pack_launch(x.data_ptr(), s.data_ptr(), inv_w, R,
                                        bits, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dither_pack launch failed: CUDA error {err}")
    LAUNCHES["dither_pack"] += 1
    return out


def unpack_decode(word: torch.Tensor, s: torch.Tensor, w: float,
                  bits: int) -> torch.Tensor:
    """Packed int32 words (R, 128) + dither s (R, G, 128) -> f32
    (R, G, 128)."""
    g = _group(bits)
    on_card("unpack_decode", word)
    R = word.shape[0]
    shape = (R, g, LANES)
    _check("word", word, torch.int32, (R, LANES), word.device)
    _check("s", s, torch.float32, shape, word.device)
    out = torch.empty(shape, dtype=torch.float32, device=word.device)
    if word.device.type == "meta":
        meta.charge("unpack_decode", 0, (word, s), (out,))
        return out
    with torch.cuda.device(word.device):
        stream = torch.cuda.current_stream(word.device).cuda_stream
        err = _lib().unpack_decode_launch(word.data_ptr(), s.data_ptr(),
                                          float(np.float32(w)), R, bits,
                                          out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"unpack_decode launch failed: CUDA error {err}")
    LAUNCHES["unpack_decode"] += 1
    return out
