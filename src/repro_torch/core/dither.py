"""Subtractive dithered quantization (paper Example 1).

For step size w > 0 and shared randomness S ~ U(-1/2, 1/2):

    M = round(X / w + S)            (round = floor(. + 1/2), paper notation)
    Y = (M - S) * w

Then Y - X ~ U(-w/2, w/2), independent of X — the building block of every
mechanism in this library.  Operations keep the reference's left-to-right
f32 order so messages match it bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.f32 import rcp_fma_div, true_div

__all__ = ["round_half_up", "dither_noise", "dither_encode", "dither_decode"]


def round_half_up(x: torch.Tensor) -> torch.Tensor:
    """Paper's round-to-nearest: floor(x + 1/2)."""
    return torch.floor(x + 0.5)


def dither_noise(key, shape=(), device=None, out=None) -> torch.Tensor:
    """S ~ U(-1/2, 1/2), drawn in chunks on ``device``."""
    return prng.uniform(key, shape, -0.5, 0.5, device=device, out=out)


def dither_encode(x, w, s, *, msg_dtype=torch.int32) -> torch.Tensor:
    """M = round(x / w + s). ``w`` may be a scalar or broadcastable tensor.
    A scalar step is a compile-time constant in the reference, which XLA
    divides by as ``fma(x, 1/w, s)``; a tensor step divides exactly."""
    if isinstance(w, torch.Tensor):
        q = true_div(x, w) + s
    else:
        q = rcp_fma_div(x, w, s)
    return round_half_up(q).to(msg_dtype)


def dither_decode(m, w, s) -> torch.Tensor:
    """Y = (M - s) * w."""
    return (m.to(torch.float32) - s.to(torch.float32)) * w
