"""Counter-based threefry2x32 keys and draws, bit-compatible with
``jax.random`` in its partitionable form (``jax_threefry_partitionable``).

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
a single key has shape ``(2,)`` and lives on the CPU (deriving it costs a
few hundred scalar ops), while batched per-lane keys live wherever the
lanes do.  torch has no full uint32 arithmetic, so every word is kept in
int64 and reduced with ``& 0xFFFFFFFF`` after each add and shift.

The partitionable layout hashes the flat element index ``i`` as the
counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and returns ``out0 ^ out1``,
so any slice ``[start, start + count)`` of a draw is computable on its
own: bulk draws are made chunk by chunk, bounding peak memory at the
chunk's int64 temporaries whatever the full size.

``normal`` and ``laplace`` go through XLA's own f32 ``erfinv`` polynomial,
``log1p`` and ``sqrt`` (``core/f32``), so they match jax bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import f32
from repro_torch.core.f32 import fma

__all__ = [
    "PRNGKey", "fold_in", "split", "random_bits", "uniform", "bernoulli",
    "randint", "normal", "laplace", "erfinv", "CHUNK",
]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements per chunk of a bulk draw: ~1 GiB of int64 temporaries
CHUNK = 1 << 24

Key = torch.Tensor
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under the
    key (k0, k1).  All operands are int64 tensors (or python ints) of
    uint32 values, broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """Key of a 32-bit integer seed, as ``jax.random.PRNGKey``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64)


def fold_in(key: Key, data: int) -> Key:
    """Key derived from ``key`` and an integer: hash of counter (0, data)."""
    k0, k1 = key.unbind(-1)
    o0, o1 = threefry2x32(k0, k1, 0, int(data) & M32)
    return torch.stack([o0, o1], dim=-1)


def split(key: Key, num: int = 2) -> Key:
    """``num`` child keys of each key: (..., 2) -> (..., num, 2)."""
    k0, k1 = key.unsqueeze(-2).unbind(-1)
    j = torch.arange(num, dtype=torch.int64, device=k0.device)
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(j), j)
    return torch.stack([o0, o1], dim=-1)


def split_range(key: Key, start: int, count: int, device) -> Key:
    """Children ``[start, start + count)`` of ``split(key, num)`` for any
    num > start + count, computed on ``device``: (count, 2)."""
    i = torch.arange(start, start + count, dtype=torch.int64, device=device)
    k0, k1 = (int(v) for v in key.tolist())
    o0, o1 = threefry2x32(k0, k1, i >> 32, i & M32)
    return torch.stack([o0, o1], dim=-1)


def _bits_range(key: Key, start: int, count: int, device) -> torch.Tensor:
    """Elements ``[start, start + count)`` of the flat 32-bit draw of a
    single key, as int64."""
    i = torch.arange(start, start + count, dtype=torch.int64, device=device)
    k0, k1 = (int(v) for v in key.tolist())
    o0, o1 = threefry2x32(k0, k1, i >> 32, i & M32)
    return o0 ^ o1


def _lane_bits(keys: Key) -> torch.Tensor:
    """One 32-bit draw of shape () per lane key: keys (..., 2) -> (...)."""
    o0, o1 = threefry2x32(keys[..., 0], keys[..., 1], 0, 0)
    return o0 ^ o1


def random_bits(key: Key, shape: Shape = (), device=None) -> torch.Tensor:
    """uint32 draws (as int64) of ``shape``: a single key gives the flat
    partitionable draw; batched keys (..., 2) with ``shape=()`` give one
    draw per key."""
    shape = _shape(shape)
    if key.dim() > 1:
        if shape:
            raise ValueError("batched keys draw shape () only")
        return _lane_bits(key)
    device = key.device if device is None else torch.device(device)
    n = math.prod(shape)
    return _bits_range(key, 0, n, device).reshape(shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): mantissa fill of 1.0, minus one."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def _scale(unit: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """jax's ``max(lo, u * (hi - lo) + lo)`` with f32 lo, hi; XLA
    contracts the multiply-add."""
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(np.float32(hi - lo))
    if math.frexp(span)[0] == 0.5:
        # a power-of-two span scales exactly: one rounding either way
        out = unit * span + float(lo)
    else:
        out = fma(unit, span, float(lo))
    return torch.clamp_min(out, float(lo))


def uniform(key: Key, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, device=None,
            out: Optional[torch.Tensor] = None,
            start: int = 0) -> torch.Tensor:
    """f32 U[minval, maxval) draws, bitwise equal to ``jax.random.uniform``.
    A single key is drawn in chunks of ``CHUNK`` into ``out`` (allocated
    on ``device`` when not given): elements ``[start, start + size)`` of
    its flat draw, so a larger draw can be made piece by piece; batched
    keys give one draw each."""
    shape = _shape(shape)
    if key.dim() > 1:
        return _scale(_bits_to_unit(random_bits(key, shape)), minval, maxval)
    if out is None:
        device = key.device if device is None else torch.device(device)
        out = torch.empty(shape, dtype=torch.float32, device=device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), CHUNK):
        count = min(CHUNK, flat.numel() - lo)
        # repro-lint: disable=rng-key-reuse -- each chunk hashes its own
        # disjoint counter range of the one draw
        bits = _bits_range(key, start + lo, count, flat.device)
        flat[lo:lo + count] = _scale(_bits_to_unit(bits), minval, maxval)
    return out


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """a * b mod 2^32 for uint32 values a (int64 tensor) and b (int), as
    uint32 arithmetic wraps, without leaving int64: a is split into
    16-bit halves so no partial product reaches 2^63."""
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (hi + (a & 0xFFFF) * b) & M32


def randint(key: Key, shape: Shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """int32 draws in [minval, maxval), bitwise equal to
    ``jax.random.randint`` with its default int32 dtype.  As jax does
    (``_randint``): two 32-bit draws per value from ``split(key)``, the
    span's multiplier m = (2^16 mod span)^2 mod span, and ((hi mod span) m
    + lo mod span) mod span in wrapping uint32 arithmetic, added to
    minval; span 1 where maxval <= minval.  (The square wraps too: for
    spans past 2^16 jax's multiplier is 0, and so is this one.)"""
    shape = _shape(shape)
    info = np.iinfo(np.int32)
    lo_v = min(max(int(minval), info.min), info.max)
    hi_v = min(max(int(maxval), info.min), info.max)
    span = (hi_v - lo_v) & M32 if hi_v > lo_v else 1
    k1, k2 = split(key).unbind(0)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span  # wraps to 0 for span > 2^16
    off = ((_mul32(hi % span, mult) + lo % span) & M32) % span
    # int32 addition wraps as XLA's
    out = ((off + lo_v + 2 ** 31) & M32) - 2 ** 31
    return out.to(torch.int32)


def bernoulli(key: Key, p: float = 0.5, shape: Shape = (),
              device=None) -> torch.Tensor:
    """bool draws, bitwise equal to ``jax.random.bernoulli``: U[0, 1) < p
    in f32."""
    return uniform(key, shape, device=device) < float(np.float32(p))


# Giles' single-precision erfinv, in XLA's coefficient order (Horner from
# the highest power, each step one fused multiply-add), so the polynomial
# rounds as the reference's does.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """f32 inverse error function (Giles 2010), as XLA evaluates it."""
    w = -f32.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, f32.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = fma(p, w, torch.where(small, cs, cl))
    y = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, y)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(math.sqrt(2.0)))
_LAPLACE_LO = float(np.float32(-1.0) + np.finfo(np.float32).epsneg)


def normal(key: Key, shape: Shape = (), device=None) -> torch.Tensor:
    """f32 standard normal: sqrt(2) * erfinv(U(nextafter(-1, 0), 1))."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, device=device)
    return erfinv(u) * _SQRT2_F32


def laplace(key: Key, shape: Shape = (), device=None) -> torch.Tensor:
    """f32 standard Laplace: sign(u) * log1p(-|u|), u ~ U(-1 + eps, 1)."""
    u = uniform(key, shape, _LAPLACE_LO, 1.0, device=device)
    return torch.sign(u) * f32.log1p(-u.abs())
