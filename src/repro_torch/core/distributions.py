"""Unimodal symmetric target noise distributions for AINQ mechanisms.

Every distribution here is symmetric around 0 with a unimodal pdf f_Z.
The layered quantizers (``repro_torch.core.layered``) need, besides
pdf / sampling:

  * ``peak``      -- Zbar = f_Z(0) = max f_Z
  * ``b_plus(v)`` -- positive edge of the superlevel set
                     {x : f_Z(x) >= v} for v in (0, peak]

which have closed forms for Gaussian and Laplace targets.

The arithmetic is the JAX package's as XLA compiles it (``core/f32``):
its ``exp``, ``log`` and ``sqrt``; a division by a python float is a
multiply by the f32 reciprocal; consecutive multiplies by python floats
fold into one multiply by their f32 product; and where a multiply feeds
an add XLA rounds once.  ``b_plus(v)`` is ``k * root(v)`` for a python
constant ``k``, so the layer geometry is written in terms of ``_root``:
``step_shifted`` is ``fma(k, root(w), k * root(peak - w))``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import f32, prng
from repro_torch.core.f32 import fma

__all__ = [
    "Unimodal",
    "Gaussian",
    "Laplace",
    "layer_sample_direct",
    "layer_sample_shifted",
]

_LOG2 = math.log(2.0)
_SQRT_2PI = math.sqrt(2.0 * math.pi)
_SQRT2 = math.sqrt(2.0)


def _c(v: float) -> float:
    """A python float as the f32 constant XLA uses."""
    return float(np.float32(v))


def _cmul(a: float, b: float) -> float:
    """The f32 product XLA folds two constant multipliers into."""
    return float(np.float32(a) * np.float32(b))


@dataclasses.dataclass(frozen=True)
class Unimodal:
    """Base class: symmetric unimodal distribution centered at 0."""

    def pdf(self, x):
        raise NotImplementedError

    @property
    def peak(self) -> float:
        """Zbar = f_Z(0)."""
        raise NotImplementedError

    @property
    def _k(self) -> float:
        """The constant factor of ``b_plus``: b_plus(v) = k * _root(v)."""
        raise NotImplementedError

    def _root(self, v):
        raise NotImplementedError

    def b_plus(self, v):
        """sup{x : f_Z(x) >= v} for 0 < v <= peak."""
        return self._root(v) * self._k

    def sample(self, key, shape=(), device=None, start=0):
        """Draws ``[start, start + size)`` of the flat draw of ``key``."""
        raise NotImplementedError

    def _pdf_of_sample(self, key, shape, device, start):
        """pdf(sample(key)), as XLA compiles the composition."""
        return self.pdf(self.sample(key, shape, device=device, start=start))

    @property
    def variance(self) -> float:
        raise NotImplementedError

    @property
    def mean_abs(self) -> float:
        """E|Z|."""
        raise NotImplementedError

    @property
    def std(self) -> float:
        return math.sqrt(self.variance)

    # --- layered-quantizer geometry (symmetric case) -------------------
    def step_direct(self, d):
        """Quantization step for the direct layered quantizer: lambda(L_d)
        = 2 b+(d), the two constants folded into one multiply."""
        return self._root(d) * _cmul(2.0, self._k)

    def offset_direct(self, d):
        """Interval midpoint (0 by symmetry)."""
        return torch.zeros_like(d)

    def step_shifted(self, w):
        """f_W(w) = b+(w) + b+(Zbar - w)  (symmetric b-(x) = -b+(x));
        XLA contracts the first product into the sum."""
        k = _c(self._k)
        return fma(self._root(w), k, self._root(self.peak - w) * k)

    def offset_shifted(self, w):
        """Interval midpoint (b+(w) - b+(Zbar - w)) / 2; XLA contracts the
        first product into the difference."""
        k = _c(self._k)
        return 0.5 * fma(self._root(w), k, -(self._root(self.peak - w) * k))

    def step_offset_shifted(self, w):
        """(step, offset) of a shifted layer when both are computed from
        the same b+ values, as the decode does (each b+ then has two
        users, so XLA contracts neither into the sum)."""
        bp, bm = self.b_plus(w), self.b_plus(self.peak - w)
        return bp + bm, 0.5 * (bp - bm)

    @property
    def min_step_shifted(self) -> float:
        """eta_Z = min f_W > 0 (Prop. 2). Overridden with closed forms."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Gaussian(Unimodal):
    sigma: float = 1.0

    def pdf(self, x):
        s = self.sigma
        z = f32.rcp_mul(x, s)
        return f32.rcp_mul(f32.exp(-0.5 * (z * z)), s * _SQRT_2PI)

    @property
    def peak(self) -> float:
        return 1.0 / (self.sigma * math.sqrt(2.0 * math.pi))

    @property
    def _k(self) -> float:
        return self.sigma

    def _root(self, v):
        # f(x) = v  =>  x = sigma * sqrt(-2 ln(v sigma sqrt(2 pi)))
        t = torch.clamp(v * _cmul(self.sigma, _SQRT_2PI), 1e-37, 1.0)
        return f32.sqrt(torch.clamp_min(-2.0 * f32.log(t), 0.0))

    def _erfinv(self, key, shape, device, start):
        u = prng.uniform(key, shape, prng._NORMAL_LO, 1.0, device=device,
                         start=start)
        return prng.erfinv(u)

    def sample(self, key, shape=(), device=None, start=0):
        # sigma * (sqrt(2) * erfinv(u)): the two constants fold into one
        return self._erfinv(key, shape, device, start) * _cmul(self.sigma,
                                                               _SQRT2)

    def _pdf_of_sample(self, key, shape, device, start):
        # z / sigma = erfinv(u) * f32(f32(sigma sqrt 2) * f32(1 / sigma)):
        # XLA folds the sampler's constant into the pdf's reciprocal
        z = self._erfinv(key, shape, device, start) * _cmul(
            _cmul(self.sigma, _SQRT2), f32.rcp(self.sigma))
        return f32.rcp_mul(f32.exp(-0.5 * (z * z)), self.sigma * _SQRT_2PI)

    @property
    def variance(self) -> float:
        return self.sigma**2

    @property
    def mean_abs(self) -> float:
        return self.sigma * math.sqrt(2.0 / math.pi)

    @property
    def min_step_shifted(self) -> float:
        # eta = 2 sigma sqrt(ln 4)   (Prop. 2)
        return 2.0 * self.sigma * math.sqrt(math.log(4.0))


@dataclasses.dataclass(frozen=True)
class Laplace(Unimodal):
    scale: float = 1.0  # b; std = b*sqrt(2)

    @classmethod
    def from_std(cls, sigma: float) -> "Laplace":
        return cls(scale=sigma / math.sqrt(2.0))

    def pdf(self, x):
        b = self.scale
        return f32.rcp_mul(f32.exp(f32.rcp_mul(-x.abs(), b)), 2.0 * b)

    @property
    def peak(self) -> float:
        return 1.0 / (2.0 * self.scale)

    @property
    def _k(self) -> float:
        return -self.scale

    def _root(self, v):
        # f(x) = v  =>  x = -b ln(2 b v)
        return f32.log(torch.clamp(v * (2.0 * self.scale), 1e-37, 1.0))

    def sample(self, key, shape=(), device=None, start=0):
        u = prng.uniform(key, shape, prng._LAPLACE_LO, 1.0, device=device,
                         start=start)
        return torch.sign(u) * f32.log1p(-u.abs()) * _c(self.scale)

    @property
    def variance(self) -> float:
        return 2.0 * self.scale**2

    @property
    def mean_abs(self) -> float:
        return self.scale

    @property
    def min_step_shifted(self) -> float:
        # eta = sigma sqrt(2) ln2 = 2 b ln 2   (Prop. 2, b = sigma/sqrt(2))
        return 2.0 * self.scale * _LOG2


def layer_sample_direct(dist: Unimodal, key, shape=(), device=None,
                        start=0):
    """Sample D ~ f_D where f_D(v) = lambda(L_v(f_Z)) = 2 b+(v).

    (Z, V) uniform under the graph of f_Z  =>  marginal of V is f_D.
    ``start`` selects elements [start, start + size) of the flat draw.
    """
    kz, ku = prng.split(key)
    pdf = dist._pdf_of_sample(kz, shape, device, start)
    return prng.uniform(ku, shape, device=device, start=start) * pdf


def layer_sample_shifted(dist: Unimodal, key, shape=(), device=None,
                         start=0):
    """Sample W ~ f_W where f_W(v) = b+(v) + b+(Zbar - v).

    Mixture of the direct-layer height V (density 2 b+(v), weight 1/2)
    and its reflection Zbar - V (weight 1/2).
    """
    kd, kf = prng.split(key)
    v = layer_sample_direct(dist, kd, shape, device=device, start=start)
    flip = prng.uniform(kf, shape, device=device, start=start) < 0.5
    return torch.where(flip, dist.peak - v, v)
