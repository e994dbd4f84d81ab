"""Aggregate Q mechanism (paper Def. 8) with Q = Gaussian or Laplace.

Homomorphic AND exactly Q-distributed: global shared randomness T = (A, B)
is drawn by DECOMPOSE, then every client runs subtractive dithering with
step A*w (w = 2 sigma sqrt(3n)); the server decodes the *sum* of the
integer descriptions:

    M_i = round(x_i / (A w) + S_i)
    Y   = (A w / n) (sum_i M_i - sum_i S_i) + B sigma
    Y - mean(x)  ~  Q(0, sigma^2)       (exactly; Prop. 3)

per_coord=True draws one (A, B) per coordinate (i.i.d. noise, required
for DP), in chunks of coordinates so peak memory stays bounded at any d;
per_coord=False draws one pair per tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch import debug
from repro_torch.core import dither, prng
from repro_torch.core.f32 import rcp_mul
from repro_torch.core.decompose import (
    DecomposeTables,
    decompose_gaussian,
    gaussian_tables,
    laplace_tables,
)
from repro_torch.core.packing import PackGeometry, geometry_for_bits

__all__ = ["AggregateGaussianMechanism", "AggGaussShared"]


class AggGaussShared(NamedTuple):
    """Global shared randomness T = (A, B) (scalar or per-coordinate)."""

    A: torch.Tensor
    B: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AggregateGaussianMechanism:
    """Aggregate AINQ mechanism: noise exactly ~ Q with std sigma, for Q
    the target ``family``; only the DECOMPOSE target differs between
    families."""

    n: int
    sigma: float
    per_coord: bool = True
    family: str = "gaussian"  # gaussian | laplace

    homomorphic = True

    def __post_init__(self):
        if self.family not in ("gaussian", "laplace"):
            raise ValueError(f"unknown aggregate family {self.family!r}")

    @property
    def name(self) -> str:
        return f"aggregate_{self.family}"

    @property
    def w(self) -> float:
        return 2.0 * self.sigma * math.sqrt(3.0 * self.n)

    @property
    def tables(self) -> DecomposeTables:
        if self.family == "laplace":
            return laplace_tables(self.n)
        return gaussian_tables(self.n)

    # --- shared randomness -----------------------------------------------
    def global_randomness(self, key, shape=(), *, a_min=0.0,
                          device=None) -> AggGaussShared:
        """T = (A, B) on ``device``, with A clamped from below at
        ``a_min`` (a_min_for_geometry / a_min_for_range): the clamped
        mass P[A < a_min] is the deviation from the exact law in total
        variation."""
        shape = tuple(shape)
        device = key.device if device is None else torch.device(device)
        tables = self.tables
        if self.per_coord and shape:
            flat = math.prod(shape)
            A = torch.empty(flat, dtype=torch.float32, device=device)
            B = torch.empty_like(A)
            for start in range(0, flat, prng.CHUNK):
                count = min(prng.CHUNK, flat - start)
                # repro-lint: disable=rng-key-reuse -- split_range yields
                # the disjoint children [start, start + count) of the key
                lanes = prng.split_range(key, start, count, device)
                A[start:start + count], B[start:start + count] = (
                    decompose_gaussian(tables, lanes))
            A, B = A.reshape(shape), B.reshape(shape)
        else:
            a, b = decompose_gaussian(tables, key.to(device)[None])
            A, B = a.reshape(()).expand(shape), b.reshape(()).expand(shape)
        if debug.active():
            # the exact-error claim degrades by P[A < a_min] in total
            # variation; past this bound the geometry is mis-sized
            debug.check(
                torch.mean((A < a_min).to(torch.float32))
                <= debug.A_CLAMP_MASS_BOUND,
                "global_randomness: A-clamp mass exceeds "
                f"{debug.A_CLAMP_MASS_BOUND} (geometry too narrow for "
                "clip/sigma)")
        return AggGaussShared(torch.clamp_min(A, a_min), B)

    def a_min_for_range(self, t_range, *, msg_bits: int = 30):
        """Smallest safe A for inputs |x_i| <= t_range / 2: keeps the
        *summed* message within a 2^msg_bits budget (int32 sum)."""
        return t_range * self.n / (self.w * float(2**msg_bits))

    # --- packed-collective geometry ---------------------------------------
    def pack_geometry(self, bits: int) -> PackGeometry:
        """``bits``-wide unsigned fields whose n-fold sum cannot carry."""
        return geometry_for_bits(bits, self.n)

    def a_min_for_geometry(self, clip: float, geom: PackGeometry):
        """Smallest A whose messages stay within [-m_max, m_max] for
        |x| <= clip: |m| <= clip/(A w) + 1 <= m_max."""
        return clip / ((geom.m_max - 1) * self.w)

    def client_randomness(self, key, shape=(), device=None):
        """S_i ~ U(-1/2,1/2) per coordinate."""
        return dither.dither_noise(key, shape, device=device)

    # --- encode / decode ---------------------------------------------------
    def encode(self, x_i, s_i, t: AggGaussShared):
        return dither.dither_encode(x_i, t.A * self.w, s_i)

    def decode_sum(self, m_sum, s_sum, t: AggGaussShared):
        step = rcp_mul(t.A * self.w, self.n)
        return (m_sum.to(torch.float32) - s_sum) * step + t.B * self.sigma
