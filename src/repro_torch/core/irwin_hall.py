"""Irwin-Hall distributions and the Irwin-Hall mechanism (paper Sec. 4.2).

IH(n, 0, sigma^2) is the law of (1/n) sum_i Z_i with
Z_i ~iid~ U(-sigma sqrt(3n), sigma sqrt(3n)).  The pdf of the normalized
Irwin-Hall X = (B_n - n/2)/n on [-1/2, 1/2] comes from inverting its
characteristic function phi(t) = sinc(t/(2n))^n with an FFT on a dense
float64 host grid, one time per n (a copy of the JAX package's grid, so
both packages build identical tables).

Mechanism (homomorphic):   w = 2 sigma sqrt(3n)
    M_i = round(x_i / w + S_i),   Y = (w/n) (sum_i M_i - sum_i S_i)
    Y - mean(x)  ~  IH(n, 0, sigma^2).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core import dither
from repro_torch.core.packing import PackGeometry, geometry_for_range

__all__ = ["NormalizedIrwinHall", "IrwinHallMechanism"]


@functools.lru_cache(maxsize=64)
def _normalized_pdf_grid(n: int, grid_half: int = 4096):
    """float64 grids (xs in [0, 1/2], f(xs), f'(xs)) of the normalized IH."""
    assert n >= 1
    if n == 1:  # U(-1/2, 1/2)
        xs = np.linspace(0.0, 0.5, grid_half + 1)
        return xs, np.ones_like(xs), np.zeros_like(xs)
    if n == 2:  # triangle on [-1/2, 1/2], peak 2
        xs = np.linspace(0.0, 0.5, grid_half + 1)
        return xs, 2.0 * (1.0 - 2.0 * xs), np.full_like(xs, -4.0)
    # n >= 3: Fourier series with period 1 (support is exactly [-1/2, 1/2]
    # and f(+-1/2) = 0, so no aliasing); the tail of |phi(2 pi k)| is
    # bounded by (n/(pi k))^n, and K is picked so it stays below 1e-11.
    target = 1e-11
    ratio = n / math.pi
    log_k = (n * math.log(ratio) - math.log(target * (n - 1))) / (n - 1)
    K = int(min(2**20, max(64, math.exp(min(log_k, 15.0)))))
    nfft = 1
    while nfft < 4 * K or nfft < 4 * grid_half:
        nfft *= 2
    k = np.arange(1, K + 1, dtype=np.float64)
    u = math.pi * k / n  # t/(2n) with t = 2 pi k
    phi = np.exp(n * (np.log(np.abs(np.sin(u) / u) + 1e-300)))
    phi *= np.sign(np.sin(u) / u) ** n
    coef = np.zeros(nfft, dtype=np.complex128)
    coef[0] = 1.0
    coef[1 : K + 1] = phi
    coef[nfft - K :] = phi[::-1]  # conjugate-symmetric (phi real, even)
    dense = np.fft.ifft(coef).real * nfft  # f(j/nfft), periodised
    dense_xs = np.arange(nfft) / nfft
    half = dense_xs <= 0.5 + 1e-12
    dxs, dfs = dense_xs[half], np.maximum(dense[half], 0.0)
    ddf = np.gradient(dfs, dxs)
    xs = np.linspace(0.0, 0.5, grid_half + 1)
    fs = np.interp(xs, dxs, dfs)
    dfsi = np.interp(xs, dxs, ddf)
    fs[-1] = 0.0
    return xs, fs, dfsi


class NormalizedIrwinHall:
    """Normalized Irwin-Hall: (B_n - n/2)/n on [-1/2, 1/2], as float64
    host grids (the members the DECOMPOSE tables are built from)."""

    def __init__(self, n: int):
        self.n = int(n)
        self._xs64, self._fs64, self._dfs64 = _normalized_pdf_grid(self.n)
        self.unit_scale = math.sqrt(12.0 * self.n)  # X_unit = scale * X_norm


class IrwinHallMechanism:
    """Homomorphic aggregate AINQ mechanism with noise IH(n, 0, sigma^2)."""

    homomorphic = True
    name = "irwin_hall"

    def __init__(self, n: int, sigma: float):
        self.n = int(n)
        self.sigma = float(sigma)
        self.w = 2.0 * sigma * math.sqrt(3.0 * n)

    def client_randomness(self, key, shape=(), device=None):
        """S_i ~ U(-1/2, 1/2) per coordinate."""
        return dither.dither_noise(key, shape, device=device)

    def encode(self, x_i, s_i):
        return dither.dither_encode(x_i, self.w, s_i)

    def decode_sum(self, m_sum, s_sum):
        """Y from the *aggregated* descriptions (homomorphic decode)."""
        return (m_sum.to(torch.float32) - s_sum) * (self.w / self.n)

    def bits_fixed(self, t: float) -> int:
        """Fixed-length bits per coordinate for |x_i| <= t/2."""
        supp = 2.0 + t / self.w
        return max(1, math.ceil(math.log2(supp + 1)))

    def pack_geometry(self, clip: float) -> PackGeometry:
        """Packed geometry at the natural message range:
        |m| <= ceil(clip/w) + 1 for |x| <= clip."""
        m_max = math.ceil(clip / self.w) + 1
        return geometry_for_range(m_max, self.n)
