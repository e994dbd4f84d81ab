"""CSGM-style baseline (Chen et al. 2023) for the Fig. 5 comparison.

Coordinate-subsampled Gaussian mechanism: quantization and DP noise are
*separate* — each selected coordinate is b-bit dither-quantized, then
the server adds independent N(0, sigma^2) noise.  SIGM instead folds the
noise into the quantizer; at equal bits SIGM therefore has strictly
smaller MSE (quantization error does not stack on top of DP noise).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["CSGMechanism"]


@dataclasses.dataclass(frozen=True)
class CSGMechanism:
    n: int
    sigma: float  # DP noise std on the mean estimate (same calibration as SIGM)
    gamma: float  # coordinate subsampling rate
    bits: float  # quantization bits per selected coordinate
    clip: float  # per-coordinate bound |x_ij| <= clip

    homomorphic = False
    exact_gaussian = True  # the added noise is Gaussian (on top of quantization)
    name = "csgm"

    def run(self, seed: int, xs: np.ndarray):
        """xs: (n, d) -> (mean estimate, bits/client/coordinate)."""
        rng = np.random.default_rng(seed)
        n, d = xs.shape
        sel = rng.random((n, d)) < self.gamma
        levels = max(2.0, 2.0 ** float(self.bits))
        # scale inputs by sqrt(ntilde) like SIGM so per-coordinate ranges match
        ntilde = np.maximum(sel.sum(axis=0), 1)
        t = 2.0 * self.clip * np.sqrt(ntilde)  # quantizer range per coordinate
        step = t / (levels - 1.0)
        u = rng.random((n, d)) - 0.5
        scaled = xs * np.sqrt(ntilde)
        m = np.floor(scaled / step + u + 0.5)
        dec = (m - u) * step
        total = np.where(sel, dec, 0.0).sum(axis=0)
        y = total / (self.gamma * self.n * np.sqrt(ntilde))
        y = y + self.sigma * rng.standard_normal(d)
        return y, self.gamma * float(self.bits)
