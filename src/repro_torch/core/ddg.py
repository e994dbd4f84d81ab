"""Distributed Discrete Gaussian (DDG) baseline (Kairouz et al. 2021a).

The paper's Sec. 5.2 comparison point: DP-against-the-server via SecAgg
with discrete Gaussian noise.  Pipeline per client:

  clip to c -> randomized Hadamard rotation -> scale 1/g -> stochastic
  round to Z^d -> + discrete Gaussian N_Z(0, (sigma_z/g)^2) -> mod m

Server: sum mod m -> center -> * g -> inverse rotation -> / n.

The discrete Gaussian sampler is Canonne-Kamath-Steinke (2020) Alg. 1
(rejection from a discrete Laplace), vectorized in numpy (host-side:
DDG is a benchmark baseline, not part of the training path).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["discrete_gaussian", "fwht", "DDGMechanism"]


def discrete_gaussian(rng: np.random.Generator, sigma: float, size) -> np.ndarray:
    """Exact discrete Gaussian N_Z(0, sigma^2) via CKS'20 rejection."""
    t = math.floor(sigma) + 1
    p = 1.0 - math.exp(-1.0 / t)
    out = np.zeros(size, dtype=np.int64).ravel()
    pending = np.ones(out.shape, dtype=bool)
    while pending.any():
        k = int(pending.sum())
        g1 = rng.geometric(p, size=k) - 1
        g2 = rng.geometric(p, size=k) - 1
        y = g1 - g2  # discrete Laplace(t)
        acc_p = np.exp(-((np.abs(y) - sigma**2 / t) ** 2) / (2.0 * sigma**2))
        acc = rng.random(k) < acc_p
        idx = np.flatnonzero(pending)
        out[idx[acc]] = y[acc]
        pending[idx[acc]] = False
    return out.reshape(size)


def fwht(x: np.ndarray) -> np.ndarray:
    """Fast Walsh-Hadamard transform over the last axis (power-of-2 dim),
    normalized so the transform is orthonormal."""
    d = x.shape[-1]
    assert d & (d - 1) == 0, "dimension must be a power of 2"
    y = x.astype(np.float64).copy()
    h = 1
    while h < d:
        y = y.reshape(*x.shape[:-1], d // (2 * h), 2, h)
        a, b = y[..., 0, :].copy(), y[..., 1, :].copy()
        y[..., 0, :], y[..., 1, :] = a + b, a - b
        y = y.reshape(*x.shape[:-1], d)
        h *= 2
    return y / math.sqrt(d)


@dataclasses.dataclass(frozen=True)
class DDGMechanism:
    """DDG distributed mean estimation with b-bit modular SecAgg."""

    n: int
    sigma_total: float  # std of the total Gaussian-equivalent noise on Y
    clip: float
    bits: int
    range_sigmas: float = 3.5  # modulus safety: m*g covers +-range_sigmas of the sum

    homomorphic = True
    exact_gaussian = False
    name = "ddg"

    def run(self, seed: int, xs: np.ndarray):
        """xs: (n, d) -> (mean estimate, realized bits/coordinate)."""
        rng = np.random.default_rng(seed)
        n, d0 = xs.shape
        d = 1 << max(1, (d0 - 1).bit_length())  # pad to power of 2
        x = np.zeros((n, d))
        norms = np.linalg.norm(xs, axis=1, keepdims=True)
        x[:, :d0] = xs * np.minimum(1.0, self.clip / np.maximum(norms, 1e-12))
        signs = rng.choice([-1.0, 1.0], size=d)
        rot = fwht(x * signs)
        # the b-bit modulus must cover the SUM of n messages (signal +
        # per-client noise sigma_total*sqrt(n)); this is the fundamental
        # DDG tradeoff: small b forces a coarse granularity g.
        m = 1 << self.bits
        sum_range = 2.0 * self.range_sigmas * (
            math.sqrt(n) * self.clip / math.sqrt(d) + n * self.sigma_total
        )
        g = sum_range / m
        scaled = rot / g
        # unbiased stochastic rounding
        floor = np.floor(scaled)
        rounded = floor + (rng.random(scaled.shape) < (scaled - floor))
        sigma_z = self.sigma_total * math.sqrt(n) / g  # per-client, msg units
        noise = discrete_gaussian(rng, sigma_z, scaled.shape)
        msgs = np.mod(rounded.astype(np.int64) + noise, m)
        # SecAgg: server sees only the modular sum
        total = np.mod(msgs.sum(axis=0), m)
        centered = np.where(total >= m // 2, total - m, total)
        y = fwht((centered * g / n)[None, :])[0] * signs
        return y[:d0], float(self.bits)
