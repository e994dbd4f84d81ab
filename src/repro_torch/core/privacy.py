"""Differential-privacy accounting (paper Sec. 2 App. 1, Sec. 5, Prop. 4).

AINQ mechanisms with exactly-Gaussian error inherit the Gaussian
mechanism's guarantees verbatim — that is the point of the paper: no
separate compression error to account for.
"""
from __future__ import annotations

import math

__all__ = [
    "gaussian_sigma",
    "gaussian_epsilon",
    "renyi_gaussian",
    "rdp_to_dp",
    "sigm_sigma",
]


def gaussian_sigma(eps: float, delta: float, sensitivity: float = 1.0) -> float:
    """Classic calibration (Dwork et al. 2014):
    sigma^2 >= 2 Delta_2^2 ln(1.25/delta) / eps^2."""
    return sensitivity * math.sqrt(2.0 * math.log(1.25 / delta)) / eps


def gaussian_epsilon(sigma: float, delta: float, sensitivity: float = 1.0) -> float:
    """Inverse of gaussian_sigma."""
    return sensitivity * math.sqrt(2.0 * math.log(1.25 / delta)) / sigma


def renyi_gaussian(alpha: float, sigma: float, sensitivity: float = 1.0) -> float:
    """Renyi-DP of the Gaussian mechanism: eps(alpha) = alpha Delta^2/(2 sigma^2)
    (Mironov 2017)."""
    return alpha * sensitivity**2 / (2.0 * sigma**2)


def rdp_to_dp(sigma: float, delta: float, sensitivity: float = 1.0) -> float:
    """(eps, delta)-DP from RDP, optimizing over alpha:
    eps = min_alpha [ alpha Delta^2/(2 sigma^2) + log(1/delta)/(alpha-1) ]."""
    best = float("inf")
    for i in range(1, 10_000):
        alpha = 1.0 + i / 100.0
        eps = renyi_gaussian(alpha, sigma, sensitivity) + math.log(1.0 / delta) / (
            alpha - 1.0
        )
        best = min(best, eps)
    return best


def sigm_sigma(
    eps: float, delta: float, c: float, n: int, gamma: float, d: int
) -> float:
    """Noise level for SIGM, Prop. 4 (via Chen et al. 2023 Thm 4.1):
    sigma^2 = Theta( c^2 ln(1/delta)/(n gamma)^2
                     + c^2 d (ln(d/delta)+eps) ln(d/delta) / (n eps)^2 ).

    We use unit constants for both SIGM and the CSGM baseline so the
    comparison (Fig. 5) is calibration-fair.
    """
    t1 = c**2 * math.log(1.0 / delta) / (n * gamma) ** 2
    t2 = c**2 * d * (math.log(d / delta) + eps) * math.log(d / delta) / (n * eps) ** 2
    return math.sqrt(t1 + t2)
