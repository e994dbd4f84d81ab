"""Unified mean-estimation API over all AINQ mechanisms + registry.

Every mechanism implements ``run(key, xs) -> (y, bits_per_coord)`` where
``xs`` is the (n_clients, d) client data and ``y`` estimates the mean
with the mechanism's exact error law.  This is the benchmark- and
test-facing API; the FL round uses the message-level codec
(``repro_torch.runtime.protocol``).  Estimators run on the device given
to ``get_mechanism`` (CUDA unless "cpu" is asked for).

Table 1 of the paper, as code:

  mechanism            homomorphic  gaussian  renyi-DP  fixed-length
  individual-direct    no           yes       yes       no
  individual-shifted   no           yes       yes       yes
  irwin-hall           yes          no        no        yes
  aggregate-gaussian   yes          yes       yes       no
  aggregate-laplace    yes          no        no        no
  sigm                 no           yes       yes       yes
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import coding, prng
from repro_torch.core.aggregate import AggregateGaussianMechanism
from repro_torch.core.distributions import Gaussian, Laplace, Unimodal
from repro_torch.core.f32 import rcp_mul
from repro_torch.core.irwin_hall import IrwinHallMechanism
from repro_torch.core.layered import LayeredQuantizer
from repro_torch.core.sigm import SIGM

__all__ = ["MeanEstimator", "get_mechanism", "MECHANISMS"]


def _mean_bits(ms: torch.Tensor) -> float:
    """Mean Elias-gamma length of the messages: the reference's f32 sum
    (exact here) times f32(1 / size), as XLA compiles ``jnp.mean``."""
    return coding.mean_of_total(coding.elias_gamma_total(ms), ms.numel())


class MeanEstimator:
    name = "base"
    homomorphic = False
    exact_gaussian = False
    fixed_length = False

    def run(self, key, xs):
        raise NotImplementedError


def _on(xs: torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(xs).to(device=device, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class NoCompression(MeanEstimator):
    """Uncompressed mean + optional server-side Gaussian noise
    (the classical Gaussian mechanism, Eq. (3))."""

    sigma: float = 0.0
    device: str = "cuda"
    name = "none"
    homomorphic = True
    exact_gaussian = True

    def run(self, key, xs):
        xs = _on(xs, self.device)
        y = rcp_mul(xs.sum(0), xs.shape[0])
        if self.sigma > 0:
            y = y + prng.normal(key, y.shape, device=y.device) * self.sigma
        return y, 32.0


@dataclasses.dataclass(frozen=True)
class IndividualLayered(MeanEstimator):
    """Individual AINQ mechanism (Def. 2) from a layered point-to-point
    quantizer.  Per-client noise N(0, n sigma^2) averages to N(0, sigma^2)
    (Gaussian is n-divisible; Laplace only supports n=1)."""

    n: int
    sigma: float
    shifted: bool = False
    family: str = "gaussian"
    device: str = "cuda"

    @property
    def name(self):
        kind = "shifted" if self.shifted else "direct"
        return f"individual_{self.family}_{kind}"

    homomorphic = False
    exact_gaussian = True

    @property
    def fixed_length(self):
        return self.shifted

    @property
    def quantizer(self) -> LayeredQuantizer:
        per_client_std = self.sigma * math.sqrt(self.n)
        if self.family == "gaussian":
            dist: Unimodal = Gaussian(per_client_std)
        elif self.family == "laplace":
            if self.n != 1:
                raise ValueError(
                    "Laplace noise is not n-divisible (paper Sec. 2)")
            dist = Laplace.from_std(per_client_std)
        else:
            raise ValueError(self.family)
        return LayeredQuantizer(dist, shifted=self.shifted)

    def run(self, key, xs):
        xs = _on(xs, self.device)
        n = xs.shape[0]
        if n != self.n:
            raise ValueError(f"xs has {n} clients, mechanism takes {self.n}")
        q = self.quantizer
        keys = prng.split(key, n)
        total = torch.zeros(xs.shape[1:], dtype=torch.float32,
                            device=xs.device)
        bits = 0
        for i in range(n):
            # repro-lint: disable=rng-key-reuse -- keys[i] is client i's
            # own split key: one quantizer call per client
            y, m, _ = q(keys[i], xs[i])
            total += y
            bits += coding.elias_gamma_total(m)
        return rcp_mul(total, n), coding.mean_of_total(bits, xs.numel())


@dataclasses.dataclass(frozen=True)
class IrwinHallEstimator(MeanEstimator):
    n: int
    sigma: float
    device: str = "cuda"
    name = "irwin_hall"
    homomorphic = True
    exact_gaussian = False
    fixed_length = True

    def run(self, key, xs):
        xs = _on(xs, self.device)
        mech = IrwinHallMechanism(self.n, self.sigma)
        keys = prng.split(key, self.n)
        # repro-lint: disable=rng-key-reuse -- keys[i] is client i's own
        # split key: one dither draw per client
        ss = torch.stack([mech.client_randomness(keys[i], xs.shape[1:],
                                                 device=xs.device)
                          for i in range(self.n)])
        ms = torch.stack([mech.encode(xs[i], ss[i]) for i in range(self.n)])
        y = mech.decode_sum(ms.sum(0, dtype=torch.int32), ss.sum(0))
        return y, _mean_bits(ms)


@dataclasses.dataclass(frozen=True)
class AggregateGaussianEstimator(MeanEstimator):
    n: int
    sigma: float
    per_coord: bool = True
    family: str = "gaussian"
    device: str = "cuda"
    homomorphic = True
    fixed_length = False

    @property
    def name(self):
        return f"aggregate_{self.family}"

    @property
    def exact_gaussian(self):
        return self.family == "gaussian"

    def run(self, key, xs):
        xs = _on(xs, self.device)
        mech = AggregateGaussianMechanism(self.n, self.sigma, self.per_coord,
                                          family=self.family)
        kt, ks = prng.split(key)
        t_range = float(np.float32(2.0) * np.float32(xs.abs().max().item()))
        a_min = float(np.float32(t_range * self.n)
                      / np.float32(mech.w * float(2**30)))
        t = mech.global_randomness(kt, xs.shape[1:], a_min=a_min,
                                   device=xs.device)
        keys = prng.split(ks, self.n)
        # repro-lint: disable=rng-key-reuse -- keys[i] is client i's own
        # split key: one dither draw per client
        ss = torch.stack([mech.client_randomness(keys[i], xs.shape[1:],
                                                 device=xs.device)
                          for i in range(self.n)])
        ms = torch.stack([mech.encode(xs[i], ss[i], t)
                          for i in range(self.n)])
        y = mech.decode_sum(ms.sum(0, dtype=torch.int32), ss.sum(0), t)
        return y, _mean_bits(ms)


@dataclasses.dataclass(frozen=True)
class SigmEstimator(MeanEstimator):
    n: int
    sigma: float
    gamma: float = 1.0
    device: str = "cuda"
    name = "sigm"
    homomorphic = False
    exact_gaussian = True
    fixed_length = True

    def run(self, key, xs):
        xs = _on(xs, self.device)
        mech = SIGM(self.n, self.sigma, self.gamma)
        shared = mech.shared_randomness(key, xs.shape[1:], device=xs.device)
        ms = torch.stack([mech.encode(xs[i], shared, i)
                          for i in range(self.n)])
        y = mech.decode(ms, shared)
        sent = torch.where(shared.select, coding.elias_gamma_bits(ms), 0)
        bits = float(np.float32(int(sent.sum(dtype=torch.int64)))
                     / np.float32(self.n * xs.shape[1]))
        return y, bits


MECHANISMS: Dict[str, Callable[..., MeanEstimator]] = {
    "none": lambda n, sigma, **kw: NoCompression(sigma=sigma, **kw),
    "individual_direct": lambda n, sigma, **kw: IndividualLayered(
        n, sigma, shifted=False, **kw
    ),
    "individual_shifted": lambda n, sigma, **kw: IndividualLayered(
        n, sigma, shifted=True, **kw
    ),
    "irwin_hall": lambda n, sigma, **kw: IrwinHallEstimator(n, sigma, **kw),
    "aggregate_gaussian": lambda n, sigma, **kw: AggregateGaussianEstimator(
        n, sigma, **kw
    ),
    "aggregate_laplace": lambda n, sigma, **kw: AggregateGaussianEstimator(
        n, sigma, family="laplace", **kw
    ),
    "sigm": lambda n, sigma, **kw: SigmEstimator(n, sigma, **kw),
}


def get_mechanism(name: str, n: int, sigma: float, *, device=None,
                  **kw) -> MeanEstimator:
    """The estimator ``name`` for ``n`` clients at aggregate std
    ``sigma``, running on ``device`` (CUDA unless "cpu" is asked for)."""
    if name not in MECHANISMS:
        raise KeyError(
            f"unknown mechanism {name!r}; have {sorted(MECHANISMS)}")
    return MECHANISMS[name](n=n, sigma=sigma,
                            device=str(resolve_device(device)), **kw)
