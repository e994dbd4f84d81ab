"""SIGM: Subsampled Individual Gaussian Mechanism (paper Sec. 5.1, Alg. 5).

Coordinate-wise Bernoulli subsampling + shifted layered quantizer whose
*quantization error is the DP noise* ("compression for free"):

  shared:  B_i(j) ~ Bern(gamma);   ntilde(j) = sum_i B_i(j)
           S_i(.,j) for the shifted layered quantizer targeting
           N(0, (sigma * gamma * n)^2)
  client:  M_i(j) = Enc(x_i(j) * sqrt(ntilde(j)), S_i(.,j))   if B_i(j)=1
  server:  Y(j) = (gamma n sqrt(ntilde(j)))^{-1}
                    sum_{i: B_i(j)=1} Dec(M_i(j), S_i(.,j))

Then  Y - (gamma n)^{-1} sum_{i:B_i=1} x_i  ~  N(0, sigma^2) exactly
(Appendix A.6).  Coordinates with ntilde(j) = 0 receive fresh
N(0, sigma^2) noise so the AINQ property holds unconditionally.
Not homomorphic (Table 1), but fixed-length (shifted quantizer), so each
client's encode and decode run through the layered kernels on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import f32, prng
from repro_torch.core.distributions import Gaussian
from repro_torch.core.layered import LayeredQuantizer

__all__ = ["SIGM", "SigmShared"]


class SigmShared(NamedTuple):
    select: torch.Tensor  # (n, *shape) bool — B_i(j)
    ntilde: torch.Tensor  # (*shape,) int32 — per-coordinate selected count
    u: torch.Tensor  # (n, *shape) — dither U(0,1)
    layer: torch.Tensor  # (n, *shape) — shifted-layer heights W
    fresh: torch.Tensor  # (*shape,) — N(0,1) for ntilde == 0 coords


@dataclasses.dataclass(frozen=True)
class SIGM:
    n: int
    sigma: float
    gamma: float = 1.0

    homomorphic = False
    exact_gaussian = True
    name = "sigm"

    @property
    def quantizer(self) -> LayeredQuantizer:
        return LayeredQuantizer(
            Gaussian(self.sigma * self.gamma * self.n), shifted=True
        )

    def shared_randomness(self, key, shape=(), device=None) -> SigmShared:
        shape = tuple(shape)
        kb, kq, kf = prng.split(key, 3).unbind(0)
        select = prng.bernoulli(kb, self.gamma, (self.n,) + shape,
                                device=device)
        ntilde = select.sum(dim=0, dtype=torch.int32)
        u, layer = self.quantizer.randomness(kq, (self.n,) + shape,
                                             device=device)
        fresh = prng.normal(kf, shape, device=device)
        return SigmShared(select, ntilde, u, layer, fresh)

    def _sqrt_nt(self, shared: SigmShared) -> torch.Tensor:
        return f32.sqrt(torch.clamp_min(shared.ntilde, 1).to(torch.float32))

    def encode(self, x_i, shared: SigmShared, i: int) -> torch.Tensor:
        """M_i; zeros where client i is not selected for a coordinate."""
        scaled = x_i * self._sqrt_nt(shared)
        m = self.quantizer.encode(scaled, (shared.u[i], shared.layer[i]))
        return torch.where(shared.select[i], m, 0)

    def decode(self, msgs, shared: SigmShared) -> torch.Tensor:
        """msgs: (n, *shape) stacked descriptions -> mean estimate Y.
        Clients are decoded one at a time and summed in order."""
        q = self.quantizer
        total = torch.zeros(msgs.shape[1:], dtype=torch.float32,
                            device=msgs.device)
        for i in range(self.n):
            dec = q.decode(msgs[i], (shared.u[i], shared.layer[i]))
            total += torch.where(shared.select[i], dec, 0.0)
        y = total / (self._sqrt_nt(shared) * float(self.gamma * self.n))
        empty = shared.ntilde == 0
        return torch.where(empty, shared.fresh * self.sigma, y)

    # --- accounting ------------------------------------------------------
    def bits_per_client(self, c: float) -> float:
        """Expected fixed-length bits/coordinate-block: only ~gamma*d coords
        sent, each with |Supp M| <= 2 + t/(2 sigma_q sqrt(ln 4)),
        t = 2 c sqrt(ntilde) ~ 2 c sqrt(gamma n)  (Prop. 4 proof)."""
        sig_q = self.sigma * self.gamma * self.n
        t = 2.0 * c * math.sqrt(max(self.gamma * self.n, 1.0))
        supp = 2.0 + t / (2.0 * sig_q * math.sqrt(math.log(4.0)))
        return self.gamma * math.log2(supp)
