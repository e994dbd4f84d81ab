"""Direct and shifted layered quantizers (paper Definitions 4 and 5).

Both are point-to-point AINQ mechanisms: the error Y - X follows the
target unimodal distribution f_Z exactly, independent of X.  They are
subtractive dithering with a *random* step size:

  * direct  (Def. 4): step = f_D(D) = lambda(L_D(f_Z)), D ~ f_D.
    Error | D  ~  U over the superlevel interval  =>  marginal = f_Z.
    Near-optimal variable-length cost (Eq. 5) but step can be ~0.

  * shifted (Def. 5, Wilson's layered multishift coupling):
    step = f_W(W) = b+(W) + b+(Zbar - W), W ~ f_W, with a per-layer
    offset.  Step is bounded below by eta_Z > 0 (Prop. 2)  =>  supports
    fixed-length codes:  |Supp M| <= 2 + t / eta_Z.

Shared randomness S = (U, D-or-W) is derived per coordinate from a PRNG
key (clients and server hold the same key = shared seed).

A Gaussian shifted quantizer encodes and decodes through
``kernels.ops.layered_encode`` / ``layered_decode``: the CUDA kernels on
the card, their plain versions on the CPU.  Direct and Laplace
quantizers are plain PyTorch on both devices, as they are plain jnp in
the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.distributions import (
    Gaussian,
    Unimodal,
    layer_sample_direct,
    layer_sample_shifted,
)
from repro_torch.core.f32 import fma, true_div
from repro_torch.kernels import ops

__all__ = ["LayeredQuantizer", "layered_randomness", "layered_encode",
           "layered_decode"]


@dataclasses.dataclass(frozen=True)
class LayeredQuantizer:
    """Point-to-point AINQ quantizer with exact error distribution.

    Attributes:
      dist:    target error distribution (symmetric unimodal).
      shifted: False -> direct layered (Def. 4); True -> shifted (Def. 5).
    """

    dist: Unimodal
    shifted: bool = False

    @property
    def _kernel_sigma(self):
        """sigma of a Gaussian shifted quantizer (the kernels' case)."""
        if self.shifted and isinstance(self.dist, Gaussian):
            return self.dist.sigma
        return None

    # -- shared randomness ------------------------------------------------
    def randomness(self, key, shape=(), device=None):
        """S = (U, layer): U ~ U(0,1); layer ~ f_D or f_W, per coordinate.
        The layer is drawn ``prng.CHUNK`` coordinates at a time (each
        chunk of a partitionable draw is computable on its own), so its
        temporaries stay bounded at any size."""
        shape = tuple(shape)
        device = key.device if device is None else torch.device(device)
        ku, kl = prng.split(key)
        u = prng.uniform(ku, shape, device=device)
        sample = layer_sample_shifted if self.shifted else layer_sample_direct
        layer = torch.empty(shape, dtype=torch.float32, device=device)
        flat = layer.view(-1)
        for start in range(0, flat.numel(), prng.CHUNK):
            count = min(prng.CHUNK, flat.numel() - start)
            # repro-lint: disable=rng-key-reuse -- each chunk draws its own
            # disjoint range [start, start + count) of the one layer draw
            flat[start:start + count] = sample(self.dist, kl, (count,),
                                               device=device, start=start)
        return u, layer

    def step_offset(self, layer):
        if self.shifted:
            return self.dist.step_offset_shifted(layer)
        return self.dist.step_direct(layer), self.dist.offset_direct(layer)

    # -- encode / decode ---------------------------------------------------
    def encode(self, x, rand: Tuple) -> torch.Tensor:
        """M = floor(x / step + (U - 1/2) + 1/2), int32."""
        u, layer = rand
        if self._kernel_sigma is not None:
            return ops.layered_encode(x, u, layer, self._kernel_sigma)
        step = (self.dist.step_shifted(layer) if self.shifted
                else self.dist.step_direct(layer))
        q = true_div(x, step) + (u - 0.5)
        return torch.floor(q + 0.5).to(torch.int32)

    def decode(self, m, rand: Tuple) -> torch.Tensor:
        """Y = (M - (U - 1/2)) * step + offset, one rounding for the
        multiply-add."""
        u, layer = rand
        if self._kernel_sigma is not None:
            return ops.layered_decode(m, u, layer, self._kernel_sigma)
        step, offset = self.step_offset(layer)
        return fma(m.to(torch.float32) - (u - 0.5), step, offset)

    def __call__(self, key, x):
        """Compress x: returns (y, m, rand) with y - x ~ dist exactly."""
        rand = self.randomness(key, tuple(x.shape), device=x.device)
        m = self.encode(x, rand)
        return self.decode(m, rand), m, rand

    # -- fixed-length support (shifted only) --------------------------------
    def support_size(self, t: float) -> int:
        """|Supp M| bound for inputs in an interval of length t (Prop. 2)."""
        if not self.shifted:
            raise ValueError("direct layered quantizer has unbounded support")
        return int(math.floor(2.0 + t / self.dist.min_step_shifted))

    def fixed_bits(self, t: float) -> int:
        return max(1, math.ceil(math.log2(self.support_size(t))))


# Functional aliases.
def layered_randomness(dist, shifted, key, shape, device=None):
    return LayeredQuantizer(dist, shifted).randomness(key, shape,
                                                      device=device)


def layered_encode(dist, shifted, x, rand):
    return LayeredQuantizer(dist, shifted).encode(x, rand)


def layered_decode(dist, shifted, m, rand):
    return LayeredQuantizer(dist, shifted).decode(m, rand)
