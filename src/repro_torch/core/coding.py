"""Bit accounting (paper Sec. 5.2): Elias gamma code lengths of signed
messages under the zigzag map, as the unpacked decode reports them."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import f32, prng

__all__ = ["zigzag", "elias_gamma_bits", "elias_gamma_total",
           "mean_of_total"]


def zigzag(m: torch.Tensor) -> torch.Tensor:
    """Signed -> positive ints: 0,-1,1,-2,2,... -> 1,2,3,4,5..."""
    return torch.where(m >= 0, 2 * m + 1, -2 * m)


def elias_gamma_bits(m: torch.Tensor) -> torch.Tensor:
    """Elias gamma code length of signed m (zigzag-mapped): 2 floor(log2 k)+1,
    with the reference's f32 log2 (which reads 2^j as just below j at some
    powers of two)."""
    k = zigzag(m).to(torch.float32)
    return 2 * torch.floor(f32.log2(k)).to(torch.int32) + 1


def elias_gamma_total(m: torch.Tensor) -> int:
    """Total Elias gamma bits of the messages ``m``, summed exactly (int64)
    over chunks of ``prng.CHUNK`` elements, so a full model's messages
    need no full-size (f64) temporaries."""
    flat, step = m.reshape(-1), prng.CHUNK
    return sum(int(elias_gamma_bits(flat[i:i + step]).sum(dtype=torch.int64))
               for i in range(0, flat.numel(), step))


def mean_of_total(total: int, size: int) -> float:
    """``jnp.mean`` of ``size`` lengths summing to ``total``, as XLA
    compiles it: f32(total) * f32(1 / size)."""
    return float(np.float32(total) * (np.float32(1.0) / np.float32(size)))
