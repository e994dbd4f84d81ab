"""Bit accounting (paper Sec. 5.2): Elias gamma code lengths of signed
messages under the zigzag map, as the unpacked decode reports them."""
from __future__ import annotations

import torch

__all__ = ["zigzag", "elias_gamma_bits"]


def zigzag(m: torch.Tensor) -> torch.Tensor:
    """Signed -> positive ints: 0,-1,1,-2,2,... -> 1,2,3,4,5..."""
    return torch.where(m >= 0, 2 * m + 1, -2 * m)


def elias_gamma_bits(m: torch.Tensor) -> torch.Tensor:
    """Elias gamma code length of signed m (zigzag-mapped): 2 floor(log2 k)+1."""
    k = zigzag(m).to(torch.float32)
    return 2 * torch.floor(torch.log2(k)).to(torch.int32) + 1
