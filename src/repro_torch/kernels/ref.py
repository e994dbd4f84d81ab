"""Plain PyTorch versions of the CUDA kernels, in the op order of the
JAX package's oracles: the CPU path of ``ops`` and the yardstick the
kernels are held to on the card.

Scalar steps divide through ``true_div``, correctly rounded on every
device, as the kernels divide."""
from __future__ import annotations

import torch

from repro_torch.core.f32 import true_div


def fused_encode_ref(x, s, step, bits: int, m_max: int) -> torch.Tensor:
    """clip -> dither-quantize -> bias -> unsigned-pack.  x, s (and a
    tensor ``step``) are (..., G, C) with G = 32 // bits; returns packed
    int32 words (..., C)."""
    g = max(32 // bits, 1)
    m = torch.clamp(torch.floor(true_div(x, step) + s + 0.5),
                    -m_max, m_max)
    u = m.to(torch.int32) + m_max
    word = torch.zeros(u.shape[:-2] + u.shape[-1:], dtype=torch.int32,
                       device=u.device)
    for j in range(g):
        word |= u[..., j, :] << (bits * j)
    return word


def unpack_biased_ref(word, bits: int) -> torch.Tensor:
    """Unsigned-field unpack of (summed) biased words: (..., C) ->
    (..., G, C) int32 field sums."""
    g = max(32 // bits, 1)
    mask = (1 << bits) - 1
    return torch.stack([(word >> (bits * j)) & mask for j in range(g)],
                       dim=-2)


def fused_decode_ref(word, s_eff, step, offset, bits: int) -> torch.Tensor:
    """unpack + subtract the effective dither (dither_sum + r * m_max) +
    rescale [+ offset]."""
    u = unpack_biased_ref(word, bits).to(torch.float32)
    y = (u - s_eff) * step
    return y if offset is None else y + offset
