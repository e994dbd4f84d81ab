"""True-bit-width packing geometry for the homomorphic mechanisms.

The cross-client collective for the aggregate mechanisms carries
integer dither messages; the paper's communication claim (Fig. 4) is
bits per coordinate, so the wire should carry the code width
``b = ceil(log2(range))`` — not one int32 word per coordinate.

The packing that keeps the collective homomorphic stores each message
as an UNSIGNED, BIASED b-bit field inside an int32 word:

    u_i = m_i + m_max                in [0, 2 m_max]
    word = sum_j u[j] << (b * j)     G = 32 // b fields per word

With per-field sums bounded by ``n * 2 m_max <= 2^b - 1``, adding the
packed words of n clients never carries across a field boundary, so

    psum(word)  ==  pack(sum_i u_i)      (bit-exact)

and one unpack of the summed word recovers ``sum_i m_i + r * m_max``
(r = number of summed messages).  Two's-complement int32 addition is
exact mod 2^32, so a top field touching bit 31 is still recovered
exactly by masked shifts.

``PackGeometry`` is the single source of truth for (b, m_max, n):
mechanisms derive it (``IrwinHallMechanism.pack_geometry``) or accept a
configured width (``AggregateGaussianMechanism.pack_geometry``), and
both the fused CUDA kernels and the unfused path clamp to the same
``m_max`` so the two paths encode identical messages.

A copy of the JAX package's ``core/packing.py``: the port depends on
nothing of that package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

__all__ = ["PackGeometry", "geometry_for_bits", "geometry_for_range"]


class PackGeometry(NamedTuple):
    """Field width / clamp range of a packed homomorphic collective.

    bits:  unsigned field width b (1..32).
    m_max: per-client signed messages are clamped to [-m_max, m_max].
    n:     max number of messages summed into one field.
    """

    bits: int
    m_max: int
    n: int

    @property
    def bias(self) -> int:
        """Unsigned bias added per message before packing."""
        return self.m_max

    @property
    def group(self) -> int:
        """Fields per int32 word (32 // bits, >= 1)."""
        return max(32 // self.bits, 1)

    def n_words(self, size: int) -> int:
        """int32 words on the wire for ``size`` coordinates (unpadded)."""
        return -(-size // self.group)

    def payload_bytes(self, size: int) -> int:
        """Wire bytes for ``size`` coordinates."""
        return 4 * self.n_words(size)


def geometry_for_bits(bits: int, n: int) -> PackGeometry:
    """Geometry for a configured field width: the largest symmetric
    clamp whose n-fold sum of biased fields stays below 2^bits."""
    if not 2 <= bits <= 32:
        raise ValueError(f"field width must be in [2, 32], got {bits}")
    n = max(int(n), 1)
    m_max = ((1 << bits) - 1) // (2 * n)
    if m_max < 2:
        raise ValueError(
            f"{bits}-bit fields cannot hold {n} summed messages "
            f"(per-client range would be +-{m_max}); use wider fields "
            f"or fewer clients"
        )
    return PackGeometry(bits=bits, m_max=m_max, n=n)


def geometry_for_range(m_max: int, n: int) -> PackGeometry:
    """Geometry for a mechanism-derived message range: the smallest
    field width whose n-fold biased sum fits, b = ceil(log2(range))."""
    m_max = max(int(m_max), 1)
    n = max(int(n), 1)
    bits = max(2, math.ceil(math.log2(2 * m_max * n + 1)))
    if bits > 32:
        raise ValueError(
            f"summed message range +-{m_max} x {n} needs {bits} > 32 bits"
        )
    return PackGeometry(bits=bits, m_max=m_max, n=n)
