"""Bit accounting and entropy coding (paper Sec. 3.2, 4.5, 5.2).

* Elias gamma code lengths (the paper's choice for variable-length codes
  in Sec. 5.2) of signed messages under the zigzag map, as the unpacked
  decode reports them.
* The exact conditional entropy H(M|S) of a dithered quantizer with
  uniform input X ~ U(0, t): closed form per (step, u), Monte-Carlo over
  S (Fig. 2 and the Prop. 1 / Eq. (5) bound checks).
* Fixed-length code sizes and Huffman code lengths.
"""
from __future__ import annotations

import heapq
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import f32, prng

__all__ = [
    "zigzag",
    "elias_gamma_bits",
    "elias_gamma_total",
    "mean_of_total",
    "fixed_bits",
    "dither_conditional_entropy",
    "layered_entropy_mc",
    "h_layer_direct",
    "h_layer_shifted",
    "huffman_lengths",
    "huffman_expected_bits",
]


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


def fixed_bits(support_size: float) -> int:
    return max(1, math.ceil(math.log2(max(support_size, 2.0))))


def dither_conditional_entropy(step, u, t: float) -> torch.Tensor:
    """H(M | S=(u, layer)) in bits for M = floor(X/step + u), X ~ U(0, t),
    in f32.  Closed form: interior cells have mass step/t; the two
    boundary cells (1-u)*step/t and t - (m_last - u)*step.  ``step`` / ``u``
    may be tensors (one value per Monte-Carlo draw of S)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    u = torch.as_tensor(u, dtype=torch.float32)
    m_last = torch.floor(t / step + u)
    p_first = torch.clamp((1.0 - u) * step / t, 0.0, 1.0)
    p_last = torch.clamp((t - (m_last - u) * step) / t, 0.0, 1.0)
    n_interior = torch.clamp_min(m_last - 1.0, 0.0)
    p_int = step / t

    def ent(p):
        return torch.where(p > 0.0, -p * torch.log2(torch.clamp_min(p, 1e-30)),
                           0.0)

    # when step >= t the whole mass may sit in <= 2 cells: n_interior = 0
    # and p_first + p_last = 1
    h = ent(p_first) + ent(p_last) + n_interior * ent(p_int)
    return torch.where(m_last == 0.0, 0.0, h)


def layered_entropy_mc(quantizer, t: float, key, num_samples: int = 20000,
                       device=None) -> float:
    """Monte-Carlo E_S[H(M|S)] for a LayeredQuantizer with X ~ U(0, t),
    on the card unless ``device="cpu"``."""
    u, layer = quantizer.randomness(key, (num_samples,),
                                    device=resolve_device(device))
    step, _ = quantizer.step_offset(layer)
    return float(torch.mean(dither_conditional_entropy(step, u, t)))


def _b_plus64(dist, vs: np.ndarray) -> np.ndarray:
    """f64 numpy evaluation of the superlevel edge (the f32 clips of the
    codec path would destroy the entropy integrands)."""
    from repro_torch.core.distributions import Gaussian, Laplace

    if isinstance(dist, Gaussian):
        s = dist.sigma
        arg = -2.0 * np.log(np.clip(vs * s * math.sqrt(2 * math.pi), 1e-300,
                                    1.0))
        return s * np.sqrt(np.maximum(arg, 0.0))
    if isinstance(dist, Laplace):
        b = dist.scale
        return -b * np.log(np.clip(2.0 * b * vs, 1e-300, 1.0))
    raise TypeError(type(dist))


def h_layer_direct(dist, num_grid: int = 200_001) -> float:
    """h(D_Z), the differential entropy of the direct-layer height density
    f_D(v) = 2 b+(v) on (0, peak): the paper's 'layered entropy' term."""
    vs = np.linspace(1e-12, dist.peak * (1 - 1e-12), num_grid)
    fd = np.maximum(2.0 * _b_plus64(dist, vs), 1e-300)
    return float(np.trapezoid(-fd * np.log2(fd), vs))


def h_layer_shifted(dist, num_grid: int = 200_001) -> float:
    """h(W_Z) for the shifted-layer density f_W(v) = b+(v) + b+(peak - v)."""
    vs = np.linspace(1e-12, dist.peak * (1 - 1e-12), num_grid)
    b = _b_plus64(dist, vs)
    fw = np.maximum(b + b[::-1], 1e-300)
    return float(np.trapezoid(-fw * np.log2(fw), vs))


def huffman_lengths(probs) -> np.ndarray:
    """Optimal prefix-code lengths for a discrete distribution (paper Sec.
    3.2: Huffman on p_{M|S}); the expected length satisfies
    H(p) <= E[len] < H(p) + 1."""
    p = np.asarray(probs, np.float64)
    idx = np.flatnonzero(p > 0)
    if len(idx) == 1:
        out = np.zeros_like(p)
        out[idx] = 1.0
        return out
    heap = [(float(p[i]), int(i), None) for i in idx]
    heapq.heapify(heap)
    parents = {}
    counter = len(p)
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        parents[a[1]] = counter
        parents[b[1]] = counter
        heapq.heappush(heap, (a[0] + b[0], counter, None))
        counter += 1
    lengths = np.zeros_like(p)
    for i in idx:
        depth, node = 0, int(i)
        while node in parents:
            node = parents[node]
            depth += 1
        lengths[i] = depth
    return lengths


def huffman_expected_bits(m_samples) -> float:
    """Expected Huffman code length of an empirical message sample."""
    if isinstance(m_samples, torch.Tensor):
        m_samples = m_samples.cpu().numpy()
    _, counts = np.unique(np.asarray(m_samples), return_counts=True)
    p = counts / counts.sum()
    return float((p * huffman_lengths(p)).sum())
