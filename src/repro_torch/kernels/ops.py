"""Public wrappers of the kernels: shape padding and layout, so callers
pass natural shapes.

  * ``fused_pack_encode`` / ``fused_unpack_decode``: the homomorphic
    biased-field codec (``fused_agg``);
  * ``dither_pack_encode`` / ``dither_unpack_decode``: the signed
    quantize-and-pack codec (``dither_pack``);
  * ``layered_encode`` / ``layered_decode``: the Gaussian shifted layered
    quantizer (``layered_encode``);
  * ``flash_attention``: block online-softmax attention
    (``flash_attention``);
  * ``wkv6``: the RWKV-6 time recurrence (``wkv6``).

Dispatch follows the tensors' device: a CPU tensor runs the plain
PyTorch version (``ref``), a CUDA tensor the hand-written kernel, which
raises if it cannot launch.  There is no fallback between the two.  A
meta tensor (the dry run, ``launch.dryrun``) goes to the kernel's
wrapper, which checks and allocates as on the card and charges the
kernel's cost (``kernels.meta``) in place of the launch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import dither_pack as dp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_agg as fg
from repro_torch.kernels import layered_encode as le
from repro_torch.kernels import ref
from repro_torch.kernels import wkv6 as wk

LANES = 128


def _pad_rows(x: torch.Tensor, g: int, value: float = 0.0) -> torch.Tensor:
    """Flatten to (R, g, 128) rows, padding with ``value`` (steps pad
    with 1.0 so padded lanes never divide by zero).  A view when no
    padding is needed."""
    row = g * LANES
    R = -(-x.numel() // row)
    pad = R * row - x.numel()
    flat = x.reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), value)])
    return flat.reshape(R, g, LANES)


def _kernel_path(t: torch.Tensor) -> bool:
    """True for the kernel's wrapper (a CUDA tensor, or a meta one), False
    for the plain version (a CPU tensor); other devices raise."""
    if t.device.type in ("cuda", "meta"):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _is_scalar(step) -> bool:
    return isinstance(step, (int, float))


def _full(t, shape) -> torch.Tensor:
    """``t`` broadcast to ``shape`` as a contiguous tensor."""
    return t.expand(shape).contiguous() if tuple(t.shape) != tuple(shape) else t


def fused_pack_encode(x: torch.Tensor, s: torch.Tensor, step, bits: int,
                      m_max: int) -> torch.Tensor:
    """Fused homomorphic encode: dither-quantize ``x`` at ``step`` (python
    scalar, or tensor broadcastable to x.shape for the per-coordinate
    aggregate mechanisms), clamp to [-m_max, m_max], bias, and pack to
    ``bits``-wide unsigned fields -> int32 words (R, 128).  Packed words
    of different clients ADD homomorphically; the caller clips x."""
    # 24-bit cap: biased field sums stay <= 2^24, exactly representable
    # in the f32 decode (wider fields would silently lose low bits)
    if not 2 <= bits <= 24:
        raise ValueError(f"packed field width must be in [2, 24], got {bits}")
    if tuple(s.shape) != tuple(x.shape):
        raise ValueError(f"dither shape {tuple(s.shape)} != {tuple(x.shape)}")
    g = max(32 // bits, 1)
    xr, sr = _pad_rows(x, g), _pad_rows(s, g)
    tr = float(step) if _is_scalar(step) else _pad_rows(
        _full(step, x.shape), g, value=1.0)
    if _kernel_path(x):
        return fg.fused_encode(xr, sr, tr, bits, m_max)
    return ref.fused_encode_ref(xr, sr, tr, bits, m_max)


def fused_unpack_decode(word: torch.Tensor, s_eff: torch.Tensor, step_dec,
                        offset, bits: int, shape) -> torch.Tensor:
    """Fused homomorphic decode of SUMMED packed words back to ``shape``:
    unpack unsigned fields, subtract ``s_eff`` (= dither_sum + r * m_max
    for r summed messages), rescale by ``step_dec`` (mechanism step / n;
    scalar or tensor) and add ``offset`` (B * sigma, or None)."""
    if not 2 <= bits <= 24:
        raise ValueError(f"packed field width must be in [2, 24], got {bits}")
    shape = tuple(shape)
    g = max(32 // bits, 1)
    se = _pad_rows(s_eff, g)
    if word.dim() != 2 or word.shape != (se.shape[0], LANES):
        raise ValueError(f"words {tuple(word.shape)} do not match "
                         f"{se.shape[0]} rows of {LANES}")
    tr = float(step_dec) if _is_scalar(step_dec) else _pad_rows(
        _full(step_dec, s_eff.shape), g, value=1.0)
    off = None if offset is None else _pad_rows(
        _full(offset, s_eff.shape), g)
    if _kernel_path(word):
        y = fg.fused_decode(word, se, tr, off, bits)
    else:
        y = ref.fused_decode_ref(word, se, tr, off, bits)
    return y.reshape(-1)[: math.prod(shape)].reshape(shape)


# ------------------------------------------- signed dither quantize+pack
def _signed_group(bits: int) -> int:
    if bits not in (4, 8, 16):
        raise ValueError(
            f"signed packing takes bits in (4, 8, 16), got {bits}")
    return 32 // bits


def dither_pack_encode(x: torch.Tensor, s: torch.Tensor, w: float,
                       bits: int = 8):
    """Quantize + pack a tensor of any shape -> (int32 words (R, 128),
    numel): m = clip(floor(x / w + s + 1/2)) to the signed ``bits`` range,
    G = 32 // bits fields per word.  ``s`` matches x's shape."""
    g = _signed_group(bits)
    if tuple(s.shape) != tuple(x.shape):
        raise ValueError(f"dither shape {tuple(s.shape)} != {tuple(x.shape)}")
    xr, sr = _pad_rows(x, g), _pad_rows(s, g)
    if _kernel_path(x):
        return dp.dither_pack(xr, sr, float(w), bits), x.numel()
    return ref.dither_pack_ref(xr, sr, float(w), bits), x.numel()


def dither_unpack_decode(word: torch.Tensor, s: torch.Tensor, w: float,
                         bits: int, shape) -> torch.Tensor:
    """Unpack + decode (m - s) * w back to ``shape``."""
    g = _signed_group(bits)
    shape = tuple(shape)
    sr = _pad_rows(s, g)
    if word.dim() != 2 or word.shape != (sr.shape[0], LANES):
        raise ValueError(f"words {tuple(word.shape)} do not match "
                         f"{sr.shape[0]} rows of {LANES}")
    if _kernel_path(word):
        y = dp.unpack_decode(word, sr, float(w), bits)
    else:
        y = ref.unpack_decode_ref(word, sr, float(w), bits)
    return y.reshape(-1)[: math.prod(shape)].reshape(shape)


# ------------------------------------------------- shifted layered codec
def _rows(t: torch.Tensor) -> torch.Tensor:
    """Flatten to (R, 128) rows, zero-padded (a view when no padding)."""
    return _pad_rows(t, 1).reshape(-1, LANES)


def layered_encode(x: torch.Tensor, u: torch.Tensor, layer: torch.Tensor,
                   sigma: float) -> torch.Tensor:
    """Gaussian shifted layered encode of any shape -> int32 messages of
    x's shape: m = floor(x / step + (u - 1/2) + 1/2), step = b+(W) +
    b+(peak - W) for N(0, sigma^2).  Padded lanes hold x = 0 and
    W = 0 (step = the largest, no division by zero)."""
    for name, t in (("u", u), ("layer", layer)):
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(x.shape)}")
    xr, ur, lr = _rows(x), _rows(u), _rows(layer)
    if _kernel_path(x):
        m = le.layered_encode(xr, ur, lr, float(sigma))
    else:
        m = ref.layered_encode_ref(xr, ur, lr, float(sigma))
    return m.reshape(-1)[: x.numel()].reshape(x.shape)


def layered_decode(m: torch.Tensor, u: torch.Tensor, layer: torch.Tensor,
                   sigma: float) -> torch.Tensor:
    """Gaussian shifted layered decode: y = (m - (u - 1/2)) * step +
    offset, one rounding for the multiply-add; f32 of m's shape."""
    for name, t in (("u", u), ("layer", layer)):
        if tuple(t.shape) != tuple(m.shape):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(m.shape)}")
    mr, ur, lr = _rows(m.to(torch.int32)), _rows(u), _rows(layer)
    if _kernel_path(m):
        y = le.layered_decode(mr, ur, lr, float(sigma))
    else:
        y = ref.layered_decode_ref(mr, ur, lr, float(sigma))
    return y.reshape(-1)[: m.numel()].reshape(m.shape)


# ------------------------------------------------------- flash attention
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, *, kv_tile: int,
                    window: int = 0) -> torch.Tensor:
    """q (B, T, H, D), k / v (B, S, HK, D) -> (B, T, H, D) in q's dtype;
    GQA (H % HK == 0), ragged T and S, D in {16, 32, 64, 112, 128}, f32 or
    bf16, differentiable.  The causal mask is the Pallas kernel's: query
    i sees keys 0..i (aligned at the top left, whatever S is); ``window``
    > 0 also masks keys at or before i - window (the JAX model's sliding
    window; causal, T <= S), 0 is none.  Each dtype
    computes one function on both devices: bf16 the JAX model's bf16
    attention (q scaled in bf16, P rounded to bf16 against the running
    max of spans of ``kv_tile`` keys, the model's ``kv_chunk``; the sm90
    kernel or ``ref.flash_attention_bf16_ref``), f32 the Pallas kernel's
    f32 function (the f32 kernel or ``ref.flash_attention_ref``), which
    has no tiling and ignores ``kv_tile``.
    On the card a bf16 span must be a multiple of 128 keys or cover S.
    The gradient is the backward kernel's (``ref.flash_attention_bwd_ref``
    on the CPU), through ``flash_attention.FlashAttention``.  The same
    shapes are refused on both devices."""
    fa.check_shapes(q, k, v)
    fa.check_window(window, causal, q.shape[1], k.shape[1])
    _kernel_path(q)
    return fa.FlashAttention.apply(q, k, v, causal, kv_tile,
                                   0 if window is None else int(window))


# ------------------------------------------------------- rwkv6 recurrence
def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state=None):
    """The RWKV-6 time recurrence (the JAX model's ``_wkv_scan``, and with
    T = 1 and a state its decode step): r, k, v (B, T, H, K) in one dtype,
    w (B, T, H, K) f32 or bf16 (as rounded by the caller's path), u (H, K),
    ``state`` (B, H, K, K) f32 or None (zeros) -> (y (B, T, H, K) f32, the
    final state (B, H, K, K) f32), differentiable.  The ``wkv6`` kernels on
    a CUDA tensor, ``ref.wkv6_ref`` / ``ref.wkv6_bwd_ref`` on a CPU one,
    through ``wkv6.Wkv6``.  The same shapes are refused on both devices."""
    wk.check_shapes(r, k, v, w, u)
    _kernel_path(r)
    return wk.Wkv6.apply(r, k, v, w, u, state)
