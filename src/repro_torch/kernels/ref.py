"""Plain PyTorch versions of the CUDA kernels, in the op order of the
JAX package's oracles: the CPU path of ``ops`` and the yardstick the
kernels are held to on the card.

A tensor step divides exactly (``true_div``); a python scalar step is
a compile-time constant in the reference, which XLA divides by as
``fma(x, f32(1/step), s)`` (``rcp_fma_div``), and so do the kernels."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributions import Gaussian
from repro_torch.core.f32 import fma, rcp_fma_div, true_div


def fused_encode_ref(x, s, step, bits: int, m_max: int) -> torch.Tensor:
    """clip -> dither-quantize -> bias -> unsigned-pack.  x, s (and a
    tensor ``step``) are (..., G, C) with G = 32 // bits; returns packed
    int32 words (..., C)."""
    g = max(32 // bits, 1)
    q = (true_div(x, step) + s if isinstance(step, torch.Tensor)
         else rcp_fma_div(x, step, s))
    m = torch.clamp(torch.floor(q + 0.5), -m_max, m_max)
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


# ------------------------------------------------- shifted layered codec
def layered_encode_ref(x, u, layer, sigma: float) -> torch.Tensor:
    """Shifted layered encode for a Gaussian target, in the order the JAX
    package's core path compiles to (``core/layered.py`` with
    ``Gaussian.step_shifted``): step = fma(r(W), s, r(peak - W) * s) with
    r(v) = sqrt(max(-2 log(clip(v s sqrt(2 pi), 1e-37, 1)), 0)), then
    m = floor(x / step + (u - 1/2) + 1/2)."""
    step = Gaussian(sigma).step_shifted(layer)
    return torch.floor(true_div(x, step) + (u - 0.5) + 0.5).to(torch.int32)


def layered_decode_ref(m, u, layer, sigma: float) -> torch.Tensor:
    """y = fma(m - (u - 1/2), b+(W) + b+(peak - W),
    (b+(W) - b+(peak - W)) / 2)."""
    step, offset = Gaussian(sigma).step_offset_shifted(layer)
    return fma(m.to(torch.float32) - (u - 0.5), step, offset)


# ------------------------------------------- signed dither quantize+pack
def dither_encode_ref(x, s, w: float, bits: int) -> torch.Tensor:
    """m = floor(x * f32(1/w) + s + 1/2) clamped to the signed ``bits``
    range, int32.  The reference multiplies by ``1.0 / w`` (a python
    float, so f32(1/w) rounded from f64); XLA contracts it with ``+ s``."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    m = torch.floor(fma(x, float(np.float32(1.0 / w)), s) + 0.5)
    return torch.clamp(m, lo, hi).to(torch.int32)


def pack_ref(m, bits: int) -> torch.Tensor:
    """Pack groups of (32 // bits) signed ints into int32 words over the
    second-to-last axis: m (..., G, C) -> (..., C)."""
    g = 32 // bits
    if m.shape[-2] != g:
        raise ValueError(f"pack axis has {m.shape[-2]} fields, need {g}")
    mask = (1 << bits) - 1
    word = torch.zeros(m.shape[:-2] + m.shape[-1:], dtype=torch.int32,
                       device=m.device)
    for j in range(g):
        word |= (m[..., j, :] & mask) << (bits * j)
    return word


def unpack_ref(word, bits: int) -> torch.Tensor:
    """Inverse of pack_ref with sign extension: (..., C) -> (..., G, C)."""
    g = 32 // bits
    return torch.stack([(word << (32 - bits * (j + 1))) >> (32 - bits)
                        for j in range(g)], dim=-2)


def dither_pack_ref(x, s, w: float, bits: int) -> torch.Tensor:
    """x, s (..., G, C) -> packed int32 (..., C)."""
    return pack_ref(dither_encode_ref(x, s, w, bits), bits)


def unpack_decode_ref(word, s, w: float, bits: int) -> torch.Tensor:
    """Packed words + dither -> dequantized values (m - s) * w."""
    return (unpack_ref(word, bits).to(torch.float32) - s) * w


# ------------------------------------------------------- flash attention
NEG_INF = -1e30


def mha_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """q (B, T, H, D), k/v (B, S, H, D) -> (B, T, H, D), f32 softmax; the
    causal mask is aligned at the bottom right (``tril(k=S-T)``), as the
    reference's ``mha_ref``."""
    T, D = q.shape[1], q.shape[3]
    S = k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q, k).to(torch.float32) * (D ** -0.5)
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool, device=q.device).tril(S - T)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)


def _keep(T: int, S: int, k0: int, n: int, causal: bool, window: int,
          device):
    """The (T, n) mask of keys k0 .. k0 + n - 1 the queries see: key j
    for query i where j <= i (causal) and j > i - window (a window > 0,
    the JAX model's ``kpos > q_pos - window``), or None for no mask."""
    if not causal and not window:
        return None
    rows = torch.arange(T, device=device)[:, None]
    cols = torch.arange(k0, k0 + n, device=device)[None, :]
    keep = torch.ones((T, n), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (cols <= rows)
    if window:
        keep = keep & (cols > rows - window)
    return keep


def flash_attention_ref(q, k, v, causal: bool = True,
                        return_lse: bool = False, window: int = 0):
    """What the Pallas flash kernel computes, written plainly: q
    (B, T, H, D), k/v (B, S, HK, D) with H % HK == 0 -> (B, T, H, D) in
    q's dtype.  f32 arithmetic: ``q * D^-1/2`` rounded to f32 before the
    product, scores masked to -1e30 (never -inf) where ``col > row``
    (causal, aligned at the top left: query i sees keys 0..i, whatever
    S is) and, with a ``window`` > 0, where ``col <= row - window``, P kept
    in f32 for P V, and the sum clamped below by 1e-30.
    ``return_lse`` also returns the row statistic m + log(l), (B, H, T)
    f32, as the kernels write it for the backward."""
    B, T, H, D = q.shape
    HK = k.shape[2]
    g = H // HK
    S = k.shape[1]
    q32 = q.to(torch.float32) * (D ** -0.5)
    k32 = k.to(torch.float32).repeat_interleave(g, dim=2)
    v32 = v.to(torch.float32).repeat_interleave(g, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q32, k32)
    keep = _keep(T, S, 0, S, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p, v32)
    o = (o / l.clamp_min(1e-30).permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


def bf16_scale(D: int) -> float:
    """D^-1/2 rounded to bf16: the JAX model's ``q * D**-0.5`` on a bf16
    array takes the Python float as a weakly typed bf16 scalar."""
    return float(torch.tensor(D ** -0.5, dtype=torch.bfloat16))


def scale_q_bf16(q) -> torch.Tensor:
    """bf16(f32(q) * bf16(D^-1/2)), the JAX model's scaled q in bf16 (the
    f32 product of two bf16 values is exact, so this is one rounding)."""
    return (q.to(torch.float32) * bf16_scale(q.shape[-1])).to(torch.bfloat16)


def flash_attention_bf16_ref(q, k, v, causal: bool = True, *,
                             kv_tile: int, return_lse: bool = False,
                             window: int = 0):
    """What the JAX model's attention (``repro.models.attention.
    flash_attention``) computes in bf16, written plainly: q (B, T, H, D),
    k/v (B, S, HK, D) bf16 with H % HK == 0 -> (B, T, H, D) bf16.  q is
    scaled by bf16(D^-1/2) and rounded to bf16; scores are f32 products of
    that and k (f32 einsums, no TF32), masked to -1e30 where ``col > row``
    (causal, aligned at the top left) and, with a ``window`` > 0, where
    ``col <= row - window``; an online softmax over tiles of
    ``kv_tile`` keys (the JAX model's ``kv_chunk``; P is rounded against
    the running max of the tiles seen so far, so the chunking is part of
    the function) keeps m and l in f32, l summing the f32 p; P is rounded
    to bf16 for P V (f32 sums); the output is acc / max(l, 1e-30)
    rounded to bf16.  A chunk wholly outside a row's window adds p = 1
    terms (exp(-1e30 - -1e30)) until the row's first live chunk multiplies
    them by exp(-1e30 - m) = 0, as in the JAX model.
    ``return_lse`` also returns m + log(l), (B, H, T) f32."""
    B, T, H, D = q.shape
    HK = k.shape[2]
    g = H // HK
    S = k.shape[1]
    f32, bf16 = torch.float32, torch.bfloat16
    qs = scale_q_bf16(q).to(f32)
    k32 = k.to(f32).repeat_interleave(g, dim=2)
    v32 = v.to(f32).repeat_interleave(g, dim=2)
    m = torch.full((B, H, T, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, T, 1), dtype=f32, device=q.device)
    acc = torch.zeros((B, H, T, D), dtype=f32, device=q.device)
    kv_tile = int(kv_tile)
    for k0 in range(0, S, kv_tile):
        s = torch.einsum("bthd,bshd->bhts", qs, k32[:, k0:k0 + kv_tile])
        keep = _keep(T, S, k0, s.shape[-1], causal, window, q.device)
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhts,bshd->bhtd", p.to(bf16).to(f32),
                                        v32[:, k0:k0 + kv_tile])
        m = m_new
    o = (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3).to(bf16)
    if return_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


# keys per tile of the plain backward's loop (its result has no tiling)
BWD_KV_TILE = 128


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            kv_tile: int = BWD_KV_TILE, window: int = 0):
    """The gradient of the forward above (bf16 or f32 by q's dtype),
    written plainly with FlashAttention-2's formula, one tile of keys at
    a time: the kernels ``csrc/flash_attention_bwd_sm90.cu`` (bf16) and
    ``csrc/flash_attention_bwd_f32_sm90.cu`` (f32) compute the same.
    q, o, do (B, T, H, D), k, v (B, S, HK, D), lse (B, H, T) f32 (the
    forward's m + log(l)) -> (dq, dk, dv) in the inputs' dtype.  In f32:
    qs = q scaled as the forward scales it (bf16(q bf16(D^-1/2)) in bf16),
    S = qs k^T masked as the forward masks (``window`` the forward's),
    P = exp(S - lse) (0 where masked), Drow = rowsum(do o), dV = P^T do (P rounded to bf16 in bf16,
    as the forward's P V), dS = P (do v^T - Drow), dK = dS^T qs, dQ =
    scale dS k; GQA sums dK and dV over each KV head's query heads."""
    B, T, H, D = q.shape
    S, HK = k.shape[1], k.shape[2]
    g = H // HK
    f32 = torch.float32
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        scale = bf16_scale(D)
        qs = scale_q_bf16(q).to(f32)
    else:
        scale = D ** -0.5
        qs = q.to(f32) * scale
    qs = qs.permute(0, 2, 1, 3)                           # (B, H, T, D)
    do32 = do.to(f32).permute(0, 2, 1, 3)
    drow = (do32 * o.to(f32).permute(0, 2, 1, 3)).sum(-1, keepdim=True)
    k32 = k.to(f32).repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    v32 = v.to(f32).repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    lse_ = lse.to(f32)[..., None]
    dq = torch.zeros_like(qs)
    dk = torch.zeros_like(k32)
    dv = torch.zeros_like(v32)
    for k0 in range(0, S, kv_tile):
        kt, vt = k32[:, :, k0:k0 + kv_tile], v32[:, :, k0:k0 + kv_tile]
        p = torch.exp(qs @ kt.transpose(-1, -2) - lse_)
        keep = _keep(T, S, k0, kt.shape[2], causal, window, q.device)
        if keep is not None:
            p = torch.where(keep, p, 0.0)
        ds = p * (do32 @ vt.transpose(-1, -2) - drow)
        pv = p.to(torch.bfloat16).to(f32) if bf16 else p
        dv[:, :, k0:k0 + kv_tile] = pv.transpose(-1, -2) @ do32
        dk[:, :, k0:k0 + kv_tile] = ds.transpose(-1, -2) @ qs
        dq += ds @ kt
    dq = (dq * scale).permute(0, 2, 1, 3).to(q.dtype)
    dk = dk.reshape(B, HK, g, S, D).sum(2).permute(0, 2, 1, 3).to(k.dtype)
    dv = dv.reshape(B, HK, g, S, D).sum(2).permute(0, 2, 1, 3).to(v.dtype)
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


# ------------------------------------------------------ rwkv6 recurrence
# steps per chunk of the chunked kernels (``csrc/wkv6.cu``), and between
# the states the forward keeps for the backward
WKV_CHUNK = 64
# steps per sub-chunk: the chunked kernels' element-by-element block
WKV_SUB = 16


def wkv6_ref(r, k, v, w, u, state=None, *, dtype=torch.float32,
             return_chunks: bool = False):
    """The RWKV-6 time recurrence of the JAX model's ``_wkv_scan`` (and of
    its one-token decode), one step at a time: r, k, v, w (B, T, H, K) in
    any float dtype (cast to ``dtype``; the caller rounds w as its path
    does), u (H, K), ``state`` (B, H, K, K) or None (zeros).  Per step,
    with S[k, j] the state before it:

        kv = k_t^T v_t;  y_t = r_t (S + diag(u) kv);  S = S diag_rows(w_t) + kv

    each product and sum rounded on its own.  Returns (y (B, T, H, K),
    S_T (B, H, K, K)) in ``dtype``, and with ``return_chunks`` also the
    state before every WKV_CHUNK-th step, (B, H, ceil(T / WKV_CHUNK), K, K)
    (the states the kernel keeps for the backward)."""
    B, T, H, K = r.shape
    r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
    u = u.to(dtype).reshape(1, H, K, 1)
    S = (torch.zeros((B, H, K, K), dtype=dtype, device=r.device)
         if state is None else state.to(dtype))
    ys, chunks = [], []
    for t in range(T):
        if t % WKV_CHUNK == 0:
            chunks.append(S)
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkj->bhj", r[:, t], S + u * kv))
        S = S * w[:, t, :, :, None] + kv
    y = torch.stack(ys, dim=1)
    if return_chunks:
        return y, S, torch.stack(chunks, dim=2)
    return y, S


def wkv6_bwd_ref(r, k, v, w, u, dy, state=None, dstate=None, *,
                 dtype=torch.float32):
    """The gradient of ``wkv6_ref``, walked in reverse time: from dy
    (B, T, H, K) and the final state's gradient ``dstate`` (B, H, K, K)
    or None (zeros) -> (dr, dk, dv, dw (B, T, H, K), du (H, K), dS0
    (B, H, K, K)) in ``dtype``.  Per step, with S the state before it and
    dS the gradient of the state after it:

        a = S + diag(u) kv;  dr = a dy;  da = r^T dy;  dkv = diag(u) da + dS
        dk = dkv v;  dv = dkv^T k;  dw = rowsum(dS * S);  du += rowsum(da * kv)
        dS <- dS diag_rows(w) + da

    (du summed over the batch and the steps).  The states are recomputed
    from ``state`` first (all of them; the kernel recomputes one chunk at
    a time from the forward's chunk states)."""
    B, T, H, K = r.shape
    r, k, v, w, dy = (t.to(dtype) for t in (r, k, v, w, dy))
    u = u.to(dtype).reshape(1, H, K, 1)
    S = (torch.zeros((B, H, K, K), dtype=dtype, device=r.device)
         if state is None else state.to(dtype))
    states = []
    for t in range(T):
        states.append(S)
        S = S * w[:, t, :, :, None] + k[:, t, :, :, None] * v[:, t, :, None, :]
    dS = torch.zeros_like(S) if dstate is None else dstate.to(dtype)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros((B, H, K), dtype=dtype, device=r.device)
    for t in range(T - 1, -1, -1):
        Sp = states[t]
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        dr[:, t] = torch.einsum("bhkj,bhj->bhk", Sp + u * kv, dy[:, t])
        da = r[:, t, :, :, None] * dy[:, t, :, None, :]
        dkv = u * da + dS
        du = du + (da * kv).sum(-1)
        dk[:, t] = torch.einsum("bhkj,bhj->bhk", dkv, v[:, t])
        dv[:, t] = torch.einsum("bhkj,bhk->bhj", dkv, k[:, t])
        dw[:, t] = (dS * Sp).sum(-1)
        dS = dS * w[:, t, :, :, None] + da
    return dr, dk, dv, dw, du.sum(0), dS


# The chunked form of the recurrence, the algorithm of the chunked kernels
# (``csrc/wkv6.cu``), in plain PyTorch: the tests and chip_smoke.py hold
# it against the serial form; no path runs it.  Per chunk of C =
# WKV_CHUNK steps, split into sub-chunks of L = WKV_SUB, with the decay
# factors as products of the w the caller passed (no log, no exp: every
# factor is a product of values in [0, 1], so none overflows, and w = 0
# resets the state as in the serial form):
#   pre_i = prod_{a0 <= m < i} w_m,  suf_j = prod_{j < m <= a1} w_m,
#   tot = prod over the sub-chunk,  D_ij = prod_{j < m < i} w_m (j < i),
# with [a0, a1] the sub-chunk (or chunk) of i and j.  Every sum over
# steps adds its terms from the most decayed to the least, as the serial
# form does (the other order puts the error at 3-4x the serial form's);
# the sums within a sub-chunk are Horner chains over w.  The chunk-level
# stages (each chunk's contribution, its decay and the pass over chunks)
# run in f64 and round each state they keep to f32 once, so the kept
# states are near the correctly rounded ones (in f32 their error from f64
# reached 2.2x the serial form's); the rest is f32, each step rounded as
# the kernels round it: a fused multiply-add (``_fma``) where they take
# one, and P, Q, Bm and rowsum(dS_a * S_a) of the backward summed in f64
# and rounded once.  A ragged last chunk is padded with identity steps (r
# = k = v = dy = 0, w = 1).
def _fma(a, b, c):
    """a b + c rounded once to f32 (the kernels' __fmaf_rn; the product
    of two f32 is exact in f64)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _wkv_blocks(x, value: float):
    """(B, T, H, K) -> (B, H, nc, C, K) f32, the last chunk padded to C
    steps with ``value``."""
    B, T, H, K = x.shape
    C = WKV_CHUNK
    nc = -(-T // C)
    x = torch.nn.functional.pad(x.to(torch.float32),
                                (0, 0, 0, 0, 0, nc * C - T), value=value)
    return x.reshape(B, nc, C, H, K).permute(0, 3, 1, 2, 4)


def _wkv_unblock(x, T: int):
    """(B, H, nc, C, K) -> (B, T, H, K)."""
    B, H, nc, C, K = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(B, nc * C, H, K)[:, :T]


def _wkv_decay(w):
    """Products of w (..., n, K) along n, each a running product:
    (pre, suf, tot), pre_i the product before i, suf_j after j."""
    n = w.shape[-2]
    pre, suf = [torch.ones_like(w[..., 0, :])], [torch.ones_like(
        w[..., 0, :])]
    for i in range(1, n):
        pre.append(pre[-1] * w[..., i - 1, :])
        suf.append(suf[-1] * w[..., n - i, :])
    return (torch.stack(pre, -2), torch.stack(suf[::-1], -2),
            pre[-1] * w[..., n - 1, :])


def _outer_sum(acc, a, b, order):
    """acc + sum_i a_i^T b_i (a, b (..., n, K)), a multiply-add each, in
    ``order``."""
    for i in order:
        acc = _fma(a[..., i, :, None], b[..., i, None, :], acc)
    return acc


def _row_dot(x, M):
    """x M (x (..., n, K), M (..., K, K)) as the kernels sum it: four
    interleaved chains of multiply-adds over K (term k into chain k % 4),
    added as ((c0 + c1) + (c2 + c3))."""
    c = [torch.zeros_like(x) for _ in range(4)]
    for kk in range(x.shape[-1]):
        c[kk % 4] = _fma(x[..., kk, None], M[..., kk, None, :], c[kk % 4])
    return (c[0] + c[1]) + (c[2] + c[3])


def _wkv_A(r, k, w, u):
    """A (..., L, L) of a sub-chunk: A_ij = sum_k r_i k_j D_ij (j < i, D
    a running product from i - 1 down), the bonus A_ii = r_i . (u k_i),
    0 above."""
    L = r.shape[-2]
    A = r.new_zeros(r.shape[:-1] + (L,))
    for i in range(L):
        A[..., i, i] = (r[..., i, :] * (u * k[..., i, :])).sum(-1)
        d = torch.ones_like(w[..., 0, :])
        for j in range(i - 1, -1, -1):
            A[..., i, j] = (r[..., i, :] * k[..., j, :] * d).sum(-1)
            d = d * w[..., j, :]
    return A


def _f64_mm(a, b):
    """a b^T accumulated in f64 (exact products of f32), rounded once to
    f32, as the chunked backward sums P, Q and Bm."""
    return (a.double() @ b.double().transpose(-1, -2)).to(torch.float32)


def wkv6_chunked_ref(r, k, v, w, u, state=None):
    """``wkv6_ref`` in the chunked kernels' form, f32: (y (B, T, H, K),
    the final state (B, H, K, K), the state entering every chunk (B, H,
    nc, K, K)).  (i) per chunk, its contribution dS_c = (k * suf)^T v
    and decay F_c = prod w over the chunk; (ii) the serial pass S_{c+1}
    = F_c S_c + dS_c (both in f64); (iii) per chunk, sub-chunk by
    sub-chunk from S_c:
    y_i = (r_i * pre_i) S_a + sum_{j<=i} A_ij v_j, S_{a+1} = tot S_a +
    (k * suf)^T v."""
    B, T, H, K = r.shape
    C, L = WKV_CHUNK, WKV_SUB
    rb, kb, vb = (_wkv_blocks(t, 0.0) for t in (r, k, v))
    wb = _wkv_blocks(w, 1.0)
    nc = rb.shape[2]
    u = u.to(torch.float32).reshape(1, H, 1, K)
    # (i), (ii) in f64
    _, sufc, F = _wkv_decay(wb.double())
    dSc = (kb * sufc).transpose(-1, -2) @ vb.double()
    S = (rb.new_zeros((B, H, K, K)) if state is None else state).double()
    chunks = []
    for c in range(nc):
        chunks.append(S.to(torch.float32))
        S = F[:, :, c, :, None] * S + dSc[:, :, c]
    chunks, S = torch.stack(chunks, 2), S.to(torch.float32)
    # (iii)
    Sa, ys = chunks, []
    for a0 in range(0, C, L):
        r_, k_, v_, w_ = (t[..., a0:a0 + L, :] for t in (rb, kb, vb, wb))
        pre, suf, tot = _wkv_decay(w_)
        A = _wkv_A(r_, k_, w_, u)
        y = _row_dot(r_ * pre, Sa)
        for i in range(L):
            for j in range(i + 1):
                y[..., i, :] = _fma(A[..., i, j, None], v_[..., j, :],
                                    y[..., i, :])
        ys.append(y)
        Sa = _outer_sum(tot[..., None] * Sa, k_ * suf, v_, range(L))
    return _wkv_unblock(torch.cat(ys, 3), T), S, chunks


def wkv6_chunked_bwd_ref(r, k, v, w, u, dy, chunks, dstate=None):
    """``wkv6_bwd_ref`` in the chunked kernels' form, f32, from the
    forward's chunk states: (dr, dk, dv, dw (B, T, H, K), du (H, K), dS0
    (B, H, K, K)).  (i) per chunk dG_c = (r * pre)^T dy; (ii) the reverse
    pass dS_{c-1} = F_c dS_c + dG_c from ``dstate`` (the gradient after
    each chunk; dS0 at the end), both in f64; (iii) per chunk, the states
    S_a entering
    its sub-chunks and the gradients dS_a after them, then per sub-chunk,
    with P = dy S_a^T, Q = v dS_a^T and Bm = dy v^T:

        dr_i = pre_i P_i + sum_{j<i} D_ij k_j Bm_ij + u k_i Bm_ii
        dk_j = suf_j Q_j + sum_{i>j} D_ij r_i Bm_ij + u r_j Bm_jj
        dv_j = (k_j suf_j) dS_a + sum_{i>=j} A_ij dy_i
        du = sum_i r_i k_i Bm_ii

    and dw_m = sum_n dS_m S_{m-1} (the serial form's: no division by w,
    finite at w = 0), split over the sub-chunk as

        pre_m suf_m rowsum(dS_a * S_a) + suf_m sum_{j<m} D_mj k_j Q_j
        + pre_m sum_{i>m} D_im r_i P_i + sum_{j<m<i} D_im D_mj r_i k_j Bm_ij.

    P, Q, Bm and rowsum(dS_a * S_a) accumulate in f64 (P, Q and Bm round
    once to f32), as the kernel's do (each output here combines several
    such sums over K where the serial form has one; in f32 they put dr,
    dk and dw at up to 3.3x the serial form's error from f64); dw's double
    sum runs on the unrounded Bm in f64, and its four terms are added in
    f64.
    """
    B, T, H, K = r.shape
    C, L = WKV_CHUNK, WKV_SUB
    rb, kb, vb, dyb = (_wkv_blocks(t, 0.0) for t in (r, k, v, dy))
    wb = _wkv_blocks(w, 1.0)
    nc = rb.shape[2]
    u = u.to(torch.float32).reshape(1, H, 1, K)
    # (i), (ii) in f64
    prec, _, F = _wkv_decay(wb.double())
    dGc = (rb * prec).transpose(-1, -2) @ dyb.double()
    dS = (rb.new_zeros((B, H, K, K)) if dstate is None else dstate).double()
    after = [None] * nc
    for c in reversed(range(nc)):
        after[c] = dS.to(torch.float32)
        dS = F[:, :, c, :, None] * dS + dGc[:, :, c]
    dS = dS.to(torch.float32)
    # (iii)
    subs = [tuple(t[..., a0:a0 + L, :] for t in (rb, kb, vb, wb, dyb))
            for a0 in range(0, C, L)]
    dec = [_wkv_decay(sub[3]) for sub in subs]
    Ss = [chunks.to(torch.float32)]
    for (r_, k_, v_, w_, dy_), (pre, suf, tot) in zip(subs[:-1], dec):
        Ss.append(_outer_sum(tot[..., None] * Ss[-1], k_ * suf, v_,
                             range(L)))
    dSs = [torch.stack(after, 2)] * len(subs)
    for a in range(len(subs) - 1, 0, -1):
        r_, k_, v_, w_, dy_ = subs[a]
        pre, suf, tot = dec[a]
        dSs[a - 1] = _outer_sum(tot[..., None] * dSs[a], r_ * pre, dy_,
                                reversed(range(L)))
    outs = [[], [], [], []]
    du = torch.zeros_like(rb[..., 0, :])
    for (r_, k_, v_, w_, dy_), (pre, suf, tot), Sa, dSa in zip(subs, dec, Ss,
                                                              dSs):
        P, Q = (_f64_mm(a, b) for a, b in ((dy_, Sa), (v_, dSa)))
        B64 = (dy_.double() @ v_.double().transpose(-1, -2))[..., None]
        Bm = B64.to(torch.float32)
        A = _wkv_A(r_, k_, w_, u)
        rowdot = (dSa.double() * Sa.double()).sum(-1)
        dr, dk, dw = (torch.empty_like(r_) for _ in range(3))
        dv = _row_dot(k_ * suf, dSa)
        for i in range(L):
            x, y = (r_[..., i, :], k_[..., i, :])
            bii = Bm[..., i, i, :]
            h = torch.zeros_like(x)
            for j in range(i):
                h = _fma(k_[..., j, :], Bm[..., i, j, :], h * w_[..., j, :])
            dr[..., i, :] = (pre[..., i, :] * P[..., i, :] + h
                             + u * y * bii)
            h = torch.zeros_like(x)
            for m in range(L - 1, i, -1):
                h = _fma(r_[..., m, :], Bm[..., m, i, :], h * w_[..., m, :])
            dk[..., i, :] = (suf[..., i, :] * Q[..., i, :] + h
                             + u * x * bii)
            for m in range(L - 1, i - 1, -1):
                dv[..., i, :] = _fma(A[..., m, i, None], dy_[..., m, :],
                                     dv[..., i, :])
            du = _fma(x * y, bii, du)
            # dw: Horner chains over the sub-chunk; the double sum (tri)
            # and the sum of the four terms in f64
            fw, rv = torch.zeros_like(x), torch.zeros_like(x)
            tri = torch.zeros_like(x, dtype=torch.float64)
            for j in range(i):
                fw = _fma(k_[..., j, :], Q[..., j, :], fw * w_[..., j, :])
            for m in range(L - 1, i, -1):
                rv = _fma(r_[..., m, :], P[..., m, :], rv * w_[..., m, :])
                z = torch.zeros_like(tri)
                for j in range(i):
                    z = k_[..., j, :] * B64[..., m, j, :] + z * w_[..., j, :]
                tri = r_[..., m, :] * z + tri * w_[..., m, :]
            p64, s64 = pre[..., i, :].double(), suf[..., i, :].double()
            dw[..., i, :] = ((p64 * s64 * rowdot + s64 * fw) + p64 * rv
                             + tri).to(torch.float32)
        for o, x in zip(outs, (dr, dk, dv, dw)):
            o.append(x)
    dr, dk, dv, dw = (_wkv_unblock(torch.cat(o, 3), T) for o in outs)
    return dr, dk, dv, dw, du.sum((0, 2)), dS
