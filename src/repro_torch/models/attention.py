"""Attention of the dense models (the port of ``repro.models.attention``).

``flash_attention``, the full-sequence (prefill / training) attention,
goes to ``kernels.ops.flash_attention``: a hand-written kernel on the
card, its plain version on the CPU, one function per dtype, with its
gradient (the dtype's backward kernel, ``flash_attention_bwd_sm90`` or
``flash_attention_bwd_f32_sm90``, on the card).  In
bf16 it computes what the reference computes in bf16 (q scaled by
bf16(D^-1/2) in bf16, scores summed in f32, P rounded to bf16 for P V
against the running max of the ``kv_chunk``-key chunks seen so far), at
the caller's ``kv_chunk`` on both devices; on the card the chunk must be
a multiple of the kernel's 128-key tile or cover every key (the configs'
1024 is; the smoke configs' 8 runs on the CPU only).  In f32 it is the
Pallas kernel's f32 function (``flash_attention_f32``), which has no
tiling in its result.  It takes the masks those kernels support, causal
or none, with queries starting at position 0, and the reference's
sliding window (zamba2's shared attention: key j is masked for query i
where ``j <= i - window``, the reference's ``kpos > q_pos - window``;
causal only, as the reference's callers use it).  The kernels skip the
key tiles wholly outside every row's window; in bf16 the spans stay the
reference's ``kv_chunk`` chunks, aligned to key 0, so P takes its bits.
A query offset raises on both devices: no caller in the reference passes
one.

``decode_attention`` (one new token against a KV cache) is plain
PyTorch, as the reference computes it outside any Pallas kernel; bf16 q
is scaled by bf16(D^-1/2), as the JAX model's weakly typed scalar does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import collectives as coll
from repro_torch.kernels import ops, ref

NEG_INF = -1e30


def flash_attention(q, k, v, *, causal: bool = True, q_offset=0,
                    window: Optional[int] = None, kv_chunk: int = 1024):
    """q: (B, Tq, HQ, D); k, v: (B, S, HK, D) with HQ % HK == 0 ->
    (B, Tq, HQ, D) in v's dtype: bf16 the reference's bf16 function, f32
    its f32 function (see the module's docstring).  ``kv_chunk`` is the
    reference's KV tiling, which sets the running max bf16 P is rounded
    against, on both devices (1024 by default, as the reference's).
    ``window``: the sliding window (None for none).  The reference's
    ``q_chunk`` has no counterpart: it does not change the result."""
    if not (isinstance(q_offset, int) and q_offset == 0):
        raise NotImplementedError(
            "a query offset is not ported yet: the flash kernel's causal "
            "mask starts the queries at position 0 (see ROADMAP.md)")
    return ops.flash_attention(q, k, v, causal=causal, kv_tile=kv_chunk,
                               window=window or 0).to(v.dtype)


def decode_attention(q, k_cache, v_cache, new_k, new_v, *,
                     window: Optional[int] = None, valid_len=None,
                     kv_pos=None, q_pos=None, row0: int = 0, group=None):
    """Single-token decode: q (B, 1, HQ, D) attends to the full cache
    (B, S, HK, D) plus its own freshly computed (new_k, new_v).

    Cache validity, one of three ways:
      * neither ``valid_len`` nor ``kv_pos``: every cache row is valid;
      * ``valid_len`` (B,): rows ``[0, valid_len)`` are valid (the
        slot-pool engine);
      * ``kv_pos`` (B, S): per-row absolute positions, -1 = empty.
    ``window`` masks rows at or before ``q_pos - window`` (``q_pos``
    defaults to ``valid_len``).  Masked rows score -1e30 and contribute
    exactly 0.  Products are summed in f32 (the reference's
    ``preferred_element_type``), the result is cast to the cache's dtype.

    ``group``: the cache holds rows [row0, row0 + S) of a longer sequence
    split over the group's ranks (``valid_len`` and ``window`` count
    global rows); each rank's (max, softmax sum, weighted values) against
    its own max are gathered in one collective and combined, rescaled to
    the global max (a shard wholly masked scales by exp(-1e30) = 0), and
    the new token's term added once.
    """
    B, _, HQ, D = q.shape
    S, HK = k_cache.shape[1], k_cache.shape[2]
    G = HQ // HK
    f32 = torch.float32
    qg = q.reshape(B, HK, G, D)
    if qg.dtype == torch.bfloat16:  # the JAX model's bf16(D^-1/2)
        qg = ref.scale_q_bf16(qg).to(k_cache.dtype)
    else:
        qg = (qg * D ** -0.5).to(k_cache.dtype)
    s_cache = torch.einsum("bkgd,bskd->bkgs", qg.to(f32), k_cache.to(f32))
    if q_pos is None and valid_len is not None:
        q_pos = valid_len
    mask = None  # (B, S): True where the cache row is attended
    if kv_pos is not None:
        mask = kv_pos >= 0
        if window is not None and q_pos is not None:
            mask = mask & (kv_pos > q_pos[:, None] - window)
    elif valid_len is not None:
        idx = row0 + torch.arange(S, device=q.device)
        mask = idx[None, :] < valid_len[:, None]
        if window is not None and q_pos is not None:
            mask = mask & (idx[None, :] > q_pos[:, None] - window)
    elif window is not None and q_pos is not None:
        idx = row0 + torch.arange(S, device=q.device)
        mask = idx[None, :] > q_pos[:, None] - window
    if mask is not None:
        s_cache = torch.where(mask[:, None, None, :], s_cache, NEG_INF)
    s_self = torch.einsum("bkgd,bkd->bkg", qg.to(f32),
                          new_k.reshape(B, HK, D).to(qg.dtype).to(f32))
    # two-part softmax: the cache and the new token, no concatenation
    if group is None:
        m = torch.maximum(s_cache.amax(dim=-1), s_self)
        p_cache = torch.exp(s_cache - m[..., None])
        denom = p_cache.sum(dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd",
                           p_cache.to(v_cache.dtype).to(f32), v_cache.to(f32))
    else:  # each shard's (max, sum, values) gathered in one collective
        m_l = s_cache.amax(dim=-1)
        p_cache = torch.exp(s_cache - m_l[..., None])
        o_l = torch.einsum("bkgs,bskd->bkgd",
                           p_cache.to(v_cache.dtype).to(f32), v_cache.to(f32))
        stats = coll.all_gather(torch.cat(
            [m_l[..., None], p_cache.sum(dim=-1)[..., None], o_l], -1)[None],
            0, group)
        m = torch.maximum(stats[..., 0].amax(dim=0), s_self)
        scale = torch.exp(stats[..., 0] - m)  # 0 for a shard wholly masked
        denom = (stats[..., 1] * scale).sum(dim=0)
        out = (stats[..., 2:] * scale[..., None]).sum(dim=0)
    p_self = torch.exp(s_self - m)
    denom = denom + p_self
    out = out + p_self[..., None] * new_v.reshape(B, HK, 1, D).to(f32)
    out = out / denom[..., None]
    return out.reshape(B, 1, HQ, D).to(v_cache.dtype)
