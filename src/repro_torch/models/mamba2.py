"""Mamba2 (SSD) block, chunked: the port of ``repro.models.mamba2``.

State-space recurrence per head (head dim P = 64, state N = ssm_state):

    h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t^T       h in R^{P x N}
    y_t = h_t C_t + D x_t

The sequence is cut into chunks of Q = ssm_chunk steps: within a chunk
the interactions are a masked (Q x Q) product, and the state crosses the
chunks in a loop of T / Q steps.  Plain PyTorch (einsums and the loop),
as the reference is pure JAX: it reaches no Pallas kernel.  The
depthwise conv frontend of Mamba2 is omitted, as in the reference.

Rounding, read off the reference's compiled HLO (bf16 compute):
  * ``cb * m * dt`` is two bf16 products, each rounded (cb, the masked
    decay m and dt each rounded to bf16 first);
  * the three-operand einsums contract as XLA's dot_generals do: the
    chunk's state increment multiplies B by the decay-weighted dt first
    (an outer product rounded to the compute dtype, (b, q, s, n, h)) and
    then contracts it with x over the chunk's steps; the cross-chunk
    output multiplies the decay exp(L_t) by C first ((b, q, t, h, n),
    rounded) and then contracts with the carried state over N; the
    decode step's increment rounds dt B (b, h, n) and then x (dt B);
  * dt = softplus(dt + bias) in f32 as ``jax.nn.softplus``, which is
    ``logaddexp(x, 0)`` (``torch.nn.functional.softplus`` switches to x
    above 20 and would differ there).
Sums run in f32 inside the products (matmuls in the compute dtype, f32
accumulation); the decays and the carried state are f32.

One deliberate difference: the within-chunk decay exp(L_t - L_s) is
masked *before* the exp (L_t - L_s set to -inf above the diagonal, whose
exp is 0), where the reference takes the exp and then masks.  The
forward is the same, bit for bit.  The gradient differs only where the
reference's is NaN: above the diagonal L_t - L_s is a sum of up to Q
positive steps, which overflows exp at the configs' Q = 128 (from the
init, A = -1 and dt ~ 0.7, the sum reaches ~90), and the gradient of
``where`` then multiplies the masked zero by inf.  So the reference's
mamba2 gradient is NaN at every full config, and the port's is finite
(tests/test_torch_zamba2.py, ROADMAP Reference caveats).

``p`` is a layer's parameters under the reference's names as attributes
(``in_proj``, ``out_proj``, ``A_log``, ``D``, ``dt_bias``, ``norm_w``,
``gate_norm``): a ``zamba2.Mamba2Layer`` or a namespace of a parameter
tree's slices.  ``norm_w`` is in the reference's tree and unused by its
block, as here.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import nn
from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import ParamSpec

P_HEAD = 64  # the head dim of the SSD heads


def mamba2_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = d_in // P_HEAD
    return {
        "in_proj": ParamSpec((d, 2 * d_in + 2 * n + h), ("embed", "mlp")),
        "out_proj": ParamSpec((d_in, d), ("mlp", "embed")),
        "A_log": ParamSpec((h,), (None,), "zeros"),
        "D": ParamSpec((h,), (None,), "ones"),
        "dt_bias": ParamSpec((h,), (None,), "zeros"),
        "norm_w": ParamSpec((d,), ("embed",), "ones"),
        "gate_norm": ParamSpec((d_in,), ("mlp",), "ones"),
    }


def heads(cfg: ModelConfig) -> tuple:
    """(H, P, N): the SSD heads, their dim and the state size."""
    return cfg.ssm_expand * cfg.d_model // P_HEAD, P_HEAD, cfg.ssm_state


def _split_proj(cfg: ModelConfig, x, p):
    """The input projection split into z, x, B, C (x's dtype) and dt
    (f32, softplus'd with its bias)."""
    d_in = cfg.ssm_expand * cfg.d_model
    H, _, n = heads(cfg)
    zxbcdt = nn.dense(x, p.in_proj)
    z, xs, B, C, dt = torch.split(zxbcdt, [d_in, d_in, n, n, H], dim=-1)
    dt = dt.to(torch.float32) + p.dt_bias.to(torch.float32)
    dt = torch.logaddexp(dt, torch.zeros((), dtype=dt.dtype,
                                         device=dt.device))
    return z, xs, B, C, dt


def _gate_out(cfg: ModelConfig, p, y, xs, z):
    """y + D x, gated RMS norm, output projection."""
    y = y + xs * p.D.to(xs.dtype).repeat_interleave(P_HEAD)
    y = nn.rms_norm(y, p.gate_norm) * torch.nn.functional.silu(z)
    return nn.dense(y, p.out_proj)


def mamba2_block(cfg: ModelConfig, p, x):
    """Training / prefill: x (B, T, D) -> (y (B, T, D), the final state
    (B, H, P, N) f32).  T must be a multiple of the chunk
    Q = min(ssm_chunk, T), as the reference's reshape requires."""
    Bsz, T, _ = x.shape
    H, P, N = heads(cfg)
    Q = min(cfg.ssm_chunk, T)
    if T % Q:
        raise ValueError(f"mamba2: T = {T} is not a multiple of the chunk "
                         f"{Q} (ssm_chunk {cfg.ssm_chunk})")
    nq = T // Q
    f32, dt_ = torch.float32, x.dtype
    z, xs, Bm, Cm, dt = _split_proj(cfg, x, p)
    A = -torch.exp(p.A_log.to(f32))  # (H,), negative

    xh = xs.reshape(Bsz, nq, Q, H, P)
    dtc = dt.reshape(Bsz, nq, Q, H)
    Bc = Bm.reshape(Bsz, nq, Q, N)
    Cc = Cm.reshape(Bsz, nq, Q, N)

    cum = torch.cumsum(dtc * A, dim=2)  # L_t, (B, nq, Q, H) f32

    # within a chunk: y[t] = sum_{s<=t} exp(L_t - L_s) dt_s (C_t . B_s) x_s
    cb = torch.einsum("bqtn,bqsn->bqts", Cc, Bc)  # (B, nq, Q, Q)
    # exp(L_t - L_s) for s <= t, 0 above the diagonal: masked before the
    # exp, where the reference masks after it (see the module docstring)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    m = torch.exp(torch.where(mask[None, None, :, :, None],
                              cum[:, :, :, None, :] - cum[:, :, None, :, :],
                              float("-inf"))).to(dt_)
    scores = cb[..., None].to(dt_) * m * dtc[:, :, None, :, :].to(dt_)
    del m
    y_intra = torch.einsum("bqtsh,bqshp->bqthp", scores, xh)
    del scores

    # the state increment of each chunk: sum_s exp(L_end - L_s) dt_s
    # x_s B_s^T, as (B (x) w) then x
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # (B, nq, Q, H) f32
    bw = Bc.to(dt_)[..., :, None] * w.to(dt_)[..., None, :]  # (b,q,s,n,h)
    inc = torch.einsum("bqshp,bqsnh->bqhpn", xh, bw).to(f32)
    del bw
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nq, H)

    # across chunks: the state before each chunk
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    prev = []
    for c in range(nq):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + inc[:, c]
    h_prev = torch.stack(prev, dim=1)  # (B, nq, H, P, N)

    # y_cross[t] = exp(L_t) C_t . h_prev, as (exp(L) (x) C) then h_prev
    ec = torch.exp(cum).to(dt_)[..., :, None] * Cc.to(dt_)[..., None, :]
    y_cross = torch.einsum("bqthn,bqhpn->bqthp", ec, h_prev.to(dt_))
    del ec, h_prev

    y = (y_intra + y_cross).reshape(Bsz, T, H * P)
    return _gate_out(cfg, p, y, xs, z), h


def mamba2_decode(cfg: ModelConfig, p, x, state):
    """One step: x (B, 1, D), state (B, H, P, N) f32 -> (y (B, 1, D),
    the new state)."""
    H, P, N = heads(cfg)
    f32, dt_ = torch.float32, x.dtype
    z, xs, Bm, Cm, dt = _split_proj(cfg, x, p)
    A = -torch.exp(p.A_log.to(f32))
    a = torch.exp(dt[:, 0] * A)  # (B, H)
    xh = xs.reshape(-1, H, P)
    db = dt[:, 0].to(dt_)[:, :, None] * Bm[:, 0].to(dt_)[:, None, :]
    inc = xh[..., None] * db[:, :, None, :]  # (B, H, P, N)
    new_state = (state * a[..., None, None].to(state.dtype)
                 + inc.to(state.dtype))
    y = torch.einsum("bhpn,bn->bhp", new_state.to(dt_), Cm[:, 0].to(dt_))
    y = y.reshape(x.shape[0], 1, H * P)
    return _gate_out(cfg, p, y, xs, z), new_state
