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

On a model axis (``parallel.tp``) where ``out_proj`` / ``gate_norm`` hold
blocks of d_in and the heads divide the axis, the SSD runs on the rank's
``H / model`` heads: the fused ``in_proj`` (whose column blocks cut its
segments) is multiplied by the rank's block and the product gathered
over ``model``, the rank takes its heads of z, x and dt and the whole B
and C, its slice of the whole per-head ``A_log`` / ``D`` / ``dt_bias``
(gradient summed over ``model``), ``gate_norm`` normalises the whole
width and ``out_proj`` is row-parallel.  Where the heads do not divide
(zamba2's smoke config on 4 ranks) the SSD runs whole on every rank and
only ``gate_norm`` / ``out_proj`` run split; a whole layer runs whole.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.dist import collectives as coll
from repro_torch.models import nn, parallel
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


def _mode(cfg: ModelConfig, p):
    """(the model axis or None, whether the SSD runs on the rank's heads,
    whether ``out_proj`` / ``gate_norm`` hold the rank's block of d_in).
    On a model axis, where ``out_proj`` and ``gate_norm`` hold blocks of
    d_in (a table splitting one splits the other: both are ``mlp``), the
    heads split where they divide it; where they are whole the block
    runs whole (a whole model on the mesh, as the one-rank checks run
    it)."""
    t = parallel.tp()
    if t is None:
        return None, False, False
    H, P, _ = heads(cfg)
    split_out = parallel.held_in_part(p.out_proj, 0, H * P)
    if split_out != parallel.held_in_part(p.gate_norm, 0, H * P):
        raise ValueError("out_proj and gate_norm split alike over model")
    return t, split_out and H % t.size == 0, split_out


def _split_proj(cfg: ModelConfig, x, p, mode=(None, False, False)):
    """The input projection split into z, x, B, C (x's dtype) and dt
    (f32, softplus'd with its bias), and the heads they cover (H, or the
    rank's H / model).

    On the model axis the fused ``in_proj`` columns [z | x | B | C | dt]
    held in blocks do not split along its segments: the rank multiplies
    by its block and the product's columns are gathered over ``model``
    (backward: reduce-scatter), then the rank takes its heads of z, x
    and dt and the whole B and C; a whole ``in_proj`` gives the whole
    product on every rank.  Where the heads do not divide the axis every
    rank runs them all."""
    d_in = cfg.ssm_expand * cfg.d_model
    H, P, n = heads(cfg)
    t, local, _ = mode
    A_log, dt_bias, D = p.A_log, p.dt_bias, p.D
    if t is None:
        zxbcdt = nn.dense(x, p.in_proj)
    elif parallel.held_in_part(p.in_proj, 1, 2 * d_in + 2 * n + H):
        part = nn.dense(coll.copy_to(x, t.group), p.in_proj)
        zxbcdt = (coll.gather(part, -1, t.group) if local
                  else parallel.gather_whole(part, -1, t.group))
    else:
        zxbcdt = nn.dense(x, p.in_proj)
        if local:  # the rank reads a part: its gradient summed over model
            zxbcdt = coll.copy_to(zxbcdt, t.group)
    z, xs, B, C, dt = torch.split(zxbcdt, [d_in, d_in, n, n, H], dim=-1)
    if local:
        h = H // t.size
        z, xs = (y.narrow(-1, t.rank * h * P, h * P) for y in (z, xs))
        dt = dt.narrow(-1, t.rank * h, h)
        A_log, dt_bias, D = (parallel.rank_slice(v, 0, t, h)
                             for v in (A_log, dt_bias, D))
        H = h
    dt = dt.to(torch.float32) + dt_bias.to(torch.float32)
    dt = torch.logaddexp(dt, torch.zeros((), dtype=dt.dtype,
                                         device=dt.device))
    return z, xs, B, C, dt, (H, A_log, D)


def _gate_out(cfg: ModelConfig, p, y, xs, z, D, mode=(None, False, False)):
    """y + D x, gated RMS norm, output projection.  On the model axis,
    with ``out_proj`` / ``gate_norm`` held in blocks of d_in, the norm
    runs over the whole width (``nn.rms_norm(group=)``) and ``out_proj``
    is row-parallel; whole heads are first cut to the rank's block of
    d_in (its gradient summed over model)."""
    t, local, split_out = mode
    y = y + xs * D.to(xs.dtype).repeat_interleave(P_HEAD)
    if not split_out:
        y = nn.rms_norm(y, p.gate_norm) * torch.nn.functional.silu(z)
        return nn.dense(y, p.out_proj)
    if not local:
        b = p.out_proj.shape[0]
        y, z = (coll.copy_to(v, t.group).narrow(-1, t.rank * b, b)
                for v in (y, z))
    y = nn.rms_norm(y, p.gate_norm, group=t.group) * \
        torch.nn.functional.silu(z)
    return nn.row_parallel(y, p.out_proj, t.group)


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
    mode = _mode(cfg, p)
    z, xs, Bm, Cm, dt, (H, A_log, D) = _split_proj(cfg, x, p, mode)
    A = -torch.exp(A_log.to(f32))  # (H,), negative

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
    return _gate_out(cfg, p, y, xs, z, D, mode), h


def mamba2_decode(cfg: ModelConfig, p, x, state):
    """One step: x (B, 1, D), state (B, H, P, N) f32 -> (y (B, 1, D),
    the new state)."""
    f32, dt_ = torch.float32, x.dtype
    mode = _mode(cfg, p)
    z, xs, Bm, Cm, dt, (H, A_log, D) = _split_proj(cfg, x, p, mode)
    P = P_HEAD
    A = -torch.exp(A_log.to(f32))
    a = torch.exp(dt[:, 0] * A)  # (B, H)
    xh = xs.reshape(-1, H, P)
    db = dt[:, 0].to(dt_)[:, :, None] * Bm[:, 0].to(dt_)[:, None, :]
    inc = xh[..., None] * db[:, :, None, :]  # (B, H, P, N)
    new_state = (state * a[..., None, None].to(state.dtype)
                 + inc.to(state.dtype))
    y = torch.einsum("bhpn,bn->bhp", new_state.to(dt_), Cm[:, 0].to(dt_))
    y = y.reshape(x.shape[0], 1, H * P)
    return _gate_out(cfg, p, y, xs, z, D, mode), new_state
