"""Mixture-of-Experts FFN of dbrx / phi3.5-moe (the port of
``repro.models.moe``): capacity-based dispatch, local to the call's
tokens.

Top-k routing, each choice's position within its expert from a one-hot
cumsum (sort-free), the kept choices placed in an (E, C, D) buffer, the
batched expert FFN on the whole zero-padded buffer, then gather and
combine (``route``, ``dispatch``, ``expert_ffn``, ``combine``).

On the active mesh (``models.parallel``) the block routes the rank's own
tokens, its rows of the batch, with the capacity of their count, as the
reference's ``shard_map`` hands each (pod, data) shard its rows; a batch
that no batch axis divides is whole on every rank.  On a ``model`` axis
it takes the reference's branches:

  * tensor parallel (``_local_moe``): the rank's block of each expert's
    d_ff; the tokens enter through ``copy_to`` and the down-projection's
    partials are summed over ``model`` (``nn.row_parallel``: f32
    partials, one rounding after the sum, as XLA compiles the
    reference's bf16 ``psum``);
  * expert parallel (``_local_moe_ep``, for ``cfg.moe_ep`` when the
    experts divide the axis): the (E, C, D) buffer goes out in ``model``
    blocks of E / model experts (``coll.exchange``), each rank runs its
    experts at full d_ff on the (E / model, model C, D) rows it receives,
    and the outputs come back by the same exchange.  The tokens are
    replicated over ``model``, so every peer sends the same rows and the
    rank computes each of them ``model`` times, as the reference does
    (``parallel.rank_experts`` scales the experts' gradient back).

Without a model axis (or one rank) the block is the one-card block.

Bits follow the reference's jitted block:

  * the gate is ``softmax(f32 tokens @ f32 router)``; the product runs
    in f64 and is rounded to f32 once, so no global TF32 switch can
    reach it; the top ``k`` come from a stable descending sort, which
    breaks ties toward the lower expert as ``jax.lax.top_k`` does
    (``torch.topk`` promises no order for ties on CUDA);
  * positions are taken in token-major, choice-minor order (token 0's
    second choice before token 1's first); a choice at a position
    ``>= C`` is dropped: no slot, no output, no gradient;
  * the combine rounds each weight to the compute dtype, each weighted
    output too, and sums a token's ``k`` outputs in choice order,
    rounding after each add, as XLA's ``segment_sum`` does.

The dispatch and the combine are gathers (an inverse slot map), with no
atomics in the forward: a recomputed forward (remat) routes and sums
identically.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as coll
from repro_torch.models import nn, parallel
from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import ParamSpec


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", None)),
        "w_gate": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "w_up": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "w_down": ParamSpec((e, f, d), ("expert", "mlp", "embed")),
    }


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of ``tokens`` tokens: ceil(N K / E
    times the capacity factor), rounded up to 8, at least 8."""
    c = int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def route(cfg: ModelConfig, tokens: torch.Tensor, router: torch.Tensor):
    """Routing of ``tokens`` (N, D): (top_w (N, K) f32 renormalized
    weights, top_e (N, K) experts, flat_pos (N K,) position of each
    choice within its expert, keep (N K,) bool, C)."""
    N = tokens.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(N, cfg)
    logits = (tokens.double() @ router.double()).to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = vals[:, :K], idx[:, :K]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    flat_e = top_e.reshape(-1)
    # the (E, N K) one-hot, so the scan runs along the inner dimension
    onehot = (flat_e[None] == torch.arange(E, device=flat_e.device)[:, None]
              ).long()
    pos = torch.cumsum(onehot, dim=1) - onehot  # exclusive, choice order
    flat_pos = pos.gather(0, flat_e[None])[0]
    return top_w, top_e, flat_pos, flat_pos < C, C


def dispatch(cfg: ModelConfig, tokens: torch.Tensor, top_e, flat_pos,
             keep, C: int):
    """The (E, C, D) buffer of the kept choices' tokens (zero rows where
    no choice is placed) and ``slot`` (N K,): each choice's row in the
    flattened buffer, E C for a dropped one."""
    N, D = tokens.shape
    E, K = cfg.n_experts, cfg.top_k
    # slot of each choice in the flattened (E C) buffer; dropped choices
    # point at one extra slot past the end, which stays empty
    slot = torch.where(keep, top_e.reshape(-1) * C + flat_pos, E * C)
    # the inverse map: the choice filling each slot, N K where none does
    src = torch.full((E * C + 1,), N * K, dtype=torch.long,
                     device=tokens.device)
    src[slot] = torch.arange(N * K, device=tokens.device)
    src_tok = torch.where(src < N * K, src // K, N)[:E * C]
    return F.pad(tokens, (0, 0, 0, 1))[src_tok].view(E, C, D), slot


def expert_ffn(buf, w_gate, w_up, w_down, group=None):
    """silu(buf @ w_gate) * (buf @ w_up) @ w_down, batched over the
    experts, in buf's dtype.  With ``group`` the weights are the rank's
    block of d_ff and the down-projection's partials are summed over the
    group (``nn.row_parallel``)."""
    dt = buf.dtype
    h = (F.silu(torch.matmul(buf, w_gate.to(dt)))
         * torch.matmul(buf, w_up.to(dt)))
    if group is None:
        return torch.matmul(h, w_down.to(dt))
    return nn.row_parallel(h, w_down.to(dt), group)


def local_moe(cfg: ModelConfig, x, router, w_gate, w_up, w_down,
              group=None):
    """The MoE FFN of ``x`` (B, T, D) in x's dtype (the reference's
    ``_local_moe``): on one rank with whole weights, or with ``group``
    (the model axis) on the rank's d_ff block of every expert."""
    B, T, D = x.shape
    tokens = x.reshape(B * T, D)
    top_w, top_e, flat_pos, keep, C = route(cfg, tokens, router)
    if group is not None:  # each rank's d_ff block sends back a partial
        tokens = coll.copy_to(tokens, group)
    buf, slot = dispatch(cfg, tokens, top_e, flat_pos, keep, C)
    out = expert_ffn(buf, w_gate, w_up, w_down, group)
    return combine(out.reshape(-1, D), slot, top_w).reshape(B, T, D)


def local_moe_ep(cfg: ModelConfig, x, router, w_gate, w_up, w_down, t):
    """The expert-parallel MoE FFN of ``x`` (B, T, D) (the reference's
    ``_local_moe_ep``) on the model axis ``t``: ``w_*`` are this rank's E
    / model experts at full d_ff (``parallel.rank_experts``)."""
    B, T, D = x.shape
    E, n = cfg.n_experts, t.size
    tokens = x.reshape(B * T, D)
    top_w, top_e, flat_pos, keep, C = route(cfg, tokens, router)
    buf, slot = dispatch(cfg, tokens, top_e, flat_pos, keep, C)
    e_loc = E // n
    # (E, C, D) -> (model, E / model, C, D): block i to rank i, which
    # returns the rows for its experts from every peer, stacked by peer
    recv = coll.exchange(buf.view(n, e_loc, C, D), t.group)
    recv = recv.transpose(0, 1).reshape(e_loc, n * C, D)
    out = expert_ffn(recv, w_gate, w_up, w_down)
    out = out.view(e_loc, n, C, D).transpose(0, 1)
    back = coll.exchange(out, t.group).reshape(E * C, D)
    return combine(back, slot, top_w).reshape(B, T, D)


def combine(out: torch.Tensor, slot: torch.Tensor,
            top_w: torch.Tensor) -> torch.Tensor:
    """(N, D) outputs of the tokens from the experts' flattened outputs
    ``out`` (E C, D): choice j of token n reads row ``slot[n K + j]`` (E C
    for a dropped choice, which reads 0), times its weight rounded to
    out's dtype; a token's K products are summed in choice order in
    out's dtype."""
    N, K = top_w.shape
    gathered = F.pad(out, (0, 0, 0, 1))[slot]
    w = top_w.reshape(-1).to(out.dtype)
    parts = (gathered * w[:, None]).view(N, K, -1)
    y = parts[:, 0]
    for j in range(1, K):
        y = y + parts[:, j]
    return y


def moe_block(cfg: ModelConfig, m, x):
    """``m``: the layer's ``moe`` parameters (router, w_gate, w_up,
    w_down; a dict or ParameterDict), each this rank's block on the
    active mesh, gathered over ``data`` by the caller (FSDP).  The
    branch follows the reference's ``moe_block``: expert parallel for
    ``cfg.moe_ep`` on a model axis the experts divide, else tensor
    parallel where the rank holds a d_ff block of the experts, else the
    whole block on every rank."""
    t = parallel.tp()
    if parallel.moe_expert_parallel(cfg, t):
        ws = [parallel.rank_experts(cfg, t, m[k], f_dim)
              for k, f_dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1))]
        return local_moe_ep(cfg, x, m["router"], *ws, t)
    if t is not None and parallel.held_in_part(m["w_gate"], 0,
                                               cfg.n_experts):
        raise NotImplementedError(
            "expert leaves split over the model axis (EP_PARAM_RULES) "
            "under a config that does not take the expert-parallel "
            "branch (cfg.moe_ep off): place them by the config's rule "
            "table")
    group = (t.group if t is not None and parallel.held_in_part(
        m["w_gate"], 2, cfg.d_ff) else None)
    return local_moe(cfg, x, m["router"], m["w_gate"], m["w_up"],
                     m["w_down"], group)
