"""Mixture-of-Experts FFN of dbrx / phi3.5-moe (the port of
``repro.models.moe``): capacity-based dispatch, local to the call's
tokens.

Top-k routing, each choice's position within its expert from a one-hot
cumsum (sort-free), the kept choices placed in an (E, C, D) buffer, the
batched expert FFN on the whole zero-padded buffer, then gather and
combine.  The reference wraps this block (``_local_moe``) in a
``shard_map`` with a ``psum`` over its ``model`` axis and has an
expert-parallel variant (``_local_moe_ep``, an ``all_to_all`` over that
axis); one card has no such axis, so the port calls the local block
directly (see the README).

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


def local_moe(cfg: ModelConfig, x, router, w_gate, w_up, w_down):
    """The MoE FFN of ``x`` (B, T, D) in x's dtype (the reference's
    ``_local_moe`` on one device)."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    tokens = x.reshape(B * T, D)
    N = B * T
    top_w, top_e, flat_pos, keep, C = route(cfg, tokens, router)
    # slot of each choice in the flattened (E C) buffer; dropped choices
    # point at one extra slot past the end, which stays empty
    slot = torch.where(keep, top_e.reshape(-1) * C + flat_pos, E * C)
    # the inverse map: the choice filling each slot, N K where none does
    src = torch.full((E * C + 1,), N * K, dtype=torch.long, device=x.device)
    src[slot] = torch.arange(N * K, device=x.device)
    src_tok = torch.where(src < N * K, src // K, N)[:E * C]
    buf = F.pad(tokens, (0, 0, 0, 1))[src_tok].view(E, C, D)

    h = (F.silu(torch.matmul(buf, w_gate.to(x.dtype)))
         * torch.matmul(buf, w_up.to(x.dtype)))
    out = torch.matmul(h, w_down.to(x.dtype)).view(E * C, D)

    return combine(out, slot, top_w).reshape(B, T, D)


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
    w_down), a dict or ParameterDict."""
    return local_moe(cfg, x, m["router"], m["w_gate"], m["w_up"],
                     m["w_down"])
