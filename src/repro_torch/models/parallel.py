"""How the transformer runs on the mesh's ``data`` and ``model`` axes.

The weights are stored by the rule tables (``dist.sharding``): each rank
holds ``shard_tensor``'s block of every leaf.  The model code reads the
active mesh (``meshctx.active_mesh``; none: one rank, every function
here the identity) and each leaf's block shape against its spec's global
shape, so one code path serves every rule table and mesh:

  * FSDP: a dim of logical axis ``embed`` held in part is sharded over
    ``data`` (the only axis the tables map ``embed`` to); ``gather_layer``
    and ``gather_leaf`` all-gather it at use (backward: reduce-scatter),
    in the dtype the caller cast the block to;
  * tensor parallelism: a sub-block whose weight is held in part along
    its ``heads`` / ``mlp`` / ``vocab`` / ``vocab_in`` dim runs on the
    rank's columns (``copy_to`` at its entry) and, for a row-parallel
    product, sums over ``model`` at its exit (``reduce_from``); a
    sub-block whose weight is whole runs whole on every rank, with no
    collective;
  * the MoE FFN (``models.moe``) routes the rank's own tokens (its rows
    of the batch, replicated over ``model``) with the capacity of their
    count, as the reference's ``shard_map`` does, and takes one of two
    branches on a model axis: tensor parallel (the experts' ``mlp`` dim
    split; the tokens enter through ``copy_to`` and the down-projection's
    f32 partials are summed over ``model``), or, for ``cfg.moe_ep`` with
    the experts dividing the axis, expert parallel (each rank's
    ``n_experts / model`` experts at full d_ff, the dispatch buffer
    exchanged both ways by ``coll.exchange``).  Its expert leaves are
    stored whole along ``expert`` and split along ``mlp`` under
    PARAM_RULES, NO_FSDP_RULES and SERVE_RESIDENT_RULES, and split along
    ``expert`` at full ``mlp`` under EP_PARAM_RULES; ``rank_experts``
    reshards the first layout to the expert-parallel one at use;
  * attention runs on the rank's query heads, ``n_heads / model`` of
    them, contiguous, where the head count divides the axis.  Its KV
    heads are the rank's own columns when ``n_kv_heads`` divides
    ``model``; otherwise the column blocks of ``wk`` / ``wv`` cut heads
    (starcoder2-3b's 2 heads of 128 over 4 ranks: 64 columns each) and
    the rank gathers the whole K / V over ``model`` and takes the heads
    its query heads use (``kv_for_local``).  Where the column blocks of
    ``wq`` cut query heads too (24 heads over 16 ranks: 1.5 heads each),
    the reference's layout runs: q, k and v projected by the rank's
    column blocks and gathered whole in one collective (backward: the
    reduce-scatter of every rank's partial gradient, which its block of
    dO gives), attention over all heads on every rank, and the rank's
    column block of the output into the row-parallel ``wo``
    (``local_heads`` 0, ``rank_columns``);
  * rwkv6, zamba2 and whisper: the embedding is vocab-parallel and the
    logits the rank's vocab block (``embed_lookup``, ``unembed``); a norm
    over a dim split over ``model`` (rwkv6's ``ln_x``, mamba2's
    ``gate_norm``) sums its f32 squares over the group
    (``nn.rms_norm(group=)``); a per-head vector stored whole (mamba2's
    ``A_log``, ``D``, ``dt_bias``) is sliced to the rank's heads with its
    gradient summed over ``model`` (``rank_slice``); mamba2's fused
    ``in_proj``, whose column blocks cut its segments, is multiplied by
    the rank's block and its product gathered over ``model``
    (``coll.gather``, or ``gather_whole`` where every rank then runs all
    heads).

``leaf_drawer`` draws each family's random weights a leaf at a time, cut
to the rank's block on a mesh.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Optional

import torch

from repro_torch.dist import collectives as coll
from repro_torch.dist import meshctx, sharding
from repro_torch.models import nn
from repro_torch.models.config import torch_dtype


@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's place on the ``model`` axis."""

    group: Any
    size: int
    rank: int


def tp() -> Optional[TP]:
    """The model axis of the active mesh, or None when it has size 1."""
    mesh = meshctx.active_mesh()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return TP(mesh.group("model"), mesh.shape["model"], mesh.coord("model"))


def data_group():
    mesh = meshctx.active_mesh()
    if mesh is None or mesh.shape.get("data", 1) == 1:
        return None
    return mesh.group("data")


def held_in_part(t: torch.Tensor, dim: int, full: int) -> bool:
    return t.shape[dim] < full


# ------------------------------------------------------------------ FSDP
def gather_leaf(t, spec):
    """``t`` with each ``embed`` dim that the rank holds in part gathered
    over ``data`` (autograd: the gradient is reduce-scattered back)."""
    group = data_group()
    if group is None:
        return t
    for dim, name in enumerate(spec.axes):
        if name == "embed" and held_in_part(t, dim, spec.shape[dim]):
            t = coll.gather(t, dim, group)
    return t


def gather_layer(lp, specs):
    """A layer's leaves gathered over ``data`` (``specs``: the layer's
    ParamSpec tree), as a namespace of the layer's names; the layer
    itself when the mesh has no ``data`` axis."""
    if data_group() is None:
        return lp
    out = {}
    for name, spec in specs.items():
        node = getattr(lp, name)
        if isinstance(spec, dict):
            out[name] = {k: gather_leaf(node[k], s) for k, s in spec.items()
                         if k in node}
        else:
            out[name] = gather_leaf(node, spec)
    return SimpleNamespace(**out)


def leaf_drawer(cfg, generator: torch.Generator, device, mesh=None,
                rules=None):
    """``draw(spec, lead=0)``: one leaf of ``spec``'s law without its
    first ``lead`` dims (a layer's slice of a stack, under the stack's
    law), drawn in f32 from ``generator`` on ``device`` and cast to the
    compute dtype as it is made; on a ``mesh`` of more than one rank,
    this rank's block of it under ``rules`` (default
    SERVE_RESIDENT_RULES): the same values as the whole model's
    blocks."""
    dt = torch_dtype(cfg.compute_dtype)
    rules = sharding.SERVE_RESIDENT_RULES if rules is None else rules

    def draw(spec, lead: int = 0):
        shape = spec.shape[lead:]
        x = nn.init_leaf(spec, generator, device, shape).to(dt)
        if mesh is None or mesh.size == 1:
            return x
        return sharding.shard_tensor(
            x, sharding.spec_for_axes(spec.axes[lead:], shape, mesh, rules),
            mesh)

    return draw


# ------------------------------------------------------ split widths
def rank_slice(v: torch.Tensor, dim: int, t: TP, n: int) -> torch.Tensor:
    """This rank's ``n`` entries along ``dim`` of ``v``, a leaf stored
    whole on every model rank (mamba2's per-head ``A_log``, ``D``,
    ``dt_bias``): the rank's gradient covers only its part, so it is
    summed over ``model`` (``copy_to``), and every rank holds the whole
    leaf's gradient."""
    return coll.copy_to(v, t.group).narrow(dim, t.rank * n, n)


class _GatherWhole(torch.autograd.Function):
    """All-gather of the ranks' blocks along ``dim``, used where every
    rank then computes the same from the whole (so the gradient arriving
    is the same on every rank): backward, this rank's block of it."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.r = coll.rank(group)
        return coll.all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.n, ctx.n).contiguous(), None, None


def gather_whole(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if coll.size(group) == 1:
        return x
    return _GatherWhole.apply(x, dim % x.dim(), group)


# ------------------------------------------------------------------- MoE
def moe_expert_parallel(cfg, t: Optional[TP]) -> bool:
    """The reference's test for its expert-parallel branch
    (``repro.models.moe.moe_block``): ``cfg.moe_ep``, a model axis, and
    the experts dividing it."""
    return (t is not None and cfg.moe_ep
            and cfg.n_experts % t.size == 0)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def rank_experts(cfg, t: TP, w: torch.Tensor, f_dim: int) -> torch.Tensor:
    """This rank's ``n_experts / model`` experts of an expert weight (E,
    ..., d_ff at ``f_dim``, ...) at full d_ff, from the block it stores:
    its experts already (EP_PARAM_RULES); a block of d_ff, gathered over
    ``model`` first (the other tables; the reference's ``shard_map``
    reshards at its boundary); or the whole weight.  The expert-parallel
    branch computes each expert's rows once for every peer (the tokens
    are replicated over ``model``, so every peer sends the same ones),
    so the gradient reaching these experts is ``model`` times their own:
    it is scaled back by 1 / model here, then summed back to the stored
    block (the gather's reduce-scatter, ``copy_to``'s all-reduce)."""
    E = cfg.n_experts
    e = E // t.size
    if held_in_part(w, 0, E):
        mine = w
    else:
        if held_in_part(w, f_dim, cfg.d_ff):
            w = coll.gather(w, f_dim, t.group)
        else:
            w = coll.copy_to(w, t.group)
        mine = w.narrow(0, t.rank * e, e)
    return _ScaleGrad.apply(mine, 1.0 / t.size)


# ------------------------------------------------------------- attention
def local_heads(cfg, t: TP) -> int:
    """The rank's query heads where whole heads fall to each rank (the
    split-heads branch), else 0: ``wq``'s column blocks of ``n_heads hd /
    model`` columns then cut heads, and every rank runs all of them
    (``rank_columns``)."""
    return 0 if cfg.n_heads % t.size else cfg.n_heads // t.size


def rank_columns(x: torch.Tensor, t: TP, c: int) -> torch.Tensor:
    """This rank's column block ``[r c, (r + 1) c)`` of ``x``'s last dim
    (``x`` itself where it holds ``c`` columns already): the attention
    output of every head narrowed to the rows of ``wo`` the rank holds."""
    if x.shape[-1] == c:
        return x
    return x.narrow(-1, t.rank * c, c)


def kv_heads_local(cfg, t: TP) -> bool:
    """Whether the rank's KV heads are its own columns (n_kv_heads
    divides the model axis); otherwise it works on all of them."""
    return cfg.n_kv_heads % t.size == 0


def kv_for_local(cfg, t: TP, x: torch.Tensor) -> torch.Tensor:
    """The KV heads (dim 2 of ``x``, all ``n_kv_heads`` of them) that the
    rank's query heads use, in an order the GQA grouping of the local
    heads reads: a contiguous slice where the local heads cover whole
    groups or lie in one, else one KV head per query head."""
    hq_l = local_heads(cfg, t)
    G = cfg.n_heads // cfg.n_kv_heads
    q0 = t.rank * hq_l
    lo, hi = q0 // G, (q0 + hq_l - 1) // G + 1
    n = hi - lo
    if hq_l % n == 0 and all((q0 + j) // G - lo == j // (hq_l // n)
                             for j in range(hq_l)):
        return x[:, :, lo:hi].contiguous()
    idx = torch.tensor([(q0 + j) // G for j in range(hq_l)],
                       device=x.device)
    return x.index_select(2, idx)


def gather_blocks(parts, group):
    """Each of ``parts``, this rank's column blocks (..., c_i), gathered
    whole over ``group`` in one collective: (..., n c_i) each, the blocks
    in rank order (autograd: each part's gradient reduce-scattered)."""
    sizes = [p.shape[-1] for p in parts]
    g = coll.gather(torch.cat(parts, -1).unsqueeze(-2), -2, group)
    return [y.reshape(y.shape[:-2] + (-1,)) for y in g.split(sizes, -1)]


# ----------------------------------------------------------------- vocab
def embed_lookup(cfg, E: torch.Tensor, tokens, dtype) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``dtype`` from ``E`` (padded
    vocab, d), whole over ``data``; vocab-parallel where the rank holds a
    block of its rows: the rank's rows, zero elsewhere, summed over
    ``model`` (gather, then cast: the reference's cast-then-gather
    values)."""
    t = tp()
    if t is None or not held_in_part(E, 0, cfg.padded_vocab):
        return E[tokens].to(dtype)
    n = E.shape[0]
    local = tokens.long() - t.rank * n
    inside = (local >= 0) & (local < n)
    x = E[torch.clamp(local, 0, n - 1)].to(dtype)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=dtype,
                                                      device=x.device))
    return coll.reduce_from(x, t.group)


def unembed(cfg, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Logits ``h @ w`` over the padded vocabulary (w (d, V), whole over
    ``data``); on the model axis, the rank's block of them where w holds
    a block of the vocabulary."""
    t = tp()
    if t is not None and held_in_part(w, 1, cfg.padded_vocab):
        h = coll.copy_to(h, t.group)
    return nn.dense(h, w)


def vocab_group(cfg, logits: torch.Tensor):
    """The model group when ``logits`` hold this rank's block of the
    padded vocabulary, else None."""
    t = tp()
    if t is None or logits.shape[-1] == cfg.padded_vocab:
        return None
    return t.group


def argmax_vocab(cfg, logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim of logits whole or held in vocab blocks
    over ``model``: each block's first maximal index, then the lowest
    global index among the blocks holding the largest value, as
    ``torch.argmax`` takes the first maximal index of the whole row."""
    group = vocab_group(cfg, logits)
    if group is None:
        return torch.argmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1)
    vals = torch.gather(logits, -1, idx[..., None])[..., 0].to(torch.float32)
    V = logits.shape[-1]
    vals_all = coll.all_gather(vals[None], 0, group)  # (n, ...)
    idx_all = coll.all_gather(idx[None], 0, group)
    best = vals_all.max(dim=0).values
    owner = torch.argmax((vals_all == best).to(torch.int32), dim=0)
    picked = torch.gather(idx_all, 0, owner[None])[0]
    return picked + owner * V
