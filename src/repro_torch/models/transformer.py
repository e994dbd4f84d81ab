"""Decoder-only transformer (GQA + RoPE), the backbone of qwen1.5 /
starcoder2 / qwen3 / minitron (kind dense), dbrx / phi3.5-moe (kind moe:
the FFN is ``models.moe``) and llava (kind llava: patch embeddings,
projected by ``patch_proj``, precede the text); the port of
``repro.models.transformer``.

``param_specs`` keeps the reference's tree, with layer stacks on a
leading axis; ``Transformer`` holds one ``DecoderLayer`` module per
layer under the reference's parameter names (``attn.wq`` ... ``attn.bv``,
``attn.q_norm``, ``mlp.w_gate`` or ``moe.router`` ... ``moe.w_down``,
``norm1_w``, ...).  The functions take that module where the reference
takes its parameter tree.  ``init_model`` draws random weights layer by
layer, each leaf cast to the compute dtype as it is made.

Full-sequence attention (prefill, training) runs through the flash
kernel (``attention.flash_attention``, with its backward kernel under
autograd); single-token decode through the plain
``attention.decode_attention``.  Weights are cast to the compute dtype
at each use, as in the reference; a model already cast with
``Transformer.to(dtype)`` gives the same values without the casts.

Training takes the parameter tree itself: ``TreeModel`` views a tree in
the reference's layout (the compute copy the train step casts) with the
module's attribute names, each layer's slices unbound from the stacks,
so the gradient reaches the stacked leaves.  ``cfg.remat`` of ``full``
or ``dots`` recomputes each layer's forward in the backward
(``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint`` of the layer scan does; ``dots`` has no separate
policy here and recomputes everything, as ``full`` does.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List

import torch
from torch import nn as tnn
from torch.utils import checkpoint

from repro_torch import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.models import attention, moe, nn, parallel
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.nn import ParamSpec

KINDS = ("dense", "moe", "llava")


def _check_kind(cfg: ModelConfig) -> None:
    if cfg.kind not in KINDS:
        raise ValueError(
            f"kind={cfg.kind!r}: the transformer serves {KINDS}; rwkv6, "
            f"zamba2 and whisper have their own modules")


# ----------------------------------------------------------------- specs
def _stack(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec((n,) + spec.shape, ("layers",) + spec.axes, spec.init,
                     spec.scale, spec.dtype)


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s: Dict[str, ParamSpec] = {
        "wq": ParamSpec((d, hq * hd), ("embed", "heads")),
        "wk": ParamSpec((d, hk * hd), ("embed", "kv")),
        "wv": ParamSpec((d, hk * hd), ("embed", "kv")),
        "wo": ParamSpec((hq * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((hq * hd,), ("heads",), "zeros")
        s["bk"] = ParamSpec((hk * hd,), ("kv",), "zeros")
        s["bv"] = ParamSpec((hk * hd,), ("kv",), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), (None,), "ones")
        s["k_norm"] = ParamSpec((hd,), (None,), "ones")
    return s


def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamSpec((d, f), ("embed", "mlp")),
            "w_up": ParamSpec((d, f), ("embed", "mlp")),
            "w_down": ParamSpec((f, d), ("mlp", "embed")),
        }
    return {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "b_up": ParamSpec((f,), ("mlp",), "zeros"),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
        "b_down": ParamSpec((d,), ("embed",), "zeros"),
    }


def norm_specs(cfg: ModelConfig, name: str) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    s = {f"{name}_w": ParamSpec((d,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        s[f"{name}_b"] = ParamSpec((d,), ("embed",), "zeros")
    return s


def layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_kind(cfg)
    s: Dict[str, Any] = {"attn": attn_specs(cfg)}
    if cfg.kind == "moe":
        s["moe"] = moe.moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg)
    s.update(norm_specs(cfg, "norm1"))
    s.update(norm_specs(cfg, "norm2"))
    return s


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    stacked = nn.map_specs(lambda _, sp: _stack(sp, cfg.n_layers),
                           layer_specs(cfg))
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("vocab_in", "embed"), "embed"),
        "layers": stacked,
    }
    specs.update(norm_specs(cfg, "final"))
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                     ("embed", "vocab"))
    if cfg.kind == "llava":
        specs["patch_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                        ("embed", "embed"))
    return specs


# --------------------------------------------------------------- modules
def _params(tree: Dict[str, torch.Tensor]) -> tnn.ParameterDict:
    return tnn.ParameterDict(
        {k: tnn.Parameter(t, requires_grad=False) for k, t in tree.items()})


class DecoderLayer(tnn.Module):
    """One decoder layer's parameters under the reference's names:
    ``attn`` and ``mlp`` or ``moe`` (ParameterDicts) and ``norm1_w`` /
    ``norm2_w`` (+ ``_b`` for LayerNorm)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, t in tree.items():
            if isinstance(t, dict):
                setattr(self, name, _params(t))
            else:
                setattr(self, name, tnn.Parameter(t, requires_grad=False))


class Transformer(tnn.Module):
    """The model: ``embed``, ``layers`` (one DecoderLayer each),
    ``final_w`` (+ ``final_b``), ``lm_head`` when embeddings are untied,
    ``patch_proj`` for llava.  Built from a parameter tree in the
    reference's layout (layer stacks on a leading axis; each layer's
    slice is copied out), or with ``tree["layers"]`` a list of one tree
    per layer, which is taken as it is."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        _check_kind(cfg)
        self.cfg = cfg
        L = cfg.n_layers

        def layer(i, node):
            if isinstance(node, dict):
                return {k: layer(i, v) for k, v in node.items()}
            if node.shape[0] != L:
                raise ValueError(f"layer stack of {node.shape[0]}, "
                                 f"expected {L}")
            return node[i].clone()

        layers = tree["layers"]
        if not isinstance(layers, list):
            layers = [layer(i, layers) for i in range(L)]
        if len(layers) != L:
            raise ValueError(f"{len(layers)} layers, expected {L}")
        self.layers = tnn.ModuleList([DecoderLayer(t) for t in layers])
        for name, t in tree.items():
            if name != "layers":
                setattr(self, name, tnn.Parameter(t, requires_grad=False))


class TreeModel:
    """A parameter tree in the reference's layout, seen as a
    ``Transformer``: ``embed``, ``final_w`` ... as attributes, and
    ``layers``, one namespace a layer (``attn`` and ``mlp`` or ``moe``
    dicts, the norms as attributes) of the stacks' slices (``unbind``, whose
    backward stacks the layers' gradients in one op)."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        _check_kind(cfg)
        L = cfg.n_layers

        def unbind(node):
            if isinstance(node, dict):
                return {k: unbind(v) for k, v in node.items()}
            if node.shape[0] != L:
                raise ValueError(f"layer stack of {node.shape[0]}, "
                                 f"expected {L}")
            return node.unbind(0)

        def layer(i, node):
            if isinstance(node, dict):
                return {k: layer(i, v) for k, v in node.items()}
            return node[i]

        stacks = unbind(tree["layers"])
        self.layers = [SimpleNamespace(**layer(i, stacks)) for i in range(L)]
        for name, t in tree.items():
            if name != "layers":
                setattr(self, name, t)


# --------------------------------------------------------------- forward
def _norm(cfg: ModelConfig, x, p, name: str):
    """``p``: a DecoderLayer (norm1 / norm2) or the Transformer (final)."""
    if cfg.norm == "layernorm":
        return nn.layer_norm(x, getattr(p, f"{name}_w"),
                             getattr(p, f"{name}_b"))
    return nn.rms_norm(x, getattr(p, f"{name}_w"))


def _attn_tp(cfg: ModelConfig, lp):
    """The model axis when attention is tensor parallel (``wq`` held in
    column blocks: the rank's query heads, or, where the blocks cut heads,
    all heads from the gathered blocks), else None."""
    t = parallel.tp()
    if t is None or not parallel.held_in_part(
            lp.attn["wq"], 1, cfg.n_heads * cfg.hd):
        return None
    return t


def _project_qkv(cfg: ModelConfig, lp: DecoderLayer, x, all_q=False):
    """q (B, T, heads, hd) and k, v (B, T, kv heads, hd).  On the model
    axis (``_attn_tp``) q holds the rank's heads (all of them with
    ``all_q``), and k, v the rank's KV heads when they split, else all of
    them: the column blocks of ``wk`` / ``wv`` then cut heads and are
    gathered, with q's for ``all_q``, in one collective; from a whole
    weight every rank computes all heads, its gradient summed at
    ``copy_to`` (see ``parallel``).  Where ``wq``'s blocks cut query
    heads, q is gathered whole as for ``all_q``."""
    B, T = x.shape[:2]
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    a = lp.attn
    t = _attn_tp(cfg, lp)
    if t is None:
        q = nn.dense(x, a["wq"], a.get("bq")).reshape(B, T, hq, hd)
        k = nn.dense(x, a["wk"], a.get("bk")).reshape(B, T, hk, hd)
        v = nn.dense(x, a["wv"], a.get("bv")).reshape(B, T, hk, hd)
        if cfg.qk_norm:
            q = nn.rms_norm(q, a["q_norm"])
            k = nn.rms_norm(k, a["k_norm"])
        return q, k, v
    all_q = all_q or not parallel.local_heads(cfg, t)
    xm = coll.copy_to(x, t.group)
    q = nn.dense(xm, a["wq"], a.get("bq"))
    split = parallel.held_in_part(a["wk"], 1, hk * hd)
    k, v = (nn.dense(xm, a[w], a.get(b)) if split
            else coll.copy_to(nn.dense(x, a[w], a.get(b)), t.group)
            for w, b in (("wk", "bk"), ("wv", "bv")))
    if split and not parallel.kv_heads_local(cfg, t):
        k, v, *qs = parallel.gather_blocks(
            [k, v] + ([q] if all_q else []), t.group)
        q = qs[0] if all_q else q
    elif all_q:
        q = coll.gather(q, -1, t.group)
    q, k, v = (y.reshape(B, T, -1, hd) for y in (q, k, v))
    if cfg.qk_norm:  # each rank norms its heads: the weight's gradient sums
        q = nn.rms_norm(q, coll.copy_to(a["q_norm"], t.group))
        k = nn.rms_norm(k, coll.copy_to(a["k_norm"], t.group))
    return q, k, v


def _kv_sel(cfg: ModelConfig, t, x):
    """The KV heads the rank's query heads read: ``x`` itself when it
    holds the rank's own heads, or when every rank runs all heads (cut
    query heads; no model axis)."""
    if (t is None or x.shape[2] < cfg.n_kv_heads
            or not parallel.local_heads(cfg, t)):
        return x
    return parallel.kv_for_local(cfg, t, x)


def _out_proj(lp, o, t):
    """The output projection of o (B, T, columns); on the model axis the
    rank's column block of o (``o`` itself where it holds the rank's
    heads) times its rows of ``wo``, summed over ``model``."""
    if t is None:
        return nn.row_parallel(o, lp.attn["wo"], None)
    w = lp.attn["wo"]
    return nn.row_parallel(parallel.rank_columns(o, t, w.shape[0]), w,
                           t.group)


def attn_block(cfg: ModelConfig, lp: DecoderLayer, x, rope, *, window=None):
    """Full-sequence (prefill) attention through the flash kernel.
    Returns (out, (k, v))."""
    cos, sin = rope
    q, k, v = _project_qkv(cfg, lp, x)
    q = nn.apply_rope(q, cos, sin)
    k = nn.apply_rope(k, cos, sin)
    t = _attn_tp(cfg, lp)
    o = attention.flash_attention(q, _kv_sel(cfg, t, k), _kv_sel(cfg, t, v),
                                  causal=True, window=window or cfg.window,
                                  kv_chunk=cfg.kv_chunk)
    B, T = x.shape[:2]
    return _out_proj(lp, o.reshape(B, T, -1), t), (k, v)


def attn_block_decode(cfg: ModelConfig, lp: DecoderLayer, x, cache, *,
                      pos=None, valid_len=None, kv_pos=None, window=None,
                      seq=None):
    """Single-token decode against a cache (B, S, HK, hd).  Returns
    (out, (new_k, new_v)); the new KV is RoPE-rotated at ``pos`` (B, 1),
    which defaults to the cache length S (the naive loop's cache holds
    exactly the S previous positions).  ``seq``: (group, row0) when the
    cache holds rows [row0, row0 + S) of all KV heads, the sequence split
    over the model axis (``registry.decode_state_shardings`` where the KV
    heads do not split): every rank scores all query heads on its rows,
    the softmax is combined across the group, and each keeps its column
    block of the output (its heads, or a block that cuts heads)."""
    k_cache, v_cache = cache
    B = x.shape[0]
    if pos is None:
        pos = torch.full((B, 1), k_cache.shape[1], dtype=torch.int32,
                         device=x.device)
    cos, sin = nn.rope_at(cfg.hd, pos, cfg.rope_theta, x.dtype)
    t = _attn_tp(cfg, lp)
    q, k, v = _project_qkv(cfg, lp, x, all_q=seq is not None)
    q = nn.apply_rope_direct(q, cos, sin)
    k = nn.apply_rope_direct(k, cos, sin)
    if seq is None:
        o = attention.decode_attention(
            q, _kv_sel(cfg, t, k_cache), _kv_sel(cfg, t, v_cache),
            _kv_sel(cfg, t, k), _kv_sel(cfg, t, v), window=window,
            valid_len=valid_len, kv_pos=kv_pos, q_pos=pos[:, 0])
    else:
        group, row0 = seq
        o = attention.decode_attention(
            q, k_cache, v_cache, k, v, window=window, valid_len=valid_len,
            kv_pos=kv_pos, q_pos=pos[:, 0], row0=row0, group=group)
    return _out_proj(lp, o.reshape(B, 1, -1), t), (k, v)


def mlp_block(cfg: ModelConfig, lp: DecoderLayer, x):
    """The MLP; column- then row-parallel over the model axis when the
    rank holds a block of ``d_ff``."""
    m = lp.mlp
    t = parallel.tp()
    group = (t.group if t is not None
             and parallel.held_in_part(m["w_up"], 1, cfg.d_ff) else None)
    if cfg.act == "swiglu":
        return nn.swiglu(x, m["w_gate"], m["w_up"], m["w_down"], group=group)
    return nn.gelu_mlp(x, m["w_up"], m["b_up"], m["w_down"], m["b_down"],
                       group=group)


def _ffn(cfg: ModelConfig, lp: DecoderLayer, x):
    """The layer's FFN: the MLP, or for the moe kind ``moe.moe_block``
    (its tensor- or expert-parallel branch on a model axis)."""
    if cfg.kind == "moe":
        return moe.moe_block(cfg, lp.moe, x)
    return mlp_block(cfg, lp, x)


def _gathered(cfg: ModelConfig, lp):
    """A layer's leaves gathered over the data axis (FSDP), or the layer
    itself without one."""
    if parallel.data_group() is None:
        return lp
    return parallel.gather_layer(lp, layer_specs(cfg))


def _layer(cfg: ModelConfig, lp, h, rope):
    lp = _gathered(cfg, lp)
    a, kv = attn_block(cfg, lp, _norm(cfg, h, lp, "norm1"), rope)
    h = h + a
    h = h + _ffn(cfg, lp, _norm(cfg, h, lp, "norm2"))
    return h, kv


def decoder(cfg: ModelConfig, model: Transformer, x, rope,
            caches: bool = True):
    """Run the layers.  Returns (y, caches): caches is the (k, v) pair
    stacked over layers, (L, B, T, HK, hd) each (for prefill), or None
    without ``caches``.  Under autograd with ``cfg.remat`` other than
    ``none`` each layer is checkpointed: its forward runs again in the
    backward."""
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    h = x
    for lp in model.layers:
        if remat and not caches:
            h = checkpoint.checkpoint(
                lambda hh, lp=lp: _layer(cfg, lp, hh, rope)[0], h,
                use_reentrant=False)
            continue
        h, (k, v) = _layer(cfg, lp, h, rope)
        if caches:
            ks.append(k)
            vs.append(v)
    if not caches:
        return h, None
    return h, (torch.stack(ks), torch.stack(vs))


def seq_positions(x, caches, seq):
    """The new token's position (B, 1) for a cache holding exactly the
    previous positions: its rows, times the model axis's ranks for a
    cache split over them (``seq``: (group, row0)), else None (the
    cache's own length)."""
    if seq is None:
        return None
    rows = caches[0].shape[2] * coll.size(seq[0])
    return torch.full((x.shape[0], 1), rows, dtype=torch.int32,
                      device=x.device)


def decoder_decode(cfg: ModelConfig, model: Transformer, x, caches,
                   seq=None):
    """Single-token decode through the layers; caches: stacked
    (L, B, S, HK, hd) pair holding exactly the S previous positions (with
    ``seq``, (group, row0): rows [row0, row0 + S) of them, the sequence
    split over the model axis, ``registry.decode_state_shardings``).
    Returns (y, new_kv stacked (L, B, 1, HK, hd)); the caller appends."""
    k_all, v_all = caches
    h = x
    nks, nvs = [], []
    pos = seq_positions(x, caches, seq)
    for i, lp in enumerate(model.layers):
        lp = _gathered(cfg, lp)
        a, (nk, nv) = attn_block_decode(
            cfg, lp, _norm(cfg, h, lp, "norm1"), (k_all[i], v_all[i]),
            pos=pos, window=cfg.window, seq=seq)
        h = h + a
        h = h + _ffn(cfg, lp, _norm(cfg, h, lp, "norm2"))
        nks.append(nk)
        nvs.append(nv)
    return h, (torch.stack(nks), torch.stack(nvs))


def decoder_decode_slots(cfg: ModelConfig, model: Transformer, x, caches,
                         lengths, keep, seq=None):
    """Slot-pool decode: one token per slot against a preallocated cache.
    x: (N, 1, D); caches: stacked (L, N, S_max, HK, hd) pair; lengths
    (N,): valid cache rows per slot (the absolute position of the
    incoming token).

    Unlike the reference, which returns updated copies, the new KV is
    written IN PLACE into ``caches`` at row ``min(lengths, S_max - 1)``
    of each slot; slots with ``keep`` (N,) False get their old row written
    back, so their cache stays bitwise as it was (the engine's
    ``select``).  ``seq``: (group, row0) when the caches hold rows [row0,
    row0 + S) of a sequence of S x group-size rows split over the model
    axis; only the rank holding a slot's row writes it.  Returns (y,
    caches)."""
    k_all, v_all = caches
    N, S = x.shape[0], k_all.shape[2]
    pos = lengths[:, None]
    if seq is None:
        write = torch.clamp(lengths, max=S - 1).long()
    else:
        row0 = seq[1]
        w = torch.clamp(lengths, max=S * coll.size(seq[0]) - 1).long()
        keep = keep & (w >= row0) & (w < row0 + S)
        write = torch.clamp(w - row0, 0, S - 1)
    rows = torch.arange(N, device=x.device)
    h = x
    for i, lp in enumerate(model.layers):
        lp = _gathered(cfg, lp)
        kc, vc = k_all[i], v_all[i]
        a, (nk, nv) = attn_block_decode(
            cfg, lp, _norm(cfg, h, lp, "norm1"), (kc, vc), pos=pos,
            valid_len=lengths, window=cfg.window, seq=seq)
        for cache, new in ((kc, nk[:, 0]), (vc, nv[:, 0])):
            old = cache[rows, write]
            cache[rows, write] = torch.where(keep[:, None, None],
                                             new.to(cache.dtype), old)
        h = h + a
        h = h + _ffn(cfg, lp, _norm(cfg, h, lp, "norm2"))
    return h, caches


def _top(cfg: ModelConfig, model, name: str):
    """A top-level leaf, gathered over the data axis where it is held in
    part."""
    t = getattr(model, name)
    if parallel.data_group() is None:
        return t
    return parallel.gather_leaf(t, param_specs(cfg)[name])


def embed_tokens(cfg: ModelConfig, model: Transformer, tokens, dtype):
    return parallel.embed_lookup(cfg, _top(cfg, model, "embed"), tokens,
                                 dtype)


def unembed(cfg: ModelConfig, model: Transformer, h):
    """Logits over the padded vocabulary; on the model axis, the rank's
    block of it when the weight is held in vocab blocks."""
    w = (_top(cfg, model, "embed").T if cfg.tie_embeddings
         else _top(cfg, model, "lm_head"))
    return parallel.unembed(cfg, h, w)


def final_norm(cfg: ModelConfig, model: Transformer, y):
    if parallel.data_group() is not None:
        model = parallel.gather_layer(model, norm_specs(cfg, "final"))
    return _norm(cfg, y, model, "final")


def forward(cfg: ModelConfig, model: Transformer, tokens, *, patches=None,
            last_only: bool = False, caches: bool = True):
    """Prefill / training forward -> (logits, caches).  For llava,
    ``patches`` (B, P, D) projected by ``patch_proj`` precede the text
    (logits and caches then cover P + T positions).  ``last_only``
    computes logits for the final position only; without ``caches`` the
    KV caches are not kept (training) and None is returned for them."""
    dtype = torch_dtype(cfg.compute_dtype)
    x = embed_tokens(cfg, model, tokens, dtype)
    if cfg.kind == "llava" and patches is not None:
        proj = nn.dense(patches.to(dtype), _top(cfg, model, "patch_proj"))
        x = torch.cat([proj, x], dim=1)
    rope = nn.rope_freqs(cfg.hd, x.shape[1] + 1, cfg.rope_theta, dtype,
                         device=x.device)
    y, caches = decoder(cfg, model, x, rope, caches=caches)
    if last_only:
        y = y[:, -1:]
    y = final_norm(cfg, model, y)
    return unembed(cfg, model, y), caches


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device=None, mesh=None, rules=None) -> Transformer:
    """Random weights with the reference's init law from ``generator``
    (on ``device``, CUDA unless "cpu"), layer by layer: each leaf is
    drawn in f32 (a layer's slice of a stack under the stack's law) and
    cast to the compute dtype as it is made, so the peak stays near the
    weights in that dtype.  Draw order: embed, each
    layer's leaves, then the other top-level leaves.  On a ``mesh`` each
    leaf is cut to this rank's block under ``rules`` (default
    SERVE_RESIDENT_RULES) as it is made: the same values as the whole
    model's blocks."""
    specs = param_specs(cfg)
    draw = parallel.leaf_drawer(cfg, generator, resolve_device(device),
                                mesh, rules)

    tree: Dict[str, Any] = {"embed": draw(specs["embed"])}
    tree["layers"] = [nn.map_specs(lambda _, s: draw(s, 1),
                                   specs["layers"])
                      for _ in range(cfg.n_layers)]
    for name, spec in specs.items():
        if name not in tree:
            tree[name] = draw(spec)
    return Transformer(cfg, tree)
