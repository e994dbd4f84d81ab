"""Whisper-small backbone: a transformer encoder-decoder (the port of
``repro.models.whisper``).

The audio front end (log-mel and the convolutions) is a stub, as in the
reference: the batch carries precomputed frame embeddings (B,
encoder_len, d_model) (``data.synthetic.with_frontend_stubs``).  The
encoder adds learned positions ``enc_pos`` (in the compute dtype) and
runs non-causal self-attention, LayerNorm and the GELU MLP; the decoder
runs causal self-attention with RoPE (``transformer.attn_block``), then
cross-attention over the encoder memory, then the MLP.  The unembedding
is tied, ``embed.T`` over the padded vocab, whatever
``cfg.tie_embeddings`` says, as the reference's.  Every attention over a
full sequence goes through ``attention.flash_attention`` (the flash
kernels on the card, with their backward under autograd): the encoder
non-causal over encoder_len keys, the decoder's self-attention causal,
its cross-attention non-causal over the encoder's keys, and the decode
step's cross-attention at one query.

``Whisper`` holds the parameters under the reference's names: ``embed``,
``enc_pos``, ``enc_layers`` and ``dec_layers`` (one
``transformer.DecoderLayer`` a layer: ``attn``, ``mlp`` and for the
decoder ``cross`` ParameterDicts, ``norm1_w`` ...), ``enc_final_w`` /
``_b`` and ``final_w`` / ``_b``.  ``TreeModel`` views a parameter tree
in the reference's layout (layer stacks on a leading axis) the same
way, each layer's slices unbound from the stacks.  ``cfg.remat`` other
than ``none`` recomputes each encoder and decoder layer in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of
each layer scan.

``decode_step`` takes the decoder's self-attention cache (k, v) stacked
(L, B, S, HK, hd), holding exactly the S previous positions, and the
cross-attention's (k, v) stacked (L, B, encoder_len, HK, hd); it returns
the logits and the new token's self K / V, (L, B, 1, HK, hd) each.  As
in the reference, nothing here fills either cache: a caller projects the
cross K / V from ``encode`` with each layer's ``cross.wk`` / ``cross.wv``
(``cross_kv``).

On the mesh each layer is gathered over ``data`` where held in part
(``enc_pos`` too); over ``model`` every attention (the encoder's, the
decoder's self- and cross-attention, the decode step's) runs on the
rank's heads with a row-parallel ``wo`` (all heads, and the rank's
column block of the output, where the model axis cuts heads), the MLPs
column- then row-parallel, and the tied embedding is vocab-parallel: the
lookup and the unembedding read, and send their gradients to, the rank's
vocab block.  Its caches hold the rank's heads (all heads where they are
cut).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List

import torch
from torch import nn as tnn
from torch.utils import checkpoint

from repro_torch import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.models import attention, nn, parallel, transformer
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.nn import ParamSpec

STACKS = ("enc_layers", "dec_layers")


def _check_kind(cfg: ModelConfig) -> None:
    if cfg.kind != "whisper":
        raise ValueError(f"kind={cfg.kind!r} is not whisper")


def _depth(cfg: ModelConfig, stack: str) -> int:
    return cfg.encoder_layers if stack == "enc_layers" else cfg.n_layers


# ----------------------------------------------------------------- specs
def _enc_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {"attn": transformer.attn_specs(cfg),
                         "mlp": transformer.mlp_specs(cfg)}
    s.update(transformer.norm_specs(cfg, "norm1"))
    s.update(transformer.norm_specs(cfg, "norm2"))
    return s


def _dec_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {"attn": transformer.attn_specs(cfg),
                         "cross": transformer.attn_specs(cfg),
                         "mlp": transformer.mlp_specs(cfg)}
    for name in ("norm1", "norm_cross", "norm2"):
        s.update(transformer.norm_specs(cfg, name))
    return s


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_kind(cfg)
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, d), ("vocab_in", "embed"),
                           "embed"),
        "enc_pos": ParamSpec((cfg.encoder_len, d), (None, "embed"), "embed"),
        "enc_layers": nn.map_specs(
            lambda _, s: transformer._stack(s, cfg.encoder_layers),
            _enc_layer_specs(cfg)),
        "dec_layers": nn.map_specs(
            lambda _, s: transformer._stack(s, cfg.n_layers),
            _dec_layer_specs(cfg)),
    }
    specs.update(transformer.norm_specs(cfg, "enc_final"))
    specs.update(transformer.norm_specs(cfg, "final"))
    return specs


# --------------------------------------------------------------- modules
def _unbind(cfg: ModelConfig, tree: Dict[str, Any], stack: str,
            take) -> List[Dict[str, Any]]:
    """The layers of ``tree[stack]`` (stacks on a leading axis) as a list
    of per-layer trees, each leaf ``take(stack_leaf)[i]``."""
    L = _depth(cfg, stack)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if node.shape[0] != L:
            raise ValueError(f"{stack} stack of {node.shape[0]}, "
                             f"expected {L}")
        return take(node)

    stacks = rec(tree[stack])

    def layer(i, node):
        if isinstance(node, dict):
            return {k: layer(i, v) for k, v in node.items()}
        return node[i]

    return [layer(i, stacks) for i in range(L)]


class Whisper(tnn.Module):
    """The model, built from a parameter tree in the reference's layout
    (each layer's slice copied out of its stack), or with ``enc_layers``
    and ``dec_layers`` lists of per-layer trees, taken as they are."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        _check_kind(cfg)
        self.cfg = cfg
        for stack in STACKS:
            layers = tree[stack]
            if not isinstance(layers, list):
                layers = _unbind(cfg, tree, stack,
                                 lambda t: [x.clone() for x in t])
            if len(layers) != _depth(cfg, stack):
                raise ValueError(f"{len(layers)} {stack}, expected "
                                 f"{_depth(cfg, stack)}")
            setattr(self, stack, tnn.ModuleList(
                [transformer.DecoderLayer(t) for t in layers]))
        for name, t in tree.items():
            if name not in STACKS:
                setattr(self, name, tnn.Parameter(t, requires_grad=False))


class TreeModel:
    """A parameter tree in the reference's layout seen as a ``Whisper``:
    ``enc_layers`` / ``dec_layers`` namespaces of the stacks' slices
    (``unbind``, whose backward stacks the layers' gradients in one op),
    the other leaves as attributes."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        _check_kind(cfg)
        for stack in STACKS:
            setattr(self, stack, [
                SimpleNamespace(**lp)
                for lp in _unbind(cfg, tree, stack, lambda t: t.unbind(0))])
        for name, t in tree.items():
            if name not in STACKS:
                setattr(self, name, t)


# --------------------------------------------------------------- forward
_norm = transformer._norm


def _run(cfg: ModelConfig, fn, h):
    """``fn(h)``, recomputed in the backward under ``cfg.remat``."""
    if cfg.remat != "none" and torch.is_grad_enabled():
        return checkpoint.checkpoint(fn, h, use_reentrant=False)
    return fn(h)


def _enc_layer(cfg: ModelConfig, lp, h):
    lp = parallel.gather_layer(lp, _enc_layer_specs(cfg))
    q, k, v = transformer._project_qkv(cfg, lp, _norm(cfg, h, lp, "norm1"))
    o = attention.flash_attention(q, k, v, causal=False,
                                  kv_chunk=cfg.kv_chunk)
    B, T = h.shape[:2]
    t = transformer._attn_tp(cfg, lp)
    h = h + transformer._out_proj(lp, o.reshape(B, T, -1), t)
    return h + transformer.mlp_block(cfg, lp, _norm(cfg, h, lp, "norm2"))


def _top(cfg: ModelConfig, model, name: str):
    return parallel.gather_leaf(getattr(model, name), param_specs(cfg)[name])


def _final_norm(cfg: ModelConfig, model, x, name: str):
    """The ``enc_final`` or ``final`` norm, its leaves gathered over
    ``data`` where held in part."""
    return _norm(cfg, x, parallel.gather_layer(
        model, transformer.norm_specs(cfg, name)), name)


def encode(cfg: ModelConfig, model, frames):
    """frames (B, encoder_len, d) stub embeddings -> the encoder memory
    (B, encoder_len, d) in the compute dtype."""
    dtype = torch_dtype(cfg.compute_dtype)
    x = frames.to(dtype) + _top(cfg, model, "enc_pos").to(dtype)[None]
    for lp in model.enc_layers:
        x = _run(cfg, lambda h, lp=lp: _enc_layer(cfg, lp, h), x)
    return _final_norm(cfg, model, x, "enc_final")


def _cross_tp(cfg: ModelConfig, lp):
    """The model axis when the cross-attention is tensor parallel (its
    ``wq`` held in column blocks: the rank's heads, or all heads where the
    blocks cut them), else None."""
    t = parallel.tp()
    if t is None or not parallel.held_in_part(
            lp.cross["wq"], 1, cfg.n_heads * cfg.hd):
        return None
    if not parallel.held_in_part(lp.cross["wk"], 1, cfg.n_kv_heads * cfg.hd):
        raise NotImplementedError(
            "whisper's cross-attention on a model axis splits its KV heads "
            "with its query heads")
    return t


def cross_kv(cfg: ModelConfig, lp, memory):
    """The cross-attention's K / V over the encoder memory (B, S, d) ->
    (B, S, heads, hd) each: column-parallel on the model axis (the
    rank's heads; all heads where the column blocks cut them, the blocks
    gathered in one collective, as the reference's decode state holds
    them replicated)."""
    B, S = memory.shape[:2]
    a = lp.cross
    t = _cross_tp(cfg, lp)
    if t is not None:
        memory = coll.copy_to(memory, t.group)
    k, v = nn.dense(memory, a["wk"]), nn.dense(memory, a["wv"])
    if t is not None and not parallel.local_heads(cfg, t):
        k, v = parallel.gather_blocks([k, v], t.group)
    return k.reshape(B, S, -1, cfg.hd), v.reshape(B, S, -1, cfg.hd)


def _cross_out(cfg: ModelConfig, lp, x, k, v):
    """The cross-attention of decoder states x (B, T, d) over K / V:
    column-parallel ``wq`` and row-parallel ``wo`` on the model axis;
    where the column blocks cut heads, q gathered whole, attention over
    all heads, and the rank's column block of the output into ``wo``."""
    B, T = x.shape[:2]
    a = lp.cross
    t = _cross_tp(cfg, lp)
    if t is not None:
        x = coll.copy_to(x, t.group)
    q = nn.dense(x, a["wq"])
    if t is not None and not parallel.local_heads(cfg, t):
        if k.shape[1] < cfg.encoder_len:
            raise NotImplementedError(
                "cross K / V split over the sequence: cut query heads run "
                "on the whole encoder memory")
        q = coll.gather(q, -1, t.group)
    o = attention.flash_attention(q.reshape(B, T, -1, cfg.hd), k, v,
                                  causal=False, kv_chunk=cfg.kv_chunk)
    o = o.reshape(B, T, -1)
    if t is None:
        return nn.row_parallel(o, a["wo"], None)
    return nn.row_parallel(parallel.rank_columns(o, t, a["wo"].shape[0]),
                           a["wo"], t.group)


def _cross_attend(cfg: ModelConfig, lp, x, memory):
    """Cross-attention of decoder states x over the encoder memory."""
    k, v = cross_kv(cfg, lp, memory)
    return _cross_out(cfg, lp, x, k, v)


def _dec_layer(cfg: ModelConfig, lp, h, memory, rope):
    """One decoder layer -> (h, (k, v)): its self-attention's RoPE-rotated
    K / V, (B, T, HK, hd) each (the rank's heads on the model axis),
    beside the output."""
    lp = parallel.gather_layer(lp, _dec_layer_specs(cfg))
    a, kv = transformer.attn_block(cfg, lp, _norm(cfg, h, lp, "norm1"),
                                   rope)
    h = h + a
    h = h + _cross_attend(cfg, lp, _norm(cfg, h, lp, "norm_cross"), memory)
    h = h + transformer.mlp_block(cfg, lp, _norm(cfg, h, lp, "norm2"))
    return h, kv


def _embed(cfg: ModelConfig, model, tokens):
    return parallel.embed_lookup(cfg, _top(cfg, model, "embed"), tokens,
                                 torch_dtype(cfg.compute_dtype))


def _logits(cfg: ModelConfig, model, x):
    """The final norm and the tied unembedding ``embed.T`` (the rank's
    vocab block on the model axis, whose gradient lands on the same
    block of ``embed`` as the lookup's)."""
    x = _final_norm(cfg, model, x, "final")
    return parallel.unembed(cfg, x, _top(cfg, model, "embed").T)


def forward(cfg: ModelConfig, model, tokens, frames,
            last_only: bool = False):
    """Training / prefill: the decoder over tokens (B, T) with
    cross-attention on the encoded frames -> logits (B, T, V), or
    (B, 1, V) with ``last_only``."""
    dtype = torch_dtype(cfg.compute_dtype)
    memory = encode(cfg, model, frames)
    x = _embed(cfg, model, tokens)
    rope = nn.rope_freqs(cfg.hd, x.shape[1] + 1, cfg.rope_theta, dtype,
                         device=x.device)
    for lp in model.dec_layers:
        x = _run(cfg, lambda h, lp=lp: _dec_layer(cfg, lp, h, memory,
                                                  rope)[0], x)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, model, x)


def decode_step(cfg: ModelConfig, model, tokens, self_cache, cross_kv,
                seq=None):
    """One-token decode: tokens (B, 1); self_cache (k, v) stacked (L, B,
    S, HK, hd), the S previous positions (with ``seq``, (group, row0):
    rows [row0, row0 + S) of them, split over the model axis); cross_kv
    (k, v) stacked (L, B, encoder_len, HK, hd) (the rank's heads on the
    model axis, or all of them where the axis cuts heads, as
    ``registry.decode_state_shardings`` places them).  Returns (logits
    (B, 1, V), new (k, v) stacked (L, B, 1, HK, hd)); the caller
    appends."""
    x = _embed(cfg, model, tokens)
    k_all, v_all = self_cache
    ck_all, cv_all = cross_kv
    nks, nvs = [], []
    h = x
    pos = transformer.seq_positions(x, self_cache, seq)
    for i, lp in enumerate(model.dec_layers):
        lp = parallel.gather_layer(lp, _dec_layer_specs(cfg))
        a, (nk, nv) = transformer.attn_block_decode(
            cfg, lp, _norm(cfg, h, lp, "norm1"), (k_all[i], v_all[i]),
            pos=pos, seq=seq)
        h = h + a
        h = h + _cross_out(cfg, lp, _norm(cfg, h, lp, "norm_cross"),
                           ck_all[i], cv_all[i])
        h = h + transformer.mlp_block(cfg, lp, _norm(cfg, h, lp, "norm2"))
        nks.append(nk)
        nvs.append(nv)
    return _logits(cfg, model, h), (torch.stack(nks), torch.stack(nvs))


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device=None, mesh=None, rules=None) -> Whisper:
    """Random weights with the reference's init law from ``generator``
    (on ``device``, CUDA unless "cpu"), layer by layer: each leaf drawn in
    f32 (a layer's slice of a stack under the stack's law) and cast to
    the compute dtype as it is made.  Draw order: embed, enc_pos, the
    encoder's layers, the decoder's, then the final norms.  On a ``mesh``
    each leaf is this rank's block under ``rules``
    (``parallel.leaf_drawer``)."""
    specs = param_specs(cfg)
    draw = parallel.leaf_drawer(cfg, generator, resolve_device(device),
                                mesh, rules)
    tree: Dict[str, Any] = {name: draw(specs[name])
                            for name in ("embed", "enc_pos")}
    for stack in STACKS:
        tree[stack] = [nn.map_specs(lambda _, s: draw(s, 1), specs[stack])
                       for _ in range(_depth(cfg, stack))]
    for name, spec in specs.items():
        if name not in tree:
            tree[name] = draw(spec)
    return Whisper(cfg, tree)
