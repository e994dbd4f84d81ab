"""Model API over the architecture families (the port of
``repro.models.registry``), for the transformer's kinds (dense, moe,
llava), rwkv6, zamba2 and whisper:

  param_specs(cfg)                    -> ParamSpec tree
  logits_fn(cfg, model, batch)        -> (B, T, V) logits
  loss_fn(cfg)(params, batch)         -> scalar NLL (training)
  prefill_fn(cfg)(model, batch)       -> (last-token logits, caches)
  serve_fn(cfg)(model, batch, cache)  -> (logits, new kv)
  decode_state_specs(cfg, B, S)       -> cache tree of meta tensors
  decode_state_shardings(cfg, mesh, B, S) -> the caches' placement
  init_decode_state(cfg, B, S, device)-> fresh cache tree
  init_model(cfg, generator, device, mesh, rules)
                                      -> random model in the compute dtype
                                         (on a mesh, the rank's blocks)

``batch`` is a dict with tokens (B, T) int, for llava patches (B, P,
D) and for whisper frames (B, encoder_len, D)
(``data.synthetic.with_frontend_stubs``): llava's logits are the text
positions'.  ``model`` is a ``transformer.Transformer``, an
``rwkv6.Rwkv6``, a ``zamba2.Zamba2`` or a ``whisper.Whisper`` (or its
family's ``TreeModel``);
``params`` is a parameter tree in the reference's layout.  rwkv6's and
zamba2's prefill is their scan path (``forward(last_only=True)``), which
returns ``(logits, None)``; their decode cache is their recurrent state
(``rwkv6.init_state``; ``zamba2.init_state``, whose KV rings are
``min(window, seq_len)`` rows).  whisper's prefill is its forward over
the frames and tokens (``last_only=True``) and returns ``(logits,
None)``, as the reference's; its decode cache holds the decoder's self
K / V (``k``, ``v``: (L, B, seq_len, HK, hd), every row a previous
position) and the cross-attention's (``cross_k``, ``cross_v``: (L, B,
encoder_len, HK, hd)), which nothing here fills, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.models import (nn, parallel, rwkv6, transformer, whisper,
                                zamba2)
from repro_torch.models.config import ModelConfig, torch_dtype

DENSE_KINDS = transformer.KINDS
KINDS = DENSE_KINDS + ("rwkv6", "zamba2", "whisper")
# the families with their own modules: the recurrent ones (prefill on the
# scan path) and whisper
_FAMILIES = {"rwkv6": rwkv6, "zamba2": zamba2, "whisper": whisper}


def _known(cfg: ModelConfig) -> None:
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown kind {cfg.kind!r}; expected one of "
                         f"{KINDS}")


def param_specs(cfg: ModelConfig):
    _known(cfg)
    return _FAMILIES.get(cfg.kind, transformer).param_specs(cfg)


def init_model(cfg: ModelConfig, generator: torch.Generator, device=None,
               mesh=None, rules=None):
    """Random weights with the reference's init law, layer by layer in
    the compute dtype (each family's ``init_model``); on a mesh each
    rank's blocks under ``rules`` (default SERVE_RESIDENT_RULES;
    EP_PARAM_RULES places the moe experts over ``model``)."""
    _known(cfg)
    return _FAMILIES.get(cfg.kind, transformer).init_model(
        cfg, generator, device, mesh, rules)


def tree_model(cfg: ModelConfig, params):
    """A parameter tree seen as its family's model (a model is returned
    as it is)."""
    if not isinstance(params, dict):
        return params
    return _FAMILIES.get(cfg.kind, transformer).TreeModel(cfg, params)


def logits_fn(cfg: ModelConfig, model, batch) -> torch.Tensor:
    _known(cfg)
    if cfg.kind == "whisper":
        return whisper.forward(cfg, model, batch["tokens"], batch["frames"])
    if cfg.kind in _FAMILIES:
        return _FAMILIES[cfg.kind].forward(cfg, model, batch["tokens"])
    if cfg.kind == "llava":
        patches = batch["patches"]
        logits, _ = transformer.forward(cfg, model, batch["tokens"],
                                        patches=patches, caches=False)
        return logits[:, patches.shape[1]:]  # text positions only
    logits, _ = transformer.forward(cfg, model, batch["tokens"],
                                    caches=False)
    return logits


def loss_fn(cfg: ModelConfig) -> Callable:
    """loss(params, batch): next-token NLL, ``logits[:, :-1]`` against
    ``tokens[:, 1:]``; ``params`` is a parameter tree (a dict, seen
    through its family's ``TreeModel``) or a model."""
    _known(cfg)

    def loss(params, batch):
        model = tree_model(cfg, params)
        logits = logits_fn(cfg, model, batch)
        tokens = batch["tokens"]
        return nn.cross_entropy_loss(
            logits[:, :-1], tokens[:, 1:],
            group=parallel.vocab_group(cfg, logits))

    return loss


# ----------------------------------------------------------------- serving
def decode_state_specs(cfg: ModelConfig, batch: int,
                       seq_len: int) -> Dict[str, torch.Tensor]:
    """The decode cache tree as meta tensors (shape and dtype, no
    allocation); rwkv6's is its recurrent state, whatever ``seq_len``;
    zamba2's KV rings hold ``min(window, seq_len)`` rows."""
    _known(cfg)
    if cfg.kind == "rwkv6":
        return rwkv6.init_state(cfg, batch, "meta")
    if cfg.kind == "zamba2":
        return zamba2.init_state(cfg, batch, _ring(cfg, seq_len), "meta")
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.hd)
    dt = torch_dtype(cfg.compute_dtype)
    specs = {k: torch.empty(shape, dtype=dt, device="meta")
             for k in ("k", "v")}
    if cfg.kind == "whisper":
        cross = (cfg.n_layers, batch, cfg.encoder_len, cfg.n_kv_heads,
                 cfg.hd)
        specs.update({k: torch.empty(cross, dtype=dt, device="meta")
                      for k in ("cross_k", "cross_v")})
    return specs


def decode_state_shardings(cfg: ModelConfig, mesh, batch: int,
                           seq_len: int):
    """NamedSharding tree for the decode caches, per family (the
    reference's placement).

    KV caches (L, B, S, HK, hd) of the transformer's kinds and whisper
    (its self and cross caches) split their heads over 'model' when HK
    divides it, otherwise the *sequence* dim (decode attention scores
    each rank's rows and combines the softmax across 'model';
    ``transformer.attn_block_decode(seq=)``), otherwise stay replicated.
    rwkv6's ``wkv`` (L, B, H, K, K) splits its heads and the shift tokens
    (L, B, 1, D) their D; zamba2's SSD states and KV rings split their
    heads, ``kv_pos`` and ``pos`` only their slots.  The slots split over
    the batch axes as ``batch_spec`` splits them."""
    from repro_torch.dist import sharding as shd

    mdl = mesh.shape.get("model", 1)
    P = shd.P

    def b_axis(bsz):
        return shd.batch_spec(mesh, 1, bsz)[0]

    def kv_spec(shape):  # (L, B, S, HK, hd)
        _, B, S, HK, _ = shape
        if HK % mdl == 0:
            return P(None, b_axis(B), None, "model", None)
        if S % mdl == 0:
            return P(None, b_axis(B), "model", None, None)
        return P(None, b_axis(B))

    def split(n):
        return "model" if n % mdl == 0 else None

    def rwkv6_spec(k, s):
        if k == "wkv":  # (L, B, H, K, K)
            return P(None, b_axis(s[1]), split(s[2]), None, None)
        return P(None, b_axis(s[1]), None, split(s[3]))  # (L, B, 1, D)

    def zamba2_spec(k, s):
        if k == "ssm_groups":  # (G, pg, B, H, P, N)
            return P(None, None, b_axis(s[2]), split(s[3]), None, None)
        if k == "ssm_tail":  # (tail, B, H, P, N)
            return P(None, b_axis(s[1]), split(s[2]), None, None)
        if k in ("attn_k", "attn_v"):  # (G, B, W, HK, hd)
            return P(None, b_axis(s[1]), None, split(s[3]), None)
        if k == "kv_pos":  # (B, W)
            return P(b_axis(s[0]), None)
        return P(b_axis(s[0]))  # pos (B,)

    spec = {"rwkv6": rwkv6_spec, "zamba2": zamba2_spec}.get(
        cfg.kind, lambda k, s: kv_spec(s))
    return {k: shd.NamedSharding(mesh, spec(k, tuple(v.shape)))
            for k, v in decode_state_specs(cfg, batch, seq_len).items()}


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None, mesh=None,
                      axes=None) -> Dict[str, torch.Tensor]:
    """A fresh decode cache on ``device`` (CUDA unless "cpu"): zeros, and
    zamba2's empty ring rows at position -1.  On a ``mesh`` of more than
    one rank, each leaf is this rank's block under
    ``decode_state_shardings`` (split only over the mesh axes in
    ``axes``, when given: ``("model",)`` for a batch every rank runs
    whole)."""
    from repro_torch.dist import sharding as shd

    dev = resolve_device(device)
    shards = (decode_state_shardings(cfg, mesh, batch, seq_len)
              if mesh is not None and mesh.size > 1 else None)
    out = {}
    for k, s in decode_state_specs(cfg, batch, seq_len).items():
        shape = (s.shape if shards is None else
                 shd.shard_shape(s.shape, shards[k].spec, mesh, axes))
        fill = -1 if k == "kv_pos" else 0
        out[k] = torch.full(shape, fill, dtype=s.dtype, device=dev)
    return out


def _ring(cfg: ModelConfig, seq_len: int) -> int:
    """zamba2's KV ring rows for a horizon of ``seq_len`` positions."""
    return min(seq_len, cfg.window or seq_len)


def serve_fn(cfg: ModelConfig) -> Callable:
    """serve(model, batch{tokens (B, 1)}, cache, seq=None) -> (logits, new
    kv); for rwkv6 and zamba2 (logits, new state); whisper's new kv is
    the decoder's self K / V (the cross K / V stay as they are).
    ``seq``: (model group, row0) when the (self) K / V cache holds rows
    [row0, row0 + S) of a sequence split over the model axis
    (``decode_state_shardings``; the transformer's kinds and whisper)."""
    _known(cfg)

    def serve(model, batch, cache, seq=None):
        if cfg.kind == "whisper":
            return whisper.decode_step(
                cfg, model, batch["tokens"], (cache["k"], cache["v"]),
                (cache["cross_k"], cache["cross_v"]), seq=seq)
        if cfg.kind in _FAMILIES:
            return _FAMILIES[cfg.kind].decode(cfg, model, batch["tokens"],
                                              cache)
        dtype = torch_dtype(cfg.compute_dtype)
        x = transformer.embed_tokens(cfg, model, batch["tokens"], dtype)
        y, new_kv = transformer.decoder_decode(
            cfg, model, x, (cache["k"], cache["v"]), seq=seq)
        y = transformer.final_norm(cfg, model, y)
        return transformer.unembed(cfg, model, y), new_kv

    return serve


def prefill_fn(cfg: ModelConfig) -> Callable:
    """prefill(model, batch) -> (last-position logits, caches); llava's
    caches cover its patch positions too; rwkv6 and zamba2 run their scan
    path and whisper its forward, and return (logits, None), as the
    reference."""
    _known(cfg)

    def prefill(model, batch) -> Any:
        if cfg.kind == "whisper":
            return whisper.forward(cfg, model, batch["tokens"],
                                   batch["frames"], last_only=True), None
        if cfg.kind in _FAMILIES:
            return _FAMILIES[cfg.kind].forward(cfg, model, batch["tokens"],
                                               last_only=True), None
        patches = batch["patches"] if cfg.kind == "llava" else None
        return transformer.forward(cfg, model, batch["tokens"],
                                   patches=patches, last_only=True)

    return prefill
