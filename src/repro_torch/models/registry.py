"""Model API over the architecture families (the port of
``repro.models.registry``), for the transformer's kinds (dense, moe,
llava):

  param_specs(cfg)                    -> ParamSpec tree
  logits_fn(cfg, model, batch)        -> (B, T, V) logits
  loss_fn(cfg)(params, batch)         -> scalar NLL (training)
  prefill_fn(cfg)(model, batch)       -> (last-token logits, caches)
  serve_fn(cfg)(model, batch, cache)  -> (logits, new kv)
  decode_state_specs(cfg, B, S)       -> cache tree of meta tensors
  init_decode_state(cfg, B, S, device)-> zero cache tree

``batch`` is a dict with tokens (B, T) int, and for llava patches
(B, P, D) (``data.synthetic.with_frontend_stubs``): the logits are the
text positions'.  ``model`` is a ``transformer.Transformer`` (or a
``transformer.TreeModel``); ``params`` is a parameter tree in the
reference's layout.  rwkv6, zamba2 and whisper are not ported yet and
raise NotImplementedError (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.models import nn, transformer
from repro_torch.models.config import ModelConfig, torch_dtype

DENSE_KINDS = transformer.KINDS


def _dense(cfg: ModelConfig) -> None:
    if cfg.kind not in DENSE_KINDS:
        raise NotImplementedError(
            f"kind={cfg.kind!r} is not ported to repro_torch yet (see "
            f"ROADMAP.md, Queue 1)")


def param_specs(cfg: ModelConfig):
    _dense(cfg)
    return transformer.param_specs(cfg)


def logits_fn(cfg: ModelConfig, model, batch) -> torch.Tensor:
    _dense(cfg)
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
    through ``transformer.TreeModel``) or a model."""
    _dense(cfg)

    def loss(params, batch):
        model = (transformer.TreeModel(cfg, params)
                 if isinstance(params, dict) else params)
        logits = logits_fn(cfg, model, batch)
        tokens = batch["tokens"]
        return nn.cross_entropy_loss(logits[:, :-1], tokens[:, 1:])

    return loss


# ----------------------------------------------------------------- serving
def decode_state_specs(cfg: ModelConfig, batch: int,
                       seq_len: int) -> Dict[str, torch.Tensor]:
    """The decode cache tree as meta tensors (shape and dtype, no
    allocation)."""
    _dense(cfg)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.hd)
    dt = torch_dtype(cfg.compute_dtype)
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k in ("k", "v")}


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None) -> Dict[str, torch.Tensor]:
    """A fresh (zero) decode cache on ``device`` (CUDA unless "cpu")."""
    dev = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in decode_state_specs(cfg, batch, seq_len).items()}


def serve_fn(cfg: ModelConfig) -> Callable:
    """serve(model, batch{tokens (B, 1)}, cache) -> (logits, new kv)."""
    _dense(cfg)

    def serve(model, batch, cache):
        dtype = torch_dtype(cfg.compute_dtype)
        x = transformer.embed_tokens(cfg, model, batch["tokens"], dtype)
        y, new_kv = transformer.decoder_decode(cfg, model, x,
                                               (cache["k"], cache["v"]))
        y = transformer._norm(cfg, y, model, "final")
        return transformer.unembed(cfg, model, y), new_kv

    return serve


def prefill_fn(cfg: ModelConfig) -> Callable:
    """prefill(model, batch) -> (last-position logits, caches); llava's
    caches cover its patch positions too."""
    _dense(cfg)

    def prefill(model, batch) -> Any:
        patches = batch["patches"] if cfg.kind == "llava" else None
        return transformer.forward(cfg, model, batch["tokens"],
                                   patches=patches, last_only=True)

    return prefill
