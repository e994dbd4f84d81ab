"""Naive one-batch generation loop, kept as the engine's correctness
oracle (the port of ``repro.serve.oracle``, for the transformer's kinds,
rwkv6 and zamba2).

Every request in one batch, decode steps in lockstep, the dense cache
*grows* by one row per step and never drops a position; rwkv6 and zamba2
run one serve call per prompt token and carry their recurrent state
(zamba2's KV rings of ``min(window, P + n_tokens)`` rows, as the
reference's).  ``ServeEngine``
at full occupancy must be token-identical to this loop: same RoPE
(``rope_at`` positions), same greedy argmax + clip, and the engine's
padded cache rows contribute exact-zero probability.  On a mesh (the
active one, ``meshctx.use_mesh``) the loop runs tensor parallel, its
growing cache holding the rank's KV heads, or all of them where they do
not split; rwkv6's and zamba2's state holds the rank's blocks of it
(``registry.decode_state_shardings`` over 'model' alone: every rank runs
the whole batch).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.dist import meshctx
from repro_torch.models import parallel, registry
from repro_torch.models.config import ModelConfig


def _greedy(cfg: ModelConfig, logits) -> torch.Tensor:
    # the vocabulary may be held in blocks over the mesh's model axis
    tok = parallel.argmax_vocab(cfg, logits[:, -1:]).to(torch.int32)
    return torch.clamp(tok, 0, cfg.vocab - 1)


@torch.no_grad()
def naive_generate(cfg: ModelConfig, model, prompts: Dict,
                   n_tokens: int) -> torch.Tensor:
    """Greedy-decode ``n_tokens`` per sequence (the prefill argmax plus
    n_tokens - 1 decode steps).  ``prompts``: batch dict with tokens
    (B, P) [+ patches for llava] on the model's device.  Returns
    (B, n_tokens) int32."""
    if cfg.kind == "whisper":
        raise NotImplementedError(
            "whisper serving needs an encoder pass + cross-KV plumbing; "
            "not covered by the naive oracle")
    serve = registry.serve_fn(cfg)
    if cfg.kind in registry.DENSE_KINDS:
        logits, (k, v) = registry.prefill_fn(cfg)(model, prompts)
        cache = {"k": k, "v": v}
    else:  # recurrent: one serve call per prompt token
        tokens = prompts["tokens"]
        cache = registry.init_decode_state(cfg, tokens.shape[0],
                                           tokens.shape[1] + n_tokens,
                                           tokens.device,
                                           meshctx.active_mesh(),
                                           axes=("model",))
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = serve(model, {"tokens": tokens[:, t:t + 1]},
                                  cache)
    tok = _greedy(cfg, logits)
    out = [tok]
    for _ in range(n_tokens - 1):
        logits, new = serve(model, {"tokens": tok}, cache)
        if cfg.kind in registry.DENSE_KINDS:
            # grow; never drop a position
            cache = {"k": torch.cat([cache["k"], new[0]], dim=2),
                     "v": torch.cat([cache["v"], new[1]], dim=2)}
        else:
            cache = new
        tok = _greedy(cfg, logits)
        out.append(tok)
    return torch.cat(out, dim=1)
