"""Deterministic synthetic data (the port of ``repro.data.synthetic``).

Stateless and seedable: batch(step) is a pure function of (seed, step),
so a restart reproduces the stream from the step counter alone.  The
tokens are bitwise the JAX package's: the keys are threefry
(``core/prng``) and ``prng.randint`` is ``jax.random.randint``'s
algorithm; the affine chain runs in int32 as the JAX scan does.

  * ``lm_batch``      — learnable affine-mod token chains;
  * ``uniform_batch`` — i.i.d. tokens.
Federated partitioning: client c draws from fold_in(key, c), with its own
affine parameters (the non-IID knob).

The tokens are made on the CPU (a few thousand draws and a short integer
recursion) and moved to ``device`` (CUDA unless "cpu").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "lm"  # lm | uniform


def _chain(key, batch: int, seq: int, vocab: int, mult: int = 3,
           add: int = 7) -> torch.Tensor:
    t = prng.randint(key, (batch, 1), 0, vocab, device="cpu")
    cols = [t]
    for _ in range(seq - 1):
        t = (mult * t + add) % vocab  # int32, as the JAX scan
        cols.append(t)
    return torch.cat(cols, dim=1)


def _key(cfg: DataConfig, step: int, client: Optional[int]):
    key = prng.fold_in(prng.PRNGKey(cfg.seed), step)
    if client is not None:
        key = prng.fold_in(key, client)
    return key


def lm_batch(cfg: DataConfig, step: int, client: Optional[int] = None,
             device=None) -> Dict[str, torch.Tensor]:
    mult, add = 3, 7
    if client is not None:
        mult, add = 3 + 2 * (client % 5), 7 + client % 11  # non-IID clients
    tokens = _chain(_key(cfg, step, client), cfg.global_batch, cfg.seq_len,
                    cfg.vocab, mult, add)
    return {"tokens": tokens.to(resolve_device(device))}


def uniform_batch(cfg: DataConfig, step: int, client: Optional[int] = None,
                  device=None) -> Dict[str, torch.Tensor]:
    tokens = prng.randint(_key(cfg, step, client),
                          (cfg.global_batch, cfg.seq_len), 0, cfg.vocab,
                          device="cpu")
    return {"tokens": tokens.to(resolve_device(device))}


def batch_fn(cfg: DataConfig):
    return lm_batch if cfg.kind == "lm" else uniform_batch


def with_frontend_stubs(batch: Dict, model_cfg, key=None) -> Dict:
    """Attach the stubs' deterministic embeddings: whisper's audio frames
    ``0.02 * normal(key, (B, encoder_len, d_model))`` as ``frames``,
    llava's vision patches ``0.02 * normal(key, (B, n_patches,
    d_model))`` as ``patches``, with ``key`` PRNGKey(13) by default,
    bitwise the JAX package's, on the tokens' device.  The other kinds
    take tokens alone (the batch is returned as it is)."""
    stub = {"whisper": ("frames", "encoder_len"),
            "llava": ("patches", "n_patches")}.get(model_cfg.kind)
    if stub is not None:
        name, length = stub
        key = prng.PRNGKey(13) if key is None else key
        tokens = batch["tokens"]
        batch = dict(batch)
        batch[name] = 0.02 * prng.normal(
            key, (tokens.shape[0], getattr(model_cfg, length),
                  model_cfg.d_model), device=tokens.device)
    return batch
