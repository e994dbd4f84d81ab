"""Shared architecture config for the ten architectures of the JAX
package (a copy of ``repro.models.config``; the port imports no JAX).

The dtype strings map to torch dtypes in one place: ``torch_dtype``.
``kv_chunk`` sets the running max bf16 P is rounded against, as in the
reference; ``q_chunk`` stays as a field so the configs read the same as
the reference's, and changes no result.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; expected one of "
                         f"{sorted(DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str  # dense | moe | rwkv6 | zamba2 | whisper | llava
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window attention
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_ep: bool = False
    # SSM / RWKV
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    shared_attn_every: int = 6  # zamba2: shared attn block cadence
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_len: int = 1500
    # VLM (llava)
    n_patches: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # full | dots | none
    # chunking (the reference's pure-JAX attention; the port's bf16
    # attention rounds P over kv_chunk, and q_chunk changes nothing)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    ssm_chunk: int = 128

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 128 multiple (the reference shards
        logits over it; the port keeps the same widths)."""
        return -(-self.vocab // 128) * 128

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks; no biases
        or norms), as the reference computes it."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.kind == "moe":
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        elif self.act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.kind == "rwkv6":
            attn = 6 * d * d
            mlp = 2 * d * self.d_ff
        if self.kind == "zamba2":
            d_in = self.ssm_expand * d
            attn = 2 * d * d_in + d_in * d + d_in * (2 * self.ssm_state)
            mlp = 0
        layers = self.n_layers * (attn + mlp)
        if self.encoder_layers:
            layers += (self.encoder_layers * (4 * d * d + mlp)
                       + self.n_layers * 2 * d * d)
        return emb + layers
