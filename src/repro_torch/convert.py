"""Carry state across from the JAX package: its parameters and keys,
exported as numpy arrays, become the port's tensors, keys and models."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.rwkv6 import Rwkv6
from repro_torch.models.transformer import Transformer
from repro_torch.models.whisper import Whisper
from repro_torch.models.zamba2 import Zamba2

__all__ = ["params_from_numpy", "key_from_numpy", "transformer_from_numpy",
           "rwkv6_from_numpy", "zamba2_from_numpy", "whisper_from_numpy"]


def params_from_numpy(tree: Any, device=None) -> Any:
    """A tree (dict / list / tuple) of numpy arrays -> the same tree of
    tensors on ``device`` (CUDA unless "cpu"), dtypes kept."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def key_from_numpy(key_data) -> torch.Tensor:
    """A jax key's ``(..., 2)`` uint32 data -> the port's int64 key."""
    data = np.asarray(key_data)
    if data.shape[-1:] != (2,) or data.dtype != np.uint32:
        raise ValueError(f"expected (..., 2) uint32 key data, got "
                         f"{data.shape} {data.dtype}")
    return torch.from_numpy(data.astype(np.int64))


def transformer_from_numpy(cfg, tree: Any, device=None):
    """The reference's transformer parameter tree (dense, moe or llava;
    numpy arrays, layer stacks on a leading axis) -> the port's
    ``Transformer`` on ``device`` (CUDA unless "cpu"), dtypes kept."""
    return Transformer(cfg, params_from_numpy(tree, device))


def rwkv6_from_numpy(cfg, tree: Any, device=None):
    """The reference's rwkv6 parameter tree (numpy arrays, layer stacks on
    a leading axis) -> the port's ``Rwkv6`` on ``device`` (CUDA unless
    "cpu"), dtypes kept."""
    return Rwkv6(cfg, params_from_numpy(tree, device))


def zamba2_from_numpy(cfg, tree: Any, device=None):
    """The reference's zamba2 parameter tree (numpy arrays; group stacks
    (G, every - 1, ...), tail stacks (tail, ...), the shared block once)
    -> the port's ``Zamba2`` on ``device`` (CUDA unless "cpu"), dtypes
    kept."""
    return Zamba2(cfg, params_from_numpy(tree, device))


def whisper_from_numpy(cfg, tree: Any, device=None):
    """The reference's whisper parameter tree (numpy arrays; encoder and
    decoder layer stacks on a leading axis) -> the port's ``Whisper`` on
    ``device`` (CUDA unless "cpu"), dtypes kept."""
    return Whisper(cfg, params_from_numpy(tree, device))
