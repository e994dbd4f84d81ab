"""Parameter specs and the layer functions of the dense models (the
port of ``repro.models.nn``).

Each model defines ``param_specs(cfg)`` -> nested dict of ``ParamSpec``;
``init_params`` materialises it with the reference's law (normal with
std ``scale / sqrt(fan_in)``, 0.02 for embeddings and 1-d tensors,
zeros, ones) from a seeded ``torch.Generator``.  Layer stacks carry a
leading 'layers' axis, as in the reference; ``transformer.Transformer``
splits them into one module per layer.  ``jax.random`` and
``torch.Generator`` give different numbers: tests carry the reference's
parameters across as numpy arrays (``repro_torch.convert``).

The reference's ``shard_activation`` has no counterpart: the port runs
on one card, where the reference's own version returns its input.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def map_specs(fn: Callable[[Tuple[str, ...], ParamSpec], Any], specs: PyTree):
    """Apply ``fn(path, spec)`` to every leaf of a spec tree, in order."""
    def rec(path, node):
        if is_spec(node):
            return fn(path, node)
        if isinstance(node, dict):
            return {k: rec(path + (k,), v) for k, v in node.items()}
        raise TypeError(f"bad spec node at {path}: {type(node)}")

    return rec((), specs)


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              device: torch.device, shape=None) -> torch.Tensor:
    """One leaf of ``spec``'s law, of ``shape`` (default the spec's; a
    layer's slice of a stack keeps the stack's std)."""
    shape = spec.shape if shape is None else shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=spec.dtype, device=device)
    if spec.init in ("normal", "embed"):
        if spec.init == "embed" or len(spec.shape) < 2:
            std = spec.scale * 0.02
        else:
            std = spec.scale / math.sqrt(max(spec.shape[-2], 1))
        x = torch.randn(shape, generator=generator, dtype=spec.dtype,
                        device=device)
        return x.mul_(std)
    raise ValueError(spec.init)


def init_params(specs: PyTree, generator: torch.Generator,
                device=None) -> PyTree:
    """Materialise a spec tree on ``device`` (CUDA unless "cpu"), drawing
    every normal leaf from ``generator`` (which lives on that device) in
    the tree's order: one seed gives one set of weights."""
    dev = resolve_device(device)
    return map_specs(lambda _, s: init_leaf(s, generator, dev), specs)


def spec_numel(specs: PyTree) -> int:
    """Total element count of a spec tree (nothing is allocated)."""
    total = 0

    def add(_, s):
        nonlocal total
        total += math.prod(s.shape)

    map_specs(add, specs)
    return total


def cast_tree(tree: PyTree, dtype: torch.dtype) -> PyTree:
    """Floating leaves cast to ``dtype`` (a leaf already of that dtype is
    returned as it is, so the gradient reaches it directly)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token NLL: logits (..., V) cast to f32, logsumexp minus the
    label's logit; labels int (...,)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


# ---------------------------------------------------------------- layers
def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)  # biased
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * weight.to(dt) + bias.to(dt)


def dense(x, w, b=None):
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(dense(x, w_gate)) * dense(x, w_up)
    return dense(h, w_down)


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    # jax.nn.gelu defaults to the tanh approximation
    return dense(F.gelu(dense(x, w_up, b_up), approximate="tanh"), w_down,
                 b_down)


# ---------------------------------------------------------------- RoPE
def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_freqs(head_dim: int, max_t: int, theta: float = 10_000.0,
               dtype=torch.float32, device=None):
    """cos/sin tables (max_t, D/2) of angle ``pos_f32 * inv`` in f32, cast
    to ``dtype``."""
    inv = _inv_freq(head_dim, theta, device)
    t = torch.arange(max_t, dtype=torch.float32, device=device)
    ang = t[:, None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def rope_at(head_dim: int, positions, theta: float = 10_000.0,
            dtype=torch.float32):
    """cos/sin at explicit integer positions (...,) -> (..., D/2); the
    same ``pos_f32 * inv`` as ``rope_freqs``, so bitwise equal to
    indexing its table."""
    inv = _inv_freq(head_dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope_direct(x, cos, sin):
    """x: (..., T, H, D); cos/sin already gathered per token (..., T, D/2)."""
    cos = cos[..., :, None, :].to(x.dtype)
    sin = sin[..., :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, cos, sin, positions=None):
    """x: (..., T, H, D). cos/sin: (T_max, D/2). positions: (..., T) or None."""
    if positions is not None:
        cos, sin = cos[positions], sin[positions]
    else:
        cos, sin = cos[: x.shape[-3]], sin[: x.shape[-3]]
    return apply_rope_direct(x, cos, sin)
