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

The reference's ``shard_activation`` (a GSPMD layout hint) has no
counterpart: the port's layout on the mesh is explicit (``parallel``,
the collectives of ``swiglu`` / ``gelu_mlp`` / ``cross_entropy_loss``
given a ``group``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.dist import collectives as coll

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


def abstract_params(specs: PyTree) -> PyTree:
    """Meta tensors of the specs' shapes and dtypes: the dry-run's
    no-allocation stand-in."""
    return map_specs(
        lambda _, s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def logical_axes(specs: PyTree) -> PyTree:
    return map_specs(lambda _, s: s.axes, specs)


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


def cross_entropy_loss(logits, labels, mask=None, group=None):
    """Mean token NLL: logits (..., V) cast to f32, logsumexp minus the
    label's logit; labels int (...,).  With ``group`` the logits are this
    rank's block of the vocabulary (blocks in rank order) and the labels
    global ids: the max and the sum of exps are reduced across the group,
    and the label's logit comes from the block holding it."""
    logits = logits.to(torch.float32)
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        V = logits.shape[-1]
        m = coll.all_reduce_max(logits.detach().amax(dim=-1), group)
        s = coll.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                             group)
        lse = m + torch.log(s)
        local = labels.long() - coll.rank(group) * V
        inside = (local >= 0) & (local < V)
        ll = torch.gather(logits, -1,
                          torch.clamp(local, 0, V - 1)[..., None])[..., 0]
        ll = coll.reduce_from(torch.where(inside, ll, 0.0), group)
    nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


# ---------------------------------------------------------------- layers
def rms_norm(x, weight, eps: float = 1e-6, group=None):
    """RMS norm over the last dim.  With ``group`` the last dim is this
    rank's block of a dim split evenly over the group's ranks (``weight``
    its block too): the f32 sum of squares is summed over the group and
    divided by the whole width, and its gradient, partial on each rank,
    is summed back (``reduce_from`` then ``copy_to``)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    if coll.size(group) == 1:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    else:
        ss = torch.sum(x32 * x32, dim=-1, keepdim=True)
        var = (coll.copy_to(coll.reduce_from(ss, group), group)
               / (x.shape[-1] * coll.size(group)))
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


_NARROW = (torch.bfloat16, torch.float16)


def _mm_f32(a, b):
    """a @ b for 2-D (or batched 3-D) narrow-float operands, accumulated
    and returned in f32 (the products of bf16 / f16 values are exact in
    f32); a meta tensor (the dry run) takes the card's branch."""
    mm = torch.bmm if a.dim() == 3 else torch.mm
    if a.is_cuda or a.is_meta:
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.to(torch.float32), b.to(torch.float32))


class _PartialF32(torch.autograd.Function):
    """x @ w in f32 for narrow x, w: a rank's partial product, kept in f32
    until the sum over the ranks.  w is 2-D, or 3-D with x (n, m, k)
    batched alike (the MoE experts' down-projection).  Its backward is
    ``dense``'s: the gradient (f32 holding narrow values, from the cast
    after the sum) is narrowed and multiplied in x's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if w.dim() == 3:
            return _mm_f32(x, w)
        return _mm_f32(x.reshape(-1, x.shape[-1]), w).reshape(
            x.shape[:-1] + (w.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = (torch.matmul(g, w.transpose(-1, -2))
              if ctx.needs_input_grad[0] else None)
        if not ctx.needs_input_grad[1]:
            return dx, None
        if w.dim() == 3:
            return dx, torch.matmul(x.transpose(-1, -2), g)
        return dx, torch.matmul(x.reshape(-1, x.shape[-1]).T,
                                g.reshape(-1, g.shape[-1]))


def row_parallel(x, w, group):
    """``dense(x, w)`` with w's rows (and x's last dim) split over
    ``group``: each rank's partial product summed over the group.  In a
    narrow dtype the partials stay f32 through the sum, which is rounded
    to x's dtype once, as the one-rank ``dense`` rounds its f32
    accumulator once (and as XLA compiles the reference's ``psum`` of a
    bf16 product on the CPU: an f32 dot, an all-reduce promoted to f32,
    one convert after it); a group of one rank is ``dense``.  A 3-D w
    (experts, rows, cols) takes x (experts, ..., rows) batched alike."""
    if coll.size(group) == 1:
        return dense(x, w)
    w = w.to(x.dtype)
    if x.dtype not in _NARROW:
        return coll.reduce_from(torch.matmul(x, w), group)
    return coll.reduce_from(_PartialF32.apply(x, w), group).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, group=None):
    """With ``group``: the weights are the rank's block of ``d_ff``
    (column-parallel gate and up, row-parallel down, summed over the
    group)."""
    if group is not None:
        x = coll.copy_to(x, group)
    h = F.silu(dense(x, w_gate)) * dense(x, w_up)
    return row_parallel(h, w_down, group)


def gelu_mlp(x, w_up, b_up, w_down, b_down, group=None):
    """As ``swiglu`` on a ``group``; ``b_down`` is added once, after the
    sum."""
    if group is not None:
        x = coll.copy_to(x, group)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense(x, w_up, b_up), approximate="tanh")
    if group is None:
        return dense(h, w_down, b_down)
    y = row_parallel(h, w_down, group)
    return y + b_down.to(y.dtype)


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
