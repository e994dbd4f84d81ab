"""Optimizers over trees of tensors (the port of ``repro.optim.
optimizers``): SGD, AdamW, and the Langevin (QLSD*) update.

The API mirrors optax and the JAX package: ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; updates are
*added* to the params.  A tree is a dict, list or tuple of tensors (dict
keys in any order); the state has the JAX package's structure, AdamW's
``(m, v, count)`` with ``count`` an int32 scalar tensor, so a checkpoint
reads the same in both packages.

The JAX package's step runs under ``jax.jit``, where XLA on the CPU
contracts a multiply feeding an add into one fused multiply-add: the
moment updates ``b1 * m + (1 - b1) * g`` become ``fma(b1, m, (1 - b1) *
g)``, SGD's ``momentum * m + g`` ``fma(momentum, m, g)``, the weight
decay ``step + wd * p`` ``fma(wd, p, step)``, and the train step's
``p + (-lr * step)`` ``fma(step, -lr, p)``; it also rewrites AdamW's
``(m / c1) / (sqrt(v / c2) + eps)`` as ``m / (c1 (sqrt(v / c2) + eps))``.
The port rounds as that compiled step does (``core/f32.fma``, a correctly
rounded ``f32.sqrt``) in ``apply``, which the train step calls: bitwise
on the CPU (tests/test_torch_optim.py).  ``update`` returns the updates
alone, as the JAX package's does.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import f32

PyTree = Any

__all__ = ["Optimizer", "sgd", "adamw", "langevin", "get_optimizer",
           "tree_map"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    # apply(grads, state, params) -> (new params, state): update and add
    # in one, rounding as the jitted train step does
    apply: Callable


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _f32(x: float) -> float:
    """A Python constant as the f32 the jitted reference folds it to."""
    return float(np.float32(x))


def _make(init, direction, rate: float) -> Optimizer:
    """An Optimizer from ``direction(grads, state, params) -> (d, state)``
    whose update is ``-rate * d``.  ``apply`` adds it to the params as
    ``fma(d, -rate, p)``: XLA contracts the update's multiply into the
    step's add."""
    neg = _f32(-rate)

    def update(grads, state, params=None):
        d, state = direction(grads, state, params)
        return tree_map(lambda x, p: (-rate * x).to(p.dtype), d,
                        d if params is None else params), state

    def apply(grads, state, params):
        d, state = direction(grads, state, params)
        return tree_map(lambda x, p: f32.fma(x, neg, p).to(p.dtype), d,
                        params), state

    return Optimizer(init, update, apply)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return (tree_map(torch.zeros_like, params),)

    def direction(grads, state, params=None):
        if momentum == 0.0:
            return grads, ()
        (mu,) = state
        mu = tree_map(lambda m, g: f32.fma(m, _f32(momentum), g), mu, grads)
        return mu, (mu,)

    return _make(init, direction, lr)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros():
            return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)
        device = next(iter(_leaves(params))).device
        return (zeros(), zeros(),
                torch.zeros((), dtype=torch.int32, device=device))

    def direction(grads, state, params):
        m, v, count = state
        count = count + 1
        m = tree_map(lambda mi, g: f32.fma(mi, _f32(b1), (1 - b1)
                                           * g.float()), m, grads)
        v = tree_map(lambda vi, g: f32.fma(vi, _f32(b2), (1 - b2)
                                           * torch.square(g.float())),
                     v, grads)
        cnt = count.float()
        c1 = 1.0 - torch.pow(torch.tensor(_f32(b1), device=cnt.device), cnt)
        c2 = 1.0 - torch.pow(torch.tensor(_f32(b2), device=cnt.device), cnt)

        def step(mi, vi, p):
            # (m / c1) / (sqrt(v / c2) + eps): XLA rewrites (a / b) / c as
            # a / (b * c)
            den = f32.sqrt(f32.true_div(vi, c2)) + eps
            out = mi / (den * c1)
            if weight_decay:
                out = f32.fma(p.float(), _f32(weight_decay), out)
            return out

        return tree_map(step, m, v, params), (m, v, count)

    return _make(init, direction, lr)


def langevin(gamma: float) -> Optimizer:
    """Stochastic Langevin update theta <- theta - gamma g + sqrt(2 gamma)
    Z.  The noise is injected by the compressor when an AINQ mechanism
    with sigma^2 = 2 / gamma is active (paper App. 2 / QLSD*); this
    optimizer applies only the deterministic part."""

    def init(params):
        return ()

    def direction(grads, state, params=None):
        return grads, ()

    return _make(init, direction, gamma)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "langevin":
        return langevin(lr)
    raise KeyError(name)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree
