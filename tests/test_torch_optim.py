"""The port's optimizers against the JAX package's under ``jax.jit``:
sgd (momentum 0 and 0.9), adamw (with and without weight decay) and
langevin, five updates from numpy-seeded params and gradients.

Bars: ``apply`` (update and add in one, as the train step calls it) is
bitwise equal to the jitted reference step ``p + update``: it rounds as
XLA's contractions do (``core/f32``).  ``update`` alone (the updates
before the add) is within 1e-6 relative of the reference's jitted
``update`` (the reference's own rounding differs there only by the
contraction into the add)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jo
from repro_torch.optim import optimizers as to

CASES = [("sgd", {}), ("sgd", {"momentum": 0.9}), ("adamw", {}),
         ("adamw", {"weight_decay": 0.1}), ("langevin", {})]
LR = 3e-4


def _trees(seed=0):
    r = np.random.default_rng(seed)
    params = {"w": r.standard_normal((48, 33)).astype(np.float32),
              "layers": [r.standard_normal((17,)).astype(np.float32),
                         r.standard_normal((3, 5)).astype(np.float32)]}
    grads = [{"w": r.standard_normal((48, 33)).astype(np.float32) * s,
              "layers": [r.standard_normal((17,)).astype(np.float32) * s,
                         r.standard_normal((3, 5)).astype(np.float32) * s]}
             for s in (1.0, 0.1, 3.0, 1e-3, 10.0)]
    return params, grads


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _tleaves(tree):
    return [x.numpy() for x in jax.tree.leaves(
        to.tree_map(lambda t: t, tree),
        is_leaf=lambda x: isinstance(x, torch.Tensor))]


@pytest.mark.parametrize("name,kw", CASES)
def test_apply_bitwise_with_the_jitted_reference(name, kw):
    params, grads = _trees()
    jopt, topt = jo.get_optimizer(name, LR, **kw), to.get_optimizer(name, LR,
                                                                    **kw)

    @jax.jit
    def jstep(p, s, g):
        u, s = jopt.update(g, s, p)
        return jax.tree.map(jnp.add, p, u), s

    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = to.tree_map(torch.from_numpy, params)
    ts = topt.init(tp)
    for g in grads:
        jp, js = jstep(jp, js, jax.tree.map(jnp.asarray, g))
        tp, ts = topt.apply(to.tree_map(torch.from_numpy, g), ts, tp)
        for a, b in zip(_tleaves(tp), _leaves(jp)):
            np.testing.assert_array_equal(a, b)
    if name == "adamw":
        assert int(ts[2]) == int(js[2]) == len(grads)
        for a, b in zip(_tleaves(ts[:2]), _leaves(js[:2])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kw", CASES)
def test_update_matches_the_jitted_reference(name, kw):
    params, grads = _trees(1)
    jopt, topt = jo.get_optimizer(name, LR, **kw), to.get_optimizer(name, LR,
                                                                    **kw)
    jupdate = jax.jit(jopt.update)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = to.tree_map(torch.from_numpy, params)
    ts = topt.init(tp)
    for g in grads:
        ju, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(to.tree_map(torch.from_numpy, g), ts, tp)
        for a, b in zip(_tleaves(tu), _leaves(ju)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_state_structure_and_unknown_name():
    """AdamW's state is the reference's (m, v, count) with an int32
    count; sgd without momentum and langevin keep none; a bad name
    raises KeyError as the reference's."""
    params, _ = _trees()
    tp = to.tree_map(torch.from_numpy, params)
    m, v, count = to.adamw(LR).init(tp)
    assert count.dtype == torch.int32 and count.shape == ()
    assert to.sgd(LR).init(tp) == () and to.langevin(LR).init(tp) == ()
    assert len(to.sgd(LR, momentum=0.9).init(tp)) == 1
    with pytest.raises(KeyError):
        to.get_optimizer("lamb", LR)
