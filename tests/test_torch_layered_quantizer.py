"""The layered quantizers (``core/layered``) against the JAX package's,
on the CPU: randomness, encode and decode bitwise, each jitted on its own
as the round codec runs them, and the messages of the jitted
``__call__``.

Split from tests/test_torch_layered.py (which holds the helpers) so that
a run with ``--dist loadfile`` spreads the files over its workers."""
import jax
import numpy as np
import pytest
import torch

from repro.core import layered as jl
from repro_torch.core import layered as tl
from test_torch_layered import DISTS, N, _dists, _eq, _keys


@pytest.mark.parametrize("family,sigma", DISTS)
@pytest.mark.parametrize("shifted", [False, True])
def test_quantizer_bitwise(family, sigma, shifted):
    """randomness, encode and decode, each jitted on its own as the codec
    runs them, and the messages of the jitted __call__."""
    jdist, tdist = _dists(family, sigma)
    jq, tq = jl.LayeredQuantizer(jdist, shifted), tl.LayeredQuantizer(
        tdist, shifted)
    jk, tk = _keys(4)
    x = np.random.default_rng(2).normal(0, 3 * sigma, N).astype(np.float32)
    tx = torch.from_numpy(x)
    ju, jlay = jax.jit(lambda k: jq.randomness(k, (N,)))(jk)
    tu, tlay = tq.randomness(tk, (N,))
    _eq(ju, tu)
    _eq(jlay, tlay)
    jm = jax.jit(jq.encode)(x, (ju, jlay))
    tm = tq.encode(tx, (tu, tlay))
    _eq(jm, tm)
    _eq(jax.jit(jq.decode)(jm, (ju, jlay)), tq.decode(tm, (tu, tlay)))
    jy, jm2, _ = jax.jit(jq.__call__)(jk, x)
    ty, tm2, _ = tq(tk, tx)
    _eq(jm2, tm2)
    # one jit both encoding and decoding rounds the decode twice
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=2e-7 * max(1.0, 60 * sigma))
