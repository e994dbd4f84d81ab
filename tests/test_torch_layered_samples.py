"""The layered path's distributions (``core/distributions``) against the
JAX package's, on the CPU, bitwise: the geometry of each law, its layer
samples under the reference's key splits, and the Bernoulli draw.

Split from tests/test_torch_layered.py (which holds the helpers) so that
a run with ``--dist loadfile`` spreads the files over its workers."""
import jax
import numpy as np
import pytest
import torch

from repro.core import distributions as jd
from repro_torch.core import distributions as td
from repro_torch.core import prng
from test_torch_layered import DISTS, N, _dists, _eq, _keys


@pytest.mark.parametrize("family,sigma", DISTS)
def test_geometry_bitwise(family, sigma):
    """pdf, b+, and the direct / shifted steps and offsets."""
    jdist, tdist = _dists(family, sigma)
    rng = np.random.default_rng(1)
    v = (rng.uniform(0, 1, N) * jdist.peak).astype(np.float32)
    x = rng.normal(0, 3 * sigma, N).astype(np.float32)
    tv, tx = torch.from_numpy(v), torch.from_numpy(x)
    assert tdist.peak == jdist.peak
    assert tdist.min_step_shifted == jdist.min_step_shifted
    _eq(jax.jit(jdist.pdf)(x), tdist.pdf(tx))
    for name in ("b_plus", "step_direct", "step_shifted", "offset_shifted"):
        _eq(jax.jit(getattr(jdist, name))(v), getattr(tdist, name)(tv))
    _eq(jax.jit(jdist.offset_direct)(v), tdist.offset_direct(tv))


@pytest.mark.parametrize("family,sigma", DISTS)
def test_layer_samples_bitwise(family, sigma):
    """sample, layer_sample_direct / _shifted with the reference's key
    splits (kz, ku; kd, kf)."""
    jdist, tdist = _dists(family, sigma)
    jk, tk = _keys(3)
    _eq(jax.jit(lambda k: jdist.sample(k, (N,)))(jk), tdist.sample(tk, (N,)))
    _eq(jax.jit(lambda k: jd.layer_sample_direct(jdist, k, (N,)))(jk),
        td.layer_sample_direct(tdist, tk, (N,)))
    _eq(jax.jit(lambda k: jd.layer_sample_shifted(jdist, k, (N,)))(jk),
        td.layer_sample_shifted(tdist, tk, (N,)))


def test_bernoulli_bitwise():
    jk, tk = _keys(9)
    for p in (0.5, 0.3, 0.999):
        ref_b = np.asarray(jax.random.bernoulli(jk, p, (5, 2001)))
        assert np.array_equal(ref_b, prng.bernoulli(tk, p, (5, 2001)).numpy())
