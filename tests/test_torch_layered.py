"""The port's layered path against the JAX package's, on the CPU:
distributions (``core/distributions``), the layered quantizers
(``core/layered``) and the plain version of the layered kernels
(``kernels/ref``, reached through ``kernels/ops`` on a CPU tensor).

The reference runs under ``jax.jit``, as the round codec runs it, and
the port computes what XLA compiles: values bitwise.  The one exception
is documented where it is tested: when one jitted function both encodes
and decodes (``LayeredQuantizer.__call__``), XLA rounds the decode's
multiply-add twice, where the decode alone (the codec's server side)
rounds it once, as the port does; messages are equal either way.

Inputs are numpy arrays made from a seed, or keys both packages share.
The bitwise sets of the distributions and the quantizers live in
tests/test_torch_layered_samples.py and
tests/test_torch_layered_quantizer.py (``--dist loadfile`` runs a file
on one worker), which import this file's helpers."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import ks_statistic, ks_threshold, norm_cdf
from repro.core import distributions as jd
from repro.core import layered as jl
from repro.kernels import ops as jops
from repro_torch.core import distributions as td
from repro_torch.core import layered as tl
from repro_torch.core import prng
from repro_torch.kernels import layered_encode as tle
from repro_torch.kernels import ops, ref

N = 1 << 16

DISTS = [("gaussian", 0.5), ("gaussian", 0.01), ("gaussian", 1.3),
         ("laplace", 1.3), ("laplace", 0.05)]


def _dists(family, sigma):
    if family == "gaussian":
        return jd.Gaussian(sigma), td.Gaussian(sigma)
    return jd.Laplace.from_std(sigma), td.Laplace.from_std(sigma)


def _eq(ref_arr, got):
    ref_arr = np.asarray(ref_arr)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref_arr.dtype == got.dtype, (ref_arr.dtype, got.dtype)
    if ref_arr.dtype == np.float32:
        ref_arr, got = ref_arr.view(np.int32), got.view(np.int32)
    bad = int((ref_arr != got).sum())
    assert bad == 0, f"{bad} of {ref_arr.size} differ"


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def test_randomness_chunks_match_one_draw(monkeypatch):
    """The layer drawn in chunks equals the one-chunk draw."""
    q = tl.LayeredQuantizer(td.Gaussian(0.3), shifted=True)
    _, tk = _keys(6)
    u, layer = q.randomness(tk, (5000,))
    monkeypatch.setattr(prng, "CHUNK", 777)
    u2, layer2 = q.randomness(tk, (5000,))
    assert torch.equal(u, u2) and torch.equal(layer, layer2)


def test_fixed_length_support():
    for dist in (td.Gaussian(0.7), td.Laplace.from_std(0.7)):
        q = tl.LayeredQuantizer(dist, shifted=True)
        jq = jl.LayeredQuantizer(jd.Gaussian(0.7) if isinstance(
            dist, td.Gaussian) else jd.Laplace.from_std(0.7), shifted=True)
        for t in (2.0, 50.0):
            assert q.support_size(t) == jq.support_size(t)
            assert q.fixed_bits(t) == jq.fixed_bits(t)
    with pytest.raises(ValueError):
        tl.LayeredQuantizer(td.Gaussian(1.0)).support_size(8.0)


# ------------------------------------------- the layered kernel (plain)
@pytest.mark.parametrize("sigma", [0.01, 0.5])
@pytest.mark.parametrize("shape", [(256,), (130, 77)])
def test_plain_kernel_matches_reference_kernel(sigma, shape):
    """At tests/test_kernels.py:80-81's sigma and shapes: the port's
    ops.layered_* (the plain version on the CPU) give the reference
    Pallas kernel's messages (interpret mode) and its decode within that
    test's 1e-5, and the core path's messages and decode bitwise."""
    jq = jl.LayeredQuantizer(jd.Gaussian(sigma), shifted=True)
    jk = jax.random.PRNGKey(7)
    x = jax.random.normal(jk, shape) * 3 * sigma
    u, layer = jq.randomness(jax.random.fold_in(jk, 1), shape)
    m_k = np.asarray(jops.layered_encode(x, u, layer, sigma))
    y_k = np.asarray(jops.layered_decode(m_k, u, layer, sigma))
    tx, tu, tlay = (torch.from_numpy(np.asarray(a).copy())
                    for a in (x, u, layer))
    m = ops.layered_encode(tx, tu, tlay, sigma)
    assert tuple(m.shape) == shape and m.dtype == torch.int32
    assert np.array_equal(m.numpy(), m_k)
    y = ops.layered_decode(m, tu, tlay, sigma)
    np.testing.assert_allclose(y.numpy(), y_k, atol=1e-5)
    m_c = jax.jit(jq.encode)(x, (u, layer))
    _eq(m_c, m)
    _eq(jax.jit(jq.decode)(m_c, (u, layer)), y)


def test_quantizer_routes_gaussian_shifted_through_ops(monkeypatch):
    """Gaussian shifted encode / decode go through ops.layered_*; direct
    and Laplace quantizers compute in place (as plain jnp does in the
    reference)."""
    calls = []
    for name in ("layered_encode", "layered_decode"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    x = torch.linspace(-1, 1, 300)
    _, tk = _keys(1)
    for dist, shifted, routed in ((td.Gaussian(0.2), True, True),
                                  (td.Gaussian(0.2), False, False),
                                  (td.Laplace(0.2), True, False)):
        calls.clear()
        tl.LayeredQuantizer(dist, shifted)(tk, x)
        assert calls == (["layered_encode", "layered_decode"] if routed
                         else [])


def test_plain_kernel_rows_and_padding():
    """Ragged sizes pad to rows of 128 and come back to their shape; the
    (R, 128) plain functions are the ones the kernels are held to."""
    q = tl.LayeredQuantizer(td.Gaussian(0.4), shifted=True)
    _, tk = _keys(2)
    x = torch.linspace(-2, 2, 1000).reshape(8, 125)
    u, layer = q.randomness(tk, x.shape)
    m = ops.layered_encode(x, u, layer, 0.4)
    rows = [ops._rows(t) for t in (x, u, layer)]
    assert rows[0].shape == (8, 128)
    m_rows = ref.layered_encode_ref(*rows, 0.4)
    assert torch.equal(m_rows.reshape(-1)[:1000].reshape(8, 125), m)
    y = ops.layered_decode(m, u, layer, 0.4)
    y_rows = ref.layered_decode_ref(ops._rows(m), rows[1], rows[2], 0.4)
    assert torch.equal(y_rows.reshape(-1)[:1000].reshape(8, 125), y)
    with pytest.raises(ValueError):
        ops.layered_encode(x, u[:4], layer, 0.4)


def test_kernel_wrappers_refuse_cpu_tensors():
    a = torch.zeros((2, 128))
    with pytest.raises(ValueError):
        tle.layered_encode(a, a, a, 0.5)
    with pytest.raises(ValueError):
        tle.layered_decode(a.to(torch.int32), a, a, 0.5)
    assert tle.LAUNCHES == {"layered_encode": 0, "layered_decode": 0}


# ------------------------------------------------------- the exact law
def _laplace_cdf(x, b):
    x = np.asarray(x)
    return np.where(x < 0, 0.5 * np.exp(x / b), 1 - 0.5 * np.exp(-x / b))


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("family", ["gaussian", "laplace"])
def test_layered_quantizer_exact_error(shifted, family):
    """As tests/test_mechanisms.py:30: the error y - x has the target law
    for arbitrary (non-random) inputs."""
    sigma, n = 1.3, 60_000
    dist = (td.Gaussian(sigma) if family == "gaussian"
            else td.Laplace.from_std(sigma))
    q = tl.LayeredQuantizer(dist, shifted=shifted)
    x = torch.linspace(-9.0, 14.0, n)
    y, _, _ = q(prng.PRNGKey(0), x)
    err = (y - x).numpy()
    if family == "gaussian":
        ks = ks_statistic(err, lambda z: norm_cdf(z, sigma))
    else:
        ks = ks_statistic(err, lambda z: _laplace_cdf(z, dist.scale))
    assert ks < ks_threshold(n), ks
    assert abs(err.mean()) < 0.03 and abs(err.std() - sigma) < 0.03
    assert math.isclose(dist.std, sigma)
