"""The rest of the port's ``core/``: the bit accounting and entropy code of
``coding.py``, the DP accounting of ``privacy.py`` and the numpy
baselines ``csgm.py`` and ``ddg.py``, against the JAX package's modules on
the cases of its own tests (tests/test_mechanisms.py,
tests/test_theory_bounds.py) and on shared inputs made with numpy from a
seed.  The numpy code is the same on both sides, so those results are
equal; the f32 entropy of the dithered quantizer agrees within 1e-6
relative (XLA's and PyTorch's log2 differ in the last bit)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coding as jcoding
from repro.core import csgm as jcsgm
from repro.core import ddg as jddg
from repro.core import privacy as jprivacy
from repro.core.distributions import Gaussian as JGaussian
from repro.core.distributions import Laplace as JLaplace
from repro.core.layered import LayeredQuantizer as JLayered
from repro_torch import convert
from repro_torch.core import coding, csgm, ddg, privacy
from repro_torch.core.distributions import Gaussian, Laplace
from repro_torch.core.layered import LayeredQuantizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: the test
    workers share the machine's cores, and idle intra-op threads spinning
    in every worker slow the others' wall-clock tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("support", [0.5, 2.0, 3.0, 17.0, 1024.0, 1025.0])
def test_fixed_bits(support):
    assert coding.fixed_bits(support) == jcoding.fixed_bits(support)


def test_dither_conditional_entropy_matches():
    rng = np.random.default_rng(0)
    step = rng.uniform(0.05, 80.0, 4096).astype(np.float32)
    u = rng.uniform(0.0, 1.0, 4096).astype(np.float32)
    for t in (1.0, 24.0, 64.0):
        want = np.asarray(jcoding.dither_conditional_entropy(
            jnp.asarray(step), jnp.asarray(u), t))
        got = coding.dither_conditional_entropy(torch.from_numpy(step),
                                                torch.from_numpy(u), t)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shifted", [False, True])
def test_layered_entropy_mc_matches(shifted):
    """Same key: the port's (U, layer) draw is the reference's bit for
    bit, so the Monte-Carlo entropy agrees to the f32 log's last bits."""
    jq = JLayered(JGaussian(1.0), shifted=shifted)
    q = LayeredQuantizer(Gaussian(1.0), shifted=shifted)
    jk = jax.random.PRNGKey(12)
    want = jcoding.layered_entropy_mc(jq, 64.0, jk, 4096)
    got = coding.layered_entropy_mc(q, 64.0,
                                    convert.key_from_numpy(np.asarray(jk)),
                                    4096, device="cpu")
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("family", ["gaussian", "laplace"])
def test_layer_entropies_equal(family):
    if family == "gaussian":
        dist, jdist = Gaussian(0.7), JGaussian(0.7)
    else:
        dist, jdist = Laplace(0.4), JLaplace(0.4)
    assert coding.h_layer_direct(dist) == jcoding.h_layer_direct(jdist)
    assert coding.h_layer_shifted(dist) == jcoding.h_layer_shifted(jdist)


def test_entropy_bounds_eq4_eq5():
    """Eq. (4) lower and Eq. (5) / Prop. 1 upper bounds bracket H(M|S)
    (the reference's test, through the port)."""
    dist = Gaussian(1.0)
    t = 64.0
    h_d = coding.h_layer_direct(dist)
    h_w = coding.h_layer_shifted(dist)
    slack = 8 * math.log2(math.e) / t * dist.std
    key = convert.key_from_numpy(np.asarray(jax.random.PRNGKey(12)))
    for shifted, h_layer in ((False, h_d), (True, h_w)):
        q = LayeredQuantizer(dist, shifted=shifted)
        h = coding.layered_entropy_mc(q, t, key, 40_000, device="cpu")
        assert (math.log2(t) + h_d - 0.05 <= h
                <= math.log2(t) + slack + h_layer + 0.05)
    assert h_w - h_d <= 2.0 + 1e-6


def test_huffman_lengths_equal_and_within_one_bit():
    """The same code lengths as the reference on the messages of a
    shifted layered quantizer; H <= E[len] < H + 1, and no longer than
    Elias gamma (the reference's test)."""
    q = LayeredQuantizer(Gaussian(0.8), shifted=True)
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.uniform(0, 24.0, 40_000).astype(np.float32))
    key = convert.key_from_numpy(np.asarray(jax.random.PRNGKey(21)))
    m = q.encode(x, q.randomness(key, x.shape, device="cpu"))
    vals, counts = np.unique(m.numpy(), return_counts=True)
    p = counts / counts.sum()
    np.testing.assert_array_equal(coding.huffman_lengths(p),
                                  jcoding.huffman_lengths(p))
    h = float(-(p * np.log2(p)).sum())
    e_len = coding.huffman_expected_bits(m)
    assert e_len == jcoding.huffman_expected_bits(m.numpy())
    assert h - 1e-9 <= e_len < h + 1.0
    assert e_len <= float(coding.elias_gamma_bits(m).float().mean()) + 1e-9
    assert list(coding.huffman_lengths([0.0, 1.0, 0.0])) == [0.0, 1.0, 0.0]


PRIVACY_CASES = [(1.2, 1e-5, 2.0), (0.5, 1e-6, 1.0), (8.0, 1e-3, 0.3)]


@pytest.mark.parametrize("eps,delta,sens", PRIVACY_CASES)
def test_privacy_accounting_equal(eps, delta, sens):
    sigma = privacy.gaussian_sigma(eps, delta, sensitivity=sens)
    assert sigma == jprivacy.gaussian_sigma(eps, delta, sensitivity=sens)
    assert privacy.gaussian_epsilon(sigma, delta, sens) == pytest.approx(eps)
    assert (privacy.rdp_to_dp(sigma, delta, sens)
            == jprivacy.rdp_to_dp(sigma, delta, sens))
    for alpha in (1.5, 2.0, 8.0, 32.0):
        assert (privacy.renyi_gaussian(alpha, sigma, sens)
                == jprivacy.renyi_gaussian(alpha, sigma, sens))
    assert (privacy.sigm_sigma(eps, delta, 1.0, 100, 0.3, 4096)
            == jprivacy.sigm_sigma(eps, delta, 1.0, 100, 0.3, 4096))


def test_gaussian_dp_calibration_roundtrip():
    """The reference's test: RDP conversion within ~35% of the classical
    calibration, and Renyi DP monotone in alpha."""
    eps, delta = 1.2, 1e-5
    sigma = privacy.gaussian_sigma(eps, delta, sensitivity=2.0)
    assert privacy.rdp_to_dp(sigma, delta, sensitivity=2.0) < eps * 1.35
    vals = [privacy.renyi_gaussian(a, sigma=1.0) for a in (1.5, 2.0, 8.0)]
    assert vals == sorted(vals)


@pytest.mark.parametrize("seed", [0, 3])
def test_csgm_equals_reference(seed):
    """The Fig. 5 baseline: the same seed and inputs give the same mean
    estimate and bits."""
    n, d = 16, 512
    xs = np.random.default_rng(seed).uniform(-1, 1, (n, d))
    kw = dict(n=n, sigma=0.05, gamma=0.5, bits=3.0, clip=1.0)
    y, bits = csgm.CSGMechanism(**kw).run(seed, xs)
    jy, jbits = jcsgm.CSGMechanism(**kw).run(seed, xs)
    np.testing.assert_array_equal(y, jy)
    assert bits == jbits
    assert float(np.mean((y - xs.mean(0)) ** 2)) < 1.0


@pytest.mark.parametrize("seed", [0, 3])
def test_ddg_equals_reference(seed):
    """The Fig. 6 baseline: discrete Gaussian, Hadamard rotation and the
    modular sum give the same estimate for the same seed."""
    n, d0 = 8, 300
    xs = np.random.default_rng(seed).normal(size=(n, d0)) * 0.05
    kw = dict(n=n, sigma_total=0.01, clip=1.0, bits=16)
    y, bits = ddg.DDGMechanism(**kw).run(seed, xs)
    jy, jbits = jddg.DDGMechanism(**kw).run(seed, xs)
    np.testing.assert_array_equal(y, jy)
    assert bits == jbits == 16.0
    rng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(ddg.discrete_gaussian(rng, 2.5, (1000,)),
                                  jddg.discrete_gaussian(jrng, 2.5, (1000,)))
    x = np.random.default_rng(2).normal(size=(3, 64))
    np.testing.assert_allclose(ddg.fwht(ddg.fwht(x)), x, atol=1e-12)
