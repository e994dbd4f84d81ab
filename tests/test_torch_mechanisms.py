"""The port's estimators (``core/mechanisms``, ``core/sigm``) and the
point-to-point compressors of ``dist/compress`` against the JAX
package's, on the CPU.

Tolerances:
  * message bits: equal (the messages are the reference's);
  * ``compress_tree`` with ``axis=None``: 1e-6, the decode tolerance; the
    reference is jitted (as the train step runs it), where one function
    encodes and decodes and XLA rounds the layered decode's multiply-add
    twice (the port, like the codec's server, rounds it once);
  * ``run``: the reference's ``run`` is eager (op by op: it divides by
    constants exactly and contracts nothing), the port computes what the
    compiled codec computes.  SIGM's mean within 1e-6; the others within
    DECODE_BAR, the largest difference that rounding moves through the
    steps of these cells (direct layered steps reach ~40 at sigma 0.05,
    so an ulp of a step is ~4e-6), measured here at 8.1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mechanisms as jmech
from repro.core import sigm as jsigm
from repro.dist import compress as jcomp
from repro_torch import convert
from repro_torch.core import mechanisms as tmech
from repro_torch.core import prng
from repro_torch.core import sigm as tsigm
from repro_torch.dist import compress as tcomp

DECODE_ATOL = 1e-6
DECODE_BAR = 2e-5

RUN_CASES = [
    ("none", 0.0, {}), ("none", 0.05, {}),
    ("individual_direct", 0.05, {}), ("individual_shifted", 0.05, {}),
    ("irwin_hall", 0.05, {}), ("aggregate_gaussian", 0.05, {}),
    ("aggregate_laplace", 0.05, {}), ("sigm", 0.05, {}),
    ("sigm", 0.05, {"gamma": 0.5}),
]


def _xs(n=4, d=4096, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(
        np.float32)


@pytest.mark.parametrize("name,sigma,kw", RUN_CASES)
def test_run_matches(name, sigma, kw):
    n = 4
    xs = _xs(n)
    key = jax.random.PRNGKey(7)
    jm = jmech.get_mechanism(name, n, sigma, **kw)
    tm = tmech.get_mechanism(name, n, sigma, device="cpu", **kw)
    assert (tm.name, tm.homomorphic, tm.exact_gaussian, tm.fixed_length) \
        == (jm.name, jm.homomorphic, jm.exact_gaussian, jm.fixed_length)
    y_ref, bits_ref = jm.run(key, jnp.asarray(xs))
    y, bits = tm.run(convert.key_from_numpy(np.asarray(key)),
                     torch.from_numpy(xs))
    assert bits == pytest.approx(bits_ref, rel=1e-6)
    bar = DECODE_ATOL if name in ("sigm", "none", "irwin_hall") \
        else DECODE_BAR
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=bar)


@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_sigm_pieces_bitwise(gamma):
    """SIGM's shared randomness (Bernoulli selection, counts, layered
    randomness, fresh noise) and its messages, against the jitted
    reference; the decode within 1e-6."""
    n, d = 5, 3000
    jm, tm = jsigm.SIGM(n, 0.05, gamma), tsigm.SIGM(n, 0.05, gamma)
    key = jax.random.PRNGKey(11)
    tk = convert.key_from_numpy(np.asarray(key))
    js = jax.jit(lambda k: jm.shared_randomness(k, (d,)))(key)
    ts = tm.shared_randomness(tk, (d,), device="cpu")
    for name in jsigm.SigmShared._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    xs = _xs(n, d, 3)
    jms = jax.jit(jax.vmap(lambda x, i: jm.encode(x, js, i)))(
        jnp.asarray(xs), jnp.arange(n))
    tms = torch.stack([tm.encode(torch.from_numpy(xs[i]), ts, i)
                       for i in range(n)])
    assert np.array_equal(np.asarray(jms), tms.numpy())
    y_ref = jax.jit(lambda m: jm.decode(m, js))(jms)
    np.testing.assert_allclose(tm.decode(tms, ts).numpy(), np.asarray(y_ref),
                               rtol=0, atol=DECODE_ATOL)
    assert tm.bits_per_client(1.0) == jm.bits_per_client(1.0)


@pytest.mark.parametrize("mechanism", ["layered_shifted", "layered_direct",
                                       "none_"])
@pytest.mark.parametrize("n_clients", [1, 4])
def test_compress_tree_point_to_point(mechanism, n_clients):
    grads = {"a": np.random.default_rng(2).normal(0, 0.5, (64, 33))
             .astype(np.float32),
             "b": np.random.default_rng(3).normal(0, 0.5, (517,))
             .astype(np.float32)}
    kw = dict(mechanism=mechanism, sigma=1e-2)
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda g, k: jcomp.compress_tree(
        g, jcomp.CompressionConfig(**kw), k, n_clients=n_clients))(
        {k: jnp.asarray(v) for k, v in grads.items()}, key)
    out = tcomp.compress_tree(convert.params_from_numpy(grads, "cpu"),
                              tcomp.CompressionConfig(**kw),
                              convert.key_from_numpy(np.asarray(key)),
                              n_clients=n_clients, device="cpu")
    for k in grads:
        assert out[k].shape == grads[k].shape
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=DECODE_ATOL)


@pytest.mark.parametrize("mechanism", ["layered_shifted", "layered_direct",
                                       "none_"])
@pytest.mark.parametrize("n_clients", [1, 4, 6])
@pytest.mark.parametrize("clip", [1.0, 0.7])
def test_message_bits_match(mechanism, n_clients, clip):
    """Fixed-length size (layered_shifted), expected Elias-gamma length
    over the reference's Monte-Carlo draw (layered_direct), 32 (none_)."""
    kw = dict(mechanism=mechanism, sigma=0.05, clip=clip)
    assert tcomp.message_bits(tcomp.CompressionConfig(**kw), n_clients,
                              device="cpu") == jcomp.message_bits(
        jcomp.CompressionConfig(**kw), n_clients)


def test_registry_and_devices():
    assert set(tmech.MECHANISMS) == set(jmech.MECHANISMS)
    with pytest.raises(KeyError):
        tmech.get_mechanism("nope", 2, 0.1, device="cpu")
    with pytest.raises(ValueError, match="n-divisible"):
        _ = tmech.get_mechanism("individual_shifted", 2, 0.1, device="cpu",
                                family="laplace").quantizer
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmech.get_mechanism("sigm", 2, 0.1)


def test_individual_laplace_single_client():
    """Laplace noise is individual only for n = 1 (not n-divisible)."""
    xs = _xs(1, 2048, 5)
    key = jax.random.PRNGKey(2)
    jm = jmech.get_mechanism("individual_shifted", 1, 0.1, family="laplace")
    tm = tmech.get_mechanism("individual_shifted", 1, 0.1, device="cpu",
                             family="laplace")
    y_ref, b_ref = jm.run(key, jnp.asarray(xs))
    y, b = tm.run(prng.PRNGKey(2), torch.from_numpy(xs))
    assert b == pytest.approx(b_ref, rel=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=DECODE_BAR)
