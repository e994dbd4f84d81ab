"""The port's threefry keys and draws against jax.random (partitionable
threefry, as jax 0.9 configures it).  Key derivation, bits and uniform
draws are bitwise equal, and so are normal and laplace: their erfinv and
log1p are XLA's own f32 sequences (``core/f32``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from repro_torch import convert
from repro_torch.core import prng


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_key_derivation_bitwise(seed):
    jk, tk = _key(seed)
    assert np.array_equal(_np(jk), tk.numpy())
    for data in (0, 1, 7, 2**31, 2**32 - 1):
        assert np.array_equal(_np(jax.random.fold_in(jk, data)),
                              prng.fold_in(tk, data).numpy())
    for num in (2, 3, 7, 1000):
        assert np.array_equal(_np(jax.random.split(jk, num)),
                              prng.split(tk, num).numpy())
    # batched keys split per lane, as vmap(split) does
    jks = jax.random.split(jk, 5)
    assert np.array_equal(_np(jax.vmap(lambda k: jax.random.split(k, 3))(jks)),
                          prng.split(convert.key_from_numpy(np.asarray(jks)),
                                     3).numpy())


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (1001,), (2, 3, 4)])
def test_random_bits_bitwise(shape):
    jk, tk = _key(11)
    ref = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    assert np.array_equal(ref, prng.random_bits(tk, shape).numpy())


def test_counter_hi_lo_split_on_large_indices():
    """Element i of a draw hashes the counter (i >> 32, i & 0xFFFFFFFF):
    checked directly against jax's threefry primitive past 2^32, where a
    jax draw of that size could not be made here."""
    jk, tk = _key(3)
    starts = [2**32 - 3, 5 * 2**32 + 11]
    for start in starts:
        idx = np.arange(start, start + 6, dtype=np.uint64)
        hi = jnp.asarray((idx >> np.uint64(32)).astype(np.uint32))
        lo = jnp.asarray((idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        k = jnp.asarray(np.asarray(jk), jnp.uint32)
        o0, o1 = jax_prng.threefry2x32_p.bind(k[0], k[1], hi, lo)
        ref = (np.asarray(o0) ^ np.asarray(o1)).astype(np.int64)
        got = prng._bits_range(tk, start, 6, "cpu").numpy()
        assert np.array_equal(ref, got)
        keys = prng.split_range(tk, start, 6, "cpu").numpy()
        assert np.array_equal(np.stack([np.asarray(o0), np.asarray(o1)], -1)
                              .astype(np.int64), keys)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 0.5), (-1.0, 1.0),
                                   (0.5, 1.5), (-0.7, 0.7), (-3.3, 1.9)])
def test_uniform_bitwise(lo, hi):
    jk, tk = _key(5)
    ref = np.asarray(jax.random.uniform(jk, (100_003,), minval=lo, maxval=hi))
    assert np.array_equal(ref, prng.uniform(tk, (100_003,), lo, hi).numpy())
    # one draw of shape () per lane key, as vmap(uniform) over split keys
    jks = jax.random.split(jk, 4097)
    ref = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, minval=lo, maxval=hi))(jks))
    got = prng.uniform(prng.split(tk, 4097), (), lo, hi).numpy()
    assert np.array_equal(ref, got)


def test_uniform_chunks_match_one_draw(monkeypatch):
    """A draw made in several chunks equals the one-chunk draw."""
    _, tk = _key(9)
    whole = prng.uniform(tk, (10_000,), -0.5, 0.5)
    monkeypatch.setattr(prng, "CHUNK", 999)
    assert torch.equal(whole, prng.uniform(tk, (10_000,), -0.5, 0.5))


@pytest.mark.parametrize("seed", [0, 42])
def test_normal_within_ulp_bound(seed):
    """Bitwise: the ulp bound is 0."""
    jk, tk = _key(seed)
    ref = np.asarray(jax.random.normal(jk, (200_001,)))
    got = prng.normal(tk, (200_001,)).numpy()
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("seed", [0, 42])
def test_laplace_within_ulp_bound(seed):
    """Bitwise: the ulp bound is 0."""
    jk, tk = _key(seed)
    ref = np.asarray(jax.random.laplace(jk, (200_001,)))
    got = prng.laplace(tk, (200_001,)).numpy()
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))


def test_erfinv_edges():
    x = torch.tensor([-1.0, 0.0, 1.0])
    y = prng.erfinv(x)
    assert y[0] == -float("inf") and y[1] == 0.0 and y[2] == float("inf")
