"""The port's DECOMPOSE tables and shared (A, B) draw against the JAX
package's, on the CPU.

Tables are host numpy built by the same code: equal exactly.  The
per-coordinate draw runs each coordinate's rejection loop with the
reference's keys, branch tests and arithmetic as XLA compiles it
(``core/f32``: its exp, erfinv and log1p, reciprocal multiplies and fused
multiply-adds).  The reference's own bits depend on the jit context: in
the round codec (``runtime/protocol._encode_jit``) XLA leaves v * f0 in
DECOMPOSEUNIF's interpolation uncontracted, in a standalone
``jax.jit(global_randomness)`` it contracts it.  The port follows the
codec: its (A, B) give the codec's unpacked payload words bit for bit,
where messages of ~1e6 expose every ulp of A (test below), and agree
with the standalone draw on every branch and within 1e-5 relative
(measured at d = 4096, seeds 0-1, n in {4, 6}: within 6.4e-6 relative;
exact shares of A / B >= 99.1% / 98.5% for gaussian, >= 97.9% / 95.3%
for laplace)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import aggregate as jagg
from repro.core import decompose as jdec
from repro.runtime import protocol as jproto
from repro_torch import convert
from repro_torch.core import aggregate as tagg
from repro_torch.core import decompose as tdec
from repro_torch.core import prng
from repro_torch.runtime import protocol as tproto

TABLE_FIELDS = ("norm_xs", "norm_fs", "inv_y", "inv_x", "psi_xs",
                "psi_inv_y", "psi_inv_x")


@pytest.mark.parametrize("family", ["gaussian", "laplace"])
@pytest.mark.parametrize("n", [2, 4, 6, 16])
def test_decompose_tables_equal(family, n):
    get = "gaussian_tables" if family == "gaussian" else "laplace_tables"
    jt, tt = getattr(jdec, get)(n), getattr(tdec, get)(n)
    assert (jt.n, jt.family, jt.lam, jt.L, jt.peak_norm) == (
        tt.n, tt.family, tt.lam, tt.L, tt.peak_norm)
    for name in TABLE_FIELDS:
        assert np.array_equal(getattr(jt, name), getattr(tt, name)), name


@pytest.mark.parametrize("right", [None, 0.0])
def test_interp_matches_jnp(right):
    """Same op order and one rounding of fp[i-1] + (delta/dx) * df:
    bitwise equal to jnp.interp, edges included."""
    t = jdec.gaussian_tables(6)
    x = np.random.default_rng(0).uniform(-0.05, 0.6, 50_000).astype(
        np.float32)
    ref = np.asarray(jax.numpy.interp(x, t.norm_xs, t.norm_fs, right=right))
    got = tdec.interp(torch.from_numpy(x), torch.from_numpy(t.norm_xs),
                      torch.from_numpy(t.norm_fs), right=right).numpy()
    assert np.array_equal(ref, got)


# relative error bound on A and B against the standalone jitted draw,
# and the exact shares of A and B (stated above)
REL_TOL = 1e-5
MIN_EXACT = {"gaussian": (0.97, 0.97), "laplace": (0.96, 0.93)}


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(a), 1e-30)


@pytest.mark.parametrize("family", ["gaussian", "laplace"])
@pytest.mark.parametrize("n", [4, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_global_randomness_per_coord(family, n, seed):
    d, sigma = 4096, 0.1
    jm = jagg.AggregateGaussianMechanism(n, sigma, True, family)
    tm = tagg.AggregateGaussianMechanism(n, sigma, True, family)
    # a clamp that binds on a few percent of coordinates
    a_min = 0.05
    jt = jax.jit(lambda k: jm.global_randomness(k, (d,), a_min=a_min))(
        jax.random.PRNGKey(seed))
    tt = tm.global_randomness(prng.PRNGKey(seed), (d,), a_min=a_min,
                              device="cpu")
    A, B = np.asarray(jt.A), np.asarray(jt.B)
    tA, tB = tt.A.numpy(), tt.B.numpy()
    assert tA.shape == (d,) and tA.dtype == np.float32
    # the exact-IH branch (A, B) = (1, 0) and the clamp agree everywhere
    branch = ((A == 1) & (B == 0)) != ((tA == 1) & (tB == 0))
    assert int(branch.sum()) == 0
    assert np.array_equal(A == a_min, tA == a_min)
    assert 0 < (A == a_min).mean() < 0.5
    assert _rel(A, tA).max() <= REL_TOL and _rel(B, tB).max() <= REL_TOL
    ea, eb = MIN_EXACT[family]
    assert (A == tA).mean() >= ea and (B == tB).mean() >= eb


@pytest.mark.parametrize("family", ["gaussian", "laplace"])
@pytest.mark.parametrize("n", [4, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_shared_draw_bitwise_in_the_codec(family, n, seed):
    """The draw as the round codec compiles it: the unpacked payload
    words floor(x / (A w) + s + 1/2), with A clamped only at the int32
    bound, are ~1e6 and move with any ulp of A; they are equal."""
    d, sigma = 4096, 1e-3
    jp = jproto.RoundProtocol(mechanism=f"aggregate_{family}", sigma=sigma)
    tp = tproto.RoundProtocol(mechanism=f"aggregate_{family}", sigma=sigma,
                              device="cpu")
    key = jproto.round_key(seed, 3)
    x = np.random.default_rng(seed).uniform(-1, 1, d).astype(np.float32)
    ref = jp.client_message(key, n, 1, x)
    got = tp.client_message(convert.key_from_numpy(np.asarray(key)), n, 1,
                            torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 1e5
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("family", ["gaussian", "laplace"])
def test_global_randomness_per_tensor(family):
    jm = jagg.AggregateGaussianMechanism(4, 0.1, False, family)
    tm = tagg.AggregateGaussianMechanism(4, 0.1, False, family)
    jt = jax.jit(lambda k: jm.global_randomness(k, (5, 7)))(
        jax.random.PRNGKey(3))
    tt = tm.global_randomness(prng.PRNGKey(3), (5, 7), device="cpu")
    assert tuple(tt.A.shape) == (5, 7)
    assert bool((tt.A == tt.A[0, 0]).all())
    np.testing.assert_allclose(tt.A.numpy(), np.asarray(jt.A), rtol=REL_TOL)
    np.testing.assert_allclose(tt.B.numpy(), np.asarray(jt.B), rtol=REL_TOL)


def test_chunked_draw_equals_one_chunk(monkeypatch):
    """Coordinates drawn in several chunks get the same (A, B) as in one:
    each coordinate's key is split_range's child of the round key."""
    tm = tagg.AggregateGaussianMechanism(4, 0.1)
    whole = tm.global_randomness(prng.PRNGKey(8), (3000,), device="cpu")
    monkeypatch.setattr(prng, "CHUNK", 1024)
    parts = tm.global_randomness(prng.PRNGKey(8), (3000,), device="cpu")
    assert torch.equal(whole.A, parts.A) and torch.equal(whole.B, parts.B)


def test_geometry_clamps_match():
    jm = jagg.AggregateGaussianMechanism(4, 0.25)
    tm = tagg.AggregateGaussianMechanism(4, 0.25)
    for bits in (8, 16, 24):
        jg, tg = jm.pack_geometry(bits), tm.pack_geometry(bits)
        assert tuple(jg) == tuple(tg)
        assert jm.a_min_for_geometry(1.0, jg) == tm.a_min_for_geometry(
            1.0, tg)
    assert jm.a_min_for_range(2.0) == tm.a_min_for_range(2.0)
