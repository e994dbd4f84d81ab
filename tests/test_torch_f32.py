"""The port's f32 arithmetic (``repro_torch.core.f32``) against XLA's, on
the CPU: exp, log, log2, log1p and sqrt bitwise equal to
``jax.jit(jnp.*)`` on 2^20-input sweeps of the ranges the codec uses and
on edge values; the reciprocal forms of a division by a python float
bitwise equal to what XLA compiles ``x / c`` and ``x / c + s`` to; and
``fma`` rounded once, including where f64 rounding would round twice."""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import f32

N = 1 << 20

EDGES = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.17549435e-38, 1e-37,
                  0.5, 1.0, -1.0, 2.0, 8192.0, 88.7, -88.7, 87.8, -87.8,
                  88.8, -88.8, 89.0, -89.0, 100.0, -100.0, 0.41421354,
                  -0.41421354, -0.9999999, 3.4e38, np.inf, -np.inf, np.nan],
                 np.float32)


def _sweep(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "unit":
        return rng.uniform(0.0, 1.0, N).astype(np.float32)
    if kind == "neg_unit":
        return -rng.uniform(0.0, 1.0, N).astype(np.float32)
    if kind == "exp_arg":
        return rng.uniform(-100.0, 100.0, N).astype(np.float32)
    if kind == "gauss_arg":  # -z^2 / 2 of the layer sampler
        return rng.uniform(-20.0, 0.0, N).astype(np.float32)
    if kind == "log1p_arg":
        return rng.uniform(-1.0, 10.0, N).astype(np.float32)
    if kind == "wide":  # positive, 1e-39 .. 1e38
        return np.exp(rng.uniform(-90.0, 88.0, N)).astype(np.float32)
    if kind == "ints":  # the Elias-gamma code's zigzag values
        return rng.integers(1, 2**32, N).astype(np.float32)
    raise KeyError(kind)


CASES = [
    ("exp", "gauss_arg"), ("exp", "exp_arg"),
    ("log", "unit"), ("log", "wide"),
    ("log2", "ints"), ("log2", "wide"),
    ("log1p", "neg_unit"), ("log1p", "log1p_arg"),
    ("sqrt", "unit"), ("sqrt", "wide"),
]


def _same_bits(ref, got):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    same = (ref.view(np.int32) == got.view(np.int32)) | (
        np.isnan(ref) & np.isnan(got))
    return same


@pytest.mark.parametrize("name,kind", CASES)
def test_sweep_bitwise(name, kind):
    x = _sweep(kind, seed=len(name) + len(kind))
    ref = np.asarray(jax.jit(getattr(jnp, name))(x))
    got = getattr(f32, name)(torch.from_numpy(x)).numpy()
    same = _same_bits(ref, got)
    assert same.all(), (x[~same][:5], ref[~same][:5], got[~same][:5])


@pytest.mark.parametrize("name", ["exp", "log", "log2", "log1p", "sqrt"])
def test_edges_bitwise(name):
    """0, denormals (XLA reads and writes them as zero), 1, the exp
    clamps at -87.8 / 88.8, the log1p branch point, infinities, NaN."""
    ref = np.asarray(jax.jit(getattr(jnp, name))(EDGES))
    got = getattr(f32, name)(torch.from_numpy(EDGES.copy())).numpy()
    same = _same_bits(ref, got)
    assert same.all(), (EDGES[~same], ref[~same], got[~same])


def test_elias_gamma_log2_on_powers_of_two():
    """XLA's log2 is log(x) * f32(1/ln 2): at some powers of two it reads
    just below the integer, and the code lengths follow it."""
    k = np.array([2.0**j + d for j in range(1, 32) for d in (-1, 0, 1)],
                 np.float32)
    ref = np.asarray(jax.jit(lambda v: jnp.floor(jnp.log2(v)))(k))
    got = torch.floor(f32.log2(torch.from_numpy(k))).numpy()
    assert np.array_equal(ref, got)
    assert (ref != np.floor(np.log2(k.astype(np.float64)))).any()


@pytest.mark.parametrize("c", [0.3, 1.0 / 7.0, 0.034641016151377546,
                               3.3e-5, 6.0])
def test_division_by_a_python_float(c):
    """x / c compiles to x * f32(1/f32(c)); x / c + s to one fma."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-40.0, 40.0, N).astype(np.float32)
    s = rng.uniform(-0.5, 0.5, N).astype(np.float32)
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    quotient = np.asarray(jax.jit(lambda v: v / c)(x))
    assert np.array_equal(quotient, f32.rcp_mul(tx, c).numpy())
    ref = np.asarray(jax.jit(lambda v, w: v / c + w)(x, s))
    assert np.array_equal(ref, f32.rcp_fma_div(tx, c, ts).numpy())
    # not the correctly rounded quotient (6.0 happens to give it)
    if c != 6.0:
        assert not np.array_equal(x / np.float32(c), quotient)


def _f32_nearest(fr: Fraction) -> np.float32:
    """The f32 nearest to an exact fraction, ties to even."""
    x = np.float32(float(fr))
    best = None
    for cand in (np.nextafter(x, np.float32(-np.inf)), x,
                 np.nextafter(x, np.float32(np.inf))):
        dist = abs(Fraction(float(cand)) - fr)
        even = (int(np.array(cand).view(np.int32)) & 1) == 0
        if best is None or dist < best[0] or (dist == best[0] and even):
            best = (dist, cand)
    return best[1]


def test_fma_rounds_once():
    """Random triples against the exact value, plus one where f64 would
    round twice: c + a*b = 1 + 2^-23 + 2^-24 - 2^-54 lies just below an
    f32 midpoint that f64 rounds onto."""
    rng = np.random.default_rng(5)
    a = rng.uniform(-4, 4, 2000).astype(np.float32)
    b = rng.uniform(-4, 4, 2000).astype(np.float32)
    c = (-a * b + rng.uniform(-1e-3, 1e-3, 2000)).astype(np.float32)
    a = np.append(a, np.float32(2.0**-24 * (1 + 2.0**-15)))
    b = np.append(b, np.float32(1 - 2.0**-15))
    c = np.append(c, np.float32(1 + 2.0**-23))
    got = f32.fma(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([_f32_nearest(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)
    assert got[-1] == np.float32(1 + 2.0**-23)
    naive = np.float32(float(a[-1]) * float(b[-1]) + float(c[-1]))
    assert naive != got[-1]
