"""DECOMPOSEUNIF / DECOMPOSE (paper Algorithms 1-2, Appendix A.2/A.4).

Given the Irwin-Hall noise P that the homomorphic dithering fleet
produces, these algorithms draw (A, B) from a coupling in Pi_{A,B}(P, Q)
so that  A * Z + B ~ Q  for Z ~ P (unit-variance Irwin-Hall here,
Q = N(0,1) or the unit-variance Laplace).

The tables are the JAX package's float64 host grids, built by the same
numpy code.  The samplers run over a batch of lanes, one lane per
coordinate: each lane carries its own key and does exactly what the
reference's vmapped ``lax.while_loop`` does for it (``split(key, 3)`` per
iteration, frozen once accepted), so every lane's (A, B) is the
reference's.  Finished lanes are compacted away, so the work of an
iteration is proportional to the lanes still looping.

The arithmetic is the reference's as XLA compiles it (``core/f32``):
one rounding where XLA contracts a multiply and an add (the
interpolation, the mixture threshold, the unif recursion), a multiply by
the f32 reciprocal where it divides by a constant, and XLA's own ``exp``
and ``log1p``, so every (A, B) is the jitted reference's, bit for bit.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import f32
from repro_torch.core.f32 import fma, rcp_mul
from repro_torch.core.irwin_hall import NormalizedIrwinHall

__all__ = [
    "interp",
    "decompose_unif",
    "decompose_gaussian",
    "DecomposeTables",
    "gaussian_tables",
    "laplace_tables",
]

_MAX_ITERS = 100_000  # hard cap; P(hit) ~ (1 - 1/f(0))^cap, astronomically small


def _norm_pdf64(x):
    return np.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def _laplace_pdf64(x):
    # unit-variance Laplace: b = 1/sqrt(2)
    b = 1.0 / math.sqrt(2.0)
    return np.exp(-np.abs(x) / b) / (2.0 * b)


_TARGET_PDFS = {"gaussian": _norm_pdf64, "laplace": _laplace_pdf64}
_TARGET_TAILS = {"gaussian": 9.5, "laplace": 16.0}


def _target_pdf_prime(family: str, x: np.ndarray) -> np.ndarray:
    if family == "gaussian":
        return -x * _norm_pdf64(x)
    b = 1.0 / math.sqrt(2.0)
    return -np.sign(x) / b * _laplace_pdf64(x)


@functools.lru_cache(maxsize=64)
def _lambda_and_psi_grid(n: int, family: str = "gaussian"):
    """lambda = inf_{x>0} g'(x)/f'(x) and a grid of psi~(x) = g - lambda f
    on [0, xmax] (g the unit-variance target pdf, f the unit-variance
    Irwin-Hall(n)); psi decreasing."""
    ih = NormalizedIrwinHall(n)
    g_pdf = _TARGET_PDFS[family]
    scale = ih.unit_scale  # X_unit = scale * X_norm
    if n <= 2:
        lam = 0.0  # paper's choice for n <= 2
    else:
        xs_n = ih._xs64[1:]  # avoid the x=0 point (0/0)
        f_prime = ih._dfs64[1:] / scale**2
        x_unit = xs_n * scale
        g_prime = _target_pdf_prime(family, x_unit)
        mask = f_prime < -1e-12
        ratio = g_prime[mask] / f_prime[mask]
        lam = float(np.clip(np.min(ratio), 0.0, 1.0)) if mask.any() else 0.0
    xmax = max(math.sqrt(3.0 * n), _TARGET_TAILS[family])
    xs = np.linspace(0.0, xmax, 16385)
    f_unit = np.interp(xs / scale, ih._xs64, ih._fs64, right=0.0) / scale
    psi = np.maximum(g_pdf(xs) - lam * f_unit, 0.0)
    psi = np.minimum.accumulate(psi)  # enforce monotone (grid noise guard)
    return lam, xs, psi


class DecomposeTables(NamedTuple):
    """Host (numpy f32) tables of the decompose sampler, copied to each
    device once (``_device_tables``)."""

    n: int
    family: str
    lam: float
    L: float  # support width of unit-variance IH = 2 sqrt(3n)
    peak_norm: float  # f~(0) of the normalized ([-1/2,1/2]) IH
    norm_xs: np.ndarray  # [0, 1/2] grid
    norm_fs: np.ndarray  # f~ on grid
    inv_y: np.ndarray  # increasing f~ values (reversed)
    inv_x: np.ndarray  # matching x
    psi_xs: np.ndarray
    psi_inv_y: np.ndarray  # increasing psi values (reversed)
    psi_inv_x: np.ndarray


@functools.lru_cache(maxsize=64)
def gaussian_tables(n: int) -> DecomposeTables:
    return _tables_eager(n, "gaussian")


@functools.lru_cache(maxsize=64)
def laplace_tables(n: int) -> DecomposeTables:
    """Decompose a unit-variance Laplace into a mixture of shifted and
    scaled Irwin-Hall laws."""
    return _tables_eager(n, "laplace")


def _tables_eager(n: int, family: str) -> DecomposeTables:
    ih = NormalizedIrwinHall(n)
    lam, psi_xs, psi = _lambda_and_psi_grid(n, family)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return DecomposeTables(
        n=n,
        family=family,
        lam=float(lam),
        L=2.0 * math.sqrt(3.0 * n),
        peak_norm=float(ih._fs64[0]),
        norm_xs=f32(ih._xs64),
        norm_fs=f32(ih._fs64),
        inv_y=f32(ih._fs64[::-1]),
        inv_x=f32(ih._xs64[::-1]),
        psi_xs=f32(psi_xs),
        psi_inv_y=f32(psi[::-1]),
        psi_inv_x=f32(psi_xs[::-1]),
    )


@functools.lru_cache(maxsize=64)
def _device_tables(tables_key: Tuple[int, str], device: str) -> dict:
    n, family = tables_key
    t = gaussian_tables(n) if family == "gaussian" else laplace_tables(n)
    names = ("norm_xs", "norm_fs", "inv_y", "inv_x", "psi_inv_y",
             "psi_inv_x")
    return {k: torch.from_numpy(getattr(t, k).copy()).to(device)
            for k in names}


_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def interp(x, xp, fp, right=None):
    """``jnp.interp`` in its op order: right-side search, clamped bin,
    fp[i-1] + (delta / dx) * df with one rounding, then the ``left`` /
    ``right`` edge values."""
    i = torch.searchsorted(xp, x, right=True).clamp_(1, xp.numel() - 1)
    lo_f, hi_f = fp[i - 1], fp[i]
    lo_x = xp[i - 1]
    df = hi_f - lo_f
    dx = xp[i] - lo_x
    delta = x - lo_x
    dx0 = dx.abs() <= _INTERP_EPS
    f = torch.where(dx0, lo_f,
                    fma(delta / torch.where(dx0, 1.0, dx), df, lo_f))
    f = torch.where(x < xp[0], fp[0], f)
    edge = fp[-1] if right is None else torch.tensor(
        right, dtype=f.dtype, device=f.device)
    return torch.where(x > xp[-1], edge, f)


def decompose_unif(tables: DecomposeTables, keys) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """Algorithm DECOMPOSEUNIF for every lane key in ``keys`` (C, 2):
    (a, b) with a*X~ + b ~ U(-1/2, 1/2), X~ normalized Irwin-Hall."""
    dev = keys.device
    tb = _device_tables((tables.n, tables.family), str(dev))
    C = keys.shape[0]
    a_out = torch.ones(C, dtype=torch.float32, device=dev)
    b_out = torch.zeros(C, dtype=torch.float32, device=dev)
    idx = torch.arange(C, device=dev)
    a, b, key = a_out.clone(), b_out.clone(), keys
    f0 = float(np.float32(tables.peak_norm))
    for _ in range(_MAX_ITERS):
        if idx.numel() == 0:
            break
        nk = prng.split(key, 3)
        key, k1, k2 = nk[:, 0], nk[:, 1], nk[:, 2]
        u = prng.uniform(k1, (), -0.5, 0.5)
        v = prng.uniform(k2, ())
        pdf = interp(u.abs(), tb["norm_xs"], tb["norm_fs"], right=0.0)
        accept = v <= rcp_mul(pdf, f0)
        s = interp(v * f0, tb["inv_y"], tb["inv_x"])
        b_new = fma(a * torch.sign(u) * 0.5, s + 0.5, b)
        a_new = a * (0.5 - s)
        # accepted lanes keep the (a, b) they entered with and freeze
        a_out[idx[accept]] = a[accept]
        b_out[idx[accept]] = b[accept]
        live = ~accept
        idx, key = idx[live], key[live]
        a, b = a_new[live], b_new[live]
    # lanes that hit the cap keep their last state, as the reference's
    a_out[idx] = a
    b_out[idx] = b
    return a_out, b_out


def decompose_gaussian(tables: DecomposeTables, keys) -> Tuple[torch.Tensor,
                                                               torch.Tensor]:
    """Algorithm DECOMPOSE for Q the unit-variance target (Gaussian or
    Laplace) and P = unit-variance IH(n), one (A, B) per lane key of
    ``keys`` (C, 2): A * Z_unit + B ~ Q for Z_unit ~ IH(n, 0, 1)."""
    dev = keys.device
    tb = _device_tables((tables.n, tables.family), str(dev))
    nk = prng.split(keys, 3)
    kx, kv, ku = nk[:, 0], nk[:, 1], nk[:, 2]
    if tables.family == "laplace":
        b = 1.0 / math.sqrt(2.0)
        x = prng.laplace(kx) * b
        g_x = rcp_mul(f32.exp(rcp_mul(-x.abs(), b)), 2.0 * b)
    else:
        x = prng.normal(kx)
        g_x = rcp_mul(f32.exp(-0.5 * x * x), math.sqrt(2.0 * math.pi))
    v = prng.uniform(kv) * g_x
    scale = tables.L
    f_unit = rcp_mul(interp(rcp_mul(x.abs(), scale), tb["norm_xs"],
                            tb["norm_fs"], right=0.0), scale)
    # exact-IH component (A, B) = (1, 0)
    take_f = v > fma(torch.full_like(f_unit, -tables.lam), f_unit, g_x)
    s = interp(v, tb["psi_inv_y"], tb["psi_inv_x"])  # psi~^{-1}(v)
    a_u, b_u = decompose_unif(tables, ku)
    A = rcp_mul(2.0 * a_u * s, tables.L)
    B = 2.0 * b_u * s
    return torch.where(take_f, 1.0, A), torch.where(take_f, 0.0, B)
