"""f32 arithmetic that rounds as the JAX package's compiled code does.

The reference runs under ``jax.jit`` on the CPU, so its bits are those
of XLA's CPU backend.  Each function here is plain PyTorch on f32
tensors and gives the same bits on the CPU and on the card; the CUDA
kernels compute the same sequences with explicitly rounded intrinsics.

* ``fma``: XLA contracts a multiply feeding an add into one fused
  multiply-add, rounded once.  Emulated exactly in f64: the product of
  two f32 values is exact in f64, the sum is rounded to odd (TwoSum
  recovers its error), and rounding that to f32 rounds once.
* ``true_div``: PyTorch turns ``cuda_tensor / python_scalar`` into a
  multiply by the reciprocal; a 0-dim tensor divisor keeps the division
  correctly rounded on every device (the reference's division by an
  array).
* ``rcp_mul`` / ``rcp_fma_div``: XLA compiles ``x / c`` for a constant
  ``c`` (a Python float under jit) as ``x * f32(1 / f32(c))``, and
  ``x / c + s`` as ``fma(x, f32(1 / f32(c)), s)``.
* ``exp``, ``log``, ``log2``, ``log1p``: XLA's CPU polynomial approximations,
  transcribed from the LLVM IR and object code that jax 0.9 emits for
  ``jax.jit(jnp.exp)`` etc. (dump with ``XLA_FLAGS=--xla_dump_to=DIR``
  and read ``DIR/*ir-with-opt.ll`` and ``objdump -d DIR/*.o``): the
  same constants, operation order and fused multiply-adds.  Neither
  PyTorch's nor CUDA's library functions round like them.
* ``sqrt``: correctly rounded on every device (PyTorch's vectorised CPU
  ``sqrt`` is not, in f32 or f64: one ulp off on about 0.6% of inputs).

XLA's CPU code also flushes denormal inputs and results to zero; these
functions do as it does (``_daz`` / ``_ftz``), the rest of the port's
arithmetic does not (the codec's values are never denormal).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["fma", "true_div", "rcp", "rcp_mul", "rcp_fma_div", "exp", "log",
           "log2", "log1p", "sqrt"]

def _f64(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.double()
    return torch.tensor(float(v), dtype=torch.float64, device=like.device)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` with one f32 rounding (f32 operands, tensors or
    python floats holding f32 values)."""
    t = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))
    p = _f64(a, t) * _f64(b, t)  # exact: 24 + 24 bits
    c = _f64(c, t)
    s = p + c
    # TwoSum: err = (p + c) - s exactly
    bp = s - c
    err = (c - (s - bp)) + (p - bp)
    # round to odd: an inexact even result moves one ulp toward err
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).float()


def true_div(t: torch.Tensor, v) -> torch.Tensor:
    """``t / v`` correctly rounded in f32 on every device."""
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(float(v), dtype=torch.float32, device=t.device)
    return t / v


def rcp(c: float) -> float:
    """XLA's reciprocal of a constant divisor: f32(1 / f32(c))."""
    return float(np.float32(1.0) / np.float32(c))


def rcp_mul(x: torch.Tensor, c: float) -> torch.Tensor:
    """XLA's ``x / c`` for a python float ``c``: ``x * f32(1/f32(c))``."""
    return x * rcp(c)


def rcp_fma_div(x: torch.Tensor, c: float, s) -> torch.Tensor:
    """XLA's ``x / c + s`` for a python float ``c``: one fused
    multiply-add by the f32 reciprocal."""
    return fma(x, rcp(c), s)


def _f(v: float) -> float:
    return float(np.float32(v))


_MIN_NORMAL = _f(1.1754943508222875e-38)


def _daz(x: torch.Tensor) -> torch.Tensor:
    """Denormal inputs read as zeros of their sign."""
    return torch.where(x.abs() < _MIN_NORMAL, x * 0.0, x)


def _ftz(y: torch.Tensor) -> torch.Tensor:
    """Denormal results flush to zeros of their sign."""
    return torch.where(y.abs() < _MIN_NORMAL, y * 0.0, y)


# exp: Cephes-style range reduction and degree-5 polynomial
_EXP_LO, _EXP_HI = _f(-87.80000305175781), _f(88.80000305175781)
_LOG2E = _f(1.4426950216293335)
_EXP_C1, _EXP_C2 = 0.693359375, _f(-0.00021219444170128554)
_EXP_P = (_f(0.00019875691214110702), _f(0.001398199936375022),
          _f(0.008333452045917511), _f(0.04166579619050026),
          _f(0.1666666567325592), 0.5)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``exp`` (CPU), bitwise."""
    x = torch.clamp(_daz(x), _EXP_LO, _EXP_HI)
    fx = torch.floor(fma(x, _LOG2E, 0.5)).clamp_(-127.0, 127.0)
    r = fma(-fx, _EXP_C1, x)
    r = fma(-fx, _EXP_C2, r)
    y = fma(_EXP_P[0], r, _EXP_P[1])
    for p in _EXP_P[2:]:
        y = fma(y, r, p)
    y = fma(y, r * r, r) + 1.0
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(y * scale)


# log: Cephes-style mantissa / exponent split, three interleaved
# polynomials of degree 2 combined in x^3
_SQRT_HALF = _f(0.7071067690849304)
_LOG_P = tuple(_f(v) for v in (
    0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
    -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
    0.2000071406364441, -0.24999994039535522, 0.3333333134651184))
_LOG_Q1, _LOG_Q2 = _f(-0.00021219444170128554), 0.693359375


def _log_core(x: torch.Tensor) -> torch.Tensor:
    """The polynomial part of XLA's log for finite x > 0 (x is clamped
    to the smallest normal first, so denormals read as it)."""
    bits = torch.maximum(x, torch.full_like(x, _MIN_NORMAL)).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, 0.0)
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = fma(fma(p[0], m, p[1]), m, p[2])
    y1 = fma(fma(p[3], m, p[4]), m, p[5])
    y2 = fma(fma(p[6], m, p[7]), m, p[8])
    y = fma(y, m3, y1)
    y = fma(y, m3, y2)
    y = fma(y, m3, e * _LOG_Q1)
    r = fma(m2, -0.5, m) + y
    return fma(e, _LOG_Q2, r)


def _log_special(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    y = torch.where((x < 0) | torch.isnan(x), float("nan"), y)
    y = torch.where(x == 0, float("-inf"), y)
    return torch.where(x == float("inf"), float("inf"), y)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 natural ``log`` (CPU), bitwise."""
    x = _daz(x)
    return _log_special(x, _log_core(x))


def log2(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log2`` (CPU), bitwise: ``log(x) * f32(1 / ln 2)``, not
    exact at powers of two (log2(8192) is 12.999999)."""
    return log(x) * _LOG2E


_LOG1P_P = tuple(_f(v) for v in (
    15.062909126281738, 83.04756927490234, 221.7624053955078,
    309.0987243652344, 216.42788696289062, 60.11865997314453))
_LOG1P_Q = tuple(_f(v) for v in (
    4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
    29.91191864013672, 60.949668884277344, 57.11296463012695,
    20.039552688598633))
_LOG1P_SMALL = _f(0.4142135679721832)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p`` (CPU), bitwise: a rational approximation for
    |x| < sqrt(2) - 1, else ``log(1 + x)``."""
    x = _daz(x)
    u = x + 1.0
    big = _log_special(u, _log_core(u))
    x2 = x * x
    t = x * 0.0
    p = t + 1.0
    for c in _LOG1P_P:
        p = fma(p, x, c)
    q = t + _LOG1P_Q[0]
    for c in _LOG1P_Q[1:]:
        q = fma(q, x, c)
    small = x + fma(x2, -0.5, (x * x2) * (q / p))
    return torch.where(x.abs() < _LOG1P_SMALL, small, big)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device.  PyTorch's CPU
    root (f32 or f64) can be one ulp off, so the candidate is corrected
    once against the exact squares of the midpoints to its neighbours
    (25-bit midpoints square exactly in f64; no root lies on one)."""
    x = _daz(x)
    y = x.double().sqrt().float()
    x64, y64 = x.double(), y.double()
    lo = (y64 + torch.nextafter(y, y.new_tensor(-float("inf"))).double()) * 0.5
    hi = (y64 + torch.nextafter(y, y.new_tensor(float("inf"))).double()) * 0.5
    fin = torch.isfinite(y) & (y > 0)
    y = torch.where(fin & (x64 < lo * lo),
                    torch.nextafter(y, y.new_tensor(0.0)), y)
    return torch.where(fin & (x64 > hi * hi),
                       torch.nextafter(y, y.new_tensor(float("inf"))), y)
