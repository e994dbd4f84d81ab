"""f32 arithmetic that rounds as the JAX package's compiled code does.

* ``true_div``: PyTorch turns ``cuda_tensor / python_scalar`` into a
  multiply by the reciprocal, which moves floor boundaries; a 0-dim
  tensor divisor keeps the division correctly rounded on every device.
* ``fma``: XLA contracts a multiply feeding an add into one fused
  multiply-add, rounded once.  The f64 product of two f32 values is
  exact, so rounding the f64 ``a * b + c`` to f32 rounds (all but
  never differently) once too.
"""
from __future__ import annotations

import torch

__all__ = ["true_div", "fma"]


def true_div(t: torch.Tensor, v) -> torch.Tensor:
    """``t / v`` correctly rounded in f32 on every device."""
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(float(v), dtype=torch.float32, device=t.device)
    return t / v


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` with one f32 rounding."""
    return (a.double() * b.double() + c.double()).float()
