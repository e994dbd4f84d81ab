"""The hand-written kernels' cost on meta tensors: what the dry run
(``launch.dryrun``) counts where the card would launch a kernel.

On a meta tensor each kernel's wrapper checks its inputs and allocates
its outputs and scratch as it does on the card (so a memory tracker sees
them at their sizes and dtypes), then, in place of the launch, calls
``charge``, which adds to ``COST`` the kernel's operations and bytes by
the formulas of PERF.md section 6 and one to its name's count:

  * attention: F = 4 B H D times the (query, key) pairs attended
    (``attended_pairs``), the backward 2.5 F;
  * wkv6: 5 K^2 a (b, t, h) forward (the step kernel too), 14 K^2 the
    backward;
  * the codec kernels: bytes alone (elementwise work counts no FLOPs, as
    in ``torch.utils.flop_counter``);
  * bytes: each input read once and each output written once.
"""
from __future__ import annotations

import torch

COST = {"flops": 0.0, "bytes": 0.0, "calls": {}}


def reset() -> None:
    COST["flops"], COST["bytes"] = 0.0, 0.0
    COST["calls"] = {}


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def charge(name: str, flops: float, inputs, outputs) -> None:
    """Add one launch of kernel ``name``: its FLOPs, and the bytes of its
    tensor inputs and outputs (None and Python scalars count nothing)."""
    COST["flops"] += float(flops)
    COST["bytes"] += float(_nbytes(inputs) + _nbytes(outputs))
    COST["calls"][name] = COST["calls"].get(name, 0) + 1


def attended_pairs(T: int, S: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs the attention kernels compute: query i sees
    keys 0..i (causal, aligned at the top left) and, with a window W,
    only the last W of them."""
    if not causal:
        return T * S
    m = min(S, window) if window else S
    if T <= m:
        return T * (T + 1) // 2
    return m * (m + 1) // 2 + (T - m) * m
