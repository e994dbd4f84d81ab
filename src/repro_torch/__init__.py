"""PyTorch + CUDA port of the exact-error compressed aggregation system.

Mirrors ``src/repro`` module for module; imports torch and numpy only.
Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``), where the plain PyTorch versions of the kernels run.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise.  Raises when CUDA is asked for (or defaulted to) and there
    is no card — nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
