"""Client workloads.

``QuadraticWorkload`` is d-dim least squares with per-client targets and a
closed-form gradient.  Its targets come from the same numpy recipe as the
JAX package's, so both packages see identical client updates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["QuadraticWorkload"]


@dataclasses.dataclass(frozen=True)
class QuadraticWorkload:
    """f_c(x) = ||x - t_c||^2 / 2 with t_c ~ scale * N(0, I) per client."""

    n_clients: int
    d: int
    seed: int = 0
    scale: float = 1.0

    def _targets(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 7919)
        return (self.scale
                * rng.standard_normal((self.n_clients, self.d))
                ).astype(np.float32)

    def init_params(self, device=None) -> torch.Tensor:
        return torch.zeros(self.d, dtype=torch.float32,
                           device=resolve_device(device))

    def build(self, device=None) -> Callable:
        """grad(flat, client_id, rnd) -> flat - t_client, on ``device``."""
        targets = torch.from_numpy(self._targets()).to(resolve_device(device))

        def grad(flat: torch.Tensor, client_id: int, rnd: int) -> torch.Tensor:
            del rnd
            return flat.to(torch.float32) - targets[client_id]

        return grad
