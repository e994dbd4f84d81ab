"""Client workloads.

``QuadraticWorkload`` is d-dim least squares with per-client targets and a
closed-form gradient.  Its targets come from the same numpy recipe as the
JAX package's, so both packages see identical client updates.

``ModelGradWorkload`` is a registry model's NLL gradient on the
deterministic synthetic non-IID client streams (``data.synthetic``):
``build()`` returns ``grad(flat, client_id, rnd)`` over flat f32 vectors
(numpy or a tensor in; f32 numpy out, as in the JAX package), the round
doubling as the data step.  Its ``init_params`` is the port's own init
(``nn.init_params`` under a torch generator), so its numbers differ from
the JAX package's jax.random init; carry the JAX vector across to compare.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["QuadraticWorkload", "ModelGradWorkload"]


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


@dataclasses.dataclass(frozen=True)
class ModelGradWorkload:
    """NLL gradient of a registry architecture on client-partitioned
    synthetic data.  The round number doubles as the data step, so every
    round sees a fresh deterministic batch.  Computes on ``device`` (CUDA
    unless "cpu"; a field, so the workload crosses to client processes
    as it is)."""

    arch: str
    smoke: bool = True
    seq: int = 32
    batch: int = 2
    data: str = "lm"
    seed: int = 0
    device: Optional[str] = None

    def _model_cfg(self):
        from repro_torch import configs

        cfg = (configs.get_smoke_config(self.arch) if self.smoke
               else configs.get_config(self.arch))
        if self.smoke:
            cfg = cfg.scaled(compute_dtype="float32")
        return cfg

    def _data_cfg(self, cfg):
        from repro_torch.data import synthetic

        return synthetic.DataConfig(vocab=cfg.vocab, seq_len=self.seq,
                                    global_batch=self.batch, seed=self.seed,
                                    kind=self.data)

    def init_params(self, device=None) -> np.ndarray:
        """The flat f32 parameter vector, leaves in the JAX package's order
        (dict keys sorted)."""
        from repro_torch.dist.compress import _flatten
        from repro_torch.models import nn, registry

        dev = resolve_device(device or self.device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        params = nn.init_params(registry.param_specs(self._model_cfg()), gen,
                                dev)
        leaves, _ = _flatten(params)
        return torch.cat([p.reshape(-1).float() for p in leaves]
                         ).cpu().numpy()

    def build(self, device=None) -> Callable:
        from repro_torch.data import synthetic
        from repro_torch.dist.compress import _flatten
        from repro_torch.models import nn, registry
        from repro_torch.train import steps

        dev = resolve_device(device or self.device)
        cfg = self._model_cfg()
        dc = self._data_cfg(cfg)
        metas, rebuild = _flatten(nn.map_specs(
            lambda _, s: torch.empty(s.shape, device="meta"),
            registry.param_specs(cfg)))
        shapes = [t.shape for t in metas]
        batch_fn = synthetic.batch_fn(dc)

        def grad(flat, client_id: int, rnd: int) -> np.ndarray:
            flat = torch.as_tensor(flat).to(device=dev, dtype=torch.float32)
            leaves, off = [], 0
            for shape in shapes:
                size = math.prod(shape)
                leaves.append(flat[off:off + size].reshape(shape))
                off += size
            data = synthetic.with_frontend_stubs(
                batch_fn(dc, rnd, client=client_id, device=dev), cfg)
            _, g = steps.value_and_grad(cfg, rebuild(leaves), data)
            return torch.cat([x.reshape(-1) for x in _flatten(g)[0]]
                             ).cpu().numpy()

        return grad
