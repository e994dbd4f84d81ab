"""Federated-learning loop at paper scale (explicit n-client rounds).

Each round samples a cohort, gathers every member's update, and
aggregates the updates with the configured mechanism, then takes an SGD
step.  Mechanisms with an integer wire format run through the
message-level codec of ``repro_torch.runtime.protocol``: each member's
update is encoded as soon as it exists and the server decodes the
messages to the mean update plus exact noise.  The others ("none",
"sigm") run the central estimator of ``repro_torch.core.mechanisms``.
Updates are flat tensors, or dicts of tensors, on the round's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.core.mechanisms import get_mechanism
from repro_torch.dist import compress as dcompress
from repro_torch.runtime import protocol

PyTree = Any


def sample_cohort(n_clients: int, cohort_fraction: float,
                  straggler_fraction: float, seed: int,
                  rnd: int) -> np.ndarray:
    """Deterministic per-round cohort: subsample clients, then drop
    stragglers (the JAX package's numpy recipe, so both packages announce
    identical cohorts for identical (seed, rnd))."""
    rng = np.random.default_rng(seed * 100_003 + rnd)
    sel = rng.random(n_clients) < cohort_fraction
    stragglers = rng.random(n_clients) < straggler_fraction
    cohort = np.flatnonzero(sel & ~stragglers)
    if cohort.size == 0:
        cohort = np.array([rng.integers(n_clients)])
    return cohort


@dataclasses.dataclass(frozen=True)
class FLConfig:
    n_clients: int
    mechanism: str = "aggregate_gaussian"
    sigma: float = 1e-3
    clip: float = 1.0  # per-coordinate clip before encoding
    cohort_fraction: float = 1.0  # client subsampling per round
    straggler_fraction: float = 0.0  # dropped uniformly at random
    lr: float = 0.1
    seed: int = 0
    mech_kwargs: tuple = ()


def round_protocol(cfg: FLConfig,
                   device) -> Optional[protocol.RoundProtocol]:
    """The integer-message codec of ``cfg`` on ``device`` (per_coord,
    packed and msg_bits from ``mech_kwargs``), or None for the mechanisms
    without a wire format ("none", "sigm")."""
    mech = protocol.canonical_mechanism(cfg.mechanism)
    if mech not in protocol.PROTOCOL_MECHANISMS:
        return None
    kw = dict(cfg.mech_kwargs)
    return protocol.RoundProtocol(
        mechanism=mech, sigma=cfg.sigma, clip=cfg.clip,
        per_coord=bool(kw.get("per_coord", True)),
        packed=bool(kw.get("packed", False)),
        msg_bits=kw.get("msg_bits"), device=str(device))


class FederatedAveraging:
    """FedAvg/FedSGD with compressed exact-noise aggregation.

    ``client_grad(params, client_id, round) -> update tree`` supplies local
    updates; the server aggregates them with the configured mechanism and
    applies an SGD step.  Runs on the card unless ``device="cpu"``.
    """

    def __init__(self, cfg: FLConfig, client_grad: Callable, device=None):
        self.cfg = cfg
        self.client_grad = client_grad
        self.device = resolve_device(device)
        self.proto = round_protocol(cfg, self.device)

    def _cohort(self, rnd: int) -> np.ndarray:
        cfg = self.cfg
        return sample_cohort(cfg.n_clients, cfg.cohort_fraction,
                             cfg.straggler_fraction, cfg.seed, rnd)

    def round(self, params: PyTree, rnd: int) -> Tuple[PyTree, Dict]:
        cfg = self.cfg
        cohort = self._cohort(rnd)
        n = len(cohort)
        key = protocol.round_key(cfg.seed, rnd)
        if self.proto is None:
            mean_update, bits = self._central(params, cohort, key, rnd)
        else:
            mean_update, bits = self._codec(params, cohort, key, rnd)
        leaves, rebuild = dcompress._flatten(params)
        out, off = [], 0
        for p in leaves:
            u = mean_update[off:off + p.numel()].reshape(p.shape)
            out.append(p - cfg.lr * u)
            off += p.numel()
        return rebuild(out), {"cohort": n, "bits_per_coord": bits}

    def _update(self, params, c: int, rnd: int) -> torch.Tensor:
        leaves, _ = dcompress._flatten(self.client_grad(params, c, rnd))
        return torch.cat([g.reshape(-1) for g in leaves])

    def _codec(self, params, cohort, key, rnd: int):
        """Mean update + exact noise through the integer message codec.
        Each member's update is encoded as soon as it exists, so only one
        full-precision update is alive at a time."""
        n = len(cohort)
        msgs, d = None, 0
        for pos, c in enumerate(cohort):
            flat = self._update(params, int(c), rnd)
            d = flat.numel()
            # repro-lint: disable=rng-key-reuse -- the codec derives client
            # pos's stream via split(key)[pos] internally, so passing the
            # same round key per cohort member is the protocol's contract
            m = self.proto.client_message(key, n, pos, flat)
            if msgs is None:  # the (n, payload) stack, filled in place
                msgs = m.new_empty((n, m.numel()))
            msgs[pos] = m
            del flat, m
        return self.proto.decode(key, n, msgs, np.ones(n, bool), d=d)

    def _central(self, params, cohort, key, rnd: int):
        """Mean update + noise from the central estimator ("none",
        "sigm"), which takes every member's clipped update at once."""
        cfg = self.cfg
        xs = torch.stack([self._update(params, int(c), rnd) for c in cohort])
        xs = torch.clamp(xs, -cfg.clip, cfg.clip)
        mech = get_mechanism(cfg.mechanism, len(cohort), cfg.sigma,
                             device=self.device, **dict(cfg.mech_kwargs))
        return mech.run(key, xs)

    def run(self, params: PyTree, n_rounds: int, *,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
            keep_last_k: Optional[int] = 3,
            resume: bool = False) -> Tuple[PyTree, Dict]:
        """Drive ``n_rounds`` rounds with optional checkpoint-and-resume.

        Rounds are pure functions of ``(seed, rnd, params)``, so a run
        resumed from the round-``k`` checkpoint reproduces rounds
        ``k..n`` of the uninterrupted run bitwise.  Checkpoints go
        through the async checkpointer (commit barrier + keep-last-k
        retention) in the JAX package's format; a resumed run places the
        restored params on the loop's device."""
        start = 0
        if resume and checkpoint_dir:
            last = ckpt_mod.latest_step(checkpoint_dir)
            if last is not None:
                state = ckpt_mod.restore(
                    checkpoint_dir, last,
                    {"params": params, "round": np.int64(0)},
                    device=self.device)
                params, start = state["params"], int(state["round"])
        ckpt = None
        if checkpoint_dir:
            ckpt = ckpt_mod.AsyncCheckpointer(checkpoint_dir,
                                              keep_last_k=keep_last_k)
        info: Dict = {}
        try:
            for rnd in range(start, n_rounds):
                params, info = self.round(params, rnd)
                if ckpt is not None and (rnd + 1) % max(checkpoint_every,
                                                        1) == 0:
                    ckpt.save(rnd + 1,
                              {"params": params, "round": np.int64(rnd + 1)})
        finally:
            if ckpt is not None:
                ckpt.close()
        info["start_round"] = start
        return params, info
