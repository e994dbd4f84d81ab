"""Top-level async runtime: wire transport + actors + monitor together.

    cfg = RuntimeConfig(fl=FLConfig(n_clients=8, mechanism="aggregate_gaussian",
                                    sigma=1e-3, clip=2.0))
    rt = AsyncFederatedRuntime(cfg, QuadraticWorkload(8, 512))
    params, summary, records = rt.run(workload.init_params(), n_rounds=20)

The uplink carries integers only (quantized updates + dither seeds);
params go downlink in round announces.  At staleness bound 0 with full
participation the result is bitwise identical to
``fl.federated.FederatedAveraging``: both sides run the same codec from
``runtime.protocol``, built from the same ``FLConfig`` (its
``mech_kwargs`` per_coord, packed and msg_bits; the JAX package's
runtime reads per_coord only), on the same device.  Everything runs on
the card unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# Module-style import (cycle with repro_torch.fl.federated, see actors.py)
import repro_torch.fl.federated as federated
from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.runtime import protocol
from repro_torch.runtime.actors import (ClientSpec, Learner, _host_f32,
                                        run_client)
from repro_torch.runtime.chaos import FaultPlan, LearnerKilled
from repro_torch.runtime.messages import SHUTDOWN
from repro_torch.runtime.monitor import Monitor, RoundRecord
from repro_torch.runtime.transport import make_transport

__all__ = ["RuntimeConfig", "AsyncFederatedRuntime", "analytic_bits_per_coord"]

# FL-loop mechanism names -> dist.compress naming for analytic bit rates
_COMPRESS_NAMES = {
    "aggregate_gaussian": "aggregate_gaussian",
    "aggregate_laplace": "aggregate_laplace",
    "irwin_hall": "irwin_hall",
    "individual_shifted": "layered_shifted",
    "individual_direct": "layered_direct",
}


def analytic_bits_per_coord(mechanism: str, n: int, sigma: float,
                            clip: float, device=None) -> Optional[float]:
    """Expected bits/coordinate from the compression layer's accounting
    (None if the mechanism has no analytic/MC rate there)."""
    from repro_torch.dist.compress import CompressionConfig, message_bits

    name = _COMPRESS_NAMES.get(protocol.canonical_mechanism(mechanism))
    if name is None:
        return None
    try:
        comp = CompressionConfig(mechanism=name, sigma=sigma, clip=clip)
        return float(message_bits(comp, n, device=device))
    except (KeyError, NotImplementedError):
        return None


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    fl: federated.FLConfig
    # staleness / aggregation policy
    staleness_bound: int = 0
    staleness_weighting: str = "uniform"  # uniform | inverse
    quorum: float = 1.0  # fraction of the announced cohort to wait for
    round_timeout_s: float = 30.0
    poll_interval_s: float = 0.002
    buffer_capacity: int = 4096
    # client behaviour
    max_retries: int = 3
    retry_backoff_s: float = 0.01
    straggler_fraction: float = 0.0  # wall-clock stragglers (sleep past
    straggler_delay_s: float = 0.5   # the deadline -> arrive stale)
    # transport
    transport: str = "thread"  # thread | process
    drop_prob: float = 0.0
    # elastic membership: a member whose last heartbeat/update is older
    # than this is evicted (leaves future announced cohorts); clients
    # beacon at timeout/4.  None disables the protocol entirely.
    heartbeat_timeout_s: Optional[float] = 10.0
    # fault tolerance
    chaos: Optional[FaultPlan] = None  # deterministic fault injection
    checkpoint_dir: Optional[str] = None  # learner {params, round} ckpts
    checkpoint_every: int = 1
    keep_last_k: Optional[int] = 3
    resume: bool = False  # start from the latest committed checkpoint
    max_learner_restarts: int = 8  # bound on crash-recovery loops


class AsyncFederatedRuntime:
    """Owns transport + client actors for a run; single-use."""

    def __init__(self, cfg: RuntimeConfig, workload, device=None):
        fl = cfg.fl
        mech = protocol.canonical_mechanism(fl.mechanism)
        if mech not in protocol.PROTOCOL_MECHANISMS:
            raise ValueError(
                f"mechanism {fl.mechanism!r} has no integer wire format; "
                f"async runtime supports {protocol.PROTOCOL_MECHANISMS}"
            )
        self.cfg = cfg
        self.workload = workload
        self.device = resolve_device(device)
        # the synchronous loop's protocol, so staleness 0 reproduces it
        self.proto = federated.round_protocol(fl, self.device)

    def _restore(self, params0) -> Tuple[np.ndarray, int]:
        """Latest committed learner checkpoint, or the initial state."""
        d = self.cfg.checkpoint_dir
        last = ckpt_mod.latest_step(d) if d else None
        if last is None:
            return _host_f32(params0), 0
        state = ckpt_mod.restore(
            d, last, {"params": _host_f32(params0), "round": np.int64(0)},
            device="cpu")
        return _host_f32(state["params"]), int(state["round"])

    def _make_learner(self, params: np.ndarray, monitor: Monitor,
                      endpoint, checkpointer, fired) -> Learner:
        cfg = self.cfg
        return Learner(
            cfg.fl, self.proto, endpoint, params, monitor,
            staleness_bound=cfg.staleness_bound,
            staleness_weighting=cfg.staleness_weighting,
            quorum=cfg.quorum, round_timeout_s=cfg.round_timeout_s,
            poll_interval_s=cfg.poll_interval_s,
            buffer_capacity=cfg.buffer_capacity,
            heartbeat_timeout_s=cfg.heartbeat_timeout_s,
            chaos=cfg.chaos, checkpointer=checkpointer,
            checkpoint_every=cfg.checkpoint_every,
            fired_learner_crashes=fired,
        )

    def run(self, params0, n_rounds: int
            ) -> Tuple[np.ndarray, dict, List[RoundRecord]]:
        cfg = self.cfg
        fl = cfg.fl
        transport = make_transport(cfg.transport, fl.n_clients,
                                   cfg.drop_prob, drop_seed=fl.seed,
                                   chaos=cfg.chaos)
        monitor = Monitor(
            bits_per_coord_analytic=analytic_bits_per_coord(
                fl.mechanism, fl.n_clients, fl.sigma, fl.clip, self.device)
        )
        heartbeat_interval = (None if cfg.heartbeat_timeout_s is None
                              else cfg.heartbeat_timeout_s / 4.0)
        specs = [
            ClientSpec(
                client_id=i, seed=fl.seed, proto=self.proto,
                workload=self.workload, max_retries=cfg.max_retries,
                retry_backoff_s=cfg.retry_backoff_s,
                straggler_fraction=cfg.straggler_fraction,
                straggler_delay_s=cfg.straggler_delay_s,
                heartbeat_interval_s=heartbeat_interval,
                chaos=cfg.chaos,
            )
            for i in range(fl.n_clients)
        ]
        transport.start_clients(run_client, specs)
        checkpointer = None
        if cfg.checkpoint_dir:
            checkpointer = ckpt_mod.AsyncCheckpointer(
                cfg.checkpoint_dir, keep_last_k=cfg.keep_last_k)
        params = _host_f32(params0)
        start_round = 0
        if cfg.resume and cfg.checkpoint_dir:
            params, start_round = self._restore(params0)
        fired: set = set()
        restarts = 0
        endpoint = transport.learner_endpoint()
        try:
            while True:
                learner = self._make_learner(params, monitor, endpoint,
                                             checkpointer, fired)
                try:
                    params = learner.run(n_rounds, start_round=start_round)
                    break
                except LearnerKilled:
                    # the learner process "died" mid-round: recover from
                    # the last committed checkpoint (losing at most
                    # checkpoint_every - 1 rounds of progress), with a
                    # fresh buffer — exactly a real restart
                    restarts += 1
                    if restarts > cfg.max_learner_restarts:
                        raise
                    if checkpointer is not None:
                        checkpointer.wait()
                    params, start_round = self._restore(params0)
        finally:
            endpoint.broadcast(SHUTDOWN)
            transport.shutdown()
            if checkpointer is not None:
                checkpointer.close()
        summary = monitor.summary()
        monitor.close()
        summary["learner_restarts"] = restarts
        return params, summary, list(monitor.records)
