"""Client actor and staleness-aware, membership-aware learner.

Client actor (`run_client` — thread target or multiprocessing entry
point): waits for a round announce, computes its local update on the
announced params, encodes it to an integer message with the shared
protocol, and sends it with bounded retry/backoff.  Wall-clock
stragglers are simulated deterministically per (seed, client, round):
a straggling client sleeps past the learner's round deadline, so its
update arrives *late* and exercises the staleness path for real.
When a heartbeat interval is configured the actor beacons liveness
between rounds; a chaos `FaultPlan` can crash it at a pinned round
(optionally rejoining later via a JoinRequest) or hold its uplink.

Learner: per server round, announces the cohort (sampled with the same
`fl.federated.sample_cohort` logic as the synchronous loop, then
filtered to the *live membership* — clients whose heartbeats expired
are evicted and leave future cohorts), polls the transport until quorum
or timeout, buffers everything through the staleness-aware
`RoundBuffer`, then aggregates the drained groups — each origin round
decoded with ITS OWN round key and realized subset (homomorphic decode
only combines messages that share a round's randomness), then combined
across rounds with staleness weights renormalized over the surviving
realized cohort (`buffer.combine_weights`).  With a checkpointer
attached, the learner saves `{params, round}` on a cadence so an
injected (or real) learner crash resumes from the last committed round
instead of round zero.

The port's actors run the protocol on its device (``RoundProtocol.
device``: CUDA unless "cpu" is asked for): a client builds its workload
there and encodes there; params cross the transport as numpy f32 and
payloads as numpy integers, as in the JAX package.  The JAX package's
client-side compilation-cache hook has no counterpart (the port compiles
nothing per client; see the port's README).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

# Module-style import: repro_torch.fl.federated itself imports
# repro_torch.runtime.protocol, so this module may load while federated
# is still mid-import: attributes are resolved at call time, never here.
import repro_torch.fl.federated as federated
from repro_torch.runtime import protocol
from repro_torch.runtime.buffer import (RoundBuffer, combine_weights,
                                        staleness_weight)
from repro_torch.runtime.chaos import FaultPlan, LearnerKilled
from repro_torch.runtime.messages import (
    ClientUpdate,
    Heartbeat,
    JoinAck,
    JoinRequest,
    RoundAnnounce,
)
from repro_torch.runtime.monitor import Monitor, RoundRecord
from repro_torch.runtime.transport import ClientEndpoint, TransportError

__all__ = ["ClientSpec", "run_client", "Learner", "staleness_weight"]


@dataclasses.dataclass(frozen=True)
class ClientSpec:
    """Everything a client actor needs — picklable, so the same spec
    drives a thread or a spawned process."""

    client_id: int
    seed: int
    proto: protocol.RoundProtocol  # its device is the client's
    workload: object  # .build(device) -> grad(flat, cid, rnd) -> flat
    max_retries: int = 3
    retry_backoff_s: float = 0.01
    straggler_fraction: float = 0.0
    straggler_delay_s: float = 0.5
    idle_timeout_s: float = 0.2
    heartbeat_interval_s: Optional[float] = None  # None = no beacons
    join_on_start: bool = False  # announce ourselves before the first round
    chaos: Optional[FaultPlan] = None


def _is_straggler(spec: ClientSpec, rnd: int) -> bool:
    if spec.straggler_fraction <= 0.0:
        return False
    rng = np.random.default_rng((spec.seed, spec.client_id, rnd))
    return bool(rng.random() < spec.straggler_fraction)


def _safe_send(endpoint: ClientEndpoint, msg) -> None:
    """Control-plane sends (heartbeat / join) are best-effort: a lost
    beacon costs at worst an eviction-and-rejoin, never the actor."""
    try:
        endpoint.send(msg)
    except (TransportError, OSError):
        pass


class _HeartbeatBeacon:
    """Sidecar thread that beacons liveness for the client actor.

    The actor's main thread can be stuck inside a long first round (a
    kernel build, a large update): beaconing inline between recv polls
    goes silent exactly then, and the learner evicts a healthy client.
    A daemon thread beacons on its own clock instead; chaos crash windows
    ``pause()`` it so injected crashes still look dead to the learner's
    eviction sweep.

    The transport endpoints are queue-backed and thread-safe, so the
    beacon shares the actor's endpoint.
    """

    def __init__(self, endpoint: ClientEndpoint, client_id: int,
                 interval_s: float):
        self._endpoint = endpoint
        self._client_id = client_id
        self._interval = float(interval_s)
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"fl-beacon-{client_id}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            if not self._paused.is_set():
                _safe_send(self._endpoint,
                           Heartbeat(self._client_id, time.time()))


def run_client(endpoint: ClientEndpoint, spec: ClientSpec) -> None:
    grad = spec.workload.build(device=spec.proto.device)
    chaos = spec.chaos
    if spec.join_on_start:
        _safe_send(endpoint, JoinRequest(spec.client_id, time.time()))
    beacon = None
    if spec.heartbeat_interval_s is not None:
        beacon = _HeartbeatBeacon(endpoint, spec.client_id,
                                  spec.heartbeat_interval_s)
        beacon.start()
    try:
        _run_client_loop(endpoint, spec, grad, chaos, beacon)
    finally:
        if beacon is not None:
            beacon.stop()


def _run_client_loop(endpoint: ClientEndpoint, spec: ClientSpec, grad,
                     chaos, beacon: Optional[_HeartbeatBeacon]) -> None:
    while True:
        ann = endpoint.recv_latest(timeout=spec.idle_timeout_s)
        if ann is None or isinstance(ann, JoinAck):
            continue  # JoinAck: admission confirmed; next announce has work
        if ann.shutdown:
            return
        if spec.client_id not in ann.cohort:
            continue
        if chaos is not None:
            fault = chaos.client_crash(spec.client_id, ann.rnd)
            if fault is not None:
                if fault.rejoin_after_s is None:
                    return  # hard crash: the actor dies mid-round
                # transient crash: dead silent through the round(s) —
                # pause the beacon so the eviction sweep sees the crash
                # — then the elastic join path: announce and resume
                if beacon is not None:
                    beacon.pause()
                time.sleep(fault.rejoin_after_s)
                _safe_send(endpoint, JoinRequest(spec.client_id, time.time()))
                if beacon is not None:
                    beacon.resume()
                continue
        if _is_straggler(spec, ann.rnd):
            time.sleep(spec.straggler_delay_s)
        pos = ann.cohort.index(spec.client_id)
        n = len(ann.cohort)
        params = torch.from_numpy(ann.params).to(spec.proto.device)
        x = grad(params, spec.client_id, ann.rnd)
        key = protocol.round_key(spec.seed, ann.rnd)
        upd = ClientUpdate(
            client_id=spec.client_id,
            origin_round=ann.rnd,
            cohort_pos=pos,
            payload=spec.proto.client_message(key, n, pos, x).cpu().numpy(),
            # repro-lint: disable=rng-key-reuse -- both callees only
            # *derive* from the round key (split inside); the second use
            # re-derives the same dither key for provenance, by design
            dither_seed=protocol.client_dither_key(key, n, pos).numpy()
            .astype(np.uint32),
            sent_at=time.time(),
        )
        if chaos is not None:
            hold = chaos.slow_uplink(spec.client_id, ann.rnd)
            if hold > 0.0:
                time.sleep(hold)  # straggling uplink: the send itself is late
        for attempt in range(spec.max_retries + 1):
            try:
                endpoint.send(dataclasses.replace(upd, attempt=attempt))
                break
            except TransportError:
                if attempt == spec.max_retries:
                    break  # give up; the learner proceeds without us
                time.sleep(spec.retry_backoff_s * (2.0 ** attempt))


def _host_f32(params) -> np.ndarray:
    """A flat parameter vector (numpy or a tensor on any device) as host
    numpy f32, the form it crosses the transport in."""
    if isinstance(params, torch.Tensor):
        params = params.detach().cpu().numpy()
    return np.asarray(params, np.float32)


class Learner:
    """Server actor: drives rounds, owns the buffer, params, membership."""

    def __init__(self, fl: federated.FLConfig, proto: protocol.RoundProtocol,
                 endpoint, params0, monitor: Monitor, *,
                 staleness_bound: int = 0, staleness_weighting: str = "uniform",
                 quorum: float = 1.0, round_timeout_s: float = 30.0,
                 poll_interval_s: float = 0.002, buffer_capacity: int = 4096,
                 heartbeat_timeout_s: Optional[float] = None,
                 chaos: Optional[FaultPlan] = None,
                 checkpointer=None, checkpoint_every: int = 1,
                 fired_learner_crashes: Optional[Set[int]] = None):
        self.fl = fl
        self.proto = proto
        self.endpoint = endpoint
        self.params = _host_f32(params0)
        self.monitor = monitor
        self.staleness_weighting = staleness_weighting
        self.quorum = quorum
        self.round_timeout_s = round_timeout_s
        self.poll_interval_s = poll_interval_s
        self.buffer = RoundBuffer(staleness_bound, buffer_capacity)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.chaos = chaos
        self.checkpointer = checkpointer
        self.checkpoint_every = max(int(checkpoint_every), 1)
        # learner-crash faults fire once per round across restarts — the
        # runtime threads this set through resumes, else a deterministic
        # plan would re-kill the resumed learner at the same round forever
        self.fired_learner_crashes = (
            fired_learner_crashes if fired_learner_crashes is not None
            else set()
        )
        # live membership: client -> last proof of life (monotonic)
        now = time.monotonic()
        self.members: Dict[int, float] = {i: now for i in range(fl.n_clients)}
        self.evicted_total = 0
        self.joined_total = 0
        self._round_evicted = 0
        self._round_joined = 0

    # -------------------------------------------------------- membership
    def _touch(self, cid: int) -> None:
        if cid in self.members:
            self.members[cid] = time.monotonic()

    def _admit(self, cid: int, rnd: int) -> None:
        """JoinRequest handling: (re-)admit and answer with the current
        round + model so the joiner is round-current immediately."""
        fresh = cid not in self.members
        self.members[cid] = time.monotonic()
        if fresh:
            self.joined_total += 1
            self._round_joined += 1
        self.endpoint.send_to(cid, JoinAck(rnd=rnd, params=self.params))

    def _evict_expired(self) -> None:
        if self.heartbeat_timeout_s is None:
            return
        cutoff = time.monotonic() - self.heartbeat_timeout_s
        dead = [cid for cid, ts in self.members.items() if ts < cutoff]
        for cid in dead:
            del self.members[cid]
        self.evicted_total += len(dead)
        self._round_evicted += len(dead)

    def _handle(self, msg, rnd: int) -> None:
        """Dispatch one polled uplink message."""
        if isinstance(msg, ClientUpdate):
            self._touch(msg.client_id)
            self.buffer.offer(msg, server_round=rnd)
        elif isinstance(msg, Heartbeat):
            self._touch(msg.client_id)
        elif isinstance(msg, JoinRequest):
            self._admit(msg.client_id, rnd)

    # ------------------------------------------------------------ rounds
    def _need(self, cohort: Tuple[int, ...]) -> int:
        """Quorum over the SURVIVING cohort: members evicted mid-round
        stop counting toward the deadline, so a round never stalls
        waiting for a client the membership already declared dead."""
        alive = sum(1 for c in cohort if c in self.members)
        return max(1, math.ceil(self.quorum * max(alive, 1)))

    def _gather(self, rnd: int, cohort: Tuple[int, ...],
                deadline: float) -> None:
        while time.monotonic() < deadline:
            self._evict_expired()
            if self.buffer.count(rnd) >= self._need(cohort):
                return
            msg = self.endpoint.poll(
                timeout=min(self.poll_interval_s,
                            max(deadline - time.monotonic(), 1e-4))
            )
            if msg is not None:
                self._handle(msg, rnd)

    def _combine(self, rnd: int) -> Tuple[Optional[torch.Tensor], Dict]:
        """Decode each drained origin-round group with its own key and
        realized subset, then staleness-weight across groups with the
        realized-cohort renormalization."""
        groups = self.buffer.drain(rnd)
        info: Dict = {"staleness_counts": {}, "used_total": 0,
                      "realized_current": 0, "bits_total": 0.0}
        ys: Dict[int, torch.Tensor] = {}
        sizes: Dict[int, int] = {}
        for g, received in groups.items():
            cohort = self.buffer.cohort_of(g)
            n = len(cohort)
            d = self.params.size
            # buffer rows match the wire payload (packed protocols carry
            # fewer int32 words than coordinates), not the update dim
            first = np.asarray(next(iter(received.values())).payload)
            msgs = np.zeros((n, first.size), first.dtype)
            mask = np.zeros(n, bool)
            for pos, upd in received.items():
                msgs[pos] = upd.payload
                mask[pos] = True
            y, bits = self.proto.decode(
                protocol.round_key(self.fl.seed, g), n,
                torch.from_numpy(msgs), mask, d=d)
            s = rnd - g
            ys[g] = y
            sizes[g] = len(received)
            info["staleness_counts"][s] = len(received)
            info["used_total"] += len(received)
            info["bits_total"] += bits * d * len(received)
            if s == 0:
                info["realized_current"] = len(received)
        if not ys:
            return None, info
        if len(ys) == 1:
            # single group: no reweighting arithmetic — staleness 0 with
            # a full cohort must reproduce the synchronous round bitwise
            return next(iter(ys.values())), info
        ws = combine_weights(sizes, rnd, self.staleness_weighting)
        acc = None
        for g, y in ys.items():
            term = ws[g] * y
            acc = term if acc is None else acc + term
        return acc, info

    def step(self, rnd: int) -> RoundRecord:
        fl = self.fl
        t0 = time.monotonic()
        self._round_evicted = 0
        self._round_joined = 0
        self._evict_expired()
        sampled = federated.sample_cohort(
            fl.n_clients, fl.cohort_fraction, fl.straggler_fraction,
            fl.seed, rnd)
        # elastic membership: evicted clients leave the announced cohort
        # (at full membership this is exactly the synchronous cohort)
        cohort = tuple(int(c) for c in sampled if int(c) in self.members)
        if not cohort and self.members:
            cohort = (min(self.members),)  # deterministic non-empty fallback
        key = protocol.round_key(fl.seed, rnd)
        self.buffer.register_round(
            rnd, cohort, protocol.expected_dither_keys(key, len(cohort))
            if cohort else None)
        rej0 = self.buffer.stats.rejected_stale
        oth0 = (self.buffer.stats.rejected_unknown_round
                + self.buffer.stats.rejected_bad_seed)
        self.endpoint.broadcast(RoundAnnounce(rnd, cohort, self.params))
        if (self.chaos is not None and rnd not in self.fired_learner_crashes
                and self.chaos.learner_crash(rnd)):
            # mid-round kill: the announce is out, the step is not — a
            # resumed learner re-announces this round from its checkpoint
            self.fired_learner_crashes.add(rnd)
            raise LearnerKilled(rnd)
        if cohort:
            self._gather(rnd, cohort, t0 + self.round_timeout_s)
        y, info = self._combine(rnd)
        norm = 0.0
        if y is not None:
            # the SGD step as the synchronous loop takes it, on the
            # protocol's device (the same f32 ops, so the same bits); the
            # new params go back to the host for the next announce
            params = torch.from_numpy(self.params).to(y.device)
            self.params = (params - self.fl.lr * y).cpu().numpy()
            norm = float(torch.linalg.vector_norm(y))
        if (self.checkpointer is not None
                and (rnd + 1) % self.checkpoint_every == 0):
            self.checkpointer.save(
                rnd + 1,
                {"params": self.params, "round": np.int64(rnd + 1)},
            )
        rec = RoundRecord(
            rnd=rnd,
            latency_s=time.monotonic() - t0,
            announced=len(cohort),
            realized_current=info["realized_current"],
            used_total=info["used_total"],
            staleness_counts=info["staleness_counts"],
            bits_total=info["bits_total"],
            rejected_stale=self.buffer.stats.rejected_stale - rej0,
            rejected_other=(self.buffer.stats.rejected_unknown_round
                            + self.buffer.stats.rejected_bad_seed - oth0),
            update_norm=norm,
            active_members=len(self.members),
            evicted=self._round_evicted,
            joined=self._round_joined,
        )
        self.monitor.emit(rec)
        return rec

    def run(self, n_rounds: int, start_round: int = 0) -> np.ndarray:
        for rnd in range(start_round, n_rounds):
            self.step(rnd)
        return self.params
