"""Deterministic chaos / fault-injection harness for the async runtime.

A ``FaultPlan`` is a *seeded, frozen* schedule of failures: every
decision is a pure function of ``(plan.seed, client_id, round)``, so a
failure scenario is a reproducible test, not an anecdote — the same plan
produces the same crashes, drops, delays and duplicates on every run,
on the thread transport and the process transport alike (the plan is a
dataclass of primitives and pickles with the client spec).

Fault kinds and their injection points::

  client_crash   run_client     actor stops participating at round r;
                                with rejoin_after_s it sleeps, sends a
                                JoinRequest, and resumes (elastic join)
  learner_crash  Learner.step   raises LearnerKilled mid-round (after
                                the announce); the runtime restores the
                                latest committed checkpoint and re-runs
  drop           endpoint.send  the update vanishes silently (no
                                TransportError, so no client retry —
                                distinct from RuntimeConfig.drop_prob)
  delay          endpoint.send  the update is held delay_s before it
                                reaches the uplink queue
  duplicate      endpoint.send  the update is enqueued twice (replay;
                                the RoundBuffer must use it only once)
  slow_uplink    run_client     the client sleeps delay_s before
                                sending (straggling uplink: the update
                                itself is late, not just in flight)

Faults can be pinned (``Fault(kind, rnd, client_id)``) or rate-based
(``client_crash_rate`` etc.: a per-(client, round) Bernoulli draw from
the plan's seed, for chaos sweeps).  ``parse_plan`` turns a CLI spec
like ``"client_crash@1:2,drop@2:0"`` into a plan.  The plans, their
draws and their grammar are the JAX package's (``repro.runtime.chaos``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["Fault", "FaultPlan", "LearnerKilled", "parse_plan", "FAULT_KINDS"]

FAULT_KINDS = (
    "client_crash",
    "learner_crash",
    "drop",
    "delay",
    "duplicate",
    "slow_uplink",
)

_TRANSPORT_KINDS = ("drop", "delay", "duplicate")


class LearnerKilled(RuntimeError):
    """Injected learner crash; carries the round it fired in."""

    def __init__(self, rnd: int):
        super().__init__(f"injected learner crash at round {rnd}")
        self.rnd = rnd


@dataclasses.dataclass(frozen=True)
class Fault:
    """One pinned fault.  ``client_id=None`` matches every client (for
    client-scoped kinds); ``learner_crash`` ignores ``client_id``."""

    kind: str
    rnd: int
    client_id: Optional[int] = None
    delay_s: float = 0.25            # delay / slow_uplink hold time
    rejoin_after_s: Optional[float] = None  # client_crash: rejoin delay

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FAULT_KINDS}")

    def matches(self, kind: str, rnd: int,
                client_id: Optional[int] = None) -> bool:
        if self.kind != kind or self.rnd != rnd:
            return False
        if kind == "learner_crash":
            return True
        return self.client_id is None or self.client_id == client_id


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule: pinned faults plus Bernoulli rates."""

    seed: int = 0
    faults: Tuple[Fault, ...] = ()
    # rate-based faults, one independent draw per (client, round)
    client_crash_rate: float = 0.0
    drop_rate: float = 0.0
    delay_rate: float = 0.0
    duplicate_rate: float = 0.0
    delay_s: float = 0.25
    rejoin_after_s: Optional[float] = None  # rate-based crashes rejoin

    def __post_init__(self):
        for f in self.faults:
            if not isinstance(f, Fault):
                raise TypeError(f"faults must be Fault instances, got {f!r}")

    # ------------------------------------------------------------ draws
    def _hit(self, kind_tag: int, rate: float, cid: int, rnd: int) -> bool:
        if rate <= 0.0:
            return False
        rng = np.random.default_rng(
            (int(self.seed), int(kind_tag), int(cid), int(rnd)))
        return bool(rng.random() < rate)

    # ------------------------------------------------------------ queries
    def client_crash(self, cid: int, rnd: int) -> Optional[Fault]:
        """The crash fault hitting ``cid`` at ``rnd``, else None."""
        for f in self.faults:
            if f.matches("client_crash", rnd, cid):
                return f
        if self._hit(1, self.client_crash_rate, cid, rnd):
            return Fault("client_crash", rnd, cid,
                         rejoin_after_s=self.rejoin_after_s)
        return None

    def learner_crash(self, rnd: int) -> bool:
        return any(f.matches("learner_crash", rnd) for f in self.faults)

    def transport_fault(self, cid: int, rnd: int) -> Optional[Fault]:
        """The drop/delay/duplicate fault for ``cid``'s round-``rnd``
        update, else None (first matching pinned fault wins, then
        rates in drop > delay > duplicate order)."""
        for f in self.faults:
            if f.kind in _TRANSPORT_KINDS and f.matches(f.kind, rnd, cid):
                return f
        for tag, kind, rate in ((2, "drop", self.drop_rate),
                                (3, "delay", self.delay_rate),
                                (4, "duplicate", self.duplicate_rate)):
            if self._hit(tag, rate, cid, rnd):
                return Fault(kind, rnd, cid, delay_s=self.delay_s)
        return None

    def slow_uplink(self, cid: int, rnd: int) -> float:
        """Seconds to hold the update before sending (0 = healthy)."""
        for f in self.faults:
            if f.matches("slow_uplink", rnd, cid):
                return f.delay_s
        return 0.0

    @property
    def any_faults(self) -> bool:
        return bool(self.faults) or any(
            r > 0 for r in (self.client_crash_rate, self.drop_rate,
                            self.delay_rate, self.duplicate_rate))


def parse_plan(spec: str, seed: int = 0, delay_s: float = 0.25,
               rejoin_after_s: Optional[float] = None) -> FaultPlan:
    """Parse a CLI fault spec into a FaultPlan.

    Grammar (comma-separated):
      kind@rnd            learner_crash, or any-client faults
      kind@rnd:client     client-scoped fault
      crash_rate=0.2      rate-based knobs (crash_rate, drop_rate,
                          delay_rate, duplicate_rate)

    e.g. ``"client_crash@1:2,drop@2:0,learner_crash@3"`` or
    ``"crash_rate=0.2"``.
    """
    faults = []
    rates = {"crash_rate": 0.0, "drop_rate": 0.0, "delay_rate": 0.0,
             "duplicate_rate": 0.0}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" in part:
            k, v = part.split("=", 1)
            if k not in rates:
                raise ValueError(f"unknown rate {k!r}; have {sorted(rates)}")
            rates[k] = float(v)
            continue
        if "@" not in part:
            raise ValueError(f"fault {part!r} needs kind@rnd[:client]")
        kind, at = part.split("@", 1)
        cid: Optional[int] = None
        if ":" in at:
            at, c = at.split(":", 1)
            cid = int(c)
        faults.append(Fault(kind, int(at), cid, delay_s=delay_s,
                            rejoin_after_s=rejoin_after_s))
    return FaultPlan(
        seed=seed, faults=tuple(faults),
        client_crash_rate=rates["crash_rate"], drop_rate=rates["drop_rate"],
        delay_rate=rates["delay_rate"],
        duplicate_rate=rates["duplicate_rate"],
        delay_s=delay_s, rejoin_after_s=rejoin_after_s,
    )
