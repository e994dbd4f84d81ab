"""Pluggable learner<->client transports.

Two implementations behind one endpoint API:

  * ThreadTransport  — `queue.Queue` pairs, clients as daemon threads in
    this process.  Zero-copy, deterministic, the default for tests and
    the runtime benchmark.
  * ProcessTransport — `multiprocessing` (spawn) queues, clients as real
    OS processes, each with its own torch runtime (spawn, not fork: a
    forked child cannot initialise CUDA).

Both preserve integer payloads exactly (numpy arrays cross either
boundary bit-for-bit; the runtime tests pin this).  Loss injection
(`drop_prob`) makes `send` raise TransportError with a deterministic
per-client rng so the client actor's bounded retry/backoff path is
exercised without a flaky network.
"""
from __future__ import annotations

import multiprocessing
import queue
import threading
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from repro_torch.runtime.chaos import FaultPlan
from repro_torch.runtime.messages import ClientUpdate, RoundAnnounce

__all__ = [
    "TransportError",
    "LearnerEndpoint",
    "ClientEndpoint",
    "ThreadTransport",
    "ProcessTransport",
    "make_transport",
]


class TransportError(RuntimeError):
    """A send was lost (injected loss or closed peer); caller may retry."""


class ClientEndpoint:
    """One client's view: receive announces, send updates.

    Picklable when built over multiprocessing queues (the queues travel
    to the child through Process args — queue inheritance)."""

    def __init__(self, client_id: int, down, up, drop_prob: float = 0.0,
                 drop_seed: int = 0, chaos: Optional[FaultPlan] = None):
        self.client_id = client_id
        self._down = down
        self._up = up
        self._drop_prob = float(drop_prob)
        self._drop_seed = int(drop_seed)
        self._drop_rng = None  # built lazily so the endpoint pickles
        self._chaos = chaos

    def recv_latest(self, timeout: float) -> Optional[RoundAnnounce]:
        """Newest pending announce (drains the queue — a slow client
        skips rounds it missed instead of working through a backlog)."""
        try:
            msg = self._down.get(timeout=timeout)
        except queue.Empty:
            return None
        while True:
            try:
                msg = self._down.get_nowait()
            except queue.Empty:
                return msg

    def send(self, update) -> None:
        if self._drop_prob > 0.0 and isinstance(update, ClientUpdate):
            if self._drop_rng is None:
                self._drop_rng = np.random.default_rng(
                    (self._drop_seed, self.client_id)
                )
            if self._drop_rng.random() < self._drop_prob:
                raise TransportError(
                    f"injected loss (client {self.client_id}, "
                    f"attempt {update.attempt})"
                )
        if self._chaos is not None and isinstance(update, ClientUpdate):
            fault = self._chaos.transport_fault(self.client_id,
                                                update.origin_round)
            if fault is not None:
                if fault.kind == "drop":
                    return  # vanished in flight: no error, so no retry
                if fault.kind == "delay":
                    # held in flight; the client thread is NOT blocked
                    t = threading.Timer(fault.delay_s, self._up.put,
                                        args=(update,))
                    t.daemon = True
                    t.start()
                    return
                if fault.kind == "duplicate":
                    self._up.put(update)  # replayed once more below
        self._up.put(update)


class LearnerEndpoint:
    """The learner's view: broadcast announces, poll the shared uplink."""

    def __init__(self, downs: Sequence[Any], up):
        self._downs = list(downs)
        self._up = up

    @property
    def n_clients(self) -> int:
        return len(self._downs)

    def broadcast(self, announce: RoundAnnounce) -> None:
        for q in self._downs:
            q.put(announce)

    def send_to(self, client_id: int, msg) -> None:
        """Direct downlink to one client (JoinAck on re-admission)."""
        self._downs[client_id].put(msg)

    def poll(self, timeout: float) -> Optional[ClientUpdate]:
        try:
            return self._up.get(timeout=max(timeout, 1e-4))
        except queue.Empty:
            return None


class _BaseTransport:
    chaos: Optional[FaultPlan] = None

    def learner_endpoint(self) -> LearnerEndpoint:
        return LearnerEndpoint(self._downs, self._up)

    def client_endpoint(self, i: int) -> ClientEndpoint:
        return ClientEndpoint(i, self._downs[i], self._up,
                              self.drop_prob, self.drop_seed, self.chaos)


class ThreadTransport(_BaseTransport):
    kind = "thread"

    def __init__(self, n_clients: int, drop_prob: float = 0.0,
                 drop_seed: int = 0, chaos: Optional[FaultPlan] = None):
        self.n_clients = n_clients
        self.drop_prob = drop_prob
        self.drop_seed = drop_seed
        self.chaos = chaos
        self._downs = [queue.Queue() for _ in range(n_clients)]
        self._up: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []

    def start_clients(self, target: Callable, specs: Sequence[Any]) -> None:
        for i, spec in enumerate(specs):
            t = threading.Thread(
                target=target, args=(self.client_endpoint(i), spec),
                name=f"fl-client-{i}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def shutdown(self, timeout: float = 10.0) -> None:
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []


class ProcessTransport(_BaseTransport):
    kind = "process"

    def __init__(self, n_clients: int, drop_prob: float = 0.0,
                 drop_seed: int = 0, chaos: Optional[FaultPlan] = None):
        self.n_clients = n_clients
        self.drop_prob = drop_prob
        self.drop_seed = drop_seed
        self.chaos = chaos
        # spawn (not fork): a forked child cannot initialise CUDA
        self._ctx = multiprocessing.get_context("spawn")
        self._downs = [self._ctx.Queue() for _ in range(n_clients)]
        self._up = self._ctx.Queue()
        self._procs: List[Any] = []

    def start_clients(self, target: Callable, specs: Sequence[Any]) -> None:
        for i, spec in enumerate(specs):
            p = self._ctx.Process(
                target=target, args=(self.client_endpoint(i), spec),
                name=f"fl-client-{i}", daemon=True,
            )
            p.start()
            self._procs.append(p)

    def shutdown(self, timeout: float = 30.0) -> None:
        for p in self._procs:
            p.join(timeout=timeout)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        self._procs = []
        # a crashed/evicted client leaves its down queue with unread
        # announces; without this the queue's feeder thread blocks
        # interpreter exit flushing into a pipe nobody will ever read
        for q in (*self._downs, self._up):
            q.cancel_join_thread()


def make_transport(kind: str, n_clients: int, drop_prob: float = 0.0,
                   drop_seed: int = 0, chaos: Optional[FaultPlan] = None):
    if kind == "thread":
        return ThreadTransport(n_clients, drop_prob, drop_seed, chaos)
    if kind == "process":
        return ProcessTransport(n_clients, drop_prob, drop_seed, chaos)
    raise KeyError(f"unknown transport {kind!r}; have thread|process")
