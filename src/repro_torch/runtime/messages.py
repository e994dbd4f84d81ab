"""Wire messages of the actor/learner runtime.

Uplink (client -> learner) carries **integers only**: the quantized
payload produced by ``runtime.protocol`` plus the raw dither seed (uint32
key data) the learner verifies against the round's expected keys before
accepting — a desynchronized or replayed client is rejected, not
silently decoded with the wrong shared randomness.

Downlink (learner -> client) is the round announce: round id, the
announced cohort, and the current flat parameter vector (the trusted
server broadcast of the paper's model; compression in this repo targets
the client->server direction, see Sec. 5).

Everything is plain dataclasses over numpy so both the in-process and
the multiprocessing transports move messages without custom picklers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["RoundAnnounce", "ClientUpdate", "Heartbeat", "JoinRequest",
           "JoinAck", "SHUTDOWN"]


@dataclasses.dataclass(frozen=True)
class RoundAnnounce:
    """Learner -> clients: start of a round (or shutdown sentinel)."""

    rnd: int
    cohort: Tuple[int, ...]
    params: Optional[np.ndarray]  # flat float32; None on shutdown
    shutdown: bool = False


SHUTDOWN = RoundAnnounce(rnd=-1, cohort=(), params=None, shutdown=True)


@dataclasses.dataclass(frozen=True)
class ClientUpdate:
    """Client -> learner: one encoded update.

    payload:     integer message: one signed word per coordinate
                 (int32/int16/int8, shape (d,)), or — packed protocols —
                 biased b-bit fields in int32 words (shorter than d;
                 payloads of different clients add homomorphically).
    dither_seed: (2,) uint32 key data of the client's dither key —
                 checked against `protocol.expected_dither_keys`.
    origin_round / cohort_pos: the round (and the client's slot in its
                 announced cohort) whose params produced this update;
                 the learner derives staleness from origin_round.
    attempt:     retry sequence number (0 = first send).
    """

    client_id: int
    origin_round: int
    cohort_pos: int
    payload: np.ndarray
    dither_seed: np.ndarray
    attempt: int = 0
    sent_at: float = 0.0

    def staleness(self, server_round: int) -> int:
        return server_round - self.origin_round


@dataclasses.dataclass(frozen=True)
class Heartbeat:
    """Client -> learner: liveness beacon.  The learner evicts members
    whose last heartbeat (or update) is older than the configured
    timeout; evicted clients leave future announced cohorts, so the
    realized-cohort renormalization reflects true membership."""

    client_id: int
    sent_at: float = 0.0


@dataclasses.dataclass(frozen=True)
class JoinRequest:
    """Client -> learner: (re)join the membership — sent by a fresh
    client at startup after a crash, or by a crashed-and-recovered actor
    (chaos ``rejoin_after_s``).  The learner re-admits the client and
    answers with a JoinAck."""

    client_id: int
    sent_at: float = 0.0


@dataclasses.dataclass(frozen=True)
class JoinAck:
    """Learner -> one client: admission.  Carries the current round (the
    joiner derives the round key locally from it, like everyone else)
    and the current model, so a joiner is round-current immediately
    instead of waiting out a full announce cycle."""

    rnd: int
    params: Optional[np.ndarray]
