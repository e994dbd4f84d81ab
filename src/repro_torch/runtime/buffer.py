"""Bounded, staleness-aware round buffer.

The learner offers every polled `ClientUpdate` to the buffer; the buffer
is the single place that decides whether an update is usable:

  * origin round unknown (never announced / already pruned) -> reject;
  * staleness  = server_round - origin_round  > bound       -> reject;
  * dither seed != the expected key for (origin_round, pos) -> reject
    (desynchronized or replayed client);
  * duplicate (retry that eventually landed twice)          -> dropped;
  * capacity exceeded -> evict the *oldest* origin round first (the
    freshest information wins, the monitor counts the evictions).

`drain(server_round)` hands the learner everything usable grouped by
origin round and clears it — an update contributes to exactly one
server step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.runtime.messages import ClientUpdate

__all__ = ["RoundBuffer", "BufferStats", "staleness_weight",
           "combine_weights"]


def staleness_weight(staleness: int, weighting: str) -> float:
    if weighting == "uniform":
        return 1.0
    if weighting == "inverse":
        return 1.0 / (1.0 + staleness)
    raise KeyError(f"unknown staleness weighting {weighting!r}")


def combine_weights(group_sizes: Dict[int, int], server_round: int,
                    weighting: str) -> Dict[int, float]:
    """Normalized combine weights over drained origin-round groups,
    renormalized by the *surviving realized cohort*: each group's decoded
    mean enters the combine with weight ∝ w(staleness) · r_g, where r_g
    is the number of updates that actually landed for that origin round
    — a group carried by one straggling survivor cannot outvote a full
    current cohort, and evicted clients stop counting the moment they
    stop reporting."""
    raw = {
        g: staleness_weight(server_round - g, weighting) * max(int(r), 0)
        for g, r in group_sizes.items()
    }
    total = sum(raw.values())
    if total <= 0.0:
        return {g: 0.0 for g in raw}
    return {g: w / total for g, w in raw.items()}


@dataclasses.dataclass
class BufferStats:
    accepted: int = 0
    rejected_stale: int = 0
    rejected_unknown_round: int = 0
    rejected_bad_seed: int = 0
    duplicates: int = 0
    evicted: int = 0


@dataclasses.dataclass
class _RoundEntry:
    cohort: Tuple[int, ...]
    expected_seeds: Optional[np.ndarray]  # (n, 2) uint32, None = unchecked
    received: Dict[int, ClientUpdate] = dataclasses.field(default_factory=dict)


class RoundBuffer:
    def __init__(self, staleness_bound: int, capacity: int = 4096):
        if staleness_bound < 0:
            raise ValueError("staleness_bound must be >= 0")
        self.staleness_bound = int(staleness_bound)
        self.capacity = int(capacity)
        self.stats = BufferStats()
        self._rounds: Dict[int, _RoundEntry] = {}

    # ------------------------------------------------------------ rounds
    def register_round(self, rnd: int, cohort: Tuple[int, ...],
                       expected_seeds: Optional[np.ndarray] = None) -> None:
        """Announce bookkeeping: remember the cohort (and expected dither
        seeds) so late updates for this round can be validated."""
        self._rounds[rnd] = _RoundEntry(tuple(cohort), expected_seeds)

    def cohort_of(self, rnd: int) -> Optional[Tuple[int, ...]]:
        e = self._rounds.get(rnd)
        return e.cohort if e is not None else None

    # ------------------------------------------------------------- offer
    def offer(self, upd: ClientUpdate, server_round: int) -> str:
        entry = self._rounds.get(upd.origin_round)
        if entry is None:
            self.stats.rejected_unknown_round += 1
            return "unknown_round"
        staleness = upd.staleness(server_round)
        if staleness < 0 or staleness > self.staleness_bound:
            self.stats.rejected_stale += 1
            return "stale"
        if (upd.cohort_pos >= len(entry.cohort)
                or entry.cohort[upd.cohort_pos] != upd.client_id):
            self.stats.rejected_bad_seed += 1
            return "bad_seed"
        if entry.expected_seeds is not None and not np.array_equal(
            np.asarray(upd.dither_seed, np.uint32),
            entry.expected_seeds[upd.cohort_pos],
        ):
            self.stats.rejected_bad_seed += 1
            return "bad_seed"
        if upd.cohort_pos in entry.received:
            self.stats.duplicates += 1
            return "duplicate"
        entry.received[upd.cohort_pos] = upd
        self.stats.accepted += 1
        self._enforce_capacity()
        return "accepted"

    def _enforce_capacity(self) -> None:
        while self.size > self.capacity:
            oldest = min(
                (r for r, e in self._rounds.items() if e.received),
                default=None,
            )
            if oldest is None:
                return
            entry = self._rounds[oldest]
            pos = next(iter(entry.received))
            del entry.received[pos]
            self.stats.evicted += 1

    # ------------------------------------------------------------- drain
    @property
    def size(self) -> int:
        return sum(len(e.received) for e in self._rounds.values())

    def count(self, rnd: int) -> int:
        e = self._rounds.get(rnd)
        return len(e.received) if e is not None else 0

    def drain(self, server_round: int) -> Dict[int, Dict[int, ClientUpdate]]:
        """All usable updates grouped by origin round (ascending), then
        cleared; round entries that fell out of the staleness window are
        pruned so `offer` rejects them as unknown afterwards."""
        lo = server_round - self.staleness_bound
        out: Dict[int, Dict[int, ClientUpdate]] = {}
        for rnd in sorted(self._rounds):
            entry = self._rounds[rnd]
            if lo <= rnd <= server_round and entry.received:
                out[rnd] = dict(sorted(entry.received.items()))
                entry.received = {}
        for rnd in [r for r in self._rounds if r < lo]:
            del self._rounds[rnd]
        return out
