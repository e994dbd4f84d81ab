"""Monitor actor: per-round runtime metrics.

The learner emits one `RoundRecord` per server round onto the monitor's
queue; a daemon thread folds them into the run summary so metric
aggregation never sits on the learner's critical path.  Collected per
round: wall-clock latency, cohort occupancy (realized / announced),
staleness histogram of the updates actually used, and message bits —
both measured (Elias-gamma over the real payloads) and analytic
(``repro_torch.dist.compress.message_bits`` for the configured
mechanism).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, List, Optional

import numpy as np

__all__ = ["RoundRecord", "Monitor", "_mean_recovery"]


def _mean_recovery(recs) -> float:
    """Mean length (in rounds) of consecutive degraded stretches — rounds
    where the realized current cohort fell short of the announced one.
    After a fault this is the time to recover full occupancy (via client
    rejoin or membership eviction shrinking the announced cohort); 0.0
    means no round was ever degraded."""
    runs, cur = [], 0
    for r in sorted(recs, key=lambda r: r.rnd):
        if r.announced and r.realized_current < r.announced:
            cur += 1
        elif cur:
            runs.append(cur)
            cur = 0
    if cur:
        runs.append(cur)
    return float(np.mean(runs)) if runs else 0.0


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    rnd: int
    latency_s: float
    announced: int
    realized_current: int  # updates from THIS round used in this step
    used_total: int        # including accepted stale updates
    staleness_counts: Dict[int, int]
    bits_total: float      # measured Elias-gamma bits across used payloads
    rejected_stale: int
    rejected_other: int
    update_norm: float
    # elastic membership (heartbeat/eviction/join protocol)
    active_members: int = 0  # membership size after this round's evictions
    evicted: int = 0         # members evicted during this round
    joined: int = 0          # members (re-)admitted during this round


class Monitor:
    """Queue-fed metrics actor.  `emit` is non-blocking for the learner;
    `summary` joins the queue so every record is folded in first."""

    def __init__(self, bits_per_coord_analytic: Optional[float] = None):
        self.bits_per_coord_analytic = bits_per_coord_analytic
        self.records: List[RoundRecord] = []
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, name="fl-monitor", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while True:
            rec = self._q.get()
            try:
                if rec is None:
                    return
                with self._lock:
                    self.records.append(rec)
            finally:
                self._q.task_done()

    def emit(self, rec: RoundRecord) -> None:
        self._q.put(rec)

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10.0)

    # ---------------------------------------------------------- summary
    def summary(self) -> Dict:
        self._q.join()
        with self._lock:
            recs = list(self.records)
        if not recs:
            return {"rounds": 0}
        hist: Dict[int, int] = {}
        for r in recs:
            for s, c in r.staleness_counts.items():
                hist[s] = hist.get(s, 0) + c
        lat = float(np.sum([r.latency_s for r in recs]))
        out = {
            "rounds": len(recs),
            "rounds_per_sec": len(recs) / max(lat, 1e-9),
            "mean_round_latency_s": lat / len(recs),
            "mean_cohort_occupancy": float(
                np.mean([r.realized_current / max(r.announced, 1)
                         for r in recs])
            ),
            "bits_per_round": float(np.mean([r.bits_total for r in recs])),
            "staleness_hist": {str(k): hist[k] for k in sorted(hist)},
            "stale_updates_used": sum(
                c for s, c in hist.items() if s > 0
            ),
            "rejected_stale": sum(r.rejected_stale for r in recs),
            "rejected_other": sum(r.rejected_other for r in recs),
            "empty_rounds": sum(1 for r in recs if r.used_total == 0),
            # elastic membership / fault recovery
            "evictions": sum(r.evicted for r in recs),
            "joins": sum(r.joined for r in recs),
            "active_members_final": recs[-1].active_members,
            "degraded_rounds": sum(
                1 for r in recs if r.realized_current < r.announced
            ),
            "recovery_rounds_mean": _mean_recovery(recs),
        }
        if self.bits_per_coord_analytic is not None:
            out["bits_per_coord_analytic"] = self.bits_per_coord_analytic
        return out
