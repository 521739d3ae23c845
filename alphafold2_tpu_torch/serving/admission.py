"""Fleet admission control: one shared queue, priorities, deadline shedding.

The port's copy of alphafold2_tpu/serving/admission.py: the same names, messages,
metric names and on-disk formats; Python and numpy only.

The single-engine queue (`ServingEngine`) is a plain bounded FIFO —
correct for one replica, but a fleet needs the front door to make
DECISIONS, not just hold requests:

  * **Priority classes** — "interactive" beats "normal" beats "batch".
    Dispatch order is (priority, arrival); under overload a higher-class
    arrival EVICTS the newest lowest-class entry rather than being shed
    behind it, so paying traffic is never starved by bulk backfill.
  * **Deadline enforcement** — an entry whose deadline passes while
    queued is shed at poll time with a structured `RequestTimeoutError`
    instead of burning a replica dispatch it can no longer use.
  * **Structured shedding** — every rejection carries `retry_after_s`
    derived from queue depth and the observed drain rate
    (`note_served`), so honest clients back off at the rate the fleet
    can actually absorb (the load-shedding half of the ParaFold
    split-and-pool serving story, arxiv 2111.06340).
  * **Requeue exemption** — entries requeued off a failed replica
    re-enter ahead of their class and are EXEMPT from capacity: a
    request the fleet already accepted is never shed by its own
    failover (the bounded requeue count lives in the fleet, not here).

Entries are duck-typed: anything with `priority` (int, lower = more
important), `deadline` (absolute monotonic seconds or None), and
`enqueued_at` works — the controller never resolves futures itself; it
RETURNS shed/evicted entries so the owner keeps sole authority over
terminal outcomes (and the counters that report them).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Tuple

from alphafold2_tpu_torch.serving.errors import QueueFullError

#: priority classes, lower value = dispatched first. Clients use the
#: names; the queue uses the ints.
PRIORITIES = {"interactive": 0, "normal": 1, "batch": 2}


def resolve_priority(priority) -> int:
    """Accept a class name or a raw int (smaller = more important)."""
    if isinstance(priority, str):
        try:
            return PRIORITIES[priority]
        except KeyError:
            raise ValueError(
                f"unknown priority class {priority!r}; expected one of "
                f"{sorted(PRIORITIES)} (or an int)"
            ) from None
    return int(priority)


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Front-door knobs (see docs/OPERATIONS.md "Fleet runbook")."""

    capacity: int = 64          # shared queue bound (backpressure point)
    min_retry_after_s: float = 0.05
    max_retry_after_s: float = 60.0
    service_rate_alpha: float = 0.2  # EMA weight for observed service time

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")


class AdmissionController:
    """Thread-safe shared priority queue with deadline + shed policy.

    `offer()` runs on submitter threads, `poll()` on the fleet dispatcher,
    `requeue()` on replica worker threads (failure callbacks) — one lock
    covers the queue; no callback ever runs under it.
    """

    def __init__(self, cfg: AdmissionConfig = AdmissionConfig(),
                 clock=time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._entries: List[Tuple[int, int, object]] = []  # sorted keys
        self._seq = 0
        self._service_ema_s: Optional[float] = None  # observed drain rate
        self.sheds = {"queue_full": 0, "evicted": 0, "deadline": 0}

    # ------------------------------------------------------------ admission

    def offer(self, entry):
        """Admit `entry`, or shed. Returns the entry this admission
        EVICTED (a lower-priority one, for the owner to fail with a
        retry-after error) or None. Raises QueueFullError — carrying
        `retry_after_s` — when the entry itself must shed (queue full of
        equal-or-higher-priority work)."""
        key = (resolve_priority(entry.priority),)
        with self._lock:
            evicted = None
            if len(self._entries) >= self.cfg.capacity:
                worst_i = max(
                    range(len(self._entries)),
                    key=lambda i: self._entries[i][:2],
                )
                worst = self._entries[worst_i]
                if worst[0] > key[0]:
                    # incoming outranks the worst queued entry: that
                    # entry sheds instead (newest of the lowest class —
                    # max seqno — so the class's FIFO head keeps its slot)
                    evicted = self._entries.pop(worst_i)[2]
                    self.sheds["evicted"] += 1
                else:
                    self.sheds["queue_full"] += 1
                    raise QueueFullError(
                        f"fleet queue at capacity ({self.cfg.capacity}) "
                        f"with no lower-priority entry to displace",
                        retry_after_s=self._retry_after_locked(),
                    )
            self._seq += 1
            self._insert_locked((key[0], self._seq, entry))
            self._cond.notify()
            return evicted

    def requeue(self, entry):
        """Re-admit an entry the fleet already accepted (replica failover).
        Capacity-EXEMPT and sequenced ahead of its priority class (seqno
        0) — failover must neither shed accepted work nor send it to the
        back of the line behind traffic that arrived after it."""
        with self._lock:
            self._insert_locked((resolve_priority(entry.priority), 0, entry))
            self._cond.notify()

    def _insert_locked(self, item):
        # sorted insert; queue stays small (capacity-bounded), so O(n)
        # beats a heap once lazy-deletion bookkeeping is priced in
        import bisect

        keys = [e[:2] for e in self._entries]
        self._entries.insert(bisect.bisect_right(keys, item[:2]), item)

    # ------------------------------------------------------------- polling

    def poll(self, timeout: Optional[float] = None):
        """Next dispatchable entry (or None at timeout), plus the entries
        whose deadlines expired while queued — the owner sheds those with
        `RequestTimeoutError(retry_after_s=...)`. Expired entries are
        harvested BEFORE choosing, so a stale head never shadows live
        work behind it."""
        deadline = None if timeout is None else self._clock() + timeout
        expired = []
        with self._lock:
            while True:
                now = self._clock()
                live_i = None
                for i, (_, _, entry) in enumerate(self._entries):
                    if entry.deadline is not None and now >= entry.deadline:
                        expired.append(entry)
                        self.sheds["deadline"] += 1
                        continue
                    live_i = i
                    break
                # drop harvested expired entries from the front section
                if expired:
                    self._entries = [
                        e for e in self._entries if e[2] not in expired
                    ]
                    live_i = 0 if self._entries else None
                if live_i is not None and self._entries:
                    _, _, entry = self._entries.pop(live_i)
                    return entry, expired
                if expired:
                    # deliver expirations promptly even with nothing live
                    return None, expired
                wait = None if deadline is None else deadline - self._clock()
                if wait is not None and wait <= 0:
                    return None, expired
                self._cond.wait(wait)

    # ------------------------------------------------------------ estimates

    def note_served(self, service_s: float):
        """Feed one completed request's dispatch->done seconds into the
        drain-rate EMA behind `retry_after_s` estimates."""
        with self._lock:
            a = self.cfg.service_rate_alpha
            self._service_ema_s = (
                service_s if self._service_ema_s is None
                else a * service_s + (1 - a) * self._service_ema_s
            )

    def retry_after_s(self) -> float:
        with self._lock:
            return self._retry_after_locked()

    def _retry_after_locked(self) -> float:
        """Depth x per-request service estimate = honest drain horizon;
        clamped so a cold queue still says SOMETHING actionable."""
        est = (self._service_ema_s or 1.0) * max(1, len(self._entries))
        return float(min(self.cfg.max_retry_after_s,
                         max(self.cfg.min_retry_after_s, est)))

    # -------------------------------------------------------------- stats

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries(self) -> list:
        """Snapshot of the queued entries (dispatch order, no removal) —
        the fleet's per-capability-pool depth gauges group this by each
        entry's target pool, so a shed can quote the CAPABLE pool's
        backlog instead of the global queue's."""
        with self._lock:
            return [e[2] for e in self._entries]

    def drain(self) -> list:
        """Remove and return every queued entry (fleet shutdown path)."""
        with self._lock:
            out = [e[2] for e in self._entries]
            self._entries = []
            return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "depth": len(self._entries),
                "capacity": self.cfg.capacity,
                "sheds": dict(self.sheds),
                "retry_after_s": self._retry_after_locked(),
                "service_ema_s": self._service_ema_s,
            }
