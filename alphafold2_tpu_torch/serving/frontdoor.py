"""Fleet front-door coalescing: one dispatch per identical in-flight key.

The port's copy of alphafold2_tpu/serving/frontdoor.py: the same names, messages,
metric names and on-disk formats; Python and numpy only.

The per-engine coalescing map (`ServingEngine._inflight`) collapses
identical submissions that land on the SAME replica. At fleet scale
that is the wrong unit: the router spreads identical requests across
the least-loaded replicas of a pool (and failovers move them between
pools), so a burst of N identical submissions costs up to N dispatches
even though one answer serves them all. This registry sits at the
fleet front door — after featurization, BEFORE pool routing — keyed by
the same content hash the artifact store uses, so the first submission
of a key becomes the LEADER (it proceeds through admission and routing
as always) and every subsequent identical submission attaches as a
FOLLOWER that never enters the admission queue.

The fleet settles the coalition at every leader-terminal path
(completion, shed, failure, shutdown): `settle` pops the followers and
the FLEET resolves them — success hands every follower the leader's
result (each `FleetRequest.result()` copy-stamps its own provenance),
failure propagates the leader's terminal error, exactly the
per-engine coalescing contract one level up. Followers carry their
leader's store key but never register one themselves, so a follower's
own terminal accounting can never pop a coalition it does not lead.

Lock discipline (af2lint CONC model): `_lock` guards only the waiter
dict and is never held while resolving a request or touching any other
lock — `register`/`settle` return immediately and the fleet does all
resolution outside it.
"""

from __future__ import annotations

import threading
from typing import Optional

from alphafold2_tpu_torch.telemetry import MetricRegistry


class FrontDoor:
    """Waiter registry keyed by (store tag, content hash)."""

    def __init__(self, registry: Optional[MetricRegistry] = None):
        self.registry = registry if registry is not None else MetricRegistry()
        self._lock = threading.Lock()
        self._waiters = {}   # key -> [follower FleetRequest, ...]
        self._coalesced = 0  # lifetime followers attached (snapshot mirror)
        self._coalesced_counter = self.registry.counter(
            "fleet_coalesced_total",
            help="submissions attached to an identical in-flight request "
                 "at the fleet front door (one dispatch serves them all)")

    def register(self, key, entry) -> bool:
        """True: `entry` is the leader for `key` (caller admits it).
        False: `entry` was attached as a follower of the in-flight
        leader and must NOT be admitted — it resolves at settle."""
        with self._lock:
            group = self._waiters.get(key)
            if group is None:
                self._waiters[key] = []
                return True
            group.append(entry)
            self._coalesced += 1
        self._coalesced_counter.inc()
        return False

    def settle(self, key) -> list:
        """Pop and return `key`'s followers (empty if already settled or
        never registered). Pop-once: the caller that receives the list
        owns resolving every entry in it."""
        with self._lock:
            return self._waiters.pop(key, [])

    def drain(self) -> list:
        """Shutdown backstop: pop EVERY follower still attached (their
        leaders settle through the normal terminal paths; this catches
        any coalition whose leader can no longer reach one)."""
        with self._lock:
            groups = list(self._waiters.values())
            self._waiters.clear()
        return [entry for group in groups for entry in group]

    def depth(self) -> int:
        """Followers currently waiting (not counting leaders)."""
        with self._lock:
            return sum(len(g) for g in self._waiters.values())

    def snapshot(self) -> dict:
        with self._lock:
            keys = len(self._waiters)
            waiting = sum(len(g) for g in self._waiters.values())
            lifetime = self._coalesced
        return {
            "inflight_keys": keys,
            "waiting_followers": waiting,
            "coalesced_total": lifetime,
        }
