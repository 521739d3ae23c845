"""Elastic replica autoscaler: close the loop from signals to capacity
(the port's copy of alphafold2_tpu/serving/autoscale.py, its imports
renamed; on the card a scale-up's engine build captures its graphs, each
capture under the card's lock, while the other replicas serve).

The ops plane made the fleet measurable while it runs — queue-wait
p95, per-replica occupancy, SLO burn rate all live in the registry — but
the replica count stayed a static `--replicas` flag: an operator reading
a burning queue-wait SLO still had to redeploy to add capacity. This
module is the missing actuator:

  `ScalePolicy`        declarative thresholds + hysteresis (JSON-loadable
                       like SLO configs and fault plans; unknown keys
                       reject loudly). Clock-invariant: the policy talks
                       thresholds and windows, never wall-clock now().
  `ReplicaAutoscaler`  a clock-injectable evaluator ticked periodically —
                       registerable as an `OpsTicker` hook (tick is
                       reentrancy-guarded), though serve.py runs it on
                       its OWN control thread so a scale-up's engine
                       build (seconds of graph capture) cannot stall the
                       shared ticker's SLO/recorder/gauge work. Each
                       tick refreshes the live queue gauges, reads the
                       registry signals, runs the
                       sustain/hysteresis state machine, and grows or
                       shrinks the pool through `ServingFleet.add_replica`
                       / `remove_replica` — which retire capacity through
                       the SAME HealthMonitor drain path a sick replica
                       takes, so in-flight work requeues and nothing is
                       lost across a scale event.

Signals (all read from the fleet registry, so the autoscaler's inputs
are exactly what `/metrics` scrapes show an operator):

  * `fleet_queue_wait_seconds` p95 — the demand signal; sustained waits
    past `up_queue_wait_p95_s` with a non-empty queue mean the pool is
    underwater.
  * `slo_burn_rate{window="fast"}` — the SLO engine's verdict; burn past
    `up_burn` is the "users are noticing" trigger.
  * `fleet_occupancy` — dispatched work per slot of healthy capacity;
    high occupancy scales up before queue-wait degrades, low occupancy
    with an empty queue is the scale-DOWN signal (queue-wait p95 is a
    sliding window and stays high after a burst — it must never be the
    idle signal).

Hysteresis, the no-flap contract: an action needs its signal SUSTAINED
for `up_sustain`/`down_sustain` consecutive ticks, and any action starts
a cooldown (`up_cooldown_s`/`down_cooldown_s`, measured from the LAST
action in either direction) inside which the opposite decision is
suppressed — so the pool can never oscillate faster than its hysteresis
window, which the chaos suite drives directly with `scale_flap` faults
(forced alternating demands that bypass sustain but not the window).

Zero-downtime deploys ride the same machinery: `ServingFleet.
rolling_update` cycles each replica through the drain path one at a
time while the rest keep serving (docs/OPERATIONS.md runbook).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
import traceback
from typing import Optional

from alphafold2_tpu_torch.serving.errors import ScaleRejectedError
from alphafold2_tpu_torch.telemetry import MetricRegistry

_POLICY_KEYS = {
    "min_replicas", "max_replicas", "up_queue_wait_p95_s", "up_burn",
    "up_occupancy", "down_occupancy", "up_sustain", "down_sustain",
    "up_cooldown_s", "down_cooldown_s", "up_headroom",
}


@dataclasses.dataclass(frozen=True)
class ScalePolicy:
    """Autoscaling thresholds + hysteresis (module docstring)."""

    min_replicas: int = 1
    max_replicas: int = 4
    # scale-up triggers (any one, sustained `up_sustain` ticks):
    up_queue_wait_p95_s: float = 2.0   # queue-wait p95 with a live queue
    up_burn: float = 2.0               # fast-window SLO burn rate
    up_occupancy: float = 0.85         # dispatched work / healthy slots
    up_headroom: float = 0.15          # MODEL trigger: scale up when the
    #                                    cost-ledger capacity model says
    #                                    fleet_pool_headroom_ratio fell to
    #                                    this — a LEADING signal that fires
    #                                    before queue-wait p95 (a lagging
    #                                    symptom) crosses its threshold.
    #                                    Inert until the gauge exists
    #                                    (measured batches); 0 disables.
    # scale-down trigger (all, sustained `down_sustain` ticks):
    down_occupancy: float = 0.25       # ... with an EMPTY queue
    up_sustain: int = 2
    down_sustain: int = 5
    # cooldowns, both measured from the last action in EITHER direction —
    # down_cooldown_s is the hysteresis window that forbids up->down flap
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 30.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})"
            )
        if self.up_sustain < 1 or self.down_sustain < 1:
            raise ValueError("sustain counts must be >= 1")
        if self.up_cooldown_s < 0 or self.down_cooldown_s < 0:
            raise ValueError("cooldowns must be >= 0")
        if (self.up_queue_wait_p95_s <= 0 or self.up_burn <= 0
                or not 0 < self.up_occupancy <= 1
                or not 0 <= self.down_occupancy < self.up_occupancy):
            raise ValueError(
                "thresholds must be positive, with "
                "0 <= down_occupancy < up_occupancy <= 1"
            )
        if not 0 <= self.up_headroom < 1:
            raise ValueError(
                f"up_headroom must be in [0, 1) (0 disables), got "
                f"{self.up_headroom}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "ScalePolicy":
        unknown = set(d) - _POLICY_KEYS
        if unknown:
            # the faults --check stance: a typo'd knob must not silently
            # leave the default in force
            raise ValueError(
                f"unknown scale-policy key(s) {sorted(unknown)}; known: "
                f"{sorted(_POLICY_KEYS)}"
            )
        return cls(**d)

    @classmethod
    def from_file(cls, path: str) -> "ScalePolicy":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


class ReplicaAutoscaler:
    """Hysteresis autoscaler over one `ServingFleet` (module docstring).

    Args:
      fleet: the scaling target. Duck-typed surface: `registry`,
        `sample_gauges()`, `replica_count()`, `add_replica()`,
        `remove_replica()`, `attach_autoscaler(self)`, `_closed` — tests
        substitute a stub.
      policy: `ScalePolicy`.
      clock: injectable monotonic clock (the whole unit matrix runs
        without sleeping).
      incident_hook: optional `fn(kind, **attrs)` — scale events report
        as `scale_up` / `scale_down` (flight-recorder seam), so a bundle
        captures what the fleet looked like around the event.
      fault_hook: chaos seam (`FaultInjector.autoscale_hook()`): called
        with the tick index; a returned "up"/"down" is a FORCED demand
        (bypasses sustain, still subject to cooldown/min/max).
      pool: "" (default) scales the whole fleet off the fleet-wide
        signals — the homogeneous fleet's behavior. A capability-pool name
        scopes EVERYTHING to that pool: signals read the pool-labeled
        families (`fleet_pool_queue_depth` / `fleet_pool_occupancy` /
        `fleet_pool_queue_wait_seconds` p95), actions call
        `add_replica(pool=)` / `remove_replica(pool=)`, and the size
        check uses `replica_count(pool)` — so a heterogeneous fleet runs
        one autoscaler per pool and a saturated SP pool grows while the
        idle dense pool shrinks, independently (ROADMAP item 4b). The
        SLO fast-burn trigger stays fleet-wide (objectives are
        fleet-level) but only fires a pool whose own queue is live.
    """

    def __init__(self, fleet, policy: ScalePolicy, *,
                 registry: Optional[MetricRegistry] = None,
                 clock=time.monotonic, incident_hook=None, fault_hook=None,
                 max_events: int = 256, pool: str = ""):
        self.fleet = fleet
        self.policy = policy
        self.pool = pool
        self.registry = registry if registry is not None else fleet.registry
        self._clock = clock
        self._incident_hook = incident_hook
        self._fault_hook = fault_hook
        self._lock = threading.Lock()
        self._ticks = 0
        self._up_streak = 0
        self._down_streak = 0
        self._last_action: Optional[str] = None
        self._last_action_at: Optional[float] = None
        self._events = collections.deque(maxlen=max_events)
        pool_label = {"pool": pool} if pool else {}
        self._decisions = {
            name: self.registry.counter(
                "autoscale_decisions_total",
                help="autoscaler decisions by outcome", action=name,
                **pool_label)
            for name in ("up", "down", "rejected", "suppressed")
        }
        # pool size itself is the fleet's gauge (fleet_replicas, set by
        # sample_gauges) — a second autoscaler-side copy would just be a
        # momentarily-disagreeing duplicate
        self._tick_gate = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        attach = getattr(fleet, "attach_autoscaler", None)
        if attach is not None:
            attach(self)

    # ------------------------------------------------------------- signals

    def _signals(self) -> dict:
        fams = self.registry.collect()

        def max_gauge(name, **want):
            fam = fams.get(name)
            if fam is None:
                return 0.0
            vals = [m.value for key, m in fam[1].items()
                    if all(dict(key).get(k) == v for k, v in want.items())]
            return max(vals, default=0.0)

        # pool-scoped: the pool-labeled families (ServingFleet
        # sample_gauges / _try_dispatch publish them) — never the global
        # ones, which mix every pool's traffic together
        if self.pool:
            depth_name, occ_name = ("fleet_pool_queue_depth",
                                    "fleet_pool_occupancy")
            wait_name, want = ("fleet_pool_queue_wait_seconds",
                               {"pool": self.pool})
        else:
            depth_name, occ_name = "fleet_queue_depth", "fleet_occupancy"
            wait_name, want = "fleet_queue_wait_seconds", {}

        p95 = 0.0
        fam = fams.get(wait_name)
        if fam is not None and fam[0] == "histogram":
            p95 = max((m.percentile(95.0) for key, m in fam[1].items()
                       if all(dict(key).get(k) == v
                              for k, v in want.items())),
                      default=0.0)
        # headroom (fleet_pool_headroom_ratio, the cost-ledger capacity
        # model): None while the gauge is ABSENT — the trigger must stay
        # inert until the pool has measured batches, and a
        # default-to-zero here would read "no data" as "no headroom"
        # and scale every cold fleet to max
        headroom = None
        fam = fams.get("fleet_pool_headroom_ratio")
        if fam is not None:
            pool_want = {"pool": self.pool} if self.pool else {}
            vals = [m.value for key, m in fam[1].items()
                    if all(dict(key).get(k) == v
                           for k, v in pool_want.items())]
            if vals:
                # fleet-wide scaler: the TIGHTEST pool is the signal
                headroom = min(vals)
        return {
            "queue_depth": max_gauge(depth_name, **want),
            "occupancy": max_gauge(occ_name, **want),
            "queue_wait_p95": p95,
            "burn_fast": max_gauge("slo_burn_rate", window="fast"),
            "headroom": headroom,
        }

    # ---------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None):
        """One evaluation pass. Never raises — rejected actions are
        decisions, not crashes. Reentrancy-guarded: a tick whose scale
        action is still building an engine (adds can capture graphs for
        seconds) makes overlapping ticks no-ops instead of stacking.
        NOTE serve.py runs this on the autoscaler's OWN thread, not the
        shared OpsTicker — a slow engine build must not stall SLO
        evaluation / flight-recorder polling / gauge sampling during
        exactly the overload window that triggered the scale-up."""
        if not self._tick_gate.acquire(blocking=False):
            return
        try:
            self._tick(now)
        finally:
            self._tick_gate.release()

    def _tick(self, now: Optional[float]):
        if getattr(self.fleet, "_closed", False):
            return
        now = self._clock() if now is None else now
        with self._lock:
            idx = self._ticks
            self._ticks += 1
        forced = None
        if self._fault_hook is not None:
            try:
                forced = self._fault_hook(idx)
            except Exception:  # noqa: BLE001 — a chaos hook bug must not
                # kill the control loop it is testing
                traceback.print_exc()
        try:
            self.fleet.sample_gauges()
        except Exception:  # noqa: BLE001 — stale gauges beat a dead loop
            traceback.print_exc()
        sig = self._signals()
        with self._lock:
            live_queue = sig["queue_depth"] >= 1
            want_up = (
                (live_queue
                 and sig["queue_wait_p95"] >= self.policy.up_queue_wait_p95_s)
                or (live_queue and sig["burn_fast"] >= self.policy.up_burn)
                or sig["occupancy"] >= self.policy.up_occupancy
                # the capacity-MODEL trigger (deliberately queue-free:
                # the whole point is to fire before queue symptoms —
                # the gauge itself only exists once arrivals and
                # measured batches armed the model)
                or (self.policy.up_headroom > 0
                    and sig["headroom"] is not None
                    and sig["headroom"] <= self.policy.up_headroom)
            )
            # the idle test deliberately ignores queue-wait p95: it is a
            # sliding window and stays high long after a burst drains
            want_down = (
                sig["queue_depth"] == 0
                and sig["occupancy"] <= self.policy.down_occupancy
            )
            if want_up:
                self._up_streak += 1
                self._down_streak = 0
            elif want_down:
                self._down_streak += 1
                self._up_streak = 0
            else:
                self._up_streak = 0
                self._down_streak = 0
            action = None
            if forced == "up" or (want_up
                                  and self._up_streak
                                  >= self.policy.up_sustain):
                action = "up"
            elif forced == "down" or (want_down
                                      and self._down_streak
                                      >= self.policy.down_sustain):
                action = "down"
            if action is None:
                return
            # hysteresis window: cooldown measured from the last action
            # in EITHER direction — the no-flap contract
            cooldown = (self.policy.up_cooldown_s if action == "up"
                        else self.policy.down_cooldown_s)
            if (self._last_action_at is not None
                    and now - self._last_action_at < cooldown):
                self._decisions["suppressed"].inc()
                self._note(now, "suppressed", sig,
                           reason=f"{action} inside {cooldown}s cooldown",
                           forced=bool(forced))
                return
            n = (self.fleet.replica_count(self.pool) if self.pool
                 else self.fleet.replica_count())
            if action == "up" and n >= self.policy.max_replicas:
                self._decisions["suppressed"].inc()
                self._note(now, "suppressed", sig, reason="at_max",
                           forced=bool(forced))
                return
            if action == "down" and n <= self.policy.min_replicas:
                self._decisions["suppressed"].inc()
                self._note(now, "suppressed", sig, reason="at_min",
                           forced=bool(forced))
                return
        # act OUTSIDE the lock: add/remove take fleet locks and (remove)
        # wait on health machinery
        try:
            if action == "up":
                name = (self.fleet.add_replica(pool=self.pool)
                        if self.pool else self.fleet.add_replica())
            else:
                name = (self.fleet.remove_replica(pool=self.pool)
                        if self.pool else self.fleet.remove_replica())
        except ScaleRejectedError as e:
            self._decisions["rejected"].inc()
            count_err = getattr(self.fleet, "_count_error", None)
            if count_err is not None:
                count_err(e)
            with self._lock:
                self._note(now, "rejected", sig, reason=str(e),
                           forced=bool(forced))
            return
        with self._lock:
            self._last_action, self._last_action_at = action, now
            self._up_streak = self._down_streak = 0
            self._decisions[action].inc()
            n_after = (self.fleet.replica_count(self.pool) if self.pool
                       else self.fleet.replica_count())
            self._note(now, action, sig, replica=name, replicas=n_after,
                       forced=bool(forced))
        if self._incident_hook is not None:
            try:
                self._incident_hook(f"scale_{action}", replica=name,
                                    replicas=n_after,
                                    **({"pool": self.pool} if self.pool
                                       else {}), **sig)
            except Exception:  # noqa: BLE001 — observability must never
                # take the control loop down
                traceback.print_exc()

    def _note(self, now, action, sig, **extra):
        self._events.append({
            "ts": now, "action": action,
            # None = signal absent (headroom before the model arms);
            # recorded as-is so the event log distinguishes "no data"
            # from a measured zero
            "signals": {k: (round(float(v), 4) if v is not None else None)
                        for k, v in sig.items()},
            **extra,
        })

    # ------------------------------------------------------------- threads

    def start(self, interval_s: float = 1.0):
        """Fallback ticker for runs without an ops server (the OpsTicker
        hook is the production wiring — `ops.add_tick(scaler.tick)`)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the control loop
                    # must survive its own bugs
                    traceback.print_exc()

        self._thread = threading.Thread(
            target=loop, name=f"af2-autoscale-{self.pool or 'fleet'}",
            daemon=True)
        self._thread.start()

    def stop(self, timeout: Optional[float] = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # --------------------------------------------------------------- stats

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def scale_events(self) -> list:
        """Only the acted up/down transitions (the acceptance assertions'
        view)."""
        return [e for e in self.events() if e["action"] in ("up", "down")]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "policy": dataclasses.asdict(self.policy),
                "pool": self.pool,
                "ticks": self._ticks,
                "replicas": (self.fleet.replica_count(self.pool)
                             if self.pool else self.fleet.replica_count()),
                "last_action": self._last_action,
                "last_action_age_s": (
                    None if self._last_action_at is None
                    else self._clock() - self._last_action_at
                ),
                "decisions": {k: int(c.value)
                              for k, c in self._decisions.items()},
                "events": list(self._events)[-32:],
            }
