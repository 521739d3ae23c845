"""Replica health management: probes, drain decisions, reinstatement.

The port's copy of alphafold2_tpu/reliability/health.py: the same names, messages,
metric names and on-disk formats; Python and numpy only. One departure: a
probe that was in flight when its target was retired does not reinstate
it (in the JAX copy it does, which leaves a retired replica registered and
undrained, its engine serving nothing and never shut down).

The fleet tier (`serving/fleet.py`) keeps N engine replicas; this module
owns the question "which of them should take traffic right now?". It is
deliberately serving-agnostic — targets are (name, probe_fn, callbacks)
triples, the clock is injectable, and every transition is driven either
by external dispatch evidence or by `tick()`, so tests cover the whole
state machine deterministically without threads or sleeps.

Per-target state machine:

  HEALTHY   takes traffic. Evidence against it accumulates two ways:
            dispatch failures reported by the router
            (`record_failure` — breaker trips, hung-batch watchdog,
            injected kills all land here) and failed heartbeat probes
            run by `tick()` at `probe_interval_s`. Either stream
            reaching `fail_threshold` CONSECUTIVE failures marks the
            target DOWN; any success resets both counts.
  DOWN      takes no traffic. The owner's `on_drain` callback runs on
            the next `tick()` (never on the reporting thread — the
            reporter is typically the replica's own worker, and a drain
            that joins that worker from itself would deadlock). Every
            `reprobe_interval_s` the target is re-probed; one probe
            success reinstates it (`on_reinstate`), because a probe is
            END-TO-END evidence the replica serves again — demanding N
            successes would just keep capacity parked during recovery.

`HealthMonitor.start()` runs `tick()` on a daemon thread for production
use; tests call `tick(now=...)` directly.
"""

from __future__ import annotations

import enum
import threading
import time
import traceback
from typing import Callable, Dict, Optional


class ReplicaState(str, enum.Enum):
    HEALTHY = "healthy"
    DOWN = "down"


class _Target:
    """One monitored replica (all fields guarded by the monitor lock)."""

    def __init__(self, name: str, probe: Optional[Callable[[], bool]],
                 on_drain: Optional[Callable[[str, str], None]],
                 on_reinstate: Optional[Callable[[str], None]]):
        self.name = name
        self.probe = probe
        self.on_drain = on_drain
        self.on_reinstate = on_reinstate
        self.state = ReplicaState.HEALTHY
        self.retiring = False           # deliberate removal in progress
        self.consecutive_failures = 0   # dispatch evidence (router-reported)
        self.consecutive_probe_failures = 0
        self.last_probe_at: Optional[float] = None
        self.down_since: Optional[float] = None
        self.down_reason = ""
        self.drain_pending = False      # drain decided, callback not yet run
        self.drains = 0                 # lifetime drain count (stats)
        self.reinstatements = 0


class HealthMonitor:
    """Heartbeat prober + drain/reinstate state machine over named targets.

    Args:
      probe_interval_s: heartbeat cadence for HEALTHY targets (0 disables
        proactive probing — dispatch evidence alone then drives drains).
      reprobe_interval_s: re-probe cadence for DOWN targets (the
        reinstatement path; also the honest `retry_after_s` to hand a
        client when nothing is serving).
      fail_threshold: consecutive failures (either evidence stream) that
        mark a target DOWN.
      clock: injectable monotonic clock.
    """

    def __init__(self, probe_interval_s: float = 2.0,
                 reprobe_interval_s: float = 1.0, fail_threshold: int = 3,
                 clock=time.monotonic):
        if fail_threshold < 1:
            raise ValueError(
                f"fail_threshold must be >= 1, got {fail_threshold}"
            )
        if probe_interval_s < 0 or reprobe_interval_s <= 0:
            raise ValueError(
                "probe_interval_s must be >= 0 and reprobe_interval_s > 0, "
                f"got {probe_interval_s}/{reprobe_interval_s}"
            )
        self.probe_interval_s = probe_interval_s
        self.reprobe_interval_s = reprobe_interval_s
        self.fail_threshold = fail_threshold
        self._clock = clock
        self._lock = threading.Lock()
        self._targets: Dict[str, _Target] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ registry

    def register(self, name: str, probe: Optional[Callable[[], bool]] = None,
                 on_drain: Optional[Callable[[str, str], None]] = None,
                 on_reinstate: Optional[Callable[[str], None]] = None):
        """Add a target (HEALTHY). `probe()` returns truthy when the
        replica serves end to end; `on_drain(name, reason)` /
        `on_reinstate(name)` run on the tick thread."""
        with self._lock:
            if name in self._targets:
                raise ValueError(f"target {name!r} already registered")
            self._targets[name] = _Target(name, probe, on_drain, on_reinstate)

    def state(self, name: str) -> ReplicaState:
        with self._lock:
            return self._targets[name].state

    def healthy_targets(self) -> list:
        """Names currently eligible for traffic (drain may still be
        pending on a DOWN target — it is already excluded here, which is
        what keeps the window between decision and drain safe)."""
        with self._lock:
            return [t.name for t in self._targets.values()
                    if t.state is ReplicaState.HEALTHY]

    # ----------------------------------------------- dispatch evidence

    def record_success(self, name: str):
        """Router-reported dispatch success: clears the failure streak.
        Deliberately does NOT reinstate a DOWN target — a straggler
        success from before the drain decision is stale evidence; the
        re-probe path owns reinstatement."""
        with self._lock:
            t = self._targets[name]
            t.consecutive_failures = 0
            t.consecutive_probe_failures = 0

    def record_failure(self, name: str, reason: str = "") -> bool:
        """Router-reported dispatch failure (replica-attributed: breaker
        open, hung batch, model exception, engine death). Returns True
        when this report crossed the threshold and marked the target
        DOWN. The drain callback runs on the next tick(), never here —
        the reporting thread may BE the replica worker being drained."""
        with self._lock:
            t = self._targets[name]
            if t.state is ReplicaState.DOWN:
                return False
            t.consecutive_failures += 1
            if t.consecutive_failures >= self.fail_threshold:
                self._mark_down(t, reason or "dispatch failures")
                return True
            return False

    def force_down(self, name: str, reason: str):
        """Immediate drain decision (operator action, breaker trip where
        one report IS conclusive). Same deferred-callback contract."""
        with self._lock:
            t = self._targets[name]
            if t.state is not ReplicaState.DOWN:
                self._mark_down(t, reason)

    def retire(self, name: str, reason: str = "retired"):
        """Deliberate permanent removal (autoscale scale-down, rolling
        replacement): the target takes no more traffic, its `on_drain`
        callback runs on the next tick — the SAME drain path a sick
        replica takes, so the owner's teardown logic is one code path —
        and it is never re-probed or reinstated; once the drain has run,
        the target is unregistered. Idempotent, and safe to call on a
        target that is already DOWN (e.g. a failure drain racing an
        autoscale decision): the drain callback is re-scheduled exactly
        once and the owner's callback must tolerate an already-torn-down
        replica (the fleet's does — that is the no-double-drain pin)."""
        with self._lock:
            t = self._targets.get(name)
            if t is None or t.retiring:
                return
            t.retiring = True
            if t.state is not ReplicaState.DOWN:
                self._mark_down(t, reason)
            else:
                # already down (possibly already drained): schedule one
                # cleanup pass through the same callback
                t.down_reason = t.down_reason or reason
                t.drain_pending = True

    def unregister(self, name: str):
        """Drop a target from supervision (no callbacks). The retire()
        path calls this itself after the final drain; direct use is for
        owners tearing down out-of-band."""
        with self._lock:
            self._targets.pop(name, None)

    def _mark_down(self, t: _Target, reason: str):
        t.state = ReplicaState.DOWN
        t.down_since = self._clock()
        t.down_reason = reason
        t.drain_pending = True
        t.drains += 1

    # ------------------------------------------------------------- ticking

    def tick(self, now: Optional[float] = None):
        """One supervision pass: run pending drains, heartbeat-probe due
        HEALTHY targets, re-probe due DOWN targets. Callbacks and probes
        run OUTSIDE the lock (they take seconds and may touch the fleet's
        own locks)."""
        now = self._clock() if now is None else now
        with self._lock:
            drains = [(t, t.down_reason) for t in self._targets.values()
                      if t.drain_pending]
            for t, _ in drains:
                t.drain_pending = False
            probes = [t for t in self._targets.values()
                      if self._probe_due(t, now)]
            for t in probes:
                t.last_probe_at = now
        for t, reason in drains:
            # re-check: a probe that was already in flight when the drain
            # was decided may have reinstated the target in between — a
            # stale drain against a now-healthy replica would tear down
            # the very engine the reinstatement just vouched for
            with self._lock:
                if t.state is not ReplicaState.DOWN:
                    continue
            if t.on_drain is not None:
                try:
                    t.on_drain(t.name, reason)
                except Exception:  # noqa: BLE001 — supervision must survive
                    traceback.print_exc()
            if t.retiring:
                # the final drain has run: the target leaves supervision
                # (no re-probe could ever reinstate it)
                self.unregister(t.name)
        for t in probes:
            self._run_probe(t)

    def _probe_due(self, t: _Target, now: float) -> bool:
        if t.probe is None or t.drain_pending or t.retiring:
            return False
        if t.state is ReplicaState.HEALTHY:
            if self.probe_interval_s <= 0:
                return False
            return (t.last_probe_at is None
                    or now - t.last_probe_at >= self.probe_interval_s)
        return (t.last_probe_at is None
                or now - t.last_probe_at >= self.reprobe_interval_s)

    def _run_probe(self, t: _Target):
        try:
            ok = bool(t.probe())
        except Exception:  # noqa: BLE001 — a raising probe is a failing probe
            ok = False
        reinstate = drain = None
        with self._lock:
            if ok:
                t.consecutive_probe_failures = 0
                t.consecutive_failures = 0
                # a probe in flight when its target was retired must not
                # reinstate it: the retirement's drain stays pending (else
                # the retired replica would stay registered, never drained,
                # its engine never shut down)
                if t.state is ReplicaState.DOWN and not t.retiring:
                    t.state = ReplicaState.HEALTHY
                    t.down_since = None
                    t.down_reason = ""
                    t.drain_pending = False  # a queued drain is now moot
                    t.reinstatements += 1
                    reinstate = t.on_reinstate
            elif t.state is ReplicaState.HEALTHY:
                t.consecutive_probe_failures += 1
                if t.consecutive_probe_failures >= self.fail_threshold:
                    self._mark_down(t, "probe failures")
                    # drain immediately: we ARE the tick thread, and
                    # waiting a full tick just extends the window in
                    # which the router can still see stale state
                    t.drain_pending = False
                    drain = t.on_drain
            reason = t.down_reason
        # callbacks outside the lock
        if reinstate is not None:
            try:
                reinstate(t.name)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
        if drain is not None:
            try:
                drain(t.name, reason)
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    # ------------------------------------------------------------- thread

    def start(self, interval_s: float = 0.1):
        """Run tick() on a daemon thread every `interval_s` (the thread
        granularity; probe cadences are enforced by the state machine)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — supervision must survive
                    traceback.print_exc()

        self._thread = threading.Thread(
            target=loop, name="af2-health-monitor", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: Optional[float] = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -------------------------------------------------------------- stats

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            return {
                "fail_threshold": self.fail_threshold,
                "probe_interval_s": self.probe_interval_s,
                "reprobe_interval_s": self.reprobe_interval_s,
                "targets": {
                    t.name: {
                        "state": t.state.value,
                        "retiring": t.retiring,
                        "consecutive_failures": t.consecutive_failures,
                        "drains": t.drains,
                        "reinstatements": t.reinstatements,
                        **({"down_for_s": now - t.down_since,
                            "down_reason": t.down_reason}
                           if t.down_since is not None else {}),
                    }
                    for t in self._targets.values()
                },
            }
