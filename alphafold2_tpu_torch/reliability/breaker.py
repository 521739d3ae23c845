"""Consecutive-failure circuit breaker for the serving engine
(counterpart of alphafold2_tpu/reliability/breaker.py, copied).

When every dispatch fails (a wedged device, bad weights), retrying each
request turns the engine into a failure amplifier; the breaker turns that
into fast rejection:

  closed     normal serving; `threshold` consecutive dispatch failures
             trip it (any success resets the count);
  open       submit() fast-rejects with CircuitOpenError, with no queue
             time and no device call, until the reset window has passed;
  half_open  exactly one probe dispatch is admitted: success closes the
             circuit, failure opens it for another window.

`allow()` runs on submitter threads and `record_*` on the engine worker,
every transition under one lock; the clock is injectable. `jitter`
spreads each open window over reset_s * [1, 1 + jitter] from a seeded
PRNG, so breakers seeded apart do not re-probe in lockstep.
"""

from __future__ import annotations

import enum
import random
import threading
import time


class CircuitState(str, enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """`on_open(snapshot)` runs outside the lock each time the circuit
    opens; its exceptions are printed and swallowed."""

    def __init__(self, threshold: int, reset_s: float, clock=time.monotonic,
                 jitter: float = 0.0, seed: int = 0, on_open=None):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if reset_s < 0:
            raise ValueError(f"reset_s must be >= 0, got {reset_s}")
        if jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {jitter}")
        self.threshold = threshold
        self.reset_s = reset_s
        self.jitter = jitter
        self.on_open = on_open
        self._rng = random.Random(seed)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CircuitState.CLOSED
        self._failures = 0          # consecutive failures while closed
        self._opened_at = 0.0
        self._current_reset_s = reset_s  # this open window's length
        self._probe_in_flight = False
        self._trips = 0             # lifetime open transitions

    def _open(self, now: float):
        """Transition to OPEN (lock held) and draw this window's length."""
        self._state = CircuitState.OPEN
        self._opened_at = now
        self._current_reset_s = self.reset_s * (
            1.0 + (self._rng.uniform(0.0, self.jitter) if self.jitter else 0.0)
        )
        self._trips += 1

    @property
    def state(self) -> CircuitState:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a new request be admitted now? Claims the half-open probe
        when the reset window has passed."""
        with self._lock:
            if self._state is CircuitState.CLOSED:
                return True
            if (self._state is CircuitState.OPEN
                    and self._clock() - self._opened_at >= self._current_reset_s):
                self._state = CircuitState.HALF_OPEN
                self._probe_in_flight = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._state = CircuitState.CLOSED
            self._failures = 0
            self._probe_in_flight = False

    def record_failure(self):
        opened = False
        with self._lock:
            now = self._clock()
            if self._state is CircuitState.HALF_OPEN:
                self._open(now)  # the probe failed: a fresh window
                self._probe_in_flight = False
                opened = True
            elif self._state is CircuitState.CLOSED:
                self._failures += 1
                if self._failures >= self.threshold:
                    self._open(now)
                    opened = True
        if opened and self.on_open is not None:
            try:
                self.on_open(self.snapshot())
            except Exception:  # noqa: BLE001 — an observer must not wedge dispatch
                import traceback

                traceback.print_exc()

    def abandon_probe(self):
        """The admitted probe never dispatched (queue full, expiry): back to
        open without a failure or a new window, so the next submit can
        claim a probe at once. No-op outside half-open."""
        with self._lock:
            if self._state is CircuitState.HALF_OPEN:
                self._state = CircuitState.OPEN
                self._probe_in_flight = False

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "state": self._state.value,
                "consecutive_failures": self._failures,
                "threshold": self.threshold,
                "reset_s": self.reset_s,
                "trips": self._trips,
            }
            if self.jitter:
                snap["jitter"] = self.jitter
                snap["current_reset_s"] = self._current_reset_s
            if self._state is not CircuitState.CLOSED:
                snap["open_for_s"] = max(0.0, self._clock() - self._opened_at)
            return snap
