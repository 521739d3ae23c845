"""Fleet-wide retry budget: a token bucket refilled by SUCCESS.

The port's copy of alphafold2_tpu/reliability/retry_budget.py: the same names, messages,
metric names and on-disk formats; Python and numpy only.

Every internal retry the serving fleet can generate — featurize-tier
requeues after a worker death, replica-failover requeues, hedged
dispatches — amplifies load exactly when the fleet can least afford it:
a brownout where every replica is failing turns each accepted request
into `requeue_limit + 1` dispatch attempts, and the retry traffic itself
keeps the fleet pinned. The classic fix (the SRE-book "retry budget") is
to make retries a SHARED, bounded resource priced in recent successes:
the bucket starts full at `capacity` tokens, every retry of any kind
spends one token, and every SUCCESSFUL completion refills `refill_ratio`
tokens. While the fleet is healthy, successes keep the bucket topped up
and retries are free; when the whole fleet browns out, successes stop,
the bucket drains within `capacity` attempts, and further retries are
denied — the caller sheds with a typed
`RetryBudgetExhaustedError(retry_after_s)` instead of dogpiling.

`try_spend(reason)` is the single gate (reasons: "featurize" /
"failover" / "hedge" — each counted per-label in
`retry_budget_spent_total` / `retry_budget_exhausted_total`), and
`retry_after_s()` converts the deficit into backoff advice: how long,
at the recently observed success rate, until refill has earned the next
token. No successes observed recently means the honest answer is "the
max" — a client retrying into a fleet with zero throughput cannot be
admitted sooner.

Deliberately serving-agnostic (no serving imports — the fleet wraps the
denial in its own error type), clock-injectable, and guarded by one leaf
lock that never calls out while held.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class RetryBudget:
    """Thread-safe success-refilled token bucket for internal retries.

    capacity        bucket size == the largest retry burst the fleet may
                    emit with zero recent successes (the brownout bound).
    refill_ratio    tokens earned per successful completion. 0.1 means
                    "retries may be at most ~10% of success throughput"
                    once the initial capacity is spent.
    """

    def __init__(self, capacity: int, *, refill_ratio: float = 0.1,
                 min_retry_after_s: float = 0.25,
                 max_retry_after_s: float = 30.0,
                 clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not (0.0 < refill_ratio <= 1.0):
            raise ValueError(
                f"refill_ratio must be in (0, 1], got {refill_ratio}")
        self.capacity = int(capacity)
        self.refill_ratio = float(refill_ratio)
        self.min_retry_after_s = float(min_retry_after_s)
        self.max_retry_after_s = float(max_retry_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = float(capacity)
        self._spent = 0
        self._denied = 0
        self._successes = 0
        self._last_success_t: Optional[float] = None
        # EMA of the inter-success interval — the "how fast is the fleet
        # actually earning tokens" signal behind retry_after_s()
        self._success_interval_ema: Optional[float] = None
        self._registry = None

    def bind_registry(self, registry) -> "RetryBudget":
        """Attach a MetricRegistry: publishes `retry_budget_tokens` plus
        the per-reason spend/denial counters. Optional — the bucket works
        unmetered (unit tests, bench arms)."""
        self._registry = registry
        registry.gauge(
            "retry_budget_tokens",
            help="retry-budget tokens currently available",
        ).set(self.tokens())
        return self

    # ------------------------------------------------------------- spending

    def try_spend(self, reason: str) -> bool:
        """Spend one token for a retry of kind `reason`. False == denied:
        the caller must shed (RetryBudgetExhaustedError) instead of
        retrying. Never blocks."""
        with self._lock:
            ok = self._tokens >= 1.0
            if ok:
                self._tokens -= 1.0
                self._spent += 1
            else:
                self._denied += 1
            tokens = self._tokens
        reg = self._registry
        if reg is not None:
            if ok:
                reg.counter("retry_budget_spent_total",
                            reason=reason).inc()
            else:
                reg.counter("retry_budget_exhausted_total",
                            reason=reason).inc()
            reg.gauge("retry_budget_tokens").set(tokens)
        return ok

    def on_success(self):
        """Record one successful completion: refill `refill_ratio` tokens
        (capped at capacity) and update the success-rate estimate."""
        now = self._clock()
        with self._lock:
            self._tokens = min(float(self.capacity),
                               self._tokens + self.refill_ratio)
            self._successes += 1
            if self._last_success_t is not None:
                dt = max(1e-6, now - self._last_success_t)
                ema = self._success_interval_ema
                self._success_interval_ema = (
                    dt if ema is None else 0.2 * dt + 0.8 * ema)
            self._last_success_t = now
            tokens = self._tokens
        reg = self._registry
        if reg is not None:
            reg.gauge("retry_budget_tokens").set(tokens)

    # ------------------------------------------------------------- reading

    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def retry_after_s(self) -> float:
        """Backoff advice for a denied retry: time until refill earns the
        next whole token at the recently observed success rate, clamped
        to [min_retry_after_s, max_retry_after_s]. With no observed
        successes the answer is the max — a fleet earning nothing cannot
        promise sooner."""
        with self._lock:
            deficit = max(0.0, 1.0 - self._tokens)
            interval = self._success_interval_ema
        if deficit == 0.0:
            return self.min_retry_after_s
        if interval is None:
            return self.max_retry_after_s
        successes_needed = deficit / self.refill_ratio
        est = successes_needed * interval
        return min(self.max_retry_after_s, max(self.min_retry_after_s, est))

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "capacity": self.capacity,
                "tokens": round(self._tokens, 3),
                "refill_ratio": self.refill_ratio,
                "spent": self._spent,
                "denied": self._denied,
                "successes": self._successes,
            }
        snap["retry_after_s"] = round(self.retry_after_s(), 3)
        return snap
