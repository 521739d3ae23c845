"""SLO engine: declarative objectives evaluated as burn rates (a copy of
alphafold2_tpu/telemetry/slo.py, which imports only the standard library
and the registry).

Two kinds of objective:

  * ``ratio``: bad / total events over a trailing window, from counter
    deltas; `objective` is the success target (0.99 leaves a 0.01
    budget) and the burn rate is the observed ratio over the budget;
  * ``quantile``: a histogram percentile against an absolute `threshold`;
    the burn rate is value / threshold.

An alert fires when both the fast and the slow window burn past their
thresholds (`fast_burn`, `slow_burn`) and resolves when the fast window
recovers. Each transition increments `slo_alerts_total{objective,
transition}`, sets `slo_alert_active{objective}`, appends an event and
calls `on_page` (the flight recorder's hook) on firing.

Selectors are `{"metric": name, "labels": {k: v}}`: every series of the
metric whose labels include those is summed. `SloConfig.from_file` loads
JSON and refuses unknown keys. The clock is injectable and
`evaluate(now=...)` is one step of the state machine, so tests drive the
windows without sleeping; the ops plane's ticker calls `evaluate()`.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from alphafold2_tpu_torch.telemetry.registry import LabelsKey, MetricRegistry

_OBJECTIVE_KEYS = {
    "name", "kind", "bad", "total", "objective", "fast_burn", "slow_burn",
    "metric", "labels", "quantile", "threshold",
}
_CONFIG_KEYS = {"fast_window_s", "slow_window_s", "objectives"}


def _selector(spec) -> Tuple[str, LabelsKey]:
    """Normalize one {"metric": ..., "labels": {...}} selector."""
    if isinstance(spec, str):
        return spec, ()
    unknown = set(spec) - {"metric", "labels"}
    if unknown:
        raise ValueError(f"unknown selector key(s) {sorted(unknown)}")
    labels = spec.get("labels", {})
    return str(spec["metric"]), tuple(
        sorted((str(k), str(v)) for k, v in labels.items())
    )


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declarative objective (see module docstring for semantics)."""

    name: str
    kind: str                       # "ratio" | "quantile"
    # ratio:
    bad: Tuple[Tuple[str, LabelsKey], ...] = ()
    total: Tuple[Tuple[str, LabelsKey], ...] = ()
    objective: float = 0.99         # success target; budget = 1 - objective
    # quantile:
    metric: str = ""
    labels: LabelsKey = ()
    quantile: float = 0.95
    threshold: float = 1.0          # absolute bound on the percentile
    # both:
    fast_burn: float = 2.0          # firing threshold, fast window
    slow_burn: float = 1.0          # firing threshold, slow window

    def __post_init__(self):
        if self.kind not in ("ratio", "quantile"):
            raise ValueError(
                f"objective {self.name!r}: kind must be 'ratio' or "
                f"'quantile', got {self.kind!r}"
            )
        if self.kind == "ratio":
            if not self.bad or not self.total:
                raise ValueError(
                    f"ratio objective {self.name!r} needs both `bad` and "
                    f"`total` selectors"
                )
            if not (0.0 < self.objective < 1.0):
                raise ValueError(
                    f"objective {self.name!r}: success target must be in "
                    f"(0, 1), got {self.objective}"
                )
        else:
            if not self.metric:
                raise ValueError(
                    f"quantile objective {self.name!r} needs `metric`"
                )
            if self.threshold <= 0:
                raise ValueError(
                    f"objective {self.name!r}: threshold must be positive, "
                    f"got {self.threshold}"
                )
        if self.fast_burn <= 0 or self.slow_burn <= 0:
            raise ValueError(
                f"objective {self.name!r}: burn thresholds must be positive"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "SloObjective":
        unknown = set(d) - _OBJECTIVE_KEYS
        if unknown:
            raise ValueError(
                f"objective {d.get('name', '?')!r}: unknown key(s) "
                f"{sorted(unknown)}; known: {sorted(_OBJECTIVE_KEYS)}"
            )
        kw = dict(d)
        for key in ("bad", "total"):
            if key in kw:
                kw[key] = tuple(_selector(s) for s in kw[key])
        if "labels" in kw:
            kw["labels"] = tuple(
                sorted((str(k), str(v)) for k, v in kw["labels"].items())
            )
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Objectives plus the two shared burn windows."""

    objectives: Tuple[SloObjective, ...]
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0

    def __post_init__(self):
        if not (0 < self.fast_window_s <= self.slow_window_s):
            raise ValueError(
                f"need 0 < fast_window_s <= slow_window_s, got "
                f"{self.fast_window_s}/{self.slow_window_s}"
            )
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")

    @classmethod
    def from_dict(cls, d: dict) -> "SloConfig":
        unknown = set(d) - _CONFIG_KEYS
        if unknown:
            raise ValueError(
                f"unknown SLO config key(s) {sorted(unknown)}; known: "
                f"{sorted(_CONFIG_KEYS)}"
            )
        kw = dict(d)
        kw["objectives"] = tuple(
            SloObjective.from_dict(o) for o in d.get("objectives", ())
        )
        return cls(**kw)

    @classmethod
    def from_file(cls, path: str) -> "SloConfig":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


def default_slo_config(prefix: str = "fleet",
                       fast_window_s: float = 60.0,
                       slow_window_s: float = 300.0) -> SloConfig:
    """The serving tier's stock objectives over the `fleet_*` (fleet
    mode) or `serving_*` (single-engine) metric families — what
    `serve.py --ops-port` arms when no --slo-config is given."""
    if prefix == "fleet":
        total = ({"metric": "fleet_requests_total",
                  "labels": {"outcome": "submitted"}},)
        objectives = (
            SloObjective.from_dict({
                "name": "availability", "kind": "ratio",
                "bad": [{"metric": "fleet_requests_total",
                         "labels": {"outcome": "failed"}}],
                "total": list(total), "objective": 0.999,
                "fast_burn": 14.0, "slow_burn": 6.0,
            }),
            SloObjective.from_dict({
                "name": "shed_rate", "kind": "ratio",
                "bad": [{"metric": "fleet_requests_total",
                         "labels": {"outcome": "shed"}}],
                "total": list(total), "objective": 0.99,
                "fast_burn": 14.0, "slow_burn": 6.0,
            }),
            SloObjective.from_dict({
                "name": "queue_wait_p95", "kind": "quantile",
                "metric": "fleet_queue_wait_seconds", "quantile": 0.95,
                "threshold": 5.0, "fast_burn": 2.0, "slow_burn": 1.0,
            }),
        )
    else:
        total = ({"metric": "serving_requests_total",
                  "labels": {"outcome": "submitted"}},)
        objectives = (
            SloObjective.from_dict({
                "name": "availability", "kind": "ratio",
                "bad": [{"metric": "serving_requests_total",
                         "labels": {"outcome": "failed"}}],
                "total": list(total), "objective": 0.999,
                "fast_burn": 14.0, "slow_burn": 6.0,
            }),
            SloObjective.from_dict({
                "name": "shed_rate", "kind": "ratio",
                "bad": [{"metric": "serving_requests_total",
                         "labels": {"outcome": "rejected"}}],
                "total": list(total), "objective": 0.99,
                "fast_burn": 14.0, "slow_burn": 6.0,
            }),
            SloObjective.from_dict({
                "name": "latency_p95", "kind": "quantile",
                "metric": "serving_request_latency_seconds",
                "quantile": 0.95, "threshold": 30.0,
                "fast_burn": 2.0, "slow_burn": 1.0,
            }),
        )
    return SloConfig(objectives=objectives, fast_window_s=fast_window_s,
                     slow_window_s=slow_window_s)


class _AlertState:
    __slots__ = ("active", "fired_at")

    def __init__(self):
        self.active = False
        self.fired_at: Optional[float] = None


class SloEngine:
    """Evaluates an `SloConfig` against one registry; see module docstring.

    Args:
      registry: the registry whose counters/histograms the objectives
        select from — AND where the slo_* result metrics are recorded,
        so one `/metrics` scrape carries both the signals and the
        verdicts.
      config: `SloConfig`.
      on_page: optional `fn(objective_name, transition, info)` called on
        every transition ("firing" / "resolved") OUTSIDE the engine
        lock; exceptions are swallowed with a traceback (the flight
        recorder plugs in here).
      clock: injectable monotonic clock (tests pin time).
      max_events: structured-event retention bound.
    """

    def __init__(self, registry: MetricRegistry, config: SloConfig,
                 on_page=None, clock=time.monotonic, max_events: int = 512):
        self.registry = registry
        self.config = config
        self.on_page = on_page
        self._clock = clock
        self._lock = threading.Lock()
        # timestamped counter samples; retention covers the slow window
        # (+1 sample of slack so a full-window delta is always available)
        self._samples: deque = deque()
        # per-objective burn history for quantile kinds: (ts, burn)
        self._burn_hist: Dict[str, deque] = {
            o.name: deque() for o in config.objectives
        }
        self._alerts: Dict[str, _AlertState] = {
            o.name: _AlertState() for o in config.objectives
        }
        self._events: deque = deque(maxlen=max_events)
        for o in config.objectives:
            # pre-register so a scrape before the first transition still
            # shows the families (absence of slo_alert_active reads as
            # "no SLO engine", not "no alert")
            self.registry.gauge(
                "slo_alert_active", help="1 = objective currently firing",
                objective=o.name).set(0)

    # ------------------------------------------------------------ sampling

    @staticmethod
    def _counter_sample(families) -> Dict[Tuple[str, LabelsKey], float]:
        out: Dict[Tuple[str, LabelsKey], float] = {}
        for name, (kind, series) in families.items():
            if kind != "counter" or name.startswith("slo_"):
                continue
            for key, metric in series.items():
                out[(name, key)] = metric.value
        return out

    @staticmethod
    def _select(sample: Dict[Tuple[str, LabelsKey], float],
                selectors) -> float:
        total = 0.0
        for name, want in selectors:
            want_d = dict(want)
            for (n, key), v in sample.items():
                if n != name:
                    continue
                have = dict(key)
                if all(have.get(k) == val for k, val in want_d.items()):
                    total += v
        return total

    def _delta_ratio(self, obj: SloObjective, window_s: float,
                     now: float) -> float:
        """bad/total over the trailing window, from counter deltas. With
        history shorter than the window, the oldest sample is used — an
        honest partial window beats silence at startup."""
        current = self._samples[-1][1]
        past = self._samples[0][1]
        for ts, sample in self._samples:
            if ts <= now - window_s:
                past = sample
            else:
                break
        d_bad = max(
            0.0, self._select(current, obj.bad) - self._select(past, obj.bad)
        )
        d_total = max(
            0.0,
            self._select(current, obj.total) - self._select(past, obj.total),
        )
        # bad and total move at DIFFERENT times (submit vs terminal): a
        # window where only failures land — submissions stopped because
        # the service is down — must read as full burn, not zero traffic
        d_total = max(d_total, d_bad)
        return (d_bad / d_total) if d_total > 0 else 0.0

    @staticmethod
    def _quantile_value(obj: SloObjective, families) -> float:
        fam = families.get(obj.metric)
        if fam is None or fam[0] != "histogram":
            return 0.0
        want = dict(obj.labels)
        best = 0.0
        for key, metric in fam[1].items():
            have = dict(key)
            if all(have.get(k) == v for k, v in want.items()):
                best = max(best, metric.percentile(obj.quantile * 100.0))
        return best

    @staticmethod
    def _window_burn(hist: deque, window_s: float, now: float) -> float:
        """Mean of the recorded instantaneous burns inside the window."""
        vals = [b for ts, b in hist if ts >= now - window_s]
        return (sum(vals) / len(vals)) if vals else 0.0

    # ----------------------------------------------------------- evaluate

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation pass: sample counters, compute each objective's
        fast/slow burn, run the alert state machine. Returns
        {objective: {burn_fast, burn_slow, active}}. Thread-safe;
        `on_page` callbacks run outside the lock."""
        now = self._clock() if now is None else now
        pages = []
        # one registry sweep per tick: both the counter sample and every
        # quantile objective read from this snapshot
        families = self.registry.collect()
        with self._lock:
            self._samples.append((now, self._counter_sample(families)))
            horizon = now - self.config.slow_window_s
            while len(self._samples) > 2 and self._samples[1][0] <= horizon:
                self._samples.popleft()
            out = {}
            for obj in self.config.objectives:
                if obj.kind == "ratio":
                    budget = 1.0 - obj.objective
                    burn_fast = self._delta_ratio(
                        obj, self.config.fast_window_s, now) / budget
                    burn_slow = self._delta_ratio(
                        obj, self.config.slow_window_s, now) / budget
                else:
                    inst = self._quantile_value(obj, families) / obj.threshold
                    hist = self._burn_hist[obj.name]
                    hist.append((now, inst))
                    while hist and hist[0][0] < horizon:
                        hist.popleft()
                    burn_fast = self._window_burn(
                        hist, self.config.fast_window_s, now)
                    burn_slow = self._window_burn(
                        hist, self.config.slow_window_s, now)
                for window, burn in (("fast", burn_fast), ("slow", burn_slow)):
                    self.registry.gauge(
                        "slo_burn_rate",
                        help="error-budget burn rate (1.0 = spending "
                             "exactly the budget)",
                        objective=obj.name, window=window).set(burn)
                state = self._alerts[obj.name]
                should_fire = (burn_fast >= obj.fast_burn
                               and burn_slow >= obj.slow_burn)
                should_resolve = state.active and burn_fast < obj.fast_burn
                transition = None
                if should_fire and not state.active:
                    state.active, state.fired_at = True, now
                    transition = "firing"
                elif should_resolve:
                    state.active, state.fired_at = False, None
                    transition = "resolved"
                if transition is not None:
                    self.registry.counter(
                        "slo_alerts_total",
                        help="SLO alert transitions",
                        objective=obj.name, transition=transition).inc()
                    self.registry.gauge(
                        "slo_alert_active",
                        help="1 = objective currently firing",
                        objective=obj.name).set(1 if state.active else 0)
                    info = {
                        "ts": now,
                        "objective": obj.name,
                        "transition": transition,
                        "burn_fast": round(burn_fast, 4),
                        "burn_slow": round(burn_slow, 4),
                        # "objective_kind", not "kind": the flight
                        # recorder splats this dict into incident(kind=
                        # "slo_page", **info) — a "kind" key collides
                        "objective_kind": obj.kind,
                    }
                    self._events.append(info)
                    pages.append((obj.name, transition, info))
                out[obj.name] = {
                    "burn_fast": burn_fast,
                    "burn_slow": burn_slow,
                    "active": state.active,
                }
        for name, transition, info in pages:
            if self.on_page is not None:
                try:
                    self.on_page(name, transition, info)
                except Exception:  # noqa: BLE001 — paging must not kill
                    # the evaluator thread
                    import traceback

                    traceback.print_exc()
        return out

    # -------------------------------------------------------------- stats

    def events(self) -> list:
        """The structured transition log (oldest first, bounded)."""
        with self._lock:
            return list(self._events)

    def snapshot(self) -> dict:
        """JSON-ready state: per-objective active flags + recent events
        (the `/statusz` payload)."""
        with self._lock:
            return {
                "fast_window_s": self.config.fast_window_s,
                "slow_window_s": self.config.slow_window_s,
                "objectives": {
                    o.name: {
                        "kind": o.kind,
                        "active": self._alerts[o.name].active,
                    }
                    for o in self.config.objectives
                },
                "events": list(self._events)[-32:],
            }
