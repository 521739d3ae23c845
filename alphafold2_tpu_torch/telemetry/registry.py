"""Metric registry: named counters, gauges and histograms with exposition
(a copy of alphafold2_tpu/telemetry/registry.py, which imports only the
standard library).

  * `Counter`: a running total (`inc`); a negative increment is allowed
    for reconciliation (the engine un-counts a submission that failed to
    enqueue).
  * `Gauge`: the last value written (`set` / `inc`).
  * `Histogram`: percentiles over a sliding window (`LatencyHistogram`)
    and lifetime cumulative buckets (`DEFAULT_BUCKET_BOUNDS`), so the
    Prometheus exposition is a real `histogram` (`_bucket{le=...}`,
    `_sum`, `_count`).

Identity is (name, sorted labels): registering the same identity again
returns the same object, and registering a name as another type raises.
`to_prometheus()` writes the text format (v0.0.4), `snapshot()` the JSON
view the engine's `stats()` carries, `collect()` the live series for
programmatic readers (the SLO engine, the flight recorder);
`parse_prometheus_text` reads the text back and `flatten_snapshot` turns
any nested dict of numbers into dotted keys.

Cost contract: `MetricRegistry(enabled=False)` (`NULL_REGISTRY`) hands
every caller one shared no-op metric: no allocation, no lock, empty
snapshots. Every read and write here is host state only, safe from any
thread while a CUDA graph is being captured.
"""

from __future__ import annotations

import bisect
import collections
import re
import threading
from typing import Dict, Optional, Tuple


class LatencyHistogram:
    """Streaming latency percentiles over a sliding window.

    The serving engine (serving/metrics.py) needs request-latency
    quantiles that (a) track the RECENT traffic mix, not the lifetime mix
    — a bucket-ladder warmup with two 30 s compiles must age out of p99
    once steady-state batches flow — and (b) cost O(window) memory
    regardless of how many requests pass through. A bounded deque of the
    last `window` observations gives both; percentiles are computed by
    nearest-rank over a sorted snapshot (window is small, sorting at
    snapshot time beats maintaining an order statistic per observe()).

    Thread-safe: `observe` is called from the scheduler worker thread
    while `snapshot` is called from health-check/stats readers.
    """

    def __init__(self, window: int = 2048):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self._values = collections.deque(maxlen=window)
        self._lock = threading.Lock()
        self._count = 0  # lifetime observations (window evicts, this doesn't)
        self._max = 0.0
        self._sum = 0.0  # lifetime sum (Prometheus summary `_sum`)

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            self._values.append(v)
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v

    @staticmethod
    def _percentile(ordered, q: float) -> float:
        # nearest-rank on a pre-sorted list; q in [0, 100]
        if not ordered:
            return 0.0
        idx = min(len(ordered) - 1, int(round(q / 100.0 * (len(ordered) - 1))))
        return ordered[idx]

    def percentile(self, q: float) -> float:
        with self._lock:
            ordered = sorted(self._values)
        return self._percentile(ordered, q)

    def snapshot(self) -> dict:
        """Plain-float summary: count (lifetime), window stats, p50/p95/p99."""
        with self._lock:
            ordered = sorted(self._values)
            count, vmax, vsum = self._count, self._max, self._sum
        return {
            "count": count,
            "window": len(ordered),
            "mean": (sum(ordered) / len(ordered)) if ordered else 0.0,
            "p50": self._percentile(ordered, 50.0),
            "p95": self._percentile(ordered, 95.0),
            "p99": self._percentile(ordered, 99.0),
            "max": vmax,
            "sum": vsum,
        }


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: dict) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def render_labels(key: LabelsKey) -> str:
    if not key:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape(v: str) -> str:
    return (
        v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    )


class Counter:
    __slots__ = ("_lock", "_value")
    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    __slots__ = ("_lock", "_value")
    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


#: cumulative-bucket upper bounds (seconds-oriented: the stack's
#: histograms are latencies/waits). +Inf is implicit in exposition.
DEFAULT_BUCKET_BOUNDS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0,
)


def format_le(bound: float) -> str:
    """Prometheus `le` label value: trimmed decimal, `+Inf` sentinel."""
    if bound == float("inf"):
        return "+Inf"
    return format(bound, ".12g")


class Histogram:
    """Sliding-window quantiles + lifetime sum/count, on LatencyHistogram
    internals (composition: the window/percentile machinery is shared) —
    plus LIFETIME cumulative buckets for
    real Prometheus `histogram` exposition. Buckets are cumulative
    counters (never windowed): a scraper computes rates from successive
    scrapes, so the bucket counts must only ever grow."""

    __slots__ = ("_hist", "_bounds", "_bucket_counts", "_bucket_sum",
                 "_bucket_lock")
    kind = "histogram"

    def __init__(self, window: int = 2048,
                 bounds: Tuple[float, ...] = DEFAULT_BUCKET_BOUNDS):
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"bucket bounds must be strictly increasing, "
                             f"got {bounds}")
        self._hist = LatencyHistogram(window=window)
        self._bounds = tuple(float(b) for b in bounds)
        # per-bound NON-cumulative counts (+ one overflow slot for +Inf);
        # cumulated at read time so observe() stays one increment. The
        # lifetime sum rides the SAME lock so one exposition() read sees
        # buckets/sum/count from the same observation set — Prometheus
        # requires the +Inf bucket to equal _count on every scrape
        self._bucket_counts = [0] * (len(self._bounds) + 1)
        self._bucket_sum = 0.0
        self._bucket_lock = threading.Lock()

    def observe(self, v: float):
        v = float(v)
        self._hist.observe(v)
        i = bisect.bisect_left(self._bounds, v)
        with self._bucket_lock:
            self._bucket_counts[i] += 1
            self._bucket_sum += v

    def percentile(self, q: float) -> float:
        return self._hist.percentile(q)

    def exposition(self) -> Tuple[dict, float, int]:
        """(cumulative buckets incl. +Inf, lifetime sum, lifetime count),
        mutually consistent: read under one lock, with count derived from
        the buckets themselves."""
        with self._bucket_lock:
            counts = list(self._bucket_counts)
            total = self._bucket_sum
        out, running = {}, 0
        for bound, n in zip(self._bounds + (float("inf"),), counts):
            running += n
            out[format_le(bound)] = running
        return out, total, running

    def buckets(self) -> dict:
        """{le_label: cumulative count} including the implicit +Inf."""
        return self.exposition()[0]

    def snapshot(self) -> dict:
        snap = self._hist.snapshot()
        snap["buckets"] = self.buckets()
        return snap


class _NoopMetric:
    """Shared do-nothing metric for a disabled registry: every mutator is
    a no-op, every reader is empty/zero. One instance serves all names."""

    __slots__ = ()
    kind = "noop"

    def inc(self, n: float = 1):
        pass

    def set(self, v: float):
        pass

    def observe(self, v: float):
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    @property
    def value(self) -> float:
        return 0.0

    def snapshot(self) -> dict:
        return {}


_NOOP_METRIC = _NoopMetric()


class MetricRegistry:
    """Get-or-create factory + exposition for named metrics.

    Identity is (name, sorted labels); re-registering the same identity
    returns the SAME object (callers can hold or re-look-up freely), and
    re-registering a name as a different metric type raises — a silent
    type flip would corrupt exposition.
    """

    def __init__(self, enabled: bool = True, histogram_window: int = 2048):
        self.enabled = enabled
        self._histogram_window = histogram_window
        self._lock = threading.Lock()
        # name -> (kind, help, {labels_key: metric})
        self._families: Dict[str, tuple] = {}

    def _get(self, cls, name: str, help_: str, labels: dict):
        if not self.enabled:
            return _NOOP_METRIC
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        bad = [k for k in labels if not _LABEL_RE.match(str(k))]
        if bad:
            raise ValueError(f"invalid label name(s) {bad} on {name!r}")
        key = _labels_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (cls.kind, help_, {})
                self._families[name] = fam
            elif fam[0] != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, "
                    f"requested {cls.kind}"
                )
            metric = fam[2].get(key)
            if metric is None:
                metric = (
                    cls(window=self._histogram_window)
                    if cls is Histogram else cls()
                )
                fam[2][key] = metric
            return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self._get(Histogram, name, help, labels)

    # ------------------------------------------------------------- reading

    def collect(self) -> Dict[str, Tuple[str, Dict[LabelsKey, object]]]:
        """{name: (kind, {labels_key: metric})} — a consistent shallow
        copy for PROGRAMMATIC readers (the SLO engine matching selectors
        against counter series, the flight recorder diffing deltas).
        The metric objects are the live ones: read-only use."""
        with self._lock:
            return {
                n: (kind, dict(series))
                for n, (kind, _, series) in self._families.items()
            }

    def snapshot(self) -> dict:
        """JSON-ready dump: {"counters": {rendered_name: value}, "gauges":
        {...}, "histograms": {rendered_name: {count, p50, ...}}}."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            families = {
                n: (kind, dict(series))
                for n, (kind, _, series) in self._families.items()
            }
        for name, (kind, series) in sorted(families.items()):
            for key, metric in sorted(series.items()):
                rendered = name + render_labels(key)
                if kind == "histogram":
                    out["histograms"][rendered] = metric.snapshot()
                else:
                    out[kind + "s"][rendered] = metric.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4). Histograms export as REAL
        histograms: cumulative `_bucket{le=...}` samples (+Inf included)
        plus `_sum`/`_count` — aggregatable across replicas and
        `histogram_quantile()`-able, unlike the summary-quantile gauges
        this used to emit."""
        lines = []
        with self._lock:
            families = {
                n: (kind, help_, dict(series))
                for n, (kind, help_, series) in self._families.items()
            }
        for name, (kind, help_, series) in sorted(families.items()):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for key, metric in sorted(series.items()):
                if kind == "histogram":
                    buckets, vsum, count = metric.exposition()
                    for le, cum in buckets.items():
                        bkey = tuple(sorted(key + (("le", le),)))
                        lines.append(
                            f"{name}_bucket{render_labels(bkey)} {cum}"
                        )
                    lines.append(f"{name}_sum{render_labels(key)} "
                                 f"{vsum}")
                    lines.append(f"{name}_count{render_labels(key)} "
                                 f"{count}")
                else:
                    lines.append(
                        f"{name}{render_labels(key)} {metric.value}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)\s*$"
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
)


def parse_prometheus_text(text: str) -> Dict[Tuple[str, LabelsKey], float]:
    """Minimal Prometheus text-format parser: {(name, labels): value}.

    Enough of the grammar to round-trip `to_prometheus()` output (and any
    plain scrape of counters/gauges/histograms — cumulative
    `_bucket{le=...}` samples are ordinary samples whose `le` label keys
    the bound, `+Inf` included); not a validator. Raises ValueError on a
    line it cannot parse — a silently-skipped sample would make the
    round-trip test vacuous.
    """
    out: Dict[Tuple[str, LabelsKey], float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line {lineno}: "
                             f"{line!r}")
        labels: LabelsKey = ()
        if m.group("labels"):
            labels = tuple(sorted(
                (k, _unescape(v))
                for k, v in _LABEL_PAIR_RE.findall(m.group("labels"))
            ))
        out[(m.group("name"), labels)] = float(m.group("value"))
    return out


#: shared disabled registry, the analog of trace.NULL_TRACER
NULL_REGISTRY = MetricRegistry(enabled=False)


def flatten_snapshot(snap: dict, prefix: str = "") -> Dict[str, float]:
    """Flatten any nested dict of numerics (a registry snapshot, an engine
    stats payload, a bench artifact) into {dotted.path: float} — the form
    a regression gate compares."""
    flat: Dict[str, float] = {}
    for k, v in snap.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_snapshot(v, key))
        elif isinstance(v, bool):
            continue  # booleans are state, not measurements
        elif isinstance(v, (int, float)):
            flat[key] = float(v)
    return flat
