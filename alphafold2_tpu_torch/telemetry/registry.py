"""Metric registry: named counters, gauges and histograms (counterpart of
alphafold2_tpu/telemetry/registry.py, the part `serving/metrics.py` reads;
the Prometheus exposition waits for the port's telemetry, ROADMAP A14).

Identity is (name, sorted labels): registering the same identity again
returns the same object, and registering a name as another type raises.
`snapshot()` is the JSON view the engine's `stats()` carries.
"""

from __future__ import annotations

import collections
import re
import threading
from typing import Dict, Tuple


class LatencyHistogram:
    """Percentiles over the last `window` observations (nearest rank on a
    sorted copy), plus the lifetime count, sum and max. Thread-safe."""

    def __init__(self, window: int = 2048):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self._values = collections.deque(maxlen=window)
        self._lock = threading.Lock()
        self._count = 0
        self._max = 0.0
        self._sum = 0.0

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
        if not ordered:
            return 0.0
        idx = min(len(ordered) - 1, int(round(q / 100.0 * (len(ordered) - 1))))
        return ordered[idx]

    def percentile(self, q: float) -> float:
        with self._lock:
            ordered = sorted(self._values)
        return self._percentile(ordered, q)

    def snapshot(self) -> dict:
        """count (lifetime), window, mean, p50/p95/p99, max, sum."""
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


def render_labels(key: LabelsKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
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


class Gauge(Counter):
    kind = "gauge"

    def set(self, v: float):
        with self._lock:
            self._value = float(v)


class Histogram(LatencyHistogram):
    kind = "histogram"


class MetricRegistry:
    """Get-or-create factory for named metrics, and their JSON snapshot."""

    def __init__(self, histogram_window: int = 2048):
        self._histogram_window = histogram_window
        self._lock = threading.Lock()
        self._families: Dict[str, tuple] = {}  # name -> (kind, {labels: metric})

    def _get(self, cls, name: str, labels: dict):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        bad = [k for k in labels if not _LABEL_RE.match(str(k))]
        if bad:
            raise ValueError(f"invalid label name(s) {bad} on {name!r}")
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.setdefault(name, (cls.kind, {}))
            if fam[0] != cls.kind:
                raise ValueError(f"metric {name!r} already registered as {fam[0]}, "
                                 f"requested {cls.kind}")
            metric = fam[1].get(key)
            if metric is None:
                metric = cls(self._histogram_window) if cls is Histogram else cls()
                fam[1][key] = metric
            return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> dict:
        """{"counters": {rendered name: value}, "gauges": {...},
        "histograms": {rendered name: {count, p50, ...}}}."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            families = {n: (kind, dict(series)) for n, (kind, series) in self._families.items()}
        for name, (kind, series) in sorted(families.items()):
            for key, metric in sorted(series.items()):
                rendered = name + render_labels(key)
                if kind == "histogram":
                    out["histograms"][rendered] = metric.snapshot()
                else:
                    out[kind + "s"][rendered] = metric.value
        return out
