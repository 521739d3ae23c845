"""Serving metrics (counterpart of alphafold2_tpu/serving/metrics.py).

Every count lives in a `telemetry.registry.MetricRegistry`:

  requests:  counter `serving_requests_total{outcome=...}`
  errors:    counter `serving_errors_total{code=...}`
  batches:   counters `serving_batches_total` / `serving_batch_requests_total`
  captures:  counter `serving_capture_total{bucket=...}`, gauges
             `serving_capture_seconds_total` / `serving_capture_last_seconds`
             and a `serving_capture` span (`telemetry/hooks.py
             CompileTracker`): the port's counterpart of the JAX engine's
             compiles, one per (bucket, batch rung) executable built (a
             CUDA graph capture on the card, an eager executable on the CPU)
  latency:   histogram `serving_request_latency_seconds` (sliding window)
  padding:   gauge `serve_batch_pad_ratio`, padded rows / live rows
  pipeline:  gauges `serve_pipeline_inflight` / `serve_pipeline_overlap_ratio`,
             fed by the engine's pipelined dispatch (its settle thread)

`snapshot()` keeps the JAX engine's JSON shape, `compiles` included
(`count` = distinct buckets built, `seconds_by_bucket`), so one set of
assertions reads both engines' `stats()`. An optional `MetricsLogger`
gets one record a dispatched batch.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Optional

from alphafold2_tpu_torch.telemetry.hooks import CompileTracker
from alphafold2_tpu_torch.telemetry.logger import MetricsLogger
from alphafold2_tpu_torch.telemetry.registry import MetricRegistry
from alphafold2_tpu_torch.telemetry.trace import NULL_TRACER

# request-terminal counters: everything submitted lands in exactly one of
# completed / failed / timed_out, or stays in flight
_COUNTERS = (
    "submitted",      # accepted by submit() (cache hits included)
    "completed",      # result delivered (cache hits included)
    "failed",         # PredictionError / EngineClosedError / HungBatchError
    "timed_out",      # scheduler-side deadline expiry
    "rejected",       # refused at submit(): queue full, too long, invalid
    "cache_hits",     # completed without touching the queue or the model
    "coalesced",      # attached to an identical in-flight request
)


class ServingMetrics:
    """Thread-safe counters and histograms for one engine."""

    def __init__(self, logger: Optional[MetricsLogger] = None, tracer=NULL_TRACER):
        self.registry = MetricRegistry()
        # one lock over the terminal counters, so a stats() reader sees a
        # consistent in_flight
        self._counts_lock = threading.Lock()
        self._counts = {name: self.registry.counter("serving_requests_total",
                                                    help="request-terminal outcomes",
                                                    outcome=name)
                        for name in _COUNTERS}
        self._errors_lock = threading.Lock()
        self._errors = {}  # stable error code -> Counter
        self.latency = self.registry.histogram(
            "serving_request_latency_seconds", help="submit->complete latency, sliding window")
        self._batches = self.registry.counter("serving_batches_total",
                                              help="dispatched batches")
        self._batch_requests = self.registry.counter(
            "serving_batch_requests_total", help="real requests across dispatched batches")
        self._recent_lock = threading.Lock()
        self._recent_batch_sizes = collections.deque(maxlen=256)
        self._shape_rows = 0   # sum of the chosen batch shapes
        self._live_rows = 0    # sum of real requests
        self._pad_ratio_gauge = self.registry.gauge(
            "serve_batch_pad_ratio",
            help="cumulative padded rows / live rows across dispatched batches")
        # pipelined dispatch (the engine's settle thread): span = a batch's
        # enqueue -> realized wall; window = the same span clamped against
        # the batches realized before it (the seconds not billed twice).
        # span / window > 1 exactly when batches in flight overlapped
        self._pipe_lock = threading.Lock()
        self._pipe_span_s = 0.0
        self._pipe_window_s = 0.0
        self._pipe_inflight = 0
        self._pipe_inflight_gauge = self.registry.gauge(
            "serve_pipeline_inflight", help="batches enqueued on device but not yet settled")
        self._pipe_overlap_gauge = self.registry.gauge(
            "serve_pipeline_overlap_ratio",
            help="sum(enqueue->realized spans) / union of those spans; "
                 "1.0 = synchronous dispatch, >1.0 = pipelined overlap")
        self._captures_lock = threading.Lock()
        self._capture_seconds = {}  # bucket -> seconds gauge
        # the tracker's `serving_capture_seconds_total{bucket}` gauge is the
        # object the snapshot's per-bucket view holds (identity = name +
        # labels), so the two never diverge
        self.compile_tracker = CompileTracker(self.registry, tracer=tracer,
                                              prefix="serving_capture")
        self._logger = logger
        self._t0 = time.monotonic()

    def inc(self, name: str, n: int = 1):
        with self._counts_lock:
            self._counts[name].inc(n)

    def inc_error(self, code_or_exc, n: int = 1):
        """Count one error under its stable code (a code string or a
        ServingError)."""
        code = getattr(code_or_exc, "code", code_or_exc)
        with self._errors_lock:
            counter = self._errors.get(code)
            if counter is None:
                counter = self.registry.counter("serving_errors_total", code=code)
                self._errors[code] = counter
        counter.inc(n)

    def observe_batch(self, n_real: int, batch_shape: int, latency_s: float):
        """One dispatched batch: n_real requests in `batch_shape` row slots
        (the rung it ran at); latency_s is its oldest member's."""
        self._batches.inc()
        self._batch_requests.inc(n_real)
        with self._recent_lock:
            self._recent_batch_sizes.append(n_real)
            self._shape_rows += batch_shape
            self._live_rows += n_real
            live, pad = self._live_rows, self._shape_rows - self._live_rows
        self._pad_ratio_gauge.set(pad / live if live else 0.0)
        if self._logger is not None:
            self._logger.log(int(self._batches.value), {
                "batch_requests": n_real,
                "batch_shape": batch_shape,
                "batch_occupancy": n_real / batch_shape,
                "batch_latency_s": latency_s,
            })

    def observe_pipeline_settle(self, span_s: float, window_s: float):
        """One settled pipelined batch: its enqueue -> realized span and
        that span's share not overlapping earlier batches. The published
        overlap ratio is the cumulative span / window."""
        with self._pipe_lock:
            self._pipe_span_s += span_s
            self._pipe_window_s += window_s
            span, window = self._pipe_span_s, self._pipe_window_s
        self._pipe_overlap_gauge.set(span / window if window > 0 else 0.0)

    def pipeline_inflight_delta(self, delta: int):
        """Track the batches enqueued but not yet settled."""
        with self._pipe_lock:
            self._pipe_inflight += delta
            n = self._pipe_inflight
        self._pipe_inflight_gauge.set(n)

    def pipeline_snapshot(self) -> dict:
        with self._pipe_lock:
            span, window = self._pipe_span_s, self._pipe_window_s
            inflight = self._pipe_inflight
        return {"inflight": inflight, "span_seconds": span, "window_seconds": window,
                "overlap_ratio": span / window if window > 0 else 0.0}

    @contextlib.contextmanager
    def capture_span(self, bucket: int):
        """Around one executable's build: the tracker's counters, gauges and
        span under the bucket. A build that raises counts under
        `serving_capture_failed_total` and never as a built bucket."""
        with self.compile_tracker.track(bucket=str(bucket)):
            yield
        gauge = self.registry.gauge("serving_capture_seconds_total",
                                    help="cumulative compile wall seconds", bucket=str(bucket))
        with self._captures_lock:
            self._capture_seconds[bucket] = gauge

    def set_weight_bytes(self, residency: dict):
        """`serving_weight_bytes{tag, weight_dtype}`: the bytes this
        engine's parameter tree keeps on its device."""
        self.registry.gauge("serving_weight_bytes",
                            help="resident parameter-tree bytes for this engine's residency tag",
                            tag=residency["tag"],
                            weight_dtype=residency["weight_dtype"]).set(residency["weight_bytes"])

    @property
    def compile_count(self) -> int:
        """Distinct buckets with a built executable (<= len(buckets))."""
        with self._captures_lock:
            return len(self._capture_seconds)

    def compile_seconds_total(self) -> float:
        """Cumulative capture seconds over every bucket: the engine reads it
        around a device call, so a first call's capture stays out of the
        cost ledger's EMA and goodput's "execute"."""
        with self._captures_lock:
            return float(sum(g.value for g in self._capture_seconds.values()))

    def snapshot(self, max_batch: int) -> dict:
        with self._counts_lock:
            counts = {name: int(c.value) for name, c in self._counts.items()}
        batches = int(self._batches.value)
        batch_requests = int(self._batch_requests.value)
        with self._recent_lock:
            recent = list(self._recent_batch_sizes)
            shape_rows, live_rows = self._shape_rows, self._live_rows
        with self._captures_lock:
            captures = {b: g.value for b, g in self._capture_seconds.items()}
        with self._errors_lock:
            errors = {code: int(c.value) for code, c in self._errors.items()}
        in_flight = (counts["submitted"] - counts["completed"] - counts["failed"]
                     - counts["timed_out"])
        latency = self.latency.snapshot()
        latency.pop("sum", None)      # the lifetime sum and the cumulative
        latency.pop("buckets", None)  # buckets are /metrics detail
        return {
            "uptime_s": time.monotonic() - self._t0,
            "requests": {**counts, "in_flight": in_flight},
            "batches": {
                "count": batches,
                "mean_requests_per_batch": batch_requests / batches if batches else 0.0,
                # occupancy of the chosen rung; max_batch slots for paths
                # that never observed a batch
                "mean_occupancy": (
                    batch_requests / shape_rows if shape_rows
                    else (batch_requests / (batches * max_batch) if batches else 0.0)
                ),
                "pad_ratio": (shape_rows - live_rows) / live_rows if live_rows else 0.0,
                "recent_sizes": recent,
            },
            "compiles": {
                "count": len(captures),
                "seconds_by_bucket": {str(k): v for k, v in captures.items()},
            },
            "errors": errors,
            "latency": latency,
        }
