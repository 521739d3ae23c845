"""Span tracing: where a request's or a step's time goes, as data (a copy
of alphafold2_tpu/telemetry/trace.py, which imports only the standard
library).

A `Tracer` records nestable, thread-safe spans with attributes, exported as

  * Chrome trace-event JSON (`export_chrome`), for Perfetto
    (https://ui.perfetto.dev) or chrome://tracing: one timeline a thread,
    nesting from same-thread ts/dur containment;
  * JSONL (`export_jsonl`), one span a line;
  * `summary()`: per span name count / total / mean / max seconds, the
    payload the engine's `stats()` carries.

Cost contract: a disabled tracer's `span()` returns one shared no-op
object: no allocation, no lock, no record, and nothing touches the card
(a span never calls CUDA or synchronizes; a span around device work
closes after the call that waits for it, or carries a `device_ms`
attribute read from CUDA events). `NULL_TRACER` is the default wiring.

Memory is bounded: at most `max_spans` spans are kept; the rest are
counted in `dropped` (in `summary()` and the Chrome export).

Correlation: `new_trace_id()` mints a request id at `submit()`;
`Tracer.bind_trace(id)` binds it to the thread, so every span recorded
there carries `trace_id` (a list binding gives `trace_ids`, for a batch).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import uuid
from typing import Optional


def new_trace_id() -> str:
    """A fresh 16-hex-char request trace id (random, not time-derived:
    two fleets started in the same instant must not collide)."""
    return uuid.uuid4().hex[:16]


class _NullSpan:
    """Shared no-op span: the disabled-tracer fast path. Stateless and
    reentrant, so ONE module-level instance serves every call site."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):  # noqa: ARG002 — signature parity with _Span
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span; created by `Tracer.span` and recorded on exit."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def set(self, key, value):
        """Attach/overwrite one attribute mid-span."""
        self.attrs[key] = value
        return self

    def __enter__(self):
        self._depth = self._tracer._push()
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = self._tracer._clock() - self._t0
        self._tracer._pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._record(
            self.name, self.cat, self._t0, dur, self._depth, self.attrs
        )
        return False


class Tracer:
    """Thread-safe collector of completed spans.

    Args:
      enabled: False gives the no-op fast path (see module docstring).
      max_spans: retention bound; overflow increments `dropped`.
      clock: injectable monotonic clock (tests pin time).
    """

    def __init__(self, enabled: bool = True, max_spans: int = 100_000,
                 clock=time.perf_counter):
        if max_spans <= 0:
            raise ValueError(f"max_spans must be positive, got {max_spans}")
        self.enabled = enabled
        self.max_spans = max_spans
        self._clock = clock
        self._t_origin = clock()
        self._lock = threading.Lock()
        self._spans: list = []
        self.dropped = 0
        self._tls = threading.local()

    # ------------------------------------------------------------ recording

    def span(self, name: str, cat: str = "app", **attrs):
        """Context manager for one timed phase; attributes are JSON leaves.

        ``with tracer.span("serving.batch", cat="serving", bucket=64):``
        """
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, attrs)

    def add(self, name: str, duration_s: float, cat: str = "app",
            end_at: Optional[float] = None, **attrs):
        """Record a span measured elsewhere (e.g. queue wait computed from
        a request's submit timestamp): ends at `end_at` (default: now) on
        this tracer's clock, started `duration_s` earlier."""
        if not self.enabled:
            return
        end = self._clock() if end_at is None else end_at
        self._record(name, cat, end - duration_s, duration_s, 0, attrs)

    @contextlib.contextmanager
    def bind_trace(self, trace):
        """Bind a trace identity to the CURRENT thread for the enclosed
        block: every span recorded here (nested spans included, helpers
        that never heard of tracing included — the AOT compile inside a
        device dispatch is the motivating case) inherits it unless the
        span set its own. `trace` is one id (str; spans gain `trace_id`)
        or a list of ids for batch-scoped work (spans gain `trace_ids`).
        No-op (beyond one boolean test) on a disabled tracer."""
        if not self.enabled or not trace:
            yield
            return
        prev = getattr(self._tls, "trace", None)
        self._tls.trace = trace
        try:
            yield
        finally:
            self._tls.trace = prev

    def current_trace_id(self) -> Optional[str]:
        """The single id bound to this thread, if any (None under a
        list binding — a batch has no one id)."""
        bound = getattr(self._tls, "trace", None)
        return bound if isinstance(bound, str) else None

    def _push(self) -> int:
        depth = getattr(self._tls, "depth", 0)
        self._tls.depth = depth + 1
        return depth

    def _pop(self):
        self._tls.depth = getattr(self._tls, "depth", 1) - 1

    def _record(self, name, cat, t0, dur, depth, attrs):
        bound = getattr(self._tls, "trace", None)
        if isinstance(bound, str):
            if "trace_id" not in attrs:
                attrs["trace_id"] = bound
        elif bound and "trace_ids" not in attrs:
            attrs["trace_ids"] = list(bound)
        rec = {
            "name": name,
            "cat": cat,
            "ts_s": t0 - self._t_origin,
            "dur_s": dur,
            "depth": depth,
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
            "attrs": attrs,
        }
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
            else:
                self._spans.append(rec)

    # ------------------------------------------------------------- reading

    def spans(self, last: Optional[int] = None) -> list:
        """Snapshot (shallow copies) of the completed spans; `last=N`
        copies only the N most recent (the flight recorder's bundle
        tail — copying 100k spans per incident would be the outage
        amplifying itself)."""
        with self._lock:
            if last is None:
                src = self._spans
            else:
                # [-last:] with last=0 is the WHOLE list, not none of it
                src = self._spans[-last:] if last > 0 else []
            return [dict(s) for s in src]

    @property
    def span_count(self) -> int:
        """Retained-span count without copying the records."""
        with self._lock:
            return len(self._spans)

    def summary(self) -> dict:
        """Per-span-name aggregate: {name: {count, total_s, mean_s, max_s}}
        plus a `dropped` count when retention overflowed."""
        agg: dict = {}
        with self._lock:
            spans = list(self._spans)
            dropped = self.dropped
        for s in spans:
            a = agg.setdefault(
                s["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            a["count"] += 1
            a["total_s"] += s["dur_s"]
            if s["dur_s"] > a["max_s"]:
                a["max_s"] = s["dur_s"]
        for a in agg.values():
            a["mean_s"] = a["total_s"] / a["count"]
            a["total_s"] = round(a["total_s"], 6)
            a["mean_s"] = round(a["mean_s"], 6)
            a["max_s"] = round(a["max_s"], 6)
        if dropped:
            agg["_dropped"] = dropped
        return agg

    # ------------------------------------------------------------ exporters

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object format: complete ("ph": "X")
        events in microseconds, one per span, plus thread-name metadata so
        Perfetto labels the worker/client timelines. Nesting needs no
        parent links — same-tid ts/dur containment renders the stack."""
        with self._lock:
            spans = list(self._spans)
            dropped = self.dropped
        events = []
        threads_seen = {}
        for s in spans:
            tid = s["tid"]
            if tid not in threads_seen:
                threads_seen[tid] = s["thread"]
                events.append({
                    "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                    "args": {"name": s["thread"]},
                })
            events.append({
                "name": s["name"],
                "cat": s["cat"],
                "ph": "X",
                # clamp: a retro-recorded span (Tracer.add) can nominally
                # start before the tracer existed; viewers expect ts >= 0
                "ts": round(max(0.0, s["ts_s"]) * 1e6, 3),
                "dur": round(s["dur_s"] * 1e6, 3),
                "pid": 1,
                "tid": tid,
                "args": {**s["attrs"], "depth": s["depth"]},
            })
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        if dropped:
            out["otherData"] = {"dropped_spans": dropped}
        return out

    def export_chrome(self, path: str):
        """Write the Chrome trace-event JSON; open in Perfetto or
        chrome://tracing."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)

    def export_jsonl(self, path: str):
        """One span record per line (append mode: successive phases of one
        run accumulate into one stream)."""
        with open(path, "a") as fh:
            for s in self.spans():
                fh.write(json.dumps(s) + "\n")


#: shared disabled tracer — the default for every instrumented call site,
#: so production paths pay one `if not enabled` per span and nothing else
NULL_TRACER = Tracer(enabled=False, max_spans=1)
