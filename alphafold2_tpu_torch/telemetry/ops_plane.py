"""The live operations plane: HTTP observability and the incident flight
recorder (counterpart of alphafold2_tpu/telemetry/ops_plane.py; standard
library only, `torch.profiler` for `/profilez`).

`OpsServer`, a threaded `http.server`:

  * ``/metrics``  the registry's Prometheus text (v0.0.4), which
                  `registry.parse_prometheus_text` reads back;
  * ``/healthz``  the engine's or trainer's `health()` JSON: 200 while
                  "ok" / "degraded", 503 when "down";
  * ``/statusz``  health, the stats snapshot, the registry snapshot, the
                  span summary, the SLO state, the flight recorder's;
  * ``/explainz`` `?trace_id=<id>`: one request's flight record from a
                  `costs.FlightBook` (400 without an id, 404 unknown);
  * ``/profilez`` `?duration_s=N`: one bounded, rate-limited
                  `torch.profiler` capture (`ProfileCapturer`; 409 while
                  one runs, 429 inside the rate limit);
  * ``/threadz``  every live thread and its stack.

A ticker thread runs the periodic work: `SloEngine.evaluate()`,
`FlightRecorder.poll()` and any `add_tick` callables (memory gauges, the
cost ledgers' publish). Construction binds the socket (port 0 =
ephemeral, `.port` the real one); nothing runs until `start()`.

The capture-mode rule: a CUDA graph captures in CUDA's global capture
mode, where no other thread of the process may make an unsafe CUDA call.
Every handler and tick here reads host state only (the registry, the
ledgers, the tracer, the engine's `health()` / `stats()`, the caching
allocator's counters); the one exception, the profiler, starts and stops
under the engine's graph-pool lock.

`FlightRecorder`: a bounded ring of recent events (incidents, SLO
transitions, counter deltas); an incident (breaker open, watchdog fire,
SLO page, a training stall) also writes a forensic bundle to disk: the
ring, the tail of the span stream, the registry snapshot and the stats.
Bundles are rate-limited per kind (`min_interval_s`).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional
from urllib.parse import parse_qs, urlsplit

from alphafold2_tpu_torch.telemetry.registry import MetricRegistry
from alphafold2_tpu_torch.telemetry.trace import NULL_TRACER, Tracer

#: incident kinds the stack's seams report today (an unknown kind is
#: still recorded — this list is documentation, not a gate)
KNOWN_INCIDENT_KINDS = (
    "breaker_open",     # engine circuit transitioned to open
    "replica_drain",    # fleet health monitor took a replica out
    "watchdog_fire",    # hung-batch watchdog abandoned a dispatch
    "slo_page",         # an SLO objective started firing
    "scale_up",         # autoscaler grew the replica pool
    "scale_down",       # autoscaler retired a replica
    "featurize_worker_death",  # a featurize worker thread died (respawned)
    "train_straggler",  # one pod process's step time diverged from the rest
    "train_data_stall",  # the input pipeline stalled training (local fetch
    #                      share or pod fetch skew past threshold)
)


def write_atomic(path: str, text: str):
    """Write `text` to `path` through a temporary file and a rename: a
    reader never sees a torn file (the flight bundles, the port files,
    serve's stats JSON)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


class FlightRecorder:
    """Bounded event ring + incident bundle writer (see module docstring).

    Args:
      out_dir: where bundles land (created lazily on first incident).
      tracer: span source for the bundle tail (`NULL_TRACER` = no spans).
      registry: metric source for delta events and bundle snapshots; the
        recorder also counts itself here (`flight_incidents_total{kind}`,
        `flight_bundles_written_total`). None disables both.
      stats_fn: optional zero-arg callable whose JSON-ready return value
        is embedded in each bundle (an engine/fleet `stats`).
      capacity: event-ring bound.
      span_tail: how many of the most recent spans a bundle carries.
      min_interval_s: per-kind bundle rate limit; suppressed incidents
        are ring events only.
      clock: wall clock for bundle timestamps (injectable for tests).
    """

    def __init__(self, out_dir: str, *, tracer: Tracer = NULL_TRACER,
                 registry: Optional[MetricRegistry] = None, stats_fn=None,
                 capacity: int = 1024, span_tail: int = 512,
                 min_interval_s: float = 5.0, clock=time.time):
        if capacity < 1 or span_tail < 0:
            raise ValueError(
                f"capacity must be >= 1 and span_tail >= 0, got "
                f"{capacity}/{span_tail}"
            )
        self.out_dir = out_dir
        self._tracer = tracer
        self._registry = registry
        self._stats_fn = stats_fn
        self._span_tail = span_tail
        self._min_interval_s = min_interval_s
        self._clock = clock
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._capacity = capacity
        self._seq = 0                  # bundle sequence number
        self._last_bundle_at = {}      # kind -> wall ts of last bundle
        self._bundles: List[str] = []  # paths written this process
        self._suppressed = 0
        self._last_counters = None     # poll() delta baseline

    def bind(self, *, registry: Optional[MetricRegistry] = None,
             stats_fn=None):
        """Late wiring for the construction-order cycle: the recorder
        must exist BEFORE the engine/fleet (it is their incident_hook),
        but the engine owns the registry and stats the bundles embed."""
        if registry is not None:
            self._registry = registry
        if stats_fn is not None:
            self._stats_fn = stats_fn

    # ------------------------------------------------------------- events

    def note(self, kind: str, **attrs):
        """Append one event to the ring (no disk I/O)."""
        with self._lock:
            self._events.append(
                {"ts": self._clock(), "kind": kind, "attrs": attrs}
            )
            if len(self._events) > self._capacity:
                del self._events[: len(self._events) - self._capacity]

    def poll(self):
        """Ticker hook: record which counters moved since the last poll
        as one `metrics_delta` ring event — the bundle's answer to "what
        was happening in the minute before the incident" even when spans
        are off."""
        if self._registry is None:
            return
        current = {}
        for name, (kind, series) in self._registry.collect().items():
            if kind != "counter":
                continue
            for key, metric in series.items():
                current[(name, key)] = metric.value
        with self._lock:
            last, self._last_counters = self._last_counters, current
        if last is None:
            return
        deltas = {}
        for (name, key), v in current.items():
            d = v - last.get((name, key), 0.0)
            if d:
                label = name + "".join(f"{{{k}={val}}}" for k, val in key)
                deltas[label] = d
        if deltas:
            self.note("metrics_delta", deltas=deltas)

    # ----------------------------------------------------------- incidents

    def incident(self, kind: str, **attrs) -> Optional[str]:
        """One incident: ring event + (rate limits permitting) a bundle
        on disk. Returns the bundle path, or None when suppressed.
        Never raises — the recorder is called from reliability seams
        that must keep serving through a full disk."""
        now = self._clock()
        self.note("incident:" + kind, **attrs)
        if self._registry is not None:
            self._registry.counter(
                "flight_incidents_total", help="incidents by kind",
                kind=kind).inc()
        with self._lock:
            last = self._last_bundle_at.get(kind)
            if last is not None and now - last < self._min_interval_s:
                self._suppressed += 1
                return None
            self._last_bundle_at[kind] = now
            self._seq += 1
            seq = self._seq
        try:
            return self._write_bundle(seq, kind, attrs, now)
        except Exception:  # noqa: BLE001 — see docstring
            traceback.print_exc()
            return None

    def _write_bundle(self, seq: int, kind: str, attrs: dict,
                      now: float) -> str:
        bundle = {
            "incident": {"seq": seq, "kind": kind, "ts": now,
                         "attrs": attrs},
            "events": None,   # filled under the lock below
            "spans": self._tracer.spans(last=self._span_tail),
        }
        with self._lock:
            bundle["events"] = list(self._events)
        if self._registry is not None:
            bundle["metrics"] = self._registry.snapshot()
        if self._stats_fn is not None:
            try:
                bundle["stats"] = self._stats_fn()
            except Exception:  # noqa: BLE001 — a failing stats provider
                # must not cost the rest of the bundle
                bundle["stats_error"] = traceback.format_exc()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"incident-{seq:03d}-{kind}.json")
        write_atomic(path, json.dumps(bundle, indent=1, default=str))
        if self._registry is not None:
            self._registry.counter(
                "flight_bundles_written_total",
                help="forensic bundles snapshotted to disk").inc()
        with self._lock:
            self._bundles.append(path)
        return path

    def slo_page_hook(self, objective: str, transition: str, info: dict):
        """Adapter matching `SloEngine(on_page=...)`: a FIRING transition
        is an incident (bundle), a RESOLVED transition is a ring event."""
        # info already carries objective/transition keys (slo.py builds
        # it that way) — merge rather than re-pass, or the duplicate
        # kwarg would TypeError and the page would never bundle
        attrs = dict(info)
        attrs.setdefault("objective", objective)
        if transition == "firing":
            self.incident("slo_page", **attrs)
        else:
            self.note("slo_" + transition, **attrs)

    # -------------------------------------------------------------- stats

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dir": self.out_dir,
                "events": len(self._events),
                "bundles": list(self._bundles),
                "suppressed_bundles": self._suppressed,
            }


class ProfileCapturer:
    """On-demand, duration-bounded, rate-limited `torch.profiler` capture
    (the `/profilez` backing; the JAX package drives `jax.profiler`).

    One capture at a time: `start()` raises `ProfileBusyError` while one
    runs (HTTP 409) and `ProfileRateLimitedError` within `min_interval_s`
    of the previous start (HTTP 429). The capture runs on its own
    non-daemon thread: `torch.profiler.profile` (CPU, and CUDA where the
    card is up) started, stopped after `duration_s` (clamped to
    `max_duration_s`), and its Chrome trace written to
    `<out_dir>/profile-<seq>/trace.json`. Outcomes are counted
    (`profilez_captures_total{outcome}`).

    `lock`: the engine's graph-pool lock (`ServingEngine.graph_lock`). A
    CUDA graph captures in CUDA's global capture mode, where no other
    thread may touch the card, and the pool's lock is held across every
    capture and replay; the profiler starts and stops only while this
    thread holds it, so neither ever meets a capture.
    """

    def __init__(self, out_dir: str, *,
                 registry: Optional[MetricRegistry] = None,
                 max_duration_s: float = 30.0, min_interval_s: float = 30.0,
                 clock=time.monotonic, lock=None):
        if max_duration_s <= 0 or min_interval_s < 0:
            raise ValueError(
                f"max_duration_s must be > 0 and min_interval_s >= 0, got "
                f"{max_duration_s}/{min_interval_s}")
        self.out_dir = out_dir
        self._registry = registry
        self.max_duration_s = max_duration_s
        self.min_interval_s = min_interval_s
        self._clock = clock
        self._device_lock = lock if lock is not None else contextlib.nullcontext()
        self._lock = threading.Lock()
        self._running: Optional[dict] = None
        self._last_start: Optional[float] = None
        self._seq = 0
        self._captures: List[dict] = []
        self._abort = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _count(self, outcome: str):
        if self._registry is not None:
            self._registry.counter(
                "profilez_captures_total",
                help="/profilez capture requests by outcome",
                outcome=outcome).inc()

    def start(self, duration_s: float = 2.0) -> dict:
        """Begin one capture; returns {"dir", "duration_s", "seq", "trace"}
        at once (the trace file is written when the capture ends). Raises
        ProfileBusyError / ProfileRateLimitedError / ValueError(duration),
        which the HTTP layer maps to 409 / 429 / 400. A profiler that
        fails to start or stop is counted (`outcome="failed"`) and shown
        in `snapshot()`."""
        if duration_s <= 0:
            raise ValueError(
                f"duration_s must be positive, got {duration_s}")
        duration_s = min(float(duration_s), self.max_duration_s)
        now = self._clock()
        with self._lock:
            if self._running is not None:
                self._count("rejected_busy")
                raise ProfileBusyError(
                    f"a profile capture is already running "
                    f"(dir {self._running['dir']})")
            if (self._last_start is not None
                    and now - self._last_start < self.min_interval_s):
                self._count("rejected_rate_limited")
                raise ProfileRateLimitedError(
                    f"last capture started "
                    f"{now - self._last_start:.1f}s ago; minimum interval "
                    f"is {self.min_interval_s}s")
            self._seq += 1
            seq = self._seq
            path = os.path.join(self.out_dir, f"profile-{seq:03d}")
            info = {"seq": seq, "dir": path, "duration_s": duration_s,
                    "trace": os.path.join(path, "trace.json")}
            self._running = info
            self._last_start = now
        self._abort.clear()

        def finish():
            with self._lock:
                self._running = None
                self._captures.append(dict(info))

        def capture():
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            # never initialize the card from here: profile it only when the
            # process already uses it
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            try:
                os.makedirs(path, exist_ok=True)
                with self._device_lock:
                    prof.start()
            except Exception:  # noqa: BLE001 — surfaced via snapshot
                traceback.print_exc()
                self._count("failed")
                info["error"] = "the profiler failed to start (see server log)"
                finish()
                return
            self._count("started")
            self._abort.wait(duration_s)
            try:
                with self._device_lock:
                    prof.stop()
                prof.export_chrome_trace(info["trace"])
            except Exception:  # noqa: BLE001 — a failing stop must not
                # kill the capture thread silently mid-serving
                traceback.print_exc()
                info["error"] = "the profiler failed to stop or export (see server log)"
            finally:
                finish()

        self._thread = threading.Thread(
            target=capture, name="af2-profilez-capture", daemon=False)
        self._thread.start()
        return dict(info)

    def close(self, timeout: Optional[float] = 30.0):
        """Abort any in-flight capture and join the capture thread —
        called from `OpsServer.stop()` so a capture can never be left
        racing process teardown (a start waiting on the graph-pool lock
        holds the join up to one capture or replay; the non-daemon thread
        covers the exit path even if this times out). Idempotent."""
        self._abort.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dir": self.out_dir,
                "running": dict(self._running) if self._running else None,
                "captures": [dict(c) for c in self._captures],
                "max_duration_s": self.max_duration_s,
                "min_interval_s": self.min_interval_s,
            }


class ProfileBusyError(RuntimeError):
    """A capture is already in flight (HTTP 409)."""


class ProfileRateLimitedError(RuntimeError):
    """Too soon after the previous capture (HTTP 429)."""


class _Handler(BaseHTTPRequestHandler):
    """One request; the server instance carries the providers."""

    server_version = "af2-ops/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: ARG002 — silence stdout;
        # scrape-per-second access logs are noise in a serving console
        pass

    def _send(self, code: int, body: bytes, content_type: str):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload):
        self._send(code, json.dumps(payload, indent=1, default=str)
                   .encode("utf-8"), "application/json")

    def do_GET(self):  # noqa: N802 — http.server API
        ops: "OpsServer" = self.server.ops  # type: ignore[attr-defined]
        parts = urlsplit(self.path)
        path = parts.path.rstrip("/") or "/"
        query = parse_qs(parts.query)
        try:
            if path == "/metrics":
                body = ops.registry.to_prometheus().encode("utf-8")
                ops.registry.counter(
                    "ops_scrapes_total",
                    help="/metrics scrapes served").inc()
                self._send(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                payload = ops.health()
                code = 503 if payload.get("status") == "down" else 200
                self._send_json(code, payload)
            elif path == "/statusz":
                self._send_json(200, ops.statusz())
            elif path == "/explainz":
                code, payload = ops.explainz(
                    query.get("trace_id", [None])[0])
                self._send_json(code, payload)
            elif path == "/profilez":
                code, payload = ops.profilez(
                    query.get("duration_s", [None])[0])
                self._send_json(code, payload)
            elif path == "/threadz":
                self._send_json(200, ops.threadz())
            elif path == "/":
                self._send_json(200, {"endpoints": [
                    "/metrics", "/healthz", "/statusz", "/explainz",
                    "/profilez", "/threadz"]})
            else:
                self._send_json(404, {"error": f"no such endpoint {path!r}"})
        except Exception:  # noqa: BLE001 — a handler bug must answer 500,
            # not silently drop the connection
            self._send(500, traceback.format_exc().encode("utf-8"),
                       "text/plain; charset=utf-8")


class OpsServer:
    """The observability HTTP server + periodic ticker (module docstring).

    Construction BINDS the port (so `.port` is real immediately and a
    bind failure surfaces at build, not mid-traffic) but serves nothing
    until `start()`. `stop()` is idempotent and joins both threads.
    """

    def __init__(self, *, registry: MetricRegistry,
                 health_fn: Optional[Callable[[], dict]] = None,
                 stats_fn: Optional[Callable[[], dict]] = None,
                 backpressure_fn: Optional[Callable[[], dict]] = None,
                 tracer: Tracer = NULL_TRACER,
                 slo=None, recorder: Optional[FlightRecorder] = None,
                 flights=None, profiler: Optional[ProfileCapturer] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 tick_interval_s: float = 1.0):
        if tick_interval_s <= 0:
            raise ValueError(
                f"tick_interval_s must be positive, got {tick_interval_s}"
            )
        self.registry = registry
        self._health_fn = health_fn
        self._stats_fn = stats_fn
        # shed-advice provider (ServingFleet.backpressure): the queue /
        # per-pool / retry-budget retry_after_s horizons a 429-emitting
        # HTTP front end quotes in Retry-After headers
        self._backpressure_fn = backpressure_fn
        self._tracer = tracer
        self.slo = slo
        self.recorder = recorder
        self.flights = flights      # telemetry.costs.FlightBook (/explainz)
        self.profiler = profiler    # ProfileCapturer (/profilez)
        self._dropped_seen = 0
        if tracer.enabled:
            # registered eagerly at 0 so span loss is alertable from the
            # first scrape (the ticker publishes increments; before this
            # counter, retention overflow was visible only in summary()
            # and the Chrome export's otherData)
            registry.counter(
                "trace_spans_dropped_total",
                help="spans lost to the tracer retention bound "
                     "(max_spans) — raise --trace-max-spans if nonzero")
        self._tick_interval_s = tick_interval_s
        self._extra_ticks: List[Callable[[], None]] = []
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.ops = self  # type: ignore[attr-defined]
        self._serve_thread: Optional[threading.Thread] = None
        self._tick_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ address

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    # ----------------------------------------------------------- payloads

    def health(self) -> dict:
        if self._health_fn is None:
            return {"status": "ok"}
        return self._health_fn()

    def statusz(self) -> dict:
        out = {
            "health": self.health(),
            "metrics": self.registry.snapshot(),
            "spans": self._tracer.summary(),
        }
        if self._stats_fn is not None:
            out["stats"] = self._stats_fn()
        if self._backpressure_fn is not None:
            out["backpressure"] = self._backpressure_fn()
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        if self.recorder is not None:
            out["flight_recorder"] = self.recorder.snapshot()
        if self.flights is not None:
            out["flights"] = self.flights.snapshot()
        if self.profiler is not None:
            out["profiler"] = self.profiler.snapshot()
        return out

    def explainz(self, trace_id: Optional[str]):
        """(code, payload) for `/explainz?trace_id=` — the exemplar
        flight lookup (telemetry/costs.py FlightBook)."""
        if self.flights is None:
            return 404, {"error": "no flight book wired on this server"}
        if not trace_id:
            return 400, {
                "error": "pass ?trace_id=<id>",
                "recent_trace_ids": self.flights.recent(),
            }
        rec = self.flights.get(trace_id)
        if rec is None:
            return 404, {
                "error": f"no flight recorded for trace_id {trace_id!r} "
                         f"(evicted, or never seen)",
                "recent_trace_ids": self.flights.recent(),
            }
        return 200, rec

    def threadz(self) -> dict:
        """`/threadz` payload: every live thread with its current stack
        (`sys._current_frames()`) — the FIRST diagnostic for a suspected
        deadlock or hang: two threads parked in `acquire` with crossed
        lock owners is a lock-order inversion caught red-handed (the
        static side of the same contract is af2lint's concurrency pass).
        Served by one of the HTTP pool's own threads, so even a fully
        wedged serving tier still answers."""
        frames = sys._current_frames()
        threads = []
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            stack = [ln.rstrip() for ln in
                     traceback.format_stack(frame)] if frame else []
            threads.append({
                "name": t.name,
                "ident": t.ident,
                "daemon": t.daemon,
                "alive": t.is_alive(),
                "stack": stack,
            })
        threads.sort(key=lambda e: str(e["name"]))
        return {"count": len(threads), "threads": threads}

    def profilez(self, duration_s):
        """(code, payload) for `/profilez?duration_s=` — start one
        bounded torch.profiler capture (409 busy / 429 rate-limited)."""
        if self.profiler is None:
            return 404, {"error": "no profiler wired on this server "
                                  "(serve.py arms it with --flight-dir)"}
        try:
            duration = float(duration_s) if duration_s is not None else 2.0
        except ValueError:
            return 400, {"error": f"duration_s must be a number, got "
                                  f"{duration_s!r}"}
        try:
            info = self.profiler.start(duration)
        except ProfileBusyError as e:
            return 409, {"error": str(e)}
        except ProfileRateLimitedError as e:
            return 429, {"error": str(e)}
        except ValueError as e:
            return 400, {"error": str(e)}
        return 200, {"status": "capturing", **info}

    # ------------------------------------------------------------ lifecycle

    def add_tick(self, fn: Callable[[], None]):
        """Register an extra periodic callable on the ticker thread."""
        self._extra_ticks.append(fn)

    def tick(self):
        """One ticker pass (tests call it directly; the thread loops it).
        Each hook is isolated: one raising hook must not starve the
        others or kill the ticker."""
        hooks: List[Callable[[], None]] = []
        if self.slo is not None:
            hooks.append(self.slo.evaluate)
        if self.recorder is not None:
            hooks.append(self.recorder.poll)
        if self._tracer.enabled:
            hooks.append(self._sync_dropped_spans)
        hooks.extend(self._extra_ticks)
        for fn in hooks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — see docstring
                traceback.print_exc()

    def _sync_dropped_spans(self):
        """Ticker hook: publish tracer retention overflow as the
        monotone `trace_spans_dropped_total` counter (increment-based so
        the counter only grows across tracer instances)."""
        dropped = self._tracer.dropped
        delta = dropped - self._dropped_seen
        if delta > 0:
            self._dropped_seen = dropped
            self.registry.counter(
                "trace_spans_dropped_total",
                help="spans lost to the tracer retention bound "
                     "(max_spans) — raise --trace-max-spans if nonzero"
            ).inc(delta)

    def start(self):
        if self._serve_thread is not None:
            return
        self._stop.clear()
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="af2-ops-http",
            daemon=True)
        self._serve_thread.start()

        def tick_loop():
            while not self._stop.wait(self._tick_interval_s):
                self.tick()

        self._tick_thread = threading.Thread(
            target=tick_loop, name="af2-ops-ticker", daemon=True)
        self._tick_thread.start()

    def stop(self, timeout: Optional[float] = 5.0):
        self._stop.set()
        if self.profiler is not None:
            # an in-flight /profilez capture must resolve before the
            # process can tear down (see ProfileCapturer.close)
            self.profiler.close()
        if self._tick_thread is not None:
            self._tick_thread.join(timeout)
            self._tick_thread = None
        if self._serve_thread is not None:
            # shutdown() blocks on an event only serve_forever() sets —
            # calling it on a built-but-never-started server deadlocks
            self._httpd.shutdown()
            self._serve_thread.join(timeout)
            self._serve_thread = None
        self._httpd.server_close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def ops_server_for_engine(engine, *, tracer: Tracer = NULL_TRACER,
                          slo=None, recorder: Optional[FlightRecorder] = None,
                          profiler: Optional[ProfileCapturer] = None,
                          host: str = "127.0.0.1", port: int = 0,
                          tick_interval_s: float = 1.0) -> OpsServer:
    """Wire an `OpsServer` over one `ServingEngine`: its metrics
    registry, `health()`, `stats()`, and its flight book (/explainz)."""
    return OpsServer(
        registry=engine.metrics.registry, health_fn=engine.health,
        stats_fn=engine.stats, tracer=tracer, slo=slo, recorder=recorder,
        flights=getattr(engine, "flights", None), profiler=profiler,
        host=host, port=port, tick_interval_s=tick_interval_s,
    )


def ops_server_for_fleet(fleet, *, tracer: Tracer = NULL_TRACER,
                         slo=None, recorder: Optional[FlightRecorder] = None,
                         profiler: Optional[ProfileCapturer] = None,
                         host: str = "127.0.0.1", port: int = 0,
                         tick_interval_s: float = 1.0) -> OpsServer:
    """Wire an `OpsServer` over a `ServingFleet`: the fleet registry
    (fleet_* families + SLO/flight metrics), `health()` (HealthMonitor +
    replica-up view), the full fleet `stats()`, its `backpressure()`
    (/statusz) and the fleet's flight book (/explainz). A profiler for a
    fleet on the card takes the card's lock (`ServingEngine.graph_lock`,
    one for every replica on the card), so /profilez never meets any
    replica's capture."""
    return OpsServer(
        registry=fleet.registry, health_fn=fleet.health,
        stats_fn=fleet.stats, tracer=tracer, slo=slo, recorder=recorder,
        backpressure_fn=getattr(fleet, "backpressure", None),
        flights=getattr(fleet, "flights", None), profiler=profiler,
        host=host, port=port, tick_interval_s=tick_interval_s,
    )
