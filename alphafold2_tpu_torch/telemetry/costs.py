"""The serving cost plane (a copy of alphafold2_tpu/telemetry/costs.py,
which imports only the standard library and the registry).

`ExecutableCostLedger`: one cell per distinct executable an engine runs,
keyed (pool, bucket, schedule, backend_arm, weight_dtype). Each joins

  * analytic: the matmul FLOPs of one request's forward at the bucket
    (`utils/flops.py model_fwd_flops`);
  * priced: the executable's resident bytes (the served weight tree, f32
    or int8, plus the residual streams and logits at the bucket,
    `serving/sp_arm.py schedule_residency`);
  * measured: EMAs of a batch's device seconds and real requests, capture
    time excluded (on the card the device seconds come from CUDA events
    around the replays).

and derives `chip_seconds_per_request`, the achieved FLOP/s and, under a
declared peak only, MFU.

`ServeGoodputLedger`: each replica-second classified as execute / compile
/ probe / drain / requeue / idle, idle being the remainder, so the causes
sum to the replica's wall clock by construction. Accounting is by deltas
(`add`) from whichever thread measured the interval.

`FlightBook`: a bounded ring of per-request flight records (trace_id,
cell, every lifecycle event, the terminal outcome), looked up by trace id
at the ops plane's `/explainz`.

Every method here reads and writes host state only.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

from alphafold2_tpu_torch.telemetry.registry import (
    NULL_REGISTRY,
    MetricRegistry,
)

# --- the executable cost ledger ----------------------------------------------

#: cell key: one row per distinct serving executable the fleet runs
CellKey = Tuple[str, int, str, str, str]  # (pool, bucket, schedule, arm, dtype)


@dataclasses.dataclass
class CostCell:
    """One (pool, bucket, schedule, backend_arm, weight_dtype) row."""

    pool: str
    bucket: int
    schedule: str          # dense / sp_msa / sp_seq (the SP plan's choice)
    backend_arm: str       # resolved kernel arm (ops/dispatch.py)
    weight_dtype: str      # f32 / int8 (the precision arm)
    # analytic + priced columns (known at engine build, chip-free):
    forward_flops: float = 0.0     # matmul FLOPs of ONE request's forward
    residency_bytes: int = 0       # per-chip priced residency (sp_arm)
    chips: int = 1                 # devices one executable occupies
    max_batch: int = 1             # the executable's batch dimension
    # measured columns (EMA over dispatched batches, compile excluded):
    batches: int = 0
    requests: int = 0
    device_seconds: float = 0.0    # cumulative execute wall (x1, not xchips)
    ema_batch_seconds: Optional[float] = None
    ema_batch_requests: Optional[float] = None

    @property
    def key(self) -> CellKey:
        return (self.pool, self.bucket, self.schedule, self.backend_arm,
                self.weight_dtype)

    # ---------------------------------------------------------- derived

    def chip_seconds_per_request(self) -> Optional[float]:
        """The headline number: chip-seconds one request of this cell
        costs (EMA batch device-seconds x chips / EMA batch requests).
        None until a batch has been measured — an unmeasured cell must
        never read as a free one."""
        if not self.ema_batch_seconds or not self.ema_batch_requests:
            return None
        return self.ema_batch_seconds * self.chips / self.ema_batch_requests

    def flops_per_sec_per_chip(self) -> Optional[float]:
        """Achieved analytic FLOP/s per chip while this executable runs."""
        if not self.ema_batch_seconds or not self.ema_batch_requests:
            return None
        return (self.ema_batch_requests * self.forward_flops
                / (self.ema_batch_seconds * self.chips))

    def mfu(self, peak_flops: Optional[float]) -> Optional[float]:
        achieved = self.flops_per_sec_per_chip()
        if achieved is None or not peak_flops:
            return None
        return achieved / peak_flops

    def as_dict(self, peak_flops: Optional[float] = None) -> dict:
        out = {
            "pool": self.pool,
            "bucket": self.bucket,
            "schedule": self.schedule,
            "backend_arm": self.backend_arm,
            "weight_dtype": self.weight_dtype,
            "forward_flops": self.forward_flops,
            "residency_bytes": int(self.residency_bytes),
            "chips": self.chips,
            "max_batch": self.max_batch,
            "batches": self.batches,
            "requests": self.requests,
            "device_seconds": self.device_seconds,
            "ema_batch_seconds": self.ema_batch_seconds,
            "ema_batch_requests": self.ema_batch_requests,
            "chip_seconds_per_request": self.chip_seconds_per_request(),
            "flops_per_sec_per_chip": self.flops_per_sec_per_chip(),
        }
        m = self.mfu(peak_flops)
        if m is not None:
            out["mfu"] = m
        return out


class ExecutableCostLedger:
    """Per-executable chip-cost rows (module docstring).

    Shared fleet-wide: every replica of a pool observes into the SAME
    cell, so the EMA is the pool's price, not one replica's. Writers are
    the engine worker threads (`observe_batch`); readers are the ops
    plane (`publish`/`snapshot`) and the fleet's headroom math
    (`pool_rate_rps`) — the lock covers that split.
    """

    _EMA_ALPHA = 0.25

    def __init__(self, registry: MetricRegistry = NULL_REGISTRY):
        self.registry = registry
        self._lock = threading.Lock()
        self._cells: Dict[CellKey, CostCell] = {}
        self._peak: Optional[float] = None
        self._published_requests: Dict[CellKey, int] = {}

    def set_peak(self, peak_flops: Optional[float]):
        """Declare the per-chip peak FLOP/s for the serving-MFU column
        (None = publish achieved FLOP/s only, the training ledger's
        honest-absence contract)."""
        with self._lock:
            self._peak = float(peak_flops) if peak_flops else None

    def register_cell(self, *, pool: str, bucket: int, schedule: str,
                      backend_arm: str, weight_dtype: str,
                      forward_flops: float, residency_bytes: int,
                      chips: int = 1, max_batch: int = 1) -> CellKey:
        """Create (or refresh the analytic columns of) one cell —
        idempotent: N replicas of a pool register the same cell once
        each and share its measured columns."""
        key = (str(pool), int(bucket), str(schedule), str(backend_arm),
               str(weight_dtype))
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = CostCell(pool=key[0], bucket=key[1], schedule=key[2],
                                backend_arm=key[3], weight_dtype=key[4])
                self._cells[key] = cell
            cell.forward_flops = float(forward_flops)
            cell.residency_bytes = int(residency_bytes)
            cell.chips = max(1, int(chips))
            cell.max_batch = max(1, int(max_batch))
        return key

    def observe_batch(self, key: CellKey, *, device_seconds: float,
                      requests: int):
        """One dispatched batch of `requests` real requests that held the
        device for `device_seconds` (compile already excluded by the
        engine). Unknown keys auto-register a bare cell (a custom
        engine_factory that skipped registration must not lose its
        measurements)."""
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = CostCell(pool=key[0], bucket=key[1], schedule=key[2],
                                backend_arm=key[3], weight_dtype=key[4])
                self._cells[key] = cell
            cell.batches += 1
            cell.requests += int(requests)
            cell.device_seconds += float(device_seconds)
            a = self._EMA_ALPHA
            cell.ema_batch_seconds = (
                float(device_seconds) if cell.ema_batch_seconds is None
                else a * float(device_seconds)
                + (1 - a) * cell.ema_batch_seconds)
            cell.ema_batch_requests = (
                float(requests) if cell.ema_batch_requests is None
                else a * float(requests) + (1 - a) * cell.ema_batch_requests)

    # ------------------------------------------------------------- reading

    def cells(self) -> list:
        with self._lock:
            peak = self._peak
            rows = [dataclasses.replace(c) for c in self._cells.values()]
        return [c.as_dict(peak) for c in sorted(
            rows, key=lambda c: (c.pool, c.bucket, c.schedule))]

    def pool_rate_rps(self, pool: str) -> Optional[float]:
        """Per-REPLICA service rate model for one pool: requests served
        per device-busy second, over the pool's cumulative measured
        columns (an intensive quantity — N replicas contributing to one
        cell do not inflate it). None until something was measured: the
        headroom gauge must stay absent rather than divide by a guess."""
        with self._lock:
            secs = sum(c.device_seconds for c in self._cells.values()
                       if c.pool == pool)
            reqs = sum(c.requests for c in self._cells.values()
                       if c.pool == pool)
        if secs <= 0 or reqs <= 0:
            return None
        return reqs / secs

    def fleet_chip_seconds_total(self) -> float:
        """Cumulative CHIP-seconds spent executing, summed over every
        cell: `device_seconds` is x1 wall per batch, so each cell scales
        by its chip count. An extensive quantity — the numerator of the
        fleet-amortized `fleet_chip_seconds_per_request` gauge, which is
        what an artifact-store/coalescing tier actually
        lowers: cache hits complete requests without adding here."""
        with self._lock:
            return sum(c.device_seconds * c.chips
                       for c in self._cells.values())

    def snapshot(self) -> dict:
        with self._lock:
            peak = self._peak
        return {"peak_flops_per_chip": peak, "cells": self.cells()}

    def publish(self):
        """Write every cell into the registry as labeled gauges (the
        `/metrics` view of the ledger): the analytic columns always, the
        measured/derived columns once a batch was observed. Volume rides
        a real counter (delta-published so it only ever grows)."""
        reg = self.registry
        with self._lock:
            peak = self._peak
            rows = [dataclasses.replace(c) for c in self._cells.values()]
        for cell in rows:
            labels = {
                "pool": cell.pool, "bucket": str(cell.bucket),
                "schedule": cell.schedule, "backend_arm": cell.backend_arm,
                "weight_dtype": cell.weight_dtype,
            }
            reg.gauge(
                "serve_forward_flops",
                help="analytic matmul FLOPs of one request's serving "
                     "forward at this cell's bucket (utils/flops.py)",
                **labels).set(cell.forward_flops)
            reg.gauge(
                "serve_residency_bytes",
                help="per-chip priced residency of this cell's executable "
                     "(serving/sp_arm.py eval_shape pricing)",
                **labels).set(cell.residency_bytes)
            with self._lock:
                seen = self._published_requests.get(cell.key, 0)
                delta = cell.requests - seen
                self._published_requests[cell.key] = cell.requests
            if delta > 0:
                reg.counter(
                    "serve_cell_requests_total",
                    help="requests served per cost-ledger cell",
                    **labels).inc(delta)
            csr = cell.chip_seconds_per_request()
            if csr is None:
                continue
            reg.gauge(
                "serve_chip_seconds_per_request",
                help="EMA chip-seconds one request of this cell costs "
                     "(batch device-seconds x chips / batch requests; "
                     "compile excluded)",
                **labels).set(csr)
            fps = cell.flops_per_sec_per_chip()
            if fps is not None:
                reg.gauge(
                    "serve_model_flops_per_sec",
                    help="achieved analytic FLOP/s per chip while this "
                         "cell's executable runs",
                    **labels).set(fps)
            m = cell.mfu(peak)
            if m is not None:
                reg.gauge(
                    "serve_mfu",
                    help="serving MFU: achieved / declared peak FLOP/s "
                         "per chip (--peak-tflops)",
                    **labels).set(m)


# --- the serving goodput ledger ----------------------------------------------

#: replica-second taxonomy. "idle" is never added directly — it is the
#: explicit remainder, so the causes sum to the replica's wall clock by
#: construction (cross-thread accounting overlap is bounded and pinned
#: <=1% by the chaos test; see module docstring).
SERVE_CAUSES = (
    "execute",   # successful device dispatch (the productive bucket)
    "compile",   # AOT executable compiles (build precompile + first call)
    "probe",     # health heartbeat round trips (minus their execute share)
    "drain",     # engine teardown during a health/retirement drain
    "requeue",   # device time burned by FAILED dispatches (failover bill)
    "idle",      # everything else: waiting for traffic
)

SERVE_GOODPUT_CAUSES = ("execute",)


class _ReplicaAccount:
    __slots__ = ("pool", "t0", "buckets")

    def __init__(self, pool: str, t0: float):
        self.pool = pool
        self.t0 = t0
        self.buckets: Dict[str, float] = {}


class ServeGoodputLedger:
    """Per-replica wall-clock economy for the serving tier (module
    docstring). Delta-based: accounters call `add(replica, cause,
    seconds)` from whatever thread measured the interval; `totals`
    derives idle as the remainder."""

    def __init__(self, registry: MetricRegistry = NULL_REGISTRY, *,
                 clock=time.monotonic):
        self.registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: Dict[str, _ReplicaAccount] = {}

    def register(self, replica: str, pool: str = ""):
        """Start (or re-pool) a replica's clock. Idempotent: an engine
        restart behind the same replica name keeps the original wall
        origin — the drain gap shows up as drain + idle, not as a
        rewound clock."""
        if not replica:
            return
        with self._lock:
            acct = self._replicas.get(replica)
            if acct is None:
                self._replicas[replica] = _ReplicaAccount(pool, self._clock())
            elif pool:
                acct.pool = pool

    def add(self, replica: str, cause: str, seconds: float):
        if cause not in SERVE_CAUSES or cause == "idle":
            raise ValueError(
                f"unknown serve-goodput cause {cause!r}; expected one of "
                f"{SERVE_CAUSES[:-1]}")
        if not replica or seconds <= 0:
            return
        with self._lock:
            acct = self._replicas.get(replica)
            if acct is None:
                acct = _ReplicaAccount("", self._clock())
                self._replicas[replica] = acct
            acct.buckets[cause] = acct.buckets.get(cause, 0.0) + seconds

    def accounted(self, replica: str) -> float:
        with self._lock:
            acct = self._replicas.get(replica)
            return sum(acct.buckets.values()) if acct else 0.0

    @contextlib.contextmanager
    def probe_span(self, replica: str):
        """Account a health probe's round trip as "probe" — MINUS
        whatever the replica's engine accounted during it (the probe's
        own execute/compile runs on the worker thread and is already
        counted there; double-counting it would break sums-to-wall on
        every reinstatement probe, whose first dispatch compiles)."""
        t0 = self._clock()
        before = self.accounted(replica)
        try:
            yield
        finally:
            wall = self._clock() - t0
            inner = self.accounted(replica) - before
            self.add(replica, "probe", max(0.0, wall - inner))

    # ------------------------------------------------------------- reading

    def wall(self, replica: str) -> float:
        with self._lock:
            acct = self._replicas.get(replica)
            return self._clock() - acct.t0 if acct else 0.0

    def totals(self, replica: str) -> Dict[str, float]:
        """{cause: seconds} including the idle remainder (clamped at 0 —
        accounting overlap surfaces as sum > wall, which the chaos test
        bounds at 1%)."""
        with self._lock:
            acct = self._replicas.get(replica)
            if acct is None:
                return {}
            out = dict(acct.buckets)
            wall = self._clock() - acct.t0
        for cause in SERVE_CAUSES:
            out.setdefault(cause, 0.0)
        out["idle"] = max(0.0, wall - sum(
            v for k, v in out.items() if k != "idle"))
        return out

    def _replica_snapshot(self, replica: str) -> dict:
        # wall_s is the BUCKET SUM (the training ledger's snapshot
        # convention: every field of one snapshot derives from one
        # totals read, so ratio denominators are internally exact) —
        # an invariant CHECK must compare totals() against the live
        # wall() instead, or it compares a sum to itself
        totals = self.totals(replica)
        wall = sum(totals.values())
        with self._lock:
            pool = self._replicas[replica].pool
        productive = sum(totals.get(b, 0.0) for b in SERVE_GOODPUT_CAUSES)
        return {
            "pool": pool,
            "wall_s": wall,
            "buckets": totals,
            "goodput_ratio": productive / wall if wall > 0 else 0.0,
            "badput_s": {k: v for k, v in totals.items()
                         if k not in SERVE_GOODPUT_CAUSES},
        }

    def snapshot(self) -> dict:
        """JSON-ready dump: per replica and aggregated per pool."""
        with self._lock:
            names = list(self._replicas)
        replicas = {name: self._replica_snapshot(name) for name in names}
        pools: Dict[str, dict] = {}
        for snap in replicas.values():
            agg = pools.setdefault(
                snap["pool"] or "", {"wall_s": 0.0, "execute_s": 0.0})
            agg["wall_s"] += snap["wall_s"]
            agg["execute_s"] += snap["buckets"].get("execute", 0.0)
        for agg in pools.values():
            agg["goodput_ratio"] = (
                agg["execute_s"] / agg["wall_s"] if agg["wall_s"] > 0
                else 0.0)
        return {"replicas": replicas, "pools": pools}

    def publish(self):
        """Registry gauges: `serve_goodput_ratio{replica,pool}` +
        `serve_badput_seconds{replica,pool,cause}` +
        `serve_wall_seconds{replica,pool}` per replica, and the pool
        aggregate `serve_pool_goodput_ratio{pool}`."""
        reg = self.registry
        snap = self.snapshot()
        for name, rs in snap["replicas"].items():
            labels = {"replica": name, "pool": rs["pool"]}
            reg.gauge(
                "serve_wall_seconds",
                help="replica wall-clock seconds (serve-goodput ledger "
                     "lifetime)", **labels).set(rs["wall_s"])
            reg.gauge(
                "serve_goodput_ratio",
                help="productive execute seconds / replica wall seconds",
                **labels).set(rs["goodput_ratio"])
            for cause, s in rs["badput_s"].items():
                reg.gauge(
                    "serve_badput_seconds",
                    help="non-productive replica wall seconds by cause",
                    cause=cause, **labels).set(s)
        for pool, agg in snap["pools"].items():
            reg.gauge(
                "serve_pool_goodput_ratio",
                help="pool-aggregate execute seconds / wall seconds",
                pool=pool).set(agg["goodput_ratio"])


# --- exemplar flight records --------------------------------------------------


class FlightBook:
    """Bounded ring of per-request flight records, queryable by trace_id
    (the `/explainz` backing store; module docstring).

    A record is born at the serving front door (`begin`), accumulates
    lifecycle `events` (admitted, dispatch, requeue, ...), and is sealed
    with a terminal `finish` (outcome + provenance). Capacity evicts the
    OLDEST record wholesale — a truncated ring never shows a partial
    flight as a complete one. All methods are cheap (dict ops under one
    lock) and never raise on unknown ids: an evicted record's late event
    is dropped, not an error — observability must not outlive its
    budget."""

    def __init__(self, capacity: int = 512, *, clock=time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._records: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict())
        self._evicted = 0

    def begin(self, trace_id: str, **fields):
        if not trace_id:
            return
        with self._lock:
            rec = self._records.get(trace_id)
            if rec is not None:
                # a replayed id (client retry with the same trace_id):
                # keep one record, note the re-entry as an event
                rec["events"].append(
                    {"ts": self._clock(), "event": "resubmitted", **fields})
                return
            self._records[trace_id] = {
                "trace_id": trace_id,
                "ts": self._clock(),
                "outcome": None,
                "events": [{"ts": self._clock(), "event": "submitted",
                            **fields}],
                **fields,
            }
            while len(self._records) > self.capacity:
                self._records.popitem(last=False)
                self._evicted += 1

    def note(self, trace_id: str, event: str, **attrs):
        with self._lock:
            rec = self._records.get(trace_id)
            if rec is None:
                return
            rec["events"].append(
                {"ts": self._clock(), "event": event, **attrs})

    def finish(self, trace_id: str, outcome: str, **fields):
        with self._lock:
            rec = self._records.get(trace_id)
            if rec is None:
                return
            rec["outcome"] = outcome
            rec.update(fields)
            rec["events"].append(
                {"ts": self._clock(), "event": "terminal",
                 "outcome": outcome})

    # ------------------------------------------------------------- reading

    def get(self, trace_id: str) -> Optional[dict]:
        """Deep-enough copy of one flight (events list copied — a reader
        must never race the resolver's append)."""
        with self._lock:
            rec = self._records.get(trace_id)
            if rec is None:
                return None
            out = dict(rec)
            out["events"] = [dict(e) for e in rec["events"]]
            return out

    def recent(self, n: int = 20) -> list:
        """The most recent trace_ids (newest last) — `/explainz` without
        a trace_id lists these so an operator can find a flight to
        explain."""
        with self._lock:
            ids = list(self._records)
        return ids[-max(0, n):]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "records": len(self._records),
                "capacity": self.capacity,
                "evicted": self._evicted,
            }
