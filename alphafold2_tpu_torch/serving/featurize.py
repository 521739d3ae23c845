"""CPU featurization tier: feature prep off the dispatch path.

The port's copy of alphafold2_tpu/serving/featurize.py: the same names, messages,
metric names and on-disk formats; Python and numpy only.

Every served request needs host-side feature preparation before a chip
can see it — strict tokenization, MSA stream normalization/validation,
bucket assignment. Until this module that work ran INLINE: on the
client's submit() thread (fleet front door) and again per replica on
the engine worker that also owns device dispatch, so a burst of long
MSAs could starve the thread whose only irreplaceable job is keeping
the accelerator fed. This is the ParaFold split (arxiv 2111.06340):
CPU featurization and accelerator inference are separately-provisioned
tiers, so serving throughput tracks chip count instead of
preprocessing.

  `featurize_request`   the PURE featurization function — one place for
                        tokenize + MSA checks + bucket choice, shared
                        by the pool workers and every inline caller
                        (engine submit validation), which is what keeps
                        the tiered and inline paths bit-exact: the tier
                        changes WHERE features are computed, never what.
  `FeaturizePool`       a separately-sized CPU worker pool with its own
                        bounded queue and backpressure (`QueueFullError`
                        with an honest drain-rate `retry_after_s`),
                        per-stage spans (`featurize.queue_wait` /
                        `featurize.run`) and metrics, sitting in FRONT
                        of the fleet's admission controller
                        (serving/fleet.py wires it): raw-sequence
                        requests enter here; pre-featurized
                        `FeatureBundle` submissions bypass the tier
                        entirely.

Failure model: a job whose featurization raises a `ServingError`
(invalid residues, oversize sequence, malformed MSA) keeps that sharp
semantic error; an unexpected exception becomes `FeaturizeError`. A
worker THREAD death (`reliability` injects one via
`kill_featurize_worker`; an organic bug would look identical) respawns
the worker and requeues the in-flight job at the FRONT of the queue —
bounded by `retry_limit`, past which the job fails with
`FeaturizeError` instead of ping-ponging through dying workers. Nothing
is ever silently lost: every submitted job reaches its `on_done`
callback exactly once.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np

from alphafold2_tpu_torch.constants import aa_to_tokens
from alphafold2_tpu_torch.serving.bucketing import BucketLadder
from alphafold2_tpu_torch.serving.errors import (
    EngineClosedError,
    FeaturizeError,
    InvalidSequenceError,
    QueueFullError,
    RequestTimeoutError,
    RetryBudgetExhaustedError,
    ServingError,
)
from alphafold2_tpu_torch.telemetry import NULL_TRACER, MetricRegistry


@dataclasses.dataclass
class FeatureBundle:
    """One request's prepared features (host numpy, pre-bucket-padding).

    Deterministic function of the raw inputs (`featurize_request`), so
    a bundle computed on a pool worker, inline on a submit thread, or
    by the client itself (the pre-featurized bypass) is interchangeable
    — the engine's cache keys and the fleet's bit-exactness pins see
    identical arrays either way. That determinism is also what lets the
    fleet artifact store (serving/artifact_store.py) persist bundles
    under a content hash and replay them across requeues, retries, and
    re-submissions: a stored bundle IS the recomputation, byte for
    byte, so the featurize tier is skipped entirely on a hit."""

    seq: str                      # normalized (stripped, uppercased)
    tokens: np.ndarray            # (L,) int32 strict tokenization
    msa: Optional[np.ndarray]     # (rows, L) int32, or None
    msa_mask: Optional[np.ndarray]  # (rows, L) bool, or None
    bucket: int                   # assigned ladder bucket

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])


def featurize_request(seq: str, msa=None, msa_mask=None, *,
                      ladder: BucketLadder,
                      msa_rows: int = 0) -> FeatureBundle:
    """The one featurization function: normalize + tokenize + validate +
    bucket. Raises the same typed ServingErrors the engine's inline
    validation always raised (InvalidSequenceError, RequestTooLongError
    via the ladder, plain ServingError for MSA-shape problems), so the
    tier's error surface is the inline path's error surface."""
    seq = seq.strip().upper()
    try:
        tokens = aa_to_tokens(seq, strict=True)
    except ValueError as e:
        raise InvalidSequenceError(str(e)) from None
    bucket = ladder.bucket_for(len(seq))

    msa_arr = None
    if msa is None and msa_mask is not None:
        raise ServingError("msa_mask given without msa")
    if msa is not None:
        if msa_rows == 0:
            raise ServingError(
                "engine is configured sequence-only (msa_rows=0); "
                "rebuild with ServingConfig(msa_rows=N) to serve MSAs"
            )
        msa_arr = np.asarray(msa, np.int32)
        if msa_arr.ndim != 2 or msa_arr.shape[1] != len(seq):
            raise ServingError(
                f"msa must be (rows, {len(seq)}) tokens, got {msa_arr.shape}"
            )
        if msa_arr.shape[0] > msa_rows:
            raise ServingError(
                f"msa has {msa_arr.shape[0]} rows; this engine serves at "
                f"most msa_rows={msa_rows} — subsample client-side or "
                f"deploy with a larger msa_rows"
            )
        if msa_mask is not None:
            msa_mask = np.asarray(msa_mask, bool)
            if msa_mask.shape != msa_arr.shape:
                raise ServingError(
                    f"msa_mask shape {msa_mask.shape} does not match msa "
                    f"shape {msa_arr.shape}"
                )
    return FeatureBundle(seq=seq, tokens=tokens, msa=msa_arr,
                         msa_mask=msa_mask, bucket=bucket)


@dataclasses.dataclass(frozen=True)
class FeaturizeConfig:
    """Featurize-tier sizing knobs (docs/SERVING.md "The featurization
    tier"). Sized independently of the replica pool — that independence
    is the tier's reason to exist."""

    workers: int = 2            # CPU featurization threads
    queue_capacity: int = 128   # bounded job queue (backpressure point)
    retry_limit: int = 1        # worker-death requeues per job
    min_retry_after_s: float = 0.05
    max_retry_after_s: float = 60.0
    ema_alpha: float = 0.2      # featurize-seconds EMA (retry_after basis)

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {self.queue_capacity}"
            )
        if self.retry_limit < 0:
            raise ValueError(
                f"retry_limit must be >= 0, got {self.retry_limit}"
            )


class _Job:
    __slots__ = ("seq", "msa", "msa_mask", "trace_id", "on_done",
                 "retries", "enqueued_at", "deadline")

    def __init__(self, seq, msa, msa_mask, trace_id, on_done,
                 deadline=None):
        self.seq = seq
        self.msa = msa
        self.msa_mask = msa_mask
        self.trace_id = trace_id
        self.on_done = on_done
        self.retries = 0
        self.enqueued_at = time.monotonic()
        self.deadline = deadline  # monotonic, or None


class FeaturizePool:
    """Bounded-queue CPU featurization worker pool (module docstring).

    Args:
      cfg: `FeaturizeConfig`.
      ladder / msa_rows: the serving tier's bucket ladder and MSA-row
        bound — featurization must agree with the engines it feeds.
      registry: metric sink (featurize_* families); None = fresh.
      tracer: span sink; `featurize.run` spans carry the job trace_id.
      fault_hook: chaos seam (`FaultInjector.featurize_hook()`): called
        with the pool's job index at the top of every job. A raised
        `WorkerKilled` kills THIS worker thread (respawned; job
        requeued); any other exception fails the job.
      incident_hook: optional `fn(kind, **attrs)` — worker deaths are
        reported as `featurize_worker_death` (flight-recorder seam).
    """

    def __init__(self, cfg: FeaturizeConfig, ladder: BucketLadder, *,
                 msa_rows: int = 0,
                 registry: Optional[MetricRegistry] = None,
                 tracer=None, fault_hook=None, incident_hook=None,
                 retry_budget=None):
        self.cfg = cfg
        self._ladder = ladder
        self._msa_rows = msa_rows
        self.registry = registry if registry is not None else MetricRegistry()
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._fault_hook = fault_hook
        self._incident_hook = incident_hook
        # optional shared reliability.RetryBudget: worker-death requeues
        # draw from the same fleet-wide bucket as failovers and hedges —
        # during a brownout the tier sheds instead of ping-ponging jobs
        # through dying workers
        self._retry_budget = retry_budget

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._jobs: "collections.deque[_Job]" = collections.deque()
        self._closed = False
        self._drain_on_stop = True
        self._job_counter = 0
        self._inflight = 0
        self._ema_s: Optional[float] = None
        self._worker_seq = 0
        self._workers = {}  # thread name -> Thread

        self._counts = {
            name: self.registry.counter(
                "featurize_requests_total",
                help="featurize-tier job outcomes", outcome=name)
            for name in ("submitted", "completed", "failed", "requeued")
        }
        self._seconds = self.registry.histogram(
            "featurize_seconds",
            help="per-job CPU featurization seconds, sliding window")
        self._depth_gauge = self.registry.gauge(
            "featurize_queue_depth", help="featurize-tier queue depth")
        self._deaths = self.registry.counter(
            "featurize_worker_deaths_total",
            help="featurize worker threads that died and were respawned")
        self._busy = self.registry.gauge(
            "featurize_busy_seconds_total",
            help="cumulative featurize worker busy seconds (the overlap "
                 "bench's CPU-side numerator)")
        self._expired = self.registry.counter(
            "featurize_expired_total",
            help="jobs dropped before featurizing because their fleet "
                 "deadline had already passed in the queue")

        for _ in range(cfg.workers):
            self._spawn_worker()

    # ----------------------------------------------------------------- API

    def submit(self, seq: str, msa=None, msa_mask=None, *,
               trace_id: str = "",
               deadline: Optional[float] = None,
               on_done: Callable[[Optional[FeatureBundle],
                                  Optional[BaseException]], None]):
        """Enqueue one featurization job; `on_done(bundle, exc)` runs
        exactly once, on a pool worker thread (or on the shutdown
        thread for jobs failed at close). Raises QueueFullError
        synchronously — featurize backpressure is explicit, like every
        other queue in the serving stack. `deadline` (monotonic, the
        fleet request's own) lets a worker drop a job whose deadline
        passed while it queued — dead-on-arrival work never burns a
        featurize slot (`featurize_expired_total`; the job finishes with
        RequestTimeoutError)."""
        with self._lock:
            if self._closed:
                raise EngineClosedError("featurize pool is shut down")
            if len(self._jobs) >= self.cfg.queue_capacity:
                raise QueueFullError(
                    f"featurize queue at capacity "
                    f"({self.cfg.queue_capacity}); retry with backoff",
                    retry_after_s=self._retry_after_locked(),
                )
            self._counts["submitted"].inc()
            self._jobs.append(_Job(seq, msa, msa_mask, trace_id, on_done,
                                   deadline))
            self._cond.notify()

    def depth(self) -> int:
        with self._lock:
            return len(self._jobs)

    def sample_gauges(self):
        """Ticker hook: publish the live queue depth so `/metrics`
        scrapes see featurize pressure between jobs."""
        self._depth_gauge.set(self.depth())

    def retry_after_s(self) -> float:
        with self._lock:
            return self._retry_after_locked()

    def _retry_after_locked(self) -> float:
        est = ((self._ema_s or 0.05) * max(1, len(self._jobs))
               / max(1, self.cfg.workers))
        return float(min(self.cfg.max_retry_after_s,
                         max(self.cfg.min_retry_after_s, est)))

    def stats(self) -> dict:
        with self._lock:
            depth, inflight = len(self._jobs), self._inflight
            workers = sum(1 for t in self._workers.values() if t.is_alive())
        return {
            "workers": workers,
            "configured_workers": self.cfg.workers,
            "queue_depth": depth,
            "queue_capacity": self.cfg.queue_capacity,
            "in_flight": inflight,
            "requests": {k: int(c.value) for k, c in self._counts.items()},
            "worker_deaths": int(self._deaths.value),
            "busy_seconds": float(self._busy.value),
            "seconds": self._seconds.snapshot(),
            "retry_after_s": self.retry_after_s(),
            "closed": self._closed,
        }

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the pool. drain=True featurizes what is queued first;
        drain=False (and anything left after a timed-out drain) fails
        with EngineClosedError through on_done — owners always hear the
        outcome. Idempotent."""
        with self._lock:
            self._closed = True
            self._drain_on_stop = drain
            self._cond.notify_all()
            workers = list(self._workers.values())
        for t in workers:
            t.join(timeout)
        leftovers = []
        with self._lock:
            while self._jobs:
                leftovers.append(self._jobs.popleft())
        for job in leftovers:
            self._finish(job, None, EngineClosedError(
                "featurize pool shut down before the job ran"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)
        return False

    # -------------------------------------------------------------- workers

    def _spawn_worker(self):
        with self._lock:
            if self._closed:
                return
            self._worker_seq += 1
            name = f"af2-featurize-{self._worker_seq}"
            t = threading.Thread(target=self._worker_loop, args=(name,),
                                 name=name, daemon=True)
            self._workers[name] = t
        t.start()

    def _worker_loop(self, name: str):
        while True:
            with self._lock:
                while not self._jobs and not self._closed:
                    self._cond.wait(0.1)
                # closed: drain=False leaves the queue for the shutdown
                # thread to fail; drain=True keeps claiming until empty
                if self._closed and (not self._drain_on_stop
                                     or not self._jobs):
                    return
                if not self._jobs:
                    continue  # spurious wake
                job = self._jobs.popleft()
                self._inflight += 1
                idx = self._job_counter
                self._job_counter += 1
            try:
                self._run_job(job, idx)
            except _WorkerDeath as death:
                self._on_worker_death(name, job, death)
                return  # the thread is "dead"; a replacement is running
            finally:
                with self._lock:
                    self._inflight -= 1

    def _run_job(self, job: _Job, idx: int):
        from alphafold2_tpu_torch.reliability.faults import WorkerKilled

        wait = time.monotonic() - job.enqueued_at
        if self._tracer.enabled:
            self._tracer.add("featurize.queue_wait", wait, cat="featurize",
                             trace_id=job.trace_id)
        if job.deadline is not None and time.monotonic() >= job.deadline:
            # the fleet deadline passed while the job queued: CPU spent
            # featurizing it would be pure waste — drop before the work,
            # with the same typed timeout the dispatch path would raise
            self._expired.inc()
            self._finish(job, None, RequestTimeoutError(
                f"deadline passed after {wait:.3f}s in the featurize "
                f"queue", retry_after_s=self.retry_after_s()))
            return
        t0 = time.monotonic()
        try:
            with self._tracer.span("featurize.run", cat="featurize",
                                   length=len(job.seq),
                                   trace_id=job.trace_id):
                if self._fault_hook is not None:
                    self._fault_hook(idx)
                bundle = featurize_request(
                    job.seq, job.msa, job.msa_mask,
                    ladder=self._ladder, msa_rows=self._msa_rows,
                )
        except WorkerKilled as e:
            # not a job outcome: the WORKER dies (re-raised past the
            # loop's claim bookkeeping); the job rides along for requeue
            raise _WorkerDeath(job, e)
        except ServingError as e:
            # semantic rejection: the request's own sharp error code
            self._finish(job, None, e)
            return
        except Exception as e:  # noqa: BLE001 — isolate to the job
            err = FeaturizeError(
                f"featurization failed: {type(e).__name__}: {e}")
            err.__cause__ = e
            self._finish(job, None, err)
            return
        finally:
            dt = time.monotonic() - t0
            self._busy.inc(dt)
            self._seconds.observe(dt)
            with self._lock:
                a = self.cfg.ema_alpha
                self._ema_s = (dt if self._ema_s is None
                               else a * dt + (1 - a) * self._ema_s)
        self._finish(job, bundle, None)

    def _on_worker_death(self, name: str, job: _Job, death: "_WorkerDeath"):
        """A worker thread died mid-job: respawn capacity first, then
        requeue the victim job at the FRONT of the queue (it has waited
        longest), bounded by retry_limit."""
        self._deaths.inc()
        if self._incident_hook is not None:
            try:
                self._incident_hook("featurize_worker_death", worker=name,
                                    retries=job.retries)
            except Exception:  # noqa: BLE001 — observability must never
                # take the tier down
                traceback.print_exc()
        with self._lock:
            self._workers.pop(name, None)
        self._spawn_worker()
        if job.retries >= self.cfg.retry_limit:
            err = FeaturizeError(
                f"featurize job lost to {job.retries + 1} worker "
                f"death(s) (retry_limit {self.cfg.retry_limit})")
            err.__cause__ = death.cause
            self._finish(job, None, err)
            return
        if (self._retry_budget is not None
                and not self._retry_budget.try_spend("featurize")):
            # fleet-wide brownout: the requeue would be amplification —
            # shed the job with honest backoff advice instead
            self._finish(job, None, RetryBudgetExhaustedError(
                "featurize requeue denied: fleet-wide retry budget "
                "exhausted",
                retry_after_s=self._retry_budget.retry_after_s()))
            return
        job.retries += 1
        self._counts["requeued"].inc()
        with self._lock:
            if self._closed and not self._drain_on_stop:
                pass  # fall through: fail below, outside the lock
            else:
                self._jobs.appendleft(job)
                self._cond.notify()
                return
        self._finish(job, None, EngineClosedError(
            "featurize pool shut down before the job ran"))

    def _finish(self, job: _Job, bundle, exc):
        if exc is None:
            self._counts["completed"].inc()
        else:
            self._counts["failed"].inc()
        try:
            job.on_done(bundle, exc)
        except Exception:  # noqa: BLE001 — a callback bug must not kill
            # the worker (the engine-request callback stance)
            traceback.print_exc()


class _WorkerDeath(BaseException):
    """Internal control-flow carrier: a WorkerKilled fault travels past
    the per-job guards to the worker loop with its job attached.
    BaseException so a generic `except Exception` job guard can never
    swallow a worker death into a mere job failure."""

    def __init__(self, job: _Job, cause: BaseException):
        super().__init__(str(cause))
        self.job = job
        self.cause = cause
