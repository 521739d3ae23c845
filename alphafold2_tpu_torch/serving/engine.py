"""Request-level inference engine for one replica (counterpart of
alphafold2_tpu/serving/engine.py `ServingEngine`).

  * **Executable table.** Requests are padded onto a length-bucket ladder
    (`serving/bucketing.py`) and each (bucket, batch shape) gets one
    executable, built once (`serving/executable.py`): on the card a
    captured pair of CUDA graphs of the whole request (the JAX engine's
    AOT executable), on the CPU the eager `predict_structure`. An
    arbitrary stream of lengths builds at most len(buckets) x len(batch
    shapes) of them (`compile_count` counts distinct buckets).
  * **Micro-batching.** A bounded queue feeds one worker thread that
    assembles same-bucket batches: a batch leaves when it fills
    (`max_batch`) or its oldest request has waited `max_wait_s`. With the
    batch-shape ladder (`batch_ladder`) a partial batch runs at the
    smallest power-of-two rung that holds it. Queue-full is an explicit
    `QueueFullError`, deadlines expire scheduler-side, and shutdown drains
    or fails pending work.
  * **Result cache.** An LRU keyed by (sequence, MSA, config tag); a hit
    completes at submit(). Identical requests in flight share one future.
  * **Failure isolation.** A failed multi-request batch is retried one
    request at a time, so a poison request fails alone. A consecutive-
    failure circuit breaker (`breaker_threshold`) fast-rejects while open,
    and a hung-batch watchdog (`watchdog_timeout_s`) fails a wedged batch
    instead of the worker.

  * **Telemetry** (the JAX engine's seams, `telemetry/`). A `tracer`
    records each request's lifecycle as spans: `serving.enqueue` (client
    thread), `serving.queue_wait`, `serving.batch`, `serving_capture` (a
    (bucket, rung)'s first batch), `serving.execute` and `serving.respond`,
    each with the request's `trace_id` (a batch's spans: `trace_ids`).
    A cost ledger holds one cell a (bucket, rung): the forward's analytic
    FLOPs, the executable's priced resident bytes, and EMAs of a batch's
    seconds and requests. A serve-goodput ledger classifies the replica's
    wall clock (execute, compile, requeue, idle); a `FlightBook` keeps each
    request's flight for `/explainz`; `incident_hook` hears breaker opens
    and watchdog fires. A batch's seconds are its device time, two CUDA
    events around the replays (recorded under the graph pool's lock), when
    a live tracer or a cost ledger is passed in; else, and on the CPU, its
    host window less any capture. With nothing passed in the engine makes
    no CUDA call the untelemetered engine did not make: its spans are the
    no-op tracer's, and its host adds, per dispatched batch, one read of
    the capture tracker (a lock), one goodput and one cost-ledger update
    (a lock and a few dict writes each) into private ledgers, which
    `stats()` reports.

  * **Trunk-depth early exit** (`early_exit_depths`, `early_exit_kl`;
    serving/pipeline.py `staged_trunk_logits`): a sample's distogram
    freezes at the first checkpoint depth whose KL from the previous one
    is small enough. On the card the executable replays one graph a stage
    and skips the rest once every sample has frozen (one host read a
    stage). A batch's seconds are apportioned to per-exit-depth cost cells
    (`dense@exit{d}`) in proportion to each depth's forward FLOPs; the
    cells' sum stays the batch's seconds.

  * **The fleet's seams** (serving/fleet.py). `fault_hook(index, bucket)`
    runs at the top of every dispatch, before the batch's executable and
    outside any capture (`reliability/faults.py` serving and replica
    hooks); `pool_name` labels the cost cells and the goodput account; a
    fleet passes its shared `cost_ledger` and `goodput` (each replica's
    `stats()` then reports the pool-wide ledgers, where JAX's omits them).
    `ServingRequest.add_done_callback` and
    `peek` are the fleet's completion seam, `submit(features=)` its
    pre-featurized path.

  * **The sequence-parallel arm** (`sp_shards`, `sp_hbm_gb`,
    `sp_schedules`; serving/sp_arm.py): each bucket's trunk takes the
    schedule the build-time plan gives it ("dense", "sp_msa" or "sp_seq")
    over a mesh of `sp_shards` shards (`sp_devices`, default
    `build_sp_mesh`'s: that many distinct cards). Every shard must lie on
    the engine's device: on the card an SP bucket's executable captures
    the sharded forward (each shard's B1f passes, and under "sp_seq" the
    ring's P^2 B3 hops a layer with their merges) into its graph one, and
    a mesh over distinct cards is refused at build, naming ROADMAP A13. A
    bucket's cost cell is priced per shard by its schedule and billed by
    the cards its mesh occupies (`chips`), not by the shard count.
    `model_apply_fn` (a forward override for every bucket, as in
    `predict_structure`) and the SP arm exclude each other.

  * **Pipelined dispatch** (`pipeline_depth` > 0; the JAX engine's
    settle thread, docs/SERVING.md "The dispatch pipeline"): the worker
    assembles and enqueues batches, an `af2-settle-{replica}` thread
    realizes them in order, bills them and resolves their requests, and
    at most `pipeline_depth` batches sit enqueued but unsettled. On the
    card the enqueue is `CapturedExecutable.enqueue` (the copies in and
    out through pinned host buffers, an event after them) and the wait
    `PendingCall.wait`, which polls that event under the card's capture
    lock, which every capture holds, and releases it between polls
    (serving/executable.py). The
    hung-batch watchdog guards both halves: the dispatch half, which on
    the card still waits for its graph one at the eager `eigh` and at
    each early-exit stage, and the settle half. Goodput and the drain EMA
    bill each batch its enqueue -> realized window clamped against the
    batches realized before it (`_billed_window`), so overlapped seconds
    are billed once; the cost cells keep the events' device seconds. A
    batch that fails at settle splits into singles on the settle thread,
    which dispatch synchronously and take the next device-call indices
    there, interleaved with the worker's: the random init's seeds of the
    batches after a settle-side split then depend on that interleaving.

The random MDS init (`mds_init="random"`): device call i (counted from 1)
starts MDS from the draw of a generator seeded fold_in(seed, i)
(`utils/rng.py`), the JAX engine's `fold_in(PRNGKey(seed), batch_idx)`:
on the card the engine's generator, registered with every executable's
graph, is reseeded and replayed in one step under the pool's lock; on the
CPU a CPU generator draws it.

Thread model: clients call `submit()` / `result()` from any thread; every
device call happens on the worker thread (with pipelined dispatch a
settle-side split's singles on the settle thread; past a watchdog
timeout, on the abandoned thread it left), one at a time under the card's
lock (`serving/executable.py device_lock`), which every engine on the
card shares: a call holds it from its first copy in to its outputs on the
host (a pipelined call for its device work; its settle takes the
card's capture lock for each poll of its event and the read of its
outputs), the construction holds it for its
device work, and `release_graphs` (after `shutdown`) frees the graphs
under it. A capture runs in CUDA's
global capture mode, where no other thread of the process may make an
unsafe CUDA call;
under that lock no engine of the process does, so replicas on one card
may capture while others serve. Other code of the process that uses the
card while an engine captures must take `graph_lock` too. `health()`,
`stats()`, `sample_gauges()` and the telemetry objects read host state
only, so the ops plane's threads may call them during a capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import traceback
from typing import Optional, Tuple

import numpy as np
import torch

from alphafold2_tpu_torch.constants import PAD_TOKEN_ID
from alphafold2_tpu_torch.device import check_params_device, resolve_device
from alphafold2_tpu_torch.ops.dispatch import OPS as DISPATCH_OPS
from alphafold2_tpu_torch.ops.dispatch import resolve as dispatch_resolve
from alphafold2_tpu_torch.reliability.breaker import CircuitBreaker
from alphafold2_tpu_torch.serving.bucketing import (
    DEFAULT_BUCKETS,
    BucketLadder,
    batch_shape_ladder,
    pad_batch,
)
from alphafold2_tpu_torch.serving.cache import ResultCache, request_key
from alphafold2_tpu_torch.serving.errors import (
    CircuitOpenError,
    EngineClosedError,
    HungBatchError,
    PredictionError,
    QueueFullError,
    RequestTimeoutError,
    ServingError,
)
from alphafold2_tpu_torch.serving.executable import (
    CapturedExecutable,
    EagerExecutable,
    GraphPool,
    PendingCall,
)
from alphafold2_tpu_torch.serving.featurize import featurize_request
from alphafold2_tpu_torch.serving.metrics import ServingMetrics
from alphafold2_tpu_torch.serving import sp_arm
from alphafold2_tpu_torch.serving.quant_residency import resident_params
from alphafold2_tpu_torch.telemetry.costs import ExecutableCostLedger, ServeGoodputLedger
from alphafold2_tpu_torch.telemetry.trace import NULL_TRACER, new_trace_id
from alphafold2_tpu_torch.utils.flops import model_fwd_flops
from alphafold2_tpu_torch.utils.rng import Streams, fold_in


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Scheduler and cache knobs (model hyperparameters live in
    `Alphafold2Config`); the JAX engine's fields."""

    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    max_batch: int = 4           # the top batch shape
    max_queue: int = 64          # bounded request queue (backpressure)
    max_wait_s: float = 0.05     # batch-assembly deadline for partial batches
    request_timeout_s: Optional[float] = 60.0  # default per-request deadline
    cache_capacity: int = 256    # result LRU entries (0 disables)
    msa_rows: int = 0            # >0: executables take a fixed-row MSA stream
    mds_iters: int = 32
    mds_init: str = "classical"
    seed: int = 0                # seeds the random MDS init, with the call index
    precompile: bool = False     # build every executable at startup
    params_tag: str = ""         # checkpoint fingerprint for cache keys
    breaker_threshold: int = 0   # consecutive dispatch failures that open
    #                              the circuit (0 = no breaker)
    breaker_reset_s: float = 30.0  # open -> half-open probe window
    breaker_jitter: float = 0.0  # fraction of reset_s added as seeded spread a
    #                              window, so a fleet's breakers do not
    #                              re-probe in lockstep (0 = fixed window)
    breaker_jitter_seed: int = 0  # per-replica seed of that spread (not in the
    #                              config tag)
    watchdog_timeout_s: Optional[float] = None  # a dispatch past this fails
    #                              its batch instead of wedging the worker
    batch_ladder: bool = False   # power-of-two batch shapes up to max_batch
    sp_shards: int = 0           # >= 2: the SP arm over this many shards
    sp_hbm_gb: float = 16.0      # per-shard budget the schedule heuristic prices
    #                              buckets against (an estimate, not an allocator)
    sp_schedules: Tuple[Tuple[int, str], ...] = ()  # ((bucket, schedule), ...)
    #                              overrides, winning over the heuristic
    # trunk-depth early exit: checkpoint depths (sorted, deduped; >= 2, the
    # first the delta-KL baseline that never exits) and the masked-mean
    # KL(prev || cur) at or under which a sample freezes
    early_exit_depths: Tuple[int, ...] = ()
    early_exit_kl: float = 0.0
    # pipelined dispatch: > 0 splits the scheduler into the worker, which
    # assembles and enqueues, and a settle thread, with at most this many
    # batches enqueued but unsettled (0: the synchronous path)
    pipeline_depth: int = 0

    def __post_init__(self):
        # the SP knobs first, with the JAX engine's messages
        if self.sp_shards < 0 or self.sp_shards == 1:
            raise ValueError(f"sp_shards must be 0 (dense) or >= 2, got {self.sp_shards}")
        if self.sp_hbm_gb <= 0:
            raise ValueError(f"sp_hbm_gb must be positive, got {self.sp_hbm_gb}")
        object.__setattr__(self, "sp_schedules",
                           tuple(sorted((int(b), str(s)) for b, s in self.sp_schedules)))
        for _bucket, sched in self.sp_schedules:
            if sched not in sp_arm.SP_SCHEDULES:
                raise ValueError(f"sp_schedules entry {sched!r} is not a schedule; "
                                 f"known: {sp_arm.SP_SCHEDULES}")
        if self.sp_schedules and not self.sp_shards:
            raise ValueError("sp_schedules given but sp_shards=0 — per-bucket schedule "
                             "overrides only apply to the SP arm")
        object.__setattr__(self, "early_exit_depths",
                           tuple(sorted({int(d) for d in self.early_exit_depths})))
        if self.early_exit_depths:
            if self.early_exit_depths[0] < 1:
                raise ValueError(f"early_exit_depths must be >= 1, got "
                                 f"{self.early_exit_depths}")
            if len(self.early_exit_depths) < 2:
                raise ValueError("early_exit_depths needs >= 2 checkpoints: the first is "
                                 "the delta-KL baseline and can never exit")
            if self.early_exit_kl <= 0:
                raise ValueError(f"early_exit_kl must be > 0 when early_exit_depths is "
                                 f"set, got {self.early_exit_kl}")
            if self.sp_shards:
                raise ValueError("early exit segments the dense sequential trunk and "
                                 "cannot compose with the SP arm (sp_shards > 0)")
        elif self.early_exit_kl:
            raise ValueError("early_exit_kl set without early_exit_depths — the exit gate "
                             "has no checkpoints to fire at")
        if self.pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got {self.pipeline_depth}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")
        if self.breaker_threshold < 0:
            raise ValueError(f"breaker_threshold must be >= 0, got {self.breaker_threshold}")
        if self.breaker_jitter < 0:
            raise ValueError(f"breaker_jitter must be >= 0, got {self.breaker_jitter}")
        if self.watchdog_timeout_s is not None and self.watchdog_timeout_s <= 0:
            raise ValueError(f"watchdog_timeout_s must be positive or None, got "
                             f"{self.watchdog_timeout_s}")
        if self.mds_init not in ("classical", "random"):
            raise ValueError(f"unknown mds_init {self.mds_init!r}")
        if self.mds_init == "random" and self.cache_capacity:
            # a random init draws anew for every batch, so identical
            # requests in different batches give different structures: the
            # cache's equal key == identical computation would not hold
            raise ValueError(
                "mds_init='random' is not reproducible across dispatches and cannot "
                "back the result cache; use mds_init='classical' or cache_capacity=0")


@dataclasses.dataclass
class PredictionResult:
    """One served structure (host numpy, sliced to the true length)."""

    seq: str
    coords: np.ndarray        # (L, 3) CA trace
    confidence: np.ndarray    # (L,) in [0, 1]
    stress: float             # final normalised MDS stress
    bucket: int
    from_cache: bool
    latency_s: float
    replica: str = ""         # fleet: the serving replica's name
    degraded: bool = False    # fleet: served by the degraded tier
    requeues: int = 0         # fleet: replica failovers survived
    trace_id: str = ""        # the request's trace id (spans, flight record)
    mean_confidence: float = 0.0  # over the true length (the cascade's signal)
    exit_depth: int = 0       # the depth the distogram froze at (0: early exit off)
    tier: str = ""            # cascade provenance: "", "draft", "escalated", "full"


class ServingRequest:
    """Client handle: a future resolved by the scheduler worker."""

    def __init__(self, seq: str, tokens: np.ndarray, msa, msa_mask, cache_key: str,
                 bucket: int, deadline: Optional[float], trace_id: str = ""):
        self.seq = seq
        self.tokens = tokens
        self.msa = msa
        self.msa_mask = msa_mask
        self.cache_key = cache_key
        self.bucket = bucket
        self.deadline = deadline
        self.trace_id = trace_id or new_trace_id()
        self.submitted_at = time.monotonic()
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._claimed = False
        self._result: Optional[PredictionResult] = None
        self._exc: Optional[BaseException] = None
        self._callbacks = []

    @property
    def length(self) -> int:
        return self.tokens.shape[0]

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    def done(self) -> bool:
        return self._event.is_set()

    def _finish(self, result=None, exc=None) -> bool:
        """Resolve once; later resolutions are dropped. True when this call
        resolved the request. Done-callbacks run after the lock, on the
        resolving thread; a raising one is printed and skipped."""
        if not self._claim(result=result, exc=exc):
            return False
        self._release()
        return True

    def _claim(self, result=None, exc=None) -> bool:
        """The first half of `_finish`: take the outcome, so that no later
        resolution can, without showing it to the client yet. True when
        this call claimed the request."""
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
            self._result, self._exc = result, exc
        return True

    def _release(self) -> None:
        """The second half: wake the waiters and run the done-callbacks."""
        with self._lock:
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — a callback must not stop the resolver
                traceback.print_exc()

    def add_done_callback(self, fn):
        """Run `fn(request)` when the request resolves: at once, on this
        thread, if it has. Callbacks run on whichever thread resolves it
        (usually the worker), so keep them non-blocking: the fleet's
        completion seam."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def peek(self):
        """(result, exc) without waiting or copying, once resolved; the
        result may alias a cache entry (fleet and engine internals only)."""
        if not self._event.is_set():
            raise RuntimeError("peek() before the request resolved")
        return self._result, self._exc

    def result(self, timeout: Optional[float] = None) -> PredictionResult:
        """Block for the outcome: the request's ServingError, or the builtin
        TimeoutError when the caller's own wait budget runs out first. Each
        call returns fresh copies of the arrays (a result may be shared by
        coalesced requests and alias a cache entry)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request ({len(self.seq)} residues) not completed within "
                               f"{timeout}s wait")
        if self._exc is not None:
            raise self._exc
        return dataclasses.replace(self._result, coords=self._result.coords.copy(),
                                   confidence=self._result.confidence.copy())


def pad_msa_batch(live, bucket: int, batch_shape: int, rows: int):
    """(B, rows, bucket) MSA stream and mask for a batch of requests. A
    request without an MSA gets its query as row 0; unused rows repeat row
    0 under a False mask (finite values that masked attention ignores);
    filler batch slots repeat the last request."""
    msa = np.full((batch_shape, rows, bucket), PAD_TOKEN_ID, np.int32)
    msam = np.zeros((batch_shape, rows, bucket), bool)
    for i, req in enumerate(live):
        L = req.length
        src = req.msa if req.msa is not None else req.tokens[None]
        src_mask = req.msa_mask if req.msa_mask is not None else np.ones(src.shape, bool)
        r = src.shape[0]
        msa[i, :r, :L] = src
        msam[i, :r, :L] = src_mask
        for j in range(r, rows):
            msa[i, j] = msa[i, 0]
    for i in range(len(live), batch_shape):
        msa[i], msam[i] = msa[len(live) - 1], msam[len(live) - 1]
    return msa, msam


_IDLE_POLL_S = 0.05  # worker wake cadence when nothing is staged

_SETTLE_STOP = object()  # the settle queue's sentinel, put LAST by the worker's
#                          final flush or abort: every batch in flight settles
#                          before the settle thread exits


@dataclasses.dataclass
class _InFlight:
    """One batch enqueued but not settled (worker -> settle thread): `out`
    is what `_call_executable` returned (on the card a `PendingCall`);
    `enqueue_t` and `compile_s0` bill its enqueue -> realized window less
    any capture."""

    bucket: int
    shape: int
    live: list
    out: object
    idx: int
    enqueue_t: float
    compile_s0: float
    n_real: int


class ServingEngine:
    """Length-bucketed, micro-batching engine over `predict_structure`.

    params: the trunk's parameter tree, on `device` (the int8 tree is made
    from it at build for weight_dtype="int8": `resident_params`);
    model_cfg: `Alphafold2Config` (max_seq_len must cover the ladder);
    cfg: `ServingConfig`; device: where it serves (default CUDA, where
    every executable is a captured graph pair; "cpu" runs eager).
    metrics_logger: a `MetricsLogger` given one record a batch.
    tracer: a `telemetry.Tracer` (None: the no-op `NULL_TRACER`).
    replica_name: stamped as `replica` on every span ("" = no tag), and
    the serve-goodput account's name ("engine" when empty).
    incident_hook: `fn(kind, **attrs)` on `breaker_open` and
    `watchdog_fire` (a `FlightRecorder.incident`); its exceptions are
    printed and swallowed.
    cost_ledger / goodput: the ledgers to fill (None: private ones over
    this engine's registry); either way `sample_gauges` publishes them and
    `stats()` reports them. A cost ledger passed in, or a live tracer,
    turns on the CUDA-event device timing.
    flights: a `FlightBook` for this engine's submit -> terminal records.
    fault_hook: `fn(dispatch_index, bucket)` at the top of every dispatch,
    outside the card's lock (a `FaultInjector` hook: it may sleep or
    raise). pool_name: the capability pool's label on the cost cells and
    the goodput account. model_apply_fn: a forward override for every
    bucket (`predict_structure`'s), exclusive with the SP arm and with
    early exit. sp_devices: the SP mesh's devices (None: `sp_shards`
    distinct cards); every one must be `device`.

    `_call_executable` and `_realize` are overridable seams: tests stub
    the device call there without touching the scheduler."""

    def __init__(self, params, model_cfg, cfg: ServingConfig = ServingConfig(), *,
                 device=None, model_apply_fn=None, metrics_logger=None, fault_hook=None,
                 tracer=None, replica_name: str = "", incident_hook=None,
                 pool_name: str = "default", cost_ledger=None, goodput=None, flights=None,
                 sp_devices=None):
        # early exit against the model (JAX's checks and messages): a bad
        # depth fails the construction, not the first dispatch
        if cfg.early_exit_depths:
            if model_apply_fn is not None:
                raise ValueError("early_exit_depths and model_apply_fn are mutually "
                                 "exclusive: early exit drives the trunk itself")
            if model_cfg.reversible:
                raise ValueError("early exit segments the sequential layer list; the "
                                 "reversible trunk is depth-stacked — set reversible=False")
            if cfg.early_exit_depths[-1] >= model_cfg.depth:
                raise ValueError(
                    f"early_exit_depths {cfg.early_exit_depths} must all be < model depth "
                    f"{model_cfg.depth} (the full-depth checkpoint is implicit)")
            if len(set(model_cfg.layer_sparse)) > 1:
                raise ValueError("early exit requires uniform sparse_self_attn flags across "
                                 "the trunk (layer slices re-index cfg.layer_sparse from 0)")
        self._ladder = BucketLadder(cfg.buckets)
        if self._ladder.max_len > model_cfg.max_seq_len:
            raise ValueError(f"largest bucket {self._ladder.max_len} exceeds the model's "
                             f"max_seq_len {model_cfg.max_seq_len}")
        if cfg.msa_rows > model_cfg.max_num_msa:
            raise ValueError(f"msa_rows {cfg.msa_rows} exceeds the model's max_num_msa "
                             f"{model_cfg.max_num_msa}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model_cfg = model_cfg
        check_params_device(params, self.device)
        self._model_apply_fn = model_apply_fn
        # the SP arm: a mesh on the engine's device and the ladder's plan,
        # priced from shapes at build. The plan enters the config tag: the
        # schedules agree only to rounding
        self._sp_mesh = None
        self._sp_plan = {}
        self._apply_fns = {}  # bucket -> its SP forward (absent: dense)
        if cfg.sp_shards:
            if model_apply_fn is not None:
                raise ValueError("sp_shards and model_apply_fn are mutually exclusive: the "
                                 "SP arm builds its own per-bucket trunk override")
            self._sp_mesh = sp_arm.build_sp_mesh(cfg.sp_shards, sp_devices)
            sp_arm.check_mesh_placement(self._sp_mesh.devices, self.device)
            self._sp_plan = sp_arm.plan_bucket_schedules(
                model_cfg, buckets=self._ladder.buckets, batch=cfg.max_batch,
                msa_rows=cfg.msa_rows, shards=cfg.sp_shards,
                hbm_bytes=cfg.sp_hbm_gb * (1 << 30), overrides=dict(cfg.sp_schedules))
            for bucket, plan in self._sp_plan.items():
                fn = sp_arm.make_sp_apply_fn(self._sp_mesh, plan.schedule)
                if fn is not None:
                    self._apply_fns[bucket] = fn
        self._fault_hook = fault_hook
        # the card's pool and lock (None on the CPU): the construction's
        # device work, every call and the release of the graphs run under it
        self._pool = GraphPool(self.device) if self.device.type == "cuda" else None
        self._card_lock = self._pool.lock if self._pool is not None else None
        with self._device_section():
            # the int8 arm quantizes once per residency tag, process-wide
            params, self._weight_residency = resident_params(params, model_cfg,
                                                             params_tag=cfg.params_tag)
            # the random init's generator (on the card, registered with each graph)
            self._init_streams = Streams(self.device) if cfg.mds_init == "random" else None
        self._params = params
        self._batch_shapes = (batch_shape_ladder(cfg.max_batch) if cfg.batch_ladder
                              else (cfg.max_batch,))
        # the numerics identity of a result: repr(model_cfg) covers every
        # model field (dtype, weight_dtype, attn_gate, sparse_self_attn,
        # ...); the ladder because a structure depends on its bucket; the
        # device type because the card's kernels and the CPU's plain
        # versions agree only to rounding; the early-exit knobs because an
        # exited distogram is another function of the sequence
        tag_fields = (model_cfg, cfg.mds_iters, cfg.mds_init, cfg.seed, cfg.msa_rows,
                      cfg.params_tag, self._ladder.buckets, self.device.type, cfg.sp_shards,
                      tuple((b, r.schedule) for b, r in sorted(self._sp_plan.items())),
                      cfg.early_exit_depths, cfg.early_exit_kl)
        if cfg.batch_ladder:
            tag_fields = tag_fields + (("batch_ladder", self._batch_shapes),)
        self._config_tag = repr(tag_fields)

        self._executables = {}
        self._compile_lock = threading.Lock()
        self._batch_counter = 0  # device calls so far: the random init's index
        self._dispatch_counter = 0
        self._counter_lock = threading.Lock()
        self.replica_name = replica_name
        self._span_tags = {"replica": replica_name} if replica_name else {}
        self._incident_hook = incident_hook
        self._breaker = (
            CircuitBreaker(cfg.breaker_threshold, cfg.breaker_reset_s,
                           jitter=cfg.breaker_jitter, seed=cfg.breaker_jitter_seed,
                           on_open=self._on_breaker_open)
            if cfg.breaker_threshold else None
        )
        self._queue: "queue.Queue[ServingRequest]" = queue.Queue(maxsize=cfg.max_queue)
        self._cache = ResultCache(cfg.cache_capacity)
        self._inflight = {}  # cache_key -> pending request (coalescing)
        self._inflight_lock = threading.Lock()
        self._held = threading.local()  # `_holding`: the requests a block releases at its end
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = ServingMetrics(logger=metrics_logger, tracer=self._tracer)
        self.metrics.set_weight_bytes(self._weight_residency)
        # which arm each kernel op takes on this device (ops/dispatch.py)
        self._dispatch_tag = (f"dispatch[{self.device.type}](" + ",".join(
            f"{op}={dispatch_resolve(op, self.device)}" for op in DISPATCH_OPS) + ")")

        # the serving cost plane: one cell a (bucket, rung) under its
        # schedule ("<schedule>@b{B}" under the batch ladder), priced per
        # shard, billed by the cards the bucket's mesh occupies
        self.pool_name = pool_name
        # a batch's device time from CUDA events, only when something asked
        # for it: without, the dispatch makes the CUDA calls it always made
        self._device_timing = self._tracer.enabled or cost_ledger is not None
        self.costs = (cost_ledger if cost_ledger is not None
                      else ExecutableCostLedger(self.metrics.registry))
        self.goodput = (goodput if goodput is not None
                        else ServeGoodputLedger(self.metrics.registry))
        self.flights = flights
        self._goodput_name = replica_name or "engine"
        self.goodput.register(self._goodput_name, pool_name)
        self._cost_cells = {}
        backend_arm = dispatch_resolve("flash_attention", self.device)
        for bucket in self._ladder.buckets:
            plan = self._sp_plan.get(bucket)
            schedule = plan.schedule if plan is not None else "dense"
            shards = cfg.sp_shards if schedule != "dense" else 1
            for shape in self._batch_shapes:
                residency = sp_arm.schedule_residency(
                    model_cfg, bucket=bucket, batch=shape, msa_rows=cfg.msa_rows,
                    schedule=schedule, shards=shards,
                    weight_bytes=self._weight_residency["weight_bytes"])
                self._cost_cells[(bucket, shape)] = self.costs.register_cell(
                    pool=pool_name, bucket=bucket,
                    schedule=f"{schedule}@b{shape}" if cfg.batch_ladder else schedule,
                    backend_arm=backend_arm, weight_dtype=model_cfg.weight_dtype,
                    forward_flops=model_fwd_flops(model_cfg, n=bucket, r=cfg.msa_rows,
                                                  c=bucket),
                    residency_bytes=residency.total_bytes,
                    chips=self.chips if schedule != "dense" else 1, max_batch=shape)
        # per-exit-depth cells (JAX's "dense@exit{d}", "dense@exit{d}@b{B}"
        # under the ladder): a request that froze at depth d did about
        # flops(d) / flops(depth) of the forward. Exits fire from the second
        # checkpoint on, so only depths[1:] get cells; `_bill_batch`
        # apportions a batch's seconds over them by FLOPs
        self._exit_cells = {}
        self._depth_flops = {}
        if cfg.early_exit_depths:
            for bucket in self._ladder.buckets:
                for d in cfg.early_exit_depths[1:]:
                    sub_cfg = dataclasses.replace(model_cfg, depth=d)
                    flops_d = model_fwd_flops(sub_cfg, n=bucket, r=cfg.msa_rows, c=bucket)
                    self._depth_flops[(bucket, d)] = flops_d
                    for shape in self._batch_shapes:
                        sub_res = sp_arm.schedule_residency(
                            sub_cfg, bucket=bucket, batch=shape, msa_rows=cfg.msa_rows,
                            schedule="dense", shards=1,
                            weight_bytes=self._weight_residency["weight_bytes"])
                        self._exit_cells[(bucket, d, shape)] = self.costs.register_cell(
                            pool=pool_name, bucket=bucket,
                            schedule=(f"dense@exit{d}@b{shape}" if cfg.batch_ladder
                                      else f"dense@exit{d}"),
                            backend_arm=backend_arm, weight_dtype=model_cfg.weight_dtype,
                            forward_flops=flops_d, residency_bytes=sub_res.total_bytes,
                            chips=1, max_batch=shape)
                self._depth_flops[(bucket, model_cfg.depth)] = model_fwd_flops(
                    model_cfg, n=bucket, r=cfg.msa_rows, c=bucket)
        self._timing = threading.local()  # a device call's CUDA events, call to realize
        self._closed = False
        self._drain_on_stop = True
        self._stop = threading.Event()
        self._rate_lock = threading.Lock()
        self._sec_per_req_ema = 0.0  # non-overlapped batch seconds per served request
        # pipelined dispatch: the worker enqueues, the settle thread
        # realizes, bills and resolves; the semaphore bounds the batches in
        # flight, and `_last_realized_t` is the realization watermark
        # `_billed_window` clamps each window against
        self._settle_dead = False
        self._pipeline_lock = threading.Lock()
        self._last_realized_t = 0.0
        self._settle_queue: "queue.Queue" = queue.Queue()
        self._inflight_sem = threading.Semaphore(max(1, cfg.pipeline_depth))
        self._settle_thread = None
        # build before the worker exists: a failing capture aborts the
        # construction instead of stranding a started worker. Largest
        # first: a smaller graph's allocations then split the blocks the
        # larger ones freed in the card's pool (ascending, each capture
        # would need blocks none freed before it)
        if cfg.precompile:
            for bucket in reversed(self._ladder.buckets):
                for shape in reversed(self._batch_shapes):
                    self._executable_for(bucket, shape)
        if cfg.pipeline_depth:
            self._settle_thread = threading.Thread(
                target=self._settle_loop, name=f"af2-settle-{replica_name or 'engine'}",
                daemon=True)
            self._settle_thread.start()
        self._worker = threading.Thread(target=self._worker_loop, name="af2-serve",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API

    def submit(self, seq: str, *, msa=None, msa_mask=None, timeout: Optional[float] = None,
               trace_id: str = "", features=None) -> ServingRequest:
        """Enqueue one sequence; returns a future at once. Raises
        EngineClosedError / InvalidSequenceError / SequenceTooLongError /
        QueueFullError / CircuitOpenError synchronously: a rejected request
        never occupies the queue. `trace_id` correlates the request's spans,
        flight record and result ("" mints one). `features`: a
        `featurize.FeatureBundle` made by the same `featurize_request` (the
        fleet's featurization tier), whose seq, tokens and MSA then replace
        `seq`, `msa` and `msa_mask`: the same bits either way."""
        trace_id = trace_id or new_trace_id()
        if features is not None:
            seq = features.seq
        # the span covers validation, the cache and coalescing lookups and
        # the enqueue; a rejection leaves it with an `error` attribute
        with self._tracer.span("serving.enqueue", cat="serving", length=len(seq),
                               trace_id=trace_id, **self._span_tags) as sp:
            req = self._submit(seq, msa, msa_mask, timeout, trace_id, features)
            sp.set("bucket", req.bucket)
            if req.trace_id != trace_id:
                # coalesced onto an identical in-flight request, whose id
                # the shared future keeps
                sp.set("coalesced_onto", req.trace_id)
            return req

    def _submit(self, seq, msa, msa_mask, timeout, trace_id, features=None) -> ServingRequest:
        if self._closed:
            self._reject(EngineClosedError("engine is shut down"))
        if features is not None:
            # made by featurize_request against a ladder and msa_rows: only
            # the guards that a bundle made for another deployment (or by a
            # client) could slip past remain (JAX's checks and messages)
            seq, tokens = features.seq, features.tokens
            msa_arr, msa_mask = features.msa, features.msa_mask
            try:
                bucket = self._ladder.bucket_for(len(seq))
            except ServingError as e:
                self._reject(e)
            if msa_arr is not None and (self.cfg.msa_rows == 0
                                        or msa_arr.shape[0] > self.cfg.msa_rows):
                self._reject(ServingError(
                    f"pre-featurized msa has {msa_arr.shape[0]} rows; this engine serves "
                    f"msa_rows={self.cfg.msa_rows}"))
            if msa_arr is None and msa_mask is not None:
                self._reject(ServingError("pre-featurized msa_mask given without msa"))
            if msa_arr is not None and msa_mask is not None and msa_mask.shape != msa_arr.shape:
                self._reject(ServingError(
                    f"pre-featurized msa_mask shape {msa_mask.shape} does not match msa "
                    f"shape {msa_arr.shape}"))
        else:
            try:
                fb = featurize_request(seq, msa, msa_mask, ladder=self._ladder,
                                       msa_rows=self.cfg.msa_rows)
            except ServingError as e:
                self._reject(e)
            seq, tokens, msa_arr, msa_mask, bucket = (fb.seq, fb.tokens, fb.msa, fb.msa_mask,
                                                      fb.bucket)
        key = request_key(seq, msa_arr, self._config_tag, msa_mask=msa_mask)
        if self.flights is not None:
            self.flights.begin(trace_id, length=len(seq),
                               **(self.cell_for(bucket) or {"pool": self.pool_name,
                                                            "bucket": bucket}))
        cached = self._cache.get(key)
        if cached is not None:
            # never touches the queue, the scheduler or the model
            self.metrics.inc("submitted")
            self.metrics.inc("cache_hits")
            self.metrics.inc("completed")
            self.metrics.latency.observe(0.0)
            if self.flights is not None:
                self.flights.finish(trace_id, "completed", from_cache=True,
                                    replica=self.replica_name)
            req = ServingRequest(seq, tokens, msa_arr, msa_mask, key, bucket, deadline=None,
                                 trace_id=trace_id)
            req._finish(result=dataclasses.replace(cached, from_cache=True, latency_s=0.0,
                                                   trace_id=trace_id))
            return req

        ttl = self.cfg.request_timeout_s if timeout is None else timeout
        deadline = (time.monotonic() + ttl) if ttl is not None else None
        with self._inflight_lock:
            existing = self._inflight.get(key)
            if existing is not None and not existing.done():
                # an identical query is pending: share its future (and its
                # deadline); this submitter's flight ends here
                if self.flights is not None:
                    self.flights.finish(trace_id, "coalesced", onto=existing.trace_id)
                self.metrics.inc("coalesced")
                return existing
            if self._breaker is not None and not self._breaker.allow():
                snap = self._breaker.snapshot()
                self._reject(CircuitOpenError(
                    f"circuit {snap['state']} after repeated dispatch failures (threshold "
                    f"{snap['threshold']}); retry after {self.cfg.breaker_reset_s}s"),
                    trace_id=trace_id)
            req = ServingRequest(seq, tokens, msa_arr, msa_mask, key, bucket, deadline,
                                 trace_id=trace_id)
            # counted before the worker can complete it, so in_flight never
            # reads negative
            self.metrics.inc("submitted")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                self.metrics.inc("submitted", -1)
                if self._breaker is not None:
                    self._breaker.abandon_probe()
                self.metrics.inc("rejected")
                self.metrics.inc_error("queue_full")
                if self.flights is not None:
                    self.flights.finish(trace_id, "rejected", code="queue_full")
                raise QueueFullError(
                    f"request queue at capacity ({self.cfg.max_queue}); retry with backoff "
                    f"or raise ServingConfig.max_queue",
                    retry_after_s=self.retry_after_estimate()) from None
            self._inflight[key] = req
        # shutdown() may have flipped the flag after the entry check, with
        # the worker already past this request: resolve it here (resolving
        # is once-only, so losing the race to a draining worker is harmless)
        if self._closed and self._resolve(req, exc=EngineClosedError(
                "engine shut down while the request was being submitted")):
            self.metrics.inc("failed")
            self.metrics.inc_error("engine_closed")
            raise EngineClosedError("engine is shut down")
        return req

    def _reject(self, exc: ServingError, trace_id: str = ""):
        """Count a submit-time rejection under its code and raise it;
        `trace_id` seals a flight record begun before the rejection."""
        self.metrics.inc("rejected")
        self.metrics.inc_error(exc)
        if self.flights is not None and trace_id:
            self.flights.finish(trace_id, "rejected", code=exc.code)
        raise exc from None

    def _incident(self, kind: str, **attrs):
        """Report a reliability incident to the hook; a raising hook is
        printed and swallowed."""
        if self._incident_hook is None:
            return
        try:
            self._incident_hook(kind, replica=self.replica_name, **attrs)
        except Exception:  # noqa: BLE001 — observability must not stop serving
            traceback.print_exc()

    def _on_breaker_open(self, snapshot: dict):
        self._incident("breaker_open", **snapshot)

    def predict(self, seq: str, *, msa=None, msa_mask=None,
                timeout: Optional[float] = None) -> PredictionResult:
        """Submit and block for the result."""
        return self.submit(seq, msa=msa, msa_mask=msa_mask, timeout=timeout).result()

    @property
    def compile_count(self) -> int:
        """Distinct buckets with a built executable."""
        return self.metrics.compile_count

    @property
    def config_tag(self) -> str:
        """The numerics identity the result cache keys on."""
        return self._config_tag

    @property
    def graph_lock(self):
        """The card's lock, held across every capture, every call and the
        construction's device work of every engine on the card (None on
        the CPU): `ProfileCapturer(lock=)` starts and stops the profiler
        under it, so the profiler never meets a capture."""
        return self._card_lock

    def _device_section(self):
        """The card's lock as a context (a no-op on the CPU)."""
        return self._card_lock if self._card_lock is not None else contextlib.nullcontext()

    @property
    def chips(self) -> int:
        """The cards this engine occupies: its device's and its SP mesh's,
        counted once each (four shards on one card are one card)."""
        if self._sp_mesh is None:
            return 1
        return len(set(self._sp_mesh.devices) | {self.device})

    def capability(self) -> dict:
        """What traffic this engine can serve."""
        return {"weight_dtype": self.model_cfg.weight_dtype, "sp_shards": self.cfg.sp_shards,
                "max_len": self._ladder.max_len}

    def cell_for(self, bucket: int, batch_shape: Optional[int] = None) -> dict:
        """The cost cell a (bucket, batch shape) bills to (None: the top
        rung, the identity known at submit time)."""
        if batch_shape is None:
            batch_shape = self._batch_shapes[-1]
        key = self._cost_cells.get((bucket, batch_shape))
        if key is None:
            return {}
        pool, b, schedule, arm, dtype = key
        return {"pool": pool, "bucket": b, "schedule": schedule, "backend_arm": arm,
                "weight_dtype": dtype}

    def retry_after_estimate(self) -> float:
        """Backoff advice for shed clients: the batch-assembly wait plus the
        backlog drained at the measured seconds per request (before any
        batch has finished: the latency p50 per max_batch batch)."""
        backlog = self._queue.qsize() + 1
        with self._rate_lock:
            sec_per_req = self._sec_per_req_ema
        if sec_per_req > 0.0:
            est = self.cfg.max_wait_s + sec_per_req * backlog
        else:
            per_batch = self.metrics.latency.snapshot().get("p50") or 0.1
            est = self.cfg.max_wait_s + per_batch * (1 + self._queue.qsize() // self.cfg.max_batch)
        return float(min(60.0, max(0.05, est)))

    def _note_drain(self, window_s: float, n: int):
        """Feed the drain EMA one settled batch: `window_s` is its
        non-overlapped share of the wall (`_billed_window`), so batches in
        flight together do not each claim the same second."""
        if n <= 0:
            return
        sec_per_req = window_s / n
        with self._rate_lock:
            self._sec_per_req_ema = (sec_per_req if self._sec_per_req_ema == 0.0
                                     else 0.2 * sec_per_req + 0.8 * self._sec_per_req_ema)

    def health(self) -> dict:
        """Liveness: "ok", "degraded" (the breaker is not closed) or "down"
        (closed, or the worker or the settle thread died)."""
        alive = self._worker.is_alive()
        if self._settle_thread is not None:
            alive = alive and self._settle_thread.is_alive()
        out = {"status": "ok" if (not self._closed and alive) else "down",
               "closed": self._closed, "worker_alive": alive,
               "queue_depth": self._queue.qsize(), "queue_capacity": self.cfg.max_queue}
        if self._settle_thread is not None:
            out["settle_alive"] = self._settle_thread.is_alive()
        if self._breaker is not None:
            out["breaker"] = self._breaker.state.value
            if out["status"] == "ok" and out["breaker"] != "closed":
                out["status"] = "degraded"
        return out

    def sample_gauges(self):
        """Publish the cost plane's gauges (the ops plane's ticker calls it;
        host state only)."""
        self.costs.publish()
        self.goodput.publish()

    def stats(self) -> dict:
        """JSON-ready snapshot: the JAX engine's keys, plus `device`,
        `captures` (each executable's build seconds, the launches its
        capture recorded and its replays; with early exit, how often each
        stage graph ran) and `launches` (the kernel launches the replays
        made: captured launches x replays, each stage graph by its own
        replays, by kernel wrapper, where the wrappers' own counts see only
        the capture).
        Host state only: safe from any thread during a capture."""
        self.sample_gauges()
        snap = self.metrics.snapshot(self.cfg.max_batch)
        snap["queue"] = {"depth": self._queue.qsize(), "capacity": self.cfg.max_queue}
        snap["cache"] = self._cache.snapshot()
        snap["buckets"] = list(self._ladder.buckets)
        snap["max_batch"] = self.cfg.max_batch
        snap["batch_shapes"] = list(self._batch_shapes)
        if self.cfg.pipeline_depth:
            snap["pipeline"] = {"depth": self.cfg.pipeline_depth,
                                **self.metrics.pipeline_snapshot()}
        snap["closed"] = self._closed
        snap["weights"] = dict(self._weight_residency)
        snap["dispatch"] = self._dispatch_tag
        snap["capability"] = self.capability()
        if self.cfg.sp_shards:
            # the per-bucket plan and its pricing, the mesh's devices
            snap["sp"] = {
                "shards": self.cfg.sp_shards,
                "hbm_budget_bytes": int(self.cfg.sp_hbm_gb * (1 << 30)),
                "schedules": {str(b): r.as_dict() for b, r in sorted(self._sp_plan.items())},
                "devices": [str(d) for d in self._sp_mesh.devices],
                "chips": self.chips,
            }
        snap["device"] = str(self.device)
        exes = sorted(self._executables.items())  # no lock: never wait on a capture
        snap["captures"] = []
        launches = {}
        for (b, s), exe in exes:
            entry = {"bucket": b, "batch": s, "seconds": exe.seconds, "replays": exe.replays,
                     "launches": dict(exe.launches)}
            stages = getattr(exe, "stage_replays", ())
            if stages:
                entry["stage_replays"] = list(stages)
            snap["captures"].append(entry)
            # a staged executable counts each stage graph's own replays
            replayed = (exe.replayed_launches() if stages
                        else {k: n * exe.replays for k, n in exe.launches.items()})
            for name, n in replayed.items():
                launches[name] = launches.get(name, 0) + n
        snap["launches"] = launches
        if self._breaker is not None:
            snap["breaker"] = self._breaker.snapshot()
        snap["costs"] = self.costs.snapshot()
        snap["serve_goodput"] = self.goodput.snapshot()
        snap["telemetry"] = {"metrics": self.metrics.registry.snapshot(),
                             "spans": self._tracer.summary()}
        return snap

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting work and stop the worker. drain=True serves the
        pending requests first (assembly deadlines waived, expiry kept);
        drain=False fails them with EngineClosedError. Either way, with
        pipelined dispatch the batches already enqueued settle, and the
        settle thread is joined. Idempotent; not from the worker thread."""
        with self._inflight_lock:
            self._closed = True
        self._drain_on_stop = drain
        self._stop.set()
        self._worker.join(timeout)
        # a submit() racing the close flag can strand a request after the
        # worker exited: fail it, once the worker is really gone
        if self._worker.is_alive():
            return
        # the worker put the settle sentinel last: past it every batch in
        # flight has settled
        if self._settle_thread is not None:
            self._settle_thread.join(timeout)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if self._resolve(req, exc=EngineClosedError(
                    "engine shut down before request was served")):
                self.metrics.inc("failed")
                self.metrics.inc_error("engine_closed")

    def release_graphs(self, timeout: Optional[float] = None):
        """After `shutdown`: free the executables' graphs and device buffers
        under the card's lock (their counters stay for `stats()`), so the
        card's pool takes their blocks back for the next capture and no
        garbage collection on another thread destroys a graph while an
        engine on the card captures (the fleet calls it on every engine it
        drains or shuts down). A pipelined engine's batches in flight settle
        first (the settle thread is joined). A call abandoned by the
        watchdog may still hold the lock, and a settle thread may still
        wait: past `timeout` the graphs are left to the collector. A no-op
        on the CPU."""
        if self._card_lock is None:
            return
        if self._settle_thread is not None:
            self._settle_thread.join(timeout)
            if self._settle_thread.is_alive():
                return
        if not self._card_lock.acquire(timeout=-1 if timeout is None else timeout):
            return
        try:
            with self._compile_lock:
                for exe in self._executables.values():
                    exe.release()
            torch.cuda.synchronize(self.device)
        finally:
            self._card_lock.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)
        return False

    @contextlib.contextmanager
    def _holding(self):
        """Within the block, this thread's resolutions claim their requests
        and release them when it ends: the spans the block closes and the
        flights it seals come before the clients see their outcomes. A
        block inside another leaves the releases to the outer one."""
        if getattr(self._held, "requests", None) is not None:
            yield
            return
        self._held.requests = held = []
        try:
            yield
        finally:
            self._held.requests = None
            for req in held:
                req._release()

    def _resolve(self, req: ServingRequest, *, result=None, exc=None) -> bool:
        """Finish a request and drop it from the coalescing map, its flight
        sealed before its client can see the outcome; inside `_holding`
        the client sees it when the block ends."""
        finished = req._claim(result=result, exc=exc)
        if finished:
            with self._inflight_lock:
                if self._inflight.get(req.cache_key) is req:
                    del self._inflight[req.cache_key]
            if self.flights is not None:
                # every terminal path resolves here: seal the flight
                if exc is not None:
                    self.flights.finish(req.trace_id, "failed",
                                        code=getattr(exc, "code", type(exc).__name__),
                                        replica=self.replica_name)
                else:
                    self.flights.finish(req.trace_id, "completed", replica=self.replica_name,
                                        latency_s=result.latency_s, batch_bucket=result.bucket)
            held = getattr(self._held, "requests", None)
            if held is None:
                req._release()
            else:
                held.append(req)
        return finished

    # ------------------------------------------------------ executables

    def _executable_for(self, bucket: int, batch_shape: Optional[int] = None):
        """The executable of (bucket, batch shape), built at most once
        under a lock (precompile and the worker can race); `batch_shape`
        None is the top rung."""
        if batch_shape is None:
            batch_shape = self._batch_shapes[-1]
        with self._compile_lock:
            exe = self._executables.get((bucket, batch_shape))
            if exe is not None:
                return exe
            t_compile = time.monotonic()
            with self.metrics.capture_span(bucket):
                exit_kw = dict(early_exit_depths=self.cfg.early_exit_depths,
                               early_exit_kl=self.cfg.early_exit_kl,
                               model_apply_fn=self._apply_fns.get(bucket,
                                                                  self._model_apply_fn))
                if self.device.type == "cuda":
                    exe = CapturedExecutable(self._params, self.model_cfg, batch=batch_shape,
                                             bucket=bucket, msa_rows=self.cfg.msa_rows,
                                             mds_iters=self.cfg.mds_iters, device=self.device,
                                             pool=self._pool, mds_init=self.cfg.mds_init,
                                             streams=self._init_streams,
                                             apply_name=self._apply_name(bucket),
                                             slots=self.cfg.pipeline_depth, **exit_kw)
                else:
                    exe = EagerExecutable(self._params, self.model_cfg,
                                          mds_iters=self.cfg.mds_iters,
                                          mds_init=self.cfg.mds_init, device=self.device,
                                          streams=self._init_streams, **exit_kw)
            # the capture's wall is "compile"; the dispatch that triggered
            # it subtracts the tracker's delta from its own window
            self.goodput.add(self._goodput_name, "compile", time.monotonic() - t_compile)
            self._executables[(bucket, batch_shape)] = exe
            return exe

    def _apply_name(self, bucket: int) -> str:
        """The forward a bucket's executable runs, for capture errors."""
        plan = self._sp_plan.get(bucket)
        if plan is not None and plan.schedule != "dense":
            return f"the {plan.schedule} forward over {self.cfg.sp_shards} shards"
        return "the forward override" if self._model_apply_fn is not None else "the forward"

    def _call_executable(self, bucket: int, tokens, mask, msa=None, msa_mask=None):
        """One device call on the padded batch (its rung is tokens.shape[0]),
        its index counted from 1 (the random init's seed is
        `init_seed(index)`). Returns the outputs on the device; with
        pipelined dispatch on the card, the enqueued call (`PendingCall`),
        which `_realize` waits for. Overridable seam."""
        exe = self._executable_for(bucket, tokens.shape[0])
        with self._counter_lock:
            self._batch_counter += 1
            index = self._batch_counter
        if self.device.type == "cuda" and self.cfg.pipeline_depth:
            return exe.enqueue(tokens, mask, msa, msa_mask, seed=self.init_seed(index),
                               timing=self._device_timing)
        if self.device.type != "cuda" or not self._device_timing:
            return exe(tokens, mask, msa, msa_mask, seed=self.init_seed(index))
        # the call's device time: two events on the engine's stream around
        # the replays, recorded under the pool's lock (outside any capture)
        # and read after _realize has waited for the outputs
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        out = exe(tokens, mask, msa, msa_mask, seed=self.init_seed(index), events=events)
        self._timing.events = events
        return out

    def init_seed(self, index: int) -> int:
        """The random MDS init's seed for device call `index`: fold_in(seed,
        index), as the JAX engine folds the index into PRNGKey(seed)."""
        return fold_in(self.cfg.seed, index)

    def _realize(self, out):
        """Wait for a call's outputs and bring them to the host as numpy.
        Overridable seam: the point the hung-batch watchdog guards (with
        pipelined dispatch, on the settle thread)."""
        if isinstance(out, PendingCall):
            return out.wait()
        return {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in out.items()}

    def _next_dispatch_idx(self) -> int:
        """The next dispatch index (the chaos clock), under the counter
        lock: the worker's enqueues and a settle-side split's singles may
        dispatch at once."""
        with self._counter_lock:
            idx = self._dispatch_counter
            self._dispatch_counter += 1
            return idx

    def _watched(self, fn, *, bucket: int, idx: int, trace_ids, thread: str, what: str):
        """`fn()` under the hung-batch watchdog when one is set: it then
        runs on a throwaway daemon thread, and past the timeout it is
        abandoned (a thread cannot be killed) and HungBatchError is raised
        while the caller goes on."""
        timeout = self.cfg.watchdog_timeout_s
        if timeout is None:
            return fn()
        box, done = {}, threading.Event()

        def runner():
            try:
                box["out"] = fn()
            except BaseException as e:  # noqa: BLE001 — relayed below
                box["exc"] = e
            finally:
                done.set()

        threading.Thread(target=runner, daemon=True,
                         name=f"{thread}-{self.replica_name or 'engine'}-{idx}").start()
        if not done.wait(timeout):
            self._incident("watchdog_fire", bucket=bucket, dispatch=idx, timeout_s=timeout,
                           trace_ids=list(trace_ids))
            raise HungBatchError(f"dispatch {idx} (bucket {bucket}) exceeded the {timeout}s "
                                 f"hung-batch watchdog; {what} abandoned")
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    def _dispatch(self, bucket: int, tokens, mask, msa=None, msa_mask=None, trace_ids=()):
        """`_call_executable` and `_realize`, under the watchdog when one is
        set: the call then runs on a throwaway daemon thread, and past the
        timeout it is abandoned (a thread cannot be killed) and the batch
        fails with HungBatchError while the worker keeps serving. Returns
        (the host outputs, the call's device seconds from CUDA events, or
        None off the card, without device timing or when the seam is
        stubbed)."""
        idx = self._next_dispatch_idx()

        def call():
            # the chaos seam first: before the executable, outside the
            # card's lock (an injected stall must not hold the card)
            if self._fault_hook is not None:
                self._fault_hook(idx, bucket)
            # the span closes after _realize has waited for the outputs, and
            # carries the events' device_ms; bind_trace stamps the batch's
            # ids onto the nested capture span too. The card's lock covers
            # the call, its capture if any, and the copy to the host
            with self._tracer.bind_trace(list(trace_ids)), \
                    self._tracer.span("serving.execute", cat="serving", bucket=bucket,
                                      batch=int(tokens.shape[0]), dispatch=idx,
                                      trace_ids=list(trace_ids), **self._span_tags) as sp, \
                    self._device_section():
                self._timing.events = None
                raw = self._call_executable(bucket, tokens, mask, msa, msa_mask)
                out = self._realize(raw)
                events, self._timing.events = self._timing.events, None
                device_s = getattr(raw, "device_s", None)  # a pipelined engine's single
                if events is not None:
                    device_s = events[0].elapsed_time(events[1]) / 1e3
                    del events  # destroyed under the lock too
                if device_s is not None:
                    sp.set("device_ms", device_s * 1e3)
                return out, device_s

        return self._watched(call, bucket=bucket, idx=idx, trace_ids=trace_ids,
                             thread="af2-dispatch", what="call")

    # ------------------------------------------------- scheduler worker

    def _worker_loop(self):
        staged = {}  # bucket -> [ServingRequest], FIFO
        try:
            while True:
                self._dispatch_ready(staged, force=False)
                if self._stop.is_set():
                    self._final_flush(staged)
                    return
                try:
                    req = self._queue.get(timeout=self._poll_timeout(staged))
                except queue.Empty:
                    continue
                self._stage(staged, req)
                # drain what arrived with it: a burst becomes one batch
                while True:
                    try:
                        self._stage(staged, self._queue.get_nowait())
                    except queue.Empty:
                        break
        except BaseException as e:  # noqa: BLE001 — the abort is the report
            # a scheduler bug must not strand pending requests behind a
            # dead thread: fail them all and refuse further traffic
            self._abort_worker(staged, e)

    def _abort_worker(self, staged, cause: BaseException):
        with self._inflight_lock:
            self._closed = True
        traceback.print_exc()
        err = PredictionError(f"serving worker crashed: {type(cause).__name__}: {cause}; "
                              f"engine is closed")
        err.__cause__ = cause
        while True:
            try:
                self._stage(staged, self._queue.get_nowait())
            except queue.Empty:
                break
        for reqs in staged.values():
            for req in reqs:
                if self._resolve(req, exc=err):
                    self.metrics.inc("failed")
                    self.metrics.inc_error(err)
        staged.clear()
        if self._settle_thread is not None:
            # the batches enqueued before the crash settle ahead of it
            self._settle_queue.put(_SETTLE_STOP)

    def _stage(self, staged, req: ServingRequest):
        staged.setdefault(req.bucket, []).append(req)

    def _poll_timeout(self, staged) -> float:
        """Sleep until the nearest batch-assembly deadline, capped so a stop
        is noticed promptly."""
        if not staged:
            return _IDLE_POLL_S
        nearest = min(reqs[0].submitted_at + self.cfg.max_wait_s
                      for reqs in staged.values() if reqs)
        return min(_IDLE_POLL_S, max(1e-3, nearest - time.monotonic()))

    def _dispatch_ready(self, staged, force: bool):
        for bucket in list(staged):
            reqs = staged[bucket]
            while reqs and (force or len(reqs) >= self.cfg.max_batch
                            or time.monotonic() - reqs[0].submitted_at >= self.cfg.max_wait_s):
                batch = reqs[: self.cfg.max_batch]
                del reqs[: self.cfg.max_batch]
                self._run_batch(bucket, batch)
            if not reqs:
                staged.pop(bucket)

    def _final_flush(self, staged):
        """Stop path: drain the queue, then serve or fail everything."""
        while True:
            try:
                self._stage(staged, self._queue.get_nowait())
            except queue.Empty:
                break
        if self._drain_on_stop:
            self._dispatch_ready(staged, force=True)
        else:
            for reqs in staged.values():
                for req in reqs:
                    if self._resolve(req, exc=EngineClosedError(
                            "engine shut down before request was served")):
                        self.metrics.inc("failed")
                        self.metrics.inc_error("engine_closed")
            staged.clear()
        if self._settle_thread is not None:
            # last: what the drain just enqueued, and anything in flight
            # from before the stop, settles first
            self._settle_queue.put(_SETTLE_STOP)

    def _run_batch(self, bucket: int, reqs, allow_split: bool = True):
        now = time.monotonic()
        live = []
        for req in reqs:
            if req.expired(now):
                exc = RequestTimeoutError(
                    f"deadline passed after {now - req.submitted_at:.3f}s in queue",
                    retry_after_s=self.retry_after_estimate())
                if self._resolve(req, exc=exc):
                    self.metrics.inc("timed_out")
                    self.metrics.inc_error(exc)
            else:
                live.append(req)
        # an expired request may have been the breaker's half-open probe,
        # which then must be released
        if len(live) < len(reqs) and self._breaker is not None:
            self._breaker.abandon_probe()
        if not live:
            return
        if not allow_split:
            # a poison-isolation retry runs inside its parent's batch span:
            # no second queue_wait or batch span for it
            self._run_live(bucket, live, allow_split)
            return
        if self._tracer.enabled:
            for req in live:
                self._tracer.add("serving.queue_wait", now - req.submitted_at, cat="serving",
                                 bucket=bucket, trace_id=req.trace_id, **self._span_tags)
        # the clients see their outcomes once the batch's spans have closed
        with self._holding(), self._tracer.span(
                "serving.batch", cat="serving", bucket=bucket, n=len(live),
                trace_ids=[r.trace_id for r in live], **self._span_tags):
            self._run_live(bucket, live, allow_split)

    def _batch_shape_for(self, n: int) -> int:
        """The smallest rung that holds n rows (max_batch without the
        ladder)."""
        for s in self._batch_shapes:
            if n <= s:
                return s
        return self._batch_shapes[-1]

    def _fail_live(self, bucket: int, live, e: Exception, allow_split: bool,
                   burned_s: float = 0.0):
        """A failed batch: its burned host seconds go to goodput's
        "requeue"; split a multi-request batch into single-request retries
        (a poison request must not fail its batchmates; a hung batch is not
        split, the device is the suspect), else resolve every request with
        the terminal error."""
        if burned_s > 0.0:
            self.goodput.add(self._goodput_name, "requeue", burned_s)
        hung = isinstance(e, HungBatchError)
        if not hung and allow_split and len(live) > 1:
            for req in live:
                self._run_batch(bucket, [req], allow_split=False)
            return
        if self._breaker is not None:
            self._breaker.record_failure()
        if hung:
            err = e
        else:
            err = PredictionError(f"prediction failed for bucket {bucket}: "
                                  f"{type(e).__name__}: {e}")
            err.__cause__ = e
        for req in live:
            if self._resolve(req, exc=err):
                self.metrics.inc("failed")
                self.metrics.inc_error(err)

    def _billed_window(self, t0: float, t1: float, compile_s0: float):
        """(window, billed) seconds of a dispatch realized over [t0, t1]:
        with pipelined dispatch the span clamped against the engine's
        realization watermark (settles are in order, so the windows
        partition the wall and no second is billed twice), else the whole
        span; billed is the window less the captures made since
        `compile_s0`."""
        compile_delta = self.metrics.compile_seconds_total() - compile_s0
        if not self.cfg.pipeline_depth:
            window = max(0.0, t1 - t0)
        else:
            with self._pipeline_lock:
                start = max(t0, self._last_realized_t)
                if t1 > self._last_realized_t:
                    self._last_realized_t = t1
            window = max(0.0, t1 - start)
        return window, max(0.0, window - compile_delta)

    def _run_live(self, bucket: int, live, allow_split: bool):
        shape = self._batch_shape_for(len(live))
        if self.cfg.pipeline_depth and allow_split and not self._settle_dead:
            self._run_pipelined(bucket, shape, live)
        else:
            # depth 0, a split's single (on whichever thread split it: with
            # pipelined dispatch, the settle thread), or a dead settle thread
            self._run_sync(bucket, shape, live, allow_split)

    def _run_sync(self, bucket: int, shape: int, live, allow_split: bool):
        t0 = None  # set once the device call starts
        try:
            # assembly sits inside the guard: a request that breaks the
            # padding fails like one that breaks the model call
            tokens, mask, n_real = pad_batch([r.tokens for r in live], bucket, shape)
            msa = msa_mask = None
            if self.cfg.msa_rows:
                msa, msa_mask = pad_msa_batch(live, bucket, shape, self.cfg.msa_rows)
            # a (bucket, rung)'s first batch captures inside this window:
            # the capture's seconds reach neither "execute" nor the EMA
            compile_s0 = self.metrics.compile_seconds_total()
            t0 = time.monotonic()
            out, device_s = self._dispatch(bucket, tokens, mask, msa, msa_mask,
                                           trace_ids=[r.trace_id for r in live])
            window, exec_s = self._billed_window(t0, time.monotonic(), compile_s0)
            coords = np.asarray(out["coords"])
            conf = np.asarray(out["confidence"])
            stress = np.asarray(out["stress"])
            exit_depth = np.asarray(out["exit_depth"]) if "exit_depth" in out else None
        except Exception as e:  # noqa: BLE001 — isolate, report, keep serving
            burned = (self._billed_window(t0, time.monotonic(), compile_s0)[1]
                      if t0 is not None else 0.0)
            self._fail_live(bucket, live, e, allow_split, burned_s=burned)
            return
        if self._breaker is not None:
            self._breaker.record_success()
        # accounted before the requests resolve
        self.goodput.add(self._goodput_name, "execute", exec_s)
        self._bill_batch(bucket, shape, exec_s if device_s is None else device_s, live,
                         exit_depth)
        self._note_drain(window, len(live))
        done_at = time.monotonic()
        with self._tracer.span("serving.respond", cat="serving", bucket=bucket, n=len(live),
                               trace_ids=[r.trace_id for r in live], **self._span_tags):
            self._respond(bucket, shape, live, coords, conf, stress, n_real, done_at,
                          exit_depth=exit_depth)

    # ------------------------------------------------- pipelined dispatch

    def _run_pipelined(self, bucket: int, shape: int, live):
        """Assemble and enqueue on the worker; realization, billing and
        the response move to the settle thread. At most `pipeline_depth`
        batches sit enqueued but unsettled. The enqueue runs under the
        watchdog: on the card it waits for its graph one at the eager
        `eigh` and at each early-exit stage."""
        idx = self._next_dispatch_idx()
        acquired = False
        try:
            tokens, mask, n_real = pad_batch([r.tokens for r in live], bucket, shape)
            msa = msa_mask = None
            if self.cfg.msa_rows:
                msa, msa_mask = pad_msa_batch(live, bucket, shape, self.cfg.msa_rows)
            # the chaos seam at the sync path's point in a request's life:
            # after assembly, before the device call, outside the card's lock
            if self._fault_hook is not None:
                self._fault_hook(idx, bucket)
            # bound the window before touching the card; the timeout keeps
            # the worker watching for a dead settle thread
            while not self._inflight_sem.acquire(timeout=0.1):
                if self._settle_dead:
                    raise PredictionError("settle thread died with the pipeline window "
                                          "full; engine is closed")
            acquired = True
            # a first call's capture happens in the enqueue: the settle
            # side's window subtracts it
            compile_s0 = self.metrics.compile_seconds_total()
            enqueue_t = time.monotonic()
            trace_ids = [r.trace_id for r in live]

            def enqueue():
                with self._tracer.bind_trace(trace_ids):
                    return self._call_executable(bucket, tokens, mask, msa, msa_mask)

            out = self._watched(enqueue, bucket=bucket, idx=idx, trace_ids=trace_ids,
                                thread="af2-dispatch", what="enqueue")
        except Exception as e:  # noqa: BLE001 — the sync path's isolation
            if acquired:
                self._inflight_sem.release()
            self._fail_live(bucket, live, e, allow_split=True)
            return
        self.metrics.pipeline_inflight_delta(+1)
        self._settle_queue.put(_InFlight(bucket=bucket, shape=shape, live=live, out=out,
                                         idx=idx, enqueue_t=enqueue_t, compile_s0=compile_s0,
                                         n_real=n_real))

    def _settle_loop(self):
        """The settle thread: each batch in flight in order, until the
        sentinel the worker puts last."""
        try:
            while True:
                rec = self._settle_queue.get()
                if rec is _SETTLE_STOP:
                    return
                self._settle(rec)
        except BaseException as e:  # noqa: BLE001 — the abort is the report
            self._abort_settle(e)

    def _settle(self, rec: _InFlight):
        try:
            out = self._wait_realized(rec)
            realized_t = time.monotonic()
            coords = np.asarray(out["coords"])
            conf = np.asarray(out["confidence"])
            stress = np.asarray(out["stress"])
            exit_depth = np.asarray(out["exit_depth"]) if "exit_depth" in out else None
        except Exception as e:  # noqa: BLE001 — isolate, keep settling
            burned = self._billed_window(rec.enqueue_t, time.monotonic(), rec.compile_s0)[1]
            # the slot first: the split's singles run here, and the worker
            # must keep enqueuing behind them
            self._inflight_sem.release()
            self.metrics.pipeline_inflight_delta(-1)
            self._fail_live(rec.bucket, rec.live, e, allow_split=True, burned_s=burned)
            return
        self._inflight_sem.release()
        self.metrics.pipeline_inflight_delta(-1)
        device_s = getattr(rec.out, "device_s", None)
        span_s = realized_t - rec.enqueue_t
        window, exec_s = self._billed_window(rec.enqueue_t, realized_t, rec.compile_s0)
        # each batch's execute span still brackets its enqueue -> realized
        self._tracer.add("serving.execute", span_s, cat="serving", bucket=rec.bucket,
                         batch=rec.shape, dispatch=rec.idx,
                         trace_ids=[r.trace_id for r in rec.live],
                         **({"device_ms": device_s * 1e3} if device_s is not None else {}),
                         **self._span_tags)
        self.metrics.observe_pipeline_settle(span_s, window)
        if self._breaker is not None:
            self._breaker.record_success()
        # accounted before the requests resolve
        self.goodput.add(self._goodput_name, "execute", exec_s)
        self._bill_batch(rec.bucket, rec.shape, exec_s if device_s is None else device_s,
                         rec.live, exit_depth)
        self._note_drain(window, len(rec.live))
        done_at = time.monotonic()
        # the clients see their results once the span has closed
        with self._holding(), self._tracer.span(
                "serving.respond", cat="serving", bucket=rec.bucket, n=len(rec.live),
                trace_ids=[r.trace_id for r in rec.live], **self._span_tags):
            self._respond(rec.bucket, rec.shape, rec.live, coords, conf, stress, rec.n_real,
                          done_at, exit_depth=exit_depth)

    def _wait_realized(self, rec: _InFlight):
        """`_realize` of one batch in flight under the watchdog, its window
        measured from when the settle thread reaches it: a wedged batch
        fires its own watchdog, and the neighbour behind it starts afresh."""
        return self._watched(lambda: self._realize(rec.out), bucket=rec.bucket, idx=rec.idx,
                             trace_ids=[r.trace_id for r in rec.live],
                             thread="af2-settle-wait", what="in-flight realization")

    def _abort_settle(self, cause: BaseException):
        # the flag first: the worker's bounded acquire watches it
        self._settle_dead = True
        with self._inflight_lock:
            self._closed = True
        traceback.print_exc()
        err = PredictionError(f"serving settle thread crashed: {type(cause).__name__}: "
                              f"{cause}; engine is closed")
        err.__cause__ = cause
        while True:
            try:
                rec = self._settle_queue.get_nowait()
            except queue.Empty:
                break
            if rec is _SETTLE_STOP:
                continue
            self._inflight_sem.release()
            self.metrics.pipeline_inflight_delta(-1)
            for req in rec.live:
                if self._resolve(req, exc=err):
                    self.metrics.inc("failed")
                    self.metrics.inc_error(err)

    def _bill_batch(self, bucket, shape, exec_s, live, exit_depth):
        """Charge a batch's seconds to its cost cells (JAX's `_bill_batch`).
        Without early exit the (bucket, rung) cell takes them all. With it,
        the live requests grouped by exit depth split `exec_s` in proportion
        to each group's forward FLOPs over the per-exit-depth cells (full
        depth: the plain cell); the shares sum to exec_s, so the ledger's
        chip-seconds total stays the device time."""
        if exit_depth is None or not self._exit_cells:
            self.costs.observe_batch(self._cost_cells[(bucket, shape)],
                                     device_seconds=exec_s, requests=len(live))
            return
        full_flops = self._depth_flops[(bucket, self.model_cfg.depth)]
        groups = {}
        for i in range(len(live)):
            d = int(exit_depth[i])
            groups[d] = groups.get(d, 0) + 1
        total_w = sum(self._depth_flops.get((bucket, d), full_flops) * n
                      for d, n in groups.items())
        for d, n in sorted(groups.items()):
            cell = self._exit_cells.get((bucket, d, shape), self._cost_cells[(bucket, shape)])
            w = self._depth_flops.get((bucket, d), full_flops) * n
            share = exec_s * (w / total_w) if total_w else 0.0
            self.costs.observe_batch(cell, device_seconds=share, requests=n)

    def _respond(self, bucket, shape, live, coords, conf, stress, n_real, done_at,
                 exit_depth=None):
        for i, req in enumerate(live):
            L = req.length
            # copies, not views: a view would pin the batch array in the
            # cache and let a client's edit reach later hits
            conf_i = conf[i, :L].copy()
            result = PredictionResult(
                seq=req.seq, coords=coords[i, :L].copy(), confidence=conf_i,
                stress=float(stress[i]), bucket=bucket, from_cache=False,
                latency_s=done_at - req.submitted_at, replica=self.replica_name,
                trace_id=req.trace_id, mean_confidence=float(conf_i.mean()) if L else 0.0,
                exit_depth=int(exit_depth[i]) if exit_depth is not None else 0,
            )
            self._cache.put(req.cache_key, result)
            if self._resolve(req, result=result):
                self.metrics.inc("completed")
                self.metrics.latency.observe(result.latency_s)
        self.metrics.observe_batch(n_real, shape, latency_s=done_at - live[0].submitted_at)
