"""Fleet tier: N engine replicas, one admission-controlled front door.

The port's copy of alphafold2_tpu/serving/fleet.py: the same names,
messages, metric names, terminal outcomes and counters, over the port's
`ServingEngine` (serving/engine.py). Departures:

  * replicas run on one `device` (default: the card), which the default
    factory passes to every engine it builds. N replicas on one card add
    failover and capture isolation, not card capacity: the card's lock
    (serving/executable.py `device_lock`) serializes their device work,
    so a replica captures a new (bucket, rung) while others serve;
  * an engine the fleet drains or shuts down has its graphs released
    under the card's lock (`ServingEngine.release_graphs`);
  * the artifact-store tag names the dispatch routes of that device
    (ops/dispatch.py `resolution_tag`), so results a CPU fleet stored
    never serve a card fleet;
  * an SP pool's replicas (`PoolSpec(sp_shards=)`) build their meshes on
    `sp_devices` (default: that many distinct cards; every shard must lie
    on the fleet's device, the engine's rule), and the hedge waste of an SP
    replica is billed by the cards its mesh occupies (`ServingEngine.
    chips`), not by its shard count.

The single engine is one warm model in one process — a single hung batch,
poisoned executable, or slow compile stalls the whole tier. This module
is the robustness half of the ParaFold pool story (arxiv 2111.06340):
a replicated tier that keeps answering, degrades predictably, and treats
replica death as routine traffic management rather than an outage.

Architecture (three cooperating layers, each independently testable):

  `serving/admission.py`   the shared front door: priority classes,
                           per-request deadlines, structured shedding
                           with `retry_after_s`.
  this module              the router: a dispatcher thread pulls from
                           the admission queue and places requests on
                           the least-loaded HEALTHY replica; completion
                           callbacks (the `add_done_callback` seam on
                           `ServingRequest`) either resolve the client
                           future or REQUEUE the request onto another
                           replica (bounded by `requeue_limit`).
  `reliability/health.py`  the supervisor: dispatch-failure evidence and
                           heartbeat probes drain a sick replica (its
                           engine is shut down drain=False, which fails
                           its queued work back through the requeue
                           path — nothing is lost), and re-probes
                           reinstate it behind a fresh engine.

Requeue is IDEMPOTENT by construction: a structure is a deterministic
function of (sequence, bucket) under a shared config tag
(serving/cache.py), so replaying a request on a different replica
returns bit-identical results — pinned by tests against the
single-engine path. Fleet latency/cache stats count each request once,
at its terminal outcome.

Degraded mode: with `degraded_mds_iters` and/or `degraded_weight_dtype`
set, the fleet holds one extra engine at a cheaper config tag (fewer MDS
iterations, and/or int8 PTQ trunk weights — serving/quant_residency.py —
a second tenant of the result-cache keyspace at ~1/4 the weight
residency). It takes traffic only when every full replica is down or the
queue is past `degrade_depth`, and every response it serves is flagged
`degraded=True` — the client always knows which answer it got.

Every replica breaker gets seeded `breaker_jitter` with a per-replica
seed, so a fleet-wide dependency failure does not re-probe in lockstep.

Terminal outcomes are exhaustive: every accepted request ends exactly
one of served / served-degraded / shed-with-structured-error / failed —
the chaos suite drives kill/slow/flap plans through `serve.py
--replicas --fault-plan` and asserts zero lost requests.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Optional

from alphafold2_tpu_torch.constants import AA_ORDER
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.ops.dispatch import resolution_tag
from alphafold2_tpu_torch.reliability.health import HealthMonitor, ReplicaState
from alphafold2_tpu_torch.serving.admission import (
    AdmissionConfig,
    AdmissionController,
    resolve_priority,
)
from alphafold2_tpu_torch.serving.artifact_store import ArtifactStore
from alphafold2_tpu_torch.serving.bucketing import BucketLadder
from alphafold2_tpu_torch.serving.cache import request_key
from alphafold2_tpu_torch.serving.cascade import (
    CascadeLedger,
    CascadePolicy,
    CascadeVerdict,
    EntropyStressScorer,
)
from alphafold2_tpu_torch.serving.engine import (
    PredictionResult,
    ServingConfig,
    ServingEngine,
)
from alphafold2_tpu_torch.serving.frontdoor import FrontDoor
from alphafold2_tpu_torch.serving.journal import IntakeJournal
from alphafold2_tpu_torch.reliability.retry_budget import RetryBudget
from alphafold2_tpu_torch.serving.errors import (
    CircuitOpenError,
    EngineClosedError,
    HungBatchError,
    NoHealthyReplicaError,
    PredictionError,
    QueueFullError,
    RequestTimeoutError,
    RequeueLimitError,
    RetryBudgetExhaustedError,
    ScaleRejectedError,
    SequenceTooLongError,
    ServingError,
)
from alphafold2_tpu_torch.serving.featurize import (
    FeatureBundle,
    FeaturizeConfig,
    FeaturizePool,
    featurize_request,
)
from alphafold2_tpu_torch.telemetry import NULL_TRACER, MetricRegistry, new_trace_id
from alphafold2_tpu_torch.telemetry.costs import (
    ExecutableCostLedger,
    FlightBook,
    ServeGoodputLedger,
)

#: replica errors that justify trying ANOTHER replica — the replica (not
#: the request) is the suspect. Everything else is terminal for the
#: request itself.
_REPLICA_FAULT_ERRORS = (
    PredictionError,
    HungBatchError,
    EngineClosedError,
    CircuitOpenError,
)

DEGRADED = "degraded"  # reserved tier name (not a health-managed replica)


def _chips(rep) -> int:
    """The cards a replica's dispatch occupies (`ServingEngine.chips`: an
    SP mesh's distinct cards); an engine from a custom factory without it
    counts its shards, the JAX fleet's rule."""
    chips = getattr(rep.engine, "chips", None)
    return chips if chips is not None else max(1, rep.cfg.sp_shards or 1)


def _release_graphs(engine, timeout):
    """Free a shut-down engine's graphs under the card's lock
    (`ServingEngine.release_graphs`), so its blocks return to the card's
    pool and no collection on another thread destroys a graph while a
    replica captures; an engine from a custom factory may lack it."""
    release = getattr(engine, "release_graphs", None)
    if release is not None:
        release(timeout)

DEFAULT_POOL = "default"  # implicit pool name for homogeneous fleets


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One capability pool: replicas sharing a (weight_dtype x sp_shards
    x bucket ceiling) capability tag: the generalization of the int8
    arm's multi-precision residency into heterogeneous-replica residency.

    The fleet routes each request to the CHEAPEST pool whose ceiling
    covers its length — pools are preferred in (bucket-ceiling ascending,
    declaration order), so short sequences land on dense/int8 replicas
    and only the lengths that need it reach the SP-sharded pool.
    `weight_dtype`/`buckets` left at their defaults inherit the fleet's
    base configs; the SP knobs are POOL-OWNED — with pools configured the
    base ServingConfig must keep sp_shards=0 (the fleet rejects the
    ambiguous combination loudly)."""

    name: str
    replicas: int = 1
    weight_dtype: str = ""       # "int8"/"f32"; "" inherits the model cfg
    sp_shards: int = 0           # >1: this pool's engines run the SP arm
    buckets: Optional[tuple] = None  # pool bucket ladder; None inherits
    sp_schedules: tuple = ()     # per-bucket SP overrides ((bucket,
    #                              schedule), ...); () defers to the base
    #                              config's overrides (ladder-filtered)
    #                              and the residency heuristic
    # per-pool fidelity knobs (the cascade's draft tier: int8 weights via
    # weight_dtype above, FEWER MDS ITERATIONS, REDUCED MSA ROWS, and
    # trunk-depth early exit — serving/cascade.py). Each knob also moves
    # the pool's store tag, so cheaper results never alias dearer ones.
    mds_iters: int = 0           # >0 overrides the base ServingConfig
    msa_rows: Optional[int] = None  # None inherits; 0 drops the MSA
    #                              stream entirely; >0 truncates riding
    #                              FeatureBundles to the top rows
    early_exit_depths: tuple = ()   # >= 2 checkpoint depths arm the
    early_exit_kl: float = 0.0      # delta-KL trunk early exit

    def __post_init__(self):
        if not self.name or self.name == DEGRADED:
            raise ValueError(
                f"pool name must be non-empty and not {DEGRADED!r}, "
                f"got {self.name!r}"
            )
        if self.replicas < 1:
            raise ValueError(
                f"pool {self.name!r}: replicas must be >= 1, "
                f"got {self.replicas}"
            )
        if self.weight_dtype not in ("", "f32", "int8"):
            raise ValueError(
                f"pool {self.name!r}: weight_dtype must be '', 'f32', or "
                f"'int8', got {self.weight_dtype!r}"
            )
        if self.sp_shards < 0 or self.sp_shards == 1:
            raise ValueError(
                f"pool {self.name!r}: sp_shards must be 0 or >= 2, "
                f"got {self.sp_shards}"
            )
        if self.buckets is not None:
            object.__setattr__(
                self, "buckets", tuple(int(b) for b in self.buckets))
            if not self.buckets:
                raise ValueError(
                    f"pool {self.name!r}: buckets must be None (inherit) "
                    f"or non-empty"
                )
        object.__setattr__(
            self, "sp_schedules",
            tuple((int(b), str(s)) for b, s in self.sp_schedules))
        if self.sp_schedules and not self.sp_shards:
            raise ValueError(
                f"pool {self.name!r}: sp_schedules without sp_shards"
            )
        if self.mds_iters < 0:
            raise ValueError(
                f"pool {self.name!r}: mds_iters must be >= 0 "
                f"(0 inherits), got {self.mds_iters}"
            )
        if self.msa_rows is not None and self.msa_rows < 0:
            raise ValueError(
                f"pool {self.name!r}: msa_rows must be None (inherit) "
                f"or >= 0, got {self.msa_rows}"
            )
        object.__setattr__(
            self, "early_exit_depths",
            tuple(int(d) for d in self.early_exit_depths))
        # depth/kl consistency is ServingConfig.__post_init__'s job —
        # _pool_serving_cfg replaces these into the pool's config, which
        # re-validates


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet-level knobs; per-replica scheduler knobs stay in
    `ServingConfig`."""

    replicas: int = 2
    queue_capacity: int = 64     # shared admission queue bound
    default_timeout_s: Optional[float] = 60.0  # fleet-level deadline
    requeue_limit: int = 2       # replica failovers per request
    degraded_mds_iters: int = 0  # >0: hold a cheaper-tag fallback engine
    degraded_weight_dtype: str = ""  # "int8": the degraded tier serves
    #                              per-channel-PTQ int8 trunk weights
    #                              (ops/quant.py) — a precision degrade
    #                              that composes with degraded_mds_iters;
    #                              ""/"f32" keeps full-precision weights
    degrade_depth: int = 0       # queue depth that routes NEW work to the
    #                              degraded tier (0 = only on total outage)
    probe_interval_s: float = 5.0    # heartbeat cadence, healthy replicas
    reprobe_interval_s: float = 0.5  # reinstatement probe cadence, down
    probe_timeout_s: float = 10.0
    fail_threshold: int = 2      # consecutive failures that drain
    drain_timeout_s: float = 5.0
    breaker_jitter: float = 0.25  # seeded reopen spread per replica
    dispatch_backoff_s: float = 0.01  # router sleep when every target is full
    tick_interval_s: float = 0.05     # health thread granularity
    # CPU featurization tier (serving/featurize.py): >0 workers puts a
    # separately-sized feature-prep pool in FRONT of the admission queue
    # — raw-sequence submissions featurize there; pre-featurized bundles
    # bypass it. 0 = featurize inline on the submit thread (the pre-tier
    # behavior, bit-identical results).
    featurize_workers: int = 0
    featurize_queue: int = 128
    featurize_retry_limit: int = 1    # worker-death requeues per job
    # Heterogeneous capability pools: () = one implicit
    # pool of `replicas` base-config engines (the pre-pool fleet,
    # behavior-identical). Non-empty REPLACES `replicas`: each PoolSpec
    # sizes and capability-tags its own slice of the fleet, routing
    # prefers the cheapest capable pool, and the per-pool autoscalers
    # scale each pool off its own queue-wait signal.
    pools: tuple = ()
    # Fleet-wide retry budget: >0 arms a token bucket (one per
    # fleet, reliability/retry_budget.py) that featurize requeues,
    # replica-failover requeues, and hedged dispatches ALL draw from,
    # refilled `retry_budget_refill` tokens per successful completion. A
    # drained bucket degrades retries into fast typed
    # RetryBudgetExhaustedError sheds instead of a retry storm. 0 keeps
    # retries unmetered (the pre-budget fleet, behavior-identical).
    retry_budget_capacity: int = 0
    retry_budget_refill: float = 0.1
    # Hedged dispatch: >0 arms a hedge timer — a dispatch
    # outstanding longer than `hedge_p95_factor` x its pool's service-time
    # p95 (floored at `hedge_min_delay_s`, armed only after
    # `hedge_min_samples` completions have been measured) gets ONE
    # budgeted duplicate dispatch on another healthy capable replica;
    # first settle wins, the loser's chip-seconds count into
    # `hedge_wasted_chip_seconds_total`. Total hedges stay under
    # `hedge_rate_cap` x dispatches. 0 disables hedging entirely.
    hedge_p95_factor: float = 0.0
    hedge_min_delay_s: float = 0.05
    hedge_rate_cap: float = 0.1
    hedge_min_samples: int = 8
    # Adaptive-fidelity cascade (serving/cascade.py): a
    # CascadePolicy routes eligible requests through a DRAFT pool first
    # (named by policy.draft_pool — must be one of `pools`), scores the
    # draft with a ConfidenceScorer, and escalates only low-confidence
    # results to the remaining full-fidelity pools with the request's
    # FeatureBundle riding. None keeps static pool routing
    # (behavior-identical to the pre-cascade fleet).
    cascade_policy: Optional["CascadePolicy"] = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.pools:
            object.__setattr__(self, "pools", tuple(self.pools))
            names = [p.name for p in self.pools]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate pool name in {names}")
        if self.requeue_limit < 0:
            raise ValueError(
                f"requeue_limit must be >= 0, got {self.requeue_limit}"
            )
        if self.degraded_mds_iters < 0 or self.degrade_depth < 0:
            raise ValueError("degraded knobs must be >= 0")
        if self.degraded_weight_dtype not in ("", "f32", "int8"):
            raise ValueError(
                f"degraded_weight_dtype must be '', 'f32', or 'int8', "
                f"got {self.degraded_weight_dtype!r}"
            )
        if self.featurize_workers < 0 or self.featurize_queue < 1:
            raise ValueError(
                "featurize_workers must be >= 0 and featurize_queue >= 1, "
                f"got {self.featurize_workers}/{self.featurize_queue}"
            )
        if self.retry_budget_capacity < 0:
            raise ValueError(
                f"retry_budget_capacity must be >= 0, "
                f"got {self.retry_budget_capacity}"
            )
        if not (0.0 < self.retry_budget_refill <= 1.0):
            raise ValueError(
                f"retry_budget_refill must be in (0, 1], "
                f"got {self.retry_budget_refill}"
            )
        if self.hedge_p95_factor < 0:
            raise ValueError(
                f"hedge_p95_factor must be >= 0 (0 disables hedging), "
                f"got {self.hedge_p95_factor}"
            )
        if self.hedge_min_delay_s <= 0 or self.hedge_min_samples < 1:
            raise ValueError(
                "hedge_min_delay_s must be > 0 and hedge_min_samples >= 1, "
                f"got {self.hedge_min_delay_s}/{self.hedge_min_samples}"
            )
        if not (0.0 < self.hedge_rate_cap <= 1.0):
            raise ValueError(
                f"hedge_rate_cap must be in (0, 1], "
                f"got {self.hedge_rate_cap}"
            )
        if self.cascade_policy is not None:
            names = [p.name for p in self.pools]
            if not names:
                raise ValueError(
                    "cascade_policy requires explicit capability pools "
                    "(FleetConfig.pools) — the draft tier is a pool"
                )
            if self.cascade_policy.draft_pool not in names:
                raise ValueError(
                    f"cascade draft_pool "
                    f"{self.cascade_policy.draft_pool!r} is not a "
                    f"configured pool (pools: {names})"
                )
            if len(names) < 2:
                raise ValueError(
                    "the cascade needs at least one full-fidelity pool "
                    "besides the draft pool — escalations would have "
                    "nowhere to go"
                )


class FleetRequest:
    """Client handle: one future, resolved exactly once by the fleet.

    Duck-typed for the admission queue (`priority` / `deadline` /
    `enqueued_at`); `requeues` counts replica failovers survived."""

    def __init__(self, seq: str, msa, msa_mask, priority: int,
                 deadline: Optional[float], trace_id: str = "",
                 features: Optional[FeatureBundle] = None):
        self.seq = seq
        self.msa = msa
        self.msa_mask = msa_mask
        self.features = features   # set by the featurize tier (or caller)
        self.priority = priority
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        # minted HERE (the fleet front door) and handed to every engine
        # submit this request makes — admission queueing, routing, and
        # requeues onto other replicas all carry ONE id
        self.trace_id = trace_id or new_trace_id()
        self.requeues = 0
        self.pool = None         # preferred capability pool (set at admit)
        # artifact-store identity, stamped at the front door: (store tag,
        # content hash) — the waiter-registry key this request leads or
        # follows, and the address its result persists under
        self.store_key = None
        self.coalesced = False   # True: follower of an in-flight leader
        self.feat_store_key = None  # (tag, hash) to persist features under
        self.failed_on = set()   # replica names this request failed on
        self.last_error: Optional[BaseException] = None
        self.hedges = 0          # hedged duplicate dispatches issued
        # dispatches currently outstanding on replicas (fleet-lock
        # guarded): with hedging, a failed twin must defer to the one
        # still in flight instead of requeueing a request that may win
        self.inflight_dispatches = 0
        # cascade state (serving/cascade.py; "" when the cascade is off):
        # tier is "draft" while the draft leg is pending, "full" after
        # bypass/promotion/escalation; escalated marks a rejected draft;
        # draft_accepted gates what may persist under the draft store tag
        self.tier = ""
        self.escalated = False
        self.draft_accepted = False
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[PredictionResult] = None
        self._meta = {}
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _finish(self, result=None, exc=None, **meta) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._result, self._exc, self._meta = result, exc, meta
            self._event.set()
            return True

    def result(self, timeout: Optional[float] = None) -> PredictionResult:
        """Block for the outcome; raises the terminal ServingError, or
        builtin TimeoutError if the CALLER's wait budget expires first.
        Returns a fresh copy stamped with fleet provenance (replica,
        degraded, requeues) — the raw result may alias a replica cache
        entry and is never handed out."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"fleet request ({len(self.seq)} residues) not completed "
                f"within {timeout}s wait"
            )
        if self._exc is not None:
            raise self._exc
        return dataclasses.replace(
            self._result,
            coords=self._result.coords.copy(),
            confidence=self._result.confidence.copy(),
            latency_s=self._meta.get("latency_s", self._result.latency_s),
            replica=self._meta.get("replica", ""),
            degraded=self._meta.get("degraded", False),
            requeues=self.requeues,
            trace_id=self.trace_id,
            tier=self._meta.get("tier", ""),
        )


class _Replica:
    """One engine slot; the engine reference swaps across drain/restart
    cycles (guarded by the fleet lock)."""

    def __init__(self, name: str, index: int, cfg: ServingConfig,
                 pool: str = DEFAULT_POOL):
        self.name = name
        self.index = index       # monotone creation index (victim ranking)
        self.cfg = cfg           # live: rolling updates swap it in place
        self.pool = pool         # capability pool this slot belongs to
        self.factory = None      # () -> ServingEngine; reads self.cfg
        self.engine: Optional[ServingEngine] = None
        self.retiring = False    # deliberate removal in progress
        self.in_flight = 0
        self.dispatches = 0
        self.probe_counter = 0
        self.restarts = 0


class _Pool:
    """Runtime view of one capability pool (spec + derived capability)."""

    def __init__(self, spec: PoolSpec, rank: int, ladder: BucketLadder):
        self.spec = spec
        self.name = spec.name
        self.rank = rank          # routing preference (ceiling-ascending)
        self.ladder = ladder
        self.service_ema_s: Optional[float] = None  # drain-rate EMA

    @property
    def max_len(self) -> int:
        return self.ladder.max_len


class ServingFleet:
    """N `ServingEngine` replicas behind one admission-controlled queue.

    Args:
      params / model_cfg / serving_cfg: as `ServingEngine` — every
        replica shares them (and therefore the cache-key config tag:
        the idempotency contract failover depends on).
      fleet_cfg: `FleetConfig`.
      engine_factory: override `(name, serving_cfg, fault_hook) ->
        ServingEngine` — tests substitute fake engines; the default
        builds real ones over `params`.
      injector: optional `reliability.FaultInjector`; each replica gets
        `injector.replica_hook(name)` so kill/slow/flap plans target
        replicas by name.
      tracer / registry: fleet-level telemetry (replica engines keep
        their own `ServingMetrics`; the fleet registry carries the
        fleet_* metric families).
      incident_hook: optional `fn(kind, **attrs)` — the flight-recorder
        seam (telemetry/ops_plane.py). The fleet reports
        `replica_drain` itself and threads the hook into every
        default-factory engine (breaker_open / watchdog_fire); custom
        `engine_factory` callers wire their own engines.
      device: where the default factory's engines serve (default: the
        card; "cpu" runs eager).
      sp_devices: the device list the default factory's SP engines build
        their meshes on (each takes its first `sp_shards` entries; None:
        that many distinct cards).
    """

    def __init__(self, params, model_cfg,
                 serving_cfg: ServingConfig = ServingConfig(),
                 fleet_cfg: FleetConfig = FleetConfig(), *,
                 engine_factory=None, model_apply_fn=None, injector=None,
                 tracer=None, registry: Optional[MetricRegistry] = None,
                 incident_hook=None,
                 artifact_store: Optional[ArtifactStore] = None,
                 journal: Optional[IntakeJournal] = None,
                 cascade_scorer=None, device=None, sp_devices=None):
        self.cfg = fleet_cfg
        # every default-factory replica serves here (engines take no
        # device of their own choosing: one card, N replicas)
        self.device = resolve_device(device)
        self.sp_devices = None if sp_devices is None else list(sp_devices)
        self._params = params
        self._model_cfg = model_cfg
        self._serving_cfg = serving_cfg
        self._model_apply_fn = model_apply_fn
        self._injector = injector
        # ---- capability pools ----
        # no explicit pools = ONE implicit pool of base-config replicas
        # (the pre-pool fleet, behavior-identical); explicit pools replace
        # `replicas` and give the router a capability table. Preference is
        # (bucket ceiling ascending, declaration order): short work lands
        # on the cheapest capable pool, the SP pool keeps its headroom.
        self._implicit_pools = not fleet_cfg.pools
        if fleet_cfg.pools and serving_cfg.sp_shards:
            # with pools configured, the SP knob belongs to the PoolSpecs
            # (each pool declares its own sp_shards/sp_schedules): a base
            # sp_shards would silently apply to the degraded tier but not
            # the pools — reject the ambiguity instead of guessing
            raise ValueError(
                "ServingConfig.sp_shards and FleetConfig.pools are "
                "mutually exclusive — declare sp_shards per PoolSpec"
            )
        specs = fleet_cfg.pools or (
            PoolSpec(DEFAULT_POOL, replicas=fleet_cfg.replicas),)
        base_buckets = serving_cfg.buckets
        ordered = sorted(
            enumerate(specs),
            key=lambda iv: (max(iv[1].buckets or base_buckets), iv[0]),
        )
        self._pools = {}
        for rank, (_, spec) in enumerate(ordered):
            self._pools[spec.name] = _Pool(
                spec, rank, BucketLadder(spec.buckets or base_buckets))
        # the union ladder: featurization + the too-long check run against
        # what the WHOLE fleet can serve — `bucket_for` past its top is the
        # sharp sequence_too_long signal (no capable pool exists)
        union = sorted({b for p in self._pools.values()
                        for b in p.ladder.buckets})
        self._ladder = BucketLadder(tuple(union))
        self._replica_pool = {}   # replica name -> pool name (never reused)
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry if registry is not None else MetricRegistry()
        self._incident_hook = incident_hook
        self._factory = engine_factory or self._default_factory

        # ---- adaptive-fidelity cascade (serving/cascade.py) ----
        # None keeps static pool routing (behavior-identical). Armed, the
        # draft pool takes every eligible request first; the scorer's
        # verdict on each draft decides accept vs escalate in
        # _on_replica_done, and _route/_admit keep the tiers disjoint.
        self._cascade: Optional[CascadePolicy] = fleet_cfg.cascade_policy
        self._cascade_scorer = None
        self._cascade_ledger: Optional[CascadeLedger] = None
        if self._cascade is not None:
            self._cascade_scorer = (
                cascade_scorer if cascade_scorer is not None
                else EntropyStressScorer(self._cascade))
            self._cascade_ledger = CascadeLedger(self.registry)

        # ---- fleet-wide artifact store + front-door coalescing ----
        # None keeps the pre-store fleet behavior-identical;
        # with a store, submissions consult it (and register in the
        # coalescing waiter registry) at `_admit`, BEFORE pool routing.
        # The store's metric families land in the FLEET registry so one
        # /metrics scrape carries both.
        self._store = artifact_store
        self._frontdoor = (FrontDoor(self.registry)
                           if artifact_store is not None else None)
        if self._store is not None:
            self._store.bind_registry(self.registry)
            self._store.set_current_tags(self._current_store_tags())

        # ---- durable intake journal ---- None keeps the
        # in-memory-only request plane. With a journal, every accepted
        # request is durably recorded at submit and settled (record
        # unlinked) at its terminal path — `replay_journal()` after a
        # restart pushes unsettled records back through submit, where
        # front-door coalescing + the artifact store make the replay
        # idempotent (at-least-once accepted->terminal, zero duplicate
        # chip dispatch).
        self._journal = journal
        if journal is not None:
            journal.bind_registry(self.registry)

        # ---- fleet-wide retry budget ---- one bucket for
        # every internal retry kind; None = unmetered (pre-budget
        # behavior). Lives in the fleet registry so /metrics carries the
        # retry_budget_* families.
        self._budget: Optional[RetryBudget] = None
        if fleet_cfg.retry_budget_capacity > 0:
            self._budget = RetryBudget(
                fleet_cfg.retry_budget_capacity,
                refill_ratio=fleet_cfg.retry_budget_refill,
            ).bind_registry(self.registry)

        # ---- serving cost & profiling plane (telemetry/costs.py) ----
        # always on (dict bookkeeping, no model cost): the shared
        # per-executable cost ledger (every replica of a pool merges into
        # one cell), the per-replica goodput ledger (the fleet layers
        # probe/drain on what the engines account), and the exemplar
        # flight book behind /explainz
        self.costs = ExecutableCostLedger(self.registry)
        self.goodput = ServeGoodputLedger(self.registry)
        self.flights = FlightBook()
        # per-pool arrival tracking for the headroom model: counts at
        # _admit (preferred-pool key), rates derived in sample_gauges
        self._arrivals_lock = threading.Lock()
        self._arrivals = {name: 0 for name in self._pools}
        self._arrival_rate = {}   # pool -> {"count", "ts", "ema"}
        self._last_headroom = {}  # pool -> headroom model (sample_gauges)

        self._lock = threading.Lock()
        self._closed = False
        self._drain_on_stop = True
        self._stop = threading.Event()

        # ---- telemetry families (the acceptance surface) ----
        self._counts = {
            name: self.registry.counter(
                "fleet_requests_total", help="fleet request terminal outcomes",
                outcome=name)
            for name in ("submitted", "completed", "shed", "failed")
        }
        self._degraded_total = self.registry.counter(
            "fleet_degraded_total", help="responses served by the degraded tier")
        self._requeue_total = self.registry.counter(
            "fleet_requeue_total", help="replica-failover requeues")
        self._shed_reasons = {}   # reason -> counter (lazy)
        self._errors = {}         # stable code -> counter (lazy)
        self._queue_wait = self.registry.histogram(
            "fleet_queue_wait_seconds",
            help="admission-queue wait, sliding window (p95 is the "
                 "autoscaling signal)")
        self._latency = self.registry.histogram(
            "fleet_request_latency_seconds",
            help="fleet submit->terminal latency, sliding window")
        self._up_gauges = {}

        # ---- live queue/occupancy gauges (sample_gauges ticker hook) ----
        self._queue_depth_gauge = self.registry.gauge(
            "fleet_queue_depth",
            help="live admission-queue depth (sampled by the ops ticker "
                 "so scrapes see pressure between requests)")
        self._service_ema_gauge = self.registry.gauge(
            "fleet_service_ema_seconds",
            help="admission drain-rate EMA (per-request service seconds)")
        self._occupancy_gauge = self.registry.gauge(
            "fleet_occupancy",
            help="dispatched requests per slot of healthy replica "
                 "capacity (the autoscaler's load signal)")
        self._replicas_gauge = self.registry.gauge(
            "fleet_replicas", help="current (non-retiring) replica count")

        # ---- per-capability-pool telemetry (the length-adaptive router's
        # observability + the per-pool autoscalers' signals) ----
        self._routed = {}         # pool -> fleet_routed_total counter (lazy)
        self._pool_wait = {
            name: self.registry.histogram(
                "fleet_pool_queue_wait_seconds",
                help="admission wait of requests dispatched to this "
                     "capability pool (p95 is the per-pool autoscaling "
                     "signal)", pool=name)
            for name in self._pools
        }
        self._pool_depth_g = {
            name: self.registry.gauge(
                "fleet_pool_queue_depth",
                help="queued requests whose preferred capability pool is "
                     "this one (sampled each ops tick)", pool=name)
            for name in self._pools
        }
        self._pool_occ_g = {
            name: self.registry.gauge(
                "fleet_pool_occupancy",
                help="dispatched requests per slot of this pool's healthy "
                     "capacity", pool=name)
            for name in self._pools
        }
        self._pool_reps_g = {
            name: self.registry.gauge(
                "fleet_pool_replicas",
                help="current (non-retiring) replicas in this capability "
                     "pool", pool=name)
            for name in self._pools
        }

        # ---- hedged dispatch ---- per-pool replica SERVICE
        # time (dispatch->completion, excludes queue wait: the hedge
        # delay must measure how long a dispatch should take, not how
        # long the queue was) + the outstanding-dispatch registry the
        # hedge timer scans. `_hedge_lock` is a LEAF lock: dict ops only,
        # never held across a call out, never nested with `_lock`.
        self._pool_service = {
            name: self.registry.histogram(
                "fleet_pool_service_seconds",
                help="replica service time (dispatch->completion) per "
                     "capability pool; its p95 derives the hedge delay",
                pool=name)
            for name in self._pools
        }
        self._hedge_lock = threading.Lock()
        self._outstanding = {}   # id(entry) -> primary-dispatch state
        self._hedges_issued = 0  # lifetime, under _hedge_lock
        self._hedge_denied = {}  # reason -> count, under _hedge_lock
        self._hedge_counters = {}  # pool -> fleet_hedge_total, under _lock
        self._dispatch_count = 0  # lifetime dispatches, under _lock
        self._hedge_waste = self.registry.counter(
            "hedge_wasted_chip_seconds_total",
            help="chip-seconds spent by the LOSING side of hedged "
                 "dispatch pairs (the price of the tail-latency cut)")

        # ---- replicas + health ----
        self._admission = AdmissionController(
            AdmissionConfig(capacity=fleet_cfg.queue_capacity))
        self._health = HealthMonitor(
            probe_interval_s=fleet_cfg.probe_interval_s,
            reprobe_interval_s=fleet_cfg.reprobe_interval_s,
            fail_threshold=fleet_cfg.fail_threshold,
        )
        self._replicas = {}
        self._replica_seq = 0
        self._autoscaler = None
        self._pool_autoscalers = {}
        self._last_gauge_sample = -1.0  # sample_gauges dedupe timestamp
        for pool in self._pools.values():
            for _ in range(pool.spec.replicas):
                self._spawn_replica(pool.name)

        # ---- CPU featurization tier (serving/featurize.py) ----
        self._featurize: Optional[FeaturizePool] = None
        if fleet_cfg.featurize_workers > 0:
            self._featurize = FeaturizePool(
                FeaturizeConfig(
                    workers=fleet_cfg.featurize_workers,
                    queue_capacity=fleet_cfg.featurize_queue,
                    retry_limit=fleet_cfg.featurize_retry_limit,
                ),
                self._ladder, msa_rows=serving_cfg.msa_rows,
                registry=self.registry, tracer=self._tracer,
                fault_hook=(injector.featurize_hook()
                            if injector is not None else None),
                incident_hook=self._incident_hook,
                retry_budget=self._budget,
            )

        self._degraded_rep: Optional[_Replica] = None
        # the degraded tier can be cheaper on MDS iterations, on weight
        # precision (int8 PTQ trunk), or both — either knob arms it. Its
        # model config diverges from the full replicas' exactly when the
        # precision knob is set, which moves it to its own config tag
        # (results can never alias the full-precision cache keyspace).
        self._degraded_model_cfg = self._model_cfg
        if fleet_cfg.degraded_weight_dtype == "int8":
            self._degraded_model_cfg = dataclasses.replace(
                model_cfg, weight_dtype="int8")
        # the degraded tier serves only lengths ITS ladder (the base
        # serving config's) covers — with wider capability pools
        # configured, a long request must shed rather than silently land
        # on a tier that cannot bucket it
        self._degraded_ladder = BucketLadder(serving_cfg.buckets)
        if (fleet_cfg.degraded_mds_iters
                or fleet_cfg.degraded_weight_dtype == "int8"):
            dcfg = serving_cfg
            if fleet_cfg.degraded_mds_iters:
                dcfg = dataclasses.replace(
                    serving_cfg, mds_iters=fleet_cfg.degraded_mds_iters)
            self._degraded_rep = _Replica(DEGRADED, -1, dcfg, pool=DEGRADED)
            self._degraded_rep.factory = self._make_factory(
                self._degraded_rep)
            self._degraded_rep.engine = self._degraded_rep.factory()

        self._health.start(fleet_cfg.tick_interval_s)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="af2-fleet-dispatcher",
            daemon=True)
        self._dispatcher.start()
        self._hedger: Optional[threading.Thread] = None
        if fleet_cfg.hedge_p95_factor > 0:
            self._hedger = threading.Thread(
                target=self._hedge_loop, name="af2-fleet-hedger",
                daemon=True)
            self._hedger.start()

    # ------------------------------------------------------------ factories

    def _pool_serving_cfg(self, pool: "_Pool") -> ServingConfig:
        """The pool's ServingConfig, derived LIVE from the fleet template
        (so rolling updates that retag the template reach every pool).
        The implicit pool inherits the base config untouched."""
        base = self._serving_cfg
        if self._implicit_pools:
            return base
        spec = pool.spec
        buckets = spec.buckets or base.buckets
        # per-bucket SP overrides: the pool's own first, else the base
        # config's filtered to this pool's ladder; a dense pool carries
        # none (sp_schedules without sp_shards is a config error)
        if not spec.sp_shards:
            sp_scheds = ()
        elif spec.sp_schedules:
            sp_scheds = spec.sp_schedules
        else:
            sp_scheds = tuple((b, s) for b, s in base.sp_schedules
                              if b in buckets)
        return dataclasses.replace(
            base, buckets=buckets, sp_shards=spec.sp_shards,
            sp_schedules=sp_scheds,
            mds_iters=spec.mds_iters or base.mds_iters,
            msa_rows=(base.msa_rows if spec.msa_rows is None
                      else spec.msa_rows),
            early_exit_depths=(spec.early_exit_depths
                               or base.early_exit_depths),
            early_exit_kl=(spec.early_exit_kl if spec.early_exit_depths
                           else base.early_exit_kl))

    def _pool_model_cfg(self, pool: "_Pool"):
        """The pool's Alphafold2Config (weight-precision arm), derived
        LIVE from the fleet master config."""
        if self._implicit_pools or not pool.spec.weight_dtype:
            return self._model_cfg
        return dataclasses.replace(
            self._model_cfg, weight_dtype=pool.spec.weight_dtype)

    def _pool_capability(self, pool: "_Pool") -> dict:
        """The pool's capability tag (what its engines CAN serve) — the
        router's table, surfaced in stats()/statusz so an operator can
        see why a request went where it did."""
        cfg = self._pool_serving_cfg(pool)
        return {
            "weight_dtype": self._pool_model_cfg(pool).weight_dtype,
            "sp_shards": cfg.sp_shards,
            "max_len": pool.max_len,
        }

    # ------------------------------------------------- artifact-store tags

    def _store_tag(self, pool_name: str) -> str:
        """The fleet-level store tag for one capability pool: the
        `request_key` config tag extended with the dispatch
        `resolution_tag` of the fleet's device and the deploy's `params_tag`, plus
        every other knob that moves the numerics a pool's engines
        produce (model config incl. the pool's weight precision, MDS
        knobs, seed, the pool's bucket ladder, and the SP plan inputs).
        Derived LIVE from the fleet template, so `rolling_update`'s
        retag re-keys the whole fleet tier exactly like it re-keys the
        per-engine LRUs — old-tag entries become unreachable, never
        stale answers."""
        pool = self._pools[pool_name]
        cfg = self._pool_serving_cfg(pool)
        mcfg = self._pool_model_cfg(pool)
        parts = (
            mcfg, cfg.mds_iters, cfg.mds_init, cfg.seed, cfg.msa_rows,
            cfg.params_tag, tuple(pool.ladder.buckets),
            resolution_tag(self.device), cfg.sp_shards, cfg.sp_hbm_gb,
            tuple(sorted(cfg.sp_schedules)),
            cfg.early_exit_depths, cfg.early_exit_kl,
        )
        if self.cfg.cascade_policy is not None:
            # the cascade-tier component (the resolution_tag invariant
            # family): even if an operator arms
            # the cascade over numerically IDENTICAL pools, a draft-tier
            # result must never alias or serve a full-fidelity hit —
            # draft acceptance is a thresholded quality gate, not a
            # config equivalence
            role = ("cascade:draft"
                    if pool_name == self.cfg.cascade_policy.draft_pool
                    else "cascade:verify")
            parts = parts + (role,)
        return "af2store:" + repr(parts)

    def _feature_tag(self) -> str:
        """Feature bundles depend only on (union ladder, msa_rows) —
        deterministic host preprocessing, no params, no kernels — so
        their tag survives rolling updates: a redeploy invalidates
        results, not featurization."""
        return "af2feat:" + repr(
            (tuple(self._ladder.buckets), self._serving_cfg.msa_rows))

    def _current_store_tags(self) -> list:
        return ([self._store_tag(name) for name in self._pools]
                + [self._feature_tag()])

    def _default_factory(self, name, cfg, fault_hook):
        if name == DEGRADED:
            model_cfg = self._degraded_model_cfg
        else:
            model_cfg = self._pool_model_cfg(
                self._pools[self._replica_pool[name]])
        return ServingEngine(
            self._params, model_cfg, cfg, device=self.device,
            sp_devices=self.sp_devices if cfg.sp_shards else None,
            model_apply_fn=self._model_apply_fn,
            fault_hook=fault_hook, tracer=self._tracer,
            replica_name=name, incident_hook=self._incident_hook,
            # the shared cost plane: this replica's cells merge into its
            # pool's rows and its execute/compile/requeue seconds land in
            # the fleet-wide per-replica economy (the fleet itself adds
            # probe/drain). The flight book stays FLEET-owned — the
            # fleet sees the whole cross-replica flight.
            pool_name=(DEGRADED if name == DEGRADED
                       else self._replica_pool[name]),
            cost_ledger=self.costs, goodput=self.goodput,
        )

    def _make_factory(self, rep: _Replica):
        hook = (self._injector.replica_hook(rep.name)
                if self._injector is not None else None)

        def build():
            try:
                # rep.cfg is read at BUILD time, not closure time: a
                # rolling update swaps the cfg and cycles the replica
                # through the drain path — the reinstatement probe's
                # fresh engine picks up the new cfg (and the current
                # self._params master) automatically
                return self._factory(rep.name, rep.cfg, hook)
            except Exception:  # noqa: BLE001 — a failing restart is a
                # failed probe, not a fleet crash
                traceback.print_exc()
                return None

        return build

    def _spawn_replica(self, pool_name: str) -> _Replica:
        """Create, build, and register one replica in `pool_name`
        (ctor + add_replica). Builds the engine OUTSIDE the fleet lock
        (it may compile)."""
        with self._lock:
            pool = self._pools[pool_name]
            i = self._replica_seq
            self._replica_seq += 1
            name = f"r{i}"
            rcfg = dataclasses.replace(
                self._pool_serving_cfg(pool),
                breaker_jitter=(self.cfg.breaker_jitter
                                if self._serving_cfg.breaker_threshold
                                else 0.0),
                breaker_jitter_seed=i,
            )
            rep = _Replica(name, i, rcfg, pool=pool_name)
            # registered BEFORE the engine builds: the default factory
            # resolves the pool's model config through this map (names
            # are never reused, so entries never need removal)
            self._replica_pool[name] = pool_name
            rep.factory = self._make_factory(rep)
        # the goodput clock starts when the SLOT exists (engine build —
        # which may compile — is already on it); fleet-side so custom
        # engine_factory fleets keep per-replica accounts too
        self.goodput.register(name, pool_name)
        rep.engine = rep.factory()
        with self._lock:
            self._replicas[name] = rep
            gauge = self._up_gauges.get(name)
            if gauge is None:
                gauge = self.registry.gauge(
                    "fleet_replica_up", help="1 = taking traffic",
                    replica=name)
                self._up_gauges[name] = gauge
        gauge.set(1 if rep.engine is not None else 0)
        self._health.register(
            name,
            probe=lambda n=name: self._probe_replica(n),
            on_drain=self._drain_replica,
            on_reinstate=self._reinstate_replica,
        )
        return rep

    # ----------------------------------------------------------------- API

    def submit(self, seq: str, *, msa=None, msa_mask=None,
               timeout: Optional[float] = None,
               priority="normal", trace_id: str = "",
               features: Optional[FeatureBundle] = None) -> FleetRequest:
        """Enqueue one sequence at the fleet front door; returns a future.

        `trace_id` ("" mints one) correlates every span this request
        touches — across the featurize tier, the admission queue, the
        dispatcher, requeues, and every replica engine — and rides the
        result for log/trace cross-reference.

        With a featurize tier configured (`FleetConfig.featurize_workers`
        > 0) a RAW submission enters the CPU featurization pool first
        and reaches the admission queue from a pool worker — validation
        errors then resolve the returned future instead of raising here
        (the submit thread never blocks on feature prep). A
        pre-featurized `features` bundle BYPASSES the tier and keeps the
        fully-synchronous contract. Without a tier, featurization runs
        inline exactly as before.

        Raises EngineClosedError / InvalidSequenceError /
        RequestTooLongError / QueueFullError(retry_after_s) synchronously
        on the paths that validate synchronously (see above). A
        lower-priority queued request may be EVICTED (resolved with a
        retry-after error) to admit a higher-priority one.
        """
        trace_id = trace_id or new_trace_id()
        with self._tracer.span("fleet.enqueue", cat="fleet",
                               length=len(seq), trace_id=trace_id):
            if self._closed:
                raise EngineClosedError("fleet is shut down")
            ttl = (self.cfg.default_timeout_s if timeout is None else timeout)
            deadline = (time.monotonic() + ttl) if ttl is not None else None
            # exemplar flight record (telemetry/costs.py FlightBook —
            # the /explainz backing): born HERE, the fleet front door;
            # every hop below appends to it
            self.flights.begin(trace_id, length=len(seq),
                               priority=str(priority))

            # durable intake: record the request BEFORE any
            # work happens — validation included, so a crash mid-
            # featurize still replays (an invalid replay settles with
            # the same typed error it would have settled with now). The
            # journal stores the ABSOLUTE wall-clock deadline: a
            # relative one would silently extend across a restart.
            if self._journal is not None:
                self._journal.accept(
                    trace_id, seq, msa=msa, msa_mask=msa_mask,
                    priority=resolve_priority(priority),
                    deadline_unix=(time.time() + ttl
                                   if ttl is not None else None),
                    accepted_at_unix=time.time())

            # feature reuse from the artifact store: the
            # generalization of the `features` ride-along — a bundle any
            # replica (or a previous submission, retry, or process
            # sharing the disk tier) already computed is fetched instead
            # of re-featurized, bypassing the tier and the inline path
            # alike. Seq-only requests only: an MSA submission's raw
            # arrays are unvalidated before featurize_request, so their
            # content key is not yet well-defined.
            feat_key = None
            if features is None and self._store is not None and msa is None:
                ftag = self._feature_tag()
                feat_key = request_key(seq.strip().upper(), None, ftag)
                hit = self._store.lookup_features(ftag, feat_key)
                if hit is not None:
                    features, level = hit
                    self.flights.note(trace_id, "features_from_store",
                                      level=level)

            if features is None and self._featurize is None:
                # no tier: featurize inline on the submit thread (the
                # pre-tier contract — same function, same errors). The
                # ladder is the UNION over capability pools, so its
                # too-long rejection means NO pool can serve this length
                # — the sharp sequence_too_long shed, identical to the
                # single-engine ladder path.
                try:
                    features = featurize_request(
                        seq, msa, msa_mask,
                        ladder=self._ladder,
                        msa_rows=self._serving_cfg.msa_rows,
                    )
                except SequenceTooLongError as e:
                    self._shed_too_long(e)
                    self.flights.finish(trace_id, "shed", code=e.code)
                    self._journal_settle(trace_id)
                    raise
                except ServingError as e:
                    self._count_error(e)
                    self.flights.finish(trace_id, "failed", code=e.code)
                    self._journal_settle(trace_id)
                    raise
                if feat_key is not None:
                    self._store.put_features(ftag, feat_key, features)
            if features is not None:
                if features.length > self._ladder.max_len:
                    # a client-built bundle is untrusted: a length past
                    # every pool's ceiling must shed HERE with the sharp
                    # code, not die later as a replica-attributed
                    # dispatch failure
                    e = SequenceTooLongError(
                        f"sequence length {features.length} exceeds every "
                        f"capability pool's bucket ceiling "
                        f"({self._ladder.max_len})")
                    self._shed_too_long(e)
                    self.flights.finish(trace_id, "shed", code=e.code)
                    self._journal_settle(trace_id)
                    raise e
                entry = FleetRequest(features.seq, msa, msa_mask,
                                     resolve_priority(priority), deadline,
                                     trace_id=trace_id, features=features)
                self._counts["submitted"].inc()
                self._admit(entry, raise_on_full=True)
                return entry

            # featurize tier: the pool's bounded queue is the new first
            # backpressure point; queue-full there raises synchronously
            # like admission queue-full always has
            entry = FleetRequest(seq, msa, msa_mask,
                                 resolve_priority(priority), deadline,
                                 trace_id=trace_id)
            if feat_key is not None:
                entry.feat_store_key = (ftag, feat_key)
            self._counts["submitted"].inc()
            self.flights.note(trace_id, "featurize_enqueue")
            try:
                self._featurize.submit(
                    seq, msa, msa_mask, trace_id=trace_id,
                    # fleet deadline rides into the CPU tier: a job whose
                    # deadline passes while queued is dropped BEFORE
                    # featurizing (featurize_expired_total)
                    deadline=entry.deadline,
                    on_done=lambda bundle, exc, e=entry:
                    self._on_featurized(e, bundle, exc))
            except QueueFullError as e:
                # stays counted as submitted: shed is its terminal
                # outcome, so in_flight arithmetic balances
                self._shed_counter("featurize_queue_full").inc()
                self._counts["shed"].inc()
                self._count_error(e)
                self.flights.finish(trace_id, "shed", code=e.code)
                self._journal_settle(trace_id)
                raise
            except EngineClosedError as e:
                self._resolve_failed(entry, e)
                raise
            return entry

    def _shed_too_long(self, exc: SequenceTooLongError):
        """Synchronous-path accounting for the sharp too-long shed: the
        submission is counted submitted AND shed (terminal) so in_flight
        arithmetic balances, with the dedicated shed reason + error code
        an operator's dashboard keys on."""
        self._counts["submitted"].inc()
        self._counts["shed"].inc()
        self._shed_counter("too_long").inc()
        self._count_error(exc)

    def _on_featurized(self, entry: FleetRequest, bundle, exc):
        """Featurize-pool completion (pool worker thread): attach the
        features and offer the entry to the admission queue, or resolve
        it with the featurization error. Never raises."""
        if exc is not None:
            if isinstance(exc, SequenceTooLongError):
                # same sharp signal as the synchronous paths — the tier
                # moves featurization across threads, never the taxonomy
                self._resolve_shed(entry, "too_long", exc)
            elif isinstance(exc, RequestTimeoutError):
                # deadline passed while queued in the CPU tier — the
                # tier's pre-featurize check (featurize_expired_total)
                # dropped it before burning CPU
                self._resolve_shed(entry, "deadline", exc)
            elif isinstance(exc, RetryBudgetExhaustedError):
                # a worker-death requeue was denied by the fleet-wide
                # retry budget — brownout shed, not a request defect
                self._resolve_shed(entry, "retry_budget", exc)
            else:
                self._resolve_failed(entry, exc)
            return
        entry.features = bundle
        entry.seq = bundle.seq
        if entry.feat_store_key is not None and self._store is not None:
            self._store.put_features(*entry.feat_store_key, bundle)
        self.flights.note(entry.trace_id, "featurized",
                          bucket=bundle.bucket)
        self._admit(entry, raise_on_full=False)

    def _preferred_pool_name(self, length: int,
                             exclude=()) -> Optional[str]:
        """First capability pool (preference order: ceiling ascending,
        declaration order) whose bucket ceiling covers `length` — the
        router's primary target and the depth-accounting key. `exclude`
        skips pools by name (the cascade keeps full-tier work off the
        draft pool)."""
        for pool in sorted(self._pools.values(), key=lambda p: p.rank):
            if pool.name in exclude:
                continue
            if pool.max_len >= length:
                return pool.name
        return None

    def _route_tier(self, entry: FleetRequest, length: int) -> Optional[str]:
        """Pick the entry's preferred pool; with the cascade armed, also
        stamp its tier. Draft-eligible work (length within the draft
        pool's ladder and the policy's max_draft_length) goes to the
        draft pool first; everything else — and escalations — goes to
        the cheapest NON-draft pool."""
        if self._cascade is None:
            return self._preferred_pool_name(length)
        draft = self._cascade.draft_pool
        if entry.tier == "full" or entry.escalated:
            return self._preferred_pool_name(length, exclude=(draft,))
        eligible = (
            self._pools[draft].max_len >= length
            and (self._cascade.max_draft_length == 0
                 or length <= self._cascade.max_draft_length))
        if eligible:
            entry.tier = "draft"
            return draft
        entry.tier = "full"
        self._cascade_ledger.note_bypass("too_long")
        return self._preferred_pool_name(length, exclude=(draft,))

    def _pool_retry_after(self, pool_name: Optional[str],
                          depth: Optional[int] = None) -> float:
        """Backoff advice quoting the CAPABLE pool's backlog: depth of
        queued entries targeting that pool x its drain-rate EMA (same
        formula, cold default, and AdmissionConfig clamps as the global
        estimate — one tuning surface). The global estimate would lie
        whenever one pool is saturated and another idle — a
        long-sequence shed must quote the SP pool's horizon, not the
        idle dense pool's. `depth` lets a caller that already grouped
        the queue (stats) skip the per-pool scan."""
        pool = self._pools.get(pool_name) if pool_name else None
        if pool is None:
            return self._admission.retry_after_s()
        if depth is None:
            depth = sum(1 for e in self._admission.entries()
                        if getattr(e, "pool", None) == pool.name)
        acfg = self._admission.cfg
        est = (pool.service_ema_s or 1.0) * max(1, depth)
        return float(min(acfg.max_retry_after_s,
                         max(acfg.min_retry_after_s, est)))

    def _front_door(self, entry: FleetRequest) -> bool:
        """The fleet front door: artifact-store result lookup
        then cross-pool coalescing, after featurization but BEFORE pool
        routing. Returns True if the entry was fully handled here — hit
        served, or attached as a follower of an identical in-flight
        leader — and must not be admitted. Runs on the caller's thread
        (sync submit or featurize-tier callback); all store I/O is
        lock-free with respect to the fleet lock."""
        if (self._store is None or self._frontdoor is None
                or entry.pool is None or entry.features is None):
            return False
        f = entry.features
        tag = self._store_tag(entry.pool)
        key = request_key(f.seq, f.msa, tag, msa_mask=f.msa_mask)
        entry.store_key = (tag, key)
        lookups = [(tag, key)]
        if self._cascade is not None and entry.tier == "draft":
            # a FULL-fidelity result dominates a draft one: check the
            # escalation target's tag first so a previously-escalated
            # sequence is served at the better tier. The reverse never
            # happens — full-tier entries only consult their own tag, so
            # a draft result can never serve a full-fidelity lookup
            full_pool = self._preferred_pool_name(
                f.length, exclude=(self._cascade.draft_pool,))
            if full_pool is not None:
                ftag = self._store_tag(full_pool)
                fkey = request_key(f.seq, f.msa, ftag,
                                   msa_mask=f.msa_mask)
                lookups.insert(0, (ftag, fkey))
        for ltag, lkey in lookups:
            hit = self._store.lookup_result(ltag, lkey)
            if hit is None:
                continue
            cached, level = hit
            latency = time.monotonic() - entry.enqueued_at
            if entry._finish(result=cached, replica="", degraded=False,
                             latency_s=latency):
                self._counts["completed"].inc()
                self._latency.observe(latency)
                self.flights.finish(
                    entry.trace_id, "completed", pool=entry.pool,
                    from_cache=True, cache_tier="artifact_store",
                    cache_level=level, bucket=cached.bucket,
                    latency_s=round(latency, 6))
                self._journal_settle(entry.trace_id)
            return True
        if not self._frontdoor.register((tag, key), entry):
            entry.coalesced = True
            self.flights.note(entry.trace_id, "coalesced", pool=entry.pool)
            return True
        return False

    def _admit(self, entry: FleetRequest, *, raise_on_full: bool):
        """Offer an accepted entry to the admission queue; shed/eviction
        accounting in one place for the sync and async entry paths."""
        # tag the preferred capability pool (features are always attached
        # by now — sync paths featurize before admitting, the tier admits
        # from its completion callback): per-pool depth gauges and
        # pool-quoted retry_after_s key on it
        length = (entry.features.length if entry.features is not None
                  else len(entry.seq))
        entry.pool = self._route_tier(entry, length)
        if self._front_door(entry):
            # served from the artifact store or attached to an identical
            # in-flight leader — the entry never reaches the admission
            # queue, and deliberately never counts as pool ARRIVAL: the
            # headroom model measures demand on CHIP capacity, and
            # cache-absorbed demand is exactly the demand that costs none
            return
        if entry.pool is not None:
            # the ARRIVAL half of the headroom model (sample_gauges
            # derives rates): demand is counted where it is admitted,
            # shed included — a shed request is still demand the pool
            # failed to absorb
            with self._arrivals_lock:
                self._arrivals[entry.pool] = (
                    self._arrivals.get(entry.pool, 0) + 1)
        self.flights.note(entry.trace_id, "admitted", pool=entry.pool)
        try:
            evicted = self._admission.offer(entry)
        except QueueFullError as e:
            # the entry stays counted as submitted: shed is its terminal
            # outcome, so in_flight arithmetic balances
            if not self._implicit_pools:
                e = QueueFullError(
                    f"{e} (capable pool {entry.pool!r})",
                    retry_after_s=self._pool_retry_after(entry.pool),
                )
            if raise_on_full:
                self._shed_counter("queue_full").inc()
                self._counts["shed"].inc()
                self._count_error(e)
                # the entry never resolves through _resolve_shed on this
                # synchronous path — seal its flight here or /explainz
                # would show an overload shed (the flight most worth
                # explaining) as forever in flight
                self.flights.finish(entry.trace_id, "shed",
                                    reason="queue_full", code=e.code)
                self._journal_settle(entry.trace_id)
                # a shed LEADER's followers must shed with it (the
                # raise skips _resolve_shed, so settle here)
                self._settle_waiters(entry, exc=e)
                raise e from None
            self._resolve_shed(entry, "queue_full", e)
            return
        if evicted is not None:
            self._resolve_shed(
                evicted, "evicted",
                QueueFullError(
                    "evicted by a higher-priority arrival under "
                    "overload; retry with backoff",
                    # the EVICTED entry's own capable pool, not the
                    # arrival's: its retry lands back in that pool's line
                    retry_after_s=(
                        self._pool_retry_after(evicted.pool)
                        if not self._implicit_pools
                        else self._admission.retry_after_s()),
                ))
        # close the TOCTOU window against shutdown() (the engine's
        # stance, engine.py): if the ROUTER is stopping (or crashed —
        # the crash guard closes the fleet with the stop event unset
        # but the thread dead), its final drain may already be past
        # this entry — resolve it ourselves; _finish is resolve-once,
        # so losing the race to a still-draining dispatcher is
        # harmless. The closed flag alone is NOT the test: during
        # shutdown(drain=True) the featurize tier drains THROUGH here
        # while the dispatcher is still serving ("serves what it still
        # can"), and failing those entries would break that promise.
        dispatcher_gone = (self._stop.is_set()
                           or not self._dispatcher.is_alive())
        if (self._closed and dispatcher_gone
                and self._resolve_failed(entry, EngineClosedError(
                    "fleet shut down while the request was being "
                    "submitted"))):
            if raise_on_full:
                raise EngineClosedError("fleet is shut down")

    def predict(self, seq: str, *, msa=None, msa_mask=None,
                timeout: Optional[float] = None,
                priority="normal") -> PredictionResult:
        """Synchronous convenience: submit + block for the result."""
        return self.submit(seq, msa=msa, msa_mask=msa_mask, timeout=timeout,
                           priority=priority).result()

    # -------------------------------------------------------- elasticity

    def _resolve_pool_name(self, pool: Optional[str]) -> str:
        """Default to the sole pool; with several, the caller must say
        which capability pool a scale action targets."""
        if pool is None:
            if len(self._pools) == 1:
                return next(iter(self._pools))
            raise ScaleRejectedError(
                f"fleet has capability pools {sorted(self._pools)} — "
                f"scale actions must name one (pool=...)")
        if pool not in self._pools:
            raise ScaleRejectedError(
                f"no capability pool named {pool!r}; known: "
                f"{sorted(self._pools)}")
        return pool

    def replica_count(self, pool: Optional[str] = None) -> int:
        """Non-retiring full replicas — fleet-wide, or one capability
        pool's slice (the per-pool autoscaler's pool size)."""
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if not r.retiring
                       and (pool is None or r.pool == pool))

    def add_replica(self, pool: Optional[str] = None) -> str:
        """Grow the pool by one replica (autoscale scale-up). `pool`
        names the capability pool to grow (optional with one pool).
        Returns the new replica's name. Raises ScaleRejectedError when
        the fleet is closed or the engine fails to build — a failed grow
        must be a visible decision outcome, not a zombie slot."""
        if self._closed:
            raise ScaleRejectedError("fleet is shut down")
        pool = self._resolve_pool_name(pool)
        rep = self._spawn_replica(pool)
        if rep.engine is None:
            # take the stillborn slot back out through the normal path
            rep.retiring = True
            self._health.retire(rep.name, "failed_to_build")
            raise ScaleRejectedError(
                f"replica {rep.name} engine failed to build")
        return rep.name

    def remove_replica(self, name: Optional[str] = None,
                       pool: Optional[str] = None) -> str:
        """Shrink the fleet by one replica through the HealthMonitor
        drain path (autoscale scale-down): the victim stops taking
        traffic immediately, its queued work fails back through the
        requeue path onto the survivors (nothing is lost), and the
        health tick unregisters it after the drain runs. `name=None`
        picks the least-loaded healthy replica (newest on ties) within
        `pool` (or fleet-wide with one pool).

        Raises ScaleRejectedError when: the fleet is closed; the victim's
        capability pool would drop below one replica (a pool emptied of
        capacity silently narrows what the FLEET can serve); `name` is
        unknown or already retiring; or (victim unspecified) any replica
        in the target pool is DOWN — draining on top of failure-drained
        capacity would amplify the outage."""
        with self._lock:
            if self._closed:
                raise ScaleRejectedError("fleet is shut down")
            if name is None:
                pool = self._resolve_pool_name(pool)
                live = [r for r in self._replicas.values()
                        if not r.retiring and r.pool == pool]
                if len(live) <= 1:
                    raise ScaleRejectedError(
                        f"refusing to shrink pool {pool!r} below one "
                        f"replica")
                healthy = set(self._health.healthy_targets())
                down = sorted(r.name for r in live if r.name not in healthy)
                if down:
                    raise ScaleRejectedError(
                        f"replica(s) {down} are down — refusing to shrink "
                        f"already-degraded capacity")
                victim = sorted(live,
                                key=lambda r: (r.in_flight, -r.index))[0]
            else:
                victim = self._replicas.get(name)
                if victim is None or victim.retiring:
                    raise ScaleRejectedError(
                        f"no live replica named {name!r}")
                peers = sum(1 for r in self._replicas.values()
                            if not r.retiring and r.pool == victim.pool)
                if peers <= 1:
                    raise ScaleRejectedError(
                        f"refusing to shrink pool {victim.pool!r} below "
                        f"one replica")
            victim.retiring = True
        self._health.retire(victim.name, "scale_down")
        return victim.name

    def attach_autoscaler(self, autoscaler):
        """Bind a ReplicaAutoscaler so `stats()` carries its snapshot
        (the acceptance surface) and shutdown() stops its ticker. A
        pool-scoped autoscaler (ReplicaAutoscaler(pool=...)) registers
        under its pool; the fleet holds one per capability pool plus at
        most one fleet-wide scaler."""
        pool = getattr(autoscaler, "pool", "") or ""
        if pool:
            self._pool_autoscalers[pool] = autoscaler
        else:
            self._autoscaler = autoscaler

    def sample_gauges(self):
        """Ticker hook (ops plane / autoscaler): publish the LIVE queue
        and occupancy signals as registry gauges — until this hook,
        queue depth and the drain-rate EMA were visible only inside
        `stats()` snapshots, so a `/metrics` scrape between requests
        never saw queue pressure.

        Cheap-dedupe guard: with per-pool autoscalers every pool's
        ticker calls this at the same cadence, and each pass takes the
        fleet lock + scans the admission queue — K pools must not mean
        K redundant sweeps per tick. Calls within 50 ms of the last
        full sample are no-ops (the signals cannot meaningfully change
        faster than the tick cadences that consume them)."""
        now = time.monotonic()
        with self._lock:
            # check-and-set under the lock: two pool tickers firing at
            # the same instant must not both pass the guard
            if now - self._last_gauge_sample < 0.05:
                return
            self._last_gauge_sample = now
        snap = self._admission.snapshot()
        self._queue_depth_gauge.set(snap["depth"])
        self._service_ema_gauge.set(snap["service_ema_s"] or 0.0)
        healthy = set(self._health.healthy_targets())
        depth_by_pool = {}
        for e in self._admission.entries():
            p = getattr(e, "pool", None)
            if p is not None:
                depth_by_pool[p] = depth_by_pool.get(p, 0) + 1
        with self._lock:
            live = [r for r in self._replicas.values() if not r.retiring]
            n_live = len(live)
            in_flight = sum(r.in_flight for r in live
                            if r.name in healthy)
            slots = sum(r.cfg.max_batch for r in live
                        if r.name in healthy)
            per_pool = {}
            for name in self._pools:
                p_live = [r for r in live if r.pool == name]
                per_pool[name] = (
                    len(p_live),
                    sum(1 for r in p_live if r.name in healthy),
                    sum(r.in_flight for r in p_live if r.name in healthy),
                    sum(r.cfg.max_batch for r in p_live
                        if r.name in healthy),
                )
        self._replicas_gauge.set(n_live)
        self._occupancy_gauge.set(in_flight / slots if slots else 0.0)
        # the per-capability-pool view: each pool autoscaler reads ITS
        # queue depth / occupancy / size, so a saturated SP pool scales
        # without the idle dense pool's signals diluting the decision
        for name, (n_p, _healthy_p, inf_p, slots_p) in per_pool.items():
            self._pool_reps_g[name].set(n_p)
            self._pool_occ_g[name].set(inf_p / slots_p if slots_p else 0.0)
            self._pool_depth_g[name].set(depth_by_pool.get(name, 0))
        self._sample_headroom(
            now, {name: h for name, (_n, h, _i, _s) in per_pool.items()})
        # the shared cost plane's gauges ride the same tick
        self.costs.publish()
        self.goodput.publish()
        if self._store is not None:
            self._store.publish_gauges()
        # the AMORTIZED fleet economy: cumulative chip-seconds over ALL
        # completed requests, cache/coalesce hits included. The per-cell
        # serve_chip_seconds_per_request gauge is an EMA over DISPATCHED
        # batches and cannot drop when a request never touches a chip —
        # this one is what the artifact store actually moves, and what
        # the telemetry.check gate reads from bench artifacts.
        completed = int(self._counts["completed"].value)
        if completed > 0:
            self.registry.gauge(
                "fleet_chip_seconds_per_request",
                help="cumulative device-seconds x chips across every "
                     "executable, amortized over completed requests "
                     "(artifact-store hits and coalesced followers "
                     "complete without spending chip time, so this "
                     "drops as the fleet memoizes)",
            ).set(self.costs.fleet_chip_seconds_total() / completed)
        if self._featurize is not None:
            self._featurize.sample_gauges()
        if self._cascade is not None:
            self._cascade_ledger.publish()

    def _sample_headroom(self, now: float, healthy_by_pool: dict):
        """The capacity model closing the autoscaler's loop: per pool,
        arrival rate (EMA over `_admit` counts) vs modeled capacity
        (cost-ledger service rate x healthy replicas) published as
        `fleet_pool_headroom_ratio` — the autoscaler's new up-trigger
        reads it, so scale-up fires when the MODEL says the pool is
        running out, before queue-wait p95 (a lagging symptom) climbs.
        `fleet_pool_slo_burn_predicted` (arrival/capacity) is the burn
        predictor: >1 means the queue grows without bound and an SLO
        page is a matter of time. Gauges stay ABSENT until the pool has
        measured batches — a guessed capacity is worse than none."""
        snap = {}
        with self._arrivals_lock:
            counts = dict(self._arrivals)
            for name, count in counts.items():
                state = self._arrival_rate.get(name)
                if state is None:
                    self._arrival_rate[name] = {
                        "count": count, "ts": now, "ema": None}
                    continue
                dt = now - state["ts"]
                if dt <= 0:
                    continue
                inst = (count - state["count"]) / dt
                state["ema"] = (inst if state["ema"] is None
                                else 0.3 * inst + 0.7 * state["ema"])
                state["count"], state["ts"] = count, now
            rates = {name: (s["ema"] or 0.0)
                     for name, s in self._arrival_rate.items()}
        for name in self._pools:
            arrival = rates.get(name, 0.0)
            self.registry.gauge(
                "fleet_pool_arrival_per_sec",
                help="EMA request arrival rate whose preferred "
                     "capability pool is this one (sheds included — "
                     "demand, not throughput)", pool=name).set(arrival)
            per_replica = self.costs.pool_rate_rps(name)
            if per_replica is None:
                continue  # nothing measured yet: headroom stays absent
            capacity = per_replica * healthy_by_pool.get(name, 0)
            self.registry.gauge(
                "fleet_pool_capacity_per_sec",
                help="modeled service capacity: cost-ledger per-replica "
                     "rate x healthy replicas", pool=name).set(capacity)
            # capacity 0 = every replica of a measured pool is down:
            # publish WORST-case headroom rather than `continue` —
            # freezing the last pre-outage value would blind the
            # headroom up-trigger during exactly the outage it exists
            # for. Burn caps at a large finite ceiling (a gauge must
            # stay finite) and reads 0 only when demand is also 0.
            if capacity > 0:
                headroom = max(-1.0,
                               min(1.0, (capacity - arrival) / capacity))
                burn = min(1e6, arrival / capacity)
            else:
                headroom = -1.0
                burn = 1e6 if arrival > 0 else 0.0
            self.registry.gauge(
                "fleet_pool_headroom_ratio",
                help="(capacity - arrival) / capacity; the autoscaler "
                     "headroom up-trigger and the capacity runbook's "
                     "first signal (-1 when a measured pool has zero "
                     "healthy capacity)", pool=name).set(headroom)
            self.registry.gauge(
                "fleet_pool_slo_burn_predicted",
                help="arrival / capacity: >1 predicts unbounded queue "
                     "growth (an SLO page is a matter of time; capped "
                     "at 1e6 when capacity is zero)",
                pool=name).set(burn)
            snap[name] = {
                "arrival_per_sec": arrival,
                "capacity_per_sec": capacity,
                "per_replica_rps": per_replica,
                "healthy_replicas": healthy_by_pool.get(name, 0),
                "headroom_ratio": headroom,
                "burn_predicted": burn,
            }
        self._last_headroom = snap

    def rolling_update(self, *, params=None, model_cfg=None,
                       params_tag: Optional[str] = None,
                       timeout_s: float = 120.0) -> dict:
        """Zero-downtime deploy: swap the master weights and/or model
        config, then cycle each replica through the SAME HealthMonitor
        drain path a failure takes — one at a time, waiting for the
        re-probe to reinstate it behind a fresh engine (which reads the
        new masters) before touching the next, so the pool never drops
        more than one replica of capacity and in-flight work requeues
        onto the survivors.

        `params_tag` MUST change when `params` does: it is part of the
        result-cache key, and stale-tag cache entries would serve the
        OLD weights' structures after the update. Returns a summary dict
        ({replica: restarts}). Raises ScaleRejectedError if the fleet is
        closed or a replica fails to come back inside `timeout_s`."""
        if params is not None and params_tag is None:
            raise ValueError(
                "rolling_update(params=...) requires params_tag=: the "
                "result cache keys on it — reusing the old tag would "
                "serve stale structures from the previous weights"
            )
        if params is None and model_cfg is None and params_tag is None:
            raise ValueError("rolling_update: nothing to update")
        with self._lock:
            if self._closed:
                raise ScaleRejectedError("fleet is shut down")
            if params is not None:
                self._params = params
            if model_cfg is not None:
                self._model_cfg = model_cfg
                self._degraded_model_cfg = model_cfg
                if self.cfg.degraded_weight_dtype == "int8":
                    self._degraded_model_cfg = dataclasses.replace(
                        model_cfg, weight_dtype="int8")
            reps = sorted(
                (r for r in self._replicas.values() if not r.retiring),
                key=lambda r: r.index)
            if params_tag is not None:
                # the template too, not just live replicas: a replica
                # the autoscaler ADDS after this deploy is spawned from
                # self._serving_cfg and must carry the new tag — a fresh
                # engine serving the new weights under the old tag would
                # alias the old weights' result-cache keyspace
                self._serving_cfg = dataclasses.replace(
                    self._serving_cfg, params_tag=params_tag)
                for r in reps:
                    r.cfg = dataclasses.replace(r.cfg,
                                                params_tag=params_tag)
                if self._degraded_rep is not None:
                    self._degraded_rep.cfg = dataclasses.replace(
                        self._degraded_rep.cfg, params_tag=params_tag)
            degraded = self._degraded_rep
        if self._store is not None:
            # re-key the fleet artifact tier the moment the tags change —
            # BEFORE cycling replicas, so no window exists where a
            # new-weights replica could read an old-tag entry. In-flight
            # old-tag leaders still settle their coalitions (settle keys
            # on the entry's stamped store_key, not the current tags);
            # their put_result lands under a retired tag and the sweep
            # below (plus the periodic budget sweep) reclaims it.
            self._store.set_current_tags(self._current_store_tags())
        summary = {}
        for rep in reps:
            try:
                self._health.force_down(rep.name, "rolling_update")
            except KeyError:
                continue  # retired (autoscale) since we captured reps
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                try:
                    state = self._health.state(rep.name)
                except KeyError:
                    break  # retired mid-update: nothing left to cycle
                if (state is ReplicaState.HEALTHY
                        and rep.engine is not None):
                    break
                time.sleep(min(0.02, self.cfg.reprobe_interval_s))
            else:
                raise ScaleRejectedError(
                    f"rolling update stalled: {rep.name} not reinstated "
                    f"within {timeout_s}s")
            summary[rep.name] = rep.restarts
        if degraded is not None:
            # the degraded tier has no health-managed drain path; swap
            # its engine directly (it serves only overflow/outage)
            old, degraded.engine = degraded.engine, None
            if old is not None:
                old.shutdown(drain=False,
                             timeout=self.cfg.drain_timeout_s)
                _release_graphs(old, self.cfg.drain_timeout_s)
            degraded.engine = degraded.factory()
        if self._store is not None:
            # GC the retired deploy's keyspace from disk right away
            # rather than waiting for the next budget sweep
            self._store.sweep()
        return summary

    def health(self) -> dict:
        """Cheap liveness payload for `/healthz` (telemetry/ops_plane.py):
        HealthMonitor states + replica-up view, no engine stats. `status`
        is "ok" (all replicas healthy), "degraded" (reduced capacity:
        some replicas down, or only the degraded tier is serving), or
        "down" (closed, or nothing can serve — mapped to HTTP 503)."""
        snap = self._health.snapshot()
        # retiring replicas are deliberate removals mid-drain, not lost
        # capacity: they must not flip /healthz to "degraded"
        states = {name: t["state"] for name, t in snap["targets"].items()
                  if not t.get("retiring")}
        n_healthy = sum(1 for s in states.values() if s == "healthy")
        with self._lock:
            has_degraded = self._degraded_rep is not None
        if self._closed or (n_healthy == 0 and not has_degraded):
            status = "down"
        elif n_healthy < len(states):
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "closed": self._closed,
            "replicas": states,
            "healthy_replicas": n_healthy,
            "total_replicas": len(states),
            "degraded_tier": has_degraded,
            "queue_depth": self._admission.depth(),
            "queue_capacity": self.cfg.queue_capacity,
        }

    def stats(self) -> dict:
        """JSON-ready fleet snapshot: terminal counters, admission queue,
        per-replica state + engine stats, health, telemetry registry."""
        counts = {k: int(c.value) for k, c in self._counts.items()}
        counts["degraded"] = int(self._degraded_total.value)
        counts["requeued"] = int(self._requeue_total.value)
        counts["in_flight"] = (
            counts["submitted"] - counts["completed"] - counts["shed"]
            - counts["failed"]
        )
        with self._lock:
            reps = list(self._replicas.values())
            degraded = self._degraded_rep
            shed = {reason: int(c.value)
                    for reason, c in self._shed_reasons.items()}
            errors = {code: int(c.value)
                      for code, c in self._errors.items()}
        replicas = {}
        # one snapshot, not per-name state() lookups: a replica retired
        # between our reps copy and here has already left the health
        # registry, and indexing it would KeyError a /statusz scrape
        health_states = {name: t["state"] for name, t
                         in self._health.snapshot()["targets"].items()}
        for rep in reps + ([degraded] if degraded else []):
            engine = rep.engine
            pool = self._pools.get(rep.pool)
            # capability visibility: the live
            # engine's own tag when it exists, else the pool's derived
            # one — so /statusz always shows WHY the router considers
            # this replica for a given length
            if engine is not None:
                capability = engine.capability()
            elif pool is not None:
                capability = self._pool_capability(pool)
            else:  # degraded tier mid-restart
                capability = {
                    "weight_dtype": self._degraded_model_cfg.weight_dtype,
                    "sp_shards": rep.cfg.sp_shards,
                    "max_len": self._degraded_ladder.max_len,
                }
            replicas[rep.name] = {
                "state": (DEGRADED if rep.name == DEGRADED
                          else health_states.get(rep.name, "retired")),
                "pool": rep.pool,
                "capability": capability,
                "in_flight": rep.in_flight,
                "dispatches": rep.dispatches,
                "restarts": rep.restarts,
                "engine": engine.stats() if engine is not None else None,
            }
        pools = {}
        # ONE queue snapshot grouped by pool (not a full scan per pool):
        # stats() sits on the observability hot path (/statusz, the
        # stats-flusher thread, polling tests)
        depth_by_pool = {}
        for e in self._admission.entries():
            p = getattr(e, "pool", None)
            if p is not None:
                depth_by_pool[p] = depth_by_pool.get(p, 0) + 1
        for name, pool in self._pools.items():
            pools[name] = {
                "rank": pool.rank,
                "capability": self._pool_capability(pool),
                "replicas": sum(1 for r in reps
                                if r.pool == name and not r.retiring),
                "service_ema_s": pool.service_ema_s,
                "retry_after_s": self._pool_retry_after(
                    name, depth=depth_by_pool.get(name, 0)),
            }
        # publish the cost-plane ledgers so the registry snapshot below
        # agrees with the sections; deliberately NOT the full
        # sample_gauges sweep — its dedupe guard exists for the ticker
        # cadence, and a stats() poll must not consume an explicit
        # sample_gauges() caller's refresh window
        self.costs.publish()
        self.goodput.publish()
        out = {
            "closed": self._closed,
            "requests": counts,
            "shed": shed,
            "errors": errors,
            "queue_wait": self._queue_wait.snapshot(),
            "latency": self._latency.snapshot(),
            "admission": self._admission.snapshot(),
            "replicas": replicas,
            "pools": pools,
            "health": self._health.snapshot(),
            "costs": self.costs.snapshot(),
            "serve_goodput": self.goodput.snapshot(),
            "headroom": dict(self._last_headroom),
            "flights": self.flights.snapshot(),
            "telemetry": {
                "metrics": self.registry.snapshot(),
                "spans": self._tracer.summary(),
            },
        }
        if self._store is not None:
            out["artifact_store"] = self._store.snapshot()
        if self._frontdoor is not None:
            out["frontdoor"] = self._frontdoor.snapshot()
        if self._featurize is not None:
            out["featurize"] = self._featurize.stats()
        if self._autoscaler is not None:
            out["autoscale"] = self._autoscaler.snapshot()
        if self._pool_autoscalers:
            out["autoscale_pools"] = {
                pool: sc.snapshot()
                for pool, sc in sorted(self._pool_autoscalers.items())
            }
        if self._journal is not None:
            out["journal"] = self._journal.stats()
        if self._cascade is not None:
            # /statusz "cascade" section: escalation rate + per-tier
            # quality EMAs next to the policy that produced them, so an
            # escalation-rate spike can be read against its thresholds
            out["cascade"] = {
                "policy": dataclasses.asdict(self._cascade),
                **self._cascade_ledger.snapshot(),
            }
        if self._budget is not None:
            out["retry_budget"] = self._budget.snapshot()
        if self._hedger is not None:
            with self._hedge_lock:
                out["hedging"] = {
                    "issued": self._hedges_issued,
                    "denied": dict(self._hedge_denied),
                    "outstanding": len(self._outstanding),
                    "wasted_chip_seconds": round(
                        self._hedge_waste.value, 6),
                }
        return out

    def backpressure(self) -> dict:
        """The shed-advice surface an HTTP front end quotes on 429s
        (/statusz `backpressure` section): the global queue horizon,
        per-pool horizons when capability pools are explicit, and the
        retry-budget state when one is armed. Cheap enough to call per
        scrape."""
        out = {"queue_retry_after_s": round(
            self._admission.retry_after_s(), 3)}
        if not self._implicit_pools:
            depth_by_pool = {}
            for e in self._admission.entries():
                p = getattr(e, "pool", None)
                if p is not None:
                    depth_by_pool[p] = depth_by_pool.get(p, 0) + 1
            out["pools"] = {
                name: round(self._pool_retry_after(
                    name, depth=depth_by_pool.get(name, 0)), 3)
                for name in self._pools
            }
        if self._budget is not None:
            out["retry_budget"] = self._budget.snapshot()
        return out

    def replay_journal(self) -> dict:
        """Re-drive every journaled-but-unsettled request through the
        normal submit() path — call at startup, BEFORE admitting fresh
        traffic. Idempotent by construction, not bookkeeping: a replayed
        request re-enters front-door coalescing and the artifact store,
        so work that completed before the crash replays as a store hit
        and identical payloads coalesce — zero duplicate chip dispatch.
        Records whose absolute deadline already passed settle directly
        (journal_expired_total); a replay the submit path sheds/fails
        synchronously is already sealed AND settled by that path.
        Returns {replayed, expired, failed, requests} — `requests` holds
        the live FleetRequest futures so a caller can await them."""
        if self._journal is None:
            return {"replayed": 0, "expired": 0, "failed": 0,
                    "requests": []}
        replayed = expired = failed = 0
        requests = []
        for rec in self._journal.pending():
            if (rec.deadline_unix is not None
                    and rec.deadline_unix <= time.time()):
                self.registry.counter(
                    "journal_expired_total",
                    help="journal records dropped at replay because "
                         "their deadline had already passed").inc()
                self._journal.settle(rec.trace_id)
                expired += 1
                continue
            remaining = (None if rec.deadline_unix is None
                         else rec.deadline_unix - time.time())
            try:
                req = self.submit(
                    rec.seq, msa=rec.msa, msa_mask=rec.msa_mask,
                    timeout=remaining, priority=rec.priority,
                    trace_id=rec.trace_id)
            except ServingError:
                failed += 1
                continue
            self.registry.counter(
                "journal_replayed_total",
                help="journal records re-driven through submit() after "
                     "a restart").inc()
            replayed += 1
            requests.append(req)
        return {"replayed": replayed, "expired": expired,
                "failed": failed, "requests": requests}

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the front door, the router, the supervisor, and every
        engine. drain=True serves what it still can (replica engines
        drain their queues); whatever cannot be served resolves with
        EngineClosedError — nothing is left unresolved. Idempotent."""
        # under the fleet lock: the dispatcher's crash guard flips the
        # same flag from its own thread (CONC001)
        with self._lock:
            self._closed = True
        self._drain_on_stop = drain
        if self._autoscaler is not None:
            # the control loop must not scale a closing fleet (tick()
            # also checks _closed; stopping the fallback thread is belt
            # and braces)
            self._autoscaler.stop()
        for scaler in self._pool_autoscalers.values():
            scaler.stop()
        if self._featurize is not None:
            # featurize first: its pending jobs resolve their entries
            # (drain=True runs them through admission; anything the
            # dispatcher no longer serves fails terminally below)
            self._featurize.shutdown(drain=drain)
        self._stop.set()
        self._dispatcher.join(timeout)
        if self._hedger is not None:
            self._hedger.join(timeout)
        self._health.stop()
        with self._lock:
            reps = list(self._replicas.values())
            if self._degraded_rep is not None:
                reps.append(self._degraded_rep)
        for rep in reps:
            engine = rep.engine
            if engine is not None:
                engine.shutdown(drain=drain, timeout=self.cfg.drain_timeout_s)
                _release_graphs(engine, self.cfg.drain_timeout_s)
        # engine shutdown callbacks may have requeued entries after the
        # dispatcher died; fail every remaining queued entry terminally
        for entry in self._admission.drain():
            self._resolve_failed(entry, EngineClosedError(
                "fleet shut down before the request was served"))
        if self._frontdoor is not None:
            # every leader above settled its own coalition through a
            # terminal path; this catches followers whose leader never
            # reached one (e.g. stranded mid-submit) — nothing is left
            # unresolved, the front-door promise included
            for entry in self._frontdoor.drain():
                self._resolve_failed(entry, EngineClosedError(
                    "fleet shut down before the coalesced request was "
                    "served"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)
        return False

    # ------------------------------------------------------------- router

    def _dispatch_loop(self):
        try:
            while True:
                if self._stop.is_set():
                    if not self._drain_on_stop:
                        return
                    entry, expired = self._admission.poll(timeout=0)
                    if entry is None and not expired:
                        return  # queue fully drained
                else:
                    entry, expired = self._admission.poll(timeout=0.05)
                for e in expired:
                    self._resolve_shed(e, "deadline", RequestTimeoutError(
                        f"deadline passed after "
                        f"{time.monotonic() - e.enqueued_at:.3f}s in the "
                        f"fleet queue",
                        retry_after_s=self._admission.retry_after_s()))
                if entry is not None:
                    self._route(entry)
        except BaseException:  # noqa: BLE001 — last-resort guard (engine
            # worker stance): fail queued work loudly, refuse new traffic
            # (the `with` regions above released _lock during unwind, so
            # re-acquiring here cannot self-deadlock)
            with self._lock:
                self._closed = True
            traceback.print_exc()
            for entry in self._admission.drain():
                self._resolve_failed(entry, PredictionError(
                    "fleet dispatcher crashed; fleet is closed"))

    def _route(self, entry: FleetRequest):
        wait = time.monotonic() - entry.enqueued_at
        self._queue_wait.observe(wait)
        if self._tracer.enabled:
            self._tracer.add("fleet.queue_wait", wait, cat="fleet",
                             priority=entry.priority,
                             trace_id=entry.trace_id,
                             requeues=entry.requeues)
        overloaded = (self.cfg.degrade_depth > 0
                      and self._admission.depth() >= self.cfg.degrade_depth)
        # length-adaptive routing: only replicas whose
        # capability pool's bucket ceiling covers the request are
        # candidates, preferred cheapest-pool-first (pool rank = ceiling
        # ascending, declaration order) then least-loaded — short work
        # lands on dense/int8 replicas, the SP pool keeps its headroom
        # for the lengths only it can serve
        length = (entry.features.length if entry.features is not None
                  else len(entry.seq))
        healthy = self._health.healthy_targets()
        with self._lock:
            # .get: a replica retired by the autoscaler may briefly
            # linger in the health view (or vice versa) mid-transition
            ranked = sorted(
                (r for r in (self._replicas.get(n) for n in healthy)
                 if r is not None and not r.retiring
                 and self._pools[r.pool].max_len >= length),
                key=lambda r: (self._pools[r.pool].rank, r.in_flight),
            )
            degraded = self._degraded_rep
        if degraded is not None and self._degraded_ladder.max_len < length:
            # the degraded tier's ladder cannot bucket this request —
            # never a candidate, whatever the overload state
            degraded = None
        # failover exclusion: a replica this request already FAILED on is
        # the worst candidate, not an equal one — prefer untried healthy
        # replicas, fall to the degraded tier when none remain, and only
        # then retry where it failed (better a retry than a starve)
        if self._cascade is not None:
            draft_name = self._cascade.draft_pool
            if entry.tier == "draft":
                draft_only = [r for r in ranked if r.pool == draft_name]
                if draft_only:
                    ranked = draft_only
                else:
                    # the whole draft pool is down/retired: PROMOTE rather
                    # than starve — the cascade is a cost optimization,
                    # never an availability reduction. The entry re-tags
                    # as full-tier so the store key, candidate set and
                    # accounting all agree from here on.
                    entry.tier = "full"
                    entry.pool = self._preferred_pool_name(
                        length, exclude=(draft_name,))
                    self._cascade_ledger.note_bypass("draft_unavailable")
                    self.flights.note(
                        entry.trace_id, "cascade_promote",
                        reason="draft_unavailable", pool=entry.pool)
                    ranked = [r for r in ranked if r.pool != draft_name]
            else:
                # full-tier (incl. escalated) work must never land on the
                # draft pool — a low-fidelity retry of a low-confidence
                # draft would be noise, not verification
                ranked = [r for r in ranked if r.pool != draft_name]
        fresh = [r for r in ranked if r.name not in entry.failed_on]
        stale = [r for r in ranked if r.name in entry.failed_on]
        targets = fresh
        if degraded is not None and (overloaded or not fresh):
            # the cheap tier catches the overload spill the full replicas
            # reject, and is the first resort once the request has failed
            # on (or lost) every full replica — the response says so
            targets = targets + [degraded]
        targets = targets + stale
        if not targets:
            # every CAPABLE replica is down (config-level incapacity —
            # a length past every pool's ceiling — already shed at submit
            # with sequence_too_long): answer NOW with the re-probe
            # horizon instead of letting the request age out silently
            self._resolve_shed(
                entry, "no_healthy_replica",
                NoHealthyReplicaError(
                    f"every replica capable of length {length} is down "
                    f"and no degraded tier covers it",
                    retry_after_s=self.cfg.reprobe_interval_s))
            return
        for rep in targets:
            if self._try_dispatch(entry, rep):
                return
        # nothing admitted it (queues full / engines mid-drain): the
        # entry stays accepted — requeue WITHOUT consuming failover
        # budget and let the router breathe. Exception: during shutdown
        # with every candidate engine already dead, nothing will ever
        # free up — resolve terminally instead of orbiting the queue.
        with self._lock:
            alive = any(
                r.engine is not None and not r.engine._closed
                for r in targets
            )
        if self._closed and not alive:
            self._resolve_failed(entry, EngineClosedError(
                "fleet shut down before the request was served"))
            return
        self._admission.requeue(entry)
        time.sleep(self.cfg.dispatch_backoff_s)

    def _try_dispatch(self, entry: FleetRequest, rep: _Replica, *,
                      hedge: bool = False) -> bool:
        engine = rep.engine
        if engine is None:
            return False
        now = time.monotonic()
        remaining = (None if entry.deadline is None
                     else entry.deadline - now)
        if remaining is not None and remaining <= 0:
            if hedge:
                # the PRIMARY dispatch owns the outcome — a hedge that
                # finds the deadline gone simply declines to launch
                return False
            self._resolve_shed(entry, "deadline", RequestTimeoutError(
                "deadline passed at dispatch",
                retry_after_s=self._admission.retry_after_s()))
            return True
        features = entry.features
        if (self._cascade is not None and features is not None
                and features.msa is not None):
            # one FeatureBundle rides every tier of the cascade
            # (featurization is never repaid), but the draft pool's
            # engines serve fewer MSA rows — hand each engine a VIEW
            # truncated to its own row budget instead of tripping its
            # featurized-for-a-different-deployment guard. Row truncation
            # is the reduced-fidelity featurization by construction
            # (featurize.py fills rows top-down), so the view is exactly
            # what that pool would have featurized itself.
            rows = getattr(getattr(engine, "cfg", None), "msa_rows", None)
            if rows == 0:
                features = dataclasses.replace(
                    features, msa=None, msa_mask=None)
            elif rows is not None and features.msa.shape[0] > rows:
                features = dataclasses.replace(
                    features, msa=features.msa[:rows],
                    msa_mask=(features.msa_mask[:rows]
                              if features.msa_mask is not None else None))
        try:
            # bind_trace: any span a helper records on the dispatcher
            # thread during THIS routing inherits the request's id
            with self._tracer.bind_trace(entry.trace_id):
                inner = engine.submit(
                    entry.seq, msa=entry.msa, msa_mask=entry.msa_mask,
                    # None would fall back to the ENGINE's default
                    # deadline; a deadline-less fleet request must stay
                    # deadline-less
                    timeout=remaining if remaining is not None else 1e9,
                    # the fleet's id, not a fresh engine-minted one: a
                    # requeued request keeps one id across replicas
                    trace_id=entry.trace_id,
                    # featurized once (tier or inline), dispatched many:
                    # a requeue onto another replica reuses the bundle
                    # (row-truncated to this engine's budget above)
                    features=features,
                )
        except QueueFullError:
            return False
        except (CircuitOpenError, EngineClosedError) as e:
            if rep.name != DEGRADED:
                self._health.record_failure(rep.name, e.code)
            return False
        except ServingError as e:
            # semantic rejection (bad MSA shape etc.): the request is the
            # problem — terminal, no failover
            if hedge:
                return False
            self._resolve_failed(entry, e)
            return True
        with self._lock:
            rep.in_flight += 1
            rep.dispatches += 1
            entry.inflight_dispatches += 1
            self._dispatch_count += 1
        # routed accounting: which capability pool actually took it, and
        # that pool's queue-wait distribution (the per-pool autoscaling
        # signal — a saturated pool's wait climbs even while another
        # pool's sits at zero)
        self._routed_counter(rep.pool).inc()
        cell = {}
        if entry.features is not None:
            cell_fn = getattr(rep.engine, "cell_for", None)
            if cell_fn is not None:
                try:
                    cell = dict(cell_fn(entry.features.bucket))
                except Exception:  # noqa: BLE001 — a stub engine without
                    # real cells must not break routing
                    cell = {}
            # the engine cell's pool IS rep.pool (passed at build) —
            # drop it so the explicit kwarg below stays the one source
            cell.pop("pool", None)
        if hedge:
            with self._lock:
                counter = self._hedge_counters.get(rep.pool)
                if counter is None:
                    counter = self.registry.counter(
                        "fleet_hedge_total",
                        help="hedged (duplicate) dispatches per pool",
                        pool=rep.pool)
                    self._hedge_counters[rep.pool] = counter
            counter.inc()
            self.flights.note(
                entry.trace_id, "hedge", replica=rep.name, pool=rep.pool,
                age_s=round(now - entry.enqueued_at, 6), **cell)
        else:
            self.flights.note(
                entry.trace_id, "dispatch", replica=rep.name,
                pool=rep.pool,
                queue_wait_s=round(now - entry.enqueued_at, 6),
                requeues=entry.requeues, **cell)
            hist = self._pool_wait.get(rep.pool)
            if hist is not None:
                hist.observe(now - entry.enqueued_at)
            if self._hedger is not None:
                # register the PRIMARY dispatch for the hedger's age scan;
                # hedges themselves are never re-hedged
                with self._hedge_lock:
                    self._outstanding[id(entry)] = {
                        "entry": entry, "rep": rep.name,
                        "pool": rep.pool, "at": now, "hedged": False,
                    }
        dispatched_at = now
        inner.add_done_callback(
            lambda r, e=entry, rp=rep, t=dispatched_at:
            self._on_replica_done(e, rp, r, t))
        return True

    # ---------------------------------------------------- completion path

    def _on_replica_done(self, entry: FleetRequest, rep: _Replica,
                         inner, dispatched_at: float):
        """Runs on the replica worker (or drain) thread: resolve, or
        requeue onto another replica. Never blocks, never raises."""
        with self._lock:
            rep.in_flight -= 1
            entry.inflight_dispatches -= 1
            twin_in_flight = entry.inflight_dispatches > 0
        with self._hedge_lock:
            self._outstanding.pop(id(entry), None)
        result, exc = inner.peek()
        degraded = rep.name == DEGRADED
        if exc is None:
            if not degraded:
                self._health.record_success(rep.name)
            service_s = time.monotonic() - dispatched_at
            self._admission.note_served(service_s)
            hist = self._pool_service.get(rep.pool)
            if hist is not None:
                hist.observe(service_s)
            if self._budget is not None:
                self._budget.on_success()
            pool = self._pools.get(rep.pool)
            if pool is not None:
                # per-pool drain-rate EMA: what pool-quoted retry_after_s
                # estimates are built from
                with self._lock:
                    pool.service_ema_s = (
                        service_s if pool.service_ema_s is None
                        else 0.2 * service_s + 0.8 * pool.service_ema_s)
            tier_meta = ""
            if (self._cascade is not None and not degraded
                    and rep.pool == self._cascade.draft_pool):
                if entry.escalated:
                    # a late draft arrival (hedge twin of the scored
                    # dispatch) after the escalation decision: the full
                    # tier owns the outcome now. The chip-second/health
                    # accounting above already happened — just do not
                    # finish, settle or persist the superseded draft.
                    self.flights.note(entry.trace_id, "draft_superseded",
                                      replica=rep.name)
                    return
                if entry.tier == "draft" and not entry.done():
                    try:
                        verdict = self._cascade_scorer.score(result)
                    except Exception:  # noqa: BLE001 — a broken scorer
                        # must degrade to "verify everything", never to
                        # dropped requests or an unscored accept
                        verdict = CascadeVerdict(
                            accept=False, confidence=0.0, stress=0.0,
                            reason="scorer_error")
                    self._cascade_ledger.note_scored(verdict)
                    if verdict.accept:
                        entry.draft_accepted = True
                    else:
                        # ESCALATE: re-tag as full-tier and requeue; the
                        # FeatureBundle rides (featurization is never
                        # repaid), _route now excludes the draft pool,
                        # and the draft result is discarded unstored.
                        entry.escalated = True
                        entry.tier = "full"
                        length = (entry.features.length
                                  if entry.features is not None
                                  else len(entry.seq))
                        entry.pool = self._preferred_pool_name(
                            length, exclude=(self._cascade.draft_pool,))
                        self.flights.note(
                            entry.trace_id, "escalate",
                            reason=verdict.reason,
                            confidence=round(verdict.confidence, 4),
                            stress=round(verdict.stress, 4),
                            from_pool=rep.pool, to_pool=entry.pool)
                        if entry.pool is not None:
                            # the escalation is NEW demand on the verify
                            # pool — count the arrival where the headroom
                            # model will have to absorb it
                            with self._arrivals_lock:
                                self._arrivals[entry.pool] = (
                                    self._arrivals.get(entry.pool, 0) + 1)
                        self._admission.requeue(entry)
                        return
            if self._cascade is not None:
                if entry.draft_accepted:
                    tier_meta = "draft"
                elif entry.escalated:
                    tier_meta = "escalated"
                else:
                    tier_meta = "full"
            if entry._finish(result=result, replica=rep.name,
                             degraded=degraded, tier=tier_meta,
                             latency_s=time.monotonic() - entry.enqueued_at):
                self._counts["completed"].inc()
                self._latency.observe(time.monotonic() - entry.enqueued_at)
                if degraded:
                    self._degraded_total.inc()
                finish_extra = {}
                if self._cascade is not None:
                    finish_extra["tier"] = tier_meta
                    if entry.escalated:
                        finish_extra["tier_path"] = "draft->escalated"
                    elif entry.draft_accepted:
                        finish_extra["tier_path"] = "draft-accepted"
                    if result.exit_depth:
                        finish_extra["exit_depth"] = result.exit_depth
                    self._cascade_ledger.note_served(
                        tier_meta,
                        confidence=result.mean_confidence,
                        stress=result.stress,
                        exit_depth=result.exit_depth)
                self.flights.finish(
                    entry.trace_id, "completed", replica=rep.name,
                    pool=rep.pool, degraded=degraded,
                    requeues=entry.requeues,
                    from_cache=result.from_cache, bucket=result.bucket,
                    latency_s=round(
                        time.monotonic() - entry.enqueued_at, 6),
                    **finish_extra)
                self._journal_settle(entry.trace_id)
            elif entry.hedges > 0:
                # _finish lost the race on a HEDGED entry: this side is
                # the hedge pair's loser — its chip-seconds bought nothing
                # but the tail cut, on every card its mesh occupies
                self._hedge_waste.inc(service_s * _chips(rep))
                self.flights.note(entry.trace_id, "hedge_lost",
                                  replica=rep.name,
                                  wasted_s=round(service_s, 6))
            # settle even when _finish lost a race (the result is still
            # the coalition's answer) — store put + follower resolution
            self._settle_waiters(entry, result=result, rep=rep)
            return
        if twin_in_flight and not entry.done():
            # a hedge twin of this dispatch is still running — IT owns
            # the outcome now; requeueing here would double-dispatch
            if isinstance(exc, _REPLICA_FAULT_ERRORS) and not degraded:
                self._health.record_failure(rep.name, exc.code)
            self.flights.note(entry.trace_id, "hedge_twin_pending",
                              failed_on=rep.name,
                              code=getattr(exc, "code",
                                           type(exc).__name__))
            return
        if isinstance(exc, RequestTimeoutError):
            # the request's OWN deadline expired inside the replica —
            # failover could not have saved it
            self._resolve_shed(entry, "deadline", exc)
            return
        if isinstance(exc, _REPLICA_FAULT_ERRORS):
            if not degraded:
                self._health.record_failure(rep.name, exc.code)
            entry.failed_on.add(rep.name)
            entry.last_error = exc
            if not self._closed and entry.requeues < self.cfg.requeue_limit:
                if (self._budget is not None
                        and not self._budget.try_spend("failover")):
                    # fleet-wide brownout: every replica failing means
                    # every requeue is amplification — shed with honest
                    # backoff advice instead of dogpiling
                    self._resolve_shed(
                        entry, "retry_budget", RetryBudgetExhaustedError(
                            "failover retry denied: fleet-wide retry "
                            "budget exhausted",
                            retry_after_s=self._budget.retry_after_s()))
                    return
                entry.requeues += 1
                self._requeue_total.inc()
                self.flights.note(entry.trace_id, "requeue",
                                  failed_on=rep.name, code=exc.code)
                self._admission.requeue(entry)
                return
            if entry.requeues >= self.cfg.requeue_limit > 0:
                err = RequeueLimitError(
                    f"failed on {entry.requeues + 1} replica(s) "
                    f"(requeue_limit {self.cfg.requeue_limit}); last: "
                    f"{type(exc).__name__}: {exc}")
                err.__cause__ = exc
                self._resolve_failed(entry, err)
                return
        self._resolve_failed(entry, exc)

    # -------------------------------------------------- hedged dispatch

    def _hedge_delay(self, pool_name: str) -> Optional[float]:
        """How long a dispatch into `pool_name` may run before it earns
        a hedge: the pool's own service-time p95 x hedge_p95_factor
        (floored at hedge_min_delay_s). None — never hedge — until the
        histogram holds `hedge_min_samples` observations: hedging off a
        cold estimate would duplicate perfectly healthy traffic."""
        hist = self._pool_service.get(pool_name)
        if hist is None:
            return None  # degraded-tier dispatches are never hedged
        snap = hist.snapshot()
        if snap.get("count", 0) < self.cfg.hedge_min_samples:
            return None
        p95 = snap.get("p95") or 0.0
        if p95 <= 0.0:
            return None
        return max(self.cfg.hedge_min_delay_s,
                   p95 * self.cfg.hedge_p95_factor)

    def _hedge_loop(self):
        """Dedicated scanner (armed only when hedge_p95_factor > 0):
        wakes every tick and hedges any outstanding PRIMARY dispatch
        older than its pool's hedge delay. First settle wins via
        FleetRequest._finish's resolve-once; the loser's service time
        lands in hedge_wasted_chip_seconds_total."""
        while not self._stop.wait(self.cfg.tick_interval_s):
            try:
                self._hedge_scan()
            except Exception:  # noqa: BLE001 — the scanner must outlive
                # a bad snapshot; a dead hedger silently disables hedging
                traceback.print_exc()

    def _hedge_scan(self):
        now = time.monotonic()
        with self._hedge_lock:
            stale = [st for st in list(self._outstanding.values())
                     if not st["hedged"]]
        for st in stale:
            entry = st["entry"]
            if entry.done():
                continue
            delay = self._hedge_delay(st["pool"])
            if delay is None or now - st["at"] < delay:
                continue
            self._issue_hedge(entry, st)

    def _hedge_deny(self, reason: str):
        with self._hedge_lock:
            self._hedge_denied[reason] = (
                self._hedge_denied.get(reason, 0) + 1)
        self.registry.counter(
            "hedge_denied_total",
            help="hedges declined by reason (rate_cap / budget / "
                 "no_replica / dispatch_full)",
            reason=reason).inc()

    def _issue_hedge(self, entry: FleetRequest, st: dict):
        """One budgeted duplicate dispatch for a straggling primary.
        Order matters: the cheap global rate-cap check first, then
        target selection, and the retry-budget token last — spent only
        when a launch will actually be attempted."""
        with self._lock:
            dispatches = self._dispatch_count
        with self._hedge_lock:
            issued = self._hedges_issued
        if issued + 1 > max(1, dispatches) * self.cfg.hedge_rate_cap:
            self._hedge_deny("rate_cap")
            return
        length = (entry.features.length if entry.features is not None
                  else len(entry.seq))
        healthy = self._health.healthy_targets()
        primary = st["rep"]
        with self._lock:
            # same candidate discipline as _route, minus the primary's
            # replica and anything this entry already failed on — a
            # hedge onto the straggler itself would measure nothing
            targets = sorted(
                (r for r in (self._replicas.get(n) for n in healthy)
                 if r is not None and not r.retiring
                 and r.name != primary
                 and r.name not in entry.failed_on
                 and self._pools[r.pool].max_len >= length),
                key=lambda r: (self._pools[r.pool].rank, r.in_flight),
            )
        if not targets:
            self._hedge_deny("no_replica")
            return
        if self._budget is not None and not self._budget.try_spend("hedge"):
            self._hedge_deny("budget")
            return
        with self._hedge_lock:
            cur = self._outstanding.get(id(entry))
            if cur is not st or st["hedged"]:
                return  # the primary settled (or another scan won) first
            st["hedged"] = True
            self._hedges_issued += 1
        entry.hedges += 1
        for rep in targets:
            if self._try_dispatch(entry, rep, hedge=True):
                return
        # token spent but no engine admitted the duplicate — the attempt
        # still counts against the rate cap (conservative by design)
        self._hedge_deny("dispatch_full")

    # ------------------------------------------------- terminal accounting

    def _shed_counter(self, reason: str):
        with self._lock:
            counter = self._shed_reasons.get(reason)
            if counter is None:
                counter = self.registry.counter(
                    "fleet_shed_total", help="load shed by reason",
                    reason=reason)
                self._shed_reasons[reason] = counter
            return counter

    def _routed_counter(self, pool: str):
        """fleet_routed_total{pool} — lazy so the degraded tier (not a
        capability pool) gets its own row on first spill."""
        with self._lock:
            counter = self._routed.get(pool)
            if counter is None:
                counter = self.registry.counter(
                    "fleet_routed_total",
                    help="requests dispatched per capability pool "
                         "(degraded-tier spills under pool=degraded)",
                    pool=pool)
                self._routed[pool] = counter
            return counter

    def _count_error(self, exc):
        code = getattr(exc, "code", "serving_error")
        with self._lock:
            counter = self._errors.get(code)
            if counter is None:
                counter = self.registry.counter(
                    "fleet_errors_total",
                    help="terminal failures and rejections by stable code",
                    code=code)
                self._errors[code] = counter
        counter.inc()

    def _journal_settle(self, trace_id: str):
        """Unlink the trace's intake-journal record: called at every
        terminal path (result, typed error, shed) so a restart replays
        only truly unfinished work. No-op without a journal; settle()
        itself is idempotent, so racing terminal paths are harmless."""
        if self._journal is not None:
            self._journal.settle(trace_id)

    def _resolve_shed(self, entry: FleetRequest, reason: str,
                      exc: ServingError) -> bool:
        if entry._finish(exc=exc):
            self._counts["shed"].inc()
            self._shed_counter(reason).inc()
            self._count_error(exc)
            self.flights.finish(entry.trace_id, "shed", reason=reason,
                                code=getattr(exc, "code", "serving_error"),
                                requeues=entry.requeues)
            self._journal_settle(entry.trace_id)
            self._settle_waiters(entry, exc=exc)
            return True
        return False

    def _resolve_failed(self, entry: FleetRequest,
                        exc: BaseException) -> bool:
        if entry._finish(exc=exc):
            self._counts["failed"].inc()
            self._count_error(exc)
            self.flights.finish(entry.trace_id, "failed",
                                code=getattr(exc, "code",
                                             type(exc).__name__),
                                requeues=entry.requeues)
            self._journal_settle(entry.trace_id)
            self._settle_waiters(entry, exc=exc)
            return True
        return False

    def _settle_waiters(self, entry: FleetRequest, *, result=None,
                        rep: Optional[_Replica] = None,
                        exc: Optional[BaseException] = None):
        """Settle the coalition `entry` leads, at its terminal path:
        persist a successful full-fidelity result into the artifact
        store and resolve every follower with the same outcome. Runs on
        whatever thread resolved the leader; never under the fleet lock.
        Followers never settle (their `coalesced` flag short-circuits),
        so a follower failing through _resolve_failed cannot pop a NEW
        leader's coalition registered under the same key after ours."""
        if (self._frontdoor is None or entry.store_key is None
                or entry.coalesced):
            return
        tag, key = entry.store_key
        degraded = rep is not None and rep.name == DEGRADED
        if result is not None and rep is not None and not degraded:
            # persist under the tag of the pool that actually SERVED the
            # request: a failover to another pool means another weight
            # precision / SP plan, i.e. another keyspace — storing it
            # under the preferred pool's tag would alias wrong numerics.
            # Compare TAGS, not pool names: an ESCALATED entry has
            # entry.pool == rep.pool (the verify pool) but a store_key
            # minted at admit time under the DRAFT tag — keying on pool
            # names would persist a full-fidelity result under the draft
            # keyspace (the exact cross-tier aliasing the tags forbid).
            persist = True
            if rep.pool in self._pools:
                serving_tag = self._store_tag(rep.pool)
                if serving_tag != tag:
                    tag = serving_tag
                    f = entry.features
                    key = request_key(f.seq, f.msa, tag,
                                      msa_mask=f.msa_mask)
            if (self._cascade is not None
                    and rep.pool == self._cascade.draft_pool
                    and not entry.draft_accepted):
                # only ACCEPTED drafts may vouch for future lookups under
                # the draft tag; an unscored/rejected draft result (e.g.
                # a finish-race loser) must never enter the store
                persist = False
            if persist:
                # normalize provenance before persisting: a cached
                # artifact carries no replica/latency history (each
                # reader's result() copy re-stamps its own), and
                # from_cache=True by decode
                self._store.put_result(tag, key, dataclasses.replace(
                    result, from_cache=True, latency_s=0.0, replica="",
                    degraded=False, requeues=0, trace_id=""))
        followers = self._frontdoor.settle(entry.store_key)
        # followers are served BY the coalition, not by a dispatch of
        # their own — their copy reads from_cache=True like a store hit
        shared = (None if result is None
                  else dataclasses.replace(result, from_cache=True))
        leader_tier = entry._meta.get("tier", "") if entry.done() else ""
        for follower in followers:
            if shared is not None and rep is not None:
                latency = time.monotonic() - follower.enqueued_at
                if follower._finish(result=shared, replica=rep.name,
                                    degraded=degraded, tier=leader_tier,
                                    latency_s=latency):
                    self._counts["completed"].inc()
                    self._latency.observe(latency)
                    if degraded:
                        self._degraded_total.inc()
                    self.flights.finish(
                        follower.trace_id, "completed", replica=rep.name,
                        pool=rep.pool, degraded=degraded, coalesced=True,
                        leader=entry.trace_id, from_cache=True,
                        bucket=result.bucket, latency_s=round(latency, 6))
                    self._journal_settle(follower.trace_id)
            elif isinstance(exc, QueueFullError):
                self._resolve_shed(follower, "coalesced_leader_shed", exc)
            elif isinstance(exc, RequestTimeoutError):
                # the LEADER's deadline expired; followers carry their
                # own deadlines, but without a leader there is nothing
                # left in flight to serve them — shed with retry advice
                self._resolve_shed(follower, "coalesced_leader_deadline",
                                   exc)
            else:
                self._resolve_failed(
                    follower, exc if exc is not None else ServingError(
                        "coalesced leader resolved without an outcome"))

    # -------------------------------------------------- health callbacks

    def _probe_replica(self, name: str) -> bool:
        """End-to-end heartbeat: one tiny request through the replica's
        real dispatch path (unique sequence per probe so the result
        cache cannot vouch for a dead engine). Restarts the engine first
        if a drain tore it down. Runs on the health thread."""
        with self._lock:
            rep = self._replicas.get(name)
        if rep is None or rep.retiring:
            return False  # mid-retirement: never vouch for a leaving slot
        with self._lock:
            engine = rep.engine
        if engine is None or getattr(engine, "_closed", False):
            engine = rep.factory()
            if engine is None:
                return False
            with self._lock:
                rep.engine = engine
                rep.restarts += 1
        rep.probe_counter += 1
        n, seq = rep.probe_counter, []
        for _ in range(4):  # base-len(AA_ORDER) counter encoding
            seq.append(AA_ORDER[n % len(AA_ORDER)])
            n //= len(AA_ORDER)
        try:
            # probe_span accounts the round trip as "probe" badput MINUS
            # whatever the engine accounts during it (the probe's own
            # execute/compile) — sums-to-wall survives reinstatement
            # probes whose first dispatch compiles
            with self.goodput.probe_span(name):
                req = engine.submit("".join(seq),
                                    timeout=self.cfg.probe_timeout_s)
                req.result(timeout=self.cfg.probe_timeout_s)
            return True
        except (ServingError, TimeoutError):
            return False

    def _drain_replica(self, name: str, reason: str):
        """Health-thread callback: take the sick (or retiring) engine out
        of rotation and fail its queued work BACK through the requeue
        path (shutdown drain=False resolves everything pending with
        EngineClosedError, which `_on_replica_done` converts into
        requeues). Idempotent — a failure drain racing an autoscale
        retirement finds engine=None the second time and only runs the
        retirement bookkeeping (the no-double-drain pin)."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                return
            engine, rep.engine = rep.engine, None
            retiring = rep.retiring
            if retiring:
                # the drain has run: the slot leaves the pool for good
                # (the health monitor unregisters its target right after
                # this callback returns)
                self._replicas.pop(name, None)
        self._up_gauges[name].set(0)
        if self._incident_hook is not None:
            try:
                self._incident_hook("replica_drain", replica=name,
                                    reason=reason)
            except Exception:  # noqa: BLE001 — observability must never
                # take the supervisor down
                traceback.print_exc()
        if engine is not None:
            t0 = time.monotonic()
            engine.shutdown(drain=False, timeout=self.cfg.drain_timeout_s)
            _release_graphs(engine, self.cfg.drain_timeout_s)
            self.goodput.add(name, "drain", time.monotonic() - t0)

    def _reinstate_replica(self, name: str):
        gauge = self._up_gauges.get(name)
        if gauge is not None:
            gauge.set(1)
