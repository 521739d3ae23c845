"""The training observability plane (counterpart of
alphafold2_tpu/telemetry/goodput.py): the goodput ledger, data-stall
detection and the trainers' wiring.

`GoodputLedger` classifies every wall-clock second of a run into buckets
(`BUCKETS`): data fetch, batch assembly, compile (on the card: a step's
CUDA graph capture), step, eval, checkpoint, restore, preemption drain
and idle, idle being the remainder, so the buckets sum to the wall clock
by construction. Accounting is exclusive time: a nested `account()`
takes its seconds from the enclosing one. It publishes the goodput ratio
(step seconds / wall), badput by cause, per-step fetch and step
histograms, the analytic FLOP/s (`utils/flops.py`) and, under a declared
peak only, MFU; `health(horizon)` is "down" when no step completed
within the horizon (the trainer's `/healthz` 503).

`StragglerDetector` files a flight-recorder incident when one step's data
fetch takes more than `stall_fraction` of it for `patience` steps in a
row (`train_data_stall`).

Not ported: the JAX package's pod federation (`MetricFederation`,
`FederatedRegistryView`, `relabeled_exposition`, `--federate-every`) and
the detector's cross-process skew check (`observe_pod`, its
`train_straggler` incidents). The port runs one process; the training
telemetry over more than one, and `--federate-every`, raise (ROADMAP
A13).

`TrainTelemetry` is the bundle the trainer loops thread through
(`run_resilient(telemetry=)`, the CLIs' plain loops);
`build_train_telemetry` wires it from `add_observability_args`'s flags
(`--ops-port`, `--flight-dir`, ...). Every reader here (the ops plane's
threads) touches host state only.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional


from alphafold2_tpu_torch.telemetry.registry import NULL_REGISTRY, MetricRegistry

#: the ledger's bucket taxonomy. "idle" is never accounted directly —
#: it is the explicit remainder (wall minus every accounted second), so
#: the buckets sum to wall clock BY CONSTRUCTION and a double-counting
#: bug shows up as negative idle (clamped, asserted in tests).
BUCKETS = (
    "data_fetch",   # host-side batch fetch/assembly (the data pipeline)
    "assembly",     # host-to-device / global-batch assembly (pod path)
    "compile",      # the first step (on the card its capture) and later captures
    "step",         # step dispatch + device execution (the productive bucket)
    "eval",         # held-out eval forward
    "checkpoint",   # checkpoint save/verify
    "restore",      # crash-recovery episodes (restart + restore)
    "preempt",      # preemption drain: final save before Preempted
    "idle",         # everything else (supervisor overhead, logging, gaps)
)

#: buckets counted as productive in the goodput ratio. Compile, eval and
#: checkpoints are overhead a perfect run amortizes to ~zero (ScaleFold
#: moves eval off the training stream for exactly this reason).
GOODPUT_BUCKETS = ("step",)


class GoodputLedger:
    """Wall-clock bucket accounting for one training run (module docstring).

    Accounting calls (`account`, `step_complete`) belong to the training
    loop thread; readers (`snapshot`, `health`, the registry gauges) may
    run on the ops-plane HTTP/ticker threads — the internal lock covers
    that split, not concurrent accounting from two threads.

    Args:
      registry: metric sink (`NULL_REGISTRY` = totals only, no metrics).
      clock: injectable monotonic clock (tests drive time explicitly).
      process_index: stamped into `snapshot()`.
    """

    def __init__(self, registry: MetricRegistry = NULL_REGISTRY, *,
                 clock: Callable[[], float] = time.perf_counter,
                 process_index: int = 0):
        self.registry = registry
        self.process_index = process_index
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        self._buckets: Dict[str, float] = {
            b: 0.0 for b in BUCKETS if b != "idle"
        }
        self._stack: List[list] = []   # [bucket, t_enter, child_seconds]
        self._step_acc: Dict[str, float] = {}  # since last step_complete
        self._steps = 0
        self._compiled = False
        self._last_step_s = 0.0
        self._last_fetch_s = 0.0
        self._last_progress = self._t0
        self._step_flops: Optional[float] = None
        self._peak_flops: Optional[float] = None

    # ---------------------------------------------------------- accounting

    @contextlib.contextmanager
    def account(self, bucket: str):
        """Attribute the enclosed wall time to `bucket` (exclusive-time:
        a nested account claims its own seconds from the enclosing one)."""
        if bucket not in BUCKETS or bucket == "idle":
            raise ValueError(f"unknown ledger bucket {bucket!r}; "
                             f"expected one of {BUCKETS[:-1]}")
        frame = [bucket, self._clock(), 0.0]
        self._stack.append(frame)
        try:
            yield
        finally:
            now = self._clock()
            self._stack.pop()
            total = now - frame[1]
            self_dt = max(0.0, total - frame[2])
            with self._lock:
                self._buckets[bucket] += self_dt
                self._step_acc[bucket] = (
                    self._step_acc.get(bucket, 0.0) + self_dt
                )
            if self._stack:
                self._stack[-1][2] += total

    def step_bucket(self) -> str:
        """Bucket for the next step execution: "compile" until the first
        step completes (its wall time is the capture and first replay),
        "step" after."""
        return "step" if self._compiled else "compile"

    def step_complete(self, step: int) -> Dict[str, float]:
        """One optimizer step finished: fold the per-step accumulation
        into histograms/gauges and reset the progress watchdog. Returns
        {"step_s", "fetch_s"} (this step's execute and data-fetch
        seconds) — the stall detector's input."""
        now = self._clock()
        with self._lock:
            acc, self._step_acc = self._step_acc, {}
            step_s = acc.get("step", 0.0) + acc.get("compile", 0.0)
            fetch_s = acc.get("data_fetch", 0.0)
            self._steps += 1
            self._compiled = True
            self._last_step_s = step_s
            self._last_fetch_s = fetch_s
            self._last_progress = now
        self.registry.counter(
            "train_steps_total", help="completed optimizer steps").inc()
        self.registry.histogram(
            "train_step_seconds",
            help="per-step execute wall seconds (compile included at "
                 "step 0)").observe(step_s)
        self.registry.histogram(
            "train_fetch_seconds",
            help="per-step host data-fetch wall seconds").observe(fetch_s)
        self.publish()
        return {"step_s": step_s, "fetch_s": fetch_s}

    def set_workload(self, step_flops: float,
                     peak_flops: Optional[float] = None):
        """Arm the MFU math: analytic FLOPs of one optimizer step
        (utils/flops.py train_step_flops) and, when known, the chip's
        peak FLOP/s (None = publish achieved FLOP/s only — an honest
        absence beats an MFU against a guessed peak)."""
        with self._lock:
            self._step_flops = float(step_flops)
            self._peak_flops = (
                float(peak_flops) if peak_flops else None
            )

    # ------------------------------------------------------------- reading

    @property
    def last_step_seconds(self) -> float:
        with self._lock:
            return self._last_step_s

    @property
    def last_fetch_seconds(self) -> float:
        with self._lock:
            return self._last_fetch_s

    def wall(self) -> float:
        return self._clock() - self._t0

    def totals(self) -> Dict[str, float]:
        """{bucket: seconds} including the idle remainder — sums to
        `wall()` by construction (idle clamps at 0, so an accounting
        overlap bug surfaces as sum > wall, which the tests assert
        against)."""
        with self._lock:
            out = dict(self._buckets)
        out["idle"] = max(0.0, self.wall() - sum(out.values()))
        return out

    def goodput_ratio(self) -> float:
        wall = self.wall()
        if wall <= 0:
            return 0.0
        totals = self.totals()
        return sum(totals[b] for b in GOODPUT_BUCKETS) / wall

    def badput(self) -> Dict[str, float]:
        """{cause: seconds} — every non-productive bucket, idle included."""
        return {b: s for b, s in self.totals().items()
                if b not in GOODPUT_BUCKETS}

    def flops_per_sec(self) -> Optional[float]:
        with self._lock:
            step_flops, steps = self._step_flops, self._steps
        wall = self.wall()
        if step_flops is None or wall <= 0:
            return None
        return steps * step_flops / wall

    def mfu(self) -> Optional[float]:
        achieved = self.flops_per_sec()
        with self._lock:
            peak = self._peak_flops
        if achieved is None or peak is None or peak <= 0:
            return None
        return achieved / peak

    def publish(self):
        """Write the ledger state into the registry (called on every
        step_complete and every ops tick — so, like snapshot(), it is
        built from ONE totals read: every gauge of a publish describes
        the same instant, and the per-step hot path takes the lock
        once, not seven times)."""
        reg = self.registry
        totals = self.totals()
        wall = sum(totals.values())
        with self._lock:
            steps = self._steps
            step_flops, peak = self._step_flops, self._peak_flops
        reg.gauge("train_wall_seconds",
                  help="run wall-clock seconds (ledger lifetime)"
                  ).set(wall)
        for bucket, s in totals.items():
            reg.gauge("train_bucket_seconds",
                      help="wall seconds by ledger bucket (sums to "
                           "train_wall_seconds)", bucket=bucket).set(s)
        productive = sum(totals[b] for b in GOODPUT_BUCKETS)
        reg.gauge("train_goodput_ratio",
                  help="productive step seconds / wall seconds"
                  ).set(productive / wall if wall > 0 else 0.0)
        for cause, s in totals.items():
            if cause in GOODPUT_BUCKETS:
                continue
            reg.gauge("train_badput_seconds",
                      help="non-productive wall seconds by cause",
                      cause=cause).set(s)
        if step_flops is not None and wall > 0:
            achieved = steps * step_flops / wall
            reg.gauge("train_model_flops_per_sec",
                      help="analytic achieved model FLOP/s "
                           "(utils/flops.py, steps x step_flops / wall)"
                      ).set(achieved)
            if peak:
                reg.gauge("train_mfu",
                          help="achieved / peak FLOP/s (requires a "
                               "declared peak)").set(achieved / peak)

    def snapshot(self) -> dict:
        """JSON-ready ledger dump (the trainer `/statusz` payload).
        Every field derives from ONE totals read: `wall_s` is the bucket
        sum and the ratio divides by that same sum, so the sums-to-wall
        invariant — and the ratio's denominator — hold EXACTLY within
        one snapshot (a live `wall()` read microseconds later would
        already disagree), and the hot callers (every /statusz request,
        every flight-recorder bundle) take the lock once, not seven
        times."""
        totals = self.totals()
        wall = sum(totals.values())
        with self._lock:
            steps = self._steps
            last_step_s, last_fetch_s = self._last_step_s, self._last_fetch_s
            step_flops, peak = self._step_flops, self._peak_flops
        out = {
            "process": self.process_index,
            "wall_s": wall,
            "buckets": totals,
            "goodput_ratio": (
                sum(totals[b] for b in GOODPUT_BUCKETS) / wall
                if wall > 0 else 0.0
            ),
            "badput_s": {b: s for b, s in totals.items()
                         if b not in GOODPUT_BUCKETS},
            "steps": steps,
            "last_step_s": last_step_s,
            "last_fetch_s": last_fetch_s,
        }
        if step_flops is not None and wall > 0:
            achieved = steps * step_flops / wall
            out["model_flops_per_sec"] = achieved
            if peak:
                out["mfu"] = achieved / peak
        return out

    def health(self, horizon_s: float = 600.0) -> dict:
        """Progress-watchdog liveness: "down" when no step completed
        within `horizon_s` (measured from ledger start before the first
        step, so a wedged first compile eventually pages too). The ops
        plane maps "down" to HTTP 503."""
        with self._lock:
            age = self._clock() - self._last_progress
            steps = self._steps
        stalled = age > horizon_s
        return {
            "status": "down" if stalled else "ok",
            "steps": steps,
            "last_step_age_s": age,
            "horizon_s": horizon_s,
        }


# --- process topology ---------------------------------------------------------


def process_topology() -> tuple:
    """(this process's index, the process count): a `torch.distributed`
    group's rank and world size, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def refuse_multi_process(process_count: int, what: str):
    if process_count > 1:
        raise NotImplementedError(
            f"{what} over {process_count} processes: multi-process execution is not "
            f"ported to the PyTorch package yet (ROADMAP A13)")


# --- straggler / data-stall detection ----------------------------------------


class StragglerDetector:
    """Fires a flight-recorder incident when the input pipeline is the
    bottleneck: `train_data_stall` once a step's fetch time exceeds
    `stall_fraction` of its fetch+execute wall (`observe_local`) for
    `patience` CONSECUTIVE steps (one slow garbage-collection pause must
    not page). Sub-`min_seconds` fetches never trigger (microsecond noise
    on tiny test models is not a stall). Incidents fire ONCE per streak
    (re-armed when the signal recovers); `registry` gets a counter of
    them. (The JAX detector's pod skew check is not ported: ROADMAP A13.)
    """

    def __init__(self, *, recorder=None,
                 registry: MetricRegistry = NULL_REGISTRY,
                 stall_fraction: float = 0.5,
                 patience: int = 3, min_seconds: float = 0.005):
        if not 0.0 < stall_fraction < 1.0:
            raise ValueError(
                f"stall_fraction must be in (0, 1), got {stall_fraction}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.recorder = recorder
        self.registry = registry
        self.stall_fraction = stall_fraction
        self.patience = patience
        self.min_seconds = min_seconds
        self._streaks: Dict[tuple, int] = {}

    def _observe(self, key: tuple, bad: bool, kind: str, **attrs):
        streak = self._streaks.get(key, 0) + 1 if bad else 0
        self._streaks[key] = streak
        if streak != self.patience:  # fire once per streak, at patience
            return
        self.registry.counter(
            "train_incidents_total",
            help="straggler/data-stall detections", kind=kind).inc()
        if self.recorder is not None:
            self.recorder.incident(
                kind, patience=self.patience, **attrs)

    def observe_local(self, step: int, *, fetch_s: float, step_s: float):
        """Single-process data-stall check on one completed step."""
        total = fetch_s + step_s
        bad = (fetch_s > self.min_seconds
               and total > 0
               and fetch_s / total > self.stall_fraction)
        self._observe(("local_stall",), bad, "train_data_stall",
                      step=step, fetch_s=fetch_s, step_s=step_s,
                      fetch_fraction=(fetch_s / total if total else 0.0))


# --- trainer wiring -----------------------------------------------------------


class TrainTelemetry:
    """The per-run observability bundle the trainer loops thread through.

    `enabled=False` (the NULL_TRAIN_TELEMETRY singleton) makes every
    hook a no-op — an uninstrumented run pays one boolean test per site,
    the same contract as NULL_TRACER/NULL_REGISTRY.
    """

    def __init__(self, *, ledger: Optional[GoodputLedger] = None,
                 detector: Optional[StragglerDetector] = None,
                 recorder=None, ops=None, logger=None,
                 enabled: bool = True):
        self.enabled = enabled
        self.ledger = ledger if ledger is not None else GoodputLedger()
        self.detector = detector
        self.recorder = recorder
        self.ops = ops
        self.logger = logger

    def account(self, bucket: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return self.ledger.account(bucket)

    def step_bucket(self) -> str:
        return self.ledger.step_bucket() if self.enabled else "step"

    def step_complete(self, step: int):
        """Per-step bookkeeping: the ledger's step and the stall check."""
        if not self.enabled:
            return
        times = self.ledger.step_complete(step)
        if self.detector is not None:
            self.detector.observe_local(step, **times)

    def health(self, horizon_s: float = 600.0) -> dict:
        return self.ledger.health(horizon_s)

    def statusz(self) -> dict:
        # NO flight-recorder block here: this payload mounts as the ops
        # server's stats_fn, and OpsServer.statusz() already serves the
        # same recorder under its own top-level "flight_recorder" key —
        # embedding it twice would hand operators two copies to diverge
        out = {"goodput": self.ledger.snapshot()}
        if self.logger is not None and hasattr(self.logger, "tail"):
            out["loss_tail"] = self.logger.tail()
        return out

    def close(self):
        """Final publish + ops-plane shutdown (idempotent)."""
        if not self.enabled:
            return
        self.ledger.publish()
        if self.ops is not None:
            self.ops.stop()
            self.ops = None
        snap = self.ledger.snapshot()
        buckets = "  ".join(
            f"{b} {s:.1f}s" for b, s in sorted(snap["buckets"].items())
            if s > 0.05
        )
        print(f"goodput {snap['goodput_ratio']:.1%} over "
              f"{snap['wall_s']:.1f}s wall ({snap['steps']} steps): "
              f"{buckets}")


#: shared disabled bundle, the analog of NULL_TRACER / NULL_REGISTRY
NULL_TRAIN_TELEMETRY = TrainTelemetry(enabled=False)


def add_observability_args(ap):
    """The trainers' live-observability flags (train_pre.py and
    train_end2end.py), the JAX CLIs' block less its multi-process help."""
    ap.add_argument("--ops-port", type=int, default=None, metavar="PORT",
                    help="serve the live trainer ops plane on this port "
                         "(/metrics, /healthz progress watchdog, /statusz "
                         "goodput ledger + loss tail); 0 = ephemeral "
                         "(printed); unset = off")
    ap.add_argument("--ops-port-file", default=None, metavar="PATH",
                    help="write the bound ops port here (for parent "
                         "processes driving --ops-port 0)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="arm the training flight recorder: straggler / "
                         "data-stall incidents snapshot forensic bundles "
                         "here")
    ap.add_argument("--progress-horizon-s", type=float, default=600.0,
                    help="/healthz turns 503 when no step completed "
                         "within this many seconds")
    ap.add_argument("--federate-every", type=int, default=None,
                    help="multi-process runs: gather per-process telemetry "
                         "every N steps (not ported: set, it raises, "
                         "ROADMAP A13)")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="declared accelerator peak TFLOP/s for the "
                         "train_mfu gauge (unset = publish achieved "
                         "FLOP/s only)")


def observability_enabled(args) -> bool:
    """Whether the flags ask for the live plane (the trainers enable the
    metric registry when this OR tracing is on)."""
    return (getattr(args, "ops_port", None) is not None
            or getattr(args, "flight_dir", None) is not None)


def build_train_telemetry(args, *, registry: MetricRegistry,
                          tracer=None, logger=None,
                          step_flops: Optional[float] = None,
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> TrainTelemetry:
    """Wire the full training observability plane from the shared flag
    block. Returns NULL_TRAIN_TELEMETRY when nothing was asked for and
    the registry is disabled (the zero-cost default path)."""
    from alphafold2_tpu_torch.telemetry.hooks import (
        device_memory_gauges,
        host_memory_gauges,
    )
    from alphafold2_tpu_torch.telemetry.ops_plane import (
        FlightRecorder,
        OpsServer,
        write_atomic,
    )
    from alphafold2_tpu_torch.telemetry.trace import NULL_TRACER

    if getattr(args, "federate_every", None) is not None:
        raise NotImplementedError(
            "--federate-every: the metric federation across processes is not ported "
            "to the PyTorch package yet (ROADMAP A13)")
    if not observability_enabled(args) and not registry.enabled:
        return NULL_TRAIN_TELEMETRY
    if process_index is None or process_count is None:
        process_index, process_count = process_topology()
    refuse_multi_process(process_count, "the training telemetry")

    tracer = tracer if tracer is not None else NULL_TRACER
    ledger = GoodputLedger(registry, process_index=process_index)
    if step_flops is not None:
        peak = getattr(args, "peak_tflops", None)
        ledger.set_workload(step_flops,
                            peak_flops=peak * 1e12 if peak else None)

    recorder = None
    if getattr(args, "flight_dir", None):
        recorder = FlightRecorder(
            args.flight_dir, tracer=tracer, registry=registry,
            stats_fn=ledger.snapshot)
    detector = StragglerDetector(recorder=recorder, registry=registry)
    telemetry = TrainTelemetry(ledger=ledger, detector=detector,
                               recorder=recorder, logger=logger)

    if getattr(args, "ops_port", None) is not None:
        horizon = getattr(args, "progress_horizon_s", 600.0)
        ops = OpsServer(
            registry=registry,
            health_fn=lambda: telemetry.health(horizon),
            stats_fn=telemetry.statusz,
            tracer=tracer, recorder=recorder,
            port=args.ops_port,
        )
        # the ticker samples host memory and the caching allocator's
        # counters between steps (host reads only: safe during a capture)
        ops.add_tick(lambda: host_memory_gauges(registry))
        ops.add_tick(lambda: device_memory_gauges(registry))
        ops.add_tick(ledger.publish)
        ops.start()
        print(f"trainer ops plane on {ops.url} "
              f"(/metrics /healthz /statusz)")
        if getattr(args, "ops_port_file", None):
            write_atomic(args.ops_port_file, str(ops.port))  # readers never see ""
        telemetry.ops = ops
    return telemetry
