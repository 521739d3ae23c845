"""Measurement of the port: the telemetry plane (counterpart of
alphafold2_tpu/telemetry/, less the multi-process names)
and the profiling tools on the card.

  * `trace`     — the span tracer, Chrome trace-event and JSONL exports,
                  `NULL_TRACER`;
  * `registry`  — counters / gauges / histograms, Prometheus exposition
                  and its parser, JSON snapshots;
  * `logger`    — `MetricsLogger`, the step-cadence JSONL stream;
  * `hooks`     — `CompileTracker`, host and device memory gauges, FLOP
                  gauges, `profile_trace` (JAX: `telemetry/profiling.py`);
  * `costs`     — the serving cost plane: per-executable cost cells, the
                  serve-goodput ledger, the flight book behind `/explainz`;
  * `goodput`   — the training plane: the goodput ledger, straggler and
                  data-stall detection, the trainers' ops-plane wiring;
  * `slo`       — declarative SLOs evaluated as burn rates;
  * `ops_plane` — the HTTP ops server (`/metrics`, `/healthz`, `/statusz`,
                  `/explainz`, `/profilez`, `/threadz`) and the incident
                  flight recorder.

The tools on the card (`python -m alphafold2_tpu_torch.telemetry.<name>`):
`profiling` (where a request's or a step's time goes) and the kernel
ablations `flash_ablation`, `dkv_ablation`, `quant_ablation`,
`sparse_ablation`; this package's `__init__` imports none of them.

Every instrumented call site defaults to the shared no-op singletons
(`NULL_TRACER`, `NULL_REGISTRY`, `NULL_TRAIN_TELEMETRY`): a run without
telemetry pays one boolean test a site and the same device work.
"""

from alphafold2_tpu_torch.telemetry.costs import (
    SERVE_CAUSES,
    ExecutableCostLedger,
    FlightBook,
    ServeGoodputLedger,
)
from alphafold2_tpu_torch.telemetry.goodput import (
    BUCKETS,
    NULL_TRAIN_TELEMETRY,
    GoodputLedger,
    StragglerDetector,
    TrainTelemetry,
    add_observability_args,
    build_train_telemetry,
    observability_enabled,
)
from alphafold2_tpu_torch.telemetry.hooks import (
    CompileTracker,
    device_memory_gauges,
    flops_gauges,
    host_memory_gauges,
    profile_trace,
)
from alphafold2_tpu_torch.telemetry.logger import MetricsLogger, per_process_metrics_path
from alphafold2_tpu_torch.telemetry.ops_plane import (
    FlightRecorder,
    OpsServer,
    ProfileBusyError,
    ProfileCapturer,
    ProfileRateLimitedError,
    ops_server_for_engine,
    ops_server_for_fleet,
)
from alphafold2_tpu_torch.telemetry.registry import (
    NULL_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    LatencyHistogram,
    MetricRegistry,
    flatten_snapshot,
    parse_prometheus_text,
)
from alphafold2_tpu_torch.telemetry.slo import (
    SloConfig,
    SloEngine,
    SloObjective,
    default_slo_config,
)
from alphafold2_tpu_torch.telemetry.trace import NULL_TRACER, Tracer, new_trace_id


def add_telemetry_args(ap):
    """The tracing flags of train_pre, train_end2end, serve and predict."""
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of this run's "
                         "phase spans here (open in Perfetto / "
                         "chrome://tracing); tracing is off (near-zero "
                         "cost) when unset")
    ap.add_argument("--trace-max-spans", type=int, default=100_000,
                    help="span retention bound; overflow is counted, "
                         "not silently discarded")


def tracer_from_args(args) -> Tracer:
    """A live tracer when --trace-out was given, NULL_TRACER otherwise."""
    if getattr(args, "trace_out", None):
        return Tracer(enabled=True, max_spans=args.trace_max_spans)
    return NULL_TRACER


def finish_trace(tracer: Tracer, args):
    """Export the trace at the end of a CLI run (no-op without
    --trace-out)."""
    if getattr(args, "trace_out", None) and tracer.enabled:
        tracer.export_chrome(args.trace_out)
        n = tracer.span_count
        print(f"wrote {args.trace_out} ({n} span(s)"
              + (f", {tracer.dropped} dropped" if tracer.dropped else "")
              + ")")


__all__ = [
    "BUCKETS",
    "CompileTracker",
    "Counter",
    "ExecutableCostLedger",
    "FlightBook",
    "FlightRecorder",
    "Gauge",
    "GoodputLedger",
    "Histogram",
    "LatencyHistogram",
    "MetricRegistry",
    "MetricsLogger",
    "NULL_REGISTRY",
    "NULL_TRACER",
    "NULL_TRAIN_TELEMETRY",
    "OpsServer",
    "ProfileBusyError",
    "ProfileCapturer",
    "ProfileRateLimitedError",
    "SERVE_CAUSES",
    "ServeGoodputLedger",
    "SloConfig",
    "SloEngine",
    "SloObjective",
    "StragglerDetector",
    "Tracer",
    "TrainTelemetry",
    "add_observability_args",
    "add_telemetry_args",
    "build_train_telemetry",
    "default_slo_config",
    "device_memory_gauges",
    "finish_trace",
    "flatten_snapshot",
    "flops_gauges",
    "host_memory_gauges",
    "new_trace_id",
    "observability_enabled",
    "ops_server_for_engine",
    "ops_server_for_fleet",
    "parse_prometheus_text",
    "per_process_metrics_path",
    "profile_trace",
    "tracer_from_args",
]
