"""Serving entry point: drive the port's engine, or a fleet of its
replicas, over a FASTA stream (counterpart of the root serve.py).

Reads a many-record FASTA (or synthesizes one with --demo), submits every
record to the micro-batching engine (serving/engine.py) or to the fleet
(serving/fleet.py) with explicit backpressure handling, prints one line a
result and the stats snapshot (captured executables, batch occupancy,
latency quantiles, cache hit rate; the fleet's terminal outcomes, sheds,
requeues and replica states), and writes a CA-trace PDB a record with
--out-dir.

Usage:
  python -m alphafold2_tpu_torch.serve --fasta proteins.fasta --out-dir preds/
  python -m alphafold2_tpu_torch.serve --demo 24 --buckets 16,32 --max-batch 4 \\
      --mds-iters 8 --dim 16 --depth 1 --heads 2 --dim-head 8 --device cpu
  python -m alphafold2_tpu_torch.serve --demo 24 --ops-port 0 --flight-dir flights/ \\
      --trace-out trace.json --metrics-jsonl batches.jsonl --stats-json stats.json \\
      --stats-interval 5
  python -m alphafold2_tpu_torch.serve --demo 24 --replicas 3 --degrade-depth 3 \\
      --reprobe-interval 0.3 --degraded-weight-dtype int8 \\
      --fault-plan docs/examples/fleet_chaos_plan.json --stats-json fleet.json

Parameters come from `--ckpt-dir` (the newest verified checkpoint there,
`training/checkpoint.py`; the model flags must match the run that wrote
it), or else from `--seed` through the port's own init. A restore is
against the f32 twin of the config (checkpoints hold f32 masters; int8
quantizes them at build), and the engine's `params_tag` becomes
`<ckpt-dir>@step<N>`, so two checkpoints never share cached results.
Runs on the GPU, each (bucket, batch shape) a captured CUDA graph pair,
unless `--device cpu` is given.

The fleet tier (the JAX CLI's flags and defaults): `--replicas` > 1,
`--pools` or `--featurize-workers` > 0 select it; N replicas share the
device (on the card: one lock for their captures and calls, so they add
failover and capture isolation, not card capacity) behind one admission
queue (`--fleet-queue`), with failover (`--requeue-limit`), a degraded
tier (`--degraded-iters`, `--degraded-weight-dtype`, `--degrade-depth`),
health probes (`--probe-interval`, `--reprobe-interval`,
`--fail-threshold`), capability pools and a draft -> verify cascade
(`--pools`, `--cascade`), a featurization tier (`--featurize-workers`,
`--featurize-queue`), a fleet-wide artifact store (`--artifact-store`,
`--artifact-mem-entries`, `--artifact-mem-mb`, `--artifact-disk-mb`), an
intake journal (`--journal`, replayed at startup), a retry budget
(`--retry-budget`) and hedged dispatch (`--hedge-factor`,
`--hedge-rate-cap`). In fleet mode the watchdog defaults to 60 s (a hung
replica must fail for the failover to start). `--fault-plan` takes a
chaos plan (reliability/faults.py: replica faults in the fleet, dispatch
faults single-engine, a training kind never fires, as in the JAX CLI;
check one with `python -m alphafold2_tpu_torch.reliability.faults
--check`; `scale_flap` drives the autoscaler). The elastic replica autoscaler (serving/autoscale.py):
`--max-replicas` arms it (fleet tier), `--min-replicas` sets its floor,
`--scale-policy` its thresholds and hysteresis (a ScalePolicy JSON), and
`--scale-grace` keeps the process ticking after the replay so an idle
scale-down is seen; it runs on its own control thread, one scaler a pool
under `--pools`, and the stats JSON carries its `autoscale` block. The
sequence-parallel arm (serving/sp_arm.py): `--sp-shards N` runs each
bucket's trunk over N shards under the schedule the plan prices against
`--sp-hbm-gb` (the stats JSON's `sp` block); N shards take N distinct
cards (fewer raise, as the JAX CLI raises on fewer devices; over distinct
cards the engine refuses, naming ROADMAP A13, since a captured graph holds
one card's stream), and with `--device cpu` N CPU shards. A pool of
`--pools` takes `sp_shards` / `sp_schedules` the same way.
`--pipeline-depth N` arms pipelined dispatch in every engine (and every
replica): up to N batches enqueued on the card while a settle thread
realizes, bills and answers the ones before them (serving/engine.py).

Telemetry, the JAX CLI's single-engine flags: `--trace-out` (the request
lifecycle spans as a Chrome trace), `--metrics-jsonl` (one record a
batch), `--stats-interval` (flush `--stats-json` every N seconds too),
`--ops-port` (the ops plane, `telemetry/ops_plane.py`: /metrics, /healthz,
/statusz, /explainz, /threadz, and the SLO engine on the stock
`serving_*` objectives or `--slo-config`), `--ops-port-file`, `--ops-tick`,
`--flight-dir` (the incident flight recorder; with --ops-port also
/profilez, bounded `torch.profiler` captures under DIR/profiles, taken
under the card's lock so they never meet a capture) and `--peak-tflops`
(the serve_mfu gauge; no peak, no MFU). The fleet's ops server carries
the fleet registry and the stock `fleet_*` SLOs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import threading
import time
import traceback

import numpy as np
import torch

from alphafold2_tpu_torch.constants import AA_ORDER
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.geometry.pdb import coords_to_pdb
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_init
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.reliability.faults import FaultPlan
from alphafold2_tpu_torch.serving.artifact_store import ArtifactStore, ArtifactStoreConfig
from alphafold2_tpu_torch.serving.autoscale import ReplicaAutoscaler, ScalePolicy
from alphafold2_tpu_torch.serving.cascade import CascadePolicy
from alphafold2_tpu_torch.serving.engine import ServingConfig, ServingEngine
from alphafold2_tpu_torch.serving.errors import (
    NoHealthyReplicaError,
    QueueFullError,
    RequestTimeoutError,
    RetryBudgetExhaustedError,
    ServingError,
)
from alphafold2_tpu_torch.serving.executable import device_lock
from alphafold2_tpu_torch.serving.fleet import FleetConfig, PoolSpec, ServingFleet
from alphafold2_tpu_torch.serving.journal import IntakeJournal
from alphafold2_tpu_torch.telemetry import (
    FlightBook,
    FlightRecorder,
    MetricsLogger,
    ProfileCapturer,
    SloConfig,
    SloEngine,
    Tracer,
    add_telemetry_args,
    default_slo_config,
    device_memory_gauges,
    finish_trace,
    host_memory_gauges,
    ops_server_for_engine,
    ops_server_for_fleet,
    tracer_from_args,
)
from alphafold2_tpu_torch.telemetry.ops_plane import write_atomic
from alphafold2_tpu_torch.training.checkpoint import restore_params_for_inference


def read_fasta(path):
    """Plain FASTA records as (name, sequence) pairs."""
    records, name, parts = [], None, []

    def flush():
        if name is not None and parts:
            records.append((name, "".join(parts)))

    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith((";", "#")):
                continue
            if line.startswith(">"):
                flush()
                name, parts = line[1:].strip() or f"record{len(records)}", []
            else:
                if name is None:
                    name = f"record{len(records)}"
                parts.append(line)
    flush()
    if not records:
        raise SystemExit(f"no sequences found in {path!r}")
    return records


def demo_records(n, buckets, seed):
    """Synthetic mixed-length traffic spanning the whole ladder, with ~10%
    repeated queries so the result cache has something to hit."""
    rng = random.Random(seed)
    records = []
    for i in range(n):
        bucket = buckets[i % len(buckets)]
        lo = 2 if bucket == min(buckets) else max(b for b in buckets if b < bucket) + 1
        length = rng.randint(lo, bucket)
        seq = "".join(rng.choice(AA_ORDER) for _ in range(length))
        records.append((f"demo{i:03d}_L{length}", seq))
    for _ in range(max(1, n // 10)):
        src = records[rng.randrange(len(records))]
        records.append((src[0] + "_repeat", src[1]))
    rng.shuffle(records)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--fasta", help="multi-record FASTA of query sequences")
    src.add_argument("--demo", type=int, metavar="N", nargs="?", const=24,
                     help="synthesize N mixed-length demo sequences")
    ap.add_argument("--out-dir", default=None, help="write one CA-trace PDB per record")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dim-head", type=int, default=16)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--weight-dtype", choices=("f32", "int8"), default="f32",
                    help="int8: the engine serves per-channel int8 trunk weights, "
                         "quantized at build")
    ap.add_argument("--buckets", default="64,128,256", help="comma-separated length ladder")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--batch-ladder", action="store_true",
                    help="power-of-two batch shapes up to --max-batch")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="pipelined dispatch: keep up to this many batches enqueued but "
                         "unsettled so device compute overlaps host assembly and settle "
                         "(0 = synchronous dispatch)")
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="batch-assembly deadline for partial batches")
    ap.add_argument("--queue-size", type=int, default=64)
    ap.add_argument("--request-timeout", type=float, default=600.0,
                    help="per-request deadline, seconds")
    ap.add_argument("--cache-size", type=int, default=256)
    ap.add_argument("--mds-iters", type=int, default=32)
    ap.add_argument("--mds-init", choices=("random", "classical"), default="classical")
    ap.add_argument("--sp-shards", type=int, default=0,
                    help="run each bucket's trunk sequence-parallel over this many "
                         "shards (0 = dense): per-bucket schedule (dense / sp_msa / "
                         "sp_seq) picked by the residency heuristic; N distinct cards, "
                         "or N CPU shards with --device cpu")
    ap.add_argument("--sp-hbm-gb", type=float, default=16.0,
                    help="per-shard memory budget the SP schedule heuristic prices "
                         "buckets against")
    ap.add_argument("--precompile", action="store_true",
                    help="capture every (bucket, batch shape) before taking traffic")
    ap.add_argument("--breaker-threshold", type=int, default=0,
                    help="open the circuit after this many consecutive dispatch "
                         "failures (0 = breaker off)")
    ap.add_argument("--breaker-reset", type=float, default=30.0,
                    help="seconds the circuit stays open before the half-open probe")
    ap.add_argument("--watchdog-timeout", type=float, default=None,
                    help="fail a batch whose model call exceeds this many seconds "
                         "(off by default; fleet mode defaults it to 60 s: the "
                         "failover path needs hung replicas to FAIL)")
    ap.add_argument("--passes", type=int, default=1,
                    help="replay the stream this many times (later passes hit the cache)")
    ap.add_argument("--ckpt-dir", default=None, help="restore trained params")
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="positional-table size (default: the largest bucket, min 64; "
                         "2048 for a train_pre checkpoint)")
    ap.add_argument("--seed", type=int, default=0, help="seeds the parameters and --demo")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    ap.add_argument("--stats-json", default=None,
                    help="write the final stats snapshot here (includes "
                         "the telemetry section: registry metrics + "
                         "per-phase span summaries)")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    metavar="SECONDS",
                    help="with --stats-json: also flush the stats "
                         "snapshot there every N seconds DURING the "
                         "replay (atomic tmp+rename), so a crashed run "
                         "keeps its last periodic snapshot instead of "
                         "losing everything (0 = end-of-run only)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="stream one record per dispatched batch here")
    ap.add_argument("--ops-port", type=int, default=None, metavar="PORT",
                    help="serve the observability HTTP endpoints "
                         "(/metrics Prometheus exposition, /healthz, "
                         "/statusz) on 127.0.0.1:PORT while the replay "
                         "runs (0 = ephemeral port, printed at startup); "
                         "also arms the SLO engine (stock objectives "
                         "unless --slo-config)")
    ap.add_argument("--ops-port-file", default=None, metavar="PATH",
                    help="write the bound ops-plane port here once "
                         "listening (how a parent process finds an "
                         "--ops-port 0 ephemeral port)")
    ap.add_argument("--ops-tick", type=float, default=1.0,
                    metavar="SECONDS",
                    help="ops-plane ticker cadence: SLO evaluation, "
                         "flight-recorder metric-delta polling, host "
                         "memory gauges")
    ap.add_argument("--slo-config", default=None, metavar="SLO_JSON",
                    help="declarative SLO objectives (telemetry/slo.py "
                         "schema); default: stock availability/shed-rate/"
                         "latency objectives. Requires --ops-port (the "
                         "ticker evaluates it)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="arm the incident flight recorder: breaker "
                         "opens, watchdog fires, and SLO pages snapshot a "
                         "forensic JSON bundle (recent spans incl. "
                         "trace_ids, event ring, registry snapshot, stats) "
                         "into DIR; with --ops-port it also arms /profilez "
                         "(on-demand torch.profiler captures land under "
                         "DIR/profiles)")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="declared per-chip peak TFLOP/s for the "
                         "serve_mfu cost-ledger gauge (unset = publish "
                         "achieved FLOP/s only)")
    add_telemetry_args(ap)  # --trace-out / --trace-max-spans
    # the fleet tier (serving/fleet.py)
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the shared admission queue; >1 selects "
                         "the fleet tier")
    ap.add_argument("--fleet-queue", type=int, default=64,
                    help="shared admission-queue capacity (fleet mode)")
    ap.add_argument("--requeue-limit", type=int, default=3,
                    help="replica failovers per request before it fails terminally "
                         "(fleet mode)")
    ap.add_argument("--degraded-iters", type=int, default=-1,
                    help="MDS iterations for the degraded fallback tier; -1 = auto "
                         "(max(1, mds_iters // 4)), 0 = no degraded tier (fleet mode)")
    ap.add_argument("--degraded-weight-dtype", choices=("", "f32", "int8"), default="",
                    help="weight precision for the degraded fallback tier (int8 = "
                         "per-channel int8 trunk weights; fleet mode; composes with "
                         "--degraded-iters)")
    ap.add_argument("--degrade-depth", type=int, default=0,
                    help="admission-queue depth past which NEW work spills to the "
                         "degraded tier (0 = degraded serves only when every full "
                         "replica is down)")
    ap.add_argument("--probe-interval", type=float, default=5.0,
                    help="healthy-replica heartbeat cadence, seconds")
    ap.add_argument("--reprobe-interval", type=float, default=0.5,
                    help="down-replica reinstatement probe cadence, seconds")
    ap.add_argument("--fail-threshold", type=int, default=2,
                    help="consecutive replica failures that drain it")
    ap.add_argument("--pools", default=None, metavar="POOLS_JSON",
                    help="heterogeneous capability pools: a JSON list of PoolSpec "
                         "dicts, inline or a file path; selects the fleet tier")
    ap.add_argument("--cascade", default="off", metavar="POLICY_JSON",
                    help="draft -> verify cascade (serving/cascade.py; requires "
                         "--pools): a CascadePolicy JSON, inline or a file path; "
                         "'off' (default) keeps static pool routing")
    ap.add_argument("--featurize-workers", type=int, default=0,
                    help="CPU featurization worker threads in front of the admission "
                         "queue (0 = featurize inline); >0 selects the fleet tier")
    ap.add_argument("--featurize-queue", type=int, default=128,
                    help="featurize-tier bounded queue capacity")
    ap.add_argument("--min-replicas", type=int, default=None,
                    help="autoscaler floor (requires --max-replicas)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="autoscaler ceiling; setting it arms the elastic replica "
                         "autoscaler (fleet tier), which grows and shrinks the pool live "
                         "from queue-wait p95 / occupancy / SLO burn")
    ap.add_argument("--scale-policy", default=None, metavar="POLICY_JSON",
                    help="autoscaler thresholds and hysteresis (a ScalePolicy JSON; "
                         "unknown keys are refused); default: the stock policy with the "
                         "--min/--max-replicas bounds")
    ap.add_argument("--scale-grace", type=float, default=0.0, metavar="SECONDS",
                    help="with the autoscaler armed: keep the process alive (idle, still "
                         "ticking) up to this long after the replay drains, so an idle "
                         "scale-down is observable before shutdown")
    ap.add_argument("--fault-plan", default=None, metavar="PLAN_JSON",
                    help="chaos schedule (reliability/faults.py FaultPlan JSON): "
                         "replica-scoped kill/slow/flap faults in fleet mode, dispatch "
                         "faults single-engine")
    ap.add_argument("--artifact-store", default="off", metavar="DIR",
                    help="fleet-wide content-addressed result/feature cache with "
                         "front-door coalescing: a directory for the disk tier, "
                         "'auto' (an 'artifacts/' sibling of --flight-dir, memory-only "
                         "without one) or 'off' (default). Fleet mode only")
    ap.add_argument("--journal", default="off", metavar="DIR",
                    help="durable intake journal: every accepted request written to "
                         "DIR before dispatch and unlinked at its terminal state, the "
                         "unfinished ones replayed at startup; 'auto' (a 'journal/' "
                         "sibling of --flight-dir) or 'off' (default). Fleet mode only")
    ap.add_argument("--retry-budget", type=int, default=0, metavar="N",
                    help="fleet-wide retry budget: a token bucket of N tokens shared by "
                         "featurize requeues, failover retries and hedges (0 = off)")
    ap.add_argument("--hedge-factor", type=float, default=0.0, metavar="X",
                    help="hedged dispatch: a dispatch past X x its pool's service-time "
                         "p95 gets one duplicate on another healthy replica (0 = off)")
    ap.add_argument("--hedge-rate-cap", type=float, default=0.1, metavar="FRAC",
                    help="upper bound on hedges as a fraction of dispatches")
    ap.add_argument("--artifact-mem-entries", type=int, default=256, metavar="N",
                    help="artifact-store hot-ring entry cap")
    ap.add_argument("--artifact-mem-mb", type=int, default=256, metavar="MB",
                    help="artifact-store hot-ring byte budget")
    ap.add_argument("--artifact-disk-mb", type=int, default=2048, metavar="MB",
                    help="artifact-store disk-tier byte budget")
    args = ap.parse_args(argv)
    # the JAX CLI's pairing checks
    if args.min_replicas is not None and args.max_replicas is None:
        ap.error("--min-replicas requires --max-replicas (the pair arms the autoscaler)")
    if args.scale_policy and args.max_replicas is None:
        ap.error("--scale-policy requires --max-replicas (nothing evaluates a policy "
                 "without the autoscaler armed)")
    if args.scale_grace and args.max_replicas is None:
        ap.error("--scale-grace requires --max-replicas")
    if args.featurize_workers < 0:
        ap.error("--featurize-workers must be >= 0")
    if args.artifact_mem_entries < 1:
        ap.error("--artifact-mem-entries must be >= 1")
    if args.retry_budget < 0:
        ap.error("--retry-budget must be >= 0 (0 disables it)")
    if args.hedge_factor < 0:
        ap.error("--hedge-factor must be >= 0 (0 disables hedging)")
    if not (0.0 < args.hedge_rate_cap <= 1.0):
        ap.error("--hedge-rate-cap must be in (0, 1]")
    if args.artifact_mem_mb < 1 or args.artifact_disk_mb < 1:
        ap.error("--artifact-mem-mb / --artifact-disk-mb must be >= 1")
    if args.slo_config and args.ops_port is None:
        ap.error("--slo-config requires --ops-port (the ops-plane ticker "
                 "is what evaluates the objectives)")
    if args.stats_interval and not args.stats_json:
        ap.error("--stats-interval requires --stats-json (it needs a "
                 "path to flush to)")
    if args.stats_interval < 0:
        ap.error("--stats-interval must be positive (0 disables the "
                 "periodic flush)")
    if args.ops_port_file and args.ops_port is None:
        ap.error("--ops-port-file requires --ops-port (there is no port "
                 "to publish without the ops server)")
    if args.ops_tick <= 0:
        ap.error("--ops-tick must be positive")

    buckets = tuple(sorted({int(b) for b in args.buckets.split(",")}))
    # capability pools, before the model config: the positional table must
    # cover the widest pool ladder, and the demo stream should span it
    pools = ()
    if args.pools:
        raw = args.pools
        if os.path.exists(raw):
            with open(raw) as fh:
                raw = fh.read()
        try:
            pool_dicts = json.loads(raw)
        except ValueError as e:
            ap.error(f"--pools is neither a file nor valid JSON: {e}")
        if not isinstance(pool_dicts, list) or not pool_dicts:
            ap.error("--pools must be a non-empty JSON list of pool dicts")
        try:
            # `is not None`: an empty buckets list must reach PoolSpec's
            # non-empty check, not decay into "inherit the base ladder"
            pools = tuple(PoolSpec(**{**d, "buckets": tuple(d["buckets"])
                                      if d.get("buckets") is not None else None})
                          for d in pool_dicts)
        except (TypeError, ValueError) as e:
            ap.error(f"--pools: {e}")
    if pools and args.sp_shards:
        ap.error("--sp-shards and --pools are mutually exclusive: with pools configured, "
                 "declare sp_shards per pool in the pools JSON")
    cascade_policy = None
    if args.cascade != "off":
        if not pools:
            ap.error("--cascade requires --pools: the draft tier is a capability pool "
                     "(give it int8 weights / fewer mds_iters / reduced msa_rows in the "
                     "pools JSON)")
        try:
            cascade_policy = (CascadePolicy.from_file(args.cascade)
                              if os.path.exists(args.cascade)
                              else CascadePolicy.from_dict(json.loads(args.cascade)))
        except ValueError as e:
            ap.error(f"--cascade: {e}")
    union_buckets = tuple(sorted(set(buckets).union(*[p.buckets or buckets for p in pools])))
    injector = None
    if args.fault_plan:
        plan = FaultPlan.from_file(args.fault_plan)
        injector = plan.injector()
        print(f"fault plan: {len(plan.faults)} fault(s) from {args.fault_plan}")
    autoscale_armed = args.max_replicas is not None
    min_replicas = args.min_replicas if args.min_replicas is not None else 1
    fleet_mode = (args.replicas > 1 or autoscale_armed or args.featurize_workers > 0
                  or bool(pools))
    initial_replicas = args.replicas
    if autoscale_armed:
        if args.max_replicas < min_replicas:
            ap.error("--max-replicas must be >= --min-replicas")
        initial_replicas = min(max(args.replicas, min_replicas), args.max_replicas)
    # the SP meshes' devices: N CPU shards with --device cpu, else (None) N
    # distinct cards, which the engine refuses past one card (ROADMAP A13)
    sp_shards = max([args.sp_shards] + [p.sp_shards for p in pools])
    sp_devices = (["cpu"] * sp_shards
                  if sp_shards and resolve_device(args.device).type == "cpu" else None)

    records = (demo_records(args.demo, union_buckets, args.seed) if args.demo is not None
               else read_fasta(args.fasta))
    print(f"{len(records)} request(s), bucket ladder {buckets}"
          + (f", pools {[p.name for p in pools]} (union ladder {union_buckets})"
             if pools else ""))
    cfg = Alphafold2Config(dim=args.dim, depth=args.depth, heads=args.heads,
                           dim_head=args.dim_head,
                           max_seq_len=args.max_seq_len or max(64, union_buckets[-1]),
                           dtype=torch.bfloat16 if args.bf16 else torch.float32,
                           weight_dtype=args.weight_dtype)
    restore_cfg = dataclasses.replace(cfg, weight_dtype="f32")
    params, step, _ = restore_params_for_inference(
        args.ckpt_dir,
        lambda: alphafold2_init(restore_cfg, torch.Generator().manual_seed(args.seed),
                                args.device))
    # the cache's fingerprint: two checkpoints never share result entries
    params_tag = f"{args.ckpt_dir}@step{step}" if args.ckpt_dir else ""
    logger = (MetricsLogger(jsonl_path=args.metrics_jsonl, print_every=None)
              if args.metrics_jsonl else None)
    tracer = tracer_from_args(args)  # NULL_TRACER unless --trace-out
    if (args.ops_port is not None or args.flight_dir) and not tracer.enabled:
        # the ops plane and the flight recorder read spans (/statusz, the
        # bundles' tails): a live tracer even without --trace-out
        tracer = Tracer(enabled=True, max_spans=args.trace_max_spans)
    # built before the engine: it is the engine's incident hook
    recorder = FlightRecorder(args.flight_dir, tracer=tracer) if args.flight_dir else None
    serving_cfg = ServingConfig(
        buckets=buckets, max_batch=args.max_batch, max_queue=args.queue_size,
        max_wait_s=args.max_wait_ms / 1000.0, request_timeout_s=args.request_timeout,
        cache_capacity=args.cache_size, mds_iters=args.mds_iters, mds_init=args.mds_init,
        seed=args.seed, precompile=args.precompile, params_tag=params_tag,
        sp_shards=args.sp_shards, sp_hbm_gb=args.sp_hbm_gb,
        batch_ladder=args.batch_ladder, pipeline_depth=args.pipeline_depth,
        breaker_threshold=args.breaker_threshold,
        breaker_reset_s=args.breaker_reset,
        # the fleet's liveness needs hung replicas to FAIL (the failover
        # path starts from a failure, never from a hang)
        watchdog_timeout_s=(args.watchdog_timeout if args.watchdog_timeout is not None
                            else (60.0 if fleet_mode else None)))
    if args.artifact_store != "off" and not fleet_mode:
        print("WARNING: --artifact-store applies to fleet mode only (--replicas > 1, "
              "pools or the featurize tier); single-engine mode keeps its per-engine "
              "result LRU")
    if args.journal != "off" and not fleet_mode:
        print("WARNING: --journal applies to fleet mode only (the fleet front door is "
              "where requests are accepted and settled); single-engine mode takes no "
              "journal")
    journal_replays = []  # (name, seq, FleetRequest) recovered from a journal
    if fleet_mode:
        if logger is not None:
            # one record a batch is an engine's stream; N replica workers
            # would interleave it
            print("WARNING: --metrics-jsonl applies to single-engine mode only; fleet "
                  "observability is --stats-json (registry snapshot incl. per-replica "
                  "engine stats) + --trace-out")
            logger.close()
            logger = None
        degraded_iters = (max(1, args.mds_iters // 4) if args.degraded_iters < 0
                          else args.degraded_iters)
        artifact_store = None
        if args.artifact_store != "off":
            if args.artifact_store == "auto":
                # beside --flight-dir; memory-only without one
                store_root = (os.path.join(os.path.dirname(os.path.abspath(args.flight_dir)),
                                           "artifacts") if args.flight_dir else None)
            else:
                store_root = args.artifact_store
            artifact_store = ArtifactStore(ArtifactStoreConfig(
                root=store_root, memory_entries=args.artifact_mem_entries,
                memory_bytes=args.artifact_mem_mb << 20,
                disk_bytes=args.artifact_disk_mb << 20))
            print("artifact store: "
                  + (f"disk tier at {store_root}" if store_root
                     else "memory-only (no --flight-dir to anchor 'auto' disk tier)")
                  + f", hot ring {args.artifact_mem_entries} entries / "
                    f"{args.artifact_mem_mb} MB")
        journal = None
        if args.journal != "off":
            journal_root = ((os.path.join(os.path.dirname(os.path.abspath(args.flight_dir)),
                                          "journal") if args.flight_dir else None)
                            if args.journal == "auto" else args.journal)
            if journal_root is None:
                print("WARNING: --journal auto needs --flight-dir to anchor a directory; "
                      "journal stays OFF")
            else:
                journal = IntakeJournal(journal_root)
                print(f"intake journal: {journal_root}")
        engine = ServingFleet(
            params, cfg, serving_cfg,
            FleetConfig(
                replicas=initial_replicas, queue_capacity=args.fleet_queue,
                default_timeout_s=args.request_timeout, requeue_limit=args.requeue_limit,
                degraded_mds_iters=degraded_iters,
                degraded_weight_dtype=args.degraded_weight_dtype,
                degrade_depth=args.degrade_depth, probe_interval_s=args.probe_interval,
                reprobe_interval_s=args.reprobe_interval,
                fail_threshold=args.fail_threshold,
                featurize_workers=args.featurize_workers,
                featurize_queue=args.featurize_queue, pools=pools,
                retry_budget_capacity=args.retry_budget,
                hedge_p95_factor=args.hedge_factor, hedge_rate_cap=args.hedge_rate_cap,
                cascade_policy=cascade_policy),
            injector=injector, tracer=tracer,
            incident_hook=recorder.incident if recorder else None,
            artifact_store=artifact_store, journal=journal, device=args.device,
            sp_devices=sp_devices)
        degraded_desc = ", ".join(
            ([f"mds_iters={degraded_iters}"] if degraded_iters else [])
            + ([f"weights={args.degraded_weight_dtype}"]
               if args.degraded_weight_dtype == "int8" else []))
        print(f"fleet on {engine.device}: {initial_replicas} replica(s), shared queue "
              f"{args.fleet_queue}, featurize tier "
              + (f"{args.featurize_workers} worker(s)" if args.featurize_workers else "OFF")
              + (f", pipelined dispatch, depth {args.pipeline_depth}"
                 if args.pipeline_depth else "")
              + ", degraded tier " + (degraded_desc or "OFF")
              + (f", retry budget {args.retry_budget}" if args.retry_budget else "")
              + (f", hedging p95 x{args.hedge_factor:g} (cap {args.hedge_rate_cap:g})"
                 if args.hedge_factor else "")
              + (f", cascade draft_pool={cascade_policy.draft_pool!r} "
                 f"min_confidence={cascade_policy.min_confidence:g}"
                 if cascade_policy is not None else ""))
        if journal is not None:
            # replayed before fresh traffic: coalescing and the store make
            # it idempotent (completed work replays as a hit)
            replayed = engine.replay_journal()
            if replayed["replayed"] or replayed["expired"]:
                print(f"journal replay: {replayed['replayed']} re-submitted, "
                      f"{replayed['expired']} expired, {replayed['failed']} rejected")
            journal_replays = [(f"journal_{req.trace_id}", req.seq, req)
                               for req in replayed["requests"]]
        registry = engine.registry
    else:
        engine = ServingEngine(
            params, cfg, serving_cfg, device=args.device, sp_devices=sp_devices,
            metrics_logger=logger,
            fault_hook=injector.serving_hook() if injector else None, tracer=tracer,
            incident_hook=recorder.incident if recorder else None,
            # the flights' one reader is the ops plane's /explainz
            flights=FlightBook() if args.ops_port is not None else None)
        snap = engine.stats()
        print(f"engine on {engine.device}; weights {snap['weights']['weight_dtype']}"
              + (f"; pipelined dispatch, depth {args.pipeline_depth}"
                 if args.pipeline_depth else "")
              + (f"; SP plan over {args.sp_shards} shards on {snap['sp']['devices']}: "
                 + ", ".join(f"{b}={r['schedule']}" for b, r in snap["sp"]["schedules"].items())
                 if args.sp_shards else ""))
        registry = engine.metrics.registry
    if recorder is not None:
        recorder.bind(registry=registry, stats_fn=engine.stats)
    if args.peak_tflops:
        engine.costs.set_peak(args.peak_tflops * 1e12)

    # the elastic replica autoscaler (serving/autoscale.py)
    scaler = scale_policy = None
    pool_scalers = []
    if autoscale_armed:
        try:
            scale_policy = (ScalePolicy.from_file(args.scale_policy) if args.scale_policy
                            else ScalePolicy())
            # the CLI's bounds armed the scaler; they win over the file's
            scale_policy = dataclasses.replace(scale_policy, min_replicas=min_replicas,
                                               max_replicas=args.max_replicas)
        except (OSError, ValueError, TypeError) as e:
            engine.shutdown(drain=False)
            ap.error(f"--scale-policy: {e}")
        hooks = dict(incident_hook=recorder.incident if recorder else None)
        if pools:
            # one autoscaler a capability pool, each on its pool's signals
            # (the CLI's bounds apply per pool)
            pool_scalers = [
                ReplicaAutoscaler(engine, scale_policy, pool=spec.name,
                                  fault_hook=injector.autoscale_hook() if injector else None,
                                  **hooks)
                for spec in pools]
        else:
            scaler = ReplicaAutoscaler(
                engine, scale_policy,
                fault_hook=injector.autoscale_hook() if injector else None, **hooks)
        print(f"autoscaler" + (f" (per-pool x{len(pool_scalers)})" if pools else "")
              + f": replicas in [{scale_policy.min_replicas}, {scale_policy.max_replicas}], "
                f"up @ p95>={scale_policy.up_queue_wait_p95_s}s | "
                f"burn>={scale_policy.up_burn} | occ>={scale_policy.up_occupancy}, "
                f"cooldowns {scale_policy.up_cooldown_s}/{scale_policy.down_cooldown_s}s")

    ops = slo = None
    if args.ops_port is not None:
        slo_cfg = (SloConfig.from_file(args.slo_config) if args.slo_config
                   else default_slo_config("fleet" if fleet_mode else "serving"))
        slo = SloEngine(registry, slo_cfg,
                        on_page=recorder.slo_page_hook if recorder else None)
        profiler = None
        if args.flight_dir:
            # the card's lock: every replica's captures and calls take it
            profiler = ProfileCapturer(os.path.join(args.flight_dir, "profiles"),
                                       registry=registry,
                                       lock=device_lock(resolve_device(args.device)))
        make_ops = ops_server_for_fleet if fleet_mode else ops_server_for_engine
        ops = make_ops(engine, tracer=tracer, slo=slo, recorder=recorder, profiler=profiler,
                       port=args.ops_port, tick_interval_s=args.ops_tick)
        # host reads only (the ticker runs while a worker captures)
        ops.add_tick(lambda: host_memory_gauges(registry))
        ops.add_tick(lambda: device_memory_gauges(registry))
        ops.add_tick(engine.sample_gauges)
        ops.start()
        print(f"ops plane listening on {ops.url} (/metrics /healthz /statusz)")
        if args.ops_port_file:
            write_atomic(args.ops_port_file, str(ops.port))
    for sc in ([scaler] if scaler is not None else []) + pool_scalers:
        # its own control thread at the ticker's cadence: a scale-up's
        # engine build captures for seconds, which must not stall the
        # shared ticker's SLO, recorder and gauge work
        sc.start(args.ops_tick)

    stats_stop = threading.Event()
    stats_thread = None
    if args.stats_interval:
        def flush_stats():
            while not stats_stop.wait(args.stats_interval):
                try:
                    write_atomic(args.stats_json, json.dumps(engine.stats(), indent=2))
                except Exception:  # noqa: BLE001 — a flush must not stop the replay
                    traceback.print_exc()

        stats_thread = threading.Thread(target=flush_stats, name="af2-stats-flusher",
                                        daemon=True)
        stats_thread.start()

    t0 = time.time()
    # journal-recovered requests drain through the same loop as fresh ones
    pending, failures, shed = list(journal_replays), 0, 0
    max_submit_retries = 200  # the replay client's patience a record
    for pass_idx in range(max(1, args.passes)):
        for name, seq in records:
            if pass_idx:
                name = f"{name}_p{pass_idx + 1}"
            retries = 0
            while True:
                try:
                    pending.append((name, seq, engine.submit(seq)))
                    break
                except (QueueFullError, RetryBudgetExhaustedError) as e:
                    # honor the backoff advice, impatiently enough that a
                    # demo replay finishes
                    retries += 1
                    if retries > max_submit_retries:
                        print(f"SHED {name}: [{e.code}] {e}")
                        shed += 1
                        break
                    time.sleep(min(0.1, e.retry_after_s or 0.005))
                except ServingError as e:
                    print(f"REJECTED {name}: [{e.code}] {e}")
                    failures += 1
                    break
        if pass_idx + 1 < max(1, args.passes):  # a later pass replays a settled one
            for _, _, req in pending:
                try:
                    req.result()
                except ServingError:
                    pass

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    used = set()
    for name, seq, req in pending:
        try:
            res = req.result()
        except ServingError as e:
            retry = (f" (retry_after={e.retry_after_s:.2f}s)"
                     if e.retry_after_s is not None else "")
            if isinstance(e, (QueueFullError, RequestTimeoutError, NoHealthyReplicaError,
                              RetryBudgetExhaustedError)):
                # a structured load shed: a terminal outcome, not a bug
                print(f"SHED {name}: [{e.code}] HTTP {e.http_status} {e}{retry}")
                shed += 1
            else:
                print(f"FAILED {name}: [{e.code}] {e}{retry}")
                failures += 1
            continue
        tag = " (cache)" if res.from_cache else ""
        if res.replica:
            tag += f" [{res.replica}]"
        if res.requeues:
            tag += f" (requeued x{res.requeues})"
        if res.degraded:
            tag += " (DEGRADED)"
        if res.tier:
            tag += f" tier={res.tier}" + (f"@exit{res.exit_depth}" if res.exit_depth else "")
        print(f"{name}: L={len(seq)} bucket={res.bucket} stress={res.stress:.3f} "
              f"conf={100 * res.mean_confidence:.1f}/100 lat={res.latency_s * 1000:.0f}ms"
              + tag + (f" tid={res.trace_id}" if res.trace_id else ""))
        if args.out_dir:
            safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)[:80]
            base, n = safe, 1
            while safe in used:
                safe, n = f"{base}.{n}", n + 1
            used.add(safe)
            coords_to_pdb(os.path.join(args.out_dir, f"{safe}.pdb"),
                          np.asarray(res.coords, np.float64), sequence=seq,
                          atom_names=("CA",), bfactors=100.0 * res.confidence)
    if (scaler is not None or pool_scalers) and args.scale_grace > 0:
        # idle grace: the replay has drained; keep ticking so the
        # autoscaler can see the idle pool and scale back down
        floor = scale_policy.min_replicas * max(1, len(pool_scalers))
        grace_deadline = time.time() + args.scale_grace
        while time.time() < grace_deadline and engine.replica_count() > floor:
            time.sleep(0.1)
    if slo is not None:
        # one last evaluation before shutdown: a burn that crossed in the
        # final window still records its transition
        slo.evaluate()
    if stats_thread is not None:
        stats_stop.set()
        stats_thread.join(timeout=5.0)
    engine.shutdown(drain=True)
    if ops is not None:
        ops.stop()
    if logger is not None:
        logger.close()
    finish_trace(tracer, args)
    wall = time.time() - t0

    stats = engine.stats()
    lat = stats["latency"]
    if fleet_mode:
        reqs = stats["requests"]
        shed_by = ", ".join(f"{k}={v}" for k, v in stats["shed"].items())
        print(f"\nfleet served {reqs['completed']} request(s) ({reqs['degraded']} degraded) "
              f"from {len(pending)} submission(s) in {wall:.1f}s — {reqs['requeued']} "
              f"requeue(s), {reqs['shed']} shed ({shed_by or 'none'}), {reqs['failed']} "
              f"failed, queue-wait p95 {stats['queue_wait']['p95']:.2f}s, latency "
              f"p50/p95/p99 = {lat['p50']:.2f}/{lat['p95']:.2f}/{lat['p99']:.2f}s")
        print(f"replicas: { {name: rep['state'] for name, rep in stats['replicas'].items()} }")
        if args.featurize_workers:
            feat = stats.get("featurize", {})
            freqs = feat.get("requests", {})
            print(f"featurize tier: {freqs.get('completed', 0)} job(s) "
                  f"({freqs.get('failed', 0)} failed, {freqs.get('requeued', 0)} requeued), "
                  f"{feat.get('worker_deaths', 0)} worker death(s), busy "
                  f"{feat.get('busy_seconds', 0.0):.2f}s")
        for sc in ([scaler] if scaler is not None else []) + pool_scalers:
            dec = sc.snapshot()["decisions"]
            label = f" [{sc.pool}]" if sc.pool else ""
            now = engine.replica_count(sc.pool) if sc.pool else engine.replica_count()
            print(f"autoscaler{label}: {dec['up']} scale-up(s), {dec['down']} scale-down(s), "
                  f"{dec.get('suppressed', 0)} suppressed, {dec.get('rejected', 0)} rejected; "
                  f"replicas now {now}")
        if pools and stats.get("shed", {}).get("too_long"):
            print(f"too-long sheds: {stats['shed']['too_long']} (sequence past every pool "
                  f"ceiling)")
        jstats = stats.get("journal")
        if jstats:
            print(f"journal: {jstats['accepted']} accepted, {jstats['settled']} settled, "
                  f"{jstats['pending']} pending, {jstats['corrupt']} corrupt, "
                  f"{jstats['write_errors']} write error(s)")
        bstats = stats.get("retry_budget")
        if bstats:
            print(f"retry budget: {bstats['tokens']:.1f}/{bstats['capacity']:g} token(s) "
                  f"left, {bstats['spent']} spent, {bstats['denied']} denial(s)")
        hstats = stats.get("hedging")
        if hstats and (hstats["issued"] or hstats["denied"]):
            denied = ", ".join(f"{k}={v}" for k, v in sorted(hstats["denied"].items()))
            print(f"hedging: {hstats['issued']} issued (denied: {denied or 'none'}), "
                  f"{hstats['wasted_chip_seconds']:.2f} wasted chip-second(s)")
        if stats["errors"]:
            print(f"errors by code: {stats['errors']}")
        if injector is not None:
            print(f"faults delivered: {injector.delivered}"
                  + ("" if injector.exhausted() else "  WARNING: plan not exhausted"))
    else:
        bat = stats["batches"]
        print(f"\nserved {stats['requests']['completed']} request(s) "
              f"({stats['requests']['coalesced']} coalesced) from {len(pending)} "
              f"submission(s) in {wall:.1f}s — {len(stats['captures'])} executable(s) "
              f"({stats['compiles']['count']} bucket(s) of {len(buckets)}), mean batch "
              f"{bat['mean_requests_per_batch']:.2f} req (occupancy "
              f"{100 * bat['mean_occupancy']:.0f}%), cache hit rate "
              f"{100 * stats['cache']['hit_rate']:.0f}%, latency p50/p95/p99 = "
              f"{lat['p50']:.2f}/{lat['p95']:.2f}/{lat['p99']:.2f}s")
        if stats["errors"]:
            print(f"errors by code: {stats['errors']}")
        if injector is not None:
            print(f"faults delivered: {injector.delivered}")
    if slo is not None:
        events = slo.events()
        fired = sum(1 for e in events if e["transition"] == "firing")
        print(f"SLO: {fired} alert(s) fired ({len(events)} transition(s)): "
              + ", ".join(f"{e['objective']}:{e['transition']}" for e in events[-6:])
              if events else "SLO: no alerts")
    if recorder is not None and recorder.snapshot()["bundles"]:
        snap = recorder.snapshot()
        print(f"flight recorder: {len(snap['bundles'])} bundle(s) in {snap['dir']}")
    if args.stats_json:
        write_atomic(args.stats_json, json.dumps(stats, indent=2))
        print(f"wrote {args.stats_json}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
