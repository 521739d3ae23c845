"""Serving entry point: drive the port's engine over a FASTA stream
(counterpart of the root serve.py, single engine only).

Reads a many-record FASTA (or synthesizes one with --demo), submits every
record to the micro-batching engine (serving/engine.py) with explicit
backpressure handling, prints one line a result and the stats snapshot
(captured executables, batch occupancy, latency quantiles, cache hit
rate), and writes a CA-trace PDB a record with --out-dir.

Usage:
  python -m alphafold2_tpu_torch.serve --fasta proteins.fasta --out-dir preds/
  python -m alphafold2_tpu_torch.serve --demo 24 --buckets 16,32 --max-batch 4 \\
      --mds-iters 8 --dim 16 --depth 1 --heads 2 --dim-head 8 --device cpu
  python -m alphafold2_tpu_torch.serve --demo 24 --ops-port 0 --flight-dir flights/ \\
      --trace-out trace.json --metrics-jsonl batches.jsonl --stats-json stats.json \\
      --stats-interval 5

Parameters come from `--ckpt-dir` (the newest verified checkpoint there,
`training/checkpoint.py`; the model flags must match the run that wrote
it), or else from `--seed` through the port's own init. A restore is
against the f32 twin of the config (checkpoints hold f32 masters; int8
quantizes them at build), and the engine's `params_tag` becomes
`<ckpt-dir>@step<N>`, so two checkpoints never share cached results.
Runs on the GPU, each (bucket, batch shape) a captured CUDA graph pair,
unless `--device cpu` is given. The fleet tier (`--replicas` > 1, ROADMAP
A11b-3) and chaos plans (`--fault-plan`, A11b) are not ported yet and are
refused, as are the JAX CLI's fleet-only flags (`--artifact-store`,
`--journal`, `--featurize-workers`, `--retry-budget`, `--cascade`: A11b-3)
when set.

Telemetry, the JAX CLI's single-engine flags: `--trace-out` (the request
lifecycle spans as a Chrome trace), `--metrics-jsonl` (one record a
batch), `--stats-interval` (flush `--stats-json` every N seconds too),
`--ops-port` (the ops plane, `telemetry/ops_plane.py`: /metrics, /healthz,
/statusz, /explainz, /threadz, and the SLO engine on the stock
`serving_*` objectives or `--slo-config`), `--ops-port-file`, `--ops-tick`,
`--flight-dir` (the incident flight recorder; with --ops-port also
/profilez, bounded `torch.profiler` captures under DIR/profiles, taken
under the engine's graph-pool lock so they never meet a capture) and
`--peak-tflops` (the serve_mfu gauge; no peak, no MFU).
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
from alphafold2_tpu_torch.geometry.pdb import coords_to_pdb
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_init
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.serving.engine import ServingConfig, ServingEngine
from alphafold2_tpu_torch.serving.errors import (
    QueueFullError,
    RequestTimeoutError,
    ServingError,
)
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
    ap.add_argument("--mds-iters", type=int, default=32)
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas (only 1: the fleet is ROADMAP A11b-3)")
    ap.add_argument("--fault-plan", default=None,
                    help="chaos plan (not ported: ROADMAP A11b)")
    # the fleet's flags (the JAX CLI's "fleet mode only"): their modules
    # are ported (serving/artifact_store.py, journal.py, featurize.py,
    # reliability/retry_budget.py, serving/cascade.py), the fleet that
    # wires them is not
    ap.add_argument("--artifact-store", default="off", metavar="DIR",
                    help="fleet-wide result/feature cache (fleet mode only: ROADMAP A11b-3)")
    ap.add_argument("--journal", default="off", metavar="DIR",
                    help="durable intake journal (fleet mode only: ROADMAP A11b-3)")
    ap.add_argument("--featurize-workers", type=int, default=0,
                    help="CPU featurization tier (fleet mode only: ROADMAP A11b-3)")
    ap.add_argument("--retry-budget", type=int, default=0, metavar="N",
                    help="fleet-wide retry budget (fleet mode only: ROADMAP A11b-3)")
    ap.add_argument("--cascade", default="off", metavar="POLICY_JSON",
                    help="draft -> verify cascade (fleet mode only: ROADMAP A11b-3)")
    args = ap.parse_args(argv)
    if args.replicas != 1:
        ap.error("--replicas > 1: the serving fleet is not ported yet (ROADMAP A11b-3)")
    for flag, value, off in (("--artifact-store", args.artifact_store, "off"),
                             ("--journal", args.journal, "off"),
                             ("--featurize-workers", args.featurize_workers, 0),
                             ("--retry-budget", args.retry_budget, 0),
                             ("--cascade", args.cascade, "off")):
        if value != off:
            ap.error(f"{flag}: fleet mode only, and the serving fleet is not ported yet "
                     f"(ROADMAP A11b-3)")
    if args.fault_plan:
        ap.error("--fault-plan: chaos injection is not ported yet (ROADMAP A11b)")
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
    records = (demo_records(args.demo, buckets, args.seed) if args.demo is not None
               else read_fasta(args.fasta))
    print(f"{len(records)} request(s), bucket ladder {buckets}")
    cfg = Alphafold2Config(dim=args.dim, depth=args.depth, heads=args.heads,
                           dim_head=args.dim_head,
                           max_seq_len=args.max_seq_len or max(64, buckets[-1]),
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
    engine = ServingEngine(
        params, cfg,
        ServingConfig(buckets=buckets, max_batch=args.max_batch, batch_ladder=args.batch_ladder,
                      mds_iters=args.mds_iters, params_tag=params_tag),
        device=args.device, metrics_logger=logger, tracer=tracer,
        incident_hook=recorder.incident if recorder else None,
        # the flights' one reader is the ops plane's /explainz
        flights=FlightBook() if args.ops_port is not None else None)
    print(f"engine on {engine.device}; weights {engine.stats()['weights']['weight_dtype']}")
    registry = engine.metrics.registry
    if recorder is not None:
        recorder.bind(registry=registry, stats_fn=engine.stats)
    if args.peak_tflops:
        engine.costs.set_peak(args.peak_tflops * 1e12)

    ops = slo = None
    if args.ops_port is not None:
        slo_cfg = (SloConfig.from_file(args.slo_config) if args.slo_config
                   else default_slo_config("serving"))
        slo = SloEngine(registry, slo_cfg,
                        on_page=recorder.slo_page_hook if recorder else None)
        profiler = None
        if args.flight_dir:
            profiler = ProfileCapturer(os.path.join(args.flight_dir, "profiles"),
                                       registry=registry, lock=engine.graph_lock)
        ops = ops_server_for_engine(engine, tracer=tracer, slo=slo, recorder=recorder,
                                    profiler=profiler, port=args.ops_port,
                                    tick_interval_s=args.ops_tick)
        # host reads only (the ticker runs while the worker captures)
        ops.add_tick(lambda: host_memory_gauges(registry))
        ops.add_tick(lambda: device_memory_gauges(registry))
        ops.add_tick(engine.sample_gauges)
        ops.start()
        print(f"ops plane listening on {ops.url} (/metrics /healthz /statusz)")
        if args.ops_port_file:
            write_atomic(args.ops_port_file, str(ops.port))

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
    pending, failures = [], 0
    for pass_idx in range(max(1, args.passes)):
        for name, seq in records:
            if pass_idx:
                name = f"{name}_p{pass_idx + 1}"
            while True:
                try:
                    pending.append((name, seq, engine.submit(seq)))
                    break
                except QueueFullError as e:
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
            kind = "SHED" if isinstance(e, (QueueFullError, RequestTimeoutError)) else "FAILED"
            print(f"{kind} {name}: [{e.code}] {e}")
            failures += 1
            continue
        print(f"{name}: L={len(seq)} bucket={res.bucket} stress={res.stress:.3f} "
              f"conf={100 * res.mean_confidence:.1f}/100 lat={res.latency_s * 1000:.0f}ms"
              + (" (cache)" if res.from_cache else ""))
        if args.out_dir:
            safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)[:80]
            base, n = safe, 1
            while safe in used:
                safe, n = f"{base}.{n}", n + 1
            used.add(safe)
            coords_to_pdb(os.path.join(args.out_dir, f"{safe}.pdb"),
                          np.asarray(res.coords, np.float64), sequence=seq,
                          atom_names=("CA",), bfactors=100.0 * res.confidence)
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
    bat, lat = stats["batches"], stats["latency"]
    print(f"\nserved {stats['requests']['completed']} request(s) "
          f"({stats['requests']['coalesced']} coalesced) from {len(pending)} submission(s) "
          f"in {wall:.1f}s — {len(stats['captures'])} executable(s) "
          f"({stats['compiles']['count']} bucket(s) of {len(buckets)}), mean batch "
          f"{bat['mean_requests_per_batch']:.2f} req (occupancy "
          f"{100 * bat['mean_occupancy']:.0f}%), cache hit rate "
          f"{100 * stats['cache']['hit_rate']:.0f}%, latency p50/p95/p99 = "
          f"{lat['p50']:.2f}/{lat['p95']:.2f}/{lat['p99']:.2f}s")
    if stats["errors"]:
        print(f"errors by code: {stats['errors']}")
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
