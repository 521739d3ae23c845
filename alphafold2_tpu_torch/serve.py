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

Parameters come from `--ckpt-dir` (the newest verified checkpoint there,
`training/checkpoint.py`; the model flags must match the run that wrote
it), or else from `--seed` through the port's own init. A restore is
against the f32 twin of the config (checkpoints hold f32 masters; int8
quantizes them at build), and the engine's `params_tag` becomes
`<ckpt-dir>@step<N>`, so two checkpoints never share cached results.
Runs on the GPU, each (bucket, batch shape) a captured CUDA graph pair,
unless `--device cpu` is given. The fleet tier
(`--replicas` > 1) and chaos plans (`--fault-plan`) are not ported yet
(ROADMAP A11b) and are refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import time

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
    ap.add_argument("--stats-json", default=None, help="write the final stats snapshot")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas (only 1: the fleet is ROADMAP A11b)")
    ap.add_argument("--fault-plan", default=None,
                    help="chaos plan (not ported: ROADMAP A11b)")
    args = ap.parse_args(argv)
    if args.replicas != 1:
        ap.error("--replicas > 1: the serving fleet is not ported yet (ROADMAP A11b)")
    if args.fault_plan:
        ap.error("--fault-plan: chaos injection is not ported yet (ROADMAP A11b)")

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
    engine = ServingEngine(
        params, cfg,
        ServingConfig(buckets=buckets, max_batch=args.max_batch, batch_ladder=args.batch_ladder,
                      mds_iters=args.mds_iters, params_tag=params_tag),
        device=args.device)
    print(f"engine on {engine.device}; weights {engine.stats()['weights']['weight_dtype']}")

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
    engine.shutdown(drain=True)
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
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(stats, fh, indent=2)
        print(f"wrote {args.stats_json}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
