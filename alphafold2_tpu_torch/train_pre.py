"""Distogram pretraining on the port (counterpart of the root train_pre.py's
single-device loop, with its checkpoints and its resilient loop).

Usage:
  python -m alphafold2_tpu_torch.train_pre --steps 100 --bf16
  python -m alphafold2_tpu_torch.train_pre --steps 3 --dim 16 --depth 1 \\
      --heads 2 --dim-head 8 --len 16 --accum 2 --device cpu
  python -m alphafold2_tpu_torch.train_pre --steps 100 --bf16 --ckpt-dir runs/pre \\
      --ckpt-every 50 [--max-restarts 3] [--fault-plan plan.json]
  python -m alphafold2_tpu_torch.train_pre --steps 200 --bf16 --data native \\
      --len-buckets 64,128,256 --len 256 --accum 2
  python -m alphafold2_tpu_torch.train_pre --steps 100 --bf16 --metrics-log m.jsonl \\
      --eval-every 10 --trace-out trace.json [--ops-port 0] [--flight-dir flights/]
  python -m alphafold2_tpu_torch.train_pre --steps 100 --bf16 --len 256 --sp-shards 4
  python -m alphafold2_tpu_torch.train_pre --steps 3 --dim 16 --depth 1 \\
      --heads 2 --dim-head 8 --len 16 --accum 2 --device cpu --sp-shards 2

Trains on synthetic protein-like batches (`training/data.py`,
sequence-only) with the defaults of the JAX CLI: dim 256, depth 1, heads
8, dim_head 64, crop 128, batch 1, 16 microbatches per step. Runs on the
GPU unless `--device cpu` is given, and never falls back to the CPU;
float32 matmuls and convolutions run in full float32 there (TF32 off).
On the GPU the step is captured as a CUDA graph and replayed
(`training/executable.py CapturedTrainStep`, the JAX CLI's jitted step),
after any restore, so that the capture's warm-up puts back the restored
moments; the CPU runs the eager `make_train_step`.

`--ckpt-dir` resumes from the newest verified checkpoint there
(`training/checkpoint.py`, the JAX package's verified npz format, which
either package reads) and saves every `--ckpt-every` steps and at the
end; a resumed run takes up the synthetic stream and the lr schedule at
the restored step. `--max-restarts` or `--fault-plan` run the loop under
`training/resilience.py run_resilient` (NaN rollback, restarts from the
newest checkpoint, SIGTERM: save and exit 0).

`--data native` draws the batches from the C++ prefetch loader
(`runtime/native.py`, 2 threads, so the batch order varies from run to
run) over an in-memory pool of 256 synthetic proteins of 32 to 4 x --len
residues, C-alpha labels, as the JAX CLI does; its stream restarts from
its top on a resume. `--len-buckets` (with --data native) batches each
protein at the smallest bucket that holds it and stacks the microbatches
of a step within one bucket (`training/data.py bucketed_microbatches`); on
the GPU each bucket is captured at its first batch, in the one graph pool.

Telemetry, the JAX CLI's flags: `--metrics-log` (the JSONL stream of
`telemetry/logger.py`, one device-to-host copy a step), `--eval-every N`
(the held-out distogram loss of one synthetic batch from another seed,
`eval_loss`, or `synthetic_eval_loss` under another --data; ignored by the
resilient loop), `--trace-out` / `--trace-max-spans` (the phase spans as a
Chrome trace, and a `<trace-out>.metrics.json` registry snapshot beside
it), `--ops-port` / `--ops-port-file` / `--flight-dir` /
`--progress-horizon-s` / `--peak-tflops` (the live ops plane and the
goodput ledger, `telemetry/goodput.py`; a capture, at the start or a
bucket's first batch, counts as "compile").

`--sp-shards N` trains with the trunk sequence-parallel over N shards
(`parallel/train.py`: the pair grid's rows and the MSA rows sharded, the
JAX CLI's "single-process grid-sharding path"); --len, and every
--len-buckets bucket, must divide by N. With `--device cpu` the shards are
N CPU shards; on the GPU they are N distinct cards (`make_mesh({"seq":
N})`, which raises on a host with fewer). Where every shard is the state's
card (N = 1) the SP step is captured as the dense one is; a mesh over
distinct cards runs the eager `make_sp_train_step`, since a CUDA graph
captures one card's stream: the startup line says which. `--eval-every`
evaluates through the SP loss, as the JAX CLI does. The SP trunk is
deterministic (no dropout, no remat, as in JAX).

A pod of processes trains data-parallel, as the JAX CLI does, launched
one command per process:

  AF2_COORDINATOR=host0:8476 AF2_NUM_PROCESSES=2 AF2_PROCESS_ID=$i \
      python -m alphafold2_tpu_torch.train_pre --steps 100 --bf16 --batch 2

Each process joins first (`parallel/distributed.py distributed_startup`,
NCCL on its card, gloo with `--device cpu`), trains on its own rows of
the global --batch (`training/data.py per_process_microbatch_fn`) and
all-reduces the gradients before the one update (`parallel/train.py
make_multihost_train_step`, eager). The JAX CLI's refusals hold: under a
pod `--sp-shards`, `--data` other than synthetic, `--fault-plan`, a
--batch that does not divide over the processes and `--ckpt-dir` without
`--ckpt-verify` exit; `--ckpt-dir` itself exits too (multi-process
checkpoints: ROADMAP A13-ckpt).

Not ported: `--data sidechainnet` (it needs a dataset in the repository)
and `--federate-every` (refused: A13).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import time

import numpy as np
import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.parallel import (
    distributed_startup,
    host_to_global,
    make_mesh,
    make_multihost_train_step,
    make_sp_train_step,
    process_count,
    sp_distogram_loss_fn,
)
from alphafold2_tpu_torch.reliability.preemption import Preempted, PreemptionHandler
from alphafold2_tpu_torch.runtime import NativePrefetchLoader
from alphafold2_tpu_torch.telemetry import (
    CompileTracker,
    MetricRegistry,
    MetricsLogger,
    add_observability_args,
    add_telemetry_args,
    build_train_telemetry,
    device_memory_gauges,
    finish_trace,
    flops_gauges,
    observability_enabled,
    tracer_from_args,
)
from alphafold2_tpu_torch.training.checkpoint import finish, open_or_init
from alphafold2_tpu_torch.training.data import (
    DataConfig,
    bucketed_microbatches,
    per_process_microbatch_fn,
    resilient_batches,
    stack_microbatches,
    synthetic_batches,
    synthetic_microbatch_fn,
)
from alphafold2_tpu_torch.training.executable import CapturedTrainStep
from alphafold2_tpu_torch.training.harness import (
    add_train_args,
    distogram_loss_fn,
    make_train_step,
    tcfg_from_args,
    train_state_init,
    with_fault_injection,
)
from alphafold2_tpu_torch.training.resilience import (
    add_resilience_args,
    chaos_from_args,
    resilient_mode,
    run_resilient,
)
from alphafold2_tpu_torch.utils.flops import train_step_flops


def bucket_of(args, batch) -> str:
    """The capture message's suffix: ' for bucket L' under --len-buckets
    (which, as in the JAX CLI, only --data native reads)."""
    bucketed = args.len_buckets and args.data == "native"
    return f" for bucket {np.shape(batch['seq'])[-1]}" if bucketed else ""


def native_pool(max_len: int, seed: int) -> list:
    """The JAX CLI's in-memory structure pool: 256 proteins from
    `RandomState(seed)`, L drawn from [32, 4 max_len), tokens in [0, 21),
    14-atom clouds a cumulative sum of 3.8 A Gaussian steps."""
    rs = np.random.RandomState(seed)
    pool = []
    for _ in range(256):
        L = rs.randint(32, 4 * max_len)
        seq = rs.randint(0, 21, L).astype(np.int32)
        cloud = np.cumsum(3.8 * rs.randn(L, 14, 3).astype(np.float32), axis=0)
        pool.append((seq, cloud))
    return pool


def native_stream(args, dcfg, tcfg, sp_shards: int = 0):
    """Microbatch stacks from the C++ prefetch loader (2 threads) over
    `native_pool`, C-alpha (atom slot 1) for the labels; with --len-buckets
    grouped by bucket (`bucketed_microbatches`), the "bucket" key popped
    (shape bookkeeping, not an input). The loader closes with the stream.
    `sp_shards`: the SP mesh's size, which every bucket must divide."""
    buckets = None
    if args.len_buckets:
        buckets = tuple(sorted(set(int(x) for x in args.len_buckets.split(","))))
        if buckets[-1] != args.max_len:
            raise SystemExit(
                f"--len-buckets largest bucket ({buckets[-1]}) must equal --len "
                f"({args.max_len}) — the top bucket is the crop length the model is sized for")
        if sp_shards:
            bad = [b for b in buckets if b % sp_shards]
            if bad:
                raise SystemExit(
                    f"--len-buckets {bad} not divisible by --sp-shards {sp_shards} "
                    f"(sp_trunk needs the pair side to divide the mesh axis)")
        print(f"length buckets: {buckets}")
    loader = NativePrefetchLoader(native_pool(args.max_len, dcfg.seed), batch_size=args.batch,
                                  max_len=args.max_len, seed=dcfg.seed, n_threads=2,
                                  buckets=buckets)
    print("native prefetch loader: C++")

    def batches():
        while True:
            b = loader.next()
            out = {"seq": b["seq"], "mask": b["mask"], "coords": b["coords"][:, :, 1]}
            if "bucket" in b:
                out["bucket"] = b["bucket"]
            yield out

    stacks = (bucketed_microbatches(batches(), tcfg.grad_accum) if buckets
              else stack_microbatches(batches(), tcfg.grad_accum))
    try:
        for stack in stacks:
            stack.pop("bucket", None)
            yield stack
    finally:
        loader.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dim-head", type=int, default=64)
    ap.add_argument("--len", dest="max_len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--accum", type=int, default=16)
    add_train_args(ap)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument("--data", choices=["synthetic", "native"], default="synthetic",
                    help="synthetic batches, or a synthetic in-memory structure pool "
                         "through the C++ prefetch loader (runtime/native.py)")
    ap.add_argument("--len-buckets", default=None,
                    help="comma-separated static length buckets (e.g. 64,128,256) for "
                         "--data native: proteins batch into the smallest bucket that "
                         "holds them (one capture a bucket); the largest must equal --len")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint/resume directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    add_resilience_args(ap)  # --max-restarts / --ckpt-verify / --fault-plan
    add_telemetry_args(ap)   # --trace-out / --trace-max-spans
    add_observability_args(ap)  # --ops-port / --flight-dir / --federate-every
    ap.add_argument("--metrics-log", default=None, help="JSONL metrics file")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate held-out distogram loss every N steps "
                         "(0 = off)")
    ap.add_argument("--sp-shards", type=int, default=0,
                    help="shard the pair grid over this many devices "
                         "(sequence-parallel trunk; --len must be a "
                         "multiple of it; 0 = replicated)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)

    # a pod (AF2_COORDINATOR / AF2_NUM_PROCESSES / AF2_PROCESS_ID) is joined
    # before anything touches a card, and its contract checked before any
    # state is built
    distributed_startup("train_pre", device=args.device)
    procs = process_count()
    if procs > 1:
        refuse_in_pod(args, procs)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(device)} (TF32 off)")
    cfg = Alphafold2Config(
        dim=args.dim, depth=args.depth, heads=args.heads, dim_head=args.dim_head,
        max_seq_len=max(2048, args.max_len),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )
    tcfg = tcfg_from_args(args, grad_accum=args.accum)
    dcfg = DataConfig(batch_size=args.batch, max_len=args.max_len, seed=args.seed)
    mesh = None
    if args.sp_shards:
        # the sequence-parallel trunk: the pair grid (not the batch) shards
        mesh = make_mesh({"seq": args.sp_shards},
                         devices=[device] * args.sp_shards if device.type == "cpu" else None)

    resilient = resilient_mode(args)
    injector, ckpt_fault_hook, max_restarts = chaos_from_args(args)
    mgr, state, resumed = open_or_init(
        args.ckpt_dir, train_state_init, cfg, tcfg, torch.Generator().manual_seed(args.seed),
        device, save_every=args.ckpt_every, fault_hook=ckpt_fault_hook)
    start = state["step"]
    if resumed:
        print(f"resumed from step {start} in {args.ckpt_dir}")
    if args.data == "native":
        stream = native_stream(args, dcfg, tcfg, args.sp_shards)
        if resumed:
            # the loader's threads are not positionally replayable
            print(f"note: --data {args.data} stream restarts from its top on resume (only "
                  f"synthetic data is positionally resumable)")
        first = next(stream)
        stream = itertools.chain([first], stream)
        source = stream

        def fetch(step):  # the stream's next stack, whatever the step
            return next(stream)
    elif procs > 1:
        # this process's rows of the global stream: row slices, so that the
        # pod's steps are the single process's on the same batches
        fetch = source = per_process_microbatch_fn(dcfg, tcfg.grad_accum)
        first = fetch(start)
    else:
        # batch i is a pure function of (seed, i): a resumed run takes up
        # the stream at start * accum, a retried step refetches its own batch
        fetch = source = synthetic_microbatch_fn(dcfg, tcfg.grad_accum)
        first = fetch(start)
    # the telemetry, built before the step so that its capture counts
    tracer = tracer_from_args(args)  # NULL_TRACER unless --trace-out
    # a logger only when something reads it: its fetch is a sync a step
    logger = (MetricsLogger(args.metrics_log, print_every=None)  # report() prints
              if args.metrics_log or tracer.enabled or observability_enabled(args) else None)
    # the registry is live when tracing (the sidecar) or when the ops plane
    # or the flight recorder is mounted; a no-op otherwise
    registry = MetricRegistry(enabled=tracer.enabled or observability_enabled(args))
    compile_tracker = CompileTracker(registry, tracer=tracer, prefix="train_compile")
    telemetry = build_train_telemetry(
        args, registry=registry, tracer=tracer, logger=logger,
        step_flops=train_step_flops(cfg, args.max_len, 0, 0, grad_accum=tcfg.grad_accum))
    pod_step = None
    if procs > 1:
        step, shardings, assemble, _ = make_multihost_train_step(
            cfg, tcfg, first, telemetry=telemetry, device=device)
        state = host_to_global(state, shardings)  # process 0's bytes everywhere

        def pod_step(st, batch, rng=None):
            return step(st, assemble(batch), rng)
    try:
        metrics = train(args, cfg, tcfg, device, state, mgr, first, fetch, source, resilient,
                        injector, max_restarts, logger, tracer, compile_tracker, telemetry,
                        mesh, pod_step)
    except Preempted as e:
        print(e)  # saved and closed by the loop: not a failure
        return state, None
    finally:
        # a crashed or interrupted run keeps its trace and its sidecar
        if tracer.enabled:
            flops_gauges(registry, cfg, n=args.max_len, r=0, c=args.max_len,
                         grad_accum=tcfg.grad_accum)
            device_memory_gauges(registry)
            sidecar = args.trace_out + ".metrics.json"
            with open(sidecar, "w") as fh:
                json.dump(registry.snapshot(), fh, indent=2)
            print(f"wrote {sidecar}")
        telemetry.close()
        if logger is not None:
            logger.close()
        finish_trace(tracer, args)
    print("done")
    return state, metrics


def refuse_in_pod(args, procs: int) -> None:
    """The JAX CLI's refusals under a pod of `procs` processes, in its
    order, then the port's own (multi-process checkpoints)."""
    if args.sp_shards:
        raise SystemExit("--sp-shards is the single-process grid-sharding path; multi-host "
                         "runs shard the batch (DP) — drop the flag")
    if args.data != "synthetic":
        raise SystemExit(f"--data {args.data} has no per-process sharding contract yet; "
                         "multi-host training runs --data synthetic")
    if args.fault_plan:
        raise SystemExit("--fault-plan is single-process chaos tooling; a per-host injected "
                         "fault would desync the SPMD step — run chaos drills single-process")
    if args.batch % procs:
        raise SystemExit(f"--batch {args.batch} is the GLOBAL batch and must divide across "
                         f"the {procs} processes (one card a process)")
    if args.ckpt_dir and not args.ckpt_verify:
        raise SystemExit("multi-host checkpointing runs through the verified manager "
                         "(process-0 writes + cross-process barrier + broadcast-consistent "
                         "restore) — add --ckpt-verify")
    if args.ckpt_dir:
        raise SystemExit("--ckpt-dir in a pod: multi-process checkpoints are not ported yet "
                         "(ROADMAP A13-ckpt)")


def train(args, cfg, tcfg, device, state, mgr, first, fetch, source, resilient, injector,
          max_restarts, logger, tracer, compile_tracker, telemetry, mesh=None, pod_step=None):
    """The run's steps from state["step"], updating `state` in place;
    returns the last step's metrics (a preemption raises `Preempted`). On
    the GPU the first batch's capture, and each bucket's first batch's, is
    accounted as compile. `mesh`: the sequence-parallel trunk's (None:
    the dense step); captured where every shard is the state's card.
    `pod_step`: the pod's data-parallel step (eager), fed this process's
    rows."""
    start = state["step"]
    loss_fn = distogram_loss_fn if mesh is None else sp_distogram_loss_fn(mesh)
    # a CUDA graph captures one card's stream: decided by the placement
    captured = device.type == "cuda" and pod_step is None and (
        mesh is None or all(d == device for d in mesh.devices))
    if pod_step is not None:
        print(f"data-parallel over {process_count()} processes, this one on {device}: the "
              f"step runs eager")
    if mesh is not None:
        how = ("captured as a CUDA graph" if captured else
               "eager (a CUDA graph captures one card's stream)" if device.type == "cuda"
               else "eager")
        print(f"sequence-parallel trunk over {mesh.size} shards on "
              f"{[str(d) for d in mesh.devices]}: the step runs {how}")
    if captured:
        with telemetry.account("compile"), compile_tracker.track(kind="train_step"):
            train_step = CapturedTrainStep(cfg, tcfg, state, first, loss_fn=loss_fn)
        capture = next(iter(train_step.captures.values()))
        print(f"captured the step{bucket_of(args, first)} as a CUDA graph in "
              f"{capture.seconds:.2f} s")
    elif pod_step is not None:
        train_step = pod_step
    elif mesh is not None:
        train_step = make_sp_train_step(cfg, tcfg, mesh, device=device)
    else:
        train_step = make_train_step(cfg, tcfg, device=device)

    def make_rng(step):  # dropout's generator, a function of the step
        return torch.Generator().manual_seed(args.seed * 1_000_003 + step + 1)

    t0 = time.time()
    last = start + args.steps - 1

    def report(step, metrics):
        if step % 10 == 0 or step == last:
            print(f"step {step}  loss {float(metrics['loss']):.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"({time.time() - t0:.1f}s elapsed)")

    if resilient:
        if args.eval_every:
            print("note: --eval-every is ignored under the resilient loop")
        handler = PreemptionHandler().install()
        if injector is not None:
            injector.bind_preemption(handler)
        seen = {}

        def on_metrics(step, m):
            seen["metrics"] = m
            if logger is not None:
                logger.log(step, m)
            report(step, m)

        try:
            run_resilient(with_fault_injection(train_step, injector), state,
                          resilient_batches(source, injector=injector), steps=args.steps,
                          make_rng=make_rng, mgr=mgr, on_metrics=on_metrics,
                          max_restarts=max_restarts, preemption=handler, logger=logger,
                          tracer=tracer, telemetry=telemetry)
        finally:
            handler.uninstall()
        if injector is not None and not injector.exhausted():
            print(f"warning: fault plan only partially delivered: {injector.delivered}")
        return seen.get("metrics")

    eval_batch, eval_key = None, "eval_loss"
    if args.eval_every:
        # a fixed held-out batch from a seed the training stream never
        # draws; synthetic whatever --data says, and then named so
        if args.data != "synthetic":
            eval_key = "synthetic_eval_loss"
        eval_batch = next(synthetic_batches(DataConfig(
            batch_size=args.batch, max_len=args.max_len, seed=args.seed + 104729)))
    metrics = None
    for step in range(start, start + args.steps):
        with tracer.span("train.fetch", cat="train", step=step), \
                telemetry.account("data_fetch"):
            batch = fetch(step)
        rng = make_rng(step)
        # a call that captures (a bucket's first batch) is compile
        captures = isinstance(train_step, CapturedTrainStep) and not train_step.captured(batch, rng)
        step_bucket = "compile" if captures else telemetry.step_bucket()
        first_traced = step == start and tracer.enabled and device.type != "cuda"
        with (compile_tracker.track(kind="train_step") if captures or first_traced
              else contextlib.nullcontext()), \
                tracer.span("train.step", cat="train", step=step), \
                telemetry.account(step_bucket):
            state, metrics = train_step(state, batch, rng)
        if captures:
            capture = list(train_step.captures.values())[-1]
            print(f"captured the step{bucket_of(args, batch)} as a CUDA graph in "
                  f"{capture.seconds:.2f} s (step {step})")
        if eval_batch is not None and (step + 1) % args.eval_every == 0:
            metrics = dict(metrics)
            with tracer.span("train.eval", cat="train", step=step), \
                    telemetry.account("eval"), torch.no_grad():
                # through the training loss: an SP run never holds the
                # whole pair grid on one device
                metrics[eval_key] = loss_fn(state["params"], cfg, eval_batch, None, device)
        # logger.log is the step's one device sync: the span and the
        # bucket absorb the execution train.step only launched
        if logger is not None:
            with tracer.span("train.metrics_fetch", cat="train", step=step), \
                    telemetry.account(step_bucket):
                logger.log(step, metrics)
        telemetry.step_complete(step)
        report(step, metrics)
        if mgr is not None:
            with tracer.span("train.checkpoint", cat="train", step=step), \
                    telemetry.account("checkpoint"):
                mgr.save(state)  # the interval decides
    finish(mgr, state)
    return metrics


if __name__ == "__main__":
    main()
