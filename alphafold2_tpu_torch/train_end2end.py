"""End-to-end structure training on the port (counterpart of the root
train_end2end.py's single-device loop, with its checkpoints and its
resilient loop): trunk -> distogram -> MDS with the mirror fix -> the
side-chain lift -> the refiner -> the Kabsch-aligned RMSD plus the
dispersion term (`training/e2e.py e2e_loss_fn`), accumulated over
microbatches and applied by one AdamW update a step.

Usage:
  python -m alphafold2_tpu_torch.train_end2end --steps 50 [--bf16] [--reversible]
  python -m alphafold2_tpu_torch.train_end2end --steps 50 --reversible --trunk-segments 4
  python -m alphafold2_tpu_torch.train_end2end --steps 50 --len 16 --msa-rows 8 --sp-shards 4
  python -m alphafold2_tpu_torch.train_end2end --steps 2 --dim 16 --depth 1 \\
      --heads 2 --dim-head 8 --len 8 --mds-iters 5 --device cpu [--features esm]
  python -m alphafold2_tpu_torch.train_end2end --steps 50 --ckpt-dir runs/e2e \\
      --ckpt-every 25 [--max-restarts 3] [--fault-plan plan.json]
  python -m alphafold2_tpu_torch.train_end2end --steps 50 --metrics-jsonl m.jsonl \\
      --eval-every 10 --trace-out trace.json --profile-dir prof/ [--ops-port 0]

The JAX CLI's flags and defaults: dim 64, depth 2, heads 4, dim_head 16,
crop 16 (the trunk sees 3 x 16 backbone tokens), batch 1, 2 microbatches
a step, 20 MDS iterations from the classical init (`--mds-reference`: 200
from a random one), refiner depth 2. `--features` picks the trunk's
second stream: msa (a synthetic MSA of `--msa-rows` rows), esm (each
microbatch's residues embedded by the ESM-1b embedder,
`models/embedder.py embed_sequences`, under `torch.no_grad`, then repeated
x3 onto the backbone tokens; random weights drawn on the run's device
unless `--esm-ckpt` names an npz of a fair-esm or a transformers state
dict, told apart by key style) or none. The data is the synthetic
full-atom stream (`training/data.py synthetic_structure_batches`).

Runs on the GPU unless `--device cpu` is given, and never falls back to
the CPU; float32 matmuls and convolutions run in full float32 there (TF32
off). The step is `training/harness.py make_train_step`, eager on the
card too: its geometry reads the host (`eigh`, the SVD), which a CUDA
graph cannot hold (ROADMAP A8-e2e-capture).

`--ckpt-dir` resumes from the newest verified checkpoint there (the JAX
package's verified npz format under the joint {"model", "refiner"} tree:
either package resumes the other's run) and saves every `--ckpt-every`
steps and at the end. `--max-restarts` or `--fault-plan` run the loop
under `training/resilience.py run_resilient`; msa and none fetch each
step's batch by its index (a retried step refetches it), esm takes the
next batch of its stream, as the JAX CLI does.

`--reversible` runs the reversible trunk (models/reversible.py), whose
activation memory does not grow with depth; it needs the trunk's second
stream, so `--features none --reversible` raises the trunk's no-MSA
error at the first step, as the JAX CLI does. `--trunk-segments K` is
the JAX CLI's segmented step (`training/segmented.py`): CUDA has no
execution limit to split the step for, so it runs the monolithic
reversible step; as the JAX CLI does, it refuses to run without
`--reversible` and under `--max-restarts` / `--fault-plan`.

Telemetry, the JAX CLI's flags: `--metrics-jsonl` (the JSONL stream of
`telemetry/logger.py`), `--eval-every N` (rmsd, gdt_ts, gdt_ha and tm of
the last microbatch's refined cloud against its truth, `geometry/metrics.py
structure_eval`), `--trace-out` / `--trace-max-spans`, the live ops plane
and goodput ledger (`--ops-port`, `--ops-port-file`, `--flight-dir`,
`--progress-horizon-s`, `--peak-tflops`), and `--profile-dir` /
`--profile-steps` (a `torch.profiler` window of that many steps from the
second, written as `<profile-dir>/trace.json` by `hooks.profile_trace`). The resilient loop ignores `--eval-every` and
`--profile-dir`, as the JAX CLI does.

`--sp-shards N` trains with the trunk sequence-parallel over N shards
(`parallel/train.py sp_e2e_loss_fn`; 3 x --len and the MSA rows must
divide by N), eager like every e2e step; `--device cpu` takes N CPU
shards, the GPU N distinct cards (`make_mesh`, which raises on a host
with fewer). As in the JAX CLI it is exclusive with `--trunk-segments`,
and `--features esm` (the embedds stream has no row axis to shard) and
`--reversible` are refused by the SP trunk at the first step; the eval
runs the dense `predict_structure`, as the JAX CLI's does.

Not ported: multi-host runs with their `--federate-every` (refused:
ROADMAP A13), `--data sidechainnet` (it needs a dataset in the
repository).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.geometry.metrics import structure_eval
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.embedder import (
    EmbedderConfig,
    convert_esm_state_dict,
    convert_hf_esm_state_dict,
    embed_sequences,
    embedder_init,
)
from alphafold2_tpu_torch.models.refiner import RefinerConfig
from alphafold2_tpu_torch.parallel import make_mesh, make_sp_train_step, sp_e2e_loss_fn
from alphafold2_tpu_torch.reliability.preemption import Preempted, PreemptionHandler
from alphafold2_tpu_torch.telemetry import (
    MetricRegistry,
    MetricsLogger,
    add_observability_args,
    add_telemetry_args,
    build_train_telemetry,
    finish_trace,
    observability_enabled,
    profile_trace,
    tracer_from_args,
)
from alphafold2_tpu_torch.training.checkpoint import finish, open_or_init
from alphafold2_tpu_torch.training.data import (
    DataConfig,
    resilient_batches,
    stack_microbatches,
    synthetic_microbatch_fn,
    synthetic_structure_batches,
)
from alphafold2_tpu_torch.training import e2e
from alphafold2_tpu_torch.training.e2e import E2EConfig, e2e_loss_fn, e2e_train_state_init
from alphafold2_tpu_torch.training.harness import (
    add_train_args,
    make_train_step,
    tcfg_from_args,
    with_fault_injection,
)
from alphafold2_tpu_torch.training.resilience import (
    add_resilience_args,
    chaos_from_args,
    resilient_mode,
    run_resilient,
)
from alphafold2_tpu_torch.training.segmented import make_segmented_train_step
from alphafold2_tpu_torch.utils.flops import train_step_flops


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dim-head", type=int, default=16)
    ap.add_argument("--len", dest="max_len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--mds-iters", type=int, default=20)
    ap.add_argument("--mds-init", choices=["classical", "random"], default="classical",
                    help="MDS warm start: 'classical' (Torgerson eigendecomposition) or "
                         "'random' (reference parity)")
    ap.add_argument("--mds-reference", action="store_true",
                    help="the reference's MDS arm: 200 iterations from a random init, "
                         "overriding --mds-iters/--mds-init")
    ap.add_argument("--mds-bwd-iters", type=int, default=None,
                    help="backpropagate MDS through its last K iterations only "
                         "(default: all)")
    ap.add_argument("--refiner-depth", type=int, default=2)
    ap.add_argument("--sp-shards", type=int, default=0,
                    help="shard the trunk sequence-parallel over this many "
                         "devices (3*--len and MSA rows must be multiples "
                         "of it; deterministic path; 0 = replicated)")
    ap.add_argument("--reversible", action="store_true",
                    help="reversible trunk: O(1) activation memory in depth (the north-star "
                         "depth-48 config, BASELINE.md config 5)")
    ap.add_argument("--trunk-segments", type=int, default=0,
                    help="the JAX CLI's reversible-trunk segments a step "
                         "(training/segmented.py: on CUDA the monolithic step); requires "
                         "--reversible; 0 = off")
    add_train_args(ap)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument("--features", choices=["msa", "esm", "none"], default="msa")
    ap.add_argument("--msa-rows", type=int, default=4)
    ap.add_argument("--esm-dim", type=int, default=128,
                    help="embedder width (1280 = real ESM-1b)")
    ap.add_argument("--esm-layers", type=int, default=2,
                    help="embedder depth (33 = real ESM-1b)")
    ap.add_argument("--esm-heads", type=int, default=4,
                    help="attention heads (20 = real ESM-1b)")
    ap.add_argument("--esm-ckpt", default=None,
                    help="npz of a torch ESM state dict (fair-esm or transformers keys) "
                         "to convert and load (random weights otherwise)")
    ap.add_argument("--esm-token-dropout", type=int, default=1,
                    help="1 = ESM-1b's inference semantics (the mask-dropout rescale)")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint/resume directory")
    ap.add_argument("--ckpt-every", type=int, default=25)
    add_resilience_args(ap)  # --max-restarts / --ckpt-verify / --fault-plan
    add_telemetry_args(ap)   # --trace-out / --trace-max-spans
    add_observability_args(ap)  # --ops-port / --flight-dir / --federate-every
    ap.add_argument("--eval-every", type=int, default=0, help="0 = no eval")
    ap.add_argument("--metrics-jsonl", default=None, help="JSONL metrics stream")
    ap.add_argument("--profile-dir", default=None, help="torch.profiler trace dir")
    ap.add_argument(
        "--profile-steps", type=int, default=10,
        help="trace this many steps (starting after the first, at step start+1)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    return ap


def e2e_config_from_args(args) -> E2EConfig:
    """The JAX CLI's E2EConfig: the trunk sees the x3-elongated sequence;
    only the esm features resize the embedds projection, so other modes'
    checkpoints resume whatever --esm-dim says."""
    model = Alphafold2Config(
        dim=args.dim, depth=args.depth, heads=args.heads, dim_head=args.dim_head,
        max_seq_len=max(64, 3 * args.max_len), max_num_msa=max(20, args.msa_rows),
        **({"num_embedds": args.esm_dim} if args.features == "esm" else {}),
        reversible=args.reversible,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )
    return E2EConfig(
        model=model,
        refiner=RefinerConfig(num_tokens=14, dim=64, depth=args.refiner_depth),
        mds_iters=200 if args.mds_reference else args.mds_iters,
        mds_init="random" if args.mds_reference else args.mds_init,
        mds_bwd_iters=args.mds_bwd_iters,
    )


def load_embedder(args, device):
    """(params, config) of the ESM embedder: `--esm-ckpt` converted by the
    converter its key style names, else random weights from seed 42."""
    cfg = EmbedderConfig(num_layers=args.esm_layers, dim=args.esm_dim, heads=args.esm_heads,
                         max_len=max(1024, args.max_len + 2),
                         token_dropout=bool(args.esm_token_dropout))
    if args.esm_ckpt:
        sd = dict(np.load(args.esm_ckpt, allow_pickle=True))
        hf_style = any(k.startswith(("esm.", "encoder.layer.", "embeddings.")) for k in sd)
        convert = convert_hf_esm_state_dict if hf_style else convert_esm_state_dict
        params = convert(sd, cfg, device)
        print(f"loaded converted ESM weights from {args.esm_ckpt} "
              f"({'transformers' if hf_style else 'fair-esm'} layout)")
    else:
        params = embedder_init(cfg, torch.Generator(device=device).manual_seed(42), device)
        print("esm features with RANDOM embedder weights (pass --esm-ckpt for real ESM-1b)")
    return params, cfg


def with_embedds(batch, e_params, e_cfg):
    """A microbatch stack with each microbatch's residues embedded (no
    gradient) and repeated x3: "embedds" (accum, b, 3L, dim) on the
    embedder's device."""
    with torch.no_grad():
        reps = [embed_sequences(e_params, e_cfg, seq, mask)
                for seq, mask in zip(batch["seq"], batch["mask"])]
    return dict(batch, embedds=torch.repeat_interleave(torch.stack(reps), 3, dim=2))


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(device)} (TF32 off); the e2e step runs "
              f"eagerly (its geometry reads the host: ROADMAP A8-e2e-capture)")
    ecfg = e2e_config_from_args(args)
    tcfg = tcfg_from_args(args, grad_accum=args.accum)
    resilient = resilient_mode(args)
    if args.sp_shards and args.trunk_segments:
        raise SystemExit("--sp-shards and --trunk-segments are exclusive: the segmented step "
                         "is a single-device execution chain")
    if args.trunk_segments and not args.reversible:
        raise SystemExit("--trunk-segments requires --reversible (segment backward IS "
                         "reversible reconstruction)")
    if resilient and args.trunk_segments:
        raise SystemExit("--max-restarts/--fault-plan and --trunk-segments are exclusive: "
                         "the segmented chain donates state internally, which invalidates "
                         "the supervisor's rollback reference")
    dcfg = DataConfig(batch_size=args.batch, max_len=args.max_len,
                      msa_rows=args.msa_rows if args.features == "msa" else 0, seed=args.seed)

    injector, ckpt_fault_hook, max_restarts = chaos_from_args(args)
    mgr, state, resumed = open_or_init(
        args.ckpt_dir, e2e_train_state_init, ecfg, tcfg,
        torch.Generator().manual_seed(args.seed), device, save_every=args.ckpt_every,
        fault_hook=ckpt_fault_hook)
    start = state["step"]
    if resumed:
        print(f"resumed from step {start} in {args.ckpt_dir}")

    if args.features == "esm":
        e_params, e_cfg = load_embedder(args, device)
        # the JAX CLI's iterator: the stream from the (restored) step on
        stream = (with_embedds(b, e_params, e_cfg) for b in stack_microbatches(
            synthetic_structure_batches(dcfg, start_index=start * tcfg.grad_accum),
            tcfg.grad_accum))
        fetch = None
    else:
        # batch i is a pure function of (seed, i): a resumed run takes up the
        # stream at start * accum, a retried step refetches its own batch
        stream = None
        fetch = synthetic_microbatch_fn(dcfg, tcfg.grad_accum,
                                        source=synthetic_structure_batches)
    if args.sp_shards:
        mesh = make_mesh({"seq": args.sp_shards},
                         devices=[device] * args.sp_shards if device.type == "cpu" else None)
        print(f"sequence-parallel trunk over {mesh.size} shards on "
              f"{[str(d) for d in mesh.devices]}")
        train_step = make_sp_train_step(ecfg, tcfg, mesh, loss_fn=sp_e2e_loss_fn(mesh),
                                        device=device)
    elif args.trunk_segments:
        train_step = make_segmented_train_step(ecfg, tcfg, args.trunk_segments, device=device)
    else:
        train_step = make_train_step(ecfg, tcfg, loss_fn=e2e_loss_fn, device=device)

    def make_rng(step):  # dropout's (and the random MDS init's) generator
        return torch.Generator().manual_seed(args.seed * 1_000_003 + step + 1)

    tracer = tracer_from_args(args)  # NULL_TRACER unless --trace-out
    # a logger only when something reads it: its fetch is a sync a step
    logger = (MetricsLogger(jsonl_path=args.metrics_jsonl, print_every=None)  # report() prints
              if args.metrics_jsonl or tracer.enabled or observability_enabled(args) else None)
    registry = MetricRegistry(enabled=tracer.enabled or observability_enabled(args))
    telemetry = build_train_telemetry(
        args, registry=registry, tracer=tracer, logger=logger,
        # the pair side is the x3 backbone; the MSA columns stay at the crop
        step_flops=train_step_flops(ecfg.model, 3 * args.max_len,
                                    dcfg.msa_rows, args.max_len,
                                    grad_accum=tcfg.grad_accum))
    t0 = time.time()
    last = start + args.steps - 1

    def report(step, metrics):
        if step % 10 == 0 or step == last:
            print(f"step {step}  loss {float(metrics['loss']):.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"({time.time() - t0:.1f}s elapsed)")

    metrics = None
    if resilient:
        if args.eval_every:
            print("note: --eval-every is ignored under the resilient loop")
        if args.profile_dir:
            print("note: --profile-dir is ignored under the resilient loop")
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
            state = run_resilient(
                with_fault_injection(train_step, injector), state,
                resilient_batches(fetch if stream is None else stream, injector=injector),
                steps=args.steps, make_rng=make_rng, mgr=mgr, on_metrics=on_metrics,
                max_restarts=max_restarts, preemption=handler, logger=logger, tracer=tracer,
                telemetry=telemetry)
        except Preempted as e:
            print(e)  # saved and closed by the loop: not a failure
            return state, None
        finally:
            handler.uninstall()
            telemetry.close()
            if logger is not None:
                logger.close()
            finish_trace(tracer, args)  # a preempted run keeps its trace
        if injector is not None and not injector.exhausted():
            print(f"warning: fault plan only partially delivered: {injector.delivered}")
        print("done")
        return state, seen.get("metrics")

    # a bounded profiler window after the first step (a 1-step run traces
    # its only step)
    prof_beg = start + 1 if args.steps > 1 else start
    prof_end = prof_beg + max(1, args.profile_steps)
    prof = contextlib.ExitStack()
    try:
        for step in range(start, start + args.steps):
            if args.profile_dir and step == prof_beg:
                prof.enter_context(profile_trace(args.profile_dir))
            with tracer.span("train.fetch", cat="train", step=step), \
                    telemetry.account("data_fetch"):
                batch = fetch(step) if stream is None else next(stream)
            step_bucket = telemetry.step_bucket()
            with tracer.span("train.step", cat="train", step=step), \
                    telemetry.account(step_bucket):
                state, metrics = train_step(state, batch, make_rng(step))
            # logger.log is the step's device sync: this span absorbs the
            # execution train.step only launched
            if logger is not None:
                with tracer.span("train.metrics_fetch", cat="train", step=step), \
                        telemetry.account(step_bucket):
                    logger.log(step, metrics)
            telemetry.step_complete(step)
            report(step, metrics)
            if args.eval_every and (step + 1) % args.eval_every == 0:
                # structure quality on the last microbatch, with the
                # features training sees
                with tracer.span("train.eval", cat="train", step=step), \
                        telemetry.account("eval"), torch.no_grad():
                    mb = {k: v[-1] for k, v in batch.items()}
                    out = e2e.predict_structure(
                        state["params"], ecfg, mb["seq"], mb["mask"], msa=mb.get("msa"),
                        msa_mask=mb.get("msa_mask"), embedds=mb.get("embedds"), device=device)
                    b = out["refined"].shape[0]
                    scores = structure_eval(out["refined"].reshape(b, -1, 3),
                                            torch.as_tensor(mb["coords"]).reshape(b, -1, 3),
                                            mask=out["cloud_mask"].reshape(b, -1))
                if logger is not None:
                    logger.log(step, scores)  # into the JSONL stream too
                print("eval  " + "  ".join(f"{k} {v:.4f}" for k, v in scores.items()))
            if mgr is not None:
                with tracer.span("train.checkpoint", cat="train", step=step), \
                        telemetry.account("checkpoint"):
                    mgr.save(state)  # the interval decides
            if args.profile_dir and step + 1 == prof_end:
                prof.close()  # writes <profile-dir>/trace.json
    finally:
        prof.close()
        # a crashed or interrupted run keeps its trace
        telemetry.close()
        finish_trace(tracer, args)
    if logger is not None:
        logger.close()
    finish(mgr, state)
    print("done")
    return state, metrics


if __name__ == "__main__":
    main()
