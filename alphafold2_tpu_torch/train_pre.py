"""Distogram pretraining on the port (counterpart of the root train_pre.py's
single-device loop, with its checkpoints and its resilient loop).

Usage:
  python -m alphafold2_tpu_torch.train_pre --steps 100 --bf16
  python -m alphafold2_tpu_torch.train_pre --steps 3 --dim 16 --depth 1 \\
      --heads 2 --dim-head 8 --len 16 --accum 2 --device cpu
  python -m alphafold2_tpu_torch.train_pre --steps 100 --bf16 --ckpt-dir runs/pre \\
      --ckpt-every 50 [--max-restarts 3] [--fault-plan plan.json]

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
newest checkpoint, SIGTERM: save and exit 0). Not ported: `--data`
sidechainnet / native and `--len-buckets` (ROADMAP A12), `--metrics-log`,
`--eval-every` and the telemetry flags (A14), `--sp-shards` training and
multi-host runs (A13).
"""

from __future__ import annotations

import argparse
import time

import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.reliability.preemption import Preempted, PreemptionHandler
from alphafold2_tpu_torch.training.checkpoint import finish, open_or_init
from alphafold2_tpu_torch.training.data import (
    DataConfig,
    resilient_batches,
    synthetic_microbatch_fn,
)
from alphafold2_tpu_torch.training.executable import CapturedTrainStep
from alphafold2_tpu_torch.training.harness import (
    add_train_args,
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
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint/resume directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    add_resilience_args(ap)  # --max-restarts / --ckpt-verify / --fault-plan
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)

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

    resilient = resilient_mode(args)
    injector, ckpt_fault_hook, max_restarts = chaos_from_args(args)
    mgr, state, resumed = open_or_init(
        args.ckpt_dir, train_state_init, cfg, tcfg, torch.Generator().manual_seed(args.seed),
        device, save_every=args.ckpt_every, fault_hook=ckpt_fault_hook)
    start = state["step"]
    if resumed:
        print(f"resumed from step {start} in {args.ckpt_dir}")
    # batch i is a pure function of (seed, i): a resumed run takes up the
    # stream at start * accum, a retried step refetches its own batch
    fetch = synthetic_microbatch_fn(dcfg, tcfg.grad_accum)
    if device.type == "cuda":
        train_step = CapturedTrainStep(cfg, tcfg, state, fetch(start))
        capture = next(iter(train_step.captures.values()))
        print(f"captured the step as a CUDA graph in {capture.seconds:.2f} s")
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

    metrics = None
    if resilient:
        handler = PreemptionHandler().install()
        if injector is not None:
            injector.bind_preemption(handler)
        seen = {}

        def on_metrics(step, m):
            seen["metrics"] = m
            report(step, m)

        try:
            state = run_resilient(
                with_fault_injection(train_step, injector), state,
                resilient_batches(fetch, injector=injector), steps=args.steps,
                make_rng=make_rng, mgr=mgr, on_metrics=on_metrics,
                max_restarts=max_restarts, preemption=handler)
        except Preempted as e:
            print(e)  # saved and closed by the loop: not a failure
            return state, None
        finally:
            handler.uninstall()
        if injector is not None and not injector.exhausted():
            print(f"warning: fault plan only partially delivered: {injector.delivered}")
        metrics = seen.get("metrics")
    else:
        for step in range(start, start + args.steps):
            state, metrics = train_step(state, fetch(step), make_rng(step))
            report(step, metrics)
            if mgr is not None:
                mgr.save(state)  # the interval decides
        finish(mgr, state)
    print("done")
    return state, metrics


if __name__ == "__main__":
    main()
