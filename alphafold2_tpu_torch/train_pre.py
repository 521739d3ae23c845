"""Distogram pretraining on the port (counterpart of the root train_pre.py's
plain single-device loop).

Usage:
  python -m alphafold2_tpu_torch.train_pre --steps 100 --bf16
  python -m alphafold2_tpu_torch.train_pre --steps 3 --dim 16 --depth 1 \\
      --heads 2 --dim-head 8 --len 16 --accum 2 --device cpu

Trains on synthetic protein-like batches (`training/data.py`,
sequence-only) with the defaults of the JAX CLI: dim 256, depth 1, heads
8, dim_head 64, crop 128, batch 1, 16 microbatches per step. Runs on the
GPU unless `--device cpu` is given, and never falls back to the CPU;
float32 matmuls and convolutions run in full float32 there (TF32 off).
On the GPU the step is captured as a CUDA graph on the first batch and
replayed (`training/executable.py CapturedTrainStep`, the JAX CLI's
jitted step); the CPU runs the eager `make_train_step`.
Checkpointing, resilience and telemetry flags are not ported yet
(ROADMAP A12, A14).
"""

from __future__ import annotations

import argparse
import itertools
import time

import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.training.data import (
    DataConfig,
    stack_microbatches,
    synthetic_batches,
)
from alphafold2_tpu_torch.training.executable import CapturedTrainStep
from alphafold2_tpu_torch.training.harness import (
    add_train_args,
    make_train_step,
    tcfg_from_args,
    train_state_init,
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
    state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(args.seed), device)
    batches = stack_microbatches(synthetic_batches(dcfg), tcfg.grad_accum)
    if device.type == "cuda":
        first = next(batches)
        train_step = CapturedTrainStep(cfg, tcfg, state, first)
        capture = next(iter(train_step.captures.values()))
        print(f"captured the step as a CUDA graph in {capture.seconds:.2f} s")
        batches = itertools.chain([first], batches)
    else:
        train_step = make_train_step(cfg, tcfg, device=device)
    rng = torch.Generator().manual_seed(args.seed + 1)  # dropout, when a rate is set

    t0 = time.time()
    metrics = None
    for step in range(args.steps):
        state, metrics = train_step(state, next(batches), rng)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step}  loss {float(metrics['loss']):.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"({time.time() - t0:.1f}s elapsed)")
    print("done")
    return state, metrics


if __name__ == "__main__":
    main()
