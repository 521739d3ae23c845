"""Where one structure request's, or one training step's, time goes on the card.

    python -m alphafold2_tpu_torch.telemetry.profiling [--length 384] [--depth 2] [--gate]
    python -m alphafold2_tpu_torch.telemetry.profiling --int8 | --sparse [--length 384]
    python -m alphafold2_tpu_torch.telemetry.profiling --sp-shards 4 [--length 384]
    python -m alphafold2_tpu_torch.telemetry.profiling --train [--length 128] [--depth 1] [--sparse] [--eager]

Request (the default): runs the serving configuration (dim 256, heads 8,
dim_head 64, bf16, a seeded 20-row MSA, 200 MDS iterations) through
`predict_structure` on the GPU and reports, for one request of `--length`
residues, the request time and the model forward's time (CUDA events,
the mean of `--reps` runs after one warm-up; the rest is the distogram
softmax, the geometry and the confidence). `--int8` serves resident int8
trunk weights (`weight_dtype="int8"`, kernel B4); `--sparse` runs the pair
axial passes of every other layer block-sparse (`sparse_self_attn=(True,
False, ...)`, kernel B5). `--sp-shards N` serves the request through the
sequence-parallel forward (parallel/sp_trunk.py alphafold2_apply_sp, the
trunk's MSA<-pair cross on kernel B3) over N shards placed on the visible
cards in turn (shard s on card s mod count; the tool prints the
placement); the events are recorded on the first card, where the request
starts and ends.

Train (`--train`): runs train_pre's step (dim 256, heads 8, dim_head 64,
bf16, batch 1, 16 microbatches, synthetic sequence-only batches at crop
`--length`) as train_pre runs it on the card, captured as a CUDA graph
(`training/executable.py CapturedTrainStep`; the capture's seconds and
peak memory are reported), or with `--eager` as the eager step
(`training/harness.py make_train_step`), and reports the step time (CUDA
events, mean of `--reps` steps after one warm-up step); `--sparse` makes
every layer's pair passes block-sparse with max_seq_len = the crop
(chip_smoke.py phase 6e's configuration: at crop 256, 66% of the blocks
active).

Both: from one more run under `torch.profiler`, device time by kernel
name and by kind (the port's flash, sparse and int8 kernels, cuBLAS
matrix products, the optimizer's fused updates, the rest), the kind
"other" again by the ATen op that launched each kernel (the innermost
op: a backward's kernels under the op its autograd node calls), the
launches the host issued (kernel launch calls and graph launches), and
the device's busy share of the time measured without the profiler. The
record goes to `--out` as JSON. Needs a CUDA device; float32 matmuls and
convolutions run in full float32 (TF32 off).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from alphafold2_tpu_torch.models.alphafold2 import alphafold2_apply, alphafold2_init
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.ops import flash_kernel, quant_kernel, sparse_kernel
from alphafold2_tpu_torch.parallel import alphafold2_apply_sp, make_mesh
from alphafold2_tpu_torch.serving.pipeline import predict_structure
from alphafold2_tpu_torch.serving.quant_residency import resident_params
from alphafold2_tpu_torch.training.data import DataConfig, synthetic_microbatch_fn
from alphafold2_tpu_torch.training.executable import CapturedTrainStep
from alphafold2_tpu_torch.training.harness import (
    TrainConfig,
    make_train_step,
    train_state_init,
)

_GEMM_MARKERS = ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_")
_OPTIMIZER_MARKERS = ("multi_tensor_apply", "foreach", "adam")
_OTHER = "other (elementwise, reductions, softmax, eigh, copies)"
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def kernel_kind(name: str) -> str:
    low = name.lower()
    if "flash_fwd_" in low:
        return "flash forward (this port)"
    if "flash_bwd_" in low:
        return "flash backward (this port)"
    if "sparse_fwd_" in low:
        return "sparse forward (this port)"
    if "sparse_dq_" in low or "sparse_dkv_" in low:
        return "sparse backward (this port)"
    if "quant_matmul_" in low:
        return "int8 matrix products (this port)"
    if any(m in low for m in _GEMM_MARKERS):
        return "matrix products (cuBLAS)"
    if any(m in low for m in _OPTIMIZER_MARKERS):
        return "optimizer (fused multi-tensor updates)"
    return _OTHER


def _events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(avg) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(avg, attr, None)
        if value is not None:
            return float(value)
    return 0.0


_COUNTED = (flash_kernel, quant_kernel, sparse_kernel)


def _profile(fn):
    """Device time by kernel and by kind over one call of fn under
    torch.profiler, the kind "other" by launching op, the launches the
    host issued, and the port's kernel launch counts of that call."""
    for module in _COUNTED:
        module.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = {name: n for module in _COUNTED for name, n in module.LAUNCHES.items()}
    averages = prof.key_averages()
    # a user annotation's device span (the optimizer's record_function)
    # covers kernels counted on their own
    kernels = [
        {"name": a.key, "count": a.count, "device_ms": _device_us(a) / 1e3}
        for a in averages
        if a.device_type == torch.autograd.DeviceType.CUDA and _device_us(a) > 0
        and not getattr(a, "is_user_annotation", False)
    ]
    kernels.sort(key=lambda k: -k["device_ms"])
    kinds = {}
    for k in kernels:
        kind = kinds.setdefault(kernel_kind(k["name"]), {"device_ms": 0.0, "launches": 0})
        kind["device_ms"] += k["device_ms"]
        kind["launches"] += k["count"]
    other_by_op = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in evt.kernels:
            if kernel_kind(k.name) == _OTHER:
                row = other_by_op.setdefault(evt.name, {"device_ms": 0.0, "launches": 0})
                row["device_ms"] += k.duration / 1e3
                row["launches"] += 1
    host = {"kernel_launches": sum(a.count for a in averages if a.key in LAUNCH_APIS),
            "graph_launches": sum(a.count for a in averages if a.key == "cudaGraphLaunch")}
    return kernels, kinds, launches, other_by_op, host


def _request(args):
    L = args.length or 384
    depth = args.depth or 2
    cfg = Alphafold2Config(dim=256, depth=depth, heads=8, dim_head=64,
                           max_seq_len=L, dtype=torch.bfloat16, attn_gate=args.gate,
                           weight_dtype="int8" if args.int8 else "f32",
                           sparse_self_attn=tuple(n % 2 == 0 for n in range(depth)) if args.sparse
                           else False)
    device, apply_fn = torch.device("cuda", 0), None
    if args.sp_shards:
        cards = torch.cuda.device_count()
        mesh = make_mesh({"seq": args.sp_shards},
                         devices=[f"cuda:{s % cards}" for s in range(args.sp_shards)])
        device, apply_fn = mesh.devices[0], functools.partial(alphafold2_apply_sp, mesh=mesh)
        print(f"[profile] sequence-parallel: {args.sp_shards} shards on {cards} card(s): "
              f"{[str(d) for d in mesh.devices]}")
    params, residency = resident_params(
        alphafold2_init(cfg, torch.Generator().manual_seed(args.seed), device), cfg)
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, 20, (1, L)).astype(np.int32)
    msa = rng.integers(0, 21, (1, 20, L)).astype(np.int32)
    msa[0, 0] = tokens[0]
    msa_mask = rng.random((1, 20, L)) > 0.1
    msa_mask[0, 0] = True

    def request():
        if args.sp_shards:
            return predict_structure(params, cfg, tokens, msa=msa, msa_mask=msa_mask,
                                     mds_iters=200, model_apply_fn=apply_fn)
        return predict_structure(params, cfg, tokens, msa=msa, msa_mask=msa_mask,
                                 mds_iters=200, device=device)

    def forward():
        with torch.inference_mode():
            if args.sp_shards:
                return apply_fn(params, cfg, tokens, msa, msa_mask=msa_mask)
            return alphafold2_apply(params, cfg, tokens, msa, msa_mask=msa_mask,
                                    device=device)

    request()
    torch.cuda.synchronize()
    request_ms = _events_ms(request, args.reps)
    forward_ms = _events_ms(forward, args.reps)
    print(f"[profile] L={L} depth={depth} gate={args.gate} int8={args.int8} "
          f"sparse={args.sparse} sp_shards={args.sp_shards}: request {request_ms:.3f} ms, forward {forward_ms:.3f} ms, "
          f"rest {request_ms - forward_ms:.3f} ms (CUDA events, mean of {args.reps}); "
          f"weights {residency['weight_bytes']:,} bytes ({residency['fp32_weight_bytes']:,} "
          f"in f32)")
    return request, request_ms, {
        "config": repr(cfg), "length": L, "msa_rows": 20, "mds_iters": 200,
        "sp_shards": args.sp_shards,
        "request_ms": request_ms, "forward_ms": forward_ms,
        "rest_ms": request_ms - forward_ms, "residency": residency,
    }


def _train(args):
    L = args.length or 128
    depth = args.depth or 1
    cfg = Alphafold2Config(dim=256, depth=depth, heads=8, dim_head=64,
                           max_seq_len=L if args.sparse else 2048, dtype=torch.bfloat16,
                           attn_gate=args.gate, sparse_self_attn=args.sparse)
    tcfg = TrainConfig(grad_accum=16)
    state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(args.seed), "cuda")
    batch = synthetic_microbatch_fn(DataConfig(max_len=L, seed=args.seed), 16)(0)
    record = {"config": repr(cfg), "length": L, "grad_accum": 16,
              "arm": "eager" if args.eager else "captured"}
    if args.eager:
        step = make_train_step(cfg, tcfg, device="cuda")
    else:
        torch.cuda.reset_peak_memory_stats()
        step = CapturedTrainStep(cfg, tcfg, state, batch)
        capture = next(iter(step.captures.values()))
        record.update(capture_s=capture.seconds,
                      capture_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"[profile] captured the step in {capture.seconds:.3f} s, peak memory "
              f"{record['capture_peak_gib']:.3f} GiB")

    def train_step():
        return step(state, batch)

    train_step()
    torch.cuda.synchronize()
    step_ms = _events_ms(train_step, args.reps)
    print(f"[profile] train step ({record['arm']}) L={L} depth={depth} gate={args.gate} "
          f"sparse={args.sparse} accum 16: "
          f"{step_ms:.3f} ms (CUDA events, mean of {args.reps})")
    record["step_ms"] = step_ms
    return train_step, step_ms, record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="profile one train_pre step instead of one request")
    ap.add_argument("--length", type=int, default=None,
                    help="residues (default 384 for a request, 128 for a train step)")
    ap.add_argument("--depth", type=int, default=None,
                    help="trunk depth (default 2 for a request, 1 for a train step)")
    ap.add_argument("--gate", action="store_true", help="attn_gate=True (the fused kernels)")
    ap.add_argument("--int8", action="store_true",
                    help="request: weight_dtype='int8' (resident int8 trunk weights, kernel B4)")
    ap.add_argument("--sparse", action="store_true",
                    help="request: sparse_self_attn=(True, False, ...) (kernel B5 on the "
                         "pair axial passes of every other layer); train step: "
                         "sparse_self_attn=True with max_seq_len the crop")
    ap.add_argument("--sp-shards", type=int, default=0,
                    help="request: the sequence-parallel forward over this many shards, "
                         "placed on the visible cards in turn (0: dense)")
    ap.add_argument("--eager", action="store_true",
                    help="train step: the eager step (make_train_step), not the captured one")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="JSON record (default chiprun_out/profile_{request,train}.json)")
    args = ap.parse_args(argv)
    if args.train and (args.int8 or args.sp_shards):
        ap.error("--int8 and --sp-shards profile a request")
    if args.eager and not args.train:
        ap.error("--eager profiles a train step")
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[profile] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")

    fn, wall_ms, record = (_train if args.train else _request)(args)
    kernels, kinds, launches, other_by_op, host = _profile(fn)
    device_ms = sum(k["device_ms"] for k in kernels)
    top_ops = sorted(other_by_op.items(), key=lambda kv: -kv[1]["device_ms"])
    record.update({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "profiled_device_ms": device_ms,
        "busy_share": device_ms / wall_ms if kernels else None,
        "kinds": kinds, "kernels": kernels[:25], "launches": launches,
        "other_by_op": [{"op": op, **v} for op, v in top_ops[:40]], "host_launches": host,
    })
    if not kernels:
        print("[profile] the profiler recorded no device time: kernel breakdown not measured")
    else:
        print(f"[profile] device time {device_ms:.3f} ms under the profiler; busy share "
              f"{record['busy_share']:.3f} of the time measured without it")
        for kind, v in sorted(kinds.items(), key=lambda kv: -kv[1]["device_ms"]):
            print(f"[profile]   {v['device_ms']:10.3f} ms {v['launches']:6d} launches  {kind}")
        for k in kernels[:12]:
            print(f"[profile]   {k['device_ms']:10.3f} ms {k['count']:6d} x  {k['name'][:90]}")
        print("[profile] the kind other by launching op:")
        for op, v in top_ops[:15]:
            print(f"[profile]   {v['device_ms']:10.3f} ms {v['launches']:6d} launches  {op[:90]}")
    print(f"[profile] the host issued {host['kernel_launches']} kernel launches and "
          f"{host['graph_launches']} graph launches")
    print(f"[profile] kernel launches {launches}")
    out = Path(args.out or f"chiprun_out/profile_{'train' if args.train else 'request'}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
