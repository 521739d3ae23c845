"""Where the time of the block-sparse kernels (B5f, B5 dq, B5 dkv) goes, on the card.

    python -m alphafold2_tpu_torch.telemetry.sparse_ablation [--baseline PATH] [--out PATH]
    python -m alphafold2_tpu_torch.telemetry.sparse_ablation --backward [--out PATH]

Builds csrc/sparse_attn.cu and copies of it whose wgmma pipeline (the
shared csrc/flash_fwd_wgmma.cuh, inlined into the copy) has one part
changed or taken out (the results of a copy that drops work are wrong; only
its time is read), and times direct launches at B5f's bf16 shapes (dh 64,
bs 16: the sparse request's pair passes at L = 384, the sparse train step's
at crop 256, n = 4096 and n = 8192) on both routes, wgmma and mma_sync.
From a copy with cycle counters (flash_ablation's) it prints the cycles a
128-key stage of one consumer thread in each warpgroup spends in each
phase (wait for the stage, S issued with the previous P.V, S waited for,
the turn, the softmax, P.V waited for, O rescaled and P packed), and the
producer warp's:

  base           the kernel as built for the port
  no_mask        the block mask is not applied (its results are dense
                 attention's over the listed stages)
  no_ex2         the softmax's exponentials become subtractions
  no_pv          the P.V products are not issued
  counters       clock64 counters a stage
  baseline       (--baseline PATH) another version of sparse_attn.cu: its
                 af2_sparse_fwd (the mma_sync route), timed on the same call

With --backward it times B5 dq and B5 dkv at the same shapes on both
routes, wgmma and mma_sync, beside the flash backward's dense wgmma dkv
kernel on the dense pass of each shape (every key block active), and from
copies of sparse_attn.cu with cycle counters in the dkv pipeline
(csrc/flash_bwd_dkv_wgmma.cuh) or the dq pipeline (csrc/flash_bwd_dq_wgmma.cuh),
dkv_ablation's counters, prints the cycles a stage of one consumer
thread in each warpgroup spends in each phase (a dq stage is two 64-key
halves), the producer's, and the cycles a tile spends outside its stage
loop.

Needs a CUDA device and nvcc; imports nothing of JAX. Writes the record as
JSON to --out (default build/sparse_ablation.json, or
build/sparse_bwd_ablation.json with --backward).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from alphafold2_tpu_torch.ops import cuda_build, flash_kernel, sparse, sparse_kernel
from alphafold2_tpu_torch.telemetry import dkv_ablation
from alphafold2_tpu_torch.telemetry.dkv_ablation import counted
from alphafold2_tpu_torch.telemetry.flash_ablation import (
    EX2,
    HEADER,
    PV,
    _replace,
    _time_ms,
    inline,
    stage_cycles,
    with_counters,
)

SOURCE = cuda_build.CSRC / "sparse_attn.cu"
WORK = cuda_build.BUILD_DIR.parent / "sparse_ablation"
SHAPES = {  # (batch, heads, n, max_seq_len): B5f's bf16 calls
    "served pair axial L=384": (384, 8, 384, 384),
    "trained pair axial crop 256": (256, 8, 256, 256),
    "long n=4096": (1, 8, 4096, 2048),
    "long n=8192": (1, 4, 8192, 2048),
}
MASK = "        const bool live = !LISTED || ((on >> (j / 2)) & 1u);\n"
def variants(baseline: Path = None) -> dict:
    """The copies to time, by name; `baseline` adds another version of
    sparse_attn.cu as it is."""
    src, header = SOURCE.read_text(), HEADER.read_text()
    return {
        "base": src,
        "no_mask": inline(src, _replace(header, MASK, "        const bool live = true;\n")),
        "no_ex2": inline(src, _replace(header, EX2, EX2.replace("ex2(", "("))),
        "no_pv": inline(src, _replace(header, PV, "")),
        "counters": with_counters(src),
        **({"baseline": Path(baseline).read_text()} if baseline else {}),
    }


def backward_variants() -> dict:
    """sparse_attn.cu with the counters in its dkv or its dq pipeline."""
    src = SOURCE.read_text()
    return {
        "dkv_counters": dkv_ablation.with_counters(src),
        "dq_counters": dkv_ablation.with_dq_counters(src),
    }


def build(sources: dict) -> dict:
    """One nvcc a variant, all started together; the loaded libraries."""
    libs = {}
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    for name, built in cuda_build.build_variants(sources, WORK).items():
        if "C7518" in built.log:  # ptxas serialized the wgmma: the copy times another kernel
            print(f"[sparse ablation] warning: the {name} variant's wgmma are serialized (C7518)")
        lib = ctypes.CDLL(str(built.path))
        # the entry points end with dropout's seed, threshold and scale (a
        # source from before them ignores the trailing arguments)
        drop = [p, ctypes.c_uint32, f32]
        lib.af2_sparse_fwd.argtypes = [p] * 8 + [i64] * 4 + [i32, i32, f32, i32, p] + drop
        lib.af2_sparse_fwd.restype = i32
        if name != "baseline":
            lib.af2_sparse_fwd_wgmma.argtypes = [p] * 10 + [i64] * 3 + [f32, p] + drop
            lib.af2_sparse_fwd_wgmma.restype = i32
            lib.af2_sparse_bwd_dq_wgmma.argtypes = [p] * 10 + [i64] * 3 + [f32, p] + drop
            lib.af2_sparse_bwd_dkv_wgmma.argtypes = [p] * 11 + [i64] * 3 + [f32, p] + drop
            lib.af2_sparse_bwd_dq_wgmma.restype = lib.af2_sparse_bwd_dkv_wgmma.restype = i32
        libs[name] = lib
    return libs


def _inputs(b, heads, n, msl):
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b * heads, n, 64, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    keep = torch.rand(b, n, generator=g, device="cuda") >= 0.05
    keep[:, 0] = True
    bias = torch.where(keep, 0.0, float("-inf")).contiguous()
    table = sparse.kernel_table(n // 16, sparse.SparseConfig(block_size=16, max_seq_len=msl),
                                "cuda")
    return q, k, v, bias, table


def _launchers(lib, q, k, v, bias, table, heads, routes=("wgmma", "mma_sync")):
    """route -> a zero-argument direct launch of `lib`'s B5f on these inputs."""
    BH, n, dh = q.shape
    out, lse = torch.empty_like(q), torch.empty((BH, n), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    no_drop = (None, 0, 1.0)  # no seed: the kernels without dropout

    def wgmma():
        rc = lib.af2_sparse_fwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            *(t.data_ptr() for t in table.unions), out.data_ptr(), lse.data_ptr(), BH, heads,
            table.n_blocks, 0.125, stream, *no_drop)
        cuda_build.check_launch(rc, "wgmma route")

    def mma_sync():
        rc = lib.af2_sparse_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                table.idx.data_ptr(), table.counts.data_ptr(), out.data_ptr(),
                                lse.data_ptr(), BH, heads, table.n_blocks, table.idx.shape[1], 16,
                                dh, 0.125, 1, stream, *no_drop)
        cuda_build.check_launch(rc, "mma_sync")

    return {name: fn for name, fn in (("wgmma", wgmma), ("mma_sync", mma_sync))
            if name in routes}


def backward() -> list:
    """The --backward rows: B5 dq and dkv on both routes and the dense dkv
    kernel, timed on the same call, and the two pipelines' cycles."""
    libs = build(backward_variants())
    for lib in libs.values():
        lib.af2_ablation_counters.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, (b, heads, n, msl) in SHAPES.items():
        q, k, v, bias, table = _inputs(b, heads, n, msl)
        do = torch.randn_like(q)
        out, lse = sparse_kernel.sparse_fwd(q, k, v, bias, table, heads, 0.125)
        delta = flash_kernel.cotangent_terms(out, do)[1]
        args = (q, k, v, bias, table, heads, lse, do, delta, 0.125)
        row = {"case": label, "shape": [b * heads, n, 64],
               "active": table.nnz / table.n_blocks ** 2, "times_ms": {}}
        for which in ("wgmma", "mma_sync"):
            row["times_ms"][f"dq {which}"] = _time_ms(
                lambda: sparse_kernel.launch_dq(*args, which=which), 20)
            row["times_ms"][f"dkv {which}"] = _time_ms(
                lambda: sparse_kernel.launch_dkv(*args, which=which), 20)
        dense_bias = bias[torch.arange(b * heads, device="cuda") // heads].contiguous()
        row["times_ms"]["dense dkv wgmma"] = _time_ms(lambda: flash_kernel.launch_dkv(
            q, k, v, dense_bias, lse, do, delta, 0.125, "flash_bwd_dkv"), 20)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
               lse.data_ptr(), delta.data_ptr())
        tail = (b * heads, heads, table.n_blocks, 0.125, stream, None, 0, 1.0)  # no dropout
        dq, dk = torch.empty_like(q), torch.empty_like(k)
        dv = torch.empty_like(v)
        lib = libs["dkv_counters"]
        row["dkv"] = dkv_ablation.tile_cycles(counted(lib, lambda: cuda_build.check_launch(
            lib.af2_sparse_bwd_dkv_wgmma(*ins, *(t.data_ptr() for t in table.key_unions),
                                         dk.data_ptr(), dv.data_ptr(), *tail), "dkv")),
            dkv_ablation.PHASES)
        lib = libs["dq_counters"]
        row["dq"] = dkv_ablation.tile_cycles(counted(lib, lambda: cuda_build.check_launch(
            lib.af2_sparse_bwd_dq_wgmma(*ins, *(t.data_ptr() for t in table.unions[:2]),
                                        dq.data_ptr(), *tail), "dq")), dkv_ablation.DQ_PHASES)
        rows.append(row)
        print(f"[sparse bwd ablation] {label:28s} " + " ".join(
            f"{name}={t:.4f}" for name, t in row["times_ms"].items()) + " ms")
        for kernel in ("dkv", "dq"):
            dkv_ablation.print_cycles("sparse bwd ablation", kernel, row[kernel])
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another sparse_attn.cu to time beside the variants")
    ap.add_argument("--backward", action="store_true",
                    help="B5 dq and B5 dkv instead of the forward")
    ap.add_argument("--out", type=Path, default=None,
                    help="the JSON record (default build/sparse[_bwd]_ablation.json)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sparse_ablation needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[sparse ablation] {card}")
    out = opts.out or WORK.parent / ("sparse_bwd_ablation.json" if opts.backward
                                     else "sparse_ablation.json")
    if opts.backward:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": backward()}, indent=1))
        return
    libs = build(variants(opts.baseline))
    counters = libs["counters"]
    counters.af2_ablation_counters.argtypes = [ctypes.c_void_p]
    rows = []
    for label, (b, heads, n, msl) in SHAPES.items():
        q, k, v, bias, table = _inputs(b, heads, n, msl)
        row = {"case": label, "shape": [b * heads, n, 64],
               "active": table.nnz / table.n_blocks ** 2, "times_ms": {}}
        for name, fn in _launchers(libs["base"], q, k, v, bias, table, heads).items():
            row["times_ms"][name] = _time_ms(fn, 20)
        for name in ("no_mask", "no_ex2", "no_pv"):
            row["times_ms"][name] = _time_ms(
                _launchers(libs[name], q, k, v, bias, table, heads, ("wgmma",))["wgmma"], 20)
        if "baseline" in libs:
            row["times_ms"]["baseline mma_sync"] = _time_ms(_launchers(
                libs["baseline"], q, k, v, bias, table, heads, ("mma_sync",))["mma_sync"], 20)
        if counters.af2_ablation_reset() != 0:
            raise RuntimeError("the counters variant failed to reset")
        _launchers(counters, q, k, v, bias, table, heads, ("wgmma",))["wgmma"]()
        torch.cuda.synchronize()
        phase = np.zeros((1024, 32), dtype=np.uint64)
        counters.af2_ablation_counters(phase.ctypes.data)
        row["cycles_a_stage"] = stage_cycles(phase)
        rows.append(row)
        print(f"[sparse ablation] {label:28s} " + " ".join(
            f"{name}={t:.4f}" for name, t in row["times_ms"].items()) + " ms")
        for who, phases in row["cycles_a_stage"].items():
            print(f"[sparse ablation]   {who} cycles a stage: " + ", ".join(
                f"{p} {c:.0f}" for p, c in phases.items()))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    sys.exit(main())
