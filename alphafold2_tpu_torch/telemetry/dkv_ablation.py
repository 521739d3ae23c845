"""Where the time of the flash backward's wgmma kernels (dkv, dq) goes, on the card.

    python -m alphafold2_tpu_torch.telemetry.dkv_ablation [--baseline PATH] [--out PATH]

Builds csrc/flash_bwd.cu and copies of it whose dkv pipeline (the shared
csrc/flash_bwd_dkv_wgmma.cuh, inlined into the copy) has one part changed
or taken out (the results of a copy that drops work are wrong; only its
time is read), times each at the trained bf16 backward shapes (pair axial
at crop 128 and 256, the 2-D bias pair at crop 128, B3's ring gradient at
the L = 128 hop; dh = 64), and prints, from a copy with cycle counters, the
cycles a 64-query stage of one consumer thread in each warpgroup spends in
each phase, the cycles a tile spends outside its stage loop (the key bias,
the first stage's products and elementwise pass, the last stage's dV and
dK, the epilogue), and the producer warp's. The dq kernel is timed at the
same shapes on its routes (wgmma where `dq_route` gives it, and mma_sync;
the baseline's own dq kernel beside them), and a copy with the same
counters in the dq pipeline (csrc/flash_bwd_dq_wgmma.cuh, unlisted: every
128-key stage, taken as two 64-key halves) prints its cycles a stage and a
tile:

  base           the kernel as built for the port
  turns          the two warpgroups take turns at the elementwise pass (a
                 named barrier each, as the flash forward does)
  no_overlap     each stage waits for its dV and dK products before the
                 next elementwise pass
  no_ex2         the elementwise pass's exponentials become subtractions
  no_ss          the S^T and dP^T products are not issued
  no_rs          the dV and dK products are not issued
  no_store       the epilogue's TMA stores of dk and dv are not issued
  dq_counters    clock64 counters a stage of the dq pipeline
  baseline       (--baseline PATH) another version of flash_bwd.cu, timed
                 on the same call

The block-sparse backward's tool (sparse_ablation --backward) puts the
same counters into the sparse dkv and dq kernels, the listed form of the
two pipelines. Needs a CUDA device and nvcc; imports nothing of JAX.
Writes the record as JSON to --out (default build/dkv_ablation.json).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from alphafold2_tpu_torch.ops import cuda_build, flash_kernel
from alphafold2_tpu_torch.telemetry.flash_ablation import _replace, _time_ms

SOURCE = cuda_build.CSRC / "flash_bwd.cu"
HEADER = cuda_build.CSRC / "flash_bwd_dkv_wgmma.cuh"  # the pipeline the variants change
INCLUDE = '#include "flash_bwd_dkv_wgmma.cuh"\n'
WORK = cuda_build.BUILD_DIR.parent / "dkv_ablation"
SHAPES = {  # (BH, i, j, 2-D bias), the trained bf16 dkv calls
    "pair axial L=256": (2048, 256, 256, False),
    "pair axial L=128": (1024, 128, 128, False),
    "pair axial L=128 bias2d": (1024, 128, 128, True),
    "B3 ring gradient L=128 P=4": (8, 640, 4096, False),
}
PHASES = ("wait for the stage (loads)", "issue the four products", "wait for S^T and dP^T",
          "elementwise", "wait for dV and dK", "pack P^T and dS^T, release")
TILE_START = ("      for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;\n"
              "      const uint32_t kv = base + (n & 1) * L::kKV;\n")
TILE_END = "      dkv(c);\n      list_of(tile + gridDim.x);\n"
STORES = ("          tma_store_3d(&tm_dk, st, 0, k0 + 64 * wg, bh);\n"
          "          tma_store_3d(&tm_dv, st + kKVTile, 0, k0 + 64 * wg, bh);\n")
TILE_DONE = "        mbar_arrive(kvempty(n));\n      }\n"
PRODUCER_END = ('      }\n    }\n  } else {\n'
                '    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(L::kConsumerRegs));\n')

LOOP = """        on = mask_of(first + qq);
        mbar_wait(full(c + 1), ring(c + 1));
        sdp(kv, c + 1);
        dkv(c);
        wgmma_wait<1>();  // the S^T and dP^T (groups retire in order)
        fence_regs(s);
        fence_regs(dp);
        elementwise(c + 1, on);
        wgmma_wait<0>();  // the dV and dK
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        fence_regs(pa);
        fence_regs(da);
        pack();
        release(empty(c));
"""
# the elementwise passes: a tile's first stage, its next stages
PASSES = ("      elementwise(c, on);\n", "        elementwise(c + 1, on);\n")
TILES = "    int c = 0, n = 0;\n    for (int64_t tile"
EX2 = "            const float p = ex2(fmaf(s[x], scale_log2, b) - (e ? l2.y : l2.x));\n"
SS = ("        wgmma_m64n64k16_ss(s, gmma_desc(ka + 32 * ks, 16, 1024), "
      "gmma_desc(qa + 32 * ks, 16, 1024),\n                           ks);\n",
      "        wgmma_m64n64k16_ss(dp, gmma_desc(ka + kKVTile + 32 * ks, 16, 1024),\n"
      "                           gmma_desc(qa + kQStage + 32 * ks, 16, 1024), ks);\n")
RS = ("        wgmma_m64n64k16_rs_mn(dv_acc, &pa[4 * ks], "
      "gmma_desc(qa + kQStage + 2048 * ks, kMNLbo, 1024));\n",
      "        wgmma_m64n64k16_rs_mn(dk_acc, &da[4 * ks], gmma_desc(qa + 2048 * ks, kMNLbo, 1024));\n")
# named barriers 3 and 4 (1 and 2 are the warpgroups' own, in the epilogue)
TURNS = ('    auto turn_wait = [&]() { asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + wg) : "memory"); };\n'
         '    auto turn_pass = [&]() {\n'
         '      asm volatile("bar.arrive %0, 256;\\n" ::"r"(3 + (wg + 1) % 2) : "memory");\n'
         '    };\n'
         '    if (wg == 1) turn_pass();  // warpgroup 0 goes first\n')


@dataclasses.dataclass(frozen=True)
class Marks:
    """Where a backward pipeline's counters go, as text of its header: the
    function's head, its tile's start, the stage loop's head and body (and
    the body's line index -> the phase it closes), the tile's last products
    and its end (the producer's end is PRODUCER_END in both pipelines)."""

    head: str
    tile_start: str
    loop_head: str
    loop: str
    marks: dict
    tile_end: str
    tile_done: str


DQ_HEADER = cuda_build.CSRC / "flash_bwd_dq_wgmma.cuh"
DQ_INCLUDE = '#include "flash_bwd_dq_wgmma.cuh"\n'
DQ_PHASES = ("wait for the stage (loads)", "issue S, dP and dS.K", "wait for S and dP",
             "elementwise", "wait for dS.K", "pack dS, release")
DQ_LOOP = """        on = mask_of(first + kk);
        mbar_wait(full(c + 1), ring(c + 1));
        sdp(qa, c + 1, 0);
        dsk(c, 1);
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        elementwise(c + 1, 0, on);
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_regs(da);
        pack();
        release(empty(c));
        sdp(qa, c + 1, 1);
        dsk(c + 1, 0);
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        elementwise(c + 1, 1, on);
        store_bias(c + 1, kk);
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_regs(da);
        pack();
"""


DKV = Marks(head="template <bool BIAS2D, bool LISTED, class Drop = Dropout<false>>\n"
           "__device__ __forceinline__ void wgmma_dkv(",
            tile_start=TILE_START,
            loop_head="      for (int qq = 1; qq < count; ++qq, ++c) {\n",
            loop=LOOP, marks={1: 0, 3: 1, 6: 2, 7: 3, 12: 4, 14: 5}, tile_end=TILE_END,
            tile_done=TILE_DONE)


# the dq pipeline's counters: a stage's two halves add into the same phases
# (a 2-D bias's d_bias stores into the elementwise pass's)
DQ = Marks(head="template <bool BIAS2D, bool LISTED, class Drop = Dropout<false>>\n"
           "__device__ __forceinline__ void wgmma_dq(",
           tile_start=("      for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;\n"
                       "      const uint32_t qa = base + (n % QB) * L::kQG + wg * kHalfBytes;\n"),
           loop_head="      for (int kk = 1; kk < count; ++kk, ++c) {\n", loop=DQ_LOOP,
           marks={1: 0, 3: 1, 6: 2, 7: 3, 10: 4, 12: 5, 14: 1, 17: 2, 19: 3, 22: 4, 23: 5},
           tile_end="      dsk(c, 1);\n      list_of(tile + gridDim.x);\n",
           tile_done="        mbar_arrive(qempty(n));\n      }\n")


def counters(header: str, at: Marks) -> str:
    """The pipeline `header` with clock64 counters around the consumer's
    phases of each stage (summed by the first thread of each warpgroup) and
    the producer's (lane 0): g_phase[block][wg * 8 + phase],
    [block][wg * 8 + 7] the stages after a tile's first, [block][wg * 8 +
    6] the cycles outside the stage loop over [block][28 + wg] tiles,
    [block][24, 25] the producer's waits and issues over [block][26]
    stages (`tile_cycles`)."""
    src = _replace(header, at.head, "__device__ unsigned long long g_phase[1024][32];\n\n" + at.head)
    src = _replace(src, "      int c = 0, n = 0;\n      for (int64_t tile",
                   "      unsigned long long P[3] = {0, 0, 0};\n      int c = 0, n = 0;\n"
                   "      for (int64_t tile")
    src = _replace(src, "          mbar_wait(empty(c), ring(c) ^ 1);\n",
                   "          const long long p0 = clock64();\n          mbar_wait(empty(c), ring(c) ^ 1);\n"
                   "          const long long p1 = clock64();\n          P[0] += p1 - p0;\n")
    src = _replace(src, "            mbar_expect_tx(full(c), L::kStage);\n",
                   "            P[1] += clock64() - p1;\n            P[2] += 1;\n"
                   "            mbar_expect_tx(full(c), L::kStage);\n")
    src = _replace(src, PRODUCER_END,
                   "      if (lane == 0 && blockIdx.x < 1024) {\n"
                   "        g_phase[blockIdx.x][24] = P[0];\n        g_phase[blockIdx.x][25] = P[1];\n"
                   "        g_phase[blockIdx.x][26] = P[2];\n"
                   "      }\n" + PRODUCER_END)
    src = _replace(src, TILES, "    unsigned long long T[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};\n" + TILES)
    src = _replace(src, at.tile_start, at.tile_start + "      long long tt = clock64();\n")
    src = _replace(src, at.loop_head, "      T[6] += clock64() - tt;\n" + at.loop_head)
    src = _replace(src, at.tile_end, "      tt = clock64();\n" + at.tile_end)
    body = ["        long long tc = clock64(), tn;"]
    for n, line in enumerate(at.loop.split("\n")[:-1]):
        body.append(line)
        if n in at.marks:
            body.append(f"        tn = clock64();\n        T[{at.marks[n]}] += tn - tc;\n        tc = tn;")
    body.append("        T[7] += 1;")
    src = _replace(src, at.loop, "\n".join(body) + "\n")
    return _replace(src, at.tile_done, at.tile_done + "      T[6] += clock64() - tt;\n      T[8] += 1;\n"
                    "      if (threadIdx.x % 128 == 0 && blockIdx.x < 1024) {\n"
                    "        for (int i = 0; i < 8; ++i) g_phase[blockIdx.x][8 * wg + i] = T[i];\n"
                    "        g_phase[blockIdx.x][28 + wg] = T[8];\n"
                    "      }\n")


def readback(namespace: str) -> str:
    """The entry points that read `namespace`'s g_phase back
    (af2_ablation_counters) and zero it (af2_ablation_reset)."""
    table = f"{namespace}::g_phase"
    return (f"\nextern \"C\" int af2_ablation_counters(void* host) {{\n"
            f"  return (int)cudaMemcpyFromSymbol(host, {table}, sizeof({table}));\n}}\n"
            "\nextern \"C\" int af2_ablation_reset() {\n"
            "  static unsigned long long zero[1024][32];\n"
            f"  return (int)cudaMemcpyToSymbol({table}, zero, sizeof(zero));\n}}\n")


def inline(src: str, header: str, include: str = INCLUDE) -> str:
    """`src` (a source that includes a shared pipeline) with the include
    replaced by `header`, a changed copy of the pipeline."""
    return _replace(src, include, header)


def with_counters(src: str) -> str:
    """`src` (flash_bwd.cu or sparse_attn.cu) with the dkv pipeline's
    counters inlined, and their entry points."""
    return inline(src, counters(HEADER.read_text(), DKV)) + readback("af2::dkv")


def with_dq_counters(src: str) -> str:
    """`src` (flash_bwd.cu or sparse_attn.cu) with the dq pipeline's
    counters inlined, and their entry points."""
    return inline(src, counters(DQ_HEADER.read_text(), DQ), DQ_INCLUDE) + readback("af2::dq")


def tile_cycles(phase: np.ndarray, phases: tuple) -> dict:
    """The counters (`counters`' g_phase, 1024 x 32) as the cycles a stage
    of each warpgroup's first thread spends in each of `phases`, the
    producer's, and the cycles a tile spends outside its stage loop."""
    per = phase.astype(np.float64).sum(0)  # blocks past the grid, and their tiles, count 0
    cycles = {f"wg{wg}": {p: per[8 * wg + n] / per[8 * wg + 7] for n, p in enumerate(phases)}
              for wg in range(2) if per[8 * wg + 7] > 0}
    if per[26] > 0:
        cycles["producer"] = {"wait for an empty slot": per[24] / per[26],
                              "scalars and TMA issue": per[25] / per[26]}
    outside = {f"wg{wg}": per[8 * wg + 6] / per[28 + wg] for wg in range(2) if per[28 + wg] > 0}
    return {"cycles_a_stage": cycles, "cycles_a_tile_outside_the_stage_loop": outside}


def variants(baseline: Path = None) -> dict:
    """The copies to time, by name; `baseline` adds another version of
    flash_bwd.cu as it is."""
    src, header = SOURCE.read_text(), HEADER.read_text()
    turns = _replace(header, TILES, TURNS + TILES)
    for text in PASSES:
        pad = text[:len(text) - len(text.lstrip())]
        turns = _replace(turns, text, f"{pad}turn_wait();\n{text}{pad}turn_pass();\n")
    no_ss, no_rs = header, header
    for text in SS:
        no_ss = _replace(no_ss, text, "")
    for text in RS:
        no_rs = _replace(no_rs, text, "")
    return {
        "base": src,
        "turns": inline(src, turns),
        "no_overlap": inline(src, _replace(
            header, "        wgmma_wait<1>();  // the S^T and dP^T (groups retire in order)\n",
            "        wgmma_wait<0>();\n")),
        "no_ex2": inline(src, _replace(header, EX2, EX2.replace("ex2(", "("))),
        "no_ss": inline(src, no_ss),
        "no_rs": inline(src, no_rs),
        "no_store": inline(src, _replace(header, STORES, "")),
        "counters": with_counters(src),
        **({"baseline": Path(baseline).read_text()} if baseline else {}),
    }


def build(sources: dict) -> dict:
    """One nvcc a variant, all started together; the loaded libraries."""
    libs = {}
    for name, built in cuda_build.build_variants(sources, WORK).items():
        if "C7518" in built.log:  # ptxas serialized the wgmma: the copy times another kernel
            print(f"[dkv ablation] warning: the {name} variant's wgmma are serialized (C7518)")
        lib = ctypes.CDLL(str(built.path))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        entries = [lib.af2_flash_bwd_dkv_wgmma]
        if hasattr(lib, "af2_flash_bwd_dq_wgmma"):  # a baseline may predate it
            entries.append(lib.af2_flash_bwd_dq_wgmma)
        for fn in entries:
            fn.argtypes = [p, p, p, p, p, p, p, p, p, i64, i64, i64, i32, ctypes.c_float, i32, p]
            fn.restype = i32
        lib.af2_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, p, i64, i64, i64, i32,
                                         ctypes.c_float, i32, i32, p]
        lib.af2_flash_bwd_dq.restype = i32
        libs[name] = lib
    return libs


def counted(lib, launch) -> np.ndarray:
    """The g_phase table of one `launch` (which raises if it fails) of a
    counters copy."""
    if lib.af2_ablation_reset() != 0:
        raise RuntimeError("the counters variant failed to reset")
    launch()
    torch.cuda.synchronize()
    phase = np.zeros((1024, 32), dtype=np.uint64)
    lib.af2_ablation_counters(phase.ctypes.data)
    return phase


def print_cycles(tool: str, kernel: str, cycles: dict) -> None:
    """`tile_cycles`' record of one kernel, a line a warpgroup and one for
    the tiles."""
    for who, phases in cycles["cycles_a_stage"].items():
        print(f"[{tool}]   {kernel} {who} cycles a stage: " + ", ".join(
            f"{p} {c:.0f}" for p, c in phases.items()))
    print(f"[{tool}]   {kernel} cycles a tile outside the stage loop: " + ", ".join(
        f"{who} {c:.0f}" for who, c in cycles["cycles_a_tile_outside_the_stage_loop"].items()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another flash_bwd.cu to time beside the variants")
    ap.add_argument("--out", type=Path, default=WORK.parent / "dkv_ablation.json",
                    help="the JSON record")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dkv_ablation needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[dkv ablation] {card}")
    libs = build({**variants(opts.baseline),
                  "dq_counters": with_dq_counters(SOURCE.read_text())})
    copies = {name: libs.pop(name) for name in ("counters", "dq_counters")}
    for lib in copies.values():
        lib.af2_ablation_counters.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, (BH, i, j, bias2d) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(BH, n, 64, generator=g, device="cuda").bfloat16()
                       for n in (i, j, j, i))
        bias = torch.randn((BH, i, j) if bias2d else (BH, j), generator=g, device="cuda")
        out, lse = (flash_kernel.flash_fwd_fused(q, k, v, bias, 0.125) if bias2d
                    else flash_kernel.flash_fwd(q, k, v, bias, 0.125))
        delta = flash_kernel.cotangent_terms(out, do)[1]
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, i, j, 64,
                0.125, int(bias2d), stream)
        row = {"case": label, "shape": [BH, i, j, 64], "bias2d": bias2d}
        for name, lib in libs.items():
            row[name] = _time_ms(lambda: lib.af2_flash_bwd_dkv_wgmma(*args), 20)
        lib = copies["counters"]
        row.update(tile_cycles(counted(lib, lambda: cuda_build.check_launch(
            lib.af2_flash_bwd_dkv_wgmma(*args), "dkv")), PHASES))
        # the dq kernel on the same call: its routes, and the baseline's own
        dq = torch.empty_like(q)
        d_bias = torch.empty_like(bias) if bias2d else None
        dq_args = (*args[:7], dq.data_ptr(), d_bias.data_ptr() if bias2d else None, *args[9:14])
        dq_which = flash_kernel.dq_route(q, k, v, bias)
        if dq_which == "wgmma":
            row["dq wgmma"] = _time_ms(
                lambda: libs["base"].af2_flash_bwd_dq_wgmma(*dq_args, int(bias2d), stream), 20)
            lib = copies["dq_counters"]
            row["dq"] = tile_cycles(counted(lib, lambda: cuda_build.check_launch(
                lib.af2_flash_bwd_dq_wgmma(*dq_args, int(bias2d), stream), "dq")), DQ_PHASES)
        for name in ("base", "baseline"):
            if name in libs:
                row[f"{name} dq mma_sync"] = _time_ms(
                    lambda: libs[name].af2_flash_bwd_dq(*dq_args, 1, int(bias2d), stream), 20)
        rows.append(row)
        print(f"[dkv ablation] {label:26s} " + " ".join(
            f"{name}={row[name]:.4f}" for name in row if isinstance(row[name], float)) + " ms")
        print_cycles("dkv ablation", "dkv", row)
        if "dq" in row:
            print_cycles("dkv ablation", "dq", row["dq"])
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    sys.exit(main())
