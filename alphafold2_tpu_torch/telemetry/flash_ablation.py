"""Where the time of the flash forward's wgmma route goes, on the card.

    python -m alphafold2_tpu_torch.telemetry.flash_ablation [--baseline PATH] [--out PATH]

Builds csrc/flash_fwd.cu and copies of it whose wgmma pipeline (the shared
csrc/flash_fwd_wgmma.cuh, inlined into the copy) has one part changed or
taken out (the results of a copy that drops work are wrong; only its time
is read), times each at the served bf16 shapes (L = 384, dh = 64; the pair
passes, the two crosses, the SP request's B3 hop, the 2-D bias pair), and
prints, from a copy with cycle counters, the cycles a 128-key stage of one
consumer thread in each warpgroup spends in each phase, and the producer
warp's:

  base           the kernel as built for the port
  turn_products  the warpgroups take turns issuing their products instead
                 of at the softmax
  no_turns       no turns: the warpgroups run unordered
  no_overlap     each stage waits for its P.V before the next softmax
  no_ex2         the softmax's exponentials become subtractions
  no_pv          the P.V products are not issued
  no_qk          the Q.K^T products are not issued
  baseline       (--baseline PATH) another version of flash_fwd.cu, timed
                 on the same call

The counters add registers, which a three-warpgroup launch (192-row
tiles, 160 registers a consumer thread) does not have to spare: its
cycle figures come from a slower copy, and only the variants' times
compare. The block-sparse forward's tool (sparse_ablation) cuts its copies
of the same pipeline with this module's helpers. Needs a CUDA device and
nvcc; imports nothing of JAX. Writes the record as JSON to --out (default
build/flash_ablation.json).
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

from alphafold2_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "flash_fwd.cu"
HEADER = cuda_build.CSRC / "flash_fwd_wgmma.cuh"  # the pipeline the variants change
INCLUDE = '#include "flash_fwd_wgmma.cuh"\n'
WORK = cuda_build.BUILD_DIR.parent / "flash_ablation"
SHAPES = {  # (BH, i, j, 2-D bias), the served bf16 calls at L = 384
    "pair axial": (3072, 384, 384, False),
    "cross pair<-msa": (8, 147456, 7680, False),
    "cross msa<-pair": (8, 7680, 147456, False),
    "B3 hop": (8, 1920, 36864, False),
    "pair axial bias2d": (3072, 384, 384, True),
}
PHASES = ("wait for the stage", "issue Q.K^T and P.V", "wait for the Q.K^T", "wait for the turn",
          "softmax", "wait for the P.V", "rescale O, pack P")

LOOP = """        mbar_wait(full(c + 1), ring(c + 1));
        qk(qa, c + 1);
        pv(c);
        wgmma_wait<1>();  // the Q.K^T (groups retire in order)
        fence_regs(s);
        turn_wait();
        softmax(c + 1, on);
        turn_pass();
        wgmma_wait<0>();  // the P.V
        fence_regs(o);
        fence_regs(p);
        rescale_pack();
"""
FIRST = """      qk(qa, c);
      wgmma_wait<0>();
      fence_regs(s);
      turn_wait();
      softmax(c, on);
      turn_pass();
"""
LAST = "      pv(c);\n      list_of(tile + gridDim.x);\n"
EX2 = ("          s[4 * j + 2 * h] = ex2(s[4 * j + 2 * h] - m[h]);\n"
       "          s[4 * j + 2 * h + 1] = ex2(s[4 * j + 2 * h + 1] - m[h]);\n")
PV = "        wgmma_m64n64k16_rs_mn(o, &p[4 * ks], gmma_desc(va + 2048 * ks, kVLbo, 1024));\n"
QK = ("        wgmma_m64n128k16_ss(s, gmma_desc(qa + 32 * ks, 16, 1024), "
      "gmma_desc(ka + 32 * ks, 16, 1024),\n                            ks);\n")
TURNS = ('    auto turn_wait = [&]() { asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + wg) : "memory"); };\n'
         '    auto turn_pass = [&]() {\n'
         '      asm volatile("bar.arrive %0, 256;\\n" ::"r"(1 + (wg + 1) % L::kConsumers) : "memory");\n'
         '    };\n')


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    """`src` with `old` replaced; raises unless `old` is there `count` times
    (the source a variant is cut from has changed)."""
    if src.count(old) != count:
        raise RuntimeError(f"the kernel source changed: {old.strip()[:60]!r} not found {count}x")
    return src.replace(old, new)


def inline(src: str, header: str) -> str:
    """`src` (a source that includes the shared pipeline) with the include
    replaced by `header`, a changed copy of the pipeline."""
    return _replace(src, INCLUDE, header)


def _counters(src: str) -> str:
    """The pipeline `src` (csrc/flash_fwd_wgmma.cuh's text) with clock64
    counters around the consumer's phases of each stage (summed by the
    first thread of each warpgroup) and the producer's (lane 0):
    g_phase[block][wg * 8 + phase], [block][wg * 8 + 7] the stages,
    [block][24, 25] the producer's waits and loads (`stage_cycles`)."""
    head = ("template <bool GATED, bool BIAS2D, int CONSUMERS, bool LISTED, "
            "class Drop = Dropout<false>>\n"
            "__device__ __forceinline__ void wgmma_fwd(")
    src = _replace(src, head, "__device__ unsigned long long g_phase[1024][32];\n\n" + head)
    src = _replace(src, "      int c = 0, n = 0;\n      for (int64_t tile",
                   "      unsigned long long P[2] = {0, 0};\n      int c = 0, n = 0;\n"
                   "      for (int64_t tile")
    src = _replace(src, "          mbar_wait(empty(c), ring(c) ^ 1);\n",
                   "          const long long p0 = clock64();\n          mbar_wait(empty(c), ring(c) ^ 1);\n"
                   "          const long long p1 = clock64();\n          P[0] += p1 - p0;\n")
    src = _replace(src, "            mbar_expect_tx(full(c), L::kStage);\n",
                   "            P[1] += clock64() - p1;\n            mbar_expect_tx(full(c), L::kStage);\n")
    src = _replace(src, "          } else {\n            mbar_arrive(full(c));\n          }\n        }\n      }\n",
                   "          } else {\n            mbar_arrive(full(c));\n          }\n        }\n      }\n"
                   "      if (lane == 0 && blockIdx.x < 1024) {\n"
                   "        g_phase[blockIdx.x][24] = P[0];\n        g_phase[blockIdx.x][25] = P[1];\n"
                   "      }\n")
    src = _replace(src, "    int c = 0, n = 0;\n    for (int64_t tile",
                   "    unsigned long long T[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n    int c = 0, n = 0;\n"
                   "    for (int64_t tile")
    timed = LOOP.split("\n")[:-1]
    marks = {0: 0, 2: 1, 4: 2, 5: 3, 7: 4, 10: 5, 11: 6}  # line index -> the phase it closes
    body = ["        long long tc = clock64(), tn;"]
    for n, line in enumerate(timed):
        body.append(line)
        if n in marks:
            body.append(f"        tn = clock64();\n        T[{marks[n]}] += tn - tc;\n        tc = tn;")
    body.append("        T[7] += 1;")
    src = _replace(src, LOOP, "\n".join(body) + "\n")
    src = _replace(src, "      release(qempty(n));\n",
                   "      release(qempty(n));\n"
                   "      if (threadIdx.x % 128 == 0 && blockIdx.x < 1024) {\n"
                   "        for (int i = 0; i < 8; ++i) g_phase[blockIdx.x][8 * wg + i] = T[i];\n"
                   "      }\n")
    return src


def with_counters(src: str) -> str:
    """`src` with the pipeline's counters (`_counters`) inlined and the entry
    points that read them back (af2_ablation_counters) and zero them
    (af2_ablation_reset)."""
    return inline(src, _counters(HEADER.read_text())) + (
        "\nextern \"C\" int af2_ablation_counters(void* host) {\n"
        "  return (int)cudaMemcpyFromSymbol(host, af2::fwd::g_phase, "
        "sizeof(af2::fwd::g_phase));\n}\n"
        "\nextern \"C\" int af2_ablation_reset() {\n"
        "  static unsigned long long zero[1024][32];\n"
        "  return (int)cudaMemcpyToSymbol(af2::fwd::g_phase, zero, sizeof(zero));\n}\n")


def stage_cycles(phase: np.ndarray) -> dict:
    """The counters (`_counters`' g_phase, 1024 x 32) as the cycles a stage
    of each warpgroup's first thread spends in each phase, and the
    producer's."""
    per = phase[phase[:, 7] > 0].astype(np.float64).sum(0)
    cycles = {f"wg{wg}": {p: per[8 * wg + n] / per[8 * wg + 7] for n, p in enumerate(PHASES)}
              for wg in range(3) if per[8 * wg + 7] > 0}
    cycles["producer"] = {"wait for an empty slot": per[24] / per[7],
                          "key bias and TMA issue": per[25] / per[7]}
    return cycles


def variants(baseline: Path = None) -> dict:
    """The copies to time, by name; `baseline` adds another version of
    flash_fwd.cu as it is."""
    src, header = SOURCE.read_text(), HEADER.read_text()
    products = _replace(header, LOOP, LOOP.replace("        qk(qa, c + 1);\n", "        turn_wait();\n"
                                                "        qk(qa, c + 1);\n").replace(
        "        pv(c);\n", "        pv(c);\n        turn_pass();\n").replace(
        "        turn_wait();\n        softmax(c + 1, on);\n        turn_pass();\n",
        "        softmax(c + 1, on);\n"))
    products = _replace(products, FIRST, "      turn_wait();\n      qk(qa, c);\n      turn_pass();\n"
                        "      wgmma_wait<0>();\n      fence_regs(s);\n      softmax(c, on);\n")
    products = _replace(products, LAST, "      turn_wait();\n      pv(c);\n      turn_pass();\n"
                        "      list_of(tile + gridDim.x);\n")
    return {
        "base": src,
        "turn_products": inline(src, products),
        "no_turns": inline(src, _replace(header, TURNS, "    auto turn_wait = [&]() {};\n"
                                         "    auto turn_pass = [&]() {};\n")),
        "no_overlap": inline(src, _replace(
            header, "        wgmma_wait<1>();  // the Q.K^T (groups retire in order)\n",
            "        wgmma_wait<0>();\n")),
        "no_ex2": inline(src, _replace(header, EX2, EX2.replace("ex2(", "("))),
        "no_pv": inline(src, _replace(header, PV, "")),
        "no_qk": inline(src, _replace(header, QK, "")),
        "counters": with_counters(src),
        **({"baseline": Path(baseline).read_text()} if baseline else {}),
    }


def build(sources: dict) -> dict:
    """One nvcc a variant, all started together; the loaded libraries."""
    libs = {}
    for name, built in cuda_build.build_variants(sources, WORK).items():
        if "C7518" in built.log:  # ptxas serialized the wgmma: the copy times another kernel
            print(f"[ablation] warning: the {name} variant's wgmma are serialized (C7518)")
        lib = ctypes.CDLL(str(built.path))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.af2_flash_fwd_wgmma.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i32,
                                            ctypes.c_float, i32, i32, p]
        lib.af2_flash_fwd_wgmma.restype = i32
        libs[name] = lib
    return libs


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=()) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another flash_fwd.cu to time beside the variants")
    ap.add_argument("--out", type=Path, default=WORK.parent / "flash_ablation.json",
                    help="the JSON record")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ablation needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[ablation] {card}")
    libs = build(variants(opts.baseline))
    counters = libs["counters"]
    counters.af2_ablation_counters.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, (BH, i, j, bias2d) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(BH, n, 64, generator=g, device="cuda").bfloat16()
                   for n in (i, j, j))
        bias = torch.randn((BH, i, j) if bias2d else (BH, j), generator=g, device="cuda")
        out, lse = torch.empty_like(q), torch.empty(BH, i, device="cuda")
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None, out.data_ptr(),
                lse.data_ptr(), BH, i, j, 64, 0.125, int(bias2d), 0, stream)
        reps = 3 if i * j > 10 ** 9 else 20
        row = {"case": label, "shape": [BH, i, j, 64], "bias2d": bias2d}
        for name, lib in libs.items():
            if name != "counters":
                row[name] = _time_ms(lambda: lib.af2_flash_fwd_wgmma(*args), reps)
        if counters.af2_ablation_reset() != 0 or counters.af2_flash_fwd_wgmma(*args) != 0:
            raise RuntimeError("the counters variant failed to launch")
        torch.cuda.synchronize()
        phase = np.zeros((1024, 32), dtype=np.uint64)
        counters.af2_ablation_counters(phase.ctypes.data)
        row["cycles_a_stage"] = stage_cycles(phase)
        rows.append(row)
        print(f"[ablation] {label:18s} " + " ".join(
            f"{name}={row[name]:.4f}" for name in libs if name != "counters") + " ms")
        for who, phases in row["cycles_a_stage"].items():
            print(f"[ablation]   {who} cycles a stage: " + ", ".join(
                f"{p} {c:.0f}" for p, c in phases.items()))
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
