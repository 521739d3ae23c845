"""Where the time of B4's wgmma route goes, on the card.

    python -m alphafold2_tpu_torch.telemetry.quant_ablation

Builds csrc/quant_matmul.cu and copies of it with one part taken out (the
results of a copy are wrong; only its time is read), times each at the
served int8 request's pair shapes (L = 384) beside torch.matmul on the
dequantized bf16 weight, and prints, from a copy with cycle counters, the
cycles a tile of one consumer thread in each block spends in each phase:

  base        the kernel as built for the port
  no_convert  the weight fragments are not converted from int8 (raw bits)
  no_epilogue the tile's results are never written
  no_store    the epilogue stages each box but issues no TMA store

Needs a CUDA device and nvcc; imports nothing of JAX. Writes
chiprun_out/quant_ablation.json.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from alphafold2_tpu_torch.ops import cuda_build, quant

ROOT = Path(__file__).resolve().parents[2]
SOURCE = cuda_build.CSRC / "quant_matmul.cu"
WORK = cuda_build.BUILD_DIR.parent / "ablation"
SHAPES = {  # (m, k, n), the pair dense layers of the int8 request at L = 384
    "pair q": (147456, 256, 512),
    "pair kv": (147456, 256, 1024),
    "pair out": (147456, 512, 256),
    "pair ff in": (147456, 256, 2048),
    "pair ff out": (147456, 1024, 256),
}
CONVERT = """          const uint2 lo = bf16_pairs_of_int8x4(r[2 * h]);
          const uint2 hi = bf16_pairs_of_int8x4(r[2 * h + 1]);"""
EPILOGUE = "if (n0 + 64 * wg < n) {"
STORE = "if (tid == 0) tma_store_2d(&tm_y, yb, n0 + 64 * wg, m0 + bx * kYBox);"
PHASES = ("wait for the chunk", "wgmma issue", "conversion", "wait for the previous chunk",
          "wait for the last chunk", "epilogue")


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"csrc/quant_matmul.cu changed: {old.strip()[:60]!r} not found {count}x")
    return src.replace(old, new)


def _counters(src: str) -> str:
    """The source with clock64 counters around the consumer's phases,
    summed by one thread of warpgroup 0 in each block and read back by
    af2_ablation_counters."""
    src = _replace(src, "__global__ void __launch_bounds__(kWThreads, 1)\n",
                   "__device__ unsigned long long g_phase[1024][8];\n\n"
                   "__global__ void __launch_bounds__(kWThreads, 1)\n")
    src = _replace(src, "    float acc[128];\n",
                   "    unsigned long long T[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n    float acc[128];\n")
    src = _replace(src, "      mbar_wait(full(c), ring(c));\n      const uint32_t q = ",
                   "      const long long t_w = clock64();\n      mbar_wait(full(c), ring(c));\n"
                   "      const long long t_c = clock64();\n      T[0] += t_c - t_w;\n"
                   "      const uint32_t q = ")
    src = _replace(src, "          a[2 * pair + h][3] = hi.y;\n        }\n      }\n    };\n",
                   "          a[2 * pair + h][3] = hi.y;\n        }\n      }\n"
                   "      T[2] += clock64() - t_c;\n    };\n")
    src = _replace(src, "      const uint32_t xa = base + (c % kStages) * kXBytes;\n      wgmma_fence();\n",
                   "      const long long t_i = clock64();\n"
                   "      const uint32_t xa = base + (c % kStages) * kXBytes;\n      wgmma_fence();\n")
    src = _replace(src, "      wgmma_commit();\n    };\n",
                   "      wgmma_commit();\n      T[1] += clock64() - t_i;\n    };\n")
    src = _replace(src, "            wgmma_wait<1>();\n",
                   "            const long long t_p = clock64();\n            wgmma_wait<1>();\n"
                   "            T[3] += clock64() - t_p;\n", count=2)
    src = _replace(src, "      wgmma_wait<0>();\n      fence_acc(acc);\n",
                   "      const long long t_l = clock64();\n      wgmma_wait<0>();\n      fence_acc(acc);\n"
                   "      const long long t_e = clock64();\n      T[4] += t_e - t_l;\n")
    src = _replace(src, "            ++stores;\n          }\n        }\n      }\n    }\n",
                   "            ++stores;\n          }\n        }\n      }\n"
                   "      T[5] += clock64() - t_e;\n      T[6] += 1;\n    }\n"
                   "    if (tid == 0 && wg == 0 && blockIdx.x < 1024) {\n"
                   "      for (int i = 0; i < 7; ++i) g_phase[blockIdx.x][i] = T[i];\n    }\n")
    return src + ("\nextern \"C\" int af2_ablation_counters(void* host) {\n"
                  "  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n")


def variants() -> dict:
    src = SOURCE.read_text()
    return {
        "base": src,
        "no_convert": _replace(src, CONVERT,
                               "          const uint2 lo = make_uint2(r[2 * h], r[2 * h]);\n"
                               "          const uint2 hi = make_uint2(r[2 * h + 1], r[2 * h + 1]);"),
        "no_epilogue": _replace(src, EPILOGUE, "if (n < 0) {"),
        "no_store": _replace(src, STORE, ""),
        "counters": _counters(src),
    }


def build(sources: dict) -> dict:
    """One nvcc a variant, all started together; the loaded libraries."""
    libs = {}
    for name, built in cuda_build.build_variants(sources, WORK).items():
        if "C7518" in built.log:  # ptxas serialized the wgmma: the copy times another kernel
            print(f"[ablation] warning: the {name} variant's wgmma are serialized (C7518)")
        lib = ctypes.CDLL(str(built.path))
        lib.af2_quant_matmul_wgmma.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        lib.af2_quant_matmul_wgmma.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("quant_ablation needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[ablation] {card}")
    libs = build(variants())
    counters = libs["counters"]
    counters.af2_ablation_counters.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, (m, k, n) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        qw, scale = quant.quantize_weight(torch.randn(k, n, generator=g, device="cuda"))
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        y = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        w = quant.dequantize_weight(qw, scale).bfloat16()
        args = (x.data_ptr(), qw.data_ptr(), scale.data_ptr(), y.data_ptr(), m, k, n, stream)
        row = {"case": label, "shape": [m, k, n],
               "torch.matmul": _time_ms(lambda: torch.matmul(x, w))}
        for name, lib in libs.items():
            if name != "counters":
                row[name] = _time_ms(lambda: lib.af2_quant_matmul_wgmma(*args))
        counters.af2_quant_matmul_wgmma(*args)
        torch.cuda.synchronize()
        phase = np.zeros((1024, 8), dtype=np.uint64)
        counters.af2_ablation_counters(phase.ctypes.data)
        tiles = phase[:, 6].sum()
        row["cycles_a_tile"] = {p: float(phase[:, i].sum() / tiles) for i, p in enumerate(PHASES)}
        rows.append(row)
        print(f"[ablation] {label:12s} " + " ".join(
            f"{key}={row[key]:.4f}" for key in ("torch.matmul", "base", "no_convert",
                                                "no_epilogue", "no_store")) + " ms")
        print("[ablation]   cycles a tile: " + ", ".join(
            f"{p} {c:.0f}" for p, c in row["cycles_a_tile"].items()))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "quant_ablation.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    sys.exit(main())
