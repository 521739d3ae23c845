"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a host with a CUDA device; it imports
nothing of JAX or of the JAX package. Phases (any failure exits non-zero):

  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
     float32 matmuls and convolutions are set to full float32 (TF32 off);
  2. the build: every CUDA source of the port, compiled from the checkout;
  3. each kernel against its plain PyTorch version on the same inputs, at
     the main path's attention shapes (L = 384, bf16) and at ragged, fully
     masked and float32 edge shapes, with kernel, plain, library and bound
     times;
  4. the main path through `predict_structure`:
     (a) one request at L = 64 in float32 on the card and on the CPU with
         the same parameters: logits, confidence, stress and distances;
     (b) the serving configuration (dim 256, depth 2, heads 8, dim_head
         64, bf16) on three requests, L = 128, 256, 384, each with a
         seeded 20-row MSA, 200 MDS iterations, after one untimed warm-up
         request; latency, finiteness and kernel launch counts (6 per
         trunk layer);
     (c) the same with attn_gate=True at depth 1, where the fused kernel
         carries every attention;
  5. a `kernels` JSON line, the card line, and the final `ok` JSON line.

A detailed record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import alphafold2_tpu_torch  # noqa: E402
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_init, predict_structure  # noqa: E402
from alphafold2_tpu_torch.ops import cuda_build, flash_kernel  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 / f32 (no TF32)
BF16_ULP = 2.0 ** -7        # bf16 spacing relative to the value, upper bound
KERNEL_SOURCE = "alphafold2_tpu_torch/csrc/flash_fwd.cu"
REPLACES = {
    "flash_fwd": "alphafold2_tpu/ops/flash_kernel.py:197",
    "flash_fwd_fused": "alphafold2_tpu/ops/flash_kernel.py:579",
}
RECORD = {"phases": {}}


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"FAIL: {msg}")


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps):
    """Mean device time of `reps` calls (CUDA events), after one warm-up."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# --- phase 1: the card -----------------------------------------------------------


def phase_card():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA device")
    if Path(alphafold2_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail("alphafold2_tpu_torch was not imported from this checkout")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; TF32 off "
        f"(float32 matmuls and convolutions in full float32)")
    RECORD["card"] = smi
    return smi


# --- phase 2: the build ----------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    built = cuda_build.build()
    seconds = time.perf_counter() - t0
    for b in built.values():
        log(f"[build] {b.name}: {b.path.name} in {b.seconds:.1f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all sources built in {seconds:.1f} s")
    RECORD["phases"]["build_s"] = seconds


# --- phase 3: kernels against their plain versions --------------------------------


def make_inputs(BH, i, j, dh, dtype, *, masked_bh=(), key_drop=0.05, gated=False,
                bias2d=False, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(BH, i, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(BH, j, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(BH, j, dh, generator=g, device=dev).to(dtype)
    keep = torch.rand(BH, j, generator=g, device=dev) >= key_drop
    keep[:, 0] = True
    for b in masked_bh:
        keep[b] = False
    bias = torch.where(keep, 0.0, float("-inf"))
    if bias2d:
        bias = (torch.randn(BH, i, j, generator=g, device=dev) + bias[:, None, :]).contiguous()
        if i > 3:
            bias[0, 3] = float("-inf")  # one fully masked query row
    gate = torch.randn(BH, i, dh, generator=g, device=dev).to(dtype) if gated else None
    return q, k, v, bias, gate


def bound_terms(q, k, v, bias, gate):
    """The two floors of the work, in ms: operations / peak (4*BH*i*j*dh,
    QK^T and PV) and bytes moved / HBM rate (every input read once, every
    output (out, lse) written once)."""
    BH, i, dh = q.shape
    j = k.shape[1]
    flops = 4.0 * BH * i * j * dh
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, bias) + ((gate,) if gate is not None else ()))
    nbytes += q.numel() * q.element_size() + BH * i * 4
    return flops / PEAK_FLOPS[q.dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def library_ms(q, k, v, bias, gate, scale, reps):
    """One PyTorch call computing the same function: scaled_dot_product_attention
    with the bias as an additive mask (a yardstick only; the port never
    calls it). The gated kernel has no one-call equivalent: None."""
    if gate is not None:
        return None
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
    BH, i, _ = q.shape
    j = k.shape[1]
    # cast before expanding: the key-side mask stays a stride-0 view
    mask = bias.to(q.dtype)
    mask = (mask if mask.dim() == 3 else mask[:, None, :].expand(BH, i, j))[None]
    fused_only = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.FLASH_ATTENTION,
                  SDPBackend.CUDNN_ATTENTION]
    try:
        with sdpa_kernel(fused_only):
            return time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=scale), reps)
    except RuntimeError as e:  # no fused backend takes this shape: no yardstick
        log(f"[kernels]   library: none ({str(e).splitlines()[0][:100]})")
        return None


def check_kernel(name, label, BH, i, j, dh, dtype, *, timed, masked_bh=(),
                 gated=False, bias2d=False):
    q, k, v, bias, gate = make_inputs(BH, i, j, dh, dtype, masked_bh=masked_bh,
                                      gated=gated, bias2d=bias2d)
    scale = dh ** -0.5
    fn = getattr(flash_kernel, name)
    args = (q, k, v, bias, scale) + ((gate,) if name == "flash_fwd_fused" else ())
    before = flash_kernel.LAUNCHES[name]
    out, lse = fn(*args)
    sync()
    if flash_kernel.LAUNCHES[name] != before + 1:
        fail(f"{name} did not count its launch")
    ref_out, ref_lse = flash_kernel.flash_fwd_plain(q, k, v, bias, scale, gate)
    sync()
    # f32: both sides compute in f32 in another order. bf16: the kernel
    # rounds the probabilities to bf16 for P.V (~2^-9 of the output's
    # spread) and both round the output once: one bf16 ulp of the largest
    # output bounds both
    ref_max = ref_out.float().abs().max().item()
    tol = 1e-5 * max(1.0, ref_max) if dtype == torch.float32 else BF16_ULP * ref_max
    err = (out.float() - ref_out.float()).abs().max().item()
    empty_ok = torch.equal(torch.isposinf(lse), torch.isposinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item() if fin.any() else 0.0
    if masked_bh:
        zero_ok = bool((out[list(masked_bh)] == 0).all()) and bool(
            torch.isposinf(lse[list(masked_bh)]).all())
    else:
        zero_ok = True
    ok = err <= tol and lse_err <= 1e-4 and empty_ok and zero_ok and torch.isfinite(out).all()
    row = {"kernel": name, "case": label, "shape": [BH, i, j, dh], "dtype": str(dtype),
           "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err, "ok": bool(ok)}
    if timed:
        t_ops, t_bytes = bound_terms(q, k, v, bias, gate)
        est = max(1e-3, max(t_ops, t_bytes) * 50 / 1e3)  # rough seconds
        reps = max(2, min(20, int(1.0 / est)))
        row["kernel_ms"] = time_ms(lambda: fn(*args), reps)
        row["plain_ms"] = time_ms(lambda: flash_kernel.flash_fwd_plain(q, k, v, bias, scale, gate),
                                  max(1, reps // 4))
        row["library_ms"] = library_ms(q, k, v, bias, gate, scale, reps)
        row["ops_ms"], row["bytes_ms"] = t_ops, t_bytes
        row["bound_ms"] = max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    times = "".join(
        f" {key}={row[key]:.3f}" for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
        if row.get(key) is not None
    )
    log(f"[kernels] {name:15s} {label:22s} {str(tuple(row['shape'])):26s} "
        f"{str(dtype).split('.')[-1]:8s} max|d|={err:.3e} (tol {tol:.3e}) "
        f"lse|d|={lse_err:.2e}{times} {'ok' if ok else 'FAIL'}")
    del q, k, v, bias, gate, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return row


# the main path's attention shapes at L = 384, one request, heads 8,
# 20 MSA rows: (BH, i, j)
SLICE_SHAPES = {
    "pair axial": (3072, 384, 384),
    "cross pair<-msa": (8, 147456, 7680),
    "cross msa<-pair": (8, 7680, 147456),
}


def phase_kernels():
    rows = []
    for label, (BH, i, j) in SLICE_SHAPES.items():
        rows.append(check_kernel("flash_fwd", label, BH, i, j, 64, torch.bfloat16, timed=True))
        rows.append(check_kernel("flash_fwd_fused", label + " gated", BH, i, j, 64,
                                 torch.bfloat16, timed=True, gated=True))
    rows.append(check_kernel("flash_fwd_fused", "pair axial bias2d", 3072, 384, 384, 64,
                             torch.bfloat16, timed=True, bias2d=True))
    edges = [
        ("ragged", 5, 131, 77, 64, torch.bfloat16, (1,)),
        ("ragged f32", 5, 131, 77, 64, torch.float32, (1,)),
        ("tiny i, long j", 3, 7, 1000, 32, torch.float32, ()),
        ("dh16 masked", 4, 20, 20, 16, torch.bfloat16, (0, 3)),
        ("msa width pass", 3072, 20, 20, 64, torch.float32, ()),
    ]
    for label, BH, i, j, dh, dtype, masked in edges:
        rows.append(check_kernel("flash_fwd", label, BH, i, j, dh, dtype, timed=False,
                                 masked_bh=masked))
        rows.append(check_kernel("flash_fwd_fused", label + " gated", BH, i, j, dh, dtype,
                                 timed=False, masked_bh=masked, gated=True))
        rows.append(check_kernel("flash_fwd_fused", label + " bias2d", BH, i, j, dh, dtype,
                                 timed=False, masked_bh=masked, bias2d=True))
        rows.append(check_kernel("flash_fwd_fused", label + " gated bias2d", BH, i, j, dh,
                                 dtype, timed=False, masked_bh=masked, gated=True,
                                 bias2d=True))
    RECORD["kernels"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel check(s) disagree with the plain version: "
             + ", ".join(f"{r['kernel']} {r['case']}" for r in bad))
    return rows


# --- phase 4: the main path -------------------------------------------------------


def request_inputs(L, rows, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 20, (1, L)).astype(np.int32)
    msa = rng.integers(0, 21, (1, rows, L)).astype(np.int32)
    msa[0, 0] = tokens[0]
    msa_mask = rng.random((1, rows, L)) > 0.1
    msa_mask[0, 0] = True
    return tokens, msa, msa_mask


def pairwise(c):
    c = c.double()
    return torch.cdist(c, c)


def phase_cpu_vs_card():
    """(a) One request at L = 64, float32, same params on the card and the CPU.
    Tolerance: logits 1e-4 (float32 kernels vs CPU matmuls in another
    summation order); confidence 1e-5; distances 1e-2 A and stress 1e-3
    relative (200 Guttman steps carry the logits' float noise)."""
    cfg = Alphafold2Config(dim=256, depth=2, heads=8, dim_head=64, max_seq_len=64)
    params_cpu = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    tokens, msa, msa_mask = request_inputs(64, 20, seed=1)
    kw = dict(msa=msa, msa_mask=msa_mask, mds_iters=200)
    flash_kernel.reset_launches()
    gpu = predict_structure(params_gpu, cfg, tokens, device="cuda", **kw)
    sync()
    launches = dict(flash_kernel.LAUNCHES)
    cpu = predict_structure(params_cpu, cfg, tokens, device="cpu", **kw)
    g = {k: v.cpu() for k, v in gpu.items()}
    d_logits = (g["distogram_logits"] - cpu["distogram_logits"]).abs().max().item()
    d_conf = (g["confidence"] - cpu["confidence"]).abs().max().item()
    d_stress = ((g["stress"] - cpu["stress"]).abs() / cpu["stress"].abs()).max().item()
    d_dist = (pairwise(g["coords"]) - pairwise(cpu["coords"])).abs().max().item()
    ok = d_logits <= 1e-4 and d_conf <= 1e-5 and d_stress <= 1e-3 and d_dist <= 1e-2
    log(f"[main a] L=64 f32 card vs cpu: logits |d|={d_logits:.2e} (1e-4), "
        f"confidence |d|={d_conf:.2e} (1e-5), stress rel={d_stress:.2e} (1e-3), "
        f"distances |d|={d_dist:.2e} A (1e-2); launches {launches} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["cpu_vs_card"] = {
        "logits": d_logits, "confidence": d_conf, "stress_rel": d_stress,
        "distances": d_dist, "launches": launches, "ok": ok,
    }
    if not ok:
        fail("the card and the CPU disagree on the L=64 request")
    if launches["flash_fwd"] != 12:
        fail(f"expected 12 flash_fwd launches at depth 2, got {launches}")


def serve_requests(label, cfg, lengths, expect):
    """Drive predict_structure over one request per length; counts are set
    to 0 just before and read just after. One untimed request first, so the
    first timed one does not pay the libraries' first-call set-up."""
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    reqs = [request_inputs(L, 20, seed=10 + n) for n, L in enumerate(lengths)]
    tokens, msa, msa_mask = reqs[0]
    predict_structure(params, cfg, tokens, msa=msa, msa_mask=msa_mask, mds_iters=200,
                      device="cuda")
    torch.cuda.reset_peak_memory_stats()
    sync()
    flash_kernel.reset_launches()
    results = []
    for (tokens, msa, msa_mask), L in zip(reqs, lengths):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = predict_structure(params, cfg, tokens, msa=msa, msa_mask=msa_mask,
                                mds_iters=200, device="cuda")
        end.record()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        shapes_ok = (tuple(out["coords"].shape) == (1, L, 3)
                     and tuple(out["distogram_logits"].shape) == (1, L, L, 37))
        results.append({"L": L, "device_ms": start.elapsed_time(end), "wall_ms": wall,
                        "stress": float(out["stress"][0]),
                        "confidence": float(out["confidence"].mean()),
                        "finite": finite, "shapes_ok": shapes_ok})
    launches = dict(flash_kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in results:
        log(f"[main {label}] L={r['L']}: {r['device_ms']:.1f} ms (events), "
            f"{r['wall_ms']:.1f} ms (host), stress {r['stress']:.4f}, "
            f"mean confidence {r['confidence']:.4f}, finite={r['finite']}")
    log(f"[main {label}] launches {launches} (expected {expect}); peak memory {peak:.2f} GiB")
    RECORD["phases"][f"serve_{label}"] = {"requests": results, "launches": launches,
                                          "peak_gib": peak, "config": repr(cfg)}
    if not all(r["finite"] and r["shapes_ok"] for r in results):
        fail(f"main path {label}: non-finite outputs or wrong shapes")
    if launches != expect:
        fail(f"main path {label}: launches {launches} != expected {expect}")
    return launches


def phase_main():
    phase_cpu_vs_card()
    lengths = (128, 256, 384)
    cfg = Alphafold2Config(dim=256, depth=2, heads=8, dim_head=64, max_seq_len=384,
                           dtype=torch.bfloat16)
    # 6 attentions per layer reach the kernel: 2 pair axial, 2 MSA axial
    # (tied rows off), 2 cross
    served = serve_requests("b", cfg, lengths,
                            {"flash_fwd": 6 * 2 * len(lengths), "flash_fwd_fused": 0})
    gated_cfg = Alphafold2Config(dim=256, depth=1, heads=8, dim_head=64, max_seq_len=384,
                                 dtype=torch.bfloat16, attn_gate=True)
    gated = serve_requests("c", gated_cfg, lengths,
                           {"flash_fwd": 0, "flash_fwd_fused": 6 * len(lengths)})
    return {"flash_fwd": served["flash_fwd"], "flash_fwd_fused": gated["flash_fwd_fused"]}


# --- phase 5: the kernels line -----------------------------------------------------


def kernels_line(rows, launches):
    """One entry per kernel, its numbers summed over the main path's three
    attention shapes at L = 384 in bf16 (one launch of each; B2f gated)."""
    out = []
    for name in ("flash_fwd", "flash_fwd_fused"):
        timed = [r for r in rows if r["kernel"] == name and "kernel_ms" in r
                 and "bias2d" not in r["case"]]
        checked = [r for r in rows if r["kernel"] == name]
        lib = [r["library_ms"] for r in timed]
        out.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": sum(r["kernel_ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            # which floor dominates the summed bound
            "bound_by": "operations" if sum(r["ops_ms"] for r in timed)
            >= sum(r["bytes_ms"] for r in timed) else "bytes",
            "library_ms": None if any(x is None for x in lib) else sum(lib),
        })
    return out


def main():
    t0 = time.perf_counter()
    smi = phase_card()
    phase_build()
    t = time.perf_counter()
    rows = phase_kernels()
    RECORD["phases"]["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    launches = phase_main()
    RECORD["phases"]["main_s"] = time.perf_counter() - t
    kernels = kernels_line(rows, launches)
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on the main path")
    RECORD["kernels_line"] = kernels
    RECORD["seconds"] = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    log(f"[done] {RECORD['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
