"""Kernel or plain version: the one rule every kernel op of the port follows
(counterpart of alphafold2_tpu/ops/dispatch.py `resolve`, without its
caller overrides and environment knobs, which are not ported).

    resolve(op, device, unsupported=None) -> KERNEL | PLAIN
    resolution_tag(device) -> "dispatch[cuda](flash=wgmma,quant=wgmma,sparse=wgmma)"

  * a CPU tensor gets the plain PyTorch version (the kernels have no CPU
    mode);
  * a CUDA tensor gets the hand-written kernel, or a ValueError naming what
    the kernel does not take (`unsupported`, a description from the kernel
    module; None when it takes the call): there is no way onto the plain
    version on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

KERNEL = "kernel"
PLAIN = "plain"

# op -> the CUDA source and the TPU kernel it replaces
OPS = {
    "flash_attention": "csrc/flash_fwd.cu, csrc/flash_bwd.cu (B1, B2)",
    "quant_matmul": "csrc/quant_matmul.cu (B4)",
    "sparse_attention": "csrc/sparse_attn.cu (B5)",
    # a ring hop: (out, lse) through B1's kernels, merged in log space
    "merge_lse": "csrc/flash_fwd.cu, csrc/flash_bwd.cu (B3)",
}


def resolve(op: str, device, unsupported: Optional[str] = None) -> str:
    if op not in OPS:
        raise ValueError(f"unknown kernel op {op!r} (known: {sorted(OPS)})")
    device = torch.device(device)
    if device.type == "cpu":
        return PLAIN
    if device.type != "cuda":
        raise ValueError(f"{op} runs on cpu or cuda, not {device}")
    if unsupported is not None:
        raise ValueError(f"{op}: the CUDA kernel ({OPS[op]}) does not take {unsupported}")
    return KERNEL


def on_cpu(op: str, *tensors) -> bool:
    """True when every tensor (None skipped) lies on the CPU, False when all
    lie on one CUDA device; raises on anything else. The kernel wrappers'
    own route check: a CPU tensor takes the plain version."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{op}: tensors on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on cpu or cuda, not {device}")
    return device.type == "cpu"


# the served probe: bf16 at head width 64, a (256 -> 256) int8 product,
# block-sparse blocks of 16 (every served shape's)
_PROBE_DH, _PROBE_N, _PROBE_BLOCK = 64, 128, 16


def resolution_tag(device=None) -> str:
    """Which arm each kernel family takes on `device` (default: the card)
    at the served probe shapes: `dispatch[cpu](plain)` on the CPU, the
    route of each kernel on the card (JAX's `resolution_tag`, part of the
    fleet's artifact-store tag, so results a CPU fleet stored never serve
    a card fleet, nor one route's results another's)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return "dispatch[cpu](plain)"
    if device.type != "cuda":
        raise ValueError(f"the kernels run on cpu or cuda, not {device}")
    # the route rules read shapes, dtypes and alignment only: host probes
    from alphafold2_tpu_torch.ops import flash_kernel, quant_kernel, sparse_kernel

    q = torch.empty((1, _PROBE_N, _PROBE_DH), dtype=torch.bfloat16)
    bias = torch.empty((1, _PROBE_N), dtype=torch.float32)
    x = torch.empty((_PROBE_N, 256), dtype=torch.bfloat16)
    qw = torch.empty((256, 256), dtype=torch.int8)
    table = sparse_kernel.block_table(np.zeros((1, 1), np.int64), np.ones((1, 1), bool),
                                      _PROBE_BLOCK, "cpu")
    routes = {"flash": flash_kernel.route(q, q, q, bias),
              "quant": quant_kernel.route(x, qw),
              "sparse": sparse_kernel.route(q, table)}
    return "dispatch[cuda](" + ",".join(f"{k}={v}" for k, v in routes.items()) + ")"
