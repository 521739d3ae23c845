"""Kernel or plain version: the one rule every kernel op of the port follows
(counterpart of alphafold2_tpu/ops/dispatch.py `resolve`, without its
caller overrides and environment knobs, which are not ported).

    resolve(op, device, unsupported=None) -> KERNEL | PLAIN

  * a CPU tensor gets the plain PyTorch version (the kernels have no CPU
    mode);
  * a CUDA tensor gets the hand-written kernel, or a ValueError naming what
    the kernel does not take (`unsupported`, a description from the kernel
    module; None when it takes the call): there is no way onto the plain
    version on the card.
"""

from __future__ import annotations

from typing import Optional

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
