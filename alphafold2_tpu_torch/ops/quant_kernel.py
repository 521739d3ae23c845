"""CUDA int8-weight matrix product (B4), its binding and its plain version.

Counterpart of alphafold2_tpu/ops/quant_kernel.py `quant_matmul_tpu`:
y = (x @ qw) * scale with x (m, k) float32 or bfloat16, qw (k, n) int8 and
scale (n,) float32 per output channel; y (m, n) in x's dtype.
`ops/quant.py quant_matmul` runs the plain version (`quant_matmul_plain`,
the counterpart of `quant_matmul_xla`: dequantize, product with f32
accumulation, one cast) on CPU tensors and `launch` (csrc/quant_matmul.cu,
built at first use) on CUDA tensors, or raises. `LAUNCHES` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from alphafold2_tpu_torch.ops import cuda_build

LAUNCHES = {"quant_matmul": 0}

_X_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    LAUNCHES["quant_matmul"] = 0


def quant_matmul_plain(x, qw, scale):
    """The kernel's function in plain PyTorch, as JAX's XLA arm computes it:
    the dequantized f32 weight qw * scale, the product in f32, one cast to
    x's dtype. x (m, k); qw (k, n) int8; scale (n,) f32."""
    w = qw.float() * scale.float()[None, :]
    return (x.float() @ w).to(x.dtype)


def unsupported(x, qw, scale):
    """What the CUDA kernel does not take in these arguments, or None."""
    if x.dtype not in _X_DTYPES:
        return f"activations of dtype {x.dtype} (float32 or bfloat16)"
    if qw.dtype != torch.int8:
        return f"a weight of dtype {qw.dtype} (int8)"
    if scale.dtype != torch.float32:
        return f"a scale of dtype {scale.dtype} (float32)"
    if x.dim() != 2 or qw.dim() != 2 or scale.shape != (qw.shape[1],):
        return (f"shapes x {tuple(x.shape)}, qw {tuple(qw.shape)}, scale "
                f"{tuple(scale.shape)} (x (m, k), qw (k, n), scale (n,))")
    if x.shape[1] != qw.shape[0]:
        return f"x {tuple(x.shape)} against qw {tuple(qw.shape)}"
    if 0 in x.shape or qw.shape[1] == 0:
        return f"an empty product {tuple(x.shape)} @ {tuple(qw.shape)}"
    tile_n = 128 if x.dtype == torch.bfloat16 else 64  # csrc/quant_matmul.cu kBN, kFN
    if -(-qw.shape[1] // tile_n) > 65535:
        return f"n = {qw.shape[1]} output channels (at most 65535 * {tile_n})"
    return None


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("quant_matmul")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.af2_quant_matmul.argtypes = [p, p, p, p, i64, i64, i64, i32, p]
    lib.af2_quant_matmul.restype = i32
    return lib


def launch(x, qw, scale):
    """One launch of csrc/quant_matmul.cu on the current stream, counted,
    on CUDA tensors the caller has checked (`unsupported` is None). Returns
    y (m, n) in x's dtype."""
    x, qw, scale = x.contiguous(), qw.contiguous(), scale.contiguous()
    m, k = x.shape
    n = qw.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _lib().af2_quant_matmul(
        x.data_ptr(), qw.data_ptr(), scale.data_ptr(), y.data_ptr(), m, k, n,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check_launch(rc, "quant_matmul")
    LAUNCHES["quant_matmul"] += 1
    return y
