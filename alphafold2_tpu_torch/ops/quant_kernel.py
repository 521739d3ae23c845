"""CUDA int8-weight matrix product (B4), its binding and its plain version.

Counterpart of alphafold2_tpu/ops/quant_kernel.py `quant_matmul_tpu`:
y = (x @ qw) * scale with x (m, k) float32 or bfloat16, qw (k, n) int8 and
scale (n,) float32 per output channel; y (m, n) in x's dtype.
`ops/quant.py quant_matmul` runs the plain version (`quant_matmul_plain`,
the counterpart of `quant_matmul_xla`: dequantize, product with f32
accumulation, one cast) on CPU tensors and `launch` (csrc/quant_matmul.cu,
built at first use) on CUDA tensors, or raises.

`launch` takes one of three kernels by the shape of the call (`route`):
"wgmma" (TMA loads, wgmma, persistent blocks) for bf16 whenever TMA can
address the tensors, "cp_async" (an mma.sync kernel fed by cp.async) for
the other bf16 shapes, "f32" on the CUDA cores. A route is chosen, never fallen back to: a
failed build or launch on any route raises. `LAUNCHES["quant_matmul"]`
counts every launch, `LAUNCHES["quant_matmul_<route>"]` each route's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from alphafold2_tpu_torch.ops import cuda_build

ROUTES = ("wgmma", "cp_async", "f32")
LAUNCHES = {"quant_matmul": 0, **{f"quant_matmul_{r}": 0 for r in ROUTES}}

_X_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def quant_matmul_plain(x, qw, scale):
    """The kernel's function in plain PyTorch, as JAX's XLA arm computes it:
    the dequantized f32 weight qw * scale, the product in f32, one cast to
    x's dtype. x (m, k); qw (k, n) int8; scale (n,) f32."""
    w = qw.float() * scale.float()[None, :]
    return (x.float() @ w).to(x.dtype)


def _aligned(t) -> bool:
    # `launch` copies a non-contiguous tensor into a fresh (aligned) one
    return not t.is_contiguous() or t.data_ptr() % 16 == 0


def route(x, qw) -> str:
    """Which kernel `launch` runs for x (m, k) and qw (k, n), arguments
    `unsupported` takes. "f32" for float32 activations. For bfloat16,
    "wgmma" where TMA can address x, qw and y: 16-byte row strides (k % 8
    == 0 for x, n % 16 == 0 for qw, which also covers y) and 16-byte aligned
    bases; "cp_async" otherwise."""
    if x.dtype == torch.float32:
        return "f32"
    k, n = qw.shape
    if k % 8 == 0 and n % 16 == 0 and _aligned(x) and _aligned(qw):
        return "wgmma"
    return "cp_async"


def unsupported(x, qw, scale):
    """What the CUDA kernels do not take in these arguments, or None."""
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
    which = route(x, qw)
    if which != "wgmma":  # a grid of (m, n) tiles; the wgmma grid is persistent
        tile_n = 128 if which == "cp_async" else 64  # csrc/quant_matmul.cu kBN, kFN
        if -(-qw.shape[1] // tile_n) > 65535:
            return (f"n = {qw.shape[1]} output channels on the {which} route "
                    f"(at most 65535 * {tile_n})")
    return None


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("quant_matmul")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.af2_quant_matmul.argtypes = [p, p, p, p, i64, i64, i64, i32, p]
    lib.af2_quant_matmul.restype = i32
    lib.af2_quant_matmul_wgmma.argtypes = [p, p, p, p, i64, i64, i64, p]
    lib.af2_quant_matmul_wgmma.restype = i32
    return lib


def launch(x, qw, scale):
    """One launch of csrc/quant_matmul.cu on the current stream, on the
    kernel `route` picks for the contiguous tensors, counted; on CUDA
    tensors the caller has checked (`unsupported` is None). Returns y (m, n)
    in x's dtype."""
    x, qw, scale = x.contiguous(), qw.contiguous(), scale.contiguous()
    m, k = x.shape
    n = qw.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    which = route(x, qw)
    args = (x.data_ptr(), qw.data_ptr(), scale.data_ptr(), y.data_ptr(), m, k, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if which == "wgmma":
        rc = _lib().af2_quant_matmul_wgmma(*args, stream)
    else:
        rc = _lib().af2_quant_matmul(*args, int(which == "cp_async"), stream)
    cuda_build.check_launch(rc, f"quant_matmul ({which} route)")
    LAUNCHES["quant_matmul"] += 1
    LAUNCHES[f"quant_matmul_{which}"] += 1
    return y
