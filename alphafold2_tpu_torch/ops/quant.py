"""Post-training int8 weight quantization for the inference arm
(counterpart of alphafold2_tpu/ops/quant.py).

  * `quantize_weight` maps a float32 (..., d_in, d_out) dense weight to
    (int8 values, f32 scale per output channel): scale = max|w[:, c]| /
    127, q = round(w / scale), half to even; an all-zero channel gets
    scale 0 and values 0; leading axes are a stack, each slice quantized
    on its own. Bit-equal to the JAX package's.
  * `quantize_tree` / `dequantize_tree` rewrite the selected linear dicts
    {"w", ...} <-> {"qw", "scale", ...} by named path (default: the
    trunk's dense weights, `default_quant_select`); the f32 tree is never
    mutated.
  * `quant_matmul` is y = x @ dequant(qw, scale) without a dequantized
    weight in device memory on the card: the CUDA kernel B4
    (ops/quant_kernel.py) on CUDA tensors, the plain version on CPU
    tensors (ops/dispatch.py). Its backward raises: int8 weights are
    inference-only, and the training entry points refuse int8 configs
    first (`reject_quant_training`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.ops import dispatch, quant_kernel
from alphafold2_tpu_torch.ops.quant_kernel import quant_matmul_plain

__all__ = [
    "quantize_weight",
    "dequantize_weight",
    "quantize_tree",
    "dequantize_tree",
    "default_quant_select",
    "is_quantized_linear",
    "iter_linear_dicts",
    "quant_matmul",
    "quant_matmul_plain",
    "tree_weight_bytes",
    "quantized_path_bytes",
    "reject_quant_training",
]

_QMAX = 127.0  # symmetric int8 range; -128 is never produced


# --- per-channel symmetric PTQ ------------------------------------------------


def quantize_weight(w, *, per_channel: bool = True):
    """f32 (..., d_in, d_out) -> (int8 of the same shape, f32 scale (...,
    d_out), or (...,) when per_channel=False)."""
    wf = torch.as_tensor(w).float()
    if wf.dim() < 2:
        raise ValueError(
            f"quantize_weight expects a (stacked) 2-D dense weight, got {tuple(wf.shape)}"
        )
    amax = wf.abs().amax(dim=-2) if per_channel else wf.abs().amax(dim=(-2, -1))
    scale = amax / _QMAX
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    safe = safe[..., None, :] if per_channel else safe[..., None, None]
    q = torch.clamp(torch.round(wf / safe), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def dequantize_weight(qw, scale):
    """(int8, scale) -> f32 weight; per-channel (qw.dim() - 1 dims) or
    per-tensor (qw.dim() - 2 dims) scales, stacked or plain."""
    s = torch.as_tensor(scale).float()
    if s.dim() == qw.dim() - 1:
        s = s[..., None, :]
    elif s.dim() == qw.dim() - 2:
        s = s[..., None, None]
    else:
        raise ValueError(
            f"scale shape {tuple(s.shape)} does not match weight shape {tuple(qw.shape)}"
        )
    return qw.float() * s


def is_quantized_linear(d) -> bool:
    """True for a linear-param dict rewritten by `quantize_tree`."""
    return isinstance(d, dict) and "qw" in d and "scale" in d


def default_quant_select(path: str, w) -> bool:
    """Every 2-D (or stacked 3-D) weight on a path through the trunk, but
    the KV-compression conv (by name): embeddings, LayerNorm, the front-end
    projections and the distogram head stay f32."""
    parts = path.split("/")
    return "trunk" in parts and "compress" not in parts and getattr(w, "ndim", 0) in (2, 3)


def _walk(tree, path, fn):
    """Rebuild a dict/list/tuple tree, giving `fn(path, subtree)` the first
    say at every dict node (None: recurse)."""
    if isinstance(tree, dict):
        replaced = fn(path, tree)
        if replaced is not None:
            return replaced
        return {k: _walk(v, f"{path}/{k}" if path else str(k), fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_walk(v, f"{path}/{i}" if path else str(i), fn) for i, v in enumerate(tree)]
        return type(tree)(seq) if isinstance(tree, tuple) else seq
    return tree


def quantize_tree(params, select: Optional[Callable[[str, object], bool]] = None, *,
                  per_channel: bool = True):
    """A new tree with every selected {"w": (d_in, d_out), ...} rewritten to
    {"qw": int8, "scale": f32, ...} on the weight's device."""
    select = default_quant_select if select is None else select

    def visit(path, d):
        w = d.get("w")
        if w is None or getattr(w, "ndim", 0) < 2 or not select(path, w):
            return None
        qw, scale = quantize_weight(w.detach(), per_channel=per_channel)
        out = {k: v for k, v in d.items() if k != "w"}
        out["qw"], out["scale"] = qw, scale
        return out

    return _walk(params, "", visit)


def dequantize_tree(params):
    """Every {"qw", "scale", ...} dict back to {"w": f32, ...}."""

    def visit(path, d):
        if not is_quantized_linear(d):
            return None
        out = {k: v for k, v in d.items() if k not in ("qw", "scale")}
        out["w"] = dequantize_weight(d["qw"], d["scale"])
        return out

    return _walk(params, "", visit)


# --- residency accounting -------------------------------------------------------


def tree_weight_bytes(params) -> int:
    """Resident bytes of every tensor in a parameter tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def iter_linear_dicts(params, path: str = ""):
    """Yield (path, dict) for every dict node holding a "w" or "qw" leaf."""
    if isinstance(params, dict):
        if "w" in params or "qw" in params:
            yield path, params
            return
        for k, v in params.items():
            yield from iter_linear_dicts(v, f"{path}/{k}" if path else str(k))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from iter_linear_dicts(v, f"{path}/{i}" if path else str(i))


def quantized_path_bytes(params) -> Tuple[int, int]:
    """(f32 bytes of the quantizable weights, their bytes after PTQ) over
    the default selection, for an f32 or an already quantized tree."""
    before = after = 0
    for path, d in iter_linear_dicts(params):
        w = d.get("w")
        if w is not None and w.dim() >= 2 and default_quant_select(path, w):
            n = w.numel()
            stack = n // (w.shape[-2] * w.shape[-1])
            before += n * w.element_size()
            after += n + stack * w.shape[-1] * 4  # int8 values + f32 scales
        elif is_quantized_linear(d):
            before += d["qw"].numel() * 4
            after += tree_weight_bytes({"qw": d["qw"], "scale": d["scale"]})
    return before, after


# --- the mixed-precision product ---------------------------------------------------


_INFERENCE_ONLY = (
    "int8 weight-quantized matmuls are inference-only: differentiating "
    "through quant_matmul would silently train on straight-through "
    "rounding noise. Train on the fp32 master weights "
    "(Alphafold2Config.weight_dtype='f32') and re-quantize post-training."
)


class _QuantMatmul(torch.autograd.Function):
    """The product on either route; its backward raises (JAX
    `_quant_core_bwd`)."""

    @staticmethod
    def forward(ctx, x, qw, scale, kernel):
        if kernel:
            return quant_kernel.launch(x, qw, scale)
        return quant_matmul_plain(x, qw, scale)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(_INFERENCE_ONLY)


def quant_matmul(x, qw, scale, *, dtype=None):
    """y = x @ dequant(qw, scale). x: (..., d_in) f32/bf16 activations
    (leading dims flattened); qw: one (d_in, d_out) int8 weight; scale:
    (d_out,) f32 per output channel, or a per-tensor scalar (broadcast).
    `dtype` casts the activations first (the `linear` compute-dtype
    contract); the output is in the activations' dtype. CUDA tensors take
    the kernel (or an error naming what it does not take), CPU tensors the
    plain version."""
    if dtype is not None:
        x = x.to(dtype)
    if qw.dim() != 2:
        raise ValueError(
            f"quant_matmul takes one (d_in, d_out) weight slice, got {tuple(qw.shape)}"
        )
    d_in, d_out = qw.shape
    if x.shape[-1] != d_in:
        raise ValueError(f"activation feature dim {x.shape[-1]} != weight d_in {d_in}")
    scale = torch.as_tensor(scale, device=qw.device).float().reshape(-1).expand(d_out)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d_in)
    devices = {t.device for t in (x2, qw, scale)}
    if len(devices) != 1:
        raise ValueError(f"quant_matmul tensors on several devices: {sorted(map(str, devices))}")
    route = dispatch.resolve("quant_matmul", x2.device, quant_kernel.unsupported(x2, qw, scale))
    y = _QuantMatmul.apply(x2, qw, scale, route == dispatch.KERNEL)
    return y.reshape(*lead, d_out)


def reject_quant_training(model_cfg, where: str) -> None:
    """Refuse to build a training path over an int8-weight config (or a
    wrapper carrying one as `.model`)."""
    model_cfg = getattr(model_cfg, "model", model_cfg)
    if getattr(model_cfg, "weight_dtype", "f32") == "int8":
        raise ValueError(
            f"{where}: weight_dtype='int8' is the inference-only serving "
            f"arm (per-channel PTQ over frozen weights, non-differentiable "
            f"by construction); train with weight_dtype='f32' and quantize "
            f"post-training (ops/quant.py quantize_tree)"
        )
