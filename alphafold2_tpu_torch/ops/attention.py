"""Dense, tied-row, KV-compressed and axial attention.

Counterpart of alphafold2_tpu/ops/attention.py:

  * `attention_apply` — multi-head self/cross attention with KV
    compression (a grouped strided conv over keys/values plus a sum-pooled
    mask), tied-row attention (logits shared over MSA rows with an extra
    r^-0.5 scale), the sigmoid output gate and folded-batch chunking;
  * `axial_attention_apply` — one pass along each axis of a (b, h, w, d)
    grid with the other folded into batch, results summed.

Which path computes the softmax: tied rows use the dense einsum; every
other attention takes the flash path (ops/flash.py) when `cfg.flash` is
True, or when it is "auto" and either the tensors lie on a CUDA device and
the kernels take the shape (so every such attention reaches the
hand-written kernels; the H100 has no measured dense/flash crossover yet)
or, on the CPU, the logits would exceed `_FLASH_AUTO_THRESHOLD` elements
(the JAX rule, so the CPU tests follow the JAX package branch for branch).
False forces the dense einsum, and so does live attention dropout (a
generator and a nonzero rate), which only the dense path applies, as in the
JAX package. The dense path promotes the logits to f32 before the mask
fill, so a bf16 run masks with the f32 minimum as JAX does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from alphafold2_tpu_torch.ops import flash_kernel
from alphafold2_tpu_torch.ops.core import dropout, linear, linear_init, uniform
from alphafold2_tpu_torch.ops.flash import apply_output_gate, flash_attention

# the JAX package's dense/flash switch: 2^27 logit elements (512 MB f32)
_FLASH_AUTO_THRESHOLD = 1 << 27
_NEG = float("-inf")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Static attention hyper-parameters (the JAX AttentionConfig's fields
    but `flash_qb_target`, the TPU kernel's block target)."""

    dim: int
    heads: int = 8
    dim_head: int = 64
    dropout: float = 0.0
    compress_ratio: int = 1  # KV compression for cross-attention, 1 = off
    dtype: torch.dtype = torch.float32  # compute dtype
    flash: Union[bool, str] = "auto"
    flash_tile_elems: int = 1 << 25
    flash_kv_block: int = 2048
    flash_compute_dtype_logits: bool = False
    batch_chunk: int = 0
    gate: bool = False

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head


# --- init -------------------------------------------------------------------


def attention_init(gen, cfg: AttentionConfig, device):
    inner = cfg.inner_dim
    params = {
        "to_q": linear_init(gen, cfg.dim, inner, device, bias=False),
        "to_kv": linear_init(gen, cfg.dim, 2 * inner, device, bias=False),
        "to_out": linear_init(gen, inner, cfg.dim, device),
    }
    if cfg.gate:
        # near-open gate (w=0, b=1), as in the JAX package
        params["to_gate"] = {
            "w": torch.zeros((cfg.dim, inner), device=device),
            "b": torch.ones(inner, device=device),
        }
    if cfg.compress_ratio > 1:
        # torch Conv1d(inner, inner, ratio, stride=ratio, groups=heads)
        # weight layout (out, in/groups, k); the JAX layout is (k, in/groups,
        # out) (models/convert.py maps it)
        in_per_group = inner // cfg.heads
        bound = 1.0 / math.sqrt(in_per_group * cfg.compress_ratio)
        params["compress"] = {
            "w": uniform(gen, (inner, in_per_group, cfg.compress_ratio), bound, device),
            "b": uniform(gen, (inner,), bound, device),
        }
    return params


def axial_attention_init(gen, cfg: AttentionConfig, device):
    return {
        "attn_width": attention_init(gen, cfg, device),
        "attn_height": attention_init(gen, cfg, device),
    }


# --- apply ------------------------------------------------------------------


def _compress_conv(params, cfg: AttentionConfig, t):
    """Grouped strided conv over the sequence axis of t (b, n, inner)."""
    w = params["compress"]["w"].to(t.dtype)
    b = params["compress"]["b"].to(t.dtype)
    out = F.conv1d(t.transpose(1, 2), w, b, stride=cfg.compress_ratio,
                   groups=cfg.heads)
    return out.transpose(1, 2)


def _compress_kv(params, cfg: AttentionConfig, k, v, context_mask):
    """Downsample keys/values along the sequence: pad j to a multiple of
    the ratio, conv, and sum-pool the key mask (a compressed position is
    valid if any source position was)."""
    ratio = cfg.compress_ratio
    pad = (-k.shape[-2]) % ratio
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        if context_mask is not None:
            context_mask = F.pad(context_mask, (0, pad))
    k = _compress_conv(params, cfg, k)
    v = _compress_conv(params, cfg, v)
    if context_mask is not None:
        context_mask = context_mask.reshape(context_mask.shape[0], -1, ratio).any(-1)
    return k, v, context_mask


def _use_flash(cfg: AttentionConfig, b: int, i: int, j: int, device) -> bool:
    """The flash-path rule of the module docstring."""
    if cfg.flash != "auto":
        return cfg.flash is True
    if device.type == "cuda":
        return flash_kernel.supported(i, j, cfg.dim_head)
    return b * cfg.heads * i * j > _FLASH_AUTO_THRESHOLD


def attention_apply(params, cfg: AttentionConfig, x, *, context=None,
                    mask=None, context_mask=None,
                    tie_dim: Optional[int] = None, rng=None):
    """Multi-head attention.

    x: queries (b, i, dim); context: keys/values source (b, j, dim), self-
    attention when None; mask: (b, i) bool query validity; context_mask:
    (b, j) bool key validity (defaults to `mask` for self-attention,
    all-valid for cross-attention); tie_dim: x is (b*tie_dim, i, dim) and
    the logits are shared across the tie_dim rows; rng: a generator on x's
    device for attention dropout (None: eval mode). Returns (b, i, dim) in
    cfg.dtype."""
    has_context = context is not None
    dropout_live = rng is not None and cfg.dropout > 0.0
    if (cfg.batch_chunk and x.shape[0] > cfg.batch_chunk and tie_dim is None
            and not dropout_live):
        return _batch_chunked_attention(
            params, cfg, x, context=context, mask=mask, context_mask=context_mask
        )
    ctx = context if has_context else x
    dtype = cfg.dtype

    q = linear(params["to_q"], x, dtype=dtype)
    k, v = linear(params["to_kv"], ctx, dtype=dtype).chunk(2, dim=-1)
    if cfg.compress_ratio > 1 and has_context:
        k, v, context_mask = _compress_kv(params, cfg, k, v, context_mask)

    h, dh = cfg.heads, cfg.dim_head
    q, k, v = (t.reshape(t.shape[0], t.shape[1], h, dh) for t in (q, k, v))
    gate_logits = linear(params["to_gate"], x, dtype=dtype) if cfg.gate else None
    out = attend(cfg, q, k, v, mask=mask, context_mask=context_mask,
                 self_attention=not has_context, tie_dim=tie_dim, gate_logits=gate_logits,
                 rng=rng)
    return linear(params["to_out"], out, dtype=dtype)


def attend(cfg: AttentionConfig, q, k, v, *, mask=None, context_mask=None,
           self_attention: bool = True, tie_dim: Optional[int] = None, gate_logits=None,
           rng=None):
    """The attention core over heads q (b, i, h, dh), k / v (b, j, h, dh):
    the flash path or the dense einsum by the module docstring's rule, the
    optional output gate (gate_logits (b, i, h * dh)). mask / context_mask /
    tie_dim / rng as `attention_apply`'s; self_attention: a missing
    context_mask defaults to `mask`. Returns (b, i, h * dh) in cfg.dtype,
    before the output projection."""
    dtype = cfg.dtype
    h, dh = cfg.heads, cfg.dim_head
    scale = dh ** -0.5
    i, j = q.shape[1], k.shape[1]
    dropout_live = rng is not None and cfg.dropout > 0.0

    if (tie_dim is None and not dropout_live
            and _use_flash(cfg, q.shape[0], i, j, q.device)):
        # key-side masking only: masked query rows give finite values that
        # downstream masking discards (the dense path gives them uniform
        # attention instead)
        if context_mask is None and mask is not None and self_attention:
            context_mask = mask
        key_bias = None
        if context_mask is not None:
            key_bias = torch.where(
                context_mask.expand(k.shape[0], j), 0.0, _NEG
            ).float()
        out = flash_attention(
            q, k, v, key_bias, scale=scale,
            gate=None if gate_logits is None
            else gate_logits.reshape(gate_logits.shape[0], i, h, dh),
            tile_elems=cfg.flash_tile_elems, kv_block=cfg.flash_kv_block,
            logit_dtype=dtype if cfg.flash_compute_dtype_logits else None,
        )
        return out.reshape(out.shape[0], i, h * dh)

    if tie_dim is not None:
        # (b*r, n, h, dh) -> (b, r, n, h, dh); logits shared across rows r
        # with the extra r^-0.5 scale
        r = tie_dim
        q, k, v = (t.reshape(-1, r, t.shape[1], h, dh) for t in (q, k, v))
        logits = torch.einsum("brihd,brjhd->bhij", q, k) * (scale * r ** -0.5)
        # a position is valid only if valid in every row
        if mask is not None:
            mask = mask.reshape(-1, r, mask.shape[-1]).all(dim=1)
        if context_mask is not None and context_mask.shape[0] == r * logits.shape[0]:
            context_mask = context_mask.reshape(-1, r, context_mask.shape[-1]).all(dim=1)
    else:
        logits = torch.einsum("bihd,bjhd->bhij", q, k) * scale

    if mask is not None or context_mask is not None:
        if mask is None:
            mask = torch.ones((1, i), dtype=torch.bool, device=q.device)
        if context_mask is None:
            context_mask = (
                mask if self_attention
                else torch.ones((1, j), dtype=torch.bool, device=q.device)
            )
        pair_mask = mask[:, None, :, None] & context_mask[:, None, None, :]
        # f32 first: the f32 minimum does not fit in bf16 (JAX promotes too)
        logits = logits.float().masked_fill(~pair_mask, torch.finfo(torch.float32).min)

    attn = torch.softmax(logits.float(), dim=-1).to(dtype)
    attn = dropout(attn, cfg.dropout, rng)

    if tie_dim is not None:
        out = torch.einsum("bhij,brjhd->brihd", attn, v).reshape(-1, i, h * dh)
    else:
        out = torch.einsum("bhij,bjhd->bihd", attn, v)
        out = out.reshape(out.shape[0], i, h * dh)
    if gate_logits is not None:
        out = apply_output_gate(out, gate_logits)
    return out


def _batch_chunked_attention(params, cfg: AttentionConfig, x, *, context,
                             mask, context_mask):
    """Run attention_apply over the (folded) batch axis in chunks of
    cfg.batch_chunk rows, so no projection exists over the whole batch.
    The last chunk is zero-padded to full size as in the JAX package
    (a chunk's size feeds the CPU dense/flash choice)."""
    B = x.shape[0]
    chunk = cfg.batch_chunk
    inner_cfg = dataclasses.replace(cfg, batch_chunk=0)
    pad = (-B) % chunk

    def piece(t, s):
        if t is None or (t.shape[0] == 1 and B > 1):
            return t  # absent or broadcast across chunks
        t = t[s:s + chunk]
        if t.shape[0] < chunk:
            t = torch.cat([t, t.new_zeros((chunk - t.shape[0],) + t.shape[1:])])
        return t

    outs = [
        attention_apply(
            params, inner_cfg, piece(x, s), context=piece(context, s),
            mask=piece(mask, s), context_mask=piece(context_mask, s),
        )
        for s in range(0, B + pad, chunk)
    ]
    return torch.cat(outs)[:B]


def axial_attention_apply(params, cfg: AttentionConfig, x, *, mask=None,
                          context=None, context_mask=None,
                          tie_row: bool = False, rng=None, attention_fn=None):
    """Factorised 2D attention over a (b, h, w, d) grid: a column pass
    (attend along h, w folded into batch) plus a row pass (attend along w,
    h folded into batch, tied across h when tie_row). context /
    context_mask: optional cross-attention source (b, n, d) / (b, n),
    broadcast to every folded row/column. attention_fn: an override of the
    inner attention (the block-sparse one, models/trunk.py), called as
    `attention_fn(axis_params, x, *, axis, mask, tie_dim, rng, [context,
    context_mask])` with axis "width" (column pass) or "height" (row pass)."""
    b, hh, ww, d = x.shape

    def run(p, t, m, tie_dim, axis, **ctx):
        if attention_fn is not None:
            return attention_fn(p, t, axis=axis, mask=m, tie_dim=tie_dim, rng=rng, **ctx)
        return attention_apply(p, cfg, t, mask=m, tie_dim=tie_dim, rng=rng, **ctx)

    def ctx_kwargs(rep):
        if context is None:
            return {}
        return {
            "context": context.repeat_interleave(rep, dim=0),
            "context_mask": None if context_mask is None
            else context_mask.repeat_interleave(rep, dim=0),
        }

    col_x = x.transpose(1, 2).reshape(b * ww, hh, d)
    col_mask = None if mask is None else mask.transpose(1, 2).reshape(b * ww, hh)
    col_out = run(params["attn_width"], col_x, col_mask, None, "width", **ctx_kwargs(ww))
    col_out = col_out.reshape(b, ww, hh, d).transpose(1, 2)

    row_x = x.reshape(b * hh, ww, d)
    row_mask = None if mask is None else mask.reshape(b * hh, ww)
    row_out = run(params["attn_height"], row_x, row_mask, hh if tie_row else None,
                  "height", **ctx_kwargs(hh))
    return col_out + row_out.reshape(b, hh, ww, d)
