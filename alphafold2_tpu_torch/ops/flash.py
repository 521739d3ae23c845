"""Blockwise (flash-style) exact attention: plain versions and the dispatch
to the CUDA kernels.

Counterpart of alphafold2_tpu/ops/flash.py. The plain versions
(`blockwise_attention`, `streamed_fused_attention`, `apply_output_gate`)
compute softmax(QK^T * scale + bias)V tile by tile with the
FlashAttention recurrence, so no full (i, j) logit matrix exists; they are
what `flash_attention` runs on CPU tensors, and autograd differentiates
them there (JAX's `xla_ref` arm). On CUDA tensors `flash_attention`
launches the hand-written kernels of ops/flash_kernel.py through two
`torch.autograd.Function`s, whose backwards launch the backward kernels
(a gate or a 2-D pair bias selects the fused pair), or raises: there is
no fallback to the plain versions on the card (ops/dispatch.py).

Ring attention's hop interface (parallel/sequence.py) lives here too:
`hop_attention_lse` gives one hop's normalised output and log-sum-exp
(kernel B3 through `_FlashLseKernel` on CUDA tensors, the plain version on
CPU tensors) and `merge_lse` combines two hops in log space.
"""

from __future__ import annotations

import torch

from alphafold2_tpu_torch.ops import dispatch, flash_kernel

_NEG_INF = float("-inf")


def stream_block(q, k_blk, v_blk, bias_blk, m, l, acc, scale,
                 logit_dtype=torch.float32, bias2d_blk=None):
    """One accumulation step against a K/V block.

    q: (b, nq, h, d); k_blk/v_blk: (b, nk, h, d); bias_blk: (b, nk)
    additive (-inf for masked keys) or None; bias2d_blk: optional
    (b, h, nq, nk). Running stats m, l: (b, h, nq); acc: (b, h, nq, d).
    The score tiles are materialised in `logit_dtype`; the running stats
    and the accumulator are float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).to(logit_dtype) * scale
    if bias_blk is not None:
        s = s + bias_blk[:, None, None, :].to(logit_dtype)
    if bias2d_blk is not None:
        s = s + bias2d_blk.to(logit_dtype)

    m_new = torch.maximum(m, s.amax(dim=-1).float())
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    p = torch.where(
        torch.isneginf(s), torch.zeros((), dtype=logit_dtype, device=s.device),
        torch.exp(s - m_safe[..., None].to(logit_dtype)),
    )
    l_new = l * alpha + p.sum(dim=-1, dtype=torch.float32)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.to(v_blk.dtype), v_blk
    ).float()
    return m_new, l_new, acc_new


def merge_lse(out_a, lse_a, out_b, lse_b):
    """Log-space merge of two normalised partial softmax results (the hop
    interface of ring attention):

        out = (e^lse_a out_a + e^lse_b out_b) / (e^lse_a + e^lse_b)
        lse = log(e^lse_a + e^lse_b)

    with the running-max stabilisation. A zero-mass block carries lse =
    -inf and weighs zero (`hop_attention_lse` flips the kernel's +inf);
    rows empty on both sides give (0, -inf), with finite gradients.
    out_*: (..., d) f32; lse_*: (...) f32. Returns (out, lse)."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)  # both-empty rows
    w_a = torch.exp(lse_a - m_safe)
    w_b = torch.exp(lse_b - m_safe)
    tot = w_a + w_b
    live = tot > 0
    safe_tot = torch.where(live, tot, 1.0)
    out = torch.where(
        live[..., None],
        (out_a * w_a[..., None] + out_b * w_b[..., None]) / safe_tot[..., None],
        0.0,
    )
    lse = torch.where(live, m_safe + torch.log(safe_tot), _NEG_INF)
    return out, lse


def _stream(q, k, v, bias, scale, kv_block, logit_dtype, bias2d=None):
    """Exact attention for one query tile, streaming K/V blocks.
    Returns the (b, h, nq, d) f32 normalised output."""
    b, nq, h, dh = q.shape
    j = k.shape[1]
    m = torch.full((b, h, nq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, nq, dh), dtype=torch.float32, device=q.device)
    step = j if (not kv_block or j <= kv_block) else kv_block
    for c0 in range(0, j, step):
        c1 = min(j, c0 + step)
        m, l, acc = stream_block(
            q, k[:, c0:c1], v[:, c0:c1],
            None if bias is None else bias[:, c0:c1], m, l, acc, scale,
            logit_dtype,
            None if bias2d is None else bias2d[..., c0:c1],
        )
    return acc / torch.where(l > 0, l, 1.0)[..., None]  # zeros for all-masked q


def blockwise_attention(q, k, v, key_bias=None, *, scale=None,
                        tile_elems: int = 1 << 25, kv_block: int = 2048,
                        logit_dtype=None):
    """Exact softmax(QK^T * scale + bias)V with bounded-memory tiling.

    q: (B, i, h, dh); k, v: (B, j, h, dh); key_bias: (B, j) additive f32
    (0 valid / -inf masked), key-side masking only. Query tiles are sized
    so one (batch, h, q_tile, kv_block) logit tile holds about
    `tile_elems` elements. Returns (B, i, h, dh) in q.dtype; fully masked
    query rows return zeros."""
    B, i, h, dh = q.shape
    j = k.shape[1]
    scale = dh ** -0.5 if scale is None else scale
    logit_dtype = torch.float32 if logit_dtype is None else logit_dtype
    if key_bias is None:
        key_bias = torch.zeros((B, j), dtype=torch.float32, device=q.device)
    key_bias = key_bias.expand(B, j)
    j_eff = min(j, kv_block) if kv_block else j
    qb = max(1, min(i, tile_elems // max(1, B * h * j_eff)))
    out = torch.empty_like(q)
    for r0 in range(0, i, qb):
        r1 = min(i, r0 + qb)
        o = _stream(q[:, r0:r1], k, v, key_bias, scale, kv_block, logit_dtype)
        out[:, r0:r1] = o.transpose(1, 2).to(q.dtype)
    return out


def apply_output_gate(out, gate):
    """The unfused sigmoid output gate: sigmoid in f32 on the f32 output,
    one cast at the end (the fused kernel's finish step). gate holds
    pre-sigmoid logits of out's shape."""
    return (out.float() * torch.sigmoid(gate.float())).to(out.dtype)


def streamed_fused_attention(q, k, v, key_bias, pair_bias, gate, scale,
                             kv_block: int = 2048, logit_dtype=None):
    """Plain twin of the fused kernel: a (B, h, i, j) f32 pair bias (plus
    an optional (B, j) key bias) and an optional (B, i, h, dh) pre-sigmoid
    gate, streamed along j in `kv_block` chunks."""
    logit_dtype = torch.float32 if logit_dtype is None else logit_dtype
    bias = pair_bias.float()
    if key_bias is not None:
        bias = bias + key_bias[:, None, None, :].float()
    out = _stream(q, k, v, None, scale, kv_block, logit_dtype,
                  bias2d=bias).transpose(1, 2)  # (B, i, h, dh) f32
    if gate is not None:
        out = out * torch.sigmoid(gate.float())
    return out.to(q.dtype)


def aligned(t):
    """t contiguous and 16-byte aligned (the bf16 kernels load 16-byte
    vectors; a view at an odd offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fold_heads(t):
    """(B, n, h, dh) -> the kernels' (B*h, n, dh) layout, aligned."""
    B, n, h, dh = t.shape
    return aligned(t.transpose(1, 2).reshape(B * h, n, dh))


class _FlashKernel(torch.autograd.Function):
    """B1 in the folded layout: forward `flash_fwd`, backward `flash_bwd`
    from the saved out and lse. The key-side bias is a mask, not a
    parameter: no cotangent (JAX `_bwd_impl` :419-426)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, lse = flash_kernel.flash_fwd(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_kernel.flash_bwd(q, k, v, bias, out, lse, aligned(g),
                                            ctx.scale)
        return dq, dk, dv, None, None


class _FusedFlashKernel(torch.autograd.Function):
    """B2 in the folded layout: forward `flash_fwd_fused`, backward
    `flash_bwd_fused`. A 2-D bias gets its cotangent (pair biases are
    learned projections); a key-side bias gets none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, gate, scale):
        out, lse = flash_kernel.flash_fwd_fused(q, k, v, bias, scale, gate=gate)
        ctx.save_for_backward(q, k, v, bias, gate, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, gate, out, lse = ctx.saved_tensors
        dq, dk, dv, d_bias, d_gate = flash_kernel.flash_bwd_fused(
            q, k, v, bias, gate, out, lse, aligned(g), ctx.scale
        )
        return dq, dk, dv, d_bias, d_gate, None


class _FlashLseKernel(torch.autograd.Function):
    """B3 in the folded layout: forward `flash_fwd_lse` (out and lse, both
    differentiable), backward `flash_bwd_lse` with the lse cotangent. The
    key-side bias gets no cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, lse = flash_kernel.flash_fwd_lse(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_kernel.flash_bwd_lse(
            q, k, v, bias, out, lse, aligned(g), g_lse, ctx.scale
        )
        return dq, dk, dv, None, None


def hop_attention_lse(qf, kf, vf, bias, scale):
    """One ring hop's normalised (out, lse), the `merge_lse` op's hop: B3
    on CUDA tensors (`_FlashLseKernel`, or a ValueError for a shape it does
    not take), its plain version on CPU tensors (differentiable by
    autograd). qf (BH, i, dh), kf/vf (BH, j, dh), bias (BH, j) additive
    f32. The kernel marks a zero-mass row with lse = +inf (its backward's
    convention); merging needs zero mass to weigh zero, so +inf becomes
    -inf here. Returns (out f32, lse f32)."""
    i, j, dh = qf.shape[1], kf.shape[1], qf.shape[2]
    unsupported = None if flash_kernel.supported(i, j, dh) else (
        f"i={i}, j={j}, dh={dh} (head widths {flash_kernel.SUPPORTED_DH})")
    if dispatch.resolve("merge_lse", qf.device, unsupported=unsupported) == dispatch.PLAIN:
        out, lse = flash_kernel.flash_fwd_plain(qf, kf, vf, bias, scale)
    else:
        out, lse = _FlashLseKernel.apply(aligned(qf), aligned(kf), aligned(vf), aligned(bias),
                                         scale)
    lse = torch.where(torch.isposinf(lse), _NEG_INF, lse)
    return out.float(), lse


def flash_attention(q, k, v, key_bias=None, *, pair_bias=None, gate=None,
                    scale=None, tile_elems: int = 1 << 25,
                    kv_block: int = 2048, logit_dtype=None):
    """Exact attention: the CUDA kernels on CUDA tensors (differentiable
    through the backward kernels), the plain blockwise versions on CPU
    tensors (differentiable by autograd).

    q: (B, i, h, dh); k, v: (B, j, h, dh); key_bias: (B, j) additive f32;
    pair_bias: optional (B, h, i, j) f32; gate: optional (B, i, h, dh)
    pre-sigmoid logits. tile_elems, kv_block and logit_dtype shape the
    plain versions only; a bf16 `logit_dtype` on CUDA raises, as it does
    on the TPU kernel path (the kernel keeps its logits in f32 registers).
    Returns (B, i, h, dh) in q.dtype."""
    B, i, h, dh = q.shape
    j = k.shape[1]
    scale = dh ** -0.5 if scale is None else scale

    unsupported = None if flash_kernel.supported(i, j, dh) else (
        f"i={i}, j={j}, dh={dh} (head widths {flash_kernel.SUPPORTED_DH})")
    if dispatch.resolve("flash_attention", q.device, unsupported=unsupported) == dispatch.PLAIN:
        if pair_bias is not None:
            return streamed_fused_attention(
                q, k, v, key_bias, pair_bias, gate, scale,
                kv_block=kv_block, logit_dtype=logit_dtype,
            )
        out = blockwise_attention(
            q, k, v, key_bias, scale=scale, tile_elems=tile_elems,
            kv_block=kv_block, logit_dtype=logit_dtype,
        )
        return out if gate is None else apply_output_gate(out, gate)

    if logit_dtype is not None and logit_dtype != torch.float32:
        raise ValueError(
            "logit_dtype (flash_compute_dtype_logits) applies only to the "
            f"plain streaming path, but the CUDA kernel runs here (i={i}, "
            f"j={j}); the kernel keeps its logits in f32"
        )
    if key_bias is None:
        key_bias = torch.zeros((B, j), dtype=torch.float32, device=q.device)
    key_bias = key_bias.expand(B, j).float()
    if pair_bias is not None:
        bias = pair_bias.float() + key_bias[:, None, None, :]
        bias = bias.expand(B, h, i, j).reshape(B * h, i, j).contiguous()
    else:
        bias = key_bias.repeat_interleave(h, dim=0)  # one row per (batch, head)
    if pair_bias is not None or gate is not None:
        out = _FusedFlashKernel.apply(
            fold_heads(q), fold_heads(k), fold_heads(v), bias,
            None if gate is None else fold_heads(gate), scale,
        )
    else:
        out = _FlashKernel.apply(fold_heads(q), fold_heads(k), fold_heads(v), bias, scale)
    return out.reshape(B, h, i, dh).transpose(1, 2)
