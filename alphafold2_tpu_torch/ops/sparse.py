"""Block-sparse self-attention with a variable sparsity layout
(counterpart of alphafold2_tpu/ops/sparse.py).

  * `sparsity_layout` / `layout_block_indices`: the static block layout
    (local groups, global blocks, seeded random blocks, symmetrised), in
    numpy, bit-identical to the JAX package's;
  * `block_sparse_attention`: the block-gather version in (b, n, h, dh),
    differentiable by autograd and with attention dropout; it runs the
    plain version of kernel B5 (`sparse_kernel.sparse_fwd_plain`) and is
    what the CPU runs;
  * `sparse_attention_apply`: the sparse counterpart of `attention_apply`
    for self-attention, sharing its parameters; it pads to a block
    multiple (honouring the caller's mask), unpads on exit, and runs the
    CUDA kernels of ops/sparse_kernel.py on CUDA tensors and the gather
    version on CPU tensors (ops/dispatch.py), live attention dropout
    included: both draw the layer's dropout seed (`draw_seed`) from its rng
    at the same point, and one seed gives one mask on either device. The
    JAX package's n >= 4096 switch to its kernel and its
    `sparse_use_kernel=False` are not ported: on the card the kernels run
    at every length.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from alphafold2_tpu_torch.ops import dispatch, sparse_kernel
from alphafold2_tpu_torch.ops.core import linear, row_span
from alphafold2_tpu_torch.ops.flash import aligned, fold_heads


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    """Static sparsity hyper-parameters (hashable)."""

    block_size: int = 16
    num_random_blocks: Optional[int] = None  # None: max_seq_len // block // 4
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    layout_seed: int = 0
    max_seq_len: int = 2048


@functools.lru_cache(maxsize=64)
def sparsity_layout(num_blocks: int, scfg: SparseConfig) -> np.ndarray:
    """(num_blocks, num_blocks) bool block connectivity, symmetric: local
    groups of `num_local_blocks`, the first `num_global_blocks` attend and
    are attended everywhere, `num_random_blocks` seeded random key blocks
    per row."""
    B = num_blocks
    nl = scfg.num_local_blocks
    ng = min(scfg.num_global_blocks, B)
    nr = scfg.num_random_blocks
    if nr is None:
        nr = scfg.max_seq_len // scfg.block_size // 4
    nr = min(nr, B)

    layout = np.zeros((B, B), dtype=bool)
    for g in range(0, B, nl):
        layout[g:g + nl, g:g + nl] = True
    layout[:, :ng] = True
    layout[:ng, :] = True
    rng = np.random.RandomState(scfg.layout_seed)
    for i in range(B):
        cols = rng.choice(B, size=nr, replace=False)
        layout[i, cols] = True
    layout |= layout.T
    return layout


@functools.lru_cache(maxsize=64)
def layout_block_indices(num_blocks: int, scfg: SparseConfig):
    """Per-row active key-block indices, padded to the largest row: (idx
    int32 (B, A), valid bool (B, A)), the valid slots first."""
    layout = sparsity_layout(num_blocks, scfg)
    counts = layout.sum(axis=1)
    A = int(counts.max())
    idx = np.zeros((num_blocks, A), np.int32)
    valid = np.zeros((num_blocks, A), bool)
    for i in range(num_blocks):
        cols = np.nonzero(layout[i])[0]
        idx[i, :len(cols)] = cols
        valid[i, :len(cols)] = True
    return idx, valid


@functools.lru_cache(maxsize=64)
def kernel_table(num_blocks: int, scfg: SparseConfig, device: str) -> sparse_kernel.BlockTable:
    """The layout as the CUDA kernels read it, on `device` (cached)."""
    idx, valid = layout_block_indices(num_blocks, scfg)
    return sparse_kernel.block_table(idx, valid, scfg.block_size, device)


def active_fraction(n: int, scfg: SparseConfig) -> float:
    """The share of (query block, key block) pairs the layout keeps at
    length n (padded to a block multiple)."""
    B = -(-n // scfg.block_size)
    return float(sparsity_layout(B, scfg).mean())


def _folded(q, k, v, scfg: SparseConfig, mask):
    """(b, n, h, dh) q, k, v and the (b, n) bool key mask as the B5
    functions take them: q, k, v folded to (b * h, n, dh), the mask as an
    additive (b, n) f32 key bias (0 or -inf), and the block table."""
    b, n, h, dh = q.shape
    if mask is None:
        bias = torch.zeros((b, n), dtype=torch.float32, device=q.device)
    else:
        bias = aligned(torch.where(mask, 0.0, float("-inf")).float())
    table = kernel_table(n // scfg.block_size, scfg, str(q.device))
    return fold_heads(q), fold_heads(k), fold_heads(v), bias, table


def draw_seed(rng: torch.Generator, device):
    """The dropout seed of one attention call: two int64 in [0, 2^62) drawn
    on the generator's device, in its turn (a generator registered with a
    CUDA graph draws afresh at each replay), on `device`."""
    return torch.randint(2 ** 62, (2,), generator=rng, device=rng.device).to(device)


def block_sparse_attention(q, k, v, scfg: SparseConfig, *, mask=None,
                           scale: Optional[float] = None, dropout_rate: float = 0.0,
                           seed=None, bh_base: int = 0):
    """Block-sparse attention over projected q, k, v (b, n, h, dh), n a
    multiple of the block size: each query block attends the gathered key
    blocks of its layout row, in f32. mask: (b, n) bool key validity. Rows
    with no valid key return zeros. Attention dropout at dropout_rate > 0
    from `seed`, two int64 (`draw_seed`; None: no dropout), folded row bh
    drawing as bh_base + bh. Returns (b, n, h, dh) in q.dtype."""
    b, n, h, dh = q.shape
    if n % scfg.block_size:
        raise ValueError(f"sequence {n} is not a multiple of the block size {scfg.block_size}")
    scale = dh ** -0.5 if scale is None else scale
    out, _ = sparse_kernel.sparse_fwd_plain(*_folded(q, k, v, scfg, mask), h, scale,
                                            dropout_rate=dropout_rate, seed=seed,
                                            bh_base=bh_base)
    return out.reshape(b, h, n, dh).transpose(1, 2)


def sparse_attention_apply(params, cfg, scfg: SparseConfig, x, *, mask=None, rng=None):
    """Sparse self-attention with the dense attention's parameters (to_q,
    to_kv, to_out). x: (b, n, dim); mask: (b, n) bool; rng: a generator for
    attention dropout (None: eval mode), from which the call draws its
    dropout seed once, after the projections (`draw_seed`). Returns (b, n,
    dim) in cfg.dtype."""
    b, n, _ = x.shape
    dtype, bs = cfg.dtype, scfg.block_size
    h, dh = cfg.heads, cfg.dim_head

    q = linear(params["to_q"], x, dtype=dtype)
    k, v = linear(params["to_kv"], x, dtype=dtype).chunk(2, dim=-1)
    pad = (-n) % bs
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=x.device)
        mask = F.pad(mask, (0, pad), value=False)
    q, k, v = (t.reshape(b, n + pad, h, dh) for t in (q, k, v))

    route = dispatch.resolve("sparse_attention", q.device,
                             sparse_kernel.unsupported(b * h, n + pad, dh, q.dtype, bs))
    seed = draw_seed(rng, q.device) if rng is not None and cfg.dropout > 0.0 else None
    # a data-parallel shard's folded rows draw as the whole batch's (ops/core.py)
    bh_base = row_span(b * h, rng)[0] if seed is not None else 0
    if route == dispatch.PLAIN:
        out = block_sparse_attention(q, k, v, scfg, mask=mask, dropout_rate=cfg.dropout,
                                     seed=seed, bh_base=bh_base)
    else:
        out = sparse_kernel.SparseKernelAttention.apply(*_folded(q, k, v, scfg, mask), h,
                                                        dh ** -0.5, cfg.dropout, seed, bh_base)
        out = out.reshape(b, h, n + pad, dh).transpose(1, 2)
    out = out.reshape(b, n + pad, h * dh)[:, :n]
    return linear(params["to_out"], out, dtype=dtype)
