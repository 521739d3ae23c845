"""Sequence parallelism: ring attention, Ulysses all_to_all attention and
the sequence-parallel axial passes (counterpart of
alphafold2_tpu/parallel/sequence.py).

Each function takes per-shard lists (shard s on `mesh.devices[s]`,
parallel/mesh.py) where the JAX function takes one shard inside
`shard_map`, and the mesh where it takes the axis name:

  * `ring_attention` — exact attention over a sharded sequence: the K/V
    shards rotate around the ring (`ppermute`) while each shard's queries
    stay put; every hop gives a normalised (out, lse) through kernel B3
    (`ops/flash.py hop_attention_lse`; its plain version on CPU tensors)
    and hops merge in log space (`merge_lse`). The synchronous schedule:
    the resident block first, then P - 1 rotate-then-compute hops.
  * `ulysses_attention` — all_to_all from (sequence-sharded, all heads) to
    (full sequence, heads/P), dense attention per shard, and back.
  * `sequence_parallel_axial_attention` — the trunk's axial attention with
    the grid rows sharded: the row pass is local, the column pass runs
    after an all_to_all grid transpose (`axial_alltoall_transpose`).
  * `tied_row_attention_sharded` — MSA tied-row attention with the rows
    sharded: one `psum` of the partial logits.

Dropout is refused (`rng`): the sequence-parallel trunk is deterministic.
Masked logits never contribute; a fully masked query row returns zeros.
"""

from __future__ import annotations

import torch

from alphafold2_tpu_torch.ops.attention import attention_apply
from alphafold2_tpu_torch.ops.core import linear
from alphafold2_tpu_torch.ops.flash import (
    apply_output_gate,
    flash_attention,
    hop_attention_lse,
    merge_lse,
)

_NEG_INF = float("-inf")


def _refuse_dropout(rng) -> None:
    if rng is not None:
        raise ValueError(
            "dropout is not supported on the sequence-parallel path "
            "(sp_trunk_apply is deterministic); pass rng=None"
        )


def _key_bias(mask, b, n, device):
    """(b, n) additive f32: 0 for a valid key, -inf for a masked one."""
    if mask is None:
        return torch.zeros((b, n), dtype=torch.float32, device=device)
    return torch.where(mask, 0.0, _NEG_INF).float()


def ring_attention(qs, ks, vs, mesh, masks=None, overlap=None):
    """Exact ring attention over the sharded sequence axis.

    qs, ks, vs: per-shard (b, n_local, h, d) and (b, nk_local, h, d)
    (nk_local may differ from n_local: cross-attention); masks: per-shard
    (b, nk_local) bool key validity, or None. overlap: None or False take
    the synchronous schedule; True (the double-buffered schedule, the same
    arithmetic with hop i+1's copy issued before hop i's compute) raises:
    it is worth having only with asynchronous copies between cards
    (ROADMAP A13). Returns per-shard (b, n_local, h, d) in q's dtype."""
    if overlap:
        raise NotImplementedError(
            "ring_attention(overlap=True), the double-buffered schedule, is not "
            "ported yet (ROADMAP A13); use overlap=None or False"
        )
    P = mesh.size
    b, n_local, h, d = qs[0].shape
    nk_local = ks[0].shape[1]
    scale = d ** -0.5
    masks = [None] * P if masks is None else masks
    biases = [_key_bias(m, b, nk_local, q.device) for m, q in zip(masks, qs)]
    perm = [(s, (s + 1) % P) for s in range(P)]

    def fold(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], d)

    def hop(qf, kf, vf, bias):
        return hop_attention_lse(qf, kf, vf, bias.repeat_interleave(h, dim=0), scale)

    qf = [fold(q) for q in qs]
    kb, vb, bb = [fold(k) for k in ks], [fold(v) for v in vs], biases
    outs, lses = map(list, zip(*(hop(*a) for a in zip(qf, kb, vb, bb))))
    for _ in range(1, P):
        kb, vb, bb = mesh.ppermute(kb, perm), mesh.ppermute(vb, perm), mesh.ppermute(bb, perm)
        for s in range(P):
            out_h, lse_h = hop(qf[s], kb[s], vb[s], bb[s])
            outs[s], lses[s] = merge_lse(outs[s], lses[s], out_h, lse_h)
    return [o.reshape(b, h, n_local, d).transpose(1, 2).to(q.dtype)
            for o, q in zip(outs, qs)]


def ulysses_attention(qs, ks, vs, mesh, masks=None):
    """All_to_all (Ulysses-style) sequence-parallel attention: heads
    divisible by the mesh size. Args and returns as `ring_attention`."""
    P = mesh.size
    b, n_local, h, d = qs[0].shape
    if h % P != 0:
        raise ValueError(f"heads ({h}) must divide by the sp axis ({P})")

    def flip(ts):  # (b, n_local, h, d) -> (b, n, h / P, d)
        return mesh.all_to_all(ts, split_dim=2, concat_dim=1)

    qg, kg, vg = flip(qs), flip(ks), flip(vs)
    n = n_local * P
    masks = [None] * P if masks is None else mesh.all_gather(masks, dim=1)
    biases = [_key_bias(m, b, n, q.device) for m, q in zip(masks, qs)]
    outs = [flash_attention(q, k, v, bias, scale=d ** -0.5, kv_block=2048)
            for q, k, v, bias in zip(qg, kg, vg, biases)]
    return mesh.all_to_all(outs, split_dim=1, concat_dim=2)


def axial_alltoall_transpose(xs, mesh, row_sharded: bool = True):
    """Swap the sharded grid axis of pair-grid shards: (b, rows_local,
    cols, d) -> (b, rows, cols_local, d) when `row_sharded`, the mirror
    when not. One all_to_all."""
    if row_sharded:
        return mesh.all_to_all(xs, split_dim=2, concat_dim=1)
    return mesh.all_to_all(xs, split_dim=1, concat_dim=2)


def sequence_parallel_axial_attention(params, cfg, xs, mesh, masks=None, rng=None):
    """The trunk's axial self-attention with the grid's row axis sharded:
    xs per-shard (b, rows_local, cols, d), masks (b, rows_local, cols).
    The row pass attends along the full width locally; the column pass runs
    after an all_to_all grid transpose and transposes back; the two sum in
    the row-sharded layout (ops/attention.py axial_attention_apply's
    semantics)."""
    _refuse_dropout(rng)
    P = mesh.size
    masks = [None] * P if masks is None else masks
    ps = mesh.replicate(params)
    b, h_local, w, d = xs[0].shape

    row_out = [
        attention_apply(p["attn_height"], cfg, x.reshape(b * h_local, w, d),
                        mask=None if m is None else m.reshape(b * h_local, w)
                        ).reshape(b, h_local, w, d)
        for p, x, m in zip(ps, xs, masks)
    ]

    xc = axial_alltoall_transpose(xs, mesh, row_sharded=True)  # (b, H, w/P, d)
    h_full, w_local = xc[0].shape[1], xc[0].shape[2]
    if masks[0] is not None:
        mc = axial_alltoall_transpose(masks, mesh, row_sharded=True)
        col_masks = [m.transpose(1, 2).reshape(b * w_local, h_full) for m in mc]
    else:
        col_masks = [None] * P
    col_out = [
        attention_apply(p["attn_width"], cfg,
                        x.transpose(1, 2).reshape(b * w_local, h_full, d), mask=m
                        ).reshape(b, w_local, h_full, d).transpose(1, 2)
        for p, x, m in zip(ps, xc, col_masks)
    ]
    col_out = axial_alltoall_transpose(col_out, mesh, row_sharded=False)
    return [r + c for r, c in zip(row_out, col_out)]


def tied_row_attention_sharded(params, cfg, xs, mesh, masks=None, rng=None):
    """MSA tied-row attention with the ROW axis sharded: xs per-shard
    (b, r_local, n, dim), masks (b, r_local, n). Each shard sums the logits
    over its resident rows; one psum completes the contraction over every
    row; softmax, value mixing, the gate and the output projection stay
    local. Equals `attention_apply(..., tie_dim=r_total)` on the gathered
    rows. Returns per-shard (b, r_local, n, dim)."""
    _refuse_dropout(rng)
    P = mesh.size
    masks = [None] * P if masks is None else masks
    ps = mesh.replicate(params)
    dtype = cfg.dtype
    b, r_local, n, _ = xs[0].shape
    h, dh = cfg.heads, cfg.dim_head
    scale = dh ** -0.5 * (r_local * P) ** -0.5

    qkv = []
    for p, x in zip(ps, xs):
        q = linear(p["to_q"], x, dtype=dtype)
        k, v = linear(p["to_kv"], x, dtype=dtype).chunk(2, dim=-1)
        qkv.append(tuple(t.reshape(b, r_local, n, h, dh) for t in (q, k, v)))
    partial = [torch.einsum("brihd,brjhd->bhij", q, k).float() * scale for q, k, _ in qkv]
    logits = mesh.psum(partial)
    if masks[0] is not None:
        # valid only if valid in every row, across all shards
        counts = mesh.psum([m.all(dim=1).to(torch.int32) for m in masks])
        fill = torch.finfo(torch.float32).min
        for s, c in enumerate(counts):
            valid = c == P
            pair = valid[:, None, :, None] & valid[:, None, None, :]
            logits[s] = torch.where(pair, logits[s], fill)

    outs = []
    for p, x, lg, (_, _, v) in zip(ps, xs, logits, qkv):
        attn = torch.softmax(lg, dim=-1).to(dtype)
        out = torch.einsum("bhij,brjhd->brihd", attn, v).reshape(b, r_local, n, h * dh)
        if cfg.gate:
            out = apply_output_gate(out, linear(p["to_gate"], x, dtype=dtype))
        outs.append(linear(p["to_out"], out, dtype=dtype))
    return outs
