"""The sequence-parallel trunk (counterpart of
alphafold2_tpu/parallel/sp_trunk.py).

The real trunk layer with the pair grid's ROW axis and the MSA ROW axis
sharded over one mesh axis (parallel/mesh.py: per-shard lists, shard s on
`mesh.devices[s]`, where the JAX package runs one `shard_map`):

  * pair self-attention  -> `sequence_parallel_axial_attention` (row pass
    local, column pass through an all_to_all grid transpose);
  * MSA self-attention   -> tied rows: `tied_row_attention_sharded` (a
    logit psum) for the along-columns pass, plus an all_to_all transpose
    for the along-rows pass; untied: the same axial scheme as the pair;
  * pair<-MSA cross      -> all_gather the small MSA stream, then local
    cross-attention over the resident pair rows (per column group when
    cross_attn_mode="aligned");
  * MSA<-pair cross      -> ring cross-attention: the resident MSA queries
    stream the pair K/V shards around the ring, one B3 launch a hop (per
    column group when "aligned");
  * feed-forwards, norms, residuals: shard-local.

The same math as the replicated sequential trunk (dropout off) to float
tolerance. Cross-attention KV compression applies per shard with a halo
exchange (`_compress_kv_sharded`) that reproduces the global window grid.
`alphafold2_apply_sp` runs the whole model with the trunk sharded: the
embeddings and the head run on the mesh's first device.
"""

from __future__ import annotations

import torch

from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.trunk import cross_apply_grids, prenorm_axial_apply, \
    prenorm_ff_apply
from alphafold2_tpu_torch.ops.attention import _compress_conv, attention_apply
from alphafold2_tpu_torch.ops.core import layer_norm, linear
from alphafold2_tpu_torch.ops.flash import apply_output_gate
from alphafold2_tpu_torch.parallel.sequence import (
    axial_alltoall_transpose,
    ring_attention,
    sequence_parallel_axial_attention,
    tied_row_attention_sharded,
)


def _split_heads(t, heads, dim_head):
    b, n, _ = t.shape
    return t.reshape(b, n, heads, dim_head)


def _none(mesh):
    return [None] * mesh.size


def _msa_self_attention(params, cfg: Alphafold2Config, ms, mesh, msa_masks):
    """MSA axial self-attention with the ROW axis sharded; ms per-shard
    (b, r_local, c, d). The along-columns pass is tied over ALL rows
    through the sharded-logit psum when cfg.msa_tie_row_attn, else plain
    attention with the rows folded; the along-rows pass transposes to
    column shards, attends over the full row axis and transposes back."""
    attn_cfg = cfg.self_attn_config()
    ps = mesh.replicate(params)
    b, r_local, c, d = ms[0].shape

    if cfg.msa_tie_row_attn:
        row_out = tied_row_attention_sharded(params["attn_height"], attn_cfg, ms, mesh,
                                             masks=msa_masks)
    else:
        row_out = [
            attention_apply(p["attn_height"], attn_cfg, m.reshape(b * r_local, c, d),
                            mask=None if mm is None else mm.reshape(b * r_local, c)
                            ).reshape(b, r_local, c, d)
            for p, m, mm in zip(ps, ms, msa_masks)
        ]

    mc = axial_alltoall_transpose(ms, mesh, row_sharded=True)  # (b, R, c_loc, d)
    r_full, c_local = mc[0].shape[1], mc[0].shape[2]
    if msa_masks[0] is not None:
        mm = axial_alltoall_transpose(msa_masks, mesh, row_sharded=True)
        col_masks = [t.transpose(1, 2).reshape(b * c_local, r_full) for t in mm]
    else:
        col_masks = _none(mesh)
    col_out = [
        attention_apply(p["attn_width"], attn_cfg,
                        m.transpose(1, 2).reshape(b * c_local, r_full, d), mask=cm
                        ).reshape(b, c_local, r_full, d).transpose(1, 2)
        for p, m, cm in zip(ps, mc, col_masks)
    ]
    col_out = axial_alltoall_transpose(col_out, mesh, row_sharded=False)
    return [r + c for r, c in zip(row_out, col_out)]


def _gather_msa(ms, msa_masks, mesh):
    """all_gather the (small) MSA stream and its mask over the row shards:
    (b, r_local, c, d) -> (b, R, c, d) on every shard."""
    m_full = mesh.all_gather(ms, dim=1)
    mm_full = _none(mesh) if msa_masks[0] is None else mesh.all_gather(msa_masks, dim=1)
    return m_full, mm_full


def _gathered_cross(params, cfg: Alphafold2Config, q_flat, ctx_local, q_masks, ctx_masks,
                    mesh):
    """pair<-MSA flat cross-attention: all_gather the MSA context, attend
    locally over the resident pair-row queries."""
    cross_cfg = cfg.cross_attn_config()
    ps = mesh.replicate(params)
    ctx, cm_grid = _gather_msa(ctx_local, ctx_masks, mesh)
    b = ctx[0].shape[0]
    return [
        attention_apply(
            p["attn"], cross_cfg, layer_norm(p["norm"], q),
            context=layer_norm(p["norm_context"], c.reshape(b, -1, c.shape[-1])),
            mask=qm, context_mask=None if cm is None else cm.reshape(b, -1),
        )
        for p, q, c, qm, cm in zip(ps, q_flat, ctx, q_masks, cm_grid)
    ]


def _compress_kv_sharded(params, cfg, ks, vs, context_masks, mesh):
    """Per-shard KV compression that equals the global strided conv.

    The global compression (ops/attention.py `_compress_kv`) convolves
    windows [0:r], [r:2r], ... of the whole key sequence. Shard s holds the
    slice [s*L, (s+1)*L); windows may straddle a shard boundary, so each
    shard fetches a (ratio-1)-element halo from its right neighbour
    (`ppermute`; the last shard receives zeros, the global path's zero
    padding), convolves the ceil(L/ratio) candidate windows whose starts
    land in its slice (stride `ratio` from (-s*L) mod ratio) and masks off
    the slots it does not own. The owned slots over all shards are the
    global window set.

    ks, vs: per-shard (B, L, inner); context_masks per-shard (B, L) or
    Nones. Returns (k_c, v_c, slot_mask) lists with W = ceil(L/ratio)
    slots; slot_mask joins ownership with the sum-pooled key mask."""
    ratio = cfg.compress_ratio
    B, L, inner = ks[0].shape
    if L < ratio - 1:
        raise ValueError(
            f"sequence-parallel KV compression needs the local key length "
            f"({L}) >= ratio-1 ({ratio - 1}): a compression window may not "
            f"span more than two shards"
        )
    P = mesh.size
    ps = mesh.replicate(params)
    W = -(-L // ratio)  # ceil: the most windows a shard can own
    halo_len = ratio - 1
    masked = context_masks[0] is not None
    # shard s receives shard s+1's head; the last shard receives zeros
    perm = [(s, s - 1) for s in range(1, P)]
    # one halo collective: k, v and the key mask as one extra column
    ts = [torch.cat([k, v] + ([m.to(k.dtype)[..., None]] if masked else []), dim=-1)
          for k, v, m in zip(ks, vs, context_masks)]
    halos = mesh.ppermute([t[:, :halo_len] for t in ts], perm)
    out_k, out_v, out_m = [], [], []
    for s, (p, t, halo) in enumerate(zip(ps, ts, halos)):
        # slack so the W-window slice stays in bounds; only un-owned
        # (masked) slots read it
        slack = torch.zeros((B, ratio + 1, t.shape[-1]), dtype=t.dtype, device=t.device)
        t_ext = torch.cat([t, halo, slack], dim=1)
        offset0 = (-(s * L)) % ratio
        t_win = t_ext[:, offset0:offset0 + W * ratio]
        out_k.append(_compress_conv(p, cfg, t_win[..., :inner]))
        out_v.append(_compress_conv(p, cfg, t_win[..., inner:2 * inner]))
        owned = (offset0 + torch.arange(W, device=t.device) * ratio) < L
        if masked:
            pooled = t_win[..., -1].reshape(B, W, ratio).sum(-1) > 0
            out_m.append(pooled & owned[None, :])
        else:
            # every owned window starts inside the shard: ownership alone
            out_m.append(owned[None, :].expand(B, W))
    return out_k, out_v, out_m


def _ring_cross_tokens(params, cfg: Alphafold2Config, q_tokens, ctx_tokens, ctx_masks, mesh):
    """Cross-attention with resident queries and ring-streamed K/V shards:
    q_tokens per-shard (B, nq, d), ctx_tokens per-shard (B, nk_local, d).
    K/V and the key mask rotate around the ring; the full key stream never
    exists on one shard. Key-side masking only (ops/flash.py contract)."""
    cross_cfg = cfg.cross_attn_config()
    h, dh = cross_cfg.heads, cross_cfg.dim_head
    dtype = cross_cfg.dtype
    ps = mesh.replicate(params)
    qns = [layer_norm(p["norm"], q) for p, q in zip(ps, q_tokens)]
    qs, ks, vs = [], [], []
    for p, qn, ctx in zip(ps, qns, ctx_tokens):
        cn = layer_norm(p["norm_context"], ctx)
        qs.append(_split_heads(linear(p["attn"]["to_q"], qn, dtype=dtype), h, dh))
        k, v = linear(p["attn"]["to_kv"], cn, dtype=dtype).chunk(2, dim=-1)
        ks.append(k)
        vs.append(v)
    if cross_cfg.compress_ratio > 1:
        ks, vs, ctx_masks = _compress_kv_sharded(params["attn"], cross_cfg, ks, vs,
                                                 ctx_masks, mesh)
    ks = [_split_heads(k, h, dh) for k in ks]
    vs = [_split_heads(v, h, dh) for v in vs]
    outs = ring_attention(qs, ks, vs, mesh, masks=ctx_masks)
    result = []
    for p, qn, out in zip(ps, qns, outs):
        out = out.reshape(out.shape[0], out.shape[1], h * dh)
        if cross_cfg.gate:
            out = apply_output_gate(out, linear(p["attn"]["to_gate"], qn, dtype=dtype))
        result.append(linear(p["attn"]["to_out"], out, dtype=dtype))
    return result


def _ring_cross(params, cfg: Alphafold2Config, q_flat, ctx_flat, q_masks, ctx_masks, mesh):
    """MSA<-pair flat cross-attention through ring K/V streaming."""
    del q_masks  # key-side masking only (ops/flash.py contract)
    return _ring_cross_tokens(params, cfg, q_flat, ctx_flat, ctx_masks, mesh)


def _fold_pair_local(x_local, c, x_mask_local=None):
    """Column-fold one pair-row shard (models/trunk.py `_fold_by_msa_column`
    restricted to the shard's rows): (b, n_loc, n, d) -> (b*c, n_loc*f, d),
    grouped by which chunk of f grid columns maps to MSA column c."""
    b, n_loc, n, d = x_local.shape
    if n % c != 0:
        raise ValueError(
            f"aligned cross-attention needs the pair side ({n}) divisible "
            f"by the MSA column count ({c})"
        )
    f = n // c
    xg = x_local.reshape(b, n_loc, c, f, d).permute(0, 2, 1, 3, 4).reshape(b * c, n_loc * f, d)
    mg = None
    if x_mask_local is not None:
        mg = x_mask_local.reshape(b, n_loc, c, f).permute(0, 2, 1, 3).reshape(b * c, n_loc * f)
    return xg, mg, f


def _aligned_gathered_cross(params, cfg: Alphafold2Config, xs, ms, x_masks, msa_masks, mesh):
    """pair<-MSA ALIGNED cross-attention, rows sharded: each pair token
    attends only its grid column's MSA column. The MSA is all_gathered;
    the queries are the resident pair rows, column-folded locally."""
    cross_cfg = cfg.cross_attn_config()
    ps = mesh.replicate(params)
    b, n_loc, n, d = xs[0].shape
    c = ms[0].shape[2]
    m_full, mm_full = _gather_msa(ms, msa_masks, mesh)
    outs = []
    for p, x, m, mm, xm in zip(ps, xs, m_full, mm_full, x_masks):
        r_full = m.shape[1]
        mg = m.transpose(1, 2).reshape(b * c, r_full, d)
        mg_mask = None if mm is None else mm.transpose(1, 2).reshape(b * c, r_full)
        xg, xg_mask, f = _fold_pair_local(x, c, xm)
        out = attention_apply(p["attn"], cross_cfg, layer_norm(p["norm"], xg),
                              context=layer_norm(p["norm_context"], mg),
                              mask=xg_mask, context_mask=mg_mask)
        outs.append(out.reshape(b, c, n_loc, f, d).permute(0, 2, 1, 3, 4).reshape(b, n_loc, n, d))
    return outs


def _aligned_ring_cross(params, cfg: Alphafold2Config, ms, xs, msa_masks, x_masks, mesh):
    """MSA<-pair ALIGNED cross-attention, rows sharded: each MSA token
    attends only its column's pair-grid block; each column group's pair
    keys stream around the ring (`_ring_cross_tokens` over the folded
    groups). Key-side masking only."""
    del msa_masks  # key-side masking only (ops/flash.py contract)
    b, r_loc, c, d = ms[0].shape
    mgs = [m.transpose(1, 2).reshape(b * c, r_loc, d) for m in ms]
    xgs, xg_masks, _ = zip(*(_fold_pair_local(x, c, xm) for x, xm in zip(xs, x_masks)))
    outs = _ring_cross_tokens(params, cfg, mgs, list(xgs), list(xg_masks), mesh)
    return [o.reshape(b, c, r_loc, d).transpose(1, 2) for o in outs]


def sp_layer_apply(layer, cfg: Alphafold2Config, xs, ms, x_masks, msa_masks, mesh):
    """One trunk layer on resident shards (deterministic): xs per-shard
    (b, n_local, n, d) pair rows, ms per-shard (b, r_local, c, d) MSA rows
    or None; the masks per-shard lists or None. The sequential order of models/trunk.py: pair self -> MSA self
    -> pair<-MSA cross -> MSA<-pair cross -> FFs, every op residual.

    cfg.trunk_schedule "branch_parallel" runs this same order, the JAX SP
    layer's under both schedules (its join and fork are barriers around
    the same ops), and no side stream: the single-controller mesh already
    issues each shard's work in turn, and per-device streams for the
    shards belong to the multi-process trunk (ROADMAP A13)."""
    self_cfg = cfg.self_attn_config()
    lp = mesh.replicate(layer)
    b, n_local, n, d = xs[0].shape
    x_masks = _none(mesh) if x_masks is None else x_masks
    msa_masks = _none(mesh) if msa_masks is None else msa_masks
    x_attn = sequence_parallel_axial_attention(
        layer["seq_attn"]["attn"], self_cfg,
        [layer_norm(p["seq_attn"]["norm"], x) for p, x in zip(lp, xs)], mesh, masks=x_masks,
    )
    xs = [x + a for x, a in zip(xs, x_attn)]

    if ms is not None:
        m_attn = _msa_self_attention(
            layer["msa_attn"]["attn"], cfg,
            [layer_norm(p["msa_attn"]["norm"], m) for p, m in zip(lp, ms)], mesh, msa_masks,
        )
        ms = [m + a for m, a in zip(ms, m_attn)]
        if cfg.cross_attn_mode == "aligned":
            xs = [x + a for x, a in zip(xs, _aligned_gathered_cross(
                layer["seq_cross"], cfg, xs, ms, x_masks, msa_masks, mesh))]
            ms = [m + a for m, a in zip(ms, _aligned_ring_cross(
                layer["msa_cross"], cfg, ms, xs, msa_masks, x_masks, mesh))]
        else:
            xfs = [x.reshape(b, n_local * n, d) for x in xs]
            xm_flat = [None if xm is None else xm.reshape(b, -1) for xm in x_masks]
            mm_flat = [None if mm is None else mm.reshape(b, -1) for mm in msa_masks]
            xfs = [xf + a for xf, a in zip(xfs, _gathered_cross(
                layer["seq_cross"], cfg, xfs, ms, xm_flat, msa_masks, mesh))]
            xs = [xf.reshape(b, n_local, n, d) for xf in xfs]
            mfs = [m.reshape(b, -1, d) for m in ms]
            mfs = [mf + a for mf, a in zip(mfs, _ring_cross(
                layer["msa_cross"], cfg, mfs, xfs, mm_flat, xm_flat, mesh))]
            ms = [mf.reshape(m.shape) for mf, m in zip(mfs, ms)]

    xs = [x + prenorm_ff_apply(p["seq_ff"], cfg, x) for p, x in zip(lp, xs)]
    if ms is not None:
        ms = [m + prenorm_ff_apply(p["msa_ff"], cfg, m) for p, m in zip(lp, ms)]
    return xs, ms


def msa_sharded_layer_apply(layer, cfg: Alphafold2Config, xs, ms, x_masks, msa_masks, mesh):
    """One trunk layer with ONLY the MSA row axis sharded (deterministic):
    xs per-shard copies of the FULL pair grid (b, n, n, d), ms per-shard
    (b, r_local, c, d). The pair-side ops run replicated (the same on every
    shard), the MSA self-attention goes through the sharded tied/transpose
    path, and both crosses run the replicated cross on the gathered (or
    resident) MSA rows (FastFold's dynamic axial parallelism). Under
    "branch_parallel" the same order and no side stream, as
    `sp_layer_apply`."""
    self_cfg = cfg.self_attn_config()
    lp = mesh.replicate(layer)
    x_masks = _none(mesh) if x_masks is None else x_masks
    msa_masks = _none(mesh) if msa_masks is None else msa_masks
    xs = [prenorm_axial_apply(p["seq_attn"], self_cfg, x, mask=xm) + x
          for p, x, xm in zip(lp, xs, x_masks)]
    m_attn = _msa_self_attention(
        layer["msa_attn"]["attn"], cfg,
        [layer_norm(p["msa_attn"]["norm"], m) for p, m in zip(lp, ms)], mesh, msa_masks,
    )
    ms = [m + a for m, a in zip(ms, m_attn)]
    m_full, mm_full = _gather_msa(ms, msa_masks, mesh)
    xs = [cross_apply_grids(p["seq_cross"], cfg, x, mf, xm, mmf, "pair_from_msa") + x
          for p, x, mf, xm, mmf in zip(lp, xs, m_full, x_masks, mm_full)]
    ms = [cross_apply_grids(p["msa_cross"], cfg, m, x, mm, xm, "msa_from_pair") + m
          for p, m, x, mm, xm in zip(lp, ms, xs, msa_masks, x_masks)]
    xs = [prenorm_ff_apply(p["seq_ff"], cfg, x) + x for p, x in zip(lp, xs)]
    ms = [prenorm_ff_apply(p["msa_ff"], cfg, m) + m for p, m in zip(lp, ms)]
    return xs, ms


def _refuse_sparse(cfg):
    if any(cfg.layer_sparse):
        raise ValueError("sparse layers are not sequence-parallel; use the "
                         "replicated trunk")


def msa_sharded_trunk_apply(layers, cfg: Alphafold2Config, x, m, mesh, *, x_mask=None,
                            msa_mask=None):
    """The sequential trunk with ONLY the MSA rows sharded: x (b, n, n, d)
    whole on every shard, m (b, rows, cols, d) rows sharded (rows and cols
    divisible by the mesh size: the along-rows pass transposes the sharded
    axis onto the columns). Deterministic; no sparse layers; needs an MSA.
    Returns (x, m) in global layouts on the mesh's first device."""
    _refuse_sparse(cfg)
    if m is None:
        raise ValueError(
            "msa_sharded_trunk_apply shards the MSA row axis; with no MSA "
            "stream there is nothing to shard — use the replicated trunk "
            "or sp_trunk_apply"
        )
    axis_name, shards = mesh.axis_name, mesh.size
    if m.shape[1] % shards != 0:
        raise ValueError(f"MSA rows ({m.shape[1]}) must divide by the "
                         f"'{axis_name}' mesh axis ({shards})")
    if m.shape[2] % shards != 0:
        raise ValueError(
            f"MSA cols ({m.shape[2]}) must divide by the '{axis_name}' mesh axis "
            f"({shards}) — the along-rows attention pass transposes the sharded "
            f"axis onto the columns"
        )
    xs, ms = mesh.broadcast(x), mesh.shard(m, 1)
    x_masks, msa_masks = mesh.broadcast(x_mask), mesh.shard(msa_mask, 1)
    for layer in layers:
        xs, ms = msa_sharded_layer_apply(layer, cfg, xs, ms, x_masks, msa_masks, mesh)
    return xs[0].to(mesh.devices[0]), mesh.unshard(ms, 1)


def sp_trunk_apply(layers, cfg: Alphafold2Config, x, m, mesh, *, x_mask=None, msa_mask=None):
    """The sequential trunk sequence-parallel over the mesh: x (b, n, n, d)
    rows sharded, m (b, rows, cols, d) rows sharded (or None), masks as in
    models/trunk.py. Deterministic; flat and aligned cross-attention; no
    sparse layers. Returns (x, m) in global layouts on the mesh's first
    device."""
    _refuse_sparse(cfg)
    axis_name, shards = mesh.axis_name, mesh.size
    if cfg.cross_attn_mode == "aligned" and x.shape[1] != x.shape[2]:
        raise ValueError(f"aligned cross-attention needs a square pair grid; got "
                         f"({x.shape[1]}, {x.shape[2]})")
    if x.shape[1] % shards != 0:
        raise ValueError(f"pair-grid rows ({x.shape[1]}) must divide by the "
                         f"'{axis_name}' mesh axis ({shards})")
    if m is not None and m.shape[1] % shards != 0:
        raise ValueError(f"MSA rows ({m.shape[1]}) must divide by the "
                         f"'{axis_name}' mesh axis ({shards})")
    xs, x_masks = mesh.shard(x, 1), mesh.shard(x_mask, 1)
    ms = None if m is None else mesh.shard(m, 1)
    msa_masks = mesh.shard(msa_mask, 1)
    for layer in layers:
        xs, ms = sp_layer_apply(layer, cfg, xs, ms, x_masks, msa_masks, mesh)
    return mesh.unshard(xs, 1), None if ms is None else mesh.unshard(ms, 1)


def alphafold2_apply_sp(params, cfg: Alphafold2Config, seq, msa, mesh, *, mask=None,
                        msa_mask=None, embedds=None, templates=None, templates_mask=None,
                        schedule: str = "sp_seq"):
    """The whole model's forward with the trunk sharded over `mesh`; the
    embeddings and the distogram head run on the mesh's first device, where
    the params must lie.

    schedule: "sp_seq" shards the SEQUENCE, pair-grid rows and MSA rows
    (`sp_trunk_apply`, the long-sequence cut); "sp_msa" shards the MSA rows
    only (`msa_sharded_trunk_apply`, the deep-alignment cut). A token MSA
    (rows sharded) or, under "sp_seq", msa=None. The embedds stream has no
    row axis to shard and is refused, as are sparse layers and the
    reversible trunk; the forward is deterministic (no dropout). Returns
    the logits on the first device."""
    from alphafold2_tpu_torch.models.alphafold2 import alphafold2_apply

    if cfg.reversible:
        raise ValueError("sequence-parallel trunk uses the sequential layer list; "
                         "set reversible=False (memory scales via sharding instead)")
    if schedule not in ("sp_seq", "sp_msa"):
        raise ValueError(f"schedule must be 'sp_seq' or 'sp_msa', got {schedule!r}")
    if embedds is not None:
        raise ValueError("the sequence-parallel trunk shards token/MSA row axes; the "
                         "embedds substitute stream has none: serve embedds dense")

    def trunk_fn(layers, cfg_, x, m, x_mask, m_mask, rng):
        del rng  # deterministic: alphafold2_apply gets no rng from here
        if schedule == "sp_msa":
            return msa_sharded_trunk_apply(layers, cfg_, x, m, mesh, x_mask=x_mask,
                                           msa_mask=m_mask)
        return sp_trunk_apply(layers, cfg_, x, m, mesh, x_mask=x_mask, msa_mask=m_mask)

    return alphafold2_apply(params, cfg, seq, msa, mask=mask, msa_mask=msa_mask,
                            templates=templates, templates_mask=templates_mask,
                            device=mesh.devices[0], trunk_fn=trunk_fn)
