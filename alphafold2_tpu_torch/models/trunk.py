"""The dual-track trunk (counterpart of alphafold2_tpu/models/trunk.py,
serial schedule).

Both streams keep their grid layouts — pair (b, i, j, d), MSA
(b, rows, cols, d) — and only the cross-attention flattens. Layers flagged
in `cfg.layer_sparse` run their pair axial passes block-sparse. Per layer,
every op residual: pair axial self-attn -> MSA axial self-attn (optionally
tied rows) -> pair<-MSA cross-attn -> MSA<-pair cross-attn -> pair FF ->
MSA FF. The MSA branch is skipped when there is no MSA stream.

`cfg.remat` recomputes each layer in the backward pass instead of keeping
its activations (`torch.utils.checkpoint`, the `jax.checkpoint` of the JAX
trunk): the same math, so the forward kernels launch twice per layer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.ops.attention import (
    attention_apply,
    attention_init,
    axial_attention_apply,
    axial_attention_init,
)
from alphafold2_tpu_torch.ops.core import layer_norm, layer_norm_init
from alphafold2_tpu_torch.ops.feedforward import feed_forward_apply, feed_forward_init
from alphafold2_tpu_torch.ops.sparse import sparse_attention_apply

# --- pre-norm wrapped blocks ------------------------------------------------


def prenorm_axial_init(gen, cfg: Alphafold2Config, attn_cfg, device):
    return {
        "norm": layer_norm_init(cfg.dim, device),
        "attn": axial_attention_init(gen, attn_cfg, device),
    }


def prenorm_cross_init(gen, cfg: Alphafold2Config, attn_cfg, device):
    return {
        "norm": layer_norm_init(cfg.dim, device),
        "norm_context": layer_norm_init(cfg.dim, device),
        "attn": attention_init(gen, attn_cfg, device),
    }


def prenorm_ff_init(gen, cfg: Alphafold2Config, device):
    return {
        "norm": layer_norm_init(cfg.dim, device),
        "ff": feed_forward_init(gen, cfg.dim, device),
    }


def prenorm_axial_apply(params, attn_cfg, x, **kwargs):
    return axial_attention_apply(
        params["attn"], attn_cfg, layer_norm(params["norm"], x), **kwargs
    )


def prenorm_cross_apply(params, attn_cfg, x, context, **kwargs):
    return attention_apply(
        params["attn"], attn_cfg, layer_norm(params["norm"], x),
        context=layer_norm(params["norm_context"], context), **kwargs,
    )


def prenorm_ff_apply(params, cfg: Alphafold2Config, x, rng=None):
    return feed_forward_apply(
        params["ff"], layer_norm(params["norm"], x),
        dropout_rate=cfg.ff_dropout, rng=rng, dtype=cfg.dtype,
        chunk=cfg.ff_chunk_size,
    )


def make_sparse_axial_fn(cfg: Alphafold2Config):
    """The inner-attention override that runs an axial pass block-sparse
    (`sparse_attention_apply`), for the pair passes of the layers flagged
    in cfg.layer_sparse. Self-attention only, and never tied rows."""
    attn_cfg = cfg.self_attn_config()
    scfg = cfg.sparse_config()

    def fn(params, x, *, axis, mask, tie_dim, rng, **ctx):
        del axis
        if ctx:
            raise ValueError("sparse attention is self-attention only")
        if tie_dim is not None:
            raise ValueError("sparse attention is incompatible with tied-row attention")
        return sparse_attention_apply(params, attn_cfg, scfg, x, mask=mask, rng=rng)

    return fn


# --- cross-attention over grids: flat vs column-aligned ---------------------


def _fold_by_msa_column(x, m, x_mask, msa_mask):
    """Group pair-grid columns by the MSA column they map to.

    Pair grid (b, n, n, d) with n = f*c; MSA (b, r, c, d). Returns
    xg (b*c, n*f, d), mg (b*c, r, d), their folded masks (or None) and f."""
    b, n, n2, d = x.shape
    r, c = m.shape[1], m.shape[2]
    if n != n2 or n % c != 0:
        raise ValueError(
            f"aligned cross-attention needs a square pair grid whose side is "
            f"a multiple of the MSA column count; got pair ({n}, {n2}), "
            f"msa cols {c}"
        )
    f = n // c
    xg = x.reshape(b, n, c, f, d).permute(0, 2, 1, 3, 4).reshape(b * c, n * f, d)
    mg = m.transpose(1, 2).reshape(b * c, r, d)
    xg_mask = None if x_mask is None else (
        x_mask.reshape(b, n, c, f).permute(0, 2, 1, 3).reshape(b * c, n * f)
    )
    mg_mask = None if msa_mask is None else msa_mask.transpose(1, 2).reshape(b * c, r)
    return xg, mg, xg_mask, mg_mask, f


def _unfold_pair(xg, b, n, f, d):
    c = xg.shape[0] // b
    return xg.reshape(b, c, n, f, d).permute(0, 2, 1, 3, 4).reshape(b, n, n, d)


def _unfold_msa(mg, b, r, d):
    c = mg.shape[0] // b
    return mg.reshape(b, c, r, d).transpose(1, 2)


def cross_apply_grids(params, cfg: Alphafold2Config, q_grid, ctx_grid, q_mask,
                      ctx_mask, direction, rng=None):
    """Pre-norm cross-attention between the pair and MSA streams.

    direction: "pair_from_msa" (q_grid = pair, ctx = MSA) or
    "msa_from_pair". cfg.cross_attn_mode "flat" flattens both streams and
    every query attends every context token; "aligned" attends within the
    MSA column each pair-grid column maps to. Returns the attention output
    in the query grid's layout (pre-residual)."""
    cross_cfg = cfg.cross_attn_config()
    if cfg.cross_attn_mode == "flat":
        qb, d = q_grid.shape[0], q_grid.shape[-1]
        out = prenorm_cross_apply(
            params, cross_cfg, q_grid.reshape(qb, -1, d),
            ctx_grid.reshape(qb, -1, d),
            mask=None if q_mask is None else q_mask.reshape(qb, -1),
            context_mask=None if ctx_mask is None else ctx_mask.reshape(qb, -1),
            rng=rng,
        )
        return out.reshape(q_grid.shape)

    b, d = q_grid.shape[0], q_grid.shape[-1]
    if direction == "pair_from_msa":
        x, m = q_grid, ctx_grid
        xg, mg, xg_mask, mg_mask, f = _fold_by_msa_column(x, m, q_mask, ctx_mask)
        out = prenorm_cross_apply(params, cross_cfg, xg, mg, mask=xg_mask,
                                  context_mask=mg_mask, rng=rng)
        return _unfold_pair(out, b, x.shape[1], f, d)
    if direction == "msa_from_pair":
        m, x = q_grid, ctx_grid
        xg, mg, xg_mask, mg_mask, f = _fold_by_msa_column(x, m, ctx_mask, q_mask)
        out = prenorm_cross_apply(params, cross_cfg, mg, xg, mask=mg_mask,
                                  context_mask=xg_mask, rng=rng)
        return _unfold_msa(out, b, m.shape[1], d)
    raise ValueError(f"unknown cross direction {direction!r}")


# --- trunk layer ------------------------------------------------------------


def trunk_layer_init(gen, cfg: Alphafold2Config, device):
    """One sequential trunk layer's params (six blocks)."""
    self_cfg = cfg.self_attn_config()
    cross_cfg = cfg.cross_attn_config()
    return {
        "seq_attn": prenorm_axial_init(gen, cfg, self_cfg, device),
        "msa_attn": prenorm_axial_init(gen, cfg, self_cfg, device),
        "seq_cross": prenorm_cross_init(gen, cfg, cross_cfg, device),
        "msa_cross": prenorm_cross_init(gen, cfg, cross_cfg, device),
        "seq_ff": prenorm_ff_init(gen, cfg, device),
        "msa_ff": prenorm_ff_init(gen, cfg, device),
    }


def trunk_layer_apply(layer, cfg: Alphafold2Config, x, m, *, x_mask=None,
                      msa_mask=None, rng=None, sparse_fn=None):
    """ONE sequential trunk layer in the reference op order. rng: a
    generator on x's device that every op's dropout draws from in turn
    (None: eval mode). sparse_fn: the block-sparse inner attention of the
    pair axial passes (`make_sparse_axial_fn`), None for dense; the MSA
    passes stay dense."""
    self_cfg = cfg.self_attn_config()
    x = prenorm_axial_apply(layer["seq_attn"], self_cfg, x, mask=x_mask, rng=rng,
                            attention_fn=sparse_fn) + x
    if m is not None:
        m = prenorm_axial_apply(
            layer["msa_attn"], self_cfg, m, mask=msa_mask,
            tie_row=cfg.msa_tie_row_attn, rng=rng,
        ) + m
        x = cross_apply_grids(layer["seq_cross"], cfg, x, m, x_mask, msa_mask,
                              "pair_from_msa", rng) + x
        m = cross_apply_grids(layer["msa_cross"], cfg, m, x, msa_mask, x_mask,
                              "msa_from_pair", rng) + m
    x = prenorm_ff_apply(layer["seq_ff"], cfg, x, rng) + x
    if m is not None:
        m = prenorm_ff_apply(layer["msa_ff"], cfg, m, rng) + m
    return x, m


def sequential_trunk_apply(layers, cfg: Alphafold2Config, x, m, *, x_mask=None,
                           msa_mask=None, rng=None):
    """Run the sequential trunk: x (b, n, n, d), m (b, rows, cols, d) or
    None; masks (b, n, n) / (b, rows, cols) bool. `scan_layers` computes the
    same layers in the same order, so both settings run this loop.

    rng: an optional CPU generator for dropout. Each layer draws one seed
    from it and its ops draw their masks from a generator on x's device
    seeded with it, so a layer that `remat` recomputes draws the same
    masks again. A layer flagged in cfg.layer_sparse runs its pair axial
    passes block-sparse."""
    layer_sparse = cfg.layer_sparse
    sparse_fn = make_sparse_axial_fn(cfg) if any(layer_sparse) else None
    for index, layer in enumerate(layers):
        seed = None if rng is None else int(torch.randint(2 ** 62, (), generator=rng))
        layer_fn = sparse_fn if layer_sparse[index] else None

        def run(x, m, layer=layer, seed=seed, layer_fn=layer_fn):
            gen = None if seed is None else torch.Generator(x.device).manual_seed(seed)
            return trunk_layer_apply(layer, cfg, x, m, x_mask=x_mask,
                                     msa_mask=msa_mask, rng=gen, sparse_fn=layer_fn)

        if cfg.remat:
            x, m = checkpoint(run, x, m, use_reentrant=False)
        else:
            x, m = run(x, m)
    return x, m
