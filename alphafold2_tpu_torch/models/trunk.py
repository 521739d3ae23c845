"""The dual-track trunk (counterpart of alphafold2_tpu/models/trunk.py).

Both streams keep their grid layouts — pair (b, i, j, d), MSA
(b, rows, cols, d) — and only the cross-attention flattens. Layers flagged
in `cfg.layer_sparse` run their pair axial passes block-sparse. Per layer,
every op residual: pair axial self-attn -> MSA axial self-attn (optionally
tied rows) -> pair<-MSA cross-attn -> MSA<-pair cross-attn -> pair FF ->
MSA FF. The MSA branch is skipped when there is no MSA stream.

`cfg.trunk_schedule="branch_parallel"` (`branch_parallel_layer_apply`)
runs the same ops, issued in the same order: the pair track and the MSA
track are independent branches that meet only at the cross-attention
exchange. On CUDA the MSA branch runs on a side stream (`side_stream`,
one a device), forked from the current stream before each branch region
and joined back before the exchange and at the layer's end: the CUDA
counterpart of JAX's `schedule_join` / `schedule_fork` barriers, which
only let XLA schedule the branches together. On the CPU the ops run in
turn, so the schedule is the serial one there.

`cfg.remat` recomputes each layer in the backward pass instead of keeping
its activations (`torch.utils.checkpoint`, the `jax.checkpoint` of the JAX
trunk): the same math, so the forward kernels launch twice per layer.
`cfg.remat_policy` saves some products through the recompute (selective
checkpointing, `REMAT_SAVES`), as JAX's `checkpoint_policies` save
`dot_general` outputs: "dots" (`dots_saveable`) every matrix product,
"dots_no_batch" (`dots_with_no_batch_dims_saveable`) the unbatched ones,
the dense layers. The flash and sparse kernels are autograd Functions,
not products: they are recomputed, as the Pallas calls are under JAX's
policies.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

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
from alphafold2_tpu_torch.utils.rng import as_key

_aten = torch.ops.aten
# the ATen products each remat_policy saves: the dense layers run as mm /
# addmm (a batch-free dot_general in JAX), the attention einsums as bmm /
# baddbmm (dot_generals with batch dimensions)
REMAT_SAVES = {
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def _save_products(saved, ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def remat_context_fn(policy):
    """`checkpoint`'s context_fn for a remat_policy: none for None (the
    whole layer is recomputed), else selective checkpointing that saves
    the policy's products (`REMAT_SAVES`)."""
    if policy is None:
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_save_products, REMAT_SAVES[policy]))


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


# --- the branch-parallel schedule ------------------------------------------

_SIDE_STREAMS = {}  # CUDA device index -> the schedule's side stream


# The side stream's priority. `torch.cuda.Stream()` hands out the streams
# of a fixed pool a priority in turn, so a stream made later at the
# default priority (a capture's or a warm-up's) can be the side stream
# itself; no other stream of the port is made at this one.
SIDE_PRIORITY = -1


def side_stream(device) -> "torch.cuda.Stream":
    """The branch-parallel schedule's side stream on a CUDA device, made at
    its first use and kept (one a device), at `SIDE_PRIORITY`. A capture's
    eager warm-up makes it before the capture begins."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    stream = _SIDE_STREAMS.get(index)
    if stream is None:
        try:
            stream = torch.cuda.Stream(device=index, priority=SIDE_PRIORITY)
        except RuntimeError as e:
            raise RuntimeError(
                f"trunk_schedule='branch_parallel': could not make the side stream "
                f"on cuda:{index}: {e}"
            ) from e
        _SIDE_STREAMS[index] = stream
    return stream


def branch_streams(device, main_stream=None):
    """(main, side): the stream a branch-parallel region's pair branch runs
    on (`main_stream`, default the current stream) and the device's side
    stream. Raises if they are one stream."""
    main = main_stream if main_stream is not None else torch.cuda.current_stream(device)
    side = side_stream(device)
    if main == side:
        raise RuntimeError("trunk_schedule='branch_parallel': the main stream is the "
                           "side stream; the MSA branch would run on the pair branch's")
    return main, side


def _record_use(t, stream):
    """Mark t's memory as used by `stream`, so the caching allocator does
    not hand it out again before the stream's work so far is done (a
    tensor autograd saved is freed during the backward pass, while the
    other stream may still read it). Through a fresh alias of t's storage:
    `record_stream`'s schema marks its argument as written, and t's own
    version must not move under autograd."""
    alias = torch.empty(0, dtype=t.dtype, device=t.device).set_(t.untyped_storage())
    alias.record_stream(stream)


def _fork(main, side, *tensors):
    """Start a branch region: the side stream waits for the work issued on
    `main` so far, and reads `tensors` (made on main, or on side by the
    last region)."""
    side.wait_stream(main)
    for t in tensors:
        _record_use(t, side)


def _join(main, side, *tensors):
    """End a branch region: `main` waits for the side stream, and reads
    `tensors` (made on side)."""
    main.wait_stream(side)
    for t in tensors:
        _record_use(t, main)


def _layer_ops(layer, cfg: Alphafold2Config, x_mask, msa_mask, rng, sparse_fn):
    """One trunk layer's residual ops, as functions of the streams they
    update: (pair_attn, msa_attn, exchange, pair_ff, msa_ff). Both
    schedules call them in this order, so each op's dropout draws from rng
    in the same turn (rng: a generator on x's device, None: eval mode)."""
    self_cfg = cfg.self_attn_config()

    def pair_attn(x):
        return prenorm_axial_apply(layer["seq_attn"], self_cfg, x, mask=x_mask, rng=rng,
                                   attention_fn=sparse_fn) + x

    def msa_attn(m):
        return prenorm_axial_apply(layer["msa_attn"], self_cfg, m, mask=msa_mask,
                                   tie_row=cfg.msa_tie_row_attn, rng=rng) + m

    def exchange(x, m):
        # msa<-pair reads the updated pair stream
        x = cross_apply_grids(layer["seq_cross"], cfg, x, m, x_mask, msa_mask,
                              "pair_from_msa", rng) + x
        m = cross_apply_grids(layer["msa_cross"], cfg, m, x, msa_mask, x_mask,
                              "msa_from_pair", rng) + m
        return x, m

    def pair_ff(x):
        return prenorm_ff_apply(layer["seq_ff"], cfg, x, rng) + x

    def msa_ff(m):
        return prenorm_ff_apply(layer["msa_ff"], cfg, m, rng) + m

    return pair_attn, msa_attn, exchange, pair_ff, msa_ff


def _serial(ops, x, m):
    pair_attn, msa_attn, exchange, pair_ff, msa_ff = ops
    x = pair_attn(x)
    if m is not None:
        x, m = exchange(x, msa_attn(m))
    x = pair_ff(x)
    return x, None if m is None else msa_ff(m)


def branch_parallel_layer_apply(layer, cfg: Alphafold2Config, x, m, *, x_mask=None,
                                msa_mask=None, rng=None, sparse_fn=None,
                                main_stream=None):
    """ONE trunk layer under the branch-parallel schedule (JAX
    `branch_parallel_layer_apply`): the serial layer's six residual ops,
    issued in the serial order, grouped into branches:

        pair branch: x += pair_self_attn(x)  |  MSA branch: m += msa_self_attn(m)
        join; the exchange: x += cross(x, m); m += cross(m, x)
        pair branch: x += pair_ff(x)         |  MSA branch: m += msa_ff(m)
        join

    On CUDA the pair branch runs on `main_stream` (default: the current
    stream) and the MSA branch on `side_stream`; under a CUDA graph capture
    the fork and join become parallel branches of the graph, and under
    autograd each backward op runs on its forward op's stream.
    `sequential_trunk_apply` passes the stream of the forward, so that a
    `remat` recompute, which starts on whichever stream the backward op
    needing it runs on, issues each branch on the stream its backward ops
    read from. Elsewhere the ops run in turn. Needs an MSA stream (m)."""
    ops = _layer_ops(layer, cfg, x_mask, msa_mask, rng, sparse_fn)
    if x.device.type != "cuda":
        return _serial(ops, x, m)
    pair_attn, msa_attn, exchange, pair_ff, msa_ff = ops
    main, side = branch_streams(x.device, main_stream)
    with torch.cuda.stream(main):
        _fork(main, side, m)
        x = pair_attn(x)
        with torch.cuda.stream(side):
            m = msa_attn(m)
        _join(main, side, m)
        x, m = exchange(x, m)
        _fork(main, side, m)
        x = pair_ff(x)
        with torch.cuda.stream(side):
            m = msa_ff(m)
        _join(main, side, m)
    return x, m


# --- trunk layer ------------------------------------------------------------


def trunk_layer_init(gen, cfg: Alphafold2Config, device, *, reversible: bool = False):
    """One trunk layer's params: six blocks for a sequential layer, eight
    for a reversible one, which adds a second feed-forward to each stream
    (`seq_ff2`, `msa_ff2`, drawn after the six, so the six keep the numbers
    a sequential layer draws)."""
    self_cfg = cfg.self_attn_config()
    cross_cfg = cfg.cross_attn_config()
    params = {
        "seq_attn": prenorm_axial_init(gen, cfg, self_cfg, device),
        "msa_attn": prenorm_axial_init(gen, cfg, self_cfg, device),
        "seq_cross": prenorm_cross_init(gen, cfg, cross_cfg, device),
        "msa_cross": prenorm_cross_init(gen, cfg, cross_cfg, device),
        "seq_ff": prenorm_ff_init(gen, cfg, device),
        "msa_ff": prenorm_ff_init(gen, cfg, device),
    }
    if reversible:
        params["seq_ff2"] = prenorm_ff_init(gen, cfg, device)
        params["msa_ff2"] = prenorm_ff_init(gen, cfg, device)
    return params


def trunk_layer_apply(layer, cfg: Alphafold2Config, x, m, *, x_mask=None,
                      msa_mask=None, rng=None, sparse_fn=None, main_stream=None):
    """ONE sequential trunk layer in the reference op order. rng: a
    generator on x's device that every op's dropout draws from in turn
    (None: eval mode). sparse_fn: the block-sparse inner attention of the
    pair axial passes (`make_sparse_axial_fn`), None for dense; the MSA
    passes stay dense. Under cfg.trunk_schedule="branch_parallel" a layer
    with an MSA stream runs `branch_parallel_layer_apply` (main_stream is
    its argument); a layer without one has a single track and runs
    serially, as in JAX."""
    if cfg.trunk_schedule == "branch_parallel" and m is not None:
        return branch_parallel_layer_apply(layer, cfg, x, m, x_mask=x_mask,
                                           msa_mask=msa_mask, rng=rng,
                                           sparse_fn=sparse_fn, main_stream=main_stream)
    return _serial(_layer_ops(layer, cfg, x_mask, msa_mask, rng, sparse_fn), x, m)


def dropout_live(cfg: Alphafold2Config, rng) -> bool:
    """Whether a forward draws dropout masks: a rate above 0 and an rng."""
    return rng is not None and (cfg.attn_dropout > 0.0 or cfg.ff_dropout > 0.0)


def sequential_trunk_apply(layers, cfg: Alphafold2Config, x, m, *, x_mask=None,
                           msa_mask=None, rng=None):
    """Run the sequential trunk: x (b, n, n, d), m (b, rows, cols, d) or
    None; masks (b, n, n) / (b, rows, cols) bool. `scan_layers` computes the
    same layers in the same order, so both settings run this loop.

    rng: dropout's position (`utils/rng.py` Key, or a CPU generator that
    seeds new streams; None: eval mode). Layer i draws its masks from the
    generator of position rng.fold_in("trunk", i), its ops in turn; a layer
    that `remat` recomputes takes that position's next pass, seeded alike,
    so the recompute draws the forward's masks under every remat_policy.
    A layer flagged in cfg.layer_sparse runs its pair axial passes
    block-sparse."""
    layer_sparse = cfg.layer_sparse
    sparse_fn = make_sparse_axial_fn(cfg) if any(layer_sparse) else None
    context_fn = remat_context_fn(cfg.remat_policy)
    key = as_key(rng, x.device) if dropout_live(cfg, rng) else None
    # the forward's stream, where a branch-parallel layer's recompute issues
    # its pair branch (branch_parallel_layer_apply)
    main = torch.cuda.current_stream(x.device) if x.device.type == "cuda" else None
    for index, layer in enumerate(layers):
        layer_key = None if key is None else key.fold_in("trunk", index)
        layer_fn = sparse_fn if layer_sparse[index] else None

        def run(x, m, layer=layer, layer_key=layer_key, layer_fn=layer_fn):
            gen = None if layer_key is None else layer_key.generator()
            return trunk_layer_apply(layer, cfg, x, m, x_mask=x_mask,
                                     msa_mask=msa_mask, rng=gen, sparse_fn=layer_fn,
                                     main_stream=main)

        if cfg.remat:
            x, m = checkpoint(run, x, m, use_reentrant=False, context_fn=context_fn)
        else:
            x, m = run(x, m)
    return x, m
