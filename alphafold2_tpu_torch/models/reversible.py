"""The reversible dual-stream trunk: activation memory that does not grow
with depth (counterpart of alphafold2_tpu/models/reversible.py).

Both streams are channel-doubled on entry, (x, x, m, m), and the halves
averaged on exit. Each layer is a self block (f = pair axial attention, g
= pair FF, j = MSA axial attention, k = MSA FF) and then a cross block (f
= pair<-MSA cross, g = pair FF, j = MSA<-pair cross on the UPDATED pair
half z2, k = MSA FF); every block is an additive coupling, so a layer's
input is rebuilt from its output (x2 = y2 - g(y1), ...). A reversible
layer carries eight blocks (`trunk_layer_init(..., reversible=True)`).

`_ReversibleCore` is the `torch.autograd.Function` of JAX's
`_reversible_core` custom vjp. Its forward runs every layer without a
graph and saves only the final state (z1, z2, o1, o2), the masks and the
parameters, whatever the depth. Its backward walks the layers in reverse:
each block is recomputed on detached inputs that require grad, under
`torch.enable_grad()`, and `torch.autograd.grad` gives that block's input
and parameter cotangents; its graph is freed before the next block. The
block's output also rebuilds the block's input. The parameters are explicit
inputs of the Function: every leaf of every layer, layer by layer, in the
layer dict's order (`param_leaves`), and the backward returns their gradients
in that order, so `torch.autograd.grad` and the train step's `.grad`
buffers both take them. On CUDA each recomputed attention reaches its
kernel, as the forward's does (ops/dispatch.py).

`reverse=False` computes the same function through plain autograd (every
layer's activations kept): the oracle of the parity tests, as in JAX.

Sparse layers: a layer flagged in `cfg.layer_sparse` runs its pair axial
attention block-sparse (`make_sparse_axial_fn`). JAX chains one custom-vjp
scan a run of equal flags, since a scanned body is specialised on its
flag; the port's Function loops over the layers in Python and hands each
its own attention, so one Function over all layers computes the chained
segments' function.

Dropout: JAX derives eight op keys a layer from `fold_in(rng, layer)` and
derives them again in the backward. Here each block is a position of its
own, rng.fold_in("trunk", layer, block) (`block_keys`, utils/rng.py), and
draws its masks from that position's generator: the forward takes its
first pass, the backward's recompute the second, seeded alike, so the
backward draws the forward's masks although it walks the blocks in
reverse (one generator shared in turn would replay them in the wrong
order). Inside a captured train step these generators are registered with
the graph (training/executable.py). The masks cannot equal JAX's: the
parity tests with JAX run without dropout.

The blocks are data (`COUPLINGS`: target = residual + block(*reads)), and
so is their grouping onto streams (`SCHEDULE`): one interpreter runs the
forward (`_layer_forward`) and one the inversion (`_layer_backward`, which
`reconstruct_input` walks too). Under `trunk_schedule="branch_parallel"`
on CUDA the self block's MSA half (j, k) runs on models/trunk.py's side
stream, the pair half (f, g) and the cross block on the current stream,
in the forward and in the inversion alike; each region forks from the
current stream and joins back before the cross block (JAX's
`schedule_join`). Every tensor that crosses is marked used by the stream
that reads it (`_fork` / `_join`): the forward's m1, m2 and n1, n2; the
inversion's n1, n2 and their cotangents one way, m1, m2, their
cotangents and the MSA blocks' parameter cotangents the other. Each
recomputed block builds its graph and takes `torch.autograd.grad` inside
its stream's context, so its vjp runs there. The same ops run in the
same arithmetic as "serial": the result is bit for bit serial's. On the
CPU the regions run in turn.

The reconstruction is exact in exact arithmetic only: in bfloat16 the
rebuilt inputs differ from the forward's by rounding, in JAX too
(`reconstruct_input` reports how far).
"""

from __future__ import annotations

import torch

from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.trunk import (
    _fork,
    _join,
    branch_streams,
    cross_apply_grids,
    dropout_live,
    make_sparse_axial_fn,
    prenorm_axial_apply,
    prenorm_ff_apply,
    trunk_layer_init,
)
from alphafold2_tpu_torch.utils.rng import as_key

# a reversible layer's blocks in JAX's op order (its per-layer dropout keys
# r_fs, r_gs, r_js, r_ks, r_fc, r_gc, r_jc, r_kc, and the port's
# positions), each an additive coupling: (block, target, residual, reads)
# for target = residual + block(*reads)
COUPLINGS = (
    # the self block: f = pair axial attention, g = pair FF, j = MSA axial
    # attention, k = MSA FF
    ("seq_attn", "y1", "x1", ("x2",)),
    ("seq_ff", "y2", "x2", ("y1",)),
    ("msa_attn", "n1", "m1", ("m2",)),
    ("msa_ff", "n2", "m2", ("n1",)),
    # the cross block; the MSA cross attends the UPDATED pair half z2
    ("seq_cross", "z1", "y1", ("y2", "n2")),
    ("seq_ff2", "z2", "y2", ("z1",)),
    ("msa_cross", "o1", "n1", ("n2", "z2")),
    ("msa_ff2", "o2", "n2", ("o1",)),
)
BLOCKS = tuple(c[0] for c in COUPLINGS)
COUPLING = {c[0]: c[1:] for c in COUPLINGS}
LAYER_IN, LAYER_OUT = ("x1", "x2", "m1", "m2"), ("z1", "z2", "o1", "o2")

# a layer's regions in forward order, each (main-stream blocks, side-stream
# blocks). The self block's pair half and MSA half touch only their own
# stream: under branch_parallel on CUDA the MSA half runs on the side
# stream (JAX joins the halves, `schedule_join`, before the cross block),
# in the forward and in the inversion. Elsewhere, and in a region without
# side blocks, the main blocks run, then the side blocks.
SCHEDULE = (
    (("seq_attn", "seq_ff"), ("msa_attn", "msa_ff")),
    (("seq_cross", "seq_ff2", "msa_cross", "msa_ff2"), ()),
)


def branch_io(blocks):
    """(inputs, outputs) of a run of blocks in forward order: the tensors
    it reads that it did not make before, and the tensors it makes."""
    ins, made = [], []
    for name in blocks:
        target, residual, reads = COUPLING[name]
        ins += [k for k in (residual, *reads) if k not in made and k not in ins]
        made.append(target)
    return tuple(ins), tuple(made)


def layer_streams(cfg: Alphafold2Config, t):
    """(main, side) streams for a layer under branch_parallel on CUDA (main:
    the current stream; models/trunk.py `branch_streams`), else None (the
    regions run in turn)."""
    if cfg.trunk_schedule != "branch_parallel" or t.device.type != "cuda":
        return None
    return branch_streams(t.device)


def reversible_trunk_init(gen, cfg: Alphafold2Config, device):
    """The reversible trunk's params: a list of cfg.depth eight-block
    layer dicts (JAX stacks them along a leading depth axis;
    models/convert.py maps one layout onto the other)."""
    return [trunk_layer_init(gen, cfg, device, reversible=True) for _ in range(cfg.depth)]


# --- the four block functions ------------------------------------------------


def _f_seq(cfg, params, x2, x_mask, gen, sparse_fn):
    # the pair axial self-attention, block-sparse on a flagged layer
    return prenorm_axial_apply(params, cfg.self_attn_config(), x2, mask=x_mask, rng=gen,
                               attention_fn=sparse_fn)


def _j_msa(cfg, params, m2, msa_mask, gen):
    # the MSA axial self-attention, optionally with tied rows
    return prenorm_axial_apply(params, cfg.self_attn_config(), m2, mask=msa_mask,
                               tie_row=cfg.msa_tie_row_attn, rng=gen)


def _ff(cfg, params, t, gen):
    return prenorm_ff_apply(params, cfg, t, gen)


def _cross(cfg, params, q_grid, ctx_grid, q_mask, ctx_mask, gen, direction):
    # flat or column-aligned per cfg.cross_attn_mode, optionally KV-compressed
    return cross_apply_grids(params, cfg, q_grid, ctx_grid, q_mask, ctx_mask, direction, gen)


def block_keys(cfg: Alphafold2Config, rng, depth: int, device):
    """Each layer's eight block positions (`BLOCKS` order),
    rng.fold_in("trunk", layer, block); None for each without live dropout
    (eval mode). rng: a Key, a CPU generator (new streams on `device`) or
    None."""
    key = as_key(rng, device) if dropout_live(cfg, rng) else None
    return [[None if key is None else key.fold_in("trunk", i, name) for name in BLOCKS]
            for i in range(depth)]


def _block_fns(cfg, x_mask, msa_mask, keys, sparse_fn):
    """One layer's eight blocks as functions of their params and the
    stream halves they read, each drawing from its position's next pass
    (`BLOCKS` order)."""
    g = [None if k is None else k.generator() for k in keys]
    return {
        "seq_attn": lambda p, x2: _f_seq(cfg, p, x2, x_mask, g[0], sparse_fn),
        "seq_ff": lambda p, y1: _ff(cfg, p, y1, g[1]),
        "msa_attn": lambda p, m2: _j_msa(cfg, p, m2, msa_mask, g[2]),
        "msa_ff": lambda p, n1: _ff(cfg, p, n1, g[3]),
        "seq_cross": lambda p, y2, n2: _cross(cfg, p, y2, n2, x_mask, msa_mask, g[4],
                                              "pair_from_msa"),
        "seq_ff2": lambda p, z1: _ff(cfg, p, z1, g[5]),
        "msa_cross": lambda p, n2, z2: _cross(cfg, p, n2, z2, msa_mask, x_mask, g[6],
                                              "msa_from_pair"),
        "msa_ff2": lambda p, o1: _ff(cfg, p, o1, g[7]),
    }


# --- one layer forward and backward -----------------------------------------


def _layer_forward(cfg, layer, state, x_mask, msa_mask, keys, sparse_fn, streams=None):
    """One layer on (x1, x2, m1, m2): (z1, z2, o1, o2). streams: (main,
    side) to run each region's side blocks on side (`layer_streams`)."""
    env = dict(zip(LAYER_IN, state))
    b = _block_fns(cfg, x_mask, msa_mask, keys, sparse_fn)

    def run(names):
        for name in names:
            target, residual, reads = COUPLING[name]
            env[target] = env[residual] + b[name](layer[name], *(env[k] for k in reads))

    for main_blocks, side_blocks in SCHEDULE:
        if streams is None or not side_blocks:
            run(main_blocks + side_blocks)
            continue
        main, side = streams
        ins, outs = branch_io(side_blocks)
        _fork(main, side, *(env[k] for k in ins))
        run(main_blocks)
        with torch.cuda.stream(side):
            run(side_blocks)
        _join(main, side, *(env[k] for k in outs))
    return tuple(env[k] for k in LAYER_OUT)


def param_leaves(tree):
    """A param tree's tensors in dict order: the Function's input order."""
    return list(tree_leaves(tree))


def _rebuild(tree, it):
    """`tree`'s structure with its leaves taken from the iterator `it`."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _recompute(fn, params, inputs, ct, param_grads):
    """fn(params, *inputs) recomputed under enable_grad on detached inputs
    that require grad and on detached aliases of the block's param leaves
    (requiring grad with param_grads, where the leaf does), then
    `torch.autograd.grad` of the output against them, with cotangent `ct`.
    The aliases keep the recompute's graph off the leaves' own nodes,
    which belong to the forward's stream: a vjp on the side stream that
    reached them would make autograd join the streams there. Returns (the
    output without a graph, input cotangents, param cotangents in
    `param_leaves` order or None)."""
    ins = [t.detach().requires_grad_(True) for t in inputs]
    leaves = param_leaves(params)
    alias = [p.detach().requires_grad_(param_grads and p.requires_grad) for p in leaves]
    with torch.enable_grad():
        out = fn(_rebuild(params, iter(alias)), *ins)
        wrt = ins + [a for a in alias if a.requires_grad]
        grads = torch.autograd.grad(out, wrt, ct, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(wrt, grads)]
    d_in, d_wrt = grads[:len(ins)], iter(grads[len(ins):])
    d_params = [next(d_wrt) if a.requires_grad else None for a in alias] if param_grads else None
    return out.detach(), d_in, d_params


def _accumulate(d, key, g):
    d[key] = g if key not in d else d[key] + g


def _layer_backward(cfg, layer, state, cts, x_mask, msa_mask, keys, sparse_fn,
                    param_grads=True, streams=None):
    """Invert one layer from its output `state` and carry the cotangents
    `cts` back through it (JAX `_layer_backward`): the cross block (k, j,
    g, f; the z2 coupling's cotangent added before g's vjp), then the self
    block (the pair half g, f; the MSA half k, j). streams: (main, side) to
    invert the MSA half on side (`layer_streams`). Returns (the layer's
    input, its cotangents, {block: param cotangents in `param_leaves`
    order, or None without param_grads})."""
    env, d = dict(zip(LAYER_OUT, state)), dict(zip(LAYER_OUT, cts))
    b = _block_fns(cfg, x_mask, msa_mask, keys, sparse_fn)
    dp = {}

    def invert(names):
        # each coupling in reverse: the block recomputed on its reads
        # rebuilds its residual (target - block), the residual takes the
        # target's cotangent and the block's vjp adds to the reads'
        for name in reversed(names):
            target, residual, reads = COUPLING[name]
            out, d_in, dp[name] = _recompute(b[name], layer[name], [env[k] for k in reads],
                                             d[target], param_grads)
            env[residual] = env[target] - out
            _accumulate(d, residual, d[target])
            for k, g in zip(reads, d_in):
                _accumulate(d, k, g)

    for main_blocks, side_blocks in reversed(SCHEDULE):
        if streams is None or not side_blocks:
            invert(main_blocks)
            invert(side_blocks)
            continue
        main, side = streams
        ins, outs = branch_io(side_blocks)
        _fork(main, side, *(env[k] for k in outs), *(d[k] for k in outs))
        invert(main_blocks)
        with torch.cuda.stream(side):
            invert(side_blocks)
        _join(main, side, *(env[k] for k in ins), *(d[k] for k in ins),
              *(g for name in side_blocks for g in (dp[name] or ()) if g is not None))
    return tuple(env[k] for k in LAYER_IN), tuple(d[k] for k in LAYER_IN), dp


def _sparse_fns(cfg: Alphafold2Config, depth: int):
    flags = cfg.layer_sparse
    fn = make_sparse_axial_fn(cfg) if any(flags) else None
    return [fn if flags[i] else None for i in range(depth)]


def forward_state(layers, cfg: Alphafold2Config, state, *, x_mask=None, msa_mask=None,
                  keys=None):
    """Every layer in turn on the channel-doubled state (x1, x2, m1, m2):
    the last layer's (z1, z2, o1, o2), with a graph when grad is enabled.
    keys: `block_keys`'s positions (None: eval mode)."""
    layers = list(layers)
    keys = keys if keys is not None else block_keys(cfg, None, len(layers), None)
    streams = layer_streams(cfg, state[0])
    for layer, layer_keys, sparse_fn in zip(layers, keys, _sparse_fns(cfg, len(layers))):
        state = _layer_forward(cfg, layer, state, x_mask, msa_mask, layer_keys, sparse_fn,
                               streams)
    return state


# --- the Function -----------------------------------------------------------


class _ReversibleCore(torch.autograd.Function):
    """(x1, x2, m1, m2) -> the last layer's (z1, z2, o1, o2). Saves only
    the final state, the masks and the parameters: no per-layer
    activation."""

    @staticmethod
    def forward(ctx, meta, x_mask, msa_mask, x1, x2, m1, m2, *leaves):
        cfg, structure, keys = meta
        state = forward_state(_rebuild(structure, iter(leaves)), cfg, (x1, x2, m1, m2),
                              x_mask=x_mask, msa_mask=msa_mask, keys=keys)
        ctx.meta = meta
        ctx.save_for_backward(x_mask, msa_mask, *state, *leaves)
        return state

    @staticmethod
    def backward(ctx, dz1, dz2, do1, do2):
        cfg, structure, keys = ctx.meta
        x_mask, msa_mask, z1, z2, o1, o2, *leaves = ctx.saved_tensors
        layers = _rebuild(structure, iter(leaves))
        sparse_fns = _sparse_fns(cfg, len(layers))
        param_grads = any(ctx.needs_input_grad[7:])
        state, cts = (z1, z2, o1, o2), (dz1, dz2, do1, do2)
        # the backward's stream: each branch region joins back to it, so
        # autograd gets only tensors ready there
        streams = layer_streams(cfg, z1)
        d_layers = [None] * len(layers)
        for index in reversed(range(len(layers))):
            state, cts, dp = _layer_backward(cfg, layers[index], state, cts, x_mask, msa_mask,
                                             keys[index], sparse_fns[index], param_grads,
                                             streams)
            d_layers[index] = dp
        d_leaves = []
        for layer, dp in zip(layers, d_layers):
            for name, block in layer.items():
                d_leaves += (dp[name] if param_grads else [None] * len(param_leaves(block)))
        return (None, None, None, *cts, *d_leaves)


# --- public API -------------------------------------------------------------


def reversible_trunk_apply(layers, cfg: Alphafold2Config, x, m, *, x_mask=None,
                           msa_mask=None, rng=None, reverse: bool = True):
    """Run the reversible trunk.

    layers: the list of eight-block layer dicts (`reversible_trunk_init`).
    x: the pair grid (b, n, n, d); m: the MSA stream (b, rows, cols, d),
    required. x_mask (b, n, n) / msa_mask (b, rows, cols) bool or None.
    rng: dropout's position (a utils/rng.py Key, or a CPU generator that
    seeds new streams; `block_keys`; None: eval mode). reverse: True runs
    `_ReversibleCore` (the backward rebuilds each layer's input); False the
    same function through plain autograd.
    Returns (x, m): the channel-halved streams averaged back to width d."""
    if m is None:
        raise ValueError("the reversible trunk requires an MSA stream "
                         "(reference reversible.py:316)")
    layers = list(layers)
    keys = block_keys(cfg, rng, len(layers), x.device)
    if reverse:
        meta = (cfg, layers, keys)
        z1, z2, o1, o2 = _ReversibleCore.apply(meta, x_mask, msa_mask, x, x, m, m,
                                               *param_leaves(layers))
    else:
        z1, z2, o1, o2 = forward_state(layers, cfg, (x, x, m, m), x_mask=x_mask,
                                       msa_mask=msa_mask, keys=keys)
    return (z1 + z2) * 0.5, (o1 + o2) * 0.5


def reconstruct_input(layers, cfg: Alphafold2Config, state, *, x_mask=None, msa_mask=None,
                      keys=None):
    """The trunk's input state rebuilt from its output `state` (z1, z2, o1,
    o2) by the backward's own inversion, layer by layer in reverse (with
    zero cotangents; no parameter gradients). keys: `block_keys`'s
    positions of the forward (None: eval mode). Against the forward's (x, x, m, m)
    it shows the inversion's rounding (exact in exact arithmetic)."""
    layers = list(layers)
    keys = keys if keys is not None else block_keys(cfg, None, len(layers), None)
    sparse_fns = _sparse_fns(cfg, len(layers))
    streams = layer_streams(cfg, state[0])
    cts = tuple(torch.zeros_like(t) for t in state)
    for index in reversed(range(len(layers))):
        state, cts, _ = _layer_backward(cfg, layers[index], state, cts, x_mask, msa_mask,
                                        keys[index], sparse_fns[index], param_grads=False,
                                        streams=streams)
    return tuple(t.detach() for t in state)
