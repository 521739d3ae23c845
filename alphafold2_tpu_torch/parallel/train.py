"""The data-parallel and the sequence-parallel training steps (counterpart
of alphafold2_tpu/parallel/train.py: `sharded_train_state_init` :35,
`make_sharded_train_step` :60, `make_multihost_train_step` :97,
`sp_model_apply` :303, `sp_distogram_loss_fn` :287, `sp_e2e_loss_fn` :335,
`make_sp_train_step` :526).

Data parallelism. JAX compiles the step over a mesh whose "data" axis
splits the batch; its partitioner inserts the gradient all-reduce, and
the step computes exactly the single-device step's function on the global
batch. The port computes the same function in two forms:

  * `make_sharded_train_step`: one process over a "data" `Mesh`. Each
    microbatch's rows split over the shards, each shard runs its forward
    on its device with the params replicated there (`Mesh.replicate`,
    which keeps the graph back to the one copy), and autograd sums the
    shards' gradients onto the state's device before `step_body`'s one
    update;
  * `make_multihost_train_step`: one process a card, in a pod
    (`parallel/distributed.py`). Each process computes its rows'
    gradients, all-reduces them before the clip and AdamW, and applies the
    same update to the same state, so the processes stay byte-identical.

Three things make the shards' sum the global batch's function:

  * normalisation: the losses are masked means (the distogram's over the
    valid pairs, the structure loss's over structures and over the pairs
    of positive weight), so a mean of the shards' means differs from the
    global mean wherever their counts differ. Each loss gives its terms as
    (numerator, denominator) (`loss_fn.parts`, `training/losses.py
    combine_parts`); the shards' denominators are totalled (summed, or
    all-reduced) after the forward, and each shard's loss divides its
    numerators by those totals before its backward;
  * random draws: each shard's rng streams carry its rows of the global
    batch (`utils/rng.py Streams(rows=)`, and the loss's `rows` for the
    random MDS init without rng), so every dropout mask, the random MDS
    init and the block-sparse kernels' Philox bits (`bh_base`) are this
    shard's rows of the draw the whole batch would make, in the forward
    and in the backward's recomputes (remat, the reversible trunk), on
    whatever thread autograd runs them;
  * clipping: the global norm and the clip act on the summed gradient.

The steps are eager: a CUDA graph of the step with its all-reduce inside
is a lever of ROADMAP "After the ports".

The trunk runs over the single-controller mesh (parallel/mesh.py,
`parallel/sp_trunk.py alphafold2_apply_sp`): the pair grid's rows and the
MSA rows sharded, the embeddings, the head and the loss on the mesh's
first device, where the params, their gradients and AdamW's state lie.
The collectives are `.to` / `cat` / `split`, so autograd carries every
gradient back through them to the one copy of each parameter: the step is
`training/harness.py make_train_step`'s with this loss. Where JAX's
`jax.grad` transposes the shard_map's psum / ppermute / all_to_all, the
port's backward walks the same copies in reverse.

The SP trunk is deterministic: dropout is refused (JAX's message), and
the rng is not read. It has no remat: `trunk_fn` replaces the rematted
trunk (models/alphafold2.py), as in JAX.

On one card (every shard on the state's device) the step captures as a
CUDA graph (`training/executable.py CapturedTrainStep(...,
loss_fn=sp_distogram_loss_fn(mesh))`): the ring's B3 hops forward and
backward, the halo exchange and the merges are launches on that card's
stream. A mesh over distinct cards runs eagerly: a graph captures one
card's stream.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.parallel import distributed
from alphafold2_tpu_torch.parallel.mesh import Mesh, make_mesh, pod_devices
from alphafold2_tpu_torch.parallel.sharding import replicated, state_shardings
from alphafold2_tpu_torch.parallel.sp_trunk import alphafold2_apply_sp
from alphafold2_tpu_torch.training.data import ProcessRows, assemble_global_batch
from alphafold2_tpu_torch.training.e2e import make_e2e_loss_fn
from alphafold2_tpu_torch.training.harness import (
    TrainConfig,
    check_microbatches,
    distogram_loss_fn,
    make_distogram_loss_fn,
    make_train_step,
    train_state_init,
)
from alphafold2_tpu_torch.training.losses import combine_parts
from alphafold2_tpu_torch.utils.rng import Key, Streams, seed_from


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")


def _check_device(mesh: Mesh, device) -> None:
    """The forward's embeddings, its head and the loss run on the mesh's
    first device; a caller that places them elsewhere is refused."""
    if device is not None and resolve_device(device) != mesh.devices[0]:
        raise ValueError(f"the sequence-parallel forward runs its embeddings, head and loss "
                         f"on the mesh's first device {mesh.devices[0]}, not {device}")


def sp_model_apply(mesh: Mesh, axis_name: str = "seq"):
    """An `alphafold2_apply`-signature adapter over the sequence-parallel
    trunk: any consumer of the dense forward (the distogram loss,
    `training/e2e.py predict_structure`, a custom loss) runs with the
    trunk sharded over `mesh`. `device=`, where a caller places the
    forward, must be the mesh's first device (None: that device). The
    embedds stream and dropout are refused with JAX's messages; `rng` is
    not read (the trunk is deterministic)."""
    _check_axis(mesh, axis_name)

    def apply_fn(params, cfg, seq, msa=None, *, mask=None, msa_mask=None, embedds=None,
                 templates=None, templates_mask=None, rng=None, device=None):
        if embedds is not None:
            raise ValueError(
                "the embedds path has no row axis to shard; use the "
                "replicated model for embedds input"
            )
        if cfg.attn_dropout > 0.0 or cfg.ff_dropout > 0.0:
            raise ValueError(
                "the sequence-parallel trunk is deterministic; set "
                "attn_dropout=0 and ff_dropout=0 (or train replicated)"
            )
        _check_device(mesh, device)
        del rng  # deterministic path (sp_trunk_apply contract)
        return alphafold2_apply_sp(params, cfg, seq, msa, mesh, mask=mask, msa_mask=msa_mask,
                                   templates=templates, templates_mask=templates_mask)

    return apply_fn


def sp_distogram_loss_fn(mesh: Mesh, axis_name: str = "seq"):
    """The distogram loss (`training/harness.py make_distogram_loss_fn`)
    with the trunk sequence-parallel over `mesh`: `loss_fn(params, cfg,
    batch, rng=None, device=None)`, device the mesh's first."""
    return make_distogram_loss_fn(sp_model_apply(mesh, axis_name))


def sp_e2e_loss_fn(mesh: Mesh, axis_name: str = "seq"):
    """The full structure loss (`training/e2e.py make_e2e_loss_fn`:
    distogram -> MDS -> side chains -> refiner -> Kabsch RMSD) with the
    trunk sequence-parallel; the geometry and the refiner run on the
    mesh's first device. The mesh size must divide the elongated pair side
    (3L) and the MSA row count."""
    return make_e2e_loss_fn(sp_model_apply(mesh, axis_name))


def make_sp_train_step(cfg, tcfg, mesh: Mesh, *, axis_name: str = "seq",
                       donate_state: bool = True, loss_fn: Optional[Callable[..., Any]] = None,
                       device=None):
    """The eager train step with the trunk sequence-parallel:
    `train_step(state, batch, rng=None) -> (state, metrics)`, as
    `training/harness.py make_train_step` gives it, on the mesh's first
    device (`device`, if given, must be it), where `state` must lie.
    loss_fn defaults to the distogram loss; pass `sp_e2e_loss_fn(mesh)`
    (cfg an E2EConfig) for the structure loss. Batch leaves lead with
    tcfg.grad_accum microbatches; the crop must divide over the mesh.
    `donate_state` is JAX's argument and has no effect: the port's step
    always updates the state in place. On one card,
    `CapturedTrainStep(cfg, tcfg, state, batch, loss_fn=...)` replays this
    step as a CUDA graph."""
    _check_axis(mesh, axis_name)
    del donate_state  # the port's step updates in place
    _check_device(mesh, device)
    return make_train_step(cfg, tcfg, loss_fn or sp_distogram_loss_fn(mesh, axis_name),
                           device=mesh.devices[0])


# --- data parallelism ------------------------------------------------------------


def _loss_parts(loss_fn):
    parts = getattr(loss_fn, "parts", None)
    if parts is None:
        raise ValueError(
            "a data-parallel step totals the loss's denominators over the shards: pass a loss "
            "made by make_distogram_loss_fn or make_e2e_loss_fn (its .parts), such as "
            "distogram_loss_fn or e2e_loss_fn")
    return parts


def _rows(batch: dict) -> int:
    rows = {int(v.shape[1]) for v in batch.values() if getattr(v, "ndim", 0) > 1}
    if len(rows) != 1:
        raise ValueError(f"the batch's leaves disagree on their rows (axis 1): {sorted(rows)}")
    return rows.pop()


def _keys(rng, devices, spans):
    """Each shard's dropout position: one seed, drawn once from rng (a CPU
    generator) or a Key's, and streams of that seed on the shard's device
    carrying its (start, count, total) batch rows `spans[s]` (None: eval
    mode)."""
    if rng is None:
        return [None] * len(devices)
    base = rng if isinstance(rng, Key) else Streams(devices[0], seed_from(rng)).key()
    return [Key(Streams(d, base.streams.seed, rows=span), base.path)
            for d, span in zip(devices, spans)]


def _refuse_tp(tp: bool) -> None:
    if tp:
        raise NotImplementedError(
            "tp=True needs a 'model' mesh axis, which the port's one-axis mesh does not have "
            "(ROADMAP A13-tp); the data-parallel step replicates the state (tp=False)")


def sharded_train_state_init(generator, cfg, tcfg: TrainConfig, mesh: Mesh, *, tp: bool = False,
                             state_init: Callable = train_state_init):
    """The train state from `generator` (a CPU generator) on the mesh's
    first device, where the data-parallel step keeps it, and its
    placements (`parallel/sharding.py state_shardings`: replicated).
    `state_init` defaults to the distogram state; pass
    `training/e2e.py e2e_train_state_init` (cfg an E2EConfig) for the
    structure loss. tp=True is refused (ROADMAP A13-tp)."""
    _refuse_tp(tp)
    state = state_init(cfg, tcfg, generator, mesh.devices[0])
    return state, state_shardings(mesh, state)


def _check_data_mesh(mesh: Mesh) -> None:
    if mesh.axis_name != "data":
        raise ValueError(f"the data-parallel step runs over a 'data' mesh, not "
                         f"{mesh.axis_name!r} (make_sp_train_step shards 'seq')")


def make_sharded_train_step(cfg, tcfg: TrainConfig, mesh: Mesh, example_batch, *,
                            loss_fn: Callable = distogram_loss_fn, tp: bool = False):
    """The data-parallel step over a "data" mesh in one process:
    `train_step(state, batch, rng=None) -> (state, metrics)`, as
    `training/harness.py make_train_step` gives it, the state on the
    mesh's first device. Batch leaves lead with (tcfg.grad_accum, b, ...),
    b a multiple of the mesh size (`example_batch` is checked once); shard
    s runs rows s b / P .. (s + 1) b / P of each microbatch on
    `mesh.devices[s]` (see the module docstring). loss_fn: the distogram
    or the e2e loss (anything with `.parts`). The step updates the state
    in place (JAX's `donate_state`). tp=True is refused (ROADMAP A13-tp).
    Returns (train_step, the state's placement): `replicated(mesh)`, one
    placement for every leaf (a JAX sharding as a pytree prefix)."""
    _check_data_mesh(mesh)
    _refuse_tp(tp)
    parts_fn = _loss_parts(loss_fn)
    if _rows(example_batch) % mesh.size:
        raise ValueError(f"a batch of {_rows(example_batch)} rows does not divide over the "
                         f"{mesh.size} shards of the 'data' mesh")
    home = mesh.devices[0]

    def train_step(state, batch, rng=None):
        check_microbatches(batch, tcfg)
        opt = state["optimizer"]
        opt.set_lr(state["step"])
        total = _rows(batch)
        if total % mesh.size:
            raise ValueError(f"a batch of {total} rows does not divide over {mesh.size} shards")
        per = total // mesh.size
        spans = [(s * per, per, total) for s in range(mesh.size)]
        keys = _keys(rng, mesh.devices, spans)
        grads = [p.grad for p in opt.leaves]
        torch._foreach_zero_(grads)
        n = tcfg.grad_accum
        loss_sum = torch.zeros((), dtype=torch.float32, device=home)
        for index in range(n):
            params = mesh.replicate(state["params"])
            shards = []
            for s, dev in enumerate(mesh.devices):
                mb = {k: torch.as_tensor(v[index][s * per:(s + 1) * per]).to(dev)
                      for k, v in batch.items()}
                key = None if keys[s] is None else keys[s].fold_in(index)
                shards.append(parts_fn(params[s], cfg, mb, key, dev, rows=spans[s]))
            totals = [sum(sh[t][1].detach().to(home) for sh in shards)
                      for t in range(len(shards[0]))]
            for s, dev in enumerate(mesh.devices):
                loss = combine_parts(shards[s], [t.to(dev) for t in totals])
                loss.backward()
                loss_sum += loss.detach().to(home)
            del shards
        torch._foreach_div_(grads, n)
        grad_norm = opt.update()
        state["step"] += 1
        return state, {"loss": loss_sum / n, "grad_norm": grad_norm}

    return train_step, replicated(mesh)


def make_multihost_train_step(cfg, tcfg: TrainConfig, local_example_batch, *, axes=None,
                              loss_fn: Callable = distogram_loss_fn, tp: bool = False,
                              telemetry=None, device=None):
    """The pod's step, one process a card (call after `parallel/
    distributed.py initialize_from_env`): every process calls the step in
    lockstep with its own rows. `local_example_batch` is this process's
    shard, leaves (grad_accum, per-process b, ...); `axes` defaults to
    {"data": world size} and must cover every process (`make_mesh`'s
    guard). The step `train_step(state, batch, rng=None)` takes `assemble
    (local_batch)` (or the local batch itself) and the state on this
    process's card; each microbatch's loss denominators are all-reduced
    after the forward, the gradients (and the loss) after the last
    microbatch, then every process clips and updates alike (see the module
    docstring). Metrics are the global batch's, the same on every process.
    `train_step.reduce_ms()` is the last step's gradient all-reduce in ms
    (CUDA events; None on the CPU). `telemetry`: `assemble` books its wall
    time to the goodput ledger's "assembly" cause. `device`: "cpu" for a
    CPU pod (None: each process's card, `parallel/distributed.py
    pod_device`). Outside a pod the step is the single-process one on the
    global batch. The step updates the state in place (JAX's
    `donate_state`); tp=True is refused (ROADMAP A13-tp). Returns
    (train_step, the state's placement `replicated(mesh)`, assemble,
    mesh); `parallel/sharding.py host_to_global` gives every process
    process 0's state."""
    import torch.distributed as dist

    world, rank = distributed.process_count(), distributed.process_index()
    axes = axes if axes is not None else {"data": world}
    mesh = make_mesh(axes, pod_devices(axes, device) or [resolve_device(device)])
    _check_data_mesh(mesh)
    _refuse_tp(tp)
    parts_fn = _loss_parts(loss_fn)
    global_rows = _rows(local_example_batch) * world
    if global_rows % mesh.size:
        raise ValueError(
            f"global batch {global_rows} (= per-process x {world} processes) must be divisible "
            f"by the mesh's data axis size ({mesh.size} devices)")
    device = mesh.devices[rank]
    reduce = distributed.joined()

    if telemetry is None:
        from alphafold2_tpu_torch.telemetry.goodput import NULL_TRAIN_TELEMETRY

        telemetry = NULL_TRAIN_TELEMETRY

    def assemble(local_batch):
        with telemetry.account("assembly"):
            return assemble_global_batch(local_batch, mesh, microbatched=True)

    events = []

    def all_reduce(t):
        if reduce:
            dist.all_reduce(t)
        return t

    def train_step(state, batch, rng=None):
        check_microbatches(batch, tcfg)
        if not isinstance(batch, ProcessRows):
            batch = assemble(batch)
        opt = state["optimizer"]
        opt.set_lr(state["step"])
        per = _rows(batch)
        span = (batch.start, per, batch.total)
        key = _keys(rng, [device], [span])[0]
        grads = [p.grad for p in opt.leaves]
        torch._foreach_zero_(grads)
        n = tcfg.grad_accum
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for index in range(n):
            mb = {k: v[index] for k, v in batch.items()}
            parts = parts_fn(state["params"], cfg, mb,
                             None if key is None else key.fold_in(index), device, rows=span)
            totals = [all_reduce(den.detach().clone()) for _, den in parts]
            loss = combine_parts(parts, totals)
            loss.backward()
            loss_sum += loss.detach()
        timed = device.type == "cuda"
        if timed:
            events[:] = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        if reduce:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            pieces = flat.split([g.numel() for g in grads])
            torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(pieces, grads)])
        if timed:
            events[1].record()
        all_reduce(loss_sum)
        torch._foreach_div_(grads, n)
        grad_norm = opt.update()
        state["step"] += 1
        return state, {"loss": loss_sum / n, "grad_norm": grad_norm}

    def reduce_ms():
        if not events:
            return None
        events[1].synchronize()
        return events[0].elapsed_time(events[1])

    train_step.reduce_ms = reduce_ms
    return train_step, replicated(mesh), assemble, mesh
