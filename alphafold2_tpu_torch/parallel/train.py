"""The sequence-parallel training step (counterpart of the SP half of
alphafold2_tpu/parallel/train.py: `sp_model_apply` :303,
`sp_distogram_loss_fn` :287, `sp_e2e_loss_fn` :335, `make_sp_train_step`
:526).

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

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.parallel.mesh import Mesh
from alphafold2_tpu_torch.parallel.sp_trunk import alphafold2_apply_sp
from alphafold2_tpu_torch.training.e2e import make_e2e_loss_fn
from alphafold2_tpu_torch.training.harness import make_distogram_loss_fn, make_train_step


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
