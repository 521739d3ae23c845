"""Placements of a train state and a batch on a mesh (counterpart of
alphafold2_tpu/parallel/sharding.py).

JAX binds each leaf's `PartitionSpec` to a mesh as a `NamedSharding`; the
port's `Placement` is the same pair, a mesh and a spec (a tuple of axis
names, `parallel/rules.py`). The port's mesh has one axis, and the port
trains data-parallel: the state is replicated on every shard and the
batch's rows split over "data". A mesh with a "model" axis would need the
tensor-parallel layout bound to it, which the port does not have: it is
refused, naming ROADMAP A13-tp.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from alphafold2_tpu_torch.parallel.mesh import Mesh
from alphafold2_tpu_torch.parallel.rules import match_partition_rules, partition_rules


class Placement(NamedTuple):
    """A leaf's placement: `spec` (a tuple of axis names or None, one an
    axis of the leaf; () replicates) on `mesh` (JAX's NamedSharding)."""

    mesh: Mesh
    spec: tuple


def _refuse_model_axis(mesh: Mesh) -> None:
    if mesh.axis_name == "model":
        raise NotImplementedError(
            "tensor parallelism over a 'model' mesh axis is not ported (ROADMAP A13-tp: the "
            "TP rules bound to a model axis, and hybrid_mesh, which needs a mesh of more "
            "than one axis); train data-parallel over a 'data' mesh")


def state_shardings(mesh: Mesh, state: Any, *, tp: bool = True) -> dict:
    """{name: Placement} for every leaf of a train state (`parallel/
    rules.py named_leaves`): the rules matched over its names, bound to
    `mesh`. The TP rules would apply only on a mesh with a "model" axis,
    which is refused (A13-tp), so everything replicates; `tp` is JAX's
    argument."""
    _refuse_model_axis(mesh)
    specs = match_partition_rules(partition_rules(False), state)
    return {name: Placement(mesh, spec) for name, spec in specs.items()}


def batch_shardings(mesh: Mesh, batch: Any, *, microbatched: bool = True) -> dict:
    """{key: Placement} of a batch: the batch axis (1 under `microbatched`,
    leaves (accum, b, ...), else 0) split over "data", the rest whole."""
    _refuse_model_axis(mesh)
    axis = 1 if microbatched else 0

    def spec(leaf):
        parts = [None] * len(getattr(leaf, "shape", ()))
        if mesh.axis_name == "data" and len(parts) > axis:
            parts[axis] = "data"
        return Placement(mesh, tuple(parts))

    return {k: spec(v) for k, v in batch.items()}


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def host_to_global(state: Any, shardings=None):
    """The same state on each process's card: in a pod each tensor of the
    state (params, AdamW's moments and counts) takes process 0's bytes (a
    broadcast in place, so a step built on the state keeps its tensors).
    `shardings`, a Placement for every leaf or {name: Placement} (None:
    replicated), must replicate. Outside a pod the state is returned as it
    is. Returns the state."""
    from alphafold2_tpu_torch.device import tree_leaves
    from alphafold2_tpu_torch.parallel import distributed

    placed = ({"": shardings} if isinstance(shardings, Placement)
              else shardings or {})
    partitioned = sorted(n for n, p in placed.items() if any(a is not None for a in p.spec))
    if partitioned:
        raise NotImplementedError(f"partitioned placements are not ported (ROADMAP A13-tp): "
                                  f"{partitioned[:3]}")
    if distributed.process_count() == 1:
        return state
    import torch.distributed as dist

    tensors = (state["optimizer"].state_tensors()
               if isinstance(state, dict) and "optimizer" in state else tree_leaves(state))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return state
