"""Parallelism: a single-controller device mesh and sequence parallelism
(counterpart of alphafold2_tpu/parallel/, limited to what is ported: the
mesh, the sequence-parallel primitives and the SP trunk; data parallelism,
the SP training step and the pipeline wait for ROADMAP A13)."""

from alphafold2_tpu_torch.parallel.mesh import KNOWN_AXES, Mesh, make_mesh
from alphafold2_tpu_torch.parallel.sequence import (
    axial_alltoall_transpose,
    ring_attention,
    sequence_parallel_axial_attention,
    tied_row_attention_sharded,
    ulysses_attention,
)
from alphafold2_tpu_torch.parallel.sp_trunk import (
    alphafold2_apply_sp,
    msa_sharded_trunk_apply,
    sp_trunk_apply,
)

__all__ = [
    "KNOWN_AXES",
    "Mesh",
    "make_mesh",
    "ring_attention",
    "ulysses_attention",
    "axial_alltoall_transpose",
    "sequence_parallel_axial_attention",
    "tied_row_attention_sharded",
    "sp_trunk_apply",
    "msa_sharded_trunk_apply",
    "alphafold2_apply_sp",
]
