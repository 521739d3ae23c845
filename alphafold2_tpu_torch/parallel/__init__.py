"""Parallelism: a single-controller device mesh and sequence parallelism
(counterpart of alphafold2_tpu/parallel/, limited to what is ported: the
mesh, the sequence-parallel primitives, the SP trunk and the SP training
step; data parallelism, multi-process execution and the pipeline wait for
ROADMAP A13)."""

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
from alphafold2_tpu_torch.parallel.train import (
    make_sp_train_step,
    sp_distogram_loss_fn,
    sp_e2e_loss_fn,
    sp_model_apply,
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
    "sp_model_apply",
    "sp_distogram_loss_fn",
    "sp_e2e_loss_fn",
    "make_sp_train_step",
]
