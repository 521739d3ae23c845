"""Parallelism (counterpart of alphafold2_tpu/parallel/, limited to what is
ported): the single-controller device mesh, joining a pod of processes,
the partition-rule registry and the placements it gives, data parallelism
in one process and over a pod, the sequence-parallel primitives, the SP
trunk and the SP training step. Tensor parallelism (ROADMAP A13-tp), the
pipeline (A13-pp) and the overlapped DP step wait."""

from alphafold2_tpu_torch.parallel.distributed import (
    distributed_startup,
    initialize_from_env,
    process_count,
    process_index,
    process_local_batch_size,
)
from alphafold2_tpu_torch.parallel.mesh import KNOWN_AXES, Mesh, data_parallel_mesh, make_mesh
from alphafold2_tpu_torch.parallel.rules import (
    REPLICATED_RULES,
    TP_RULES,
    match_partition_rules,
    partition_rules,
    spec_for_leaf,
    unmatched_leaves,
)
from alphafold2_tpu_torch.parallel.sharding import (
    Placement,
    batch_shardings,
    host_to_global,
    replicated,
    state_shardings,
)
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
    make_multihost_train_step,
    make_sharded_train_step,
    make_sp_train_step,
    sharded_train_state_init,
    sp_distogram_loss_fn,
    sp_e2e_loss_fn,
    sp_model_apply,
)

__all__ = [
    "KNOWN_AXES",
    "Mesh",
    "make_mesh",
    "data_parallel_mesh",
    "distributed_startup",
    "initialize_from_env",
    "process_count",
    "process_index",
    "process_local_batch_size",
    "TP_RULES",
    "REPLICATED_RULES",
    "partition_rules",
    "spec_for_leaf",
    "match_partition_rules",
    "unmatched_leaves",
    "Placement",
    "state_shardings",
    "batch_shardings",
    "replicated",
    "host_to_global",
    "sharded_train_state_init",
    "make_sharded_train_step",
    "make_multihost_train_step",
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
