"""Training on the port (counterpart of alphafold2_tpu/training/): losses,
the data pipeline, the train step, checkpoints and recovery, end-to-end
structure training and its segmented step. The JAX package's names, less
those of parts not ported: the orbax manager (`CheckpointManager`,
`restore_or_init`, `abstract_like`: ROADMAP A12-orbax) and the sidechainnet streams
(`sidechainnet_batches`, `sidechainnet_structure_batches`: `--data
sidechainnet`, not queued)."""

from alphafold2_tpu_torch.training.losses import (
    IGNORE_INDEX,
    bucketed_distance_matrix,
    distogram_cross_entropy,
)
from alphafold2_tpu_torch.training.harness import (
    TrainConfig,
    add_train_args,
    distogram_loss_fn,
    make_optimizer,
    make_train_step,
    tcfg_from_args,
    train_state_init,
    with_fault_injection,
)
from alphafold2_tpu_torch.training.data import (
    DataConfig,
    ResilientBatches,
    assemble_global_batch,
    bucket_batches,
    bucketed_microbatches,
    per_process_microbatch_fn,
    process_shard,
    resilient_batches,
    shard_items,
    stack_microbatches,
    synthetic_batches,
    synthetic_microbatch_fn,
    synthetic_structure_batches,
)
from alphafold2_tpu_torch.training.e2e import (
    E2EConfig,
    e2e_loss_fn,
    e2e_train_state_init,
    make_e2e_loss_fn,
    predict_structure,
)
from alphafold2_tpu_torch.training.presets import north_star_e2e_config
from alphafold2_tpu_torch.training.segmented import make_segmented_train_step, plan_segments
from alphafold2_tpu_torch.training.checkpoint import (
    VerifiedCheckpointManager,
    finish,
    open_or_init,
    restore_params_for_inference,
)
from alphafold2_tpu_torch.training.resilience import (
    BadStepError,
    StepGuard,
    add_resilience_args,
    chaos_from_args,
    resilient_mode,
    run_resilient,
)

__all__ = [
    "add_train_args",
    "tcfg_from_args",
    "BadStepError",
    "StepGuard",
    "add_resilience_args",
    "chaos_from_args",
    "resilient_mode",
    "run_resilient",
    "VerifiedCheckpointManager",
    "finish",
    "open_or_init",
    "restore_params_for_inference",
    "IGNORE_INDEX",
    "bucketed_distance_matrix",
    "distogram_cross_entropy",
    "TrainConfig",
    "distogram_loss_fn",
    "make_optimizer",
    "make_train_step",
    "train_state_init",
    "with_fault_injection",
    "DataConfig",
    "ResilientBatches",
    "bucket_batches",
    "bucketed_microbatches",
    "resilient_batches",
    "stack_microbatches",
    "synthetic_batches",
    "synthetic_microbatch_fn",
    "synthetic_structure_batches",
    "process_shard",
    "shard_items",
    "per_process_microbatch_fn",
    "assemble_global_batch",
    "E2EConfig",
    "e2e_loss_fn",
    "make_e2e_loss_fn",
    "e2e_train_state_init",
    "predict_structure",
    "north_star_e2e_config",
    "make_segmented_train_step",
    "plan_segments",
]
