"""Training on the port (counterpart of alphafold2_tpu/training/): losses,
the data pipeline, the train step, checkpoints and recovery, end-to-end
structure training and its segmented step."""

from alphafold2_tpu_torch.training.data import (
    DataConfig,
    ResilientBatches,
    bucket_batches,
    bucketed_microbatches,
    resilient_batches,
    stack_microbatches,
    synthetic_batches,
    synthetic_microbatch_fn,
    synthetic_structure_batches,
)
from alphafold2_tpu_torch.training.segmented import make_segmented_train_step, plan_segments

__all__ = [
    "DataConfig",
    "ResilientBatches",
    "bucket_batches",
    "bucketed_microbatches",
    "make_segmented_train_step",
    "plan_segments",
    "resilient_batches",
    "stack_microbatches",
    "synthetic_batches",
    "synthetic_microbatch_fn",
    "synthetic_structure_batches",
]
