"""Length-bucket ladder and shape padding for the engine's executables
(counterpart of alphafold2_tpu/serving/bucketing.py, copied).

A request of length L runs at the smallest bucket >= L, so an arbitrary
stream of lengths needs at most `len(buckets)` captured executables for
each batch shape. Padding is masked end to end (serving/pipeline.py):
excluded from attention, zero-weighted and zero-distanced in MDS,
zero-confidence in the output. The Torgerson centring and the Guttman
`/n` step see the padded size, so a structure is a deterministic function
of (sequence, bucket), and the engine's cache tag includes the ladder.

A partial batch is topped up by duplicating the last real row, not with
all-pad rows: an all-pad row has an all-zero MDS weight matrix, whose
normalised stress is 0/0.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from alphafold2_tpu_torch.constants import PAD_TOKEN_ID
from alphafold2_tpu_torch.serving.errors import SequenceTooLongError

# fine-grained at the short end where most sequences live
DEFAULT_BUCKETS: Tuple[int, ...] = (64, 128, 256, 384, 512)


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Sorted, deduplicated ladder of padded sequence lengths."""

    buckets: Tuple[int, ...] = DEFAULT_BUCKETS

    def __post_init__(self):
        cleaned = tuple(sorted({int(b) for b in self.buckets}))
        if not cleaned:
            raise ValueError("bucket ladder must have at least one bucket")
        if cleaned[0] <= 0:
            raise ValueError(f"buckets must be positive, got {cleaned}")
        object.__setattr__(self, "buckets", cleaned)

    def __len__(self) -> int:
        return len(self.buckets)

    @property
    def max_len(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, length: int) -> int:
        """Smallest bucket that fits `length`; SequenceTooLongError past
        the top of the ladder (never a silent truncation)."""
        if length <= 0:
            raise ValueError(f"sequence length must be positive, got {length}")
        for b in self.buckets:
            if length <= b:
                return b
        raise SequenceTooLongError(
            f"sequence length {length} exceeds the largest bucket "
            f"{self.max_len} (ladder: {self.buckets})"
        )


def batch_shape_ladder(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two batch shapes {1, 2, 4, ...} up to `max_batch`, which is
    always the top rung: a partial batch runs at the smallest rung >= its
    live count instead of paying for phantom rows at `max_batch`."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    shapes = []
    b = 1
    while b < max_batch:
        shapes.append(b)
        b *= 2
    shapes.append(int(max_batch))
    return tuple(shapes)


def pad_tokens(tokens: np.ndarray, bucket: int):
    """(L,) int tokens -> ((bucket,) padded tokens, (bucket,) bool mask)."""
    tokens = np.asarray(tokens, np.int32)
    length = tokens.shape[0]
    if length > bucket:
        raise ValueError(f"length {length} does not fit bucket {bucket}")
    out = np.full((bucket,), PAD_TOKEN_ID, np.int32)
    out[:length] = tokens
    mask = np.zeros((bucket,), bool)
    mask[:length] = True
    return out, mask


def pad_batch(rows: Sequence[np.ndarray], bucket: int, max_batch: int):
    """1..max_batch (L_i,) token rows -> (tokens (max_batch, bucket) int32,
    mask (max_batch, bucket) bool, n_real). Unused slots duplicate the last
    real row and its mask; callers slice results by n_real."""
    if not rows:
        raise ValueError("pad_batch needs at least one row")
    if len(rows) > max_batch:
        raise ValueError(f"{len(rows)} rows exceed max_batch {max_batch}")
    tokens = np.empty((max_batch, bucket), np.int32)
    mask = np.empty((max_batch, bucket), bool)
    for i, row in enumerate(rows):
        tokens[i], mask[i] = pad_tokens(row, bucket)
    for i in range(len(rows), max_batch):
        tokens[i], mask[i] = tokens[len(rows) - 1], mask[len(rows) - 1]
    return tokens, mask, len(rows)
