"""Synthetic protein batches with static shapes (a copy of the numpy-only
part of alphafold2_tpu/training/data.py: for a seed they give the same
arrays as the JAX package's).

Protein-like C-alpha traces (fixed-step random walk, ~3.8 A bond length),
so training runs without a dataset. Batch `i` is a pure function of
(seed, i).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from alphafold2_tpu_torch.constants import NUM_AMINO_ACIDS


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 1
    max_len: int = 128
    msa_rows: int = 0  # 0 = sequence-only (the train_pre path)
    seed: int = 0


def _batch_rng(seed: int, index: int) -> np.random.RandomState:
    """Per-batch RandomState derived from (stream seed, batch index)."""
    return np.random.RandomState((seed * 1_000_003 + index) % (2**31 - 1))


def synthetic_batches(cfg: DataConfig, start_index: int = 0) -> Iterator[dict]:
    """Endless batches {"seq": (b, L) int32, "mask": (b, L) bool, "coords":
    (b, L, 3) float32} (+ msa/msa_mask when cfg.msa_rows > 0), starting at
    batch `start_index`."""
    b, L = cfg.batch_size, cfg.max_len
    index = start_index
    while True:
        rng = _batch_rng(cfg.seed, index)
        index += 1
        seq = rng.randint(0, NUM_AMINO_ACIDS, size=(b, L)).astype(np.int32)
        lengths = rng.randint(max(8, L // 2), L + 1, size=(b,))
        mask = np.arange(L)[None, :] < lengths[:, None]
        steps = rng.randn(b, L, 3).astype(np.float32)
        steps /= np.linalg.norm(steps, axis=-1, keepdims=True) + 1e-8
        coords = np.cumsum(3.8 * steps, axis=1).astype(np.float32)
        batch = {"seq": seq, "mask": mask, "coords": coords}
        if cfg.msa_rows > 0:
            batch["msa"] = rng.randint(
                0, NUM_AMINO_ACIDS, size=(b, cfg.msa_rows, L)
            ).astype(np.int32)
            batch["msa_mask"] = np.broadcast_to(mask[:, None, :], batch["msa"].shape)
        yield batch


def stack_microbatches(it: Iterator[dict], grad_accum: int) -> Iterator[dict]:
    """Group `grad_accum` batches under a leading microbatch axis."""
    while True:
        mbs = [next(it) for _ in range(grad_accum)]
        yield {k: np.stack([m[k] for m in mbs]) for k in mbs[0]}


def synthetic_microbatch_fn(cfg: DataConfig, grad_accum: int):
    """`fetch(step)`: the microbatch stack of that optimizer step, a pure
    function of the step number."""

    def fetch(step: int) -> dict:
        it = synthetic_batches(cfg, start_index=step * grad_accum)
        mbs = [next(it) for _ in range(grad_accum)]
        return {k: np.stack([m[k] for m in mbs]) for k in mbs[0]}

    return fetch
