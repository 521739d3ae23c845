"""Synthetic protein batches with static shapes, length bucketing, and
the retrying wrapper around a batch source (a copy of the numpy-only part of
alphafold2_tpu/training/data.py: for a seed the batches are the JAX
package's arrays).

Protein-like C-alpha traces (fixed-step random walk, ~3.8 A bond length)
for distogram pretraining, and full-atom clouds around a noisy helix for
end-to-end structure training, so training runs without a dataset. Batch
`i` is a pure function of (seed, i). `ResilientBatches` retries a failed
fetch and skips a record that keeps failing; with a step-indexed fetch a
retry refetches the same step, so recovery stays bit-exact.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from alphafold2_tpu_torch.constants import NUM_AMINO_ACIDS
from alphafold2_tpu_torch.geometry.sidechain import sidechain_container


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


def synthetic_structure_batches(cfg: DataConfig, start_index: int = 0) -> Iterator[dict]:
    """Endless full-atom batches for end-to-end structure training: {"seq":
    (b, L) int32, "mask": (b, L) bool (all true), "coords": (b, L, 14, 3)
    float32} (+ msa/msa_mask when cfg.msa_rows > 0), starting at batch
    `start_index`. The backbone is a helix with protein-like chirality
    (mostly negative phi) plus 0.05 A of noise, lifted to the 14-atom cloud
    by `sidechain_container` with the carbonyl O placed. seq, mask, msa and
    msa_mask are the JAX package's arrays bit for bit; coords agree to
    ~1e-6 (the lift runs in torch here, in JAX there)."""
    b, L = cfg.batch_size, cfg.max_len
    index = start_index
    while True:
        rng = _batch_rng(cfg.seed, index)
        index += 1
        seq = rng.randint(0, NUM_AMINO_ACIDS, size=(b, L)).astype(np.int32)
        mask = np.ones((b, L), bool)
        t = 0.6 * np.arange(3 * L)[None, :, None]
        helix = np.concatenate([2 * np.cos(t), 2 * np.sin(t), -0.16 * t],
                               axis=-1).astype(np.float32)
        backbone = helix + 0.05 * rng.randn(b, 3 * L, 3).astype(np.float32)
        cloud = sidechain_container(torch.from_numpy(backbone), place_oxygen=True).numpy()
        batch = {"seq": seq, "mask": mask, "coords": cloud}
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


def bucket_batches(items: Iterator[tuple], cfg: DataConfig, buckets: tuple,
                   full_atom: bool = False) -> Iterator[dict]:
    """Static-shape length bucketing over a stream of variable-length
    proteins. items: (seq_ints (L,), cloud (L, 14, 3)) pairs of any L (the
    native loader's dataset layout). A protein goes to the smallest of the
    ascending `buckets` that holds it (a random crop to the largest
    otherwise, the native loader's policy), padded to the bucket's length;
    a batch is emitted when its bucket holds `cfg.batch_size` proteins,
    with a "bucket" key (a Python int: one capture a bucket). Yields
    seq/mask and coords (b, L, 3) C-alpha, or with full_atom coords (b, L,
    14, 3) and atom_mask."""
    buckets = tuple(sorted(set(int(x) for x in buckets)))
    if not buckets:
        raise ValueError("need at least one bucket length")
    rng = np.random.RandomState(cfg.seed)
    pending: dict = {bl: [] for bl in buckets}
    b = cfg.batch_size
    for seq, cloud in items:
        L = len(seq)
        bl = next((x for x in buckets if L <= x), buckets[-1])
        start = rng.randint(0, L - bl + 1) if L > bl else 0
        pending[bl].append(
            (np.asarray(seq)[start: start + bl], np.asarray(cloud)[start: start + bl]))
        if len(pending[bl]) < b:
            continue
        group, pending[bl] = pending[bl], []
        seq_out = np.zeros((b, bl), np.int32)
        mask = np.zeros((b, bl), bool)
        cloud_out = np.zeros((b, bl, 14, 3), np.float32)
        for row, (s, c) in enumerate(group):
            n = min(len(s), len(c))
            seq_out[row, :n] = s[:n]
            cloud_out[row, :n] = c[:n]
            mask[row, :n] = True
        batch = {"seq": seq_out, "mask": mask, "bucket": bl}
        if full_atom:
            batch["coords"] = cloud_out
            batch["atom_mask"] = np.abs(cloud_out).sum(-1) > 0
        else:
            batch["coords"] = cloud_out[:, :, 1]  # the C-alpha slot
        yield batch


def bucketed_microbatches(it: Iterator[dict], grad_accum: int) -> Iterator[dict]:
    """`stack_microbatches` for a bucketed stream: the microbatches of one
    stack share a shape, so they are grouped by bucket, and a stack is
    emitted as soon as any bucket holds `grad_accum` batches (with its
    "bucket" key)."""
    pending: dict = {}
    for batch in it:
        bl = batch["bucket"]
        pending.setdefault(bl, []).append(batch)
        if len(pending[bl]) < grad_accum:
            continue
        mbs = pending.pop(bl)
        out = {k: np.stack([m[k] for m in mbs]) for k in mbs[0] if k != "bucket"}
        out["bucket"] = bl
        yield out


def synthetic_microbatch_fn(cfg: DataConfig, grad_accum: int, source=None):
    """`fetch(step)`: the microbatch stack of that optimizer step, a pure
    function of the step number. source: `synthetic_batches` (default) or
    `synthetic_structure_batches`."""
    src = source if source is not None else synthetic_batches

    def fetch(step: int) -> dict:
        it = src(cfg, start_index=step * grad_accum)
        mbs = [next(it) for _ in range(grad_accum)]
        return {k: np.stack([m[k] for m in mbs]) for k in mbs[0]}

    return fetch


class ResilientBatches:
    """Retrying/skipping wrapper over a batch source: a step-indexed fetch
    (`fetch(step)`, e.g. `synthetic_microbatch_fn`; a retry fetches the same
    step again) or an iterator (`next` semantics; a retry takes the next
    record, so recovery is not replay-exact: train_end2end's esm stream).
    A failed fetch is retried with bounded exponential backoff, and a record
    that keeps failing is skipped (counted, reported) instead of ending the
    run; StopIteration is the end of the data, not a fault, and passes
    through. The chaos hook (`injector.before_batch(index)`) fires before
    each underlying fetch, so an injected transient error consumes no
    record. Call it with a step (`fetch(step)`) in the callable form;
    iterate it in the iterator form."""

    def __init__(self, source, *, max_retries: int = 2, backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0, injector=None, max_skipped: Optional[int] = None):
        self.step_indexed = callable(source)
        self._fn = source if self.step_indexed else None
        self._it = None if self.step_indexed else iter(source)
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self._injector = injector
        self.max_skipped = max_skipped
        self.skipped = 0      # records abandoned after retries
        self.retries = 0      # retry attempts
        self._index = 0       # fetch index (the chaos hook's clock)

    def _attempt(self, step: Optional[int]):
        index = self._index
        self._index += 1
        if self._injector is not None:
            self._injector.before_batch(index)
        if self._fn is None:
            return next(self._it)
        return self._fn(step if step is not None else index)

    def _fetch(self, step: Optional[int] = None):
        while True:  # a skip moves on to the next record
            for attempt in range(self.max_retries + 1):
                try:
                    return self._attempt(step)
                except StopIteration:
                    raise
                except Exception as e:
                    if attempt < self.max_retries:
                        self.retries += 1
                        delay = min(self.backoff_s * (2 ** attempt), self.max_backoff_s)
                        if delay > 0:
                            time.sleep(delay)
                        continue
                    self.skipped += 1
                    print(f"data: record at fetch index {self._index - 1} failed "
                          f"{attempt + 1} attempts ({type(e).__name__}: {e}) — skipped "
                          f"({self.skipped} total)")
                    if self.max_skipped is not None and self.skipped > self.max_skipped:
                        raise RuntimeError(
                            f"data pipeline skipped {self.skipped} records "
                            f"(> max_skipped={self.max_skipped}); the source is broken, "
                            f"not flaky") from e
            # skipped: the step's batch is lost, so the next fetch index's
            # batch serves it (logged above, counted in skipped)
            step = None

    def __iter__(self):
        if self._fn is not None:
            raise TypeError("a step-indexed ResilientBatches is called with a step, "
                            "not iterated")
        return self

    def __next__(self):
        return self._fetch()

    def __call__(self, step: int):
        if self._fn is None:
            raise TypeError("an iterator ResilientBatches is iterated, not called with a step")
        return self._fetch(step)


def resilient_batches(source, **kwargs) -> ResilientBatches:
    """`ResilientBatches(source, **kwargs)`, the data pipeline's hook point
    (reliability/faults.py)."""
    return ResilientBatches(source, **kwargs)
