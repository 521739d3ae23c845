"""Distogram pretraining loss (counterpart of alphafold2_tpu/training/losses.py).

Pairwise C-alpha distances are bucketized into the 37 distogram bins and
the model's logits are scored with a cross-entropy masked to valid pairs.
"""

from __future__ import annotations

import functools

import torch

from alphafold2_tpu_torch.constants import DISTOGRAM_BUCKETS

IGNORE_INDEX = -100

# The bin boundaries exactly as the JAX package computes them,
# `jnp.linspace(2.0, 20.0, 37)[:-1]` under XLA in float32: its lerp
# `start * (1 - t) + stop * t` lands ten of them one float32 ulp above
# 2 + k/2. Kept bit for bit, so the labels match on every distance.
_BOUNDARIES = (
    2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0, 5.5, 6.0, 6.5, 7.0,
    7.500000476837158, 8.0, 8.5, 9.0, 9.500000953674316, 10.0, 10.5, 11.0,
    11.500000953674316, 12.0, 12.5, 13.000000953674316, 13.500000953674316,
    14.000000953674316, 14.5, 15.0, 15.500000953674316, 16.0,
    16.500001907348633, 17.000001907348633, 17.500001907348633, 18.0, 18.5,
    19.0, 19.5,
)


def distogram_boundaries(device=None) -> torch.Tensor:
    """The DISTOGRAM_BUCKETS - 1 bin boundaries, float32, on `device`."""
    return _boundaries_on(torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _boundaries_on(device: torch.device) -> torch.Tensor:
    # made once a device: a copy from the host cannot be captured into a
    # CUDA graph (training/executable.py); nothing writes to it
    return torch.tensor(_BOUNDARIES, dtype=torch.float32, device=device)


def bucketed_distance_matrix(coords, mask, num_buckets: int = DISTOGRAM_BUCKETS,
                             ignore_index: int = IGNORE_INDEX):
    """coords (b, L, 3) C-alpha, mask (b, L) bool -> (b, L, L) int64 bucket
    labels, `ignore_index` where either residue is masked. A distance d
    falls in bucket k when boundary[k-1] < d <= boundary[k]."""
    if num_buckets != len(_BOUNDARIES) + 1:
        raise ValueError(f"the distogram has {len(_BOUNDARIES) + 1} buckets, got {num_buckets}")
    coords = coords.float()
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    distances = torch.sqrt(torch.clamp((diff * diff).sum(dim=-1), min=1e-12))
    labels = torch.searchsorted(distogram_boundaries(coords.device), distances)
    pair_mask = mask[:, :, None] & mask[:, None, :]
    return torch.where(pair_mask, labels, ignore_index)


def distogram_cross_entropy(logits, labels, ignore_index: int = IGNORE_INDEX):
    """Mean cross-entropy over valid pairs: logits (b, n, n, buckets) in any
    dtype (scored in f32), labels (b, n, n) with `ignore_index` to skip."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1)
