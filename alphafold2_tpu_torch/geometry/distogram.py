"""Distogram -> central distances + MDS weights, and distogram confidence
(counterpart of alphafold2_tpu/geometry/distogram.py, the default
mean/std centering)."""

from __future__ import annotations

import functools
import math

import torch

from alphafold2_tpu_torch.constants import DISTANCE_THRESHOLDS


def _bin_centers(bins: torch.Tensor) -> torch.Tensor:
    """Bucket centers from their upper thresholds: shifted down half a bin,
    the first clamped to 1.5 A, the catch-all last bucket at 1.33x the
    final threshold."""
    centers = bins - 0.5 * (bins[2] - bins[1])
    centers[0] = 1.5
    centers[-1] = 1.33 * bins[-1]
    return centers


@functools.lru_cache(maxsize=None)
def _default_bins(dtype: torch.dtype, device: torch.device):
    """(DISTANCE_THRESHOLDS, their bucket centers) on `device`, made there
    once: a copy from the host cannot be captured into a CUDA graph
    (serving/executable.py)."""
    bins = torch.as_tensor(DISTANCE_THRESHOLDS, dtype=dtype, device=device)
    return bins, _bin_centers(bins.clone())


def center_distogram(distogram, bins=None):
    """Expected distance and confidence weights from a distogram.

    distogram: (batch, N, N, B) probabilities. Returns central (batch, N, N)
    distances with a zero diagonal and weights = mask / (1 + std), where
    the mask drops pairs whose expectation falls in the catch-all "far"
    bucket."""
    if distogram.dim() == 3:
        distogram = distogram[None]
    if bins is None:
        bins, centers = _default_bins(distogram.dtype, distogram.device)
    else:
        bins = torch.as_tensor(bins, dtype=distogram.dtype, device=distogram.device)
        centers = _bin_centers(bins.clone())
    n = distogram.shape[-2]
    central = torch.einsum("...b,b->...", distogram, centers)
    mask = (central <= bins[-2]).to(distogram.dtype)
    eye = torch.eye(n, dtype=torch.bool, device=distogram.device)
    central = torch.where(eye[None], 0.0, central)
    dispersion = torch.sqrt(torch.einsum(
        "...b,...b->...", distogram, (centers - central[..., None]) ** 2
    ))
    weights = torch.nan_to_num(mask / (1.0 + dispersion), nan=0.0)
    return central, weights


def distogram_confidence(distogram, mask=None):
    """Per-residue confidence in [0, 1]: the mean over valid partners of
    1 - H(p_ij)/ln(B). distogram: (batch, N, N, B) probabilities; mask:
    (batch, N) bool. Masked residues score 0. Returns (batch, N) f32."""
    if distogram.dim() == 3:
        distogram = distogram[None]
    p = distogram.float()
    n, nb = p.shape[-2], p.shape[-1]
    ent = -(p * torch.log(p.clamp_min(1e-12))).sum(dim=-1)
    if nb == 1:
        certainty = torch.ones_like(ent)
    else:
        certainty = 1.0 - ent / math.log(nb)
    off_diag = ~torch.eye(n, dtype=torch.bool, device=p.device)[None]
    if mask is not None:
        mask = mask.bool()
        pair_valid = off_diag & mask[:, :, None] & mask[:, None, :]
    else:
        pair_valid = off_diag.expand(certainty.shape)
    denom = pair_valid.sum(dim=-1).clamp_min(1)
    conf = torch.where(pair_valid, certainty, 0.0).sum(dim=-1) / denom
    if mask is not None:
        conf = torch.where(mask, conf, 0.0)
    return conf.clamp(0.0, 1.0)
