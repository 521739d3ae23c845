"""Distogram -> central distances + MDS weights, distogram confidence, and
bucketised distance labels (counterpart of
alphafold2_tpu/geometry/distogram.py)."""

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


def center_distogram(distogram, bins=None, center: str = "mean", wide: str = "std"):
    """Central distance estimate and confidence weights from a distogram.

    distogram: (batch, N, N, B) probabilities over B buckets; bins: (B,)
    thresholds (default DISTANCE_THRESHOLDS); center: "mean" (the
    expectation over the bucket centres) or "median" (the centre of the
    first bucket whose CDF reaches 0.5); wide: the dispersion in the
    weights, "std", "var" or "none". Returns central (batch, N, N)
    distances with a zero diagonal and weights = mask / (1 + dispersion),
    where the mask drops pairs whose estimate falls in the catch-all "far"
    bucket."""
    if distogram.dim() == 3:
        distogram = distogram[None]
    if bins is None:
        bins, centers = _default_bins(distogram.dtype, distogram.device)
    else:
        bins = torch.as_tensor(bins, dtype=distogram.dtype, device=distogram.device)
        centers = _bin_centers(bins.clone())
    n = distogram.shape[-2]
    if center == "median":
        idx = (distogram.cumsum(dim=-1) < 0.5).sum(dim=-1).clamp_max(centers.shape[0] - 1)
        central = centers[idx]
    elif center == "mean":
        central = torch.einsum("...b,b->...", distogram, centers)
    else:
        raise ValueError(f"unknown center mode {center!r}")
    mask = (central <= bins[-2]).to(distogram.dtype)
    eye = torch.eye(n, dtype=torch.bool, device=distogram.device)
    central = torch.where(eye[None], 0.0, central)
    if wide in ("var", "std"):
        dispersion = torch.einsum("...b,...b->...", distogram,
                                  (centers - central[..., None]) ** 2)
        if wide == "std":
            dispersion = torch.sqrt(dispersion)
    else:
        dispersion = torch.zeros_like(central)
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


def bucketize_distances(coords, mask=None, bins=None, ignore_index: int = -100):
    """Bucketised distance labels (batch, N, N) int32 in [0, B - 1] from
    C-alpha coordinates (batch, N, 3): the index of the first threshold of
    bins[:-1] at or above each distance. Pairs with a masked end (mask:
    (batch, N) bool) get `ignore_index`."""
    coords = torch.as_tensor(coords)
    bins = torch.as_tensor(DISTANCE_THRESHOLDS if bins is None else bins,
                           dtype=coords.dtype, device=coords.device)
    d2 = ((coords[:, :, None, :] - coords[:, None, :, :]) ** 2).sum(dim=-1)
    dist = torch.sqrt(d2.clamp_min(1e-12))
    labels = torch.searchsorted(bins[:-1].contiguous(), dist.contiguous()).to(torch.int32)
    if mask is not None:
        mask = torch.as_tensor(mask, device=coords.device).bool()
        pair = mask[:, :, None] & mask[:, None, :]
        labels = torch.where(pair, labels, torch.full_like(labels, ignore_index))
    return labels
