"""Structure-quality metrics: RMSD, GDT (TS/HA) and TM-score (counterpart
of alphafold2_tpu/geometry/metrics.py). X, Y: (batch, 3, N) or (3, N);
every score is (batch,)."""

from __future__ import annotations

import numpy as np
import torch

GDT_TS_CUTOFFS = (1.0, 2.0, 4.0, 8.0)
GDT_HA_CUTOFFS = (0.5, 1.0, 2.0, 4.0)


def _batchify(*arrays):
    """Tensors with a batch axis: (3, N) inputs become (1, 3, N)."""
    arrays = tuple(torch.as_tensor(a) for a in arrays)
    if arrays[0].dim() == 2:
        return tuple(a[None] for a in arrays)
    return arrays


def _point_weights(mask, X):
    """(batch, N) float point weights and the per-structure counts (at
    least 1) from an optional boolean mask; None: every point valid."""
    if mask is None:
        w = torch.ones(X.shape[:-2] + X.shape[-1:], dtype=X.dtype, device=X.device)
    else:
        w = torch.as_tensor(mask, device=X.device).to(X.dtype)
        if w.dim() == 1:
            w = w[None]
    return w, w.sum(dim=-1).clamp_min(1.0)


def _check_norm_len(norm_len, mask, X):
    """norm_len is the full reference length: it must cover every scored
    point, or the score exceeds 1.0. Raises ValueError when it does not."""
    if mask is None:
        valid = X.shape[-1]
    else:
        valid = int(np.max(np.sum(np.asarray(torch.as_tensor(mask).cpu(), np.float64),
                                  axis=-1)))
    if norm_len < valid:
        raise ValueError(
            f"norm_len={norm_len} is smaller than the scored point count "
            f"{valid}; the score would exceed 1.0. norm_len is the full "
            f"reference length and must cover every valid point.")


def _norm_len_clamped(norm_len, valid_count, X):
    """The normaliser: norm_len, never below the per-structure point count
    (scores stay at most 1.0)."""
    return torch.clamp_min(valid_count, float(norm_len)).to(X.dtype)


def rmsd(X, Y, mask=None):
    """Root-mean-square deviation; `mask` (batch, N) drops points."""
    X, Y = _batchify(X, Y)
    w, n = _point_weights(mask, X)
    sq = ((X - Y) ** 2).sum(dim=-2)
    return torch.sqrt((sq * w).sum(dim=-1) / (3.0 * n))


def gdt(X, Y, cutoffs=GDT_TS_CUTOFFS, weights=None, mask=None, norm_len=None):
    """Global distance test: the weighted mean over cutoffs of the fraction
    of valid points within each. `norm_len` normalises by the reference
    length (uncovered residues count as outside every cutoff)."""
    X, Y = _batchify(X, Y)
    cut = torch.as_tensor(cutoffs, dtype=X.dtype, device=X.device)
    if weights is None:
        weights = torch.ones_like(cut)
    else:
        weights = torch.as_tensor(weights, dtype=X.dtype, device=X.device).expand(cut.shape)
    pw, n = _point_weights(mask, X)
    if norm_len is not None:
        _check_norm_len(norm_len, mask, X)
        n = _norm_len_clamped(norm_len, n, X)
    dist = torch.sqrt(((X - Y) ** 2).sum(dim=-2))
    within = (dist[..., None, :] <= cut[:, None]).to(X.dtype)
    frac = (within * pw[..., None, :]).sum(dim=-1) / n[..., None]
    return (frac * weights).mean(dim=-1)


def tmscore(X, Y, mask=None, norm_len=None):
    """Template-modelling score, d0 clamped to at least 0.5 (standard
    TM-score; the reference's unclamped d0 goes negative near L = 18). With
    `mask`, L is each structure's valid count; `norm_len` sets both d0 and
    the 1/L normaliser to the reference length."""
    X, Y = _batchify(X, Y)
    w, n = _point_weights(mask, X)
    if norm_len is not None:
        _check_norm_len(norm_len, mask, X)
        n = _norm_len_clamped(norm_len, n, X)
        d0 = torch.tensor(max(1.24 * np.cbrt(norm_len - 15) - 1.8, 0.5)
                          if norm_len > 15 else 0.5, dtype=X.dtype, device=X.device)
    elif mask is None:
        L = X.shape[-1]
        d0 = torch.tensor(max(1.24 * np.cbrt(L - 15) - 1.8, 0.5) if L > 15 else 0.5,
                          dtype=X.dtype, device=X.device)
    else:
        d0 = torch.clamp_min(1.24 * torch.pow(torch.clamp_min(n - 15.0, 1e-3), 1.0 / 3.0)
                             - 1.8, 0.5)
    dist = torch.sqrt(((X - Y) ** 2).sum(dim=-2))
    terms = 1.0 / (1.0 + (dist / d0[..., None]) ** 2)
    return (terms * w).sum(dim=-1) / n


# public wrappers (reference utils.py:713-761)

def RMSD(A, B, *, mask=None):
    return rmsd(A, B, mask=mask)


def GDT(A, B, *, mode: str = "TS", weights=None, mask=None, norm_len=None):
    cutoffs = GDT_HA_CUTOFFS if str(mode).upper() == "HA" else GDT_TS_CUTOFFS
    return gdt(A, B, cutoffs=cutoffs, weights=weights, mask=mask, norm_len=norm_len)


def TMscore(A, B, *, mask=None, norm_len=None):
    return tmscore(A, B, mask=mask, norm_len=norm_len)


def structure_eval(pred, true, mask=None) -> dict:
    """Quality of predicted against true clouds (counterpart of
    alphafold2_tpu/utils/observability.py `structure_eval`). pred, true:
    (b, N, 3); mask (b, N) bool. The prediction is Kabsch-aligned onto the
    truth first; returns the batch means of rmsd, gdt_ts, gdt_ha and tm as
    floats (one device-to-host copy)."""
    from alphafold2_tpu_torch.geometry.kabsch import kabsch

    pred = torch.as_tensor(pred).float().transpose(-1, -2)  # (b, 3, N)
    true = torch.as_tensor(true, device=pred.device).float().transpose(-1, -2)
    w = None if mask is None else torch.as_tensor(mask, device=pred.device).float()
    pred_al, true_c = kabsch(pred, true, weights=w)
    scores = {
        "rmsd": rmsd(pred_al, true_c, mask=w),
        "gdt_ts": gdt(pred_al, true_c, cutoffs=GDT_TS_CUTOFFS, mask=w),
        "gdt_ha": gdt(pred_al, true_c, cutoffs=GDT_HA_CUTOFFS, mask=w),
        "tm": tmscore(pred_al, true_c, mask=w),
    }
    means = torch.stack([v.mean() for v in scores.values()]).cpu().tolist()
    return dict(zip(scores, means))
