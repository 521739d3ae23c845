"""Kabsch optimal alignment (counterpart of alphafold2_tpu/geometry/kabsch.py).

The 3 x 3 covariance's SVD runs eagerly (`torch.linalg.svd`) on a
detached matrix: losses differentiate through the aligned coordinates,
not through the rotation. The reflection fix flips the last singular
direction where det(U) det(Vt) < 0, per structure.
"""

from __future__ import annotations

import torch


def kabsch(X, Y, weights=None):
    """Align X onto Y. X, Y: (..., 3, N). Returns (X_aligned, Y_centered).

    weights (..., N), optional: per-point weights (a boolean atom mask, for
    example) applied to the centroids and the covariance, the static-shape
    form of selecting the valid points: zero-weight points do not move the
    alignment but are carried through the rotation."""
    squeeze = X.dim() == 2
    if squeeze:
        X, Y = X[None], Y[None]
        if weights is not None:
            weights = torch.as_tensor(weights)[None]
    if weights is None:
        Xc = X - X.mean(dim=-1, keepdim=True)
        Yc = Y - Y.mean(dim=-1, keepdim=True)
        C = torch.einsum("...dn,...en->...de", Xc, Yc)
    else:
        w = torch.as_tensor(weights, device=X.device).to(X.dtype)[..., None, :]
        denom = w.sum(dim=-1, keepdim=True).clamp_min(1e-8)
        Xc = X - (X * w).sum(dim=-1, keepdim=True) / denom
        Yc = Y - (Y * w).sum(dim=-1, keepdim=True) / denom
        # one side of the covariance weighted; Xc and Yc stay unweighted
        # for the returned coordinates
        C = torch.einsum("...dn,...en->...de", Xc * w, Yc)
    U, _, Vt = torch.linalg.svd(C.detach())
    flip = (torch.linalg.det(U) * torch.linalg.det(Vt)) < 0.0
    U = torch.cat([U[..., :, :-1], torch.where(flip[..., None], -U[..., :, -1], U[..., :, -1])
                   [..., None]], dim=-1)
    R = U @ Vt
    X_aligned = torch.einsum("...ji,...jn->...in", R, Xc)
    if squeeze:
        return X_aligned[0], Yc[0]
    return X_aligned, Yc


def Kabsch(A, B):
    """Public wrapper (reference utils.py:698-711)."""
    return kabsch(A, B)
