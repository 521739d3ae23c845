"""Dihedral angles and backbone chirality statistics (counterpart of
alphafold2_tpu/geometry/dihedral.py)."""

from __future__ import annotations

import numpy as np
import torch


def get_dihedral(c1, c2, c3, c4):
    """Dihedral angle (radians) between the planes (c1, c2, c3) and (c2, c3,
    c4), in the atan2 form. Inputs (..., 3), broadcast."""
    u1 = c2 - c1
    u2 = c3 - c2
    u3 = c4 - c3
    cross23 = torch.linalg.cross(u2, u3, dim=-1)
    y = (torch.linalg.norm(u2, dim=-1, keepdim=True) * u1 * cross23).sum(dim=-1)
    x = (torch.linalg.cross(u1, u2, dim=-1) * cross23).sum(dim=-1)
    return torch.atan2(y, x)


def _flat_mask(mask) -> np.ndarray:
    return np.asarray(mask).reshape(-1).astype(bool)


def calc_phis(pred_coords, N_mask, CA_mask, C_mask=None, prop: bool = True):
    """Backbone phi angles, or the fraction of them that is negative (a
    correctly handed backbone has mostly negative phi).

    pred_coords: (batch, 3, P) over P backbone points, detached here (no
    gradient flows through the chirality statistic). N_mask, CA_mask,
    C_mask: (P,) static boolean masks (numpy) selecting N, C-alpha and C;
    C_mask defaults to ~(N | CA). Returns (batch,) proportions if prop,
    else the (batch, L - 1) angles."""
    coords = pred_coords.detach().transpose(1, 2)
    n_mask, ca_mask = _flat_mask(N_mask), _flat_mask(CA_mask)
    c_mask = ~(n_mask | ca_mask) if C_mask is None else _flat_mask(C_mask)

    def pick(mask):
        idx = torch.as_tensor(np.nonzero(mask)[0], device=coords.device)
        return coords[:, idx]

    n_terms, c_alphas, c_terms = pick(n_mask), pick(ca_mask), pick(c_mask)
    # phi_i between the planes (C_{i-1}, N_i, CA_i) and (N_i, CA_i, C_i)
    phis = get_dihedral(c_terms[:, :-1], n_terms[:, 1:], c_alphas[:, 1:], c_terms[:, 1:])
    if prop:
        return (phis < 0.0).float().mean(dim=-1)
    return phis
