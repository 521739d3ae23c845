"""Atom-presence masks for dense (residue, atom-slot) coordinate clouds
(counterpart of alphafold2_tpu/geometry/masks.py)."""

from __future__ import annotations

import numpy as np
import torch

from alphafold2_tpu_torch.constants import ATOMS_PER_TOKEN, NUM_COORDS_PER_RES


def scn_cloud_mask(seq_tokens, boolean: bool = True, n_atoms: int = NUM_COORDS_PER_RES):
    """Per-residue atom-slot presence: slot s of a residue is present iff s
    is below the residue's heavy-atom count (`constants.ATOMS_PER_TOKEN`;
    a pad token has none). seq_tokens: (batch, L) int tensor or array.
    Returns a (batch, L, n_atoms) bool tensor on the tokens' device, or
    with boolean=False the (k, 3) indices of its true entries."""
    tokens = torch.as_tensor(seq_tokens).long()
    counts = torch.as_tensor(ATOMS_PER_TOKEN, device=tokens.device)[tokens]
    mask = torch.arange(n_atoms, device=tokens.device)[None, None, :] < counts[..., None]
    if boolean:
        return mask
    return torch.argwhere(mask)


def scn_backbone_mask(seq_tokens, boolean: bool = True, l_aa: int = NUM_COORDS_PER_RES):
    """(N_mask, CA_mask) over a flattened (L * l_aa) atom axis: N is atom 0
    of each residue, C-alpha atom 1. Only the tokens' shape is read. Flat
    numpy masks with no batch axis (static masks for `calc_phis`), or with
    boolean=False their indices."""
    length = seq_tokens.shape[-1] * l_aa
    pos = np.arange(length)
    n_mask = pos % l_aa == 0
    ca_mask = pos % l_aa == 1
    if boolean:
        return n_mask, ca_mask
    return np.nonzero(n_mask)[0], np.nonzero(ca_mask)[0]
