"""NeRF point placement and the backbone -> dense atom-cloud lift
(counterpart of alphafold2_tpu/geometry/sidechain.py)."""

from __future__ import annotations

import math

import torch

from alphafold2_tpu_torch.constants import (
    BOND_ANG_CA_C_O,
    BOND_LEN_C_O,
    GLOBAL_PAD_CHAR,
    NUM_COORDS_PER_RES,
)
from alphafold2_tpu_torch.geometry.dihedral import get_dihedral


def nerf(a, b, c, l, theta, chi):
    """Natural extension of the reference frame: the point d bonded to c
    after (a, b, c), at bond length l (...,), bond angle theta b-c-d and
    dihedral chi between the planes (a, b, c) and (b, c, d), radians.
    a, b, c: (..., 3). Returns d (..., 3)."""
    l, theta, chi = (torch.as_tensor(t, dtype=c.dtype, device=c.device)[..., None]
                     for t in (l, theta, chi))
    ba = b - a
    cb = c - b
    n_plane = torch.linalg.cross(ba, cb, dim=-1)
    n_plane_ = torch.linalg.cross(n_plane, cb, dim=-1)
    # the rotation with columns (cb, n_plane_, n_plane), each normalised
    rotate = torch.stack([cb, n_plane_, n_plane], dim=-1)
    rotate = rotate / torch.linalg.norm(rotate, dim=-2, keepdim=True)
    d_local = torch.cat([-torch.cos(theta), torch.sin(theta) * torch.cos(chi),
                         torch.sin(theta) * torch.sin(chi)], dim=-1)
    return c + l * torch.einsum("...ij,...j->...i", rotate, d_local)


def sidechain_container(backbones, place_oxygen: bool = False,
                        n_atoms: int = NUM_COORDS_PER_RES,
                        padding: float = GLOBAL_PAD_CHAR):
    """Lift a backbone trace (batch, L*3, 3), ordered (N, CA, C) a residue,
    to a dense (batch, L, n_atoms, 3) cloud: slots 0-2 the backbone, the
    rest parked at slot 2 (the carbonyl C, as the reference's code does) as
    a differentiable placeholder for the refiner. With place_oxygen, slot 3
    gets the carbonyl O built by NeRF opposite the psi dihedral (the last
    residue, which has no psi, at 5 pi / 4). `padding` is kept for the
    signature: every slot is written."""
    del padding
    batch, flat, _ = backbones.shape
    length = flat // 3
    bb = backbones.reshape(batch, length, 3, 3)
    park = bb[:, :, 2:3].expand(batch, length, n_atoms - 3, 3)
    if not place_oxygen:
        return torch.cat([bb, park], dim=2)
    # psi_i = dihedral(N_i, CA_i, C_i, N_{i+1})
    psis = get_dihedral(bb[:, :-1, 0], bb[:, :-1, 1], bb[:, :-1, 2], bb[:, 1:, 0])
    psis = torch.cat([psis, psis.new_full((batch, 1), math.pi * 5 / 4)], dim=1)
    oxy = nerf(bb[:, :, 0], bb[:, :, 1], bb[:, :, 2], bb.new_full((batch, length), BOND_LEN_C_O),
               bb.new_full((batch, length), BOND_ANG_CA_C_O), psis - math.pi)
    return torch.cat([bb, oxy[:, :, None], park[:, :, 1:]], dim=2)
