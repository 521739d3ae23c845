"""The relaxation at the end of the structure path (counterpart of
alphafold2_tpu/refinement.py): the PyRosetta boundary behind its optional
import, and without PyRosetta a geometric relaxation, gradient descent on
ideal backbone bond lengths with a weak restraint to the input.

`relax` is JAX's `jax_relax`: the same energy, step and history, in
float32 on the coordinates' device, its gradient from `torch.autograd.grad`
of that energy. JAX runs the loop as one jitted `lax.scan`; here it is an
eager Python loop of `iters` steps (capturing it as one graph is ROADMAP
A8-relax-capture). Structures cross the PyRosetta boundary as (coords
(L * 3, 3), sequence) pairs with PDB text as the wire format, written by
the port's `geometry/pdb.py coords_to_pdb`.
"""

from __future__ import annotations

import numpy as np
import torch

from alphafold2_tpu_torch.device import resolve_device

try:  # optional, as in the JAX package
    import pyrosetta  # type: ignore

    _HAS_PYROSETTA = True
except Exception:
    pyrosetta = None
    _HAS_PYROSETTA = False

# ideal backbone bond lengths (Angstrom)
IDEAL_N_CA = 1.458
IDEAL_CA_C = 1.525
IDEAL_C_N = 1.329


def pyrosetta_available() -> bool:
    return _HAS_PYROSETTA


# --- the pose <-> array contract ----------------------------------------------------


def coords_to_pose(coords, sequence: str):
    """(L * 3, 3) N/CA/C coords + sequence -> a PyRosetta pose, through a
    PDB file. Requires PyRosetta."""
    if not _HAS_PYROSETTA:
        raise ImportError("PyRosetta is not installed")
    import os
    import tempfile

    from alphafold2_tpu_torch.geometry.pdb import coords_to_pdb

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "pose.pdb")
        coords_to_pdb(path, np.asarray(coords), sequence=sequence)
        return pyrosetta.pose_from_pdb(path)


def pose_to_coords(pose) -> np.ndarray:
    """A PyRosetta pose -> (L * 3, 3) N/CA/C coords (float64)."""
    if not _HAS_PYROSETTA:
        raise ImportError("PyRosetta is not installed")
    out = []
    for i in range(1, pose.total_residue() + 1):
        res = pose.residue(i)
        for name in ("N", "CA", "C"):
            v = res.xyz(name)
            out.append([v.x, v.y, v.z])
    return np.asarray(out, np.float64)


# --- the relaxation -----------------------------------------------------------------


def backbone_bond_energy(coords, mask=None, peptide_mask=None):
    """Sum of squared deviations from the ideal backbone bond lengths, one
    value a structure: (b,).

    coords: (b, L * 3, 3) tensor in N/CA/C order, differentiable. mask: (b,
    L) bool or float, a residue's bonds count where it is set (a peptide
    bond where both its residues are). peptide_mask: (b, L - 1), the
    peptide bond between residues i and i + 1 counts where it is set: mark
    chain breaks and numbering gaps False, or the energy welds unrelated
    residues together with a 1.329 A bond."""
    coords = torch.as_tensor(coords).float()
    bb = coords.reshape(coords.shape[0], -1, 3, 3)  # (b, L, 3, 3)

    def bond(a, b_):
        return torch.sqrt(((a - b_) ** 2).sum(dim=-1) + 1e-12)

    n_ca = bond(bb[:, :, 0], bb[:, :, 1]) - IDEAL_N_CA  # (b, L)
    ca_c = bond(bb[:, :, 1], bb[:, :, 2]) - IDEAL_CA_C
    c_n = bond(bb[:, :-1, 2], bb[:, 1:, 0]) - IDEAL_C_N  # the peptide bond
    if mask is not None:
        mask_b = torch.as_tensor(mask, device=coords.device).bool()
        n_ca = n_ca * mask_b.to(n_ca.dtype)
        ca_c = ca_c * mask_b.to(ca_c.dtype)
        c_n = c_n * (mask_b[:, :-1] & mask_b[:, 1:]).to(c_n.dtype)
    if peptide_mask is not None:
        c_n = c_n * torch.as_tensor(peptide_mask, device=coords.device).bool().to(c_n.dtype)
    return (n_ca ** 2 + ca_c ** 2).sum(dim=-1) + (c_n ** 2).sum(dim=-1)


def relax(coords, mask=None, iters: int = 100, lr: float = 0.05, peptide_mask=None,
          device=None):
    """Geometric relaxation: `iters` gradient-descent steps at `lr` on
    sum(backbone_bond_energy + 0.01 * |c - input|^2), restoring ideal
    backbone bond lengths while staying close to the input (JAX's
    `jax_relax`).

    coords: (b, L * 3, 3) or (L * 3, 3) N/CA/C backbone, a tensor (the run
    takes its device) or an array (on `device`: default CUDA, "cpu" for
    the CPU). mask: (b, L) or (L,), bool or float; peptide_mask: (b, L - 1)
    or (L - 1,), False across chain breaks and gaps (`backbone_bond_energy`).
    Returns (the relaxed coords, the energy history (iters, b)), both f32 on
    the run's device; (L * 3, 3) and (iters,) for unbatched coords. Inputs
    made under `torch.inference_mode()` (a prediction's) are taken too: the
    loop runs on a plain copy with grad enabled."""
    dev = coords.device if isinstance(coords, torch.Tensor) else resolve_device(device)
    with torch.inference_mode(False), torch.enable_grad():
        c = torch.as_tensor(coords).to(dev, torch.float32).clone()
        squeeze = c.dim() == 2
        if squeeze:
            c = c[None]
        if mask is not None:
            mask = torch.as_tensor(mask).to(dev).clone()
            mask = mask[None] if mask.dim() == 1 else mask
        if peptide_mask is not None:
            peptide_mask = torch.as_tensor(peptide_mask).to(dev).clone()
            peptide_mask = peptide_mask[None] if peptide_mask.dim() == 1 else peptide_mask
        anchor = c
        history = []
        for _ in range(iters):
            c = c.detach().requires_grad_(True)
            e = backbone_bond_energy(c, mask, peptide_mask)
            # the weak restraint to the input: bonds are repaired without
            # the fold drifting
            rest = 0.01 * ((c - anchor) ** 2).sum(dim=(-1, -2))
            (g,) = torch.autograd.grad((e + rest).sum(), c)
            c = c.detach() - lr * g
            history.append(e.detach())
        hist = torch.stack(history) if history else torch.zeros((0, c.shape[0]), device=dev)
    if squeeze:
        return c[0], hist[:, 0]
    return c, hist


def run_fast_relax(coords, sequence: str, iters: int = 100, peptide_mask=None, device=None):
    """PyRosetta's FastRelax through the pose contract when PyRosetta is
    present and the chain has no breaks; otherwise `relax` on `device`
    (default CUDA, "cpu" for the CPU). coords: (L * 3, 3); peptide_mask:
    (L - 1,) bool, False across chain breaks and gaps. Returns (L * 3, 3)
    numpy coords."""
    has_breaks = peptide_mask is not None and not bool(np.all(np.asarray(peptide_mask)))
    if _HAS_PYROSETTA and not has_breaks:
        pose = coords_to_pose(np.asarray(coords), sequence)
        scorefxn = pyrosetta.get_fa_scorefxn()
        fast_relax = pyrosetta.rosetta.protocols.relax.FastRelax()
        fast_relax.set_scorefxn(scorefxn)
        fast_relax.apply(pose)
        return pose_to_coords(pose)
    if _HAS_PYROSETTA and has_breaks:
        # the pose contract renumbers residues into one continuous chain, so
        # FastRelax would bond the breaks that peptide_mask keeps apart
        print("run_fast_relax: chain breaks present; using the relax fallback "
              "(the single-chain pose contract cannot represent breaks)")
    relaxed, _ = relax(np.asarray(coords, np.float32), iters=iters,
                       peptide_mask=peptide_mask, device=device)
    return relaxed.cpu().numpy()
