"""Geometry: distogram centering, stress-majorisation MDS, dihedrals and
the chirality fix, Kabsch alignment, structure metrics, atom masks, NeRF
side-chain building and PDB I/O (counterpart of
alphafold2_tpu/geometry/__init__.py, whose names it re-exports)."""

from alphafold2_tpu_torch.geometry.dihedral import calc_phis, get_dihedral
from alphafold2_tpu_torch.geometry.distogram import center_distogram, distogram_confidence
from alphafold2_tpu_torch.geometry.kabsch import Kabsch, kabsch
from alphafold2_tpu_torch.geometry.masks import scn_backbone_mask, scn_cloud_mask
from alphafold2_tpu_torch.geometry.mds import MDScaling, mds, mdscaling
from alphafold2_tpu_torch.geometry.metrics import GDT, RMSD, TMscore, gdt, rmsd, tmscore
from alphafold2_tpu_torch.geometry.sidechain import nerf, sidechain_container

__all__ = [
    "center_distogram",
    "distogram_confidence",
    "mds",
    "mdscaling",
    "MDScaling",
    "get_dihedral",
    "calc_phis",
    "kabsch",
    "Kabsch",
    "rmsd",
    "gdt",
    "tmscore",
    "RMSD",
    "GDT",
    "TMscore",
    "scn_backbone_mask",
    "scn_cloud_mask",
    "nerf",
    "sidechain_container",
]
