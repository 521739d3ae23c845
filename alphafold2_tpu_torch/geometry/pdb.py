"""Host-side PDB I/O (pure Python): a copy of the writing and parsing
half of alphafold2_tpu/geometry/pdb.py, kept here so the port imports
nothing of the JAX package. Nothing here touches the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# standard 3-letter residue names for our vocabulary
AA_THREE = {
    "A": "ALA", "C": "CYS", "D": "ASP", "E": "GLU", "F": "PHE",
    "G": "GLY", "H": "HIS", "I": "ILE", "K": "LYS", "L": "LEU",
    "M": "MET", "N": "ASN", "P": "PRO", "Q": "GLN", "R": "ARG",
    "S": "SER", "T": "THR", "V": "VAL", "W": "TRP", "Y": "TYR",
}
THREE_TO_ONE = {v: k for k, v in AA_THREE.items()}

BACKBONE_ATOM_NAMES = ("N", "CA", "C", "O")


@dataclass
class PdbAtom:
    serial: int
    name: str
    res_name: str
    chain_id: str
    res_seq: int
    xyz: np.ndarray
    element: str = ""
    bfactor: float = 0.0  # carries per-residue confidence (pLDDT-style)


@dataclass
class PdbStructure:
    atoms: List[PdbAtom] = field(default_factory=list)

    def coords(self) -> np.ndarray:
        return np.stack([a.xyz for a in self.atoms]) if self.atoms else np.zeros((0, 3))

    def select_chain(self, chain_id: str) -> "PdbStructure":
        return PdbStructure([a for a in self.atoms if a.chain_id == chain_id])

    def select_atoms(self, names) -> "PdbStructure":
        names = set(names)
        return PdbStructure([a for a in self.atoms if a.name in names])

    def chains(self) -> List[str]:
        seen = []
        for a in self.atoms:
            if a.chain_id not in seen:
                seen.append(a.chain_id)
        return seen

    def sequence(self) -> str:
        seq, last = [], None
        for a in self.atoms:
            key = (a.chain_id, a.res_seq)
            if key != last:
                seq.append(THREE_TO_ONE.get(a.res_name, "X"))
                last = key
        return "".join(seq)


def _parse_bfactor(line: str) -> float:
    # tolerant: files in the wild carry blanks or overflow markers ('******'
    # for B > 999.99) in cols 61-66 — junk must not abort the whole parse
    # (and the C++ fast parser's field_f likewise returns 0 on junk)
    try:
        return float(line[60:66])
    except (ValueError, IndexError):
        return 0.0


def parse_pdb(path: str) -> PdbStructure:
    """Parse ATOM records from a PDB file (first model only)."""
    atoms: List[PdbAtom] = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("ENDMDL"):
                break
            if not line.startswith("ATOM"):
                continue
            atoms.append(
                PdbAtom(
                    serial=int(line[6:11]),
                    name=line[12:16].strip(),
                    res_name=line[17:20].strip(),
                    chain_id=line[21].strip() or "A",
                    res_seq=int(line[22:26]),
                    xyz=np.array(
                        [float(line[30:38]), float(line[38:46]), float(line[46:54])]
                    ),
                    element=line[76:78].strip(),
                    bfactor=_parse_bfactor(line),
                )
            )
    return PdbStructure(atoms)


def write_pdb(path: str, structure: PdbStructure) -> str:
    """Write ATOM records to a PDB file."""
    with open(path, "w") as fh:
        for a in structure.atoms:
            name = a.name if len(a.name) == 4 else f" {a.name:<3s}"
            fh.write(
                f"ATOM  {a.serial:5d} {name}{'':1s}{a.res_name:>3s} "
                f"{a.chain_id:1s}{a.res_seq:4d}    "
                f"{a.xyz[0]:8.3f}{a.xyz[1]:8.3f}{a.xyz[2]:8.3f}"
                f"{1.00:6.2f}{a.bfactor:6.2f}          {a.element:>2s}\n"
            )
        fh.write("END\n")
    return path


def coords_to_structure(
    coords,
    sequence: Optional[str] = None,
    atom_names=BACKBONE_ATOM_NAMES[:3],
    chain_id: str = "A",
    bfactors=None,
) -> PdbStructure:
    """Build a PdbStructure from (L, A, 3) or (L*A, 3) coordinates.

    Each residue gets `len(atom_names)` atoms; `sequence` is a one-letter
    string (defaults to poly-alanine). `bfactors`: optional per-residue
    values written to every atom of that residue (confidence convention:
    `distogram_confidence` x 100, pLDDT-style).
    """
    coords = np.asarray(coords, dtype=np.float64).reshape(-1, 3)
    n_per_res = len(atom_names)
    length = coords.shape[0] // n_per_res
    if sequence is None:
        sequence = "A" * length
    if bfactors is not None:
        bfactors = np.asarray(bfactors, dtype=np.float64).reshape(-1)
        if bfactors.shape[0] != length:
            raise ValueError(
                f"bfactors has {bfactors.shape[0]} entries for {length} "
                f"residues"
            )
    atoms = []
    serial = 1
    for i in range(length):
        res3 = AA_THREE.get(sequence[i].upper(), "ALA")
        for j, an in enumerate(atom_names):
            atoms.append(
                PdbAtom(
                    serial=serial,
                    name=an,
                    res_name=res3,
                    chain_id=chain_id,
                    res_seq=i + 1,
                    xyz=coords[i * n_per_res + j],
                    element=an[0],
                    bfactor=float(bfactors[i]) if bfactors is not None else 0.0,
                )
            )
            serial += 1
    return PdbStructure(atoms)


def coords_to_pdb(path: str, coords, sequence: Optional[str] = None, **kwargs) -> str:
    """Convenience: coordinates -> .pdb file (reference `custom2pdb` analog,
    without the RCSB scaffold download)."""
    return write_pdb(path, coords_to_structure(coords, sequence, **kwargs))
