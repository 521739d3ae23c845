"""Relaxation entry point: PDB in -> relaxed PDB out (counterpart of
scripts/refinement.py).

Usage:
  python -m alphafold2_tpu_torch.refine in.pdb out.pdb [--iters 200]
  python -m alphafold2_tpu_torch.refine in.pdb out.pdb --device cpu

Keeps the residues with a complete N/CA/C backbone (and warns about the
ones dropped), marks a peptide bond only between residues of one chain
with consecutive numbering, relaxes through `refinement.py
run_fast_relax` (PyRosetta's FastRelax when it is installed and the chain
has no breaks, else `relax`) and writes the N/CA/C atoms with the input's
CA B-factors (a prediction's confidence). Runs on the GPU unless `--device
cpu` is given, and never falls back to the CPU (the JAX script forces the
CPU).
"""

from __future__ import annotations

import argparse

import numpy as np

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.geometry.pdb import THREE_TO_ONE, coords_to_pdb, parse_pdb
from alphafold2_tpu_torch.refinement import pyrosetta_available, run_fast_relax


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    structure = parse_pdb(args.input).select_atoms(("N", "CA", "C"))
    # a partial residue would misalign every later atom triplet
    by_res = {}
    for a in structure.atoms:
        by_res.setdefault((a.chain_id, a.res_seq), {})[a.name] = a
    complete = [k for k, atoms in sorted(by_res.items()) if {"N", "CA", "C"} <= set(atoms)]
    dropped = len(by_res) - len(complete)
    if dropped:
        print(f"warning: dropping {dropped} residue(s) with incomplete backbone")
    seq = "".join(THREE_TO_ONE.get(by_res[k]["CA"].res_name, "X") for k in complete)
    coords = np.asarray([by_res[k][n].xyz for k in complete for n in ("N", "CA", "C")])
    # peptide bonds only within a chain between consecutive numbers: breaks
    # and gaps (the dropped residues' too) are not welded
    peptide_mask = np.asarray(
        [complete[i][0] == complete[i + 1][0] and complete[i + 1][1] == complete[i][1] + 1
         for i in range(len(complete) - 1)], bool)
    n_breaks = int((~peptide_mask).sum())
    if n_breaks:
        print(f"note: {n_breaks} chain break(s)/gap(s) excluded from relaxation")
    backend = "pyrosetta FastRelax" if pyrosetta_available() else f"relax on {device}"
    print(f"relaxing {len(seq)} residues via {backend}")
    relaxed = run_fast_relax(coords, seq, iters=args.iters, peptide_mask=peptide_mask,
                             device=device)
    # relaxation moves atoms, not confidence
    bfactors = np.asarray([by_res[k]["CA"].bfactor for k in complete])
    coords_to_pdb(args.output, relaxed, sequence=seq,
                  bfactors=bfactors if bfactors.any() else None)
    print(f"wrote {args.output}")
    return relaxed


if __name__ == "__main__":
    main()
