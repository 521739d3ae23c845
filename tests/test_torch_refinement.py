"""The port's relaxation (alphafold2_tpu_torch/refinement.py, refine.py)
against the JAX package's (alphafold2_tpu/refinement.py,
scripts/refinement.py) on the CPU, float32, on the same inputs.

Tolerances: the same f32 function, summed in another order, descended by
the same steps: relaxed coords within 1e-4 A and the energy history within
1e-5 * max(1, |ref|) of `jax_relax` at 200 iterations; the energy itself
1e-5 * max(1, |ref|); the refine CLI's PDB coordinates within 1e-3 A of the
JAX script's (the file's three decimals).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from alphafold2_tpu import refinement as jref
from alphafold2_tpu_torch import refinement as tref
from alphafold2_tpu_torch.geometry.pdb import PdbAtom, PdbStructure, parse_pdb, write_pdb

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def backbone(L=12, seed=0, noise=0.4):
    """A helix backbone (L * 3, 3) with bond-length-distorting noise."""
    t = 0.6 * np.arange(3 * L)
    bb = np.stack([2 * np.cos(t), 2 * np.sin(t), -0.16 * t], -1).astype(np.float32)
    return bb + noise * np.random.RandomState(seed).randn(*bb.shape).astype(np.float32)


def close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def history_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (np.abs(got.numpy() - want) <= 1e-5 * np.maximum(1.0, np.abs(want))).all()


CASES = {
    "unbatched": dict(),
    "bool_mask_1d": dict(mask="bool1d"),
    "float_mask_1d": dict(mask="float1d"),
    "peptide_mask_1d": dict(peptide="1d"),
    "batched": dict(batch=2),
    "batched_float_mask": dict(batch=2, mask="float2d", peptide="2d"),
    "batched_bool_mask": dict(batch=2, mask="bool2d"),
}


def case_inputs(spec, L=12):
    rs = np.random.RandomState(3)
    b = spec.get("batch")
    coords = (np.stack([backbone(L, seed=s) for s in range(b)]) if b else backbone(L))
    kw = {}
    kind = spec.get("mask")
    if kind:
        shape = (b, L) if kind.endswith("2d") else (L,)
        m = rs.rand(*shape) > 0.2
        kw["mask"] = m if kind.startswith("bool") else m.astype(np.float32) * 0.7
    if spec.get("peptide"):
        shape = (b, L - 1) if spec["peptide"] == "2d" else (L - 1,)
        p = np.ones(shape, bool)
        p[..., 4] = False
        kw["peptide_mask"] = p
    return coords, kw


@pytest.mark.parametrize("case", list(CASES))
def test_relax_matches_jax(case):
    coords, kw = case_inputs(CASES[case])
    want, want_hist = jref.jax_relax(coords, iters=200, **kw)
    got, got_hist = tref.relax(torch.from_numpy(coords), iters=200, **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    close(got, want, 1e-4)
    history_close(got_hist, want_hist)


@pytest.mark.parametrize("case", list(CASES))
def test_bond_energy_matches_jax(case):
    coords, kw = case_inputs(CASES[case])
    batched = coords if coords.ndim == 3 else coords[None]
    kw = {k: (v if v.ndim == 2 else v[None]) for k, v in kw.items()}
    want = np.asarray(jref.backbone_bond_energy(batched, **kw))
    got = tref.backbone_bond_energy(torch.from_numpy(batched), **kw)
    assert (np.abs(got.numpy() - want) <= 1e-5 * np.maximum(1.0, np.abs(want))).all()


def test_relax_reduces_the_energy_and_keeps_chains_apart():
    a = backbone(L=6, seed=5, noise=0.05)
    b = backbone(L=6, seed=6, noise=0.05) + np.asarray([30.0, 0, 0], np.float32)
    bb = np.concatenate([a, b])
    pmask = np.ones(11, bool)
    pmask[5] = False
    relaxed, hist = tref.relax(bb, iters=200, peptide_mask=pmask, device="cpu")
    assert float(hist[-1]) < float(hist[0])
    gap_before = np.linalg.norm(bb[5 * 3 + 2] - bb[6 * 3])
    gap_after = float(torch.linalg.norm(relaxed[5 * 3 + 2] - relaxed[6 * 3]))
    assert gap_after > 0.8 * gap_before
    welded, _ = tref.relax(bb, iters=200, device="cpu")
    assert float(torch.linalg.norm(welded[5 * 3 + 2] - welded[6 * 3])) < 0.5 * gap_before


def test_relax_takes_inference_mode_tensors():
    """A prediction's coordinates (made under torch.inference_mode) relax
    as a plain tensor's do, inside or outside inference mode."""
    coords = backbone(seed=7)
    want, want_hist = tref.relax(torch.from_numpy(coords), iters=20)
    with torch.inference_mode():
        inf = torch.from_numpy(coords).clone() * 1.0
        mask = torch.ones(12, dtype=torch.bool)
        assert inf.is_inference()
        inside, _ = tref.relax(inf, mask=mask, iters=20)
    outside, hist = tref.relax(inf, iters=20)
    assert torch.equal(inside, want) and torch.equal(outside, want)
    assert torch.equal(hist, want_hist)


def test_relax_arrays_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tref.relax(backbone(), iters=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tref.run_fast_relax(backbone(), "A" * 12, iters=2)
    relaxed, hist = tref.relax(backbone(), iters=2, device="cpu")
    assert relaxed.shape == (36, 3) and hist.shape == (2,)


def test_run_fast_relax_without_pyrosetta():
    assert tref.pyrosetta_available() == jref.pyrosetta_available() is False
    bb = backbone(seed=2)
    pmask = np.ones(11, bool)
    pmask[3] = False
    for kw in ({}, {"peptide_mask": pmask}):
        got = tref.run_fast_relax(bb, "A" * 12, iters=100, device="cpu", **kw)
        want = np.asarray(jref.run_fast_relax(bb, "A" * 12, iters=100, **kw))
        assert isinstance(got, np.ndarray) and got.shape == bb.shape
        close(got, want, 1e-4)


def test_pose_contract_needs_pyrosetta():
    with pytest.raises(ImportError, match="PyRosetta"):
        tref.coords_to_pose(backbone(), "A" * 12)
    with pytest.raises(ImportError, match="PyRosetta"):
        tref.pose_to_coords(object())


def gapped_pdb(path):
    """Chain A residues 1-6 with residue 4's C missing, a numbering gap to
    9-10, and chain B residues 1-4; CA B-factors 10 * residue."""
    bb = backbone(L=12, seed=9, noise=0.3).reshape(12, 3, 3)
    keys = [("A", n) for n in (1, 2, 3, 4, 5, 6, 9, 10)] + [("B", n) for n in (1, 2, 3, 4)]
    atoms, serial = [], 1
    for r, (chain, num) in enumerate(keys):
        for a, name in enumerate(("N", "CA", "C")):
            if (chain, num, name) == ("A", 4, "C"):
                continue
            atoms.append(PdbAtom(serial, name, "GLY" if r % 2 else "ALA", chain, num,
                                 bb[r, a].astype(np.float64), name[0],
                                 bfactor=10.0 * r if name == "CA" else 0.0))
            serial += 1
    write_pdb(str(path), PdbStructure(atoms))


def test_refine_cli_matches_the_jax_script(tmp_path, capsys):
    from alphafold2_tpu_torch.refine import main

    src, ours, theirs = tmp_path / "in.pdb", tmp_path / "ours.pdb", tmp_path / "jax.pdb"
    gapped_pdb(src)
    main([str(src), str(ours), "--iters", "200", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dropping 1 residue(s)" in out and "3 chain break(s)/gap(s)" in out
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "scripts/refinement.py", str(src), str(theirs),
                          "--iters", "200"], cwd=REPO_ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    got, want = parse_pdb(str(ours)), parse_pdb(str(theirs))
    assert [(a.name, a.res_name, a.res_seq) for a in got.atoms] == \
        [(a.name, a.res_name, a.res_seq) for a in want.atoms]
    assert len(got.atoms) == 33
    close(got.coords(), want.coords(), 1e-3)
    assert [a.bfactor for a in got.atoms] == [a.bfactor for a in want.atoms]
    assert {a.bfactor for a in got.atoms} != {0.0}


def test_refine_cli_refuses_the_cpu_unless_asked(tmp_path, monkeypatch):
    from alphafold2_tpu_torch.refine import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.pdb"
    gapped_pdb(src)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([str(src), str(tmp_path / "out.pdb"), "--iters", "2"])
    assert not (tmp_path / "out.pdb").exists()

