"""`predict_structure` end to end, port vs JAX package, float32 on the CPU,
on the same parameters (alphafold2_init -> params_from_jax) and inputs.

Logits and confidence are held tightly (the same float32 function in
another summation order: bound 5e-6). MDS is defined only up to a rigid
transform and the classical init's eigenvector signs may flip between the
two `eigh` calls, so coordinates are compared through their pairwise
distance matrices, never raw. With random weights the distogram is near
uniform and the init's top eigenvalues can be close to degenerate, where
the two eigensolvers may part ways; `test_mds_on_a_helix` therefore holds
the geometry itself on a well-conditioned input (a helix's exact
distances), and the model-driven comparison bounds distances at 1e-3 A
and stress at 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.geometry.mds import mds as jax_mds
from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.serving.pipeline import predict_structure as jax_predict
from alphafold2_tpu_torch import Alphafold2Config, params_from_jax, predict_structure
from alphafold2_tpu_torch.geometry.mds import mds

KW = dict(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=32)


def pairwise(c):
    c = np.asarray(c, np.float64)
    return np.linalg.norm(c[:, :, None] - c[:, None], axis=-1)


def run_both(kw, tokens, mask, msa, msa_mask, iters):
    jcfg = JaxConfig(**kw)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tcfg = Alphafold2Config(**kw)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                              device="cpu")
    j = jax.jit(lambda p, t, m, a, am: jax_predict(
        p, jcfg, t, mask=m, msa=a, msa_mask=am, mds_iters=iters))(
        jparams, tokens, mask, msa, msa_mask)
    t = predict_structure(tparams, tcfg, tokens, mask=mask, msa=msa, msa_mask=msa_mask,
                          mds_iters=iters, device="cpu")
    return {k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()}


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_predict_structure_padded_batch(flash):
    rng = np.random.default_rng(0)
    b, L, rows = 2, 16, 3
    tokens = rng.integers(0, 20, (b, L)).astype(np.int32)
    mask = np.ones((b, L), bool)
    mask[1, 11:] = False  # the second request is 11 residues, padded to 16
    tokens[~mask] = 20
    msa = rng.integers(0, 21, (b, rows, L)).astype(np.int32)
    msa_mask = np.broadcast_to(mask[:, None], (b, rows, L)).copy()
    j, t = run_both(dict(KW, attn_flash=flash), tokens, mask, msa, msa_mask, iters=50)

    assert t["coords"].shape == (b, L, 3) and t["confidence"].shape == (b, L)
    assert all(np.isfinite(v).all() for v in t.values())
    pair = mask[:, :, None] & mask[:, None, :]
    np.testing.assert_allclose(t["distogram_logits"][pair], j["distogram_logits"][pair],
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(t["confidence"], j["confidence"], rtol=0, atol=5e-6)
    assert (t["confidence"][~mask] == 0).all()
    np.testing.assert_allclose(t["stress"], j["stress"], rtol=1e-4)
    dt, dj = pairwise(t["coords"]), pairwise(j["coords"])
    np.testing.assert_allclose(dt[pair], dj[pair], rtol=0, atol=1e-3)


def test_mds_on_a_helix():
    """Classical init + Guttman steps on a helix's exact distances (the
    verify skill's geometry flow): well-separated eigenvalues, so both
    sides reconstruct the same shape; distances agree to 1e-4 A."""
    t = 0.6 * np.arange(40)
    helix = np.stack([2 * np.cos(t), 2 * np.sin(t), -0.16 * t], axis=-1)
    d = pairwise(helix[None]).astype(np.float32)
    w = np.ones_like(d)
    w[0, 3, 7] = w[0, 7, 3] = 0.2  # a non-uniform weight
    jc, js = jax_mds(jnp.asarray(d), weights=jnp.asarray(w), iters=20, tol=-jnp.inf,
                     init="classical")
    tc, ts = mds(torch.from_numpy(d), weights=torch.from_numpy(w), iters=20,
                 tol=float("-inf"), init="classical")
    assert ts.shape == (20, 1)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3, atol=1e-6)
    dj = pairwise(np.asarray(jc).transpose(0, 2, 1))
    dt = pairwise(tc.numpy().transpose(0, 2, 1))
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-4)


def _write_a3m(path, query, rows):
    rng = np.random.default_rng(3)
    alphabet = np.array(list("ACDEFGHIKLMNPQRSTVWY-"))
    lines = [">query", query]
    for n in range(rows - 1):
        lines += [f">hit{n}", "".join(rng.choice(alphabet, len(query)))]
    path.write_text("\n".join(lines) + "\n")


def test_msa_and_tokens_match_the_jax_package(tmp_path):
    from alphafold2_tpu.constants import aa_to_tokens as jax_tokens
    from alphafold2_tpu.utils.msa import load_msa as jax_load_msa
    from alphafold2_tpu_torch.constants import aa_to_tokens
    from alphafold2_tpu_torch.utils.msa import load_msa

    query = "MKTAYIAKQRQISFVKSHFSRQ"
    aln = tmp_path / "aln.a3m"
    _write_a3m(aln, query, rows=6)
    for a, b in zip(load_msa(str(aln), query=query, max_rows=4),
                    jax_load_msa(str(aln), query=query, max_rows=4)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(aa_to_tokens(query + "XB"), jax_tokens(query + "XB"))


def test_predict_cli_writes_a_ca_trace(tmp_path):
    """`python -m alphafold2_tpu_torch.predict` on the CPU at a toy width:
    the PDB holds one CA per residue, in order, with confidence x100 as
    B-factors, and parses back with the JAX package's reader too."""
    from alphafold2_tpu.geometry.pdb import parse_pdb as jax_parse_pdb
    from alphafold2_tpu_torch.geometry.pdb import parse_pdb
    from alphafold2_tpu_torch.predict import main

    query = "MKTAYIAKQRQISFVKSHFSRQ"
    aln, out = tmp_path / "aln.a3m", tmp_path / "out.pdb"
    _write_a3m(aln, query, rows=4)
    main(["--seq", query, "--msa-file", str(aln), "--out", str(out), "--dim", "16",
          "--depth", "1", "--heads", "2", "--dim-head", "8", "--mds-iters", "5",
          "--device", "cpu"])
    s = parse_pdb(str(out))
    assert s.sequence() == query
    assert [a.name for a in s.atoms] == ["CA"] * len(query)
    assert np.isfinite(s.coords()).all()
    assert all(0.0 <= a.bfactor <= 100.0 for a in s.atoms)
    np.testing.assert_allclose(jax_parse_pdb(str(out)).coords(), s.coords())


def test_mds_random_init_takes_a_generator():
    d = torch.rand(1, 6, 6)
    d = d + d.transpose(1, 2)
    a = mds(d, iters=3, init="random", generator=torch.Generator().manual_seed(4))[0]
    b = mds(d, iters=3, init="random", generator=torch.Generator().manual_seed(4))[0]
    assert torch.equal(a, b)
