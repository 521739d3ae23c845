"""End-to-end structure prediction's forward (`training/e2e.py
predict_structure`) and `predict --full-atom`, port vs JAX package,
float32 on the CPU, on the same parameters (e2e_params_init ->
e2e_params_from_jax, the refiner's coordinate head given non-zero weights
first: it is the identity at init) and inputs made from a numpy seed.

Tolerances: logits 5e-6 absolute on valid pairs; distogram_weights 1e-5;
the refined cloud compared through its pairwise distances on the cloud
mask, 1e-3 A (the classical MDS init's eigenvector signs differ between
the two `eigh` calls, so raw coordinates can differ by a rigid motion);
the two packages' phi ratios equal before anything is compared (if they
straddle 0.5 the hands differ: a finding, not noise). The
sequence-parallel forward against the dense one 1e-5 on logits
(tests/test_torch_sp_trunk.py's bound).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import RefinerConfig as JaxRefinerConfig
from alphafold2_tpu.models import embedder as jemb
from alphafold2_tpu.training import e2e as je2e
from alphafold2_tpu_torch.geometry import calc_phis, scn_backbone_mask
from alphafold2_tpu_torch.models import embedder as temb
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.convert import e2e_params_from_jax, embedder_params_from_jax
from alphafold2_tpu_torch.models.refiner import RefinerConfig
from alphafold2_tpu_torch.parallel import alphafold2_apply_sp, make_mesh
from alphafold2_tpu_torch.training import e2e as te2e

SMALL = dict(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=48)
REFINER = dict(num_tokens=14, dim=32, depth=2)
SEQ = "MKTAYIAKQRQISFVKSHFSRQ"


def perturb_coord_head(tree, seed=0):
    """Random non-zero weights for the refiner's coordinate head (numpy tree)."""
    rng = np.random.default_rng(seed)
    for layer in tree["refiner"]["layers"]:
        head = layer["coord_mlp"]["l2"]
        head["w"] = (rng.normal(size=head["w"].shape) * 0.1).astype(np.float32)
        head["b"] = (rng.normal(size=head["b"].shape) * 0.1).astype(np.float32)
    return tree


def make(num_embedds=None, iters=20, **model_kw):
    kw = {**SMALL, **model_kw, **({} if num_embedds is None else {"num_embedds": num_embedds})}
    jcfg = je2e.E2EConfig(model=JaxConfig(**kw), refiner=JaxRefinerConfig(**REFINER),
                          mds_iters=iters, mds_init="classical")
    tcfg = te2e.E2EConfig(model=Alphafold2Config(**kw), refiner=RefinerConfig(**REFINER),
                          mds_iters=iters, mds_init="classical")
    tree = perturb_coord_head(jax.tree_util.tree_map(
        np.asarray, je2e.e2e_params_init(jax.random.PRNGKey(0), jcfg)))
    return jax.tree_util.tree_map(jnp.asarray, tree), jcfg, \
        e2e_params_from_jax(tree, tcfg, device="cpu"), tcfg


def pairwise(c):
    c = np.asarray(c, np.float64)
    return np.linalg.norm(c[:, None] - c[None], axis=-1)


def phi_ratio(proto, L):
    """The fraction of negative phis of the lifted backbone (b, L, 14, 3)."""
    bb = torch.as_tensor(np.asarray(proto))[:, :, :3].reshape(proto.shape[0], 3 * L, 3)
    n_mask, ca_mask = scn_backbone_mask(np.zeros((1, L)), l_aa=3)
    return calc_phis(bb.transpose(1, 2), n_mask, ca_mask).numpy()


def assert_outputs_close(jout, tout, mask, L):
    """The comparison of the module docstring, batch element by element."""
    np.testing.assert_array_equal(phi_ratio(tout["proto"], L), phi_ratio(jout["proto"], L))
    cm = np.asarray(jout["cloud_mask"])
    np.testing.assert_array_equal(tout["cloud_mask"].numpy(), cm)
    pair3 = np.repeat(mask, 3, axis=1)
    pair3 = pair3[:, :, None] & pair3[:, None, :]
    tl, jl = tout["distogram_logits"].numpy(), np.asarray(jout["distogram_logits"])
    np.testing.assert_allclose(tl[pair3], jl[pair3], rtol=0, atol=5e-6)
    np.testing.assert_allclose(tout["distogram_weights"].numpy(),
                               np.asarray(jout["distogram_weights"]), rtol=0, atol=1e-5)
    for b in range(cm.shape[0]):
        sel = cm[b].reshape(-1)
        tr = tout["refined"][b].reshape(-1, 3).numpy()[sel]
        jr = np.asarray(jout["refined"])[b].reshape(-1, 3)[sel]
        np.testing.assert_allclose(pairwise(tr), pairwise(jr), rtol=0, atol=1e-3)
        assert np.abs(tr - tout["proto"][b].reshape(-1, 3).numpy()[sel]).max() > 1e-3


@pytest.mark.parametrize("stream", ["msa", "embedds", "none"])
def test_predict_structure_matches_jax(stream):
    """e2e predict_structure with an MSA (and padded residues), with
    per-atom embeddings, and with neither."""
    L = 12
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 20, (2, L)).astype(np.int32)
    mask = np.ones((2, L), bool)
    kw, jkw = {}, {}
    num_embedds = None
    if stream == "msa":
        mask[1, L - 3:] = False
        seq[~mask] = 20
        msa = rng.integers(0, 21, (2, 3, L)).astype(np.int32)
        kw = dict(mask=mask, msa=msa)
        jkw = dict(mask=jnp.asarray(mask), msa=jnp.asarray(msa))
    elif stream == "embedds":
        num_embedds = 24
        e = rng.normal(size=(2, 3 * L, num_embedds)).astype(np.float32)
        kw, jkw = dict(embedds=e), dict(embedds=jnp.asarray(e))
    jp, jc, tp, tc = make(num_embedds)
    jout = jax.jit(lambda p: je2e.predict_structure(p, jc, jnp.asarray(seq), **jkw))(jp)
    with torch.inference_mode():
        tout = te2e.predict_structure(tp, tc, seq, device="cpu", **kw)
    assert tout["refined"].shape == (2, L, 14, 3)
    assert tout["distogram_logits"].shape == (2, 3 * L, 3 * L, 37)
    assert_outputs_close(jout, tout, mask, L)


def test_embed_sequences_feed_the_e2e_forward_as_train_end2end_does():
    """The library drive of `train_end2end --features esm`: embed_sequences
    -> np.repeat(..., 3, axis=1) -> e2e predict_structure(embedds=...),
    on both packages from the same embedder and model parameters."""
    L = 10
    ecfg_kw = dict(num_layers=1, dim=32, heads=2, max_len=40)
    jec, tec = jemb.EmbedderConfig(**ecfg_kw), temb.EmbedderConfig(**ecfg_kw)
    jep = jemb.embedder_init(jax.random.PRNGKey(5), jec)
    tep = embedder_params_from_jax(jax.tree_util.tree_map(np.asarray, jep), "cpu")
    seq = np.random.default_rng(2).integers(0, 20, (1, L)).astype(np.int32)
    jemb_out = np.repeat(np.asarray(jemb.embed_sequences(jep, jec, seq)), 3, axis=1)
    temb_out = np.repeat(temb.embed_sequences(tep, tec, seq).numpy(), 3, axis=1)
    np.testing.assert_allclose(temb_out, jemb_out, rtol=0, atol=5e-6 * max(1, np.abs(jemb_out).max()))
    jp, jc, tp, tc = make(num_embedds=32)
    jout = jax.jit(lambda p: je2e.predict_structure(p, jc, jnp.asarray(seq),
                                                    embedds=jnp.asarray(jemb_out)))(jp)
    with torch.inference_mode():
        tout = te2e.predict_structure(tp, tc, seq, embedds=temb_out, device="cpu")
    assert_outputs_close(jout, tout, np.ones((1, L), bool), L)


def test_templates_and_the_sp_forward():
    """Templates over the 3L grid reach the trunk (the logits move) and
    match JAX; the sequence-parallel forward (4 CPU shards) as
    model_apply_fn gives the dense forward's logits (1e-5)."""
    L = 8
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 20, (1, L)).astype(np.int32)
    templates = rng.integers(0, 37, (1, 2, 3 * L, 3 * L)).astype(np.int32)
    tmask = rng.random((1, 2, 3 * L, 3 * L)) > 0.3
    jp, jc, tp, tc = make()
    jout = jax.jit(lambda p: je2e.predict_structure(
        p, jc, jnp.asarray(seq), templates=jnp.asarray(templates),
        templates_mask=jnp.asarray(tmask)))(jp)
    with torch.inference_mode():
        tout = te2e.predict_structure(tp, tc, seq, templates=templates, templates_mask=tmask,
                                      device="cpu")
        plain = te2e.predict_structure(tp, tc, seq, device="cpu")
        mesh = make_mesh({"seq": 4}, devices=["cpu"] * 4)
        sp = te2e.predict_structure(tp, tc, seq,
                                    model_apply_fn=functools.partial(alphafold2_apply_sp, mesh=mesh))
    assert_outputs_close(jout, tout, np.ones((1, L), bool), L)
    assert (tout["distogram_logits"] - plain["distogram_logits"]).abs().max() > 1e-4
    torch.testing.assert_close(sp["distogram_logits"], plain["distogram_logits"],
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="places its own work"):
        te2e.predict_structure(tp, tc, seq, device="cpu",
                               model_apply_fn=functools.partial(alphafold2_apply_sp, mesh=mesh))


def test_config_defaults_match_and_training_is_refused():
    jfields = {f.name: f.default for f in __import__("dataclasses").fields(je2e.E2EConfig)}
    tfields = {f.name: f.default for f in __import__("dataclasses").fields(te2e.E2EConfig)}
    assert sorted(jfields) == sorted(tfields)
    for name in jfields:
        if name not in ("model", "refiner"):
            assert tfields[name] == jfields[name], name
    assert te2e.E2EConfig.__dataclass_fields__["refiner"].default.num_tokens == 14
    with pytest.raises(NotImplementedError, match="A8-e2e-train"):
        te2e.make_e2e_loss_fn()
    with pytest.raises(NotImplementedError, match="A8-e2e-train"):
        te2e.e2e_train_state_init()


def test_stage_hook_wraps_each_stage_once_in_order():
    """predict_structure's `stage` hook (a timer's seam) is entered once a
    stage, in the forward's order, and leaves every output bit-equal."""
    import contextlib

    _, _, tp, tc = make(iters=5)
    seq = np.random.default_rng(5).integers(0, 20, (1, 8)).astype(np.int32)
    seen = []

    @contextlib.contextmanager
    def stage(name):
        seen.append(name)
        yield

    with torch.inference_mode():
        plain = te2e.predict_structure(tp, tc, seq, device="cpu")
        hooked = te2e.predict_structure(tp, tc, seq, device="cpu", stage=stage)
    assert seen == ["trunk", "distogram", "mds", "sidechain", "refiner"]
    for key, value in plain.items():
        assert torch.equal(value, hooked[key]), key


# --- the CLI ----------------------------------------------------------------------

CLI = ["--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8", "--mds-iters", "5",
       "--device", "cpu"]


def run_cli(tmp_path, *extra, name="f.pdb", seq=SEQ):
    from alphafold2_tpu_torch.geometry.pdb import parse_pdb
    from alphafold2_tpu_torch.predict import main

    out = tmp_path / name
    main(["--seq", seq, "--full-atom", "--out", str(out), *CLI, *extra])
    s = parse_pdb(str(out))
    assert [a.name for a in s.atoms] == ["N", "CA", "C", "O"] * len(seq)
    assert s.sequence() == seq
    assert np.isfinite(s.coords()).all()
    assert all(0.0 <= a.bfactor <= 100.0 for a in s.atoms)
    return s


def test_cli_full_atom_plain_embedds_templates_and_sp(tmp_path, capsys):
    """`predict --full-atom` on the CPU writes 4 L atoms, alone and with each
    of --embedds-file (per residue, elongated x3 inside), --templates-file
    (the 3L grid) and --sp-shards 4, whose structure is the dense run's
    (pairwise distances at 1e-3 A) at 24 residues; at 22 (a 66-token grid)
    4 shards are refused, as in the JAX CLI, since padding would change the
    structure."""
    run_cli(tmp_path)
    assert "full pipeline" in capsys.readouterr().out
    L = len(SEQ)
    np.savez(tmp_path / "e.npz", embedds=np.random.default_rng(0).normal(size=(L, 1280)))
    run_cli(tmp_path, "--embedds-file", str(tmp_path / "e.npz"), name="e.pdb")
    np.savez(tmp_path / "t.npz",
             templates=np.random.default_rng(1).integers(0, 37, (1, 2, 3 * L, 3 * L)))
    run_cli(tmp_path, "--templates-file", str(tmp_path / "t.npz"), name="t.pdb")
    seq24 = SEQ + "GA"
    dense = run_cli(tmp_path, name="dense24.pdb", seq=seq24).coords()
    sp = run_cli(tmp_path, "--sp-shards", "4", name="sp.pdb", seq=seq24).coords()
    assert np.abs(pairwise(sp) - pairwise(dense)).max() <= 1e-3
    capsys.readouterr()
    with pytest.raises(SystemExit):
        run_cli(tmp_path, "--sp-shards", "4", name="sp22.pdb")
    assert "must divide by the shard count" in capsys.readouterr().err
    np.savez(tmp_path / "bad.npz", templates=np.zeros((1, 1, L, L), np.int32))
    with pytest.raises(SystemExit):
        run_cli(tmp_path, "--templates-file", str(tmp_path / "bad.npz"), name="bad.pdb")
    assert "3L, elongated" in capsys.readouterr().err
    with pytest.raises(SystemExit):  # as the JAX CLI: embedds have no row axis to shard
        run_cli(tmp_path, "--embedds-file", str(tmp_path / "e.npz"), "--sp-shards", "4")


def test_cli_full_atom_refuses_int8(tmp_path):
    with pytest.raises(NotImplementedError, match="A8-e2e-int8"):
        run_cli(tmp_path, "--weight-dtype", "int8")


def test_jax_e2e_checkpoint_restores_into_the_full_atom_cli(tmp_path):
    """A JAX end-to-end TrainState (its refiner's coordinate head made
    non-zero) saved by the JAX package's verified manager: the port's
    restore copies its {"model", "refiner"} params bit for bit, and
    `predict --full-atom --ckpt-dir` writes the backbone JAX's
    predict_structure gives on them (pairwise distances, 1e-3 A plus the
    PDB format's rounding)."""
    from alphafold2_tpu.training import TrainConfig as JaxTrainConfig
    from alphafold2_tpu.training.checkpoint import VerifiedCheckpointManager as JaxManager
    from alphafold2_tpu_torch.geometry.pdb import parse_pdb
    from alphafold2_tpu_torch.models.convert import leaf_paths, params_to_jax
    from alphafold2_tpu_torch.predict import main
    from alphafold2_tpu_torch.training.checkpoint import restore_params_for_inference

    L = len(SEQ)
    mkw = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=3 * L)
    jcfg = je2e.E2EConfig(model=JaxConfig(**mkw), refiner=JaxRefinerConfig(num_tokens=14),
                          mds_iters=5, mds_init="classical")
    state = je2e.e2e_train_state_init(jax.random.PRNGKey(0), jcfg, JaxTrainConfig())
    host = jax.tree_util.tree_map(np.asarray, state)
    host["params"] = perturb_coord_head(host["params"])
    state = jax.tree_util.tree_map(jnp.asarray, host)
    JaxManager(str(tmp_path / "ck")).save(state, force=True)

    tcfg = te2e.E2EConfig(model=Alphafold2Config(**mkw), refiner=RefinerConfig(num_tokens=14),
                          mds_iters=5, mds_init="classical")
    params, step, resumed = restore_params_for_inference(
        str(tmp_path / "ck"),
        lambda: te2e.e2e_params_init(tcfg, torch.Generator().manual_seed(9), "cpu"))
    assert resumed
    want = dict((json.dumps(p), a) for p, a in leaf_paths(host["params"]))
    got = list(leaf_paths(params_to_jax(params)))
    assert len(got) == len(want)
    for p, a in got:
        np.testing.assert_array_equal(a, want[json.dumps(p)])

    out = tmp_path / "ck.pdb"
    main(["--seq", SEQ, "--full-atom", "--out", str(out), "--ckpt-dir", str(tmp_path / "ck"),
          "--max-seq-len", str(3 * L), *CLI])
    tokens = np.asarray([["ACDEFGHIKLMNPQRSTVWY".index(c) for c in SEQ]], np.int32)
    jout = jax.jit(lambda p: je2e.predict_structure(p, jcfg, jnp.asarray(tokens)))(
        state["params"])
    jbb = np.asarray(jout["refined"])[0, :, :4].reshape(-1, 3)
    # a PDB coordinate carries 3 decimals: up to 2e-3 A more on a distance
    np.testing.assert_allclose(pairwise(parse_pdb(str(out)).coords()), pairwise(jbb),
                               rtol=0, atol=1e-3 + 2e-3)
