"""The template tower (`models/alphafold2.py template_tower_apply`), port
vs JAX package, float32 on the CPU, on the same parameters
(alphafold2_init -> params_from_jax) and inputs; `predict_structure`, the
sequence-parallel forward and the predict CLI with templates.

Tolerances as tests/test_torch_model.py: the same float32 function in
another summation order, logits 5e-6 absolute on valid pairs (on masked
query rows the dense path's uniform attention and the flash path's
key-side masking give different finite values that no valid output
reads); gradients 2e-6 * max(1, |ref|) per leaf; bf16 under the bf16
bound of tests/test_torch_model.py (0.1 on logits of ~1-3); the SP
forward against the dense one 1e-5 (tests/test_torch_sp_trunk.py);
a request as tests/test_torch_pipeline.py holds one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.constants import DISTANCE_THRESHOLDS as JAX_THRESHOLDS
from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_apply as jax_apply
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_apply, params_from_jax, \
    predict_structure
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.models.alphafold2 import template_buckets
from alphafold2_tpu_torch.parallel import alphafold2_apply_sp, make_mesh

ATOL = 5e-6
SMALL = dict(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=32)


def make_params(seed=0, dtype=None, **kw):
    cfg_kw = {**SMALL, **kw}
    jcfg = JaxConfig(**cfg_kw, **({} if dtype is None else {"dtype": jnp.bfloat16}))
    tcfg = Alphafold2Config(**cfg_kw, **({} if dtype is None else {"dtype": dtype}))
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, jcfg, params_from_jax(tree, tcfg, device="cpu"), tcfg


def make_inputs(L=12, rows=3, T=2, pad=3, seed=1, kind="int"):
    """Seeded tokens, a mask with `pad` padded residues, an MSA, T
    templates (int buckets, or float distances in [0, 25) A) and a partial
    templates_mask."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 20, (1, L)).astype(np.int32)
    mask = np.ones((1, L), bool)
    if pad:
        mask[:, L - pad:] = False
    msa = rng.integers(0, 21, (1, rows, L)).astype(np.int32)
    msa_mask = rng.random((1, rows, L)) > 0.2
    msa_mask[:, 0] = mask
    if kind == "int":
        templates = rng.integers(0, 37, (1, T, L, L)).astype(np.int32)
    else:
        templates = rng.uniform(0.0, 25.0, (1, T, L, L)).astype(np.float32)
    tmask = rng.random((1, T, L, L)) > 0.3
    return seq, mask, msa, msa_mask, templates, tmask


def jax_logits(jparams, jcfg, seq, mask, msa, msa_mask, templates, tmask):
    return np.asarray(jax.jit(
        lambda p, t, tm: jax_apply(p, jcfg, seq, msa, mask=mask, msa_mask=msa_mask,
                                   templates=t, templates_mask=tm))(jparams, templates, tmask))


def assert_valid_close(jl, tl, mask, atol=ATOL):
    assert tl.shape == jl.shape
    assert np.isfinite(tl).all()
    pair = mask[:, :, None] & mask[:, None, :]
    np.testing.assert_allclose(tl[pair], jl[pair], rtol=0, atol=atol)


@pytest.mark.parametrize("masked", [False, True], ids=["no-templates-mask", "templates-mask"])
@pytest.mark.parametrize(
    "kw",
    [dict(attn_flash=False), dict(attn_flash=True), dict(attn_flash=True, attn_gate=True),
     dict(attn_flash=False, attn_gate=True)],
    ids=["dense", "flash", "flash-gate", "dense-gate"],
)
def test_int_templates_match_jax(kw, masked):
    jparams, jcfg, tparams, tcfg = make_params(**kw)
    seq, mask, msa, msa_mask, templates, tmask = make_inputs()
    tmask = tmask if masked else None
    jl = jax_logits(jparams, jcfg, seq, mask, msa, msa_mask, templates, tmask)
    tl = alphafold2_apply(tparams, tcfg, seq, msa, mask=mask, msa_mask=msa_mask,
                          templates=templates, templates_mask=tmask, device="cpu")
    assert_valid_close(jl, tl.numpy(), mask)


def test_templates_without_msa_or_mask_match_jax():
    """Templates on a sequence-only forward with no residue mask (the
    joint attention then runs unmasked), template depth 1."""
    jparams, jcfg, tparams, tcfg = make_params(depth=1, template_attn_depth=1)
    seq, mask, _, _, templates, tmask = make_inputs(pad=0, T=3)
    jl = np.asarray(jax_apply(jparams, jcfg, seq, templates=templates, templates_mask=tmask))
    tl = alphafold2_apply(tparams, tcfg, seq, templates=templates, templates_mask=tmask,
                          device="cpu")
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=ATOL)


@pytest.mark.parametrize("num_buckets", [37, 20])
def test_float_templates_bucket_as_jax(num_buckets):
    """Raw distances are bucketed as the JAX forward buckets them:
    searchsorted over the thresholds but the last (side left), the range
    resampled for another bucket count; integer templates keep their
    values (as int64 ids)."""
    cfg = Alphafold2Config(dim=16, num_buckets=num_buckets)
    raw = np.random.default_rng(0).uniform(0.0, 25.0, (1, 2, 9, 9)).astype(np.float32)
    raw[0, 0, 0, :4] = [2.0, 2.5, 20.0, 19.5]  # on the thresholds themselves
    table = np.asarray(JAX_THRESHOLDS, np.float32)
    bins = table if num_buckets == len(table) else np.linspace(table[0], table[-1],
                                                               num_buckets)
    want = np.asarray(jnp.searchsorted(jnp.asarray(bins[:-1]), jnp.asarray(raw)))
    got = template_buckets(cfg, torch.from_numpy(raw))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) == num_buckets - 1
    ints = torch.from_numpy(want.astype(np.int32))
    assert template_buckets(cfg, ints).dtype == torch.int64
    assert torch.equal(template_buckets(cfg, ints), ints.long())


def test_raw_distance_templates_match_prebinned():
    """Float templates give the same logits as the same distances
    pre-binned (JAX `test_raw_distance_templates_match_prebinned`), and
    JAX's logits for the float templates."""
    jparams, jcfg, tparams, tcfg = make_params(depth=1)
    seq, mask, msa, msa_mask, raw, tmask = make_inputs(kind="float")
    bins = np.asarray(JAX_THRESHOLDS, np.float32)
    prebinned = np.searchsorted(bins[:-1], raw).astype(np.int32)
    assert int(prebinned.max()) == tcfg.num_buckets - 1
    run = functools.partial(alphafold2_apply, tparams, tcfg, seq, msa, mask=mask,
                            msa_mask=msa_mask, templates_mask=tmask, device="cpu")
    out_raw, out_pre = run(templates=raw), run(templates=prebinned)
    assert torch.equal(out_raw, out_pre)
    jl = jax_logits(jparams, jcfg, seq, mask, msa, msa_mask, raw, tmask)
    assert_valid_close(jl, out_raw.numpy(), mask)


def test_config4_templates_compress_tied():
    """BASELINE config 4 (JAX `test_config4_templates_compress_tied`): the
    template tower with KV-compressed cross-attention (ratio 3) and tied
    MSA rows."""
    jparams, jcfg, tparams, tcfg = make_params(dim_head=8, cross_attn_compress_ratio=3,
                                               msa_tie_row_attn=True)
    seq, mask, msa, msa_mask, templates, tmask = make_inputs(L=16)
    jl = jax_logits(jparams, jcfg, seq, mask, msa, msa_mask, templates, tmask)
    tl = alphafold2_apply(tparams, tcfg, seq, msa, mask=mask, msa_mask=msa_mask,
                          templates=templates, templates_mask=tmask, device="cpu")
    assert_valid_close(jl, tl.numpy(), mask)


@pytest.mark.parametrize("flash", [False, True], ids=["jax-dense", "jax-dense-port-flash"])
def test_bf16_templates_run_close(flash):
    """bf16 rounds at other places in the two frameworks: the bound of
    tests/test_torch_model.py's bf16 forward. The JAX side runs the dense
    path: under this suite's XLA settings (tests/conftest.py disables most
    optimizations) its bf16 flash path with templates lies 0.65 from its
    own f32 logits, where its dense path and the port lie within 0.02."""
    jparams, jcfg, _, _ = make_params(dtype=torch.bfloat16, attn_flash=False)
    _, _, tparams, tcfg = make_params(dtype=torch.bfloat16, attn_flash=flash)
    seq, mask, msa, msa_mask, templates, tmask = make_inputs()
    jl = jax_logits(jparams, jcfg, seq, mask, msa, msa_mask, templates, tmask)
    tl = alphafold2_apply(tparams, tcfg, seq, msa, mask=mask, msa_mask=msa_mask,
                          templates=templates, templates_mask=tmask, device="cpu")
    assert tl.dtype == torch.bfloat16
    pair = mask[:, :, None] & mask[:, None, :]
    diff = np.abs(tl.float().numpy() - np.asarray(jl, np.float32))[pair]
    assert diff.max() < 0.1, diff.max()


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_gradients_through_the_tower_match_jax(flash):
    """d/dparams of sum(w * logits) over valid pairs, through the tower
    and the trunk, against jax.grad leaf by leaf (the tower's, the template
    embeddings' and every other leaf's)."""
    jparams, jcfg, tparams, tcfg = make_params(depth=1, attn_flash=flash)
    seq, mask, msa, msa_mask, templates, tmask = make_inputs()
    pair = mask[:, :, None] & mask[:, None, :]
    w = np.random.default_rng(5).normal(size=(1, 12, 12, jcfg.num_buckets)).astype(np.float32)
    w = w * pair[..., None]

    def jloss(p):
        out = jax_apply(p, jcfg, seq, msa, mask=mask, msa_mask=msa_mask, templates=templates,
                        templates_mask=tmask)
        return jnp.sum(out * w)

    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(jloss))(jparams)),
                           tcfg, device="cpu")
    leaves = list(tree_leaves(tparams))
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = alphafold2_apply(tparams, tcfg, seq, msa, mask=mask, msa_mask=msa_mask,
                           templates=templates, templates_mask=tmask, device="cpu")
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves, allow_unused=True)
    for got, ref in zip(grads, tree_leaves(want)):
        got = torch.zeros_like(ref) if got is None else got
        torch.testing.assert_close(got, ref, rtol=0, atol=2e-6 * max(1.0, ref.abs().max().item()))
    # the tower reaches the loss: its first layer's leaves and the template
    # embedding have gradients
    assert all(bool(g.abs().max() > 0) for g in tree_leaves(want["template_tower"][0]))
    assert bool(want["template_emb"]["table"].abs().max() > 0)


def test_tower_dropout_follows_the_forwards_generator():
    """With dropout rates and a CPU generator the tower's layers draw
    their seeds from it before the trunk's: the same seed gives the same
    logits, another seed others; no generator is eval mode (JAX's logits)."""
    jparams, jcfg, tparams, _ = make_params(depth=1)
    tcfg = Alphafold2Config(**{**SMALL, "depth": 1}, attn_dropout=0.2, ff_dropout=0.2)
    seq, mask, msa, msa_mask, templates, tmask = make_inputs()
    run = functools.partial(alphafold2_apply, tparams, tcfg, seq, msa, mask=mask,
                            msa_mask=msa_mask, templates=templates, templates_mask=tmask,
                            device="cpu")
    a = run(rng=torch.Generator().manual_seed(1))
    b = run(rng=torch.Generator().manual_seed(1))
    c = run(rng=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    jl = jax_logits(jparams, jcfg, seq, mask, msa, msa_mask, templates, tmask)
    assert_valid_close(jl, run().numpy(), mask)


def test_predict_structure_with_templates_matches_jax():
    """A padded batch of two requests with templates through both
    packages' `predict_structure`: logits and confidence 5e-6, stress 1e-4
    relative, pairwise distances 1e-3 A on valid residues."""
    from alphafold2_tpu.serving.pipeline import predict_structure as jax_predict

    jparams, jcfg, tparams, tcfg = make_params()
    rng = np.random.default_rng(3)
    b, L = 2, 16
    tokens = rng.integers(0, 20, (b, L)).astype(np.int32)
    mask = np.ones((b, L), bool)
    mask[1, 11:] = False
    tokens[~mask] = 20
    msa = rng.integers(0, 21, (b, 3, L)).astype(np.int32)
    msa_mask = np.broadcast_to(mask[:, None], msa.shape).copy()
    templates = rng.integers(0, 37, (b, 2, L, L)).astype(np.int32)
    tmask = rng.random((b, 2, L, L)) > 0.3
    j = jax.jit(lambda p: jax_predict(p, jcfg, tokens, mask=mask, msa=msa, msa_mask=msa_mask,
                                      templates=templates, templates_mask=tmask,
                                      mds_iters=50))(jparams)
    j = {k: np.asarray(v) for k, v in j.items()}
    t = {k: v.numpy() for k, v in predict_structure(
        tparams, tcfg, tokens, mask=mask, msa=msa, msa_mask=msa_mask, templates=templates,
        templates_mask=tmask, mds_iters=50, device="cpu").items()}
    pair = mask[:, :, None] & mask[:, None, :]
    np.testing.assert_allclose(t["distogram_logits"][pair], j["distogram_logits"][pair],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(t["confidence"], j["confidence"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(t["stress"], j["stress"], rtol=1e-4)
    d = lambda c: np.linalg.norm(c[:, :, None] - c[:, None], axis=-1)  # noqa: E731
    dt, dj = d(t["coords"].astype(np.float64)), d(j["coords"].astype(np.float64))
    np.testing.assert_allclose(dt[pair], dj[pair], rtol=0, atol=1e-3)


@pytest.mark.parametrize("schedule", ["sp_seq", "sp_msa"])
def test_sp_forward_with_templates_matches_dense(schedule):
    """`alphafold2_apply_sp` over 4 CPU shards with templates and tied rows
    (JAX `test_full_model_sp_with_templates_matches_replicated`): the tower
    runs on the first device ahead of the sharded trunk; against the
    port's dense forward and JAX's; and through `predict_structure`."""
    jparams, jcfg, tparams, tcfg = make_params(dim=16, depth=1, dim_head=8,
                                               msa_tie_row_attn=True, template_attn_depth=1)
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 21, (1, 16)).astype(np.int32)
    msa = rng.integers(0, 21, (1, 8, 16)).astype(np.int32)
    templates = rng.integers(0, 37, (1, 2, 16, 16)).astype(np.int32)
    tmask = np.ones((1, 2, 16, 16), bool)
    mesh = make_mesh({"seq": 4}, devices=["cpu"] * 4)
    dense = alphafold2_apply(tparams, tcfg, seq, msa, templates=templates,
                             templates_mask=tmask, device="cpu")
    sp = alphafold2_apply_sp(tparams, tcfg, seq, msa, mesh, templates=templates,
                             templates_mask=tmask, schedule=schedule)
    np.testing.assert_allclose(sp.numpy(), dense.numpy(), rtol=0, atol=1e-5)
    jl = np.asarray(jax_apply(jparams, jcfg, seq, msa, templates=templates,
                              templates_mask=tmask))
    np.testing.assert_allclose(sp.numpy(), jl, rtol=0, atol=1e-5)
    fn = functools.partial(alphafold2_apply_sp, mesh=mesh, schedule=schedule)
    out = predict_structure(tparams, tcfg, seq, msa=msa, templates=templates,
                            templates_mask=tmask, mds_iters=5, model_apply_fn=fn)
    np.testing.assert_allclose(out["distogram_logits"].numpy(), sp.numpy(), rtol=0, atol=1e-6)


def test_jax_checkpoint_with_template_weights_gives_jax_templated_logits(tmp_path):
    """JAX trains 2 steps and saves (its template leaves move by weight
    decay only); `restore_params_for_inference` loads them into the port,
    whose templated logits equal JAX's on the restored params."""
    from alphafold2_tpu.training import data as jdata
    from alphafold2_tpu.training import harness as jharness
    from alphafold2_tpu.training.checkpoint import VerifiedCheckpointManager as JaxManager
    from alphafold2_tpu_torch import alphafold2_init
    from alphafold2_tpu_torch.training.checkpoint import restore_params_for_inference

    kw = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=32)
    jcfg, tcfg = JaxConfig(**kw), Alphafold2Config(**kw)
    jt = jharness.TrainConfig(grad_accum=2, weight_decay=0.01)
    jstate = jharness.train_state_init(jax.random.PRNGKey(0), jcfg, jt)
    fetch = jdata.synthetic_microbatch_fn(jdata.DataConfig(max_len=12, seed=3), 2)
    jstep = jax.jit(jharness.make_train_step(jcfg, jt))
    for n in range(2):
        jstate, _ = jstep(jstate, fetch(n))
    ck = str(tmp_path / "ck")
    JaxManager(ck).save(jstate)
    params, step, resumed = restore_params_for_inference(
        ck, lambda: alphafold2_init(tcfg, torch.Generator().manual_seed(5), "cpu"))
    assert (step, resumed) == (2, True)
    seq, mask, msa, msa_mask, templates, tmask = make_inputs()
    jl = jax_logits(jstate["params"], jcfg, seq, mask, msa, msa_mask, templates, tmask)
    tl = alphafold2_apply(params, tcfg, seq, msa, mask=mask, msa_mask=msa_mask,
                          templates=templates, templates_mask=tmask, device="cpu")
    assert_valid_close(jl, tl.numpy(), mask)


# --- the predict CLI: --templates-file and --embedds-file -----------------------------

QUERY = "MKTAYIAKQRQISFVK"
CLI = ["--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8", "--mds-iters", "5",
       "--device", "cpu"]


def run_cli(tmp_path, *extra):
    from alphafold2_tpu_torch.geometry.pdb import parse_pdb
    from alphafold2_tpu_torch.predict import main

    out = tmp_path / "out.pdb"
    main(["--seq", QUERY, "--out", str(out), *CLI, *extra])
    return parse_pdb(str(out))


def assert_ca_trace(s):
    assert s.sequence() == QUERY
    assert [a.name for a in s.atoms] == ["CA"] * len(QUERY)
    assert np.isfinite(s.coords()).all()


@pytest.mark.parametrize("kind", ["int", "float", "int-masked"])
def test_predict_cli_templates_file(tmp_path, kind, monkeypatch, capsys):
    """A good --templates-file (int buckets, float distances, or int with a
    templates_mask) writes the CA trace; the forward gets the file's
    templates with their kind, and an all-true mask when the file has none
    (the JAX CLI's default)."""
    from alphafold2_tpu_torch import predict

    L = len(QUERY)
    rng = np.random.default_rng(0)
    arrays = {"templates": rng.integers(0, 37, (1, 2, L, L)).astype(np.int64)
              if kind != "float" else rng.uniform(0, 25, (2, L, L)).astype(np.float32)}
    if kind == "int-masked":
        arrays["templates_mask"] = rng.random((1, 2, L, L)) > 0.5
    path = tmp_path / "t.npz"
    np.savez(path, **arrays)
    seen = {}
    real = predict.predict_structure

    def record(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(predict, "predict_structure", record)
    assert_ca_trace(run_cli(tmp_path, "--templates-file", str(path)))
    assert f"templates: 2 x {L}^2 grids" in capsys.readouterr().out
    t, tm = seen["templates"], seen["templates_mask"]
    assert t.shape == tm.shape == (1, 2, L, L)
    assert (t.dtype == np.int32) if kind != "float" else (t.dtype == np.float32)
    want_mask = arrays.get("templates_mask", np.ones((1, 2, L, L), bool))
    np.testing.assert_array_equal(tm, want_mask)


def test_predict_cli_embedds_file(tmp_path, capsys):
    """A good --embedds-file ((L, n) here) writes the CA trace and sets
    num_embedds from the file."""
    path = tmp_path / "e.npz"
    np.savez(path, embedds=np.random.default_rng(0).normal(size=(len(QUERY), 24)))
    assert_ca_trace(run_cli(tmp_path, "--embedds-file", str(path)))
    assert f"embedds: {len(QUERY)} residues x 24 dims" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["bucket-range", "mask-shape", "grid", "msa-exclusive",
                                  "sp-shards", "residues"])
def test_predict_cli_rejects_bad_files(tmp_path, case, capsys):
    """Each of the JAX CLI's checks, with its message, as an argparse error."""
    L = len(QUERY)
    tpath, epath = tmp_path / "t.npz", tmp_path / "e.npz"
    extra, message = {
        "bucket-range": (["--templates-file", str(tpath)], "int buckets must be in [0, 37)"),
        "mask-shape": (["--templates-file", str(tpath)], "'templates_mask' shape"),
        "grid": (["--templates-file", str(tpath)], f"pair grid is {L + 1}x{L + 1}"),
        "msa-exclusive": (["--embedds-file", str(epath), "--msa-file", str(tmp_path / "a")],
                          "--embedds-file and --msa-file are exclusive"),
        "sp-shards": (["--embedds-file", str(epath), "--sp-shards", "2"],
                      "--embedds-file is unsupported with --sp-shards"),
        "residues": (["--embedds-file", str(epath)], f"has {L + 2} residues; --seq has {L}"),
    }[case]
    np.savez(tpath, **{
        "bucket-range": {"templates": np.full((1, 1, L, L), 37)},
        "mask-shape": {"templates": np.zeros((1, 1, L, L), np.int32),
                       "templates_mask": np.ones((1, 2, L, L), bool)},
        "grid": {"templates": np.zeros((1, 1, L + 1, L + 1), np.int32)},
    }.get(case, {"templates": np.zeros((1, 1, L, L), np.int32)}))
    np.savez(epath, embedds=np.zeros((1, L + 2 if case == "residues" else L, 8)))
    (tmp_path / "a").write_text(f">q\n{QUERY}\n")
    with pytest.raises(SystemExit) as e:
        run_cli(tmp_path, *extra)
    assert e.value.code == 2
    assert message in capsys.readouterr().err
