"""The sequence-parallel trunk, port vs JAX package (CPU, float32).

The port's `sp_trunk_apply`, `msa_sharded_trunk_apply` and
`alphafold2_apply_sp` over a 4-shard CPU mesh
(`make_mesh({"seq": 4}, devices=["cpu"] * 4)`) against the JAX package's
under `shard_map` on 4 devices of tests/conftest.py's virtual CPU mesh, on
the same weights (`params_from_jax`); `predict_structure` with the SP
forward as its `model_apply_fn` against the port's dense request; and the
refusals.

Tolerance: the JAX CPU ring takes its `stream_block` arm, the port's its
per-hop (out, lse) merges, another summation order; with the projections
(XLA vs ATen matmuls) the trunk outputs and logits agree to ~1e-6. Bound:
1e-5 absolute on values of magnitude ~1-4. The request comparison (port SP
vs port dense) is held as tests/test_torch_pipeline.py holds a request:
distances 1e-4 A, confidence 1e-6, stress 1e-5 relative.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.models.trunk import trunk_layer_init as jax_layer_init
from alphafold2_tpu.parallel import alphafold2_apply_sp as jax_apply_sp
from alphafold2_tpu.parallel import make_mesh as jax_make_mesh
from alphafold2_tpu.parallel import msa_sharded_trunk_apply as jax_msa_sharded
from alphafold2_tpu.parallel import sp_trunk_apply as jax_sp_trunk
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_apply, params_from_jax, \
    predict_structure
from alphafold2_tpu_torch.models.convert import convert_tree
from alphafold2_tpu_torch.parallel import (
    alphafold2_apply_sp,
    make_mesh,
    msa_sharded_trunk_apply,
    sp_trunk_apply,
)

NS = 4
ATOL = 1e-5
BASE = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=32)


def jmesh():
    if len(jax.devices()) < NS:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    return jax_make_mesh({"seq": NS}, jax.devices()[:NS])


def tmesh():
    return make_mesh({"seq": NS}, devices=["cpu"] * NS)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def trunk_setup(kw, masked, n=16, rows=8, cols=16, seed=0):
    cfg_kw = {**BASE, **kw}
    jcfg, tcfg = JaxConfig(**cfg_kw), Alphafold2Config(**cfg_kw)
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 + jcfg.depth)
    jlayers = [jax_layer_init(k, jcfg) for k in keys[2:]]
    tlayers = convert_tree(jax.tree_util.tree_map(np.asarray, jlayers), "cpu")
    x = np.asarray(jax.random.normal(keys[0], (1, n, n, jcfg.dim)))
    m = np.asarray(jax.random.normal(keys[1], (1, rows, cols, jcfg.dim)))
    x_mask = msa_mask = None
    if masked:
        x_mask = np.ones((1, n, n), bool)
        x_mask[:, :, -3:] = False
        msa_mask = np.ones((1, rows, cols), bool)
        msa_mask[:, :, -2:] = False
    return jcfg, tcfg, jlayers, tlayers, x, m, x_mask, msa_mask


def assert_close(got, want, atol=ATOL):
    got = got.detach().numpy()
    assert got.shape == np.asarray(want).shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


TRUNK_CASES = [
    ("flat", False, 1, False),
    ("flat", True, 2, True),
    ("flat", False, 3, True),    # ratio 3 does not divide the local keys: halo windows
    ("aligned", False, 1, True),
    ("aligned", True, 2, False),
    ("aligned", False, 3, True),
]


@pytest.mark.parametrize("mode,tie,compress,masked", TRUNK_CASES,
                         ids=[f"{c[0]}-tie{int(c[1])}-r{c[2]}-m{int(c[3])}" for c in TRUNK_CASES])
def test_sp_trunk_matches_jax(mode, tie, compress, masked):
    """sp_trunk_apply, both streams' outputs, against JAX's on the same
    layers and inputs."""
    jm, tm = jmesh(), tmesh()
    jcfg, tcfg, jl, tl, x, m, xm, mm = trunk_setup(
        dict(cross_attn_mode=mode, msa_tie_row_attn=tie, cross_attn_compress_ratio=compress),
        masked)
    want_x, want_m = jax.jit(lambda ls, a, b: jax_sp_trunk(
        ls, jcfg, a, b, jm, x_mask=xm, msa_mask=mm))(jl, x, m)
    got_x, got_m = sp_trunk_apply(tl, tcfg, t(x), t(m), tm, x_mask=t(xm), msa_mask=t(mm))
    assert got_x.device.type == "cpu"
    assert_close(got_x, want_x)
    assert_close(got_m, want_m)


@pytest.mark.parametrize("tie", [False, True])
def test_msa_sharded_trunk_matches_jax(tie):
    """The "sp_msa" cut: MSA rows sharded, the pair grid whole on every
    shard."""
    jm, tm = jmesh(), tmesh()
    jcfg, tcfg, jl, tl, x, m, xm, mm = trunk_setup(dict(msa_tie_row_attn=tie), True)
    want_x, want_m = jax.jit(lambda ls, a, b: jax_msa_sharded(
        ls, jcfg, a, b, jm, x_mask=xm, msa_mask=mm))(jl, x, m)
    got_x, got_m = msa_sharded_trunk_apply(tl, tcfg, t(x), t(m), tm, x_mask=t(xm),
                                           msa_mask=t(mm))
    assert_close(got_x, want_x)
    assert_close(got_m, want_m)


def model_setup(kw, L=16, rows=8, seed=0):
    cfg_kw = {**BASE, "depth": 2, **kw}
    jparams = jax_init(jax.random.PRNGKey(seed), JaxConfig(**cfg_kw))
    tcfg = Alphafold2Config(**cfg_kw)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(seed + 1)
    seq = rng.integers(0, 20, (1, L)).astype(np.int32)
    msa = rng.integers(0, 21, (1, rows, L)).astype(np.int32)
    mask = np.ones((1, L), bool)
    mask[:, -3:] = False
    msa_mask = rng.random((1, rows, L)) > 0.2
    msa_mask[:, 0] = mask
    return JaxConfig(**cfg_kw), jparams, tcfg, tparams, seq, msa, mask, msa_mask


@pytest.mark.parametrize("schedule", ["sp_seq", "sp_msa"])
@pytest.mark.parametrize("mode", ["flat", "aligned"])
def test_alphafold2_apply_sp_matches_jax(schedule, mode):
    """The whole model, depth 2 (the MSA<-pair ring of the last layer is
    read by nothing after the head, so depth 2 puts a ring on the logits'
    path), both schedules and cross modes, against JAX's
    alphafold2_apply_sp."""
    jm, tm = jmesh(), tmesh()
    jcfg, jp, tcfg, tp, seq, msa, mask, msa_mask = model_setup(
        dict(cross_attn_mode=mode, msa_tie_row_attn=mode == "aligned"))
    want = jax.jit(lambda p, s, a, mk, mm: jax_apply_sp(
        p, jcfg, s, a, jm, mask=mk, msa_mask=mm, schedule=schedule))(
        jp, seq, msa, mask, msa_mask)
    got = alphafold2_apply_sp(tp, tcfg, seq, msa, tm, mask=mask, msa_mask=msa_mask,
                              schedule=schedule)
    assert_close(got, want)


def test_alphafold2_apply_sp_without_msa_matches_jax():
    """Pair-grid-only forward (msa=None) under "sp_seq"."""
    jm, tm = jmesh(), tmesh()
    jcfg, jp, tcfg, tp, seq, _, mask, _ = model_setup({})
    want = jax.jit(lambda p, s, mk: jax_apply_sp(p, jcfg, s, None, jm, mask=mk))(jp, seq, mask)
    assert_close(alphafold2_apply_sp(tp, tcfg, seq, None, tm, mask=mask), want)


def test_predict_structure_with_the_sp_forward_matches_the_dense_request():
    """predict_structure(model_apply_fn=the SP forward) against the port's
    dense request on the same params: distances (rotation-invariant),
    confidence and stress."""
    _, _, tcfg, tp, seq, msa, mask, msa_mask = model_setup(dict(attn_flash=True))
    kw = dict(mask=mask, msa=msa, msa_mask=msa_mask, mds_iters=20)
    dense = predict_structure(tp, tcfg, seq, device="cpu", **kw)
    sp = predict_structure(tp, tcfg, seq, **kw,
                           model_apply_fn=functools.partial(alphafold2_apply_sp, mesh=tmesh()))
    assert sp["coords"].device.type == "cpu"
    pair = mask[:, :, None] & mask[:, None, :]
    np.testing.assert_allclose(sp["distogram_logits"].numpy()[pair],
                               dense["distogram_logits"].numpy()[pair], rtol=0, atol=ATOL)
    valid = torch.from_numpy(mask[0])
    dist = lambda c: torch.cdist(c[0, valid].double(), c[0, valid].double())  # noqa: E731
    assert (dist(sp["coords"]) - dist(dense["coords"])).abs().max().item() <= 1e-4
    np.testing.assert_allclose(sp["confidence"].numpy(), dense["confidence"].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(sp["stress"].numpy(), dense["stress"].numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="no device"):
        predict_structure(tp, tcfg, seq, device="cpu", mds_iters=2,
                          model_apply_fn=functools.partial(alphafold2_apply_sp, mesh=tmesh()))


def test_refusals():
    """Each refusal of the JAX package, and the port's own: sparse layers
    (both schedules), reversible through the trunk hook, rows or MSA rows
    or cols that do not divide, a non-square aligned grid, embedds, an
    unknown schedule, no MSA under "sp_msa". (The SP forward takes no rng;
    the primitives refuse one, and ring_attention the double-buffered
    schedule: tests/test_torch_sequence.py.)"""
    tm = tmesh()
    _, _, tcfg, tp, seq, msa, _, _ = model_setup({})
    _, scfg, _, tl, x, m, _, _ = trunk_setup(dict(sparse_self_attn=True), False)
    with pytest.raises(ValueError, match="sparse"):
        sp_trunk_apply(tl, scfg, t(x), t(m), tm)
    with pytest.raises(ValueError, match="sparse"):
        msa_sharded_trunk_apply(tl, scfg, t(x), t(m), tm)
    _, _, _, tl, x, m, _, _ = trunk_setup({}, False)
    x, m = t(x), t(m)
    with pytest.raises(ValueError, match="pair-grid rows"):
        sp_trunk_apply(tl, tcfg, x[:, :14], m, tm)
    with pytest.raises(ValueError, match="MSA rows"):
        sp_trunk_apply(tl, tcfg, x, m[:, :6], tm)
    with pytest.raises(ValueError, match="MSA rows"):
        msa_sharded_trunk_apply(tl, tcfg, x, m[:, :6], tm)
    with pytest.raises(ValueError, match="MSA cols"):
        msa_sharded_trunk_apply(tl, tcfg, x, m[:, :, :14], tm)
    with pytest.raises(ValueError, match="nothing to shard"):
        msa_sharded_trunk_apply(tl, tcfg, x, None, tm)
    aligned = Alphafold2Config(**{**BASE, "cross_attn_mode": "aligned"})
    with pytest.raises(ValueError, match="square"):
        sp_trunk_apply(tl, aligned, x[:, :, :8], m, tm)
    with pytest.raises(ValueError, match="embedds"):
        alphafold2_apply_sp(tp, tcfg, seq, None, tm, embedds=np.zeros((1, 16, 1280), np.float32))
    with pytest.raises(ValueError, match="schedule"):
        alphafold2_apply_sp(tp, tcfg, seq, msa, tm, schedule="dense")
    # the reversible trunk (models/reversible.py): the SP forward and the
    # trunk hook refuse it
    rev = Alphafold2Config(**{**BASE, "depth": 2, "reversible": True})
    with pytest.raises(ValueError, match="reversible"):
        alphafold2_apply_sp(tp, rev, seq, msa, tm)
    with pytest.raises(ValueError, match="reversible"):
        alphafold2_apply(tp, rev, seq, msa, device="cpu", trunk_fn=lambda *a: a[2:4])


def test_predict_cli_sp_shards(monkeypatch, tmp_path):
    """--sp-shards on the CPU (the shards on the CPU) writes a structure;
    without the cards it names it raises, as the JAX CLI does."""
    from alphafold2_tpu_torch import predict

    out = tmp_path / "s.pdb"
    args = ["--seq", "MKTAYIAKQRQISFVK", "--dim", "16", "--depth", "2", "--heads", "2",
            "--dim-head", "8", "--mds-iters", "3", "--out", str(out), "--sp-shards", "4"]
    predict.main(args + ["--device", "cpu"])
    assert out.stat().st_size > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "one card")
    with pytest.raises(ValueError, match="needs 4 CUDA devices, this host has 1"):
        predict.main(args)

