"""The sequence-parallel training step, port vs JAX package (CPU, float32).

The port's `parallel/train.py` (`make_sp_train_step` over
`sp_distogram_loss_fn` / `sp_e2e_loss_fn`) on a 4-shard CPU mesh
(`make_mesh({"seq": 4}, devices=["cpu"] * 4)`) against JAX's
`make_sp_train_step` on 4 devices of tests/conftest.py's virtual CPU mesh,
on the same weights (`params_from_jax`) and batches; the port's SP step
against its dense step; the refusals with JAX's wording; `--sp-shards` in
both CLIs; the mesh's replica cache after an in-place update.

Tolerances, chip_smoke.py phase 6a's (the same f32 function summed in
another order: the JAX CPU ring's `stream_block` arm against the port's
per-hop merges, XLA against ATen matmuls): loss 1e-5 absolute, grad_norm
1e-5 relative, each first-step gradient leaf 1e-4 of its largest entry
(exactly 0 on both where the loss does not read the leaf), params after 3
steps 1e-5, except entries whose first-step gradient is at most 1e-3 of
their leaf's largest: 2 lr 3 (Adam turns a rounding-noise gradient's sign
into +-lr). The e2e step: JAX's own SP test's bounds (tests/test_sp_trunk.py
`test_sp_e2e_train_step_matches_replicated`: loss 2e-5 relative, params
3e-5), at its config with the classical MDS init (the packages' random
draws differ) and JAX's kabsch in its eager form (tests/test_torch_e2e_train.py).
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.parallel import make_mesh as jax_make_mesh
from alphafold2_tpu.parallel import train as jsp
from alphafold2_tpu.training import data as jdata
from alphafold2_tpu.training import e2e as je2e
from alphafold2_tpu.training import harness as jharness
from alphafold2_tpu_torch import Alphafold2Config, params_from_jax
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.models.convert import e2e_params_from_jax
from alphafold2_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    make_sp_train_step,
    sp_e2e_loss_fn,
    sp_model_apply,
)
from alphafold2_tpu_torch.training import harness
from test_torch_e2e_train import configs, eager_form_kabsch, params_pair

NS = 4
SMALL = dict(dim=16, depth=2, heads=2, dim_head=8, max_seq_len=32)


def jmesh():
    if len(jax.devices()) < NS:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    return jax_make_mesh({"seq": NS}, jax.devices()[:NS])


def tmesh(n=NS):
    return make_mesh({"seq": n}, devices=["cpu"] * n)


def jax_state(jparams, jt):
    return {"params": jparams, "opt_state": jharness.make_optimizer(jt).init(jparams),
            "step": jnp.zeros((), jnp.int32)}


def held_params(want, got, noisy, lr, tol):
    """Phase 6a's params rule: `tol`, or 2 lr 3 on rounding-level entries."""
    for w, leaf, small in zip(want, got, noisy):
        d = (leaf.detach() - w).abs()
        if (~small).any():
            assert d[~small].max().item() <= tol
        assert d.max().item() <= 2 * lr * 3


# --- the distogram step -------------------------------------------------------


CASES = {
    "no_msa": (dict(), 0),
    "tied_rows": (dict(msa_tie_row_attn=True), 8),
    "aligned_kv4": (dict(msa_tie_row_attn=True, cross_attn_mode="aligned",
                         cross_attn_compress_ratio=4), 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sp_distogram_step_matches_jax(case):
    """3 steps of 2 microbatches at L = 16 (4 pair rows a shard), depth 2
    (the first layer's MSA<-pair ring reaches the loss through the second
    layer's pair<-MSA cross): loss, grad_norm, the first step's mean
    gradient and the params after 3 steps against JAX's SP step."""
    kw, rows = CASES[case]
    jcfg, tcfg = JaxConfig(**SMALL, **kw), Alphafold2Config(**SMALL, **kw)
    jm, tm = jmesh(), tmesh()
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    jt, tt = jharness.TrainConfig(grad_accum=2), harness.TrainConfig(grad_accum=2)
    fetch = jdata.synthetic_microbatch_fn(jdata.DataConfig(max_len=16, msa_rows=rows, seed=3), 2)
    jstep = jsp.make_sp_train_step(jcfg, jt, jm, donate_state=False)
    tstep = make_sp_train_step(tcfg, tt, tm)
    jstate, tstate = jax_state(jparams, jt), harness.train_state(tparams, tt)

    b0 = fetch(0)
    jloss = jsp.sp_distogram_loss_fn(jm)

    def mean_loss(p):
        return sum(jloss(p, jcfg, {k: v[n] for k, v in b0.items()}, None) for n in range(2)) / 2

    jgrads = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(mean_loss))(jparams)), tcfg, device="cpu")
    noisy = []
    for n in range(3):
        batch = fetch(n)
        jstate, jmet = jstep(jstate, batch)
        tstate, tmet = tstep(tstate, batch)
        assert abs(float(jmet["loss"]) - float(tmet["loss"])) <= 1e-5
        assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-5)
        if n == 0:  # no clipping: the leaves hold the mean gradient
            for want, leaf in zip(tree_leaves(jgrads), tstate["optimizer"].leaves):
                scale = want.abs().max().item()
                if scale == 0.0:
                    assert leaf.grad.abs().max().item() == 0.0
                else:
                    assert (leaf.grad - want).abs().max().item() <= 1e-4 * scale
                noisy.append(leaf.grad.abs() <= 1e-3 * leaf.grad.abs().max())
    assert tstate["step"] == 3
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]), tcfg,
                           device="cpu")
    held_params(tree_leaves(want), tstate["optimizer"].leaves, noisy, tt.learning_rate, 1e-5)


def test_sp_step_matches_the_dense_step():
    """The port's SP step (4 CPU shards, aligned crosses, KV compression 4,
    tied rows, 8 rows, a padded crop) against the port's dense step from
    the same params over 3 steps, at the tolerances of the module
    docstring."""
    kw = dict(msa_tie_row_attn=True, cross_attn_mode="aligned", cross_attn_compress_ratio=4)
    cfg = Alphafold2Config(**SMALL, **kw)
    tt = harness.TrainConfig(grad_accum=2)
    fetch = jdata.synthetic_microbatch_fn(jdata.DataConfig(max_len=16, msa_rows=8, seed=11), 2)
    states = [harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cpu")
              for _ in range(2)]
    steps = [make_sp_train_step(cfg, tt, tmesh()), harness.make_train_step(cfg, tt, device="cpu")]
    noisy = []
    for n in range(3):
        batch = fetch(n)
        (_, sp), (_, dense) = (step(st, batch) for step, st in zip(steps, states))
        assert abs(float(sp["loss"]) - float(dense["loss"])) <= 1e-5
        assert float(sp["grad_norm"]) == pytest.approx(float(dense["grad_norm"]), rel=1e-5)
        if n == 0:
            for a, b in zip(*(st["optimizer"].leaves for st in states)):
                scale = b.grad.abs().max().item()
                assert (a.grad - b.grad).abs().max().item() <= 1e-4 * scale
                noisy.append(b.grad.abs() <= 1e-3 * b.grad.abs().max())
    held_params([p.detach() for p in states[1]["optimizer"].leaves],
                states[0]["optimizer"].leaves, noisy, tt.learning_rate, 1e-5)


# --- the e2e step ---------------------------------------------------------------


def test_sp_e2e_step_matches_jax(monkeypatch):
    """One step of make_sp_train_step(loss_fn=sp_e2e_loss_fn(mesh)) at JAX's
    own SP e2e test's config (dim 16, depth 1, tied rows, aligned crosses,
    refiner dim 16 depth 1, 3 MDS iterations, L = 8: a 3L = 24 pair side,
    8 MSA rows; rng PRNGKey(3) on JAX's side, unread by the classical init
    and the deterministic trunk) against JAX's: loss 2e-5 relative, params
    3e-5."""
    monkeypatch.setattr(je2e, "kabsch", eager_form_kabsch)
    model = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=64, msa_tie_row_attn=True,
                 cross_attn_mode="aligned")
    jc, tc = configs(model, refiner=dict(num_tokens=14, dim=16, depth=1, msg_dim=16),
                     mds_iters=3)
    jp, tp = params_pair(jc, tc)
    jt = jharness.TrainConfig(learning_rate=1e-3, grad_accum=1)
    tt = harness.TrainConfig(learning_rate=1e-3, grad_accum=1)
    batch = next(jdata.stack_microbatches(jdata.synthetic_structure_batches(
        jdata.DataConfig(batch_size=1, max_len=8, msa_rows=8, seed=0)), 1))
    jm, tm = jmesh(), tmesh()
    jstep = jsp.make_sp_train_step(jc, jt, jm, donate_state=False,
                                   loss_fn=jsp.sp_e2e_loss_fn(jm))
    tstep = make_sp_train_step(tc, tt, tm, loss_fn=sp_e2e_loss_fn(tm))
    jstate, jmet = jstep(jax_state(jp, jt), batch, jax.random.PRNGKey(3))
    tstate, tmet = tstep(harness.train_state(tp, tt), batch, torch.Generator().manual_seed(3))
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=2e-5)
    want = e2e_params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]), tc, "cpu")
    for w, leaf in zip(tree_leaves(want), tstate["optimizer"].leaves):
        torch.testing.assert_close(leaf.detach(), w, rtol=0, atol=3e-5)


# --- refusals ----------------------------------------------------------------------


REFUSALS = {
    "dropout": (dict(ff_dropout=0.1), 16, 8, False),
    "embedds": (dict(), 16, 0, True),
    "reversible": (dict(reversible=True), 16, 8, False),
    "sparse": (dict(sparse_self_attn=True, sparse_block_size=4, sparse_num_local_blocks=2),
               16, 0, False),
    "pair_rows": (dict(), 18, 0, False),
    "msa_rows": (dict(), 16, 6, False),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_sp_loss_refuses_what_jax_refuses(case):
    """Each refusal of the SP loss raises ValueError with JAX's message."""
    kw, L, rows, embedds = REFUSALS[case]
    cfg_kw = dict(SMALL, depth=1, max_seq_len=32, **kw)
    jcfg, tcfg = JaxConfig(**cfg_kw), Alphafold2Config(**cfg_kw)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    batch = next(jdata.synthetic_batches(jdata.DataConfig(max_len=L, msa_rows=rows, seed=1)))
    if embedds:
        batch["embedds"] = np.zeros((1, L, jcfg.num_embedds), np.float32)

    def call(apply_fn, params, cfg, **kw):
        return apply_fn(params, cfg, batch["seq"], batch.get("msa"), mask=batch["mask"],
                        msa_mask=batch.get("msa_mask"), embedds=batch.get("embedds"), **kw)

    with pytest.raises(ValueError) as jerr:
        call(jsp.sp_model_apply(jmesh()), jparams, jcfg)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        call(sp_model_apply(tmesh()), tparams, tcfg, device="cpu")


def test_sp_step_refuses_another_device_and_axis():
    """The SP step and its forward run on the mesh's first device: another
    device, or an axis name the mesh does not have, raises."""
    cfg = Alphafold2Config(**SMALL)
    tt = harness.TrainConfig(grad_accum=1)
    with pytest.raises(ValueError, match="first device"):
        make_sp_train_step(cfg, tt, tmesh(), device="meta")
    with pytest.raises(ValueError, match="axis"):
        make_sp_train_step(cfg, tt, tmesh(), axis_name="sp")
    with pytest.raises(ValueError, match="first device"):
        sp_model_apply(tmesh())(None, cfg, None, None, device="meta")


# --- the mesh's replica cache ------------------------------------------------------------


def test_replicate_recopies_a_leaf_updated_in_place():
    """Under no_grad a replicated leaf is cached per device; an in-place
    update (an optimizer step) moves its version, and the next replicate
    copies it anew. Without an update the cached copy is returned."""
    mesh = Mesh("seq", ["cpu", "meta"])
    leaf = torch.randn(4, 3, requires_grad=True)
    with torch.no_grad():
        first = mesh.replicate({"w": leaf})[1]["w"]
        assert mesh.replicate({"w": leaf})[1]["w"] is first
        leaf.mul_(2.0)
        fresh = mesh.replicate({"w": leaf})[1]["w"]
        assert fresh is not first and fresh.device.type == "meta"
        assert mesh.replicate({"w": leaf})[1]["w"] is fresh
        assert mesh.replicate({"w": leaf})[0]["w"] is leaf  # the leaf's own device


# --- the CLIs ------------------------------------------------------------------------


TINY = ["--dim", "16", "--depth", "2", "--heads", "2", "--dim-head", "8", "--len", "16",
        "--accum", "2", "--device", "cpu"]


def read_jsonl(path):
    return [json.loads(line) for line in open(path)]


def test_train_pre_sp_shards_matches_the_dense_run(tmp_path, capsys):
    """`train_pre --sp-shards 2 --device cpu` with `--eval-every 2`: every
    step's loss and grad_norm and both evals equal the dense run's to the
    module's tolerances, and the startup line names the eager step."""
    from alphafold2_tpu_torch import train_pre

    logs = {}
    for name, extra in (("dense", []), ("sp", ["--sp-shards", "2"])):
        logs[name] = tmp_path / f"{name}.jsonl"
        train_pre.main(["--steps", "4", *TINY, "--eval-every", "2",
                        "--metrics-log", str(logs[name]), *extra])
    out = capsys.readouterr().out
    assert "sequence-parallel trunk over 2 shards on ['cpu', 'cpu']: the step runs eager" in out
    dense, sp = read_jsonl(logs["dense"]), read_jsonl(logs["sp"])
    assert len(dense) == len(sp) == 4
    assert sum("eval_loss" in r for r in sp) == 2
    for d, s in zip(dense, sp):
        assert abs(d["loss"] - s["loss"]) <= 1e-5
        assert s["grad_norm"] == pytest.approx(d["grad_norm"], rel=1e-5)
        if "eval_loss" in d:
            assert abs(d["eval_loss"] - s["eval_loss"]) <= 1e-5


def test_an_sp_checkpoint_resumes_in_a_dense_run(tmp_path, capsys):
    """2 SP steps saved, then 2 dense steps resumed from them, equal 4
    dense steps (params 1e-5)."""
    from alphafold2_tpu_torch import train_pre

    ck = tmp_path / "ck"
    train_pre.main(["--steps", "2", *TINY, "--sp-shards", "4", "--ckpt-dir", str(ck),
                    "--ckpt-every", "2"])
    resumed, _ = train_pre.main(["--steps", "2", *TINY, "--ckpt-dir", str(ck)])
    assert "resumed from step 2" in capsys.readouterr().out
    straight, _ = train_pre.main(["--steps", "4", *TINY])
    assert resumed["step"] == straight["step"] == 4
    for a, b in zip(resumed["optimizer"].leaves, straight["optimizer"].leaves):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=1e-5)


def test_train_pre_refuses_buckets_the_shards_do_not_divide():
    from alphafold2_tpu_torch import train_pre

    with pytest.raises(SystemExit, match=re.escape(
            "--len-buckets [50] not divisible by --sp-shards 4 (sp_trunk needs the pair side "
            "to divide the mesh axis)")):
        train_pre.main(["--steps", "1", "--dim", "16", "--depth", "1", "--heads", "2",
                        "--dim-head", "8", "--data", "native", "--len-buckets", "48,50,64",
                        "--len", "64", "--accum", "2", "--device", "cpu", "--sp-shards", "4"])


def test_train_end2end_sp_shards_and_its_refusal(capsys):
    """`train_end2end --sp-shards 4 --device cpu` trains 2 finite steps;
    with --trunk-segments it exits with JAX's message."""
    from alphafold2_tpu_torch import train_end2end

    tiny = ["--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8", "--len", "8",
            "--msa-rows", "8", "--mds-iters", "5", "--device", "cpu", "--sp-shards", "4"]
    state, metrics = train_end2end.main(["--steps", "2", *tiny])
    assert state["step"] == 2 and np.isfinite(float(metrics["loss"]))
    assert "sequence-parallel trunk over 4 shards" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--sp-shards and --trunk-segments are exclusive"):
        train_end2end.main(["--steps", "1", *tiny, "--reversible", "--trunk-segments", "2"])
