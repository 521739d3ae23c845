"""The segmented end-to-end train step (alphafold2_tpu_torch/training/
segmented.py: on CUDA the segments are the monolithic reversible step)
against the JAX package's `make_segmented_train_step`, on the CPU,
float32; `plan_segments` against JAX's.

Against JAX's segmented step: the e2e tolerances of
tests/test_torch_e2e_train.py: loss and grad_norm 1e-5 relative, 3
steps' params 1e-5 absolute (2 lr 3 for entries whose first-step gradient
is rounding-level), with JAX's jitted `kabsch` in its eager form (ROADMAP
C). Checkpoints cross between the two steps and the two packages bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.training import harness as jharness
from alphafold2_tpu.training import e2e as je2e
from alphafold2_tpu.training import segmented as jseg
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.models.convert import e2e_params_from_jax, train_state_to_jax
from alphafold2_tpu_torch.training import data as tdata
from alphafold2_tpu_torch.training import e2e as te2e
from alphafold2_tpu_torch.training import harness
from alphafold2_tpu_torch.training.segmented import make_segmented_train_step, plan_segments
from test_torch_e2e_train import configs, eager_form_kabsch, params_pair

L = 8


@pytest.fixture(scope="module", autouse=True)
def jax_kabsch_in_eager_form():
    mp = pytest.MonkeyPatch()
    mp.setattr(je2e, "kabsch", eager_form_kabsch)
    yield
    mp.undo()


FLAGS = [
    (False,) * 6, (False,) * 5, (True, True, False, False, False, False),
    (False, True, True, False, True), (True,) * 3, (False,) * 2,
]


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_plan_segments_matches_jax(flags, k):
    assert plan_segments(flags, k) == jseg.plan_segments(flags, k)


def fetch(accum, rows=3, seed=4):
    return tdata.synthetic_microbatch_fn(
        tdata.DataConfig(batch_size=1, max_len=L, msa_rows=rows, seed=seed), accum,
        source=tdata.synthetic_structure_batches)


def port_config(**model_kw):
    _, tc = configs(dict(dict(reversible=True, depth=3), **model_kw))
    return tc


def jax_state(jp, jt):
    return {"params": jp, "opt_state": jharness.make_optimizer(jt).init(jp),
            "step": jnp.zeros((), jnp.int32)}


@pytest.fixture(scope="module")
def jax_segmented():
    """JAX's segmented step (depth 2, 2 segments, 2 microbatches), its jitted
    pieces compiled once for the module."""
    jc, tc = configs(dict(reversible=True, depth=2))
    jt, tt = jharness.TrainConfig(grad_accum=2), harness.TrainConfig(grad_accum=2)
    return jc, tc, jt, tt, jseg.make_segmented_train_step(jc, jt, 2)


def test_segmented_step_matches_jax(jax_segmented):
    """3 segmented steps of 2 microbatches, the port's against JAX's
    `make_segmented_train_step` from the same params and batches (no rng:
    the classical init, no dropout)."""
    jc, tc, jt, tt, jstep = jax_segmented
    jp, tp = params_pair(jc, tc, seed=1)
    tstep = make_segmented_train_step(tc, tt, 2, device="cpu")
    jst, tst = jax_state(jp, jt), harness.train_state(tp, tt)
    batches = fetch(2)
    noisy = []
    for n in range(3):
        batch = batches(n)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tm = tstep(tst, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        if n == 0:
            noisy = [leaf.grad.abs() <= 1e-3 * leaf.grad.abs().max()
                     for leaf in tree_leaves(tst["params"])]
    want = e2e_params_from_jax(jax.tree_util.tree_map(np.asarray, jst["params"]), tc, "cpu")
    for w, leaf, small in zip(tree_leaves(want), tree_leaves(tst["params"]), noisy):
        d = (leaf.detach() - w).abs()
        if (~small).any():
            assert d[~small].max().item() <= 1e-5
        assert d.max().item() <= 2 * tt.learning_rate * 3


def test_checkpoints_cross_steps_and_packages(tmp_path, jax_segmented):
    """JAX's segmented state after a step, saved by its verified manager,
    restores into the port bit for bit; the port's segmented step from it
    saves a checkpoint that JAX's open_or_init restores bit for bit and
    that the port's monolithic step resumes exactly as from the state in
    memory."""
    from alphafold2_tpu.training.checkpoint import VerifiedCheckpointManager as JaxManager
    from alphafold2_tpu.training.checkpoint import open_or_init as jax_open_or_init
    from alphafold2_tpu_torch.training.checkpoint import VerifiedCheckpointManager, open_or_init

    jc, tc, jt, tt, jstep = jax_segmented
    batches = fetch(2)
    jst = je2e.e2e_train_state_init(jax.random.PRNGKey(3), jc, jt)
    jst, _ = jstep(jst, {k: jnp.asarray(v) for k, v in batches(0).items()})
    JaxManager(str(tmp_path / "jax")).save(jst, force=True)

    init = (te2e.e2e_train_state_init, tc, tt, torch.Generator().manual_seed(0), "cpu")
    _, state, resumed = open_or_init(str(tmp_path / "jax"), *init)
    assert resumed and state["step"] == 1
    for (path, a), b in zip(train_state_to_jax(state), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jst))):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))

    state, _ = make_segmented_train_step(tc, tt, 2, device="cpu")(state, batches(1))
    VerifiedCheckpointManager(str(tmp_path / "port")).save(state, force=True)
    _, jback, jresumed = jax_open_or_init(str(tmp_path / "port"), je2e.e2e_train_state_init,
                                          jax.random.PRNGKey(9), jc, jt, verify=True)
    assert jresumed and int(jback["step"]) == 2
    for (path, a), b in zip(train_state_to_jax(state), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jback))):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))

    _, restored, _ = open_or_init(str(tmp_path / "port"), *init)
    mono = harness.make_train_step(tc, tt, loss_fn=te2e.e2e_loss_fn, device="cpu")
    (_, m1), (_, m2) = mono(state, batches(2)), mono(restored, batches(2))
    assert torch.equal(m1["loss"], m2["loss"]) and restored["step"] == 3
    assert all(torch.equal(a, b) for a, b in zip(state["optimizer"].state_tensors(),
                                                 restored["optimizer"].state_tensors()))


def test_refusals():
    _, tc = configs(dict(depth=2))
    tt = harness.TrainConfig(grad_accum=1)
    with pytest.raises(ValueError, match="reversible"):
        make_segmented_train_step(tc, tt, 2, device="cpu")
    rev = port_config()
    state = te2e.e2e_train_state_init(rev, tt, torch.Generator().manual_seed(0), "cpu")
    step = make_segmented_train_step(rev, tt, 2, device="cpu")
    with pytest.raises(ValueError, match="requires an MSA stream"):
        step(state, fetch(1, rows=0)(0))
    with pytest.raises(ValueError, match="inference-only"):
        make_segmented_train_step(port_config(weight_dtype="int8"), tt, 2, device="cpu")


CLI = ["--dim", "16", "--heads", "2", "--dim-head", "8", "--len", "8", "--mds-iters", "5",
       "--refiner-depth", "1", "--device", "cpu"]


def test_cli_trunk_segments(capsys):
    """`train_end2end --reversible --trunk-segments 2` gives the monolithic
    CLI's state bit for bit; without --reversible, or with --max-restarts
    or --fault-plan, it refuses with the JAX CLI's messages."""
    from alphafold2_tpu_torch.train_end2end import main

    seg, m = main([*CLI, "--steps", "2", "--depth", "3", "--reversible", "--trunk-segments", "2"])
    mono, _ = main([*CLI, "--steps", "2", "--depth", "3", "--reversible"])
    assert "done" in capsys.readouterr().out and np.isfinite(float(m["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(seg["optimizer"].state_tensors(),
                                                 mono["optimizer"].state_tensors()))
    with pytest.raises(SystemExit, match="--trunk-segments requires --reversible"):
        main([*CLI, "--steps", "1", "--trunk-segments", "2"])
    for flag in (["--max-restarts", "1"], ["--fault-plan", "plan.json"]):
        with pytest.raises(SystemExit, match="are exclusive"):
            main([*CLI, "--steps", "1", "--reversible", "--trunk-segments", "2", *flag])
    with pytest.raises(ValueError, match="requires an MSA stream"):
        main([*CLI, "--steps", "1", "--reversible", "--trunk-segments", "2",
              "--features", "none"])
