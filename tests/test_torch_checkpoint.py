"""Checkpoints of the port against the JAX package's (CPU): one file
format, read and written by both.

The same seeded weights (`params_from_jax`) and numpy batches. A state the
JAX `VerifiedCheckpointManager` wrote restores in the port bit for bit
(every param, moment and count), and the next step agrees with JAX's next
step as `test_torch_train.py` holds a step: loss 1e-5, params 1e-5. A
state the port wrote, a cold start included, passes JAX's `verify()` and
restores through JAX's template bit for bit. bf16 leaves round-trip both
ways, decoded without ml_dtypes on the port's side. A damaged newest step
falls back to the previous verified one; an orbax directory raises. And
`predict --ckpt-dir` matches JAX's `predict_structure` on the restored
params at `test_torch_pipeline.py`'s tolerances (logits and confidence
5e-6, stress 1e-4 relative, distances 1e-3 A).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.training import data as jdata
from alphafold2_tpu.training import harness as jharness
from alphafold2_tpu.training.checkpoint import VerifiedCheckpointManager as JaxManager
from alphafold2_tpu.training.checkpoint import _leaf_paths as jax_leaf_paths
from alphafold2_tpu.training.checkpoint import abstract_like
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_init, params_from_jax
from alphafold2_tpu_torch.models.convert import leaf_paths, params_to_jax, train_state_to_jax
from alphafold2_tpu_torch.reliability.faults import Fault, FaultPlan
from alphafold2_tpu_torch.training import checkpoint, data, harness

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=32)
SCHED = dict(grad_accum=2, warmup_steps=2, decay_steps=4, decay_floor=0.1)


def _jax_host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _as_np(leaf):
    return leaf.view(torch.int16).numpy() if isinstance(leaf, torch.Tensor) else leaf


def _assert_items_equal(got, want):
    """(path, leaf) lists: the same paths in the same order, every leaf
    bit-equal with its dtype."""
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8), w.reshape(-1).view(np.uint8),
                                      err_msg=str(path))


def _jax_setup(depth=1, seed=0):
    jcfg, tcfg = JaxConfig(**dict(SMALL, depth=depth)), Alphafold2Config(**dict(SMALL, depth=depth))
    jt, tt = jharness.TrainConfig(**SCHED), harness.TrainConfig(**SCHED)
    jstate = jharness.train_state_init(jax.random.PRNGKey(seed), jcfg, jt)
    fetch = jdata.synthetic_microbatch_fn(jdata.DataConfig(max_len=12, seed=3), 2)
    return jcfg, tcfg, jt, tt, jstate, fetch


def _port_state(tcfg, tt, jparams):
    return harness.train_state(params_from_jax(_jax_host(jparams), tcfg, device="cpu"), tt)


# --- the layout -----------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2])
def test_port_init_and_state_have_the_jax_layout(depth):
    """The port's own init holds every leaf of the JAX init, template tower
    included, at the same shapes; its train state maps onto JAX's
    `TrainState` with the same paths, in the same order, dtypes and shapes
    (381 leaves at depth 1)."""
    jcfg, tcfg = JaxConfig(**dict(SMALL, depth=depth)), Alphafold2Config(**dict(SMALL, depth=depth))
    jparams = _jax_host(jax_init(jax.random.PRNGKey(0), jcfg))
    tparams = alphafold2_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = [(p, a.shape) for p, a in jax_leaf_paths(jparams)]
    got = [(p, np.asarray(a).shape) for p, a in leaf_paths(params_to_jax(tparams))]
    assert got == want
    assert "template_tower" in tparams and len(tparams["template_tower"]) == 2
    jt = jharness.TrainConfig(grad_accum=1)
    jstate = _jax_host(jharness.train_state_init(jax.random.PRNGKey(0), jcfg, jt))
    items = train_state_to_jax(harness.train_state(tparams, harness.TrainConfig(grad_accum=1)))
    want = [(p, a.dtype, a.shape) for p, a in jax_leaf_paths(jstate)]
    assert [(p, a.dtype, a.shape) for p, a in items] == want
    assert depth != 1 or len(items) == 381


# --- JAX writes, the port reads ---------------------------------------------------


def test_jax_checkpoint_restores_bit_for_bit_and_the_next_step_matches(tmp_path):
    """JAX trains 2 steps (warmup, cosine decay) and saves; the port
    restores into a live state built from other params: every leaf equals
    JAX's bit for bit, AdamW's moments made where the optimizer had none,
    the same tensors kept. The third step on both sides agrees (loss 1e-5,
    params 1e-5), with the lr the schedule gives the restored count."""
    jcfg, tcfg, jt, tt, jstate, fetch = _jax_setup()
    jstep = jax.jit(jharness.make_train_step(jcfg, jt))
    for n in range(2):
        jstate, _ = jstep(jstate, fetch(n))
    JaxManager(str(tmp_path / "ck")).save(jstate)

    other = jharness.train_state_init(jax.random.PRNGKey(7), jcfg, jt)["params"]
    tstate = _port_state(tcfg, tt, other)
    ptrs = [p.data_ptr() for p in tstate["optimizer"].leaves]
    mgr = checkpoint.VerifiedCheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() == 2
    assert mgr.restore(into=tstate) is tstate
    assert [p.data_ptr() for p in tstate["optimizer"].leaves] == ptrs
    assert tstate["step"] == 2
    _assert_items_equal(train_state_to_jax(tstate), jax_leaf_paths(_jax_host(jstate)))

    jstate, jm = jstep(jstate, fetch(2))
    tstate, tm = harness.make_train_step(tcfg, tt, device="cpu")(tstate, fetch(2))
    assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-5
    want = params_from_jax(_jax_host(jstate["params"]), tcfg, device="cpu")
    for w, leaf in zip(jax.tree_util.tree_leaves(want), tstate["optimizer"].leaves):
        torch.testing.assert_close(leaf.detach(), w, rtol=0, atol=1e-5)


# --- the port writes, JAX reads ---------------------------------------------------


@pytest.mark.parametrize("steps", [0, 2], ids=["cold-start", "after-2-steps"])
def test_port_checkpoint_passes_jax_verify_and_template_restore(tmp_path, steps):
    """The port saves its own cold start (its own init, template leaves
    included) or a state after 2 steps; JAX's manager verifies the step and
    restores it through its `TrainState` template bit for bit."""
    jcfg, tcfg, jt, tt, _, fetch = _jax_setup()
    tstate = harness.train_state_init(tcfg, tt, torch.Generator().manual_seed(0), "cpu")
    step = harness.make_train_step(tcfg, tt, device="cpu")
    for n in range(steps):
        step(tstate, fetch(n))
    assert checkpoint.VerifiedCheckpointManager(str(tmp_path / "ck")).save(tstate, force=True)

    jmgr = JaxManager(str(tmp_path / "ck"))
    assert jmgr.verify(steps) and jmgr.latest_step() == steps
    template = jharness.train_state_init(jax.random.PRNGKey(0), jcfg, jt)
    restored = jmgr.restore(abstract_like(template))
    assert int(restored["step"]) == steps
    _assert_items_equal(jax_leaf_paths(_jax_host(restored)), train_state_to_jax(tstate))


# --- bf16 leaves -------------------------------------------------------------------


_READ_BF16 = """
import sys, torch
from alphafold2_tpu_torch.training.checkpoint import VerifiedCheckpointManager
tree = VerifiedCheckpointManager(sys.argv[1]).restore()
print(tree["params"]["w"].dtype, "ml_dtypes" in sys.modules, "jax" in sys.modules)
"""


def test_bf16_leaves_round_trip_both_ways_without_ml_dtypes(tmp_path):
    """A bf16 leaf JAX wrote comes back in the port as a `torch.bfloat16`
    tensor with the same bits (decoded through torch: a fresh process
    never imports ml_dtypes or jax); a bf16 tensor the port wrote comes
    back in JAX as an ml_dtypes bfloat16 array with the same bits."""
    w = jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3
    JaxManager(str(tmp_path / "j")).save(
        {"params": {"w": w}, "scalar": jnp.asarray(1.5, jnp.bfloat16),
         "step": jnp.asarray(1, jnp.int32)}, force=True)
    tree = checkpoint.VerifiedCheckpointManager(str(tmp_path / "j")).restore()
    assert tree["params"]["w"].dtype == torch.bfloat16 and tree["params"]["w"].shape == (2, 3)
    np.testing.assert_array_equal(_as_np(tree["params"]["w"]), np.asarray(w).view(np.int16))
    assert tree["scalar"].shape == () and float(tree["scalar"]) == 1.5
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _READ_BF16, str(tmp_path / "j")],
                         cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["torch.bfloat16", "False", "False"]

    tw = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    checkpoint.VerifiedCheckpointManager(str(tmp_path / "t")).save(
        {"params": {"w": tw}, "step": np.asarray(4, np.int32)}, force=True)
    jtree = JaxManager(str(tmp_path / "t")).restore()
    assert str(jtree["params"]["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jtree["params"]["w"]).view(np.int16),
                                  tw.view(torch.int16).numpy())
    assert int(jtree["step"]) == 4


# --- damaged steps and retention ----------------------------------------------------


def _state_at(tstate, step):
    tstate["step"] = step
    with torch.no_grad():
        tstate["params"]["head_out"]["b"].fill_(float(step))
    return tstate


@pytest.mark.parametrize("mode", ["truncate", "corrupt", "no_manifest"])
def test_damaged_newest_step_falls_back_and_pruning_keeps_the_newest_verified(
        tmp_path, capsys, mode):
    """Step 3's write is damaged (`ckpt_corrupt`, each mode) and every later
    one too: with max_to_keep=2 pruning never deletes step 2, the newest
    verified (it drops 1 and 3), the restore falls back past step 4 to step
    2 with a warning, and JAX's manager agrees on what verifies."""
    tcfg, tt = Alphafold2Config(**SMALL), harness.TrainConfig(grad_accum=1)
    tstate = harness.train_state_init(tcfg, tt, torch.Generator().manual_seed(0), "cpu")
    inj = FaultPlan(faults=(Fault("ckpt_corrupt", at=3, count=99, mode=mode),)).injector()
    path = str(tmp_path / "ck")
    mgr = checkpoint.VerifiedCheckpointManager(path, max_to_keep=2,
                                               fault_hook=inj.checkpoint_hook())
    for s in (1, 2, 3, 4):
        mgr.save(_state_at(tstate, s), force=True)
    assert mgr.all_steps() == [2, 4] and mgr.latest_step() == 2
    fresh = harness.train_state_init(tcfg, tt, torch.Generator().manual_seed(1), "cpu")
    checkpoint.VerifiedCheckpointManager(path).restore(into=fresh)
    assert fresh["step"] == 2
    assert torch.equal(fresh["params"]["head_out"]["b"],
                       torch.full_like(fresh["params"]["head_out"]["b"], 2.0))
    assert "failed verification" in capsys.readouterr().out
    jmgr = JaxManager(path)
    assert jmgr.latest_step() == 2 and not jmgr.verify(4)
    with pytest.raises(FileNotFoundError, match="verification"):
        checkpoint.VerifiedCheckpointManager(path).restore(into=fresh, step=4)


def test_healthy_rotation_prunes_to_max_to_keep(tmp_path):
    tcfg, tt = Alphafold2Config(**SMALL), harness.TrainConfig(grad_accum=1)
    tstate = harness.train_state_init(tcfg, tt, torch.Generator().manual_seed(0), "cpu")
    mgr = checkpoint.VerifiedCheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(_state_at(tstate, s), force=True)
    assert mgr.all_steps() == [2, 3]
    every2 = checkpoint.VerifiedCheckpointManager(str(tmp_path / "e2"), save_interval_steps=2)
    assert not every2.save(_state_at(tstate, 3)) and every2.save(_state_at(tstate, 4))
    assert every2.all_steps() == [4]


# --- what the port refuses -----------------------------------------------------------


def test_orbax_directory_raises_naming_a12_orbax(tmp_path):
    """A directory the JAX package's orbax manager wrote is refused by the
    manager, `open_or_init` and `restore_params_for_inference`: never a
    cold start from random weights."""
    from alphafold2_tpu.training.checkpoint import CheckpointManager

    path = str(tmp_path / "orbax")
    with CheckpointManager(path) as mgr:
        mgr.save({"step": jnp.asarray(1), "w": jnp.ones(3)}, step=1)
    tcfg, tt = Alphafold2Config(**SMALL), harness.TrainConfig(grad_accum=1)
    with pytest.raises(NotImplementedError, match="A12-orbax"):
        checkpoint.VerifiedCheckpointManager(path)
    with pytest.raises(NotImplementedError, match="A12-orbax"):
        checkpoint.open_or_init(path, harness.train_state_init, tcfg, tt,
                                torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="A12-orbax"):
        checkpoint.restore_params_for_inference(
            path, lambda: alphafold2_init(tcfg, torch.Generator().manual_seed(0), "cpu"))


def test_multi_process_checkpointing_raises_naming_a13(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    mgr = checkpoint.VerifiedCheckpointManager(str(tmp_path / "ck"))
    with pytest.raises(NotImplementedError, match="A13"):
        mgr.save({"step": 0, "w": np.zeros(2)}, force=True)
    with pytest.raises(NotImplementedError, match="A13"):
        mgr.restore()


def test_restore_refuses_another_layout(tmp_path):
    """A checkpoint of another depth or width raises naming the leaf,
    instead of restoring part of it."""
    tt = harness.TrainConfig(grad_accum=1)
    tstate = harness.train_state_init(Alphafold2Config(**SMALL), tt,
                                      torch.Generator().manual_seed(0), "cpu")
    checkpoint.VerifiedCheckpointManager(str(tmp_path / "ck")).save(tstate, force=True)
    for fields, err in ((dict(depth=2), KeyError), (dict(dim=32, dim_head=16), ValueError)):
        cfg = Alphafold2Config(**dict(SMALL, **fields))
        with pytest.raises(err, match="config|layouts"):
            checkpoint.restore_params_for_inference(
                str(tmp_path / "ck"),
                lambda cfg=cfg: alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu"))
    deeper = harness.train_state_init(Alphafold2Config(**dict(SMALL, depth=2)), tt,
                                      torch.Generator().manual_seed(0), "cpu")
    checkpoint.VerifiedCheckpointManager(str(tmp_path / "deep")).save(deeper, force=True)
    with pytest.raises(KeyError, match="lacks"):
        checkpoint.restore_params_for_inference(
            str(tmp_path / "deep"),
            lambda: alphafold2_init(Alphafold2Config(**SMALL), torch.Generator(), "cpu"))


# --- predict from a checkpoint --------------------------------------------------------


def test_predict_cli_from_a_checkpoint_matches_jax(tmp_path, monkeypatch, capsys):
    """The port's train_pre writes a checkpoint on the CPU; `predict
    --ckpt-dir` restores it and its `predict_structure` output matches
    JAX's `predict_structure` on the params JAX's manager restores from the
    same files (tolerances of the module docstring)."""
    from alphafold2_tpu.serving.pipeline import predict_structure as jax_predict
    from alphafold2_tpu_torch import predict, train_pre

    ck = str(tmp_path / "ck")
    train_pre.main(["--steps", "2", "--dim", "16", "--depth", "1", "--heads", "2",
                    "--dim-head", "8", "--len", "12", "--accum", "2", "--device", "cpu",
                    "--ckpt-dir", ck, "--ckpt-every", "2"])
    seen = {}

    def record(*args, **kwargs):
        seen.update(predict_structure(*args, **kwargs))
        return seen

    predict_structure = predict.predict_structure
    monkeypatch.setattr(predict, "predict_structure", record)
    query = "MKTAYIAKQRQISFVK"
    predict.main(["--seq", query, "--out", str(tmp_path / "p.pdb"), "--dim", "16",
                  "--depth", "1", "--heads", "2", "--dim-head", "8", "--mds-iters", "20",
                  "--max-seq-len", "2048", "--ckpt-dir", ck, "--device", "cpu"])
    assert "restored step-2 params" in capsys.readouterr().out

    jcfg = JaxConfig(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=2048)
    template = jharness.train_state_init(jax.random.PRNGKey(0), jcfg,
                                         jharness.TrainConfig(grad_accum=2))
    jparams = JaxManager(ck).restore(abstract_like(template))["params"]
    from alphafold2_tpu_torch.constants import aa_to_tokens

    tokens = np.asarray(aa_to_tokens(query))[None]
    j = {k: np.asarray(v) for k, v in jax_predict(jparams, jcfg, tokens, mds_iters=20).items()}
    t = {k: v.numpy() for k, v in seen.items()}
    np.testing.assert_allclose(t["distogram_logits"], j["distogram_logits"], rtol=0, atol=5e-6)
    np.testing.assert_allclose(t["confidence"], j["confidence"], rtol=0, atol=5e-6)
    np.testing.assert_allclose(t["stress"], j["stress"], rtol=1e-4)
    d = lambda c: np.linalg.norm(c[:, :, None] - c[:, None], axis=-1)  # noqa: E731
    np.testing.assert_allclose(d(t["coords"].astype(np.float64)),
                               d(j["coords"].astype(np.float64)), rtol=0, atol=1e-3)


def test_manifest_names_the_jax_paths(tmp_path):
    """The manifest the port writes lists the JAX paths and leaf_meta, leaf
    for leaf, as the JAX manager writes them."""
    tcfg, tt = Alphafold2Config(**SMALL), harness.TrainConfig(grad_accum=1)
    tstate = harness.train_state_init(tcfg, tt, torch.Generator().manual_seed(0), "cpu")
    checkpoint.VerifiedCheckpointManager(str(tmp_path / "ck")).save(tstate, force=True)
    manifest = json.load(open(tmp_path / "ck" / "step_00000000.npz.manifest.json"))
    assert manifest["step"] == 0 and manifest["leaves"] == len(manifest["paths"]) == 381
    assert manifest["paths"][0] == [["k", "opt_state"], ["i", 1], ["i", 0], ["a", "count"]]
    assert manifest["paths"][-1] == [["k", "step"]]
    assert manifest["leaf_meta"][0] == {"dtype": "int32", "shape": [], "packed": False}


def test_serve_cli_tags_the_cache_with_the_checkpoint(tmp_path, monkeypatch, capsys):
    """`serve --ckpt-dir` restores the checkpoint's params and sets the
    engine's params_tag to `<dir>@step<N>`: two checkpoints give two config
    tags, so the same request has two cache keys; no --ckpt-dir, no tag."""
    from alphafold2_tpu_torch import serve, train_pre
    from alphafold2_tpu_torch.serving.cache import request_key

    tiny = ["--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8"]
    for name, steps in (("a", "1"), ("b", "2")):
        train_pre.main(tiny + ["--steps", steps, "--len", "8", "--accum", "1", "--device",
                               "cpu", "--ckpt-dir", str(tmp_path / name)])
    engines = []

    class Recorded(serve.ServingEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)

    monkeypatch.setattr(serve, "ServingEngine", Recorded)
    for ck in (["--ckpt-dir", str(tmp_path / "a")], ["--ckpt-dir", str(tmp_path / "b")], []):
        assert serve.main(tiny + ["--demo", "2", "--buckets", "8", "--max-batch", "1",
                                  "--mds-iters", "2", "--max-seq-len", "2048",
                                  "--device", "cpu"] + ck) == 0
    out = capsys.readouterr().out
    assert "restored step-1 params" in out and "restored step-2 params" in out
    assert [e.cfg.params_tag for e in engines] == [f"{tmp_path / 'a'}@step1",
                                                   f"{tmp_path / 'b'}@step2", ""]
    keys = {request_key("MKTAYIAK", None, e.config_tag) for e in engines}
    assert len(keys) == 3
