"""End-to-end structure training on the port (`training/e2e.py
e2e_loss_fn`, `e2e_train_state_init`, `training/data.py
synthetic_structure_batches`, `train_end2end`) against the JAX package on
the CPU, float32, on the same parameters (the JAX tree through
`e2e_params_from_jax`, the refiner's coordinate head given non-zero
weights: it is zero at init) and the same batches.

Tolerances: the two packages compute the same function in another
summation order, with two differences that leave the loss unmoved. The
classical MDS init's `eigh` may return eigenvectors of other signs, so the
two clouds can come out mirror images; the mirror fix brings both to the
protein hand and the Kabsch-aligned RMSD does not see the rigid motion
left between them. The random init's draws differ between the packages,
so its case hands both JAX's draw. What holds:
  - the loss: 1e-5 relative;
  - each gradient leaf: 1e-4 of the leaf's largest entry (a leaf the loss
    does not read: exactly 0 on both);
  - 3 train steps of 2 microbatches: loss 1e-5 relative, grad_norm 1e-5
    relative, the params after 3 steps 1e-5 absolute (a step moves an
    entry by about lr = 3e-4), except entries whose first-step gradient is
    at most 1e-3 of their leaf's largest: 2 lr 3 (Adam normalises each
    entry's step to about lr whatever its gradient's size, so an entry
    whose gradient is rounding noise can step +lr on one side and -lr on
    the other; chip_smoke.py phase 6a's rule);
  - the data: seq, mask, msa and msa_mask bit-equal; coords 1e-6 (the
    side-chain lift runs in torch here, in JAX there);
  - checkpoints: every leaf bit-equal, both ways.

JAX's `geometry/kabsch.py kabsch` under `jax.jit` on the CPU departs from
its own eager result by ~2 A when a structure needs the reflection fix
(the `.at[..., :, -1].set` of U's last column; held below). The port
computes the eager function, so the JAX side of every jitted comparison
here runs `eager_form_kabsch`: the same arithmetic with the flip as a sign
on U's last column, which jit compiles to the eager result.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import RefinerConfig as JaxRefinerConfig
from alphafold2_tpu.training import data as jdata
from alphafold2_tpu.training import e2e as je2e
from alphafold2_tpu.training import harness as jharness
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.convert import e2e_params_from_jax, train_state_to_jax
from alphafold2_tpu_torch.models.refiner import RefinerConfig
from alphafold2_tpu_torch.training import data as tdata
from alphafold2_tpu_torch.training import e2e as te2e
from alphafold2_tpu_torch.training import harness

# the module (the package's `mds` attribute is the function)
tmds = importlib.import_module("alphafold2_tpu_torch.geometry.mds")
SMALL = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48)
REFINER = dict(num_tokens=14, dim=16, depth=2)
L = 8


def perturb_coord_head(tree, seed=0):
    """Random non-zero weights for the refiner's coordinate head (numpy tree)."""
    rng = np.random.default_rng(seed)
    for layer in tree["refiner"]["layers"]:
        head = layer["coord_mlp"]["l2"]
        head["w"] = (rng.normal(size=head["w"].shape) * 0.1).astype(np.float32)
        head["b"] = (rng.normal(size=head["b"].shape) * 0.1).astype(np.float32)
    return tree


def configs(model_kw=(), refiner=REFINER, **ecfg_kw):
    """(JAX E2EConfig, port E2EConfig) of the same fields, classical init."""
    mkw = {**SMALL, **dict(model_kw)}
    ekw = {"mds_iters": 5, "mds_init": "classical", **ecfg_kw}
    return (je2e.E2EConfig(model=JaxConfig(**mkw), refiner=JaxRefinerConfig(**refiner), **ekw),
            te2e.E2EConfig(model=Alphafold2Config(**mkw), refiner=RefinerConfig(**refiner), **ekw))


def params_pair(jc, tc, seed=0):
    """(JAX params, port params) of one perturbed JAX init."""
    tree = perturb_coord_head(jax.tree_util.tree_map(
        np.asarray, je2e.e2e_params_init(jax.random.PRNGKey(seed), jc)))
    return jax.tree_util.tree_map(jnp.asarray, tree), e2e_params_from_jax(tree, tc, "cpu")


def eager_form_kabsch(X, Y, weights=None):
    """JAX's kabsch with the reflection fix as a multiply by diag(1, 1, sign)
    (its arithmetic otherwise line for line): under jit it gives what JAX's
    kabsch gives eagerly."""
    w = jnp.ones(X.shape[:-2] + (X.shape[-1],), X.dtype) if weights is None else weights
    w = jnp.asarray(w, X.dtype)[..., None, :]
    denom = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-8)
    Xc = X - jnp.sum(X * w, axis=-1, keepdims=True) / denom
    Yc = Y - jnp.sum(Y * w, axis=-1, keepdims=True) / denom
    C = jnp.einsum("...dn,...en->...de", Xc * w, Yc)
    U, _, Vt = jnp.linalg.svd(jax.lax.stop_gradient(C))
    sign = jnp.where(jnp.linalg.det(U) * jnp.linalg.det(Vt) < 0.0, -1.0, 1.0)
    ones = jnp.ones_like(sign)
    U = U * jnp.stack([ones, ones, sign], axis=-1)[..., None, :]
    R = jnp.einsum("...ij,...jk->...ik", U, Vt)
    return jnp.einsum("...ji,...jn->...in", R, Xc), Yc


@pytest.fixture(scope="module", autouse=True)
def jax_kabsch_in_eager_form():
    """JAX's e2e loss aligns with `eager_form_kabsch` in this module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(je2e, "kabsch", eager_form_kabsch)
    yield
    mp.undo()


def reflected_pairs(n=6, points=20):
    """(X, Y, weights) triples whose alignments need the reflection fix:
    Y is a mirrored rotation of X plus noise."""
    rng = np.random.default_rng(0)
    for _ in range(n):
        X = rng.normal(size=(1, 3, points)).astype(np.float32)
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        Q = Q * np.sign(np.linalg.det(Q)) * np.array([1.0, 1.0, -1.0])
        Y = (Q @ X[0])[None].astype(np.float32) + 0.3 * rng.normal(
            size=(1, 3, points)).astype(np.float32)
        yield X, Y, (rng.random((1, points)) > 0.2).astype(np.float32)


def test_kabsch_on_reflections_is_jax_eager_kabsch():
    """On targets that need the reflection fix the port's kabsch equals
    JAX's eager kabsch (1e-5), and so does `eager_form_kabsch` under jit;
    JAX's own kabsch under jit departs from its eager result there (the
    largest departure is reported, not held)."""
    from alphafold2_tpu.geometry.kabsch import kabsch as jax_kabsch
    from alphafold2_tpu_torch.geometry import kabsch

    jitted = jax.jit(jax_kabsch)
    form = jax.jit(eager_form_kabsch)
    departure = 0.0
    for X, Y, w in reflected_pairs():
        want = np.asarray(jax_kabsch(X, Y, weights=w)[0])
        got = kabsch(torch.from_numpy(X), torch.from_numpy(Y), weights=torch.from_numpy(w))[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(form(X, Y, w)[0]), want, rtol=0, atol=1e-5)
        departure = max(departure, float(np.abs(np.asarray(jitted(X, Y, w)[0]) - want).max()))
    print(f"JAX's jitted kabsch departs from its eager result by up to {departure:.3f} A")


# --- the data ---------------------------------------------------------------------


@pytest.mark.parametrize("seed, msa_rows", [(0, 3), (7, 0)])
def test_structure_batches_match_jax(seed, msa_rows):
    """synthetic_structure_batches from a start index, and the step-indexed
    fetch over it (`synthetic_microbatch_fn(source=)`), against JAX's."""
    jd = jdata.DataConfig(batch_size=2, max_len=10, msa_rows=msa_rows, seed=seed)
    td = tdata.DataConfig(batch_size=2, max_len=10, msa_rows=msa_rows, seed=seed)
    jit, tit = (jdata.synthetic_structure_batches(jd, start_index=5),
                tdata.synthetic_structure_batches(td, start_index=5))
    jf = jdata.synthetic_microbatch_fn(jd, 2, source=jdata.synthetic_structure_batches)
    tf = tdata.synthetic_microbatch_fn(td, 2, source=tdata.synthetic_structure_batches)
    for want, got in [(next(jit), next(tit)), (next(jit), next(tit)), (jf(3), tf(3))]:
        assert sorted(want) == sorted(got) == sorted(
            ["seq", "mask", "coords"] + (["msa", "msa_mask"] if msa_rows else []))
        for key in want:
            assert got[key].dtype == np.asarray(want[key]).dtype, key
            if key == "coords":
                np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert tf(3)["coords"].shape == (2, 2, 10, 14, 3)


# --- the loss and its gradients -----------------------------------------------------


LOSS_CASES = {
    # a padded residue on one structure, an MSA (flat crosses)
    "msa": dict(features="msa", pad=True),
    "none": dict(features="none"),
    "esm": dict(features="esm"),
    # the north-star preset's knobs at small widths
    "north_star": dict(features="msa", model_kw=dict(
        cross_attn_mode="aligned", cross_attn_compress_ratio=2, msa_tie_row_attn=True)),
    "bwd_iters2": dict(features="msa", ecfg=dict(mds_bwd_iters=2)),
    "atom_mask": dict(features="msa", atom_mask=True),
    "random_init": dict(features="none", ecfg=dict(mds_init="random", mds_iters=10)),
}
NUM_EMBEDDS = 24


def loss_batch(case, seed=2):
    """One microbatch of two structures for a LOSS_CASES entry."""
    spec = LOSS_CASES[case]
    d = jdata.DataConfig(batch_size=2, max_len=L, seed=seed,
                         msa_rows=3 if spec["features"] == "msa" else 0)
    batch = {k: np.array(v) for k, v in next(jdata.synthetic_structure_batches(d)).items()}
    rng = np.random.default_rng(seed)
    if spec.get("pad"):
        batch["mask"][1, L - 2:] = False
        batch["seq"][1, L - 2:] = 20
        batch["msa_mask"] = batch["msa_mask"] & batch["mask"][:, None, :]
    if spec["features"] == "esm":
        batch["embedds"] = rng.normal(size=(2, 3 * L, NUM_EMBEDDS)).astype(np.float32)
    if spec.get("atom_mask"):
        batch["atom_mask"] = rng.random((2, L, 14)) > 0.2
    return batch


def jax_random_init(monkeypatch, b, n):
    """The port's `initial_coords` hands back JAX's random draw (JAX's
    predict_structure without an rng draws from PRNGKey(0))."""
    draw = np.asarray(2.0 * jax.random.uniform(jax.random.PRNGKey(0), (b, n, 3)) - 1.0)
    plain = tmds.initial_coords

    def patched(pre_dist_mat, init="classical", generator=None):
        if init != "random":
            return plain(pre_dist_mat, init, generator)
        return torch.from_numpy(draw).to(pre_dist_mat.device)

    monkeypatch.setattr(tmds, "initial_coords", patched)


def assert_grads_close(jgrads, tparams, tc):
    """Each port leaf's .grad against JAX's gradient leaf: 1e-4 of the
    leaf's largest entry (exactly 0 where JAX's is all zero)."""
    want = e2e_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tc, "cpu")
    worst = 0.0
    for w, leaf in zip(tree_leaves(want), tree_leaves(tparams)):
        got = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        scale = w.abs().max().item()
        if scale == 0.0:
            assert got.abs().max().item() == 0.0
            continue
        worst = max(worst, (got - w).abs().max().item() / (1e-4 * scale))
    assert worst <= 1.0, worst
    return worst


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_e2e_loss_and_gradients_match_jax(case, monkeypatch):
    """e2e_loss_fn's value and every gradient leaf against JAX's on the same
    params and microbatch, rng None on both sides."""
    spec = LOSS_CASES[case]
    model_kw = dict(spec.get("model_kw", {}))
    if spec["features"] == "esm":
        model_kw["num_embedds"] = NUM_EMBEDDS
    jc, tc = configs(model_kw, **spec.get("ecfg", {}))
    jp, tp = params_pair(jc, tc)
    batch = loss_batch(case)
    if case == "random_init":
        jax_random_init(monkeypatch, 2, 3 * L)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: je2e.e2e_loss_fn(p, jc, b, None)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    tloss = te2e.e2e_loss_fn(tp, tc, batch, None, "cpu")
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    assert_grads_close(jgrads, tp, tc)


def test_random_init_draws_from_the_rng_a_seed_a_microbatch():
    """mds_generator: seed 0 without an rng (JAX's PRNGKey(0)); with an rng
    and the random init one draw from it, so two microbatches of a step
    start MDS from different clouds and the same rng state gives the same
    cloud; the classical init draws nothing."""
    jc, tc = configs(mds_init="random")
    first = torch.rand(3, generator=te2e.mds_generator(tc, None))
    assert torch.equal(first, torch.rand(3, generator=torch.Generator().manual_seed(0)))
    rng = torch.Generator().manual_seed(5)
    a = torch.rand(3, generator=te2e.mds_generator(tc, rng))
    b = torch.rand(3, generator=te2e.mds_generator(tc, rng))
    assert not torch.equal(a, b)
    again = torch.rand(3, generator=te2e.mds_generator(tc, torch.Generator().manual_seed(5)))
    assert torch.equal(a, again)
    state = rng.get_state()
    te2e.mds_generator(configs()[1], rng)
    assert torch.equal(rng.get_state(), state)


# --- the train step -------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_setup():
    """The e2e train step of both packages at one small config (an MSA),
    JAX's jitted once for the module."""
    jc, tc = configs()
    jt, tt = jharness.TrainConfig(grad_accum=2), harness.TrainConfig(grad_accum=2)
    jstep = jax.jit(jharness.make_train_step(jc, jt, loss_fn=je2e.e2e_loss_fn))
    fetch = jdata.synthetic_microbatch_fn(
        jdata.DataConfig(batch_size=1, max_len=L, msa_rows=3, seed=4), 2,
        source=jdata.synthetic_structure_batches)
    return jc, tc, jt, tt, jstep, fetch


def test_e2e_train_step_matches_jax(step_setup):
    """3 steps of make_train_step(ecfg, tcfg, loss_fn=e2e_loss_fn), 2
    microbatches, from the same params and batches: loss, grad_norm and
    the params after 3 steps against JAX's make_train_step."""
    jc, tc, jt, tt, jstep, fetch = step_setup
    jp, tp = params_pair(jc, tc, seed=1)
    jstate = {"params": jp, "opt_state": jharness.make_optimizer(jt).init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = harness.train_state(tp, tt)
    tstep = harness.make_train_step(tc, tt, loss_fn=te2e.e2e_loss_fn, device="cpu")
    noisy = []
    for n in range(3):
        batch = fetch(n)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        if n == 0:  # no clipping: the leaves hold the first step's mean gradient
            noisy = [leaf.grad.abs() <= 1e-3 * leaf.grad.abs().max()
                     for leaf in tree_leaves(tstate["params"])]
    assert tstate["step"] == 3
    want = e2e_params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]), tc, "cpu")
    for w, leaf, small in zip(tree_leaves(want), tree_leaves(tstate["params"]), noisy):
        d = (leaf.detach() - w).abs()
        assert d[~small].max().item() <= 1e-5 if (~small).any() else True
        assert d.max().item() <= 2 * tt.learning_rate * 3


def test_captured_step_refuses_an_e2e_config(step_setup):
    """CapturedTrainStep names A8-e2e-capture for an E2EConfig (before it
    looks at the state's device)."""
    from alphafold2_tpu_torch.training.executable import CapturedTrainStep

    _, tc, _, tt, _, fetch = step_setup
    state = te2e.e2e_train_state_init(tc, tt, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="A8-e2e-capture"):
        CapturedTrainStep(tc, tt, state, fetch(0))


def test_e2e_train_state_init_refuses_int8():
    _, tc = configs(dict(weight_dtype="int8"))
    with pytest.raises(ValueError, match="inference-only"):
        te2e.e2e_train_state_init(tc, harness.TrainConfig(), torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="inference-only"):
        harness.make_train_step(tc, harness.TrainConfig(), loss_fn=te2e.e2e_loss_fn,
                                device="cpu")


# --- checkpoints and the CLI ----------------------------------------------------------

CLI = ["--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8", "--len", "8",
       "--mds-iters", "5", "--refiner-depth", "1", "--device", "cpu"]


def cli_configs(argv):
    """The port's E2EConfig the CLI builds from argv, and the JAX one of the
    same fields."""
    from alphafold2_tpu_torch.train_end2end import build_parser, e2e_config_from_args

    tc = e2e_config_from_args(build_parser().parse_args(argv))
    m = tc.model
    jm = JaxConfig(dim=m.dim, depth=m.depth, heads=m.heads, dim_head=m.dim_head,
                   max_seq_len=m.max_seq_len, max_num_msa=m.max_num_msa,
                   num_embedds=m.num_embedds)
    r = tc.refiner
    jc = je2e.E2EConfig(model=jm, refiner=JaxRefinerConfig(num_tokens=r.num_tokens, dim=r.dim,
                                                            depth=r.depth),
                        mds_iters=tc.mds_iters, mds_init=tc.mds_init)
    return jc, tc


def run_cli(*argv):
    from alphafold2_tpu_torch.train_end2end import main

    return main([*CLI, *argv])


def manifest(directory, step):
    with open(directory / f"step_{step:08d}.npz.manifest.json") as f:
        return json.load(f)


def test_checkpoints_cross_packages_through_the_cli(tmp_path, capsys):
    """A JAX e2e TrainState after one step, saved by the JAX package's
    verified manager: the port's e2e_train_state_init has its leaf paths
    and shapes, the port's open_or_init restores every leaf bit for bit,
    `train_end2end --ckpt-dir` resumes it at step 1 and saves step 2, and
    the JAX package's open_or_init restores the port's step 2 bit for bit."""
    from alphafold2_tpu.training.checkpoint import VerifiedCheckpointManager as JaxManager
    from alphafold2_tpu.training.checkpoint import open_or_init as jax_open_or_init
    from alphafold2_tpu_torch.training.checkpoint import open_or_init

    jc, tc = cli_configs(CLI)
    jt, tt = jharness.TrainConfig(grad_accum=2), harness.TrainConfig(grad_accum=2)
    jstate = je2e.e2e_train_state_init(jax.random.PRNGKey(3), jc, jt)
    fetch = jdata.synthetic_microbatch_fn(
        jdata.DataConfig(batch_size=1, max_len=8, msa_rows=4, seed=0), 2,
        source=jdata.synthetic_structure_batches)
    jstate, _ = jax.jit(jharness.make_train_step(jc, jt, loss_fn=je2e.e2e_loss_fn))(
        jstate, fetch(0))
    ck = tmp_path / "ck"
    JaxManager(str(ck)).save(jstate, force=True)
    stored = manifest(ck, 1)

    fresh = te2e.e2e_train_state_init(tc, tt, torch.Generator().manual_seed(0), "cpu")
    items = train_state_to_jax(fresh)
    assert [p for p, _ in items] == stored["paths"]
    assert [list(np.shape(a)) for _, a in items] == [m["shape"] for m in stored["leaf_meta"]]

    _, state, resumed = open_or_init(str(ck), te2e.e2e_train_state_init, tc, tt,
                                     torch.Generator().manual_seed(0), "cpu")
    assert resumed and state["step"] == 1
    jleaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstate))
    got = train_state_to_jax(state)
    assert len(got) == len(jleaves)
    for (path, a), b in zip(got, jleaves):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))

    state, _ = run_cli("--steps", "1", "--ckpt-dir", str(ck))
    assert "resumed from step 1" in capsys.readouterr().out
    assert state["step"] == 2
    _, jback, jresumed = jax_open_or_init(str(ck), je2e.e2e_train_state_init,
                                          jax.random.PRNGKey(9), jc, jt, verify=True)
    assert jresumed and int(jback["step"]) == 2
    back = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jback))
    for (path, a), b in zip(train_state_to_jax(state), back):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


@pytest.mark.parametrize("features", ["msa", "esm", "none"])
def test_cli_trains_each_feature_mode(features, capsys):
    state, metrics = run_cli("--steps", "2", "--features", features)
    out = capsys.readouterr().out
    assert "step 1  loss" in out and "done" in out
    assert state["step"] == 2
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    # only the esm features resize and train the embedds projection (the
    # JAX CLI's --esm-dim default, 128)
    embed = state["params"]["model"]["embedd_project"]["w"]
    assert embed.shape[0] == (128 if features == "esm" else Alphafold2Config(dim=16).num_embedds)
    assert (embed.grad.abs().max().item() > 0) == (features == "esm")


ESM_TINY = ["--features", "esm", "--esm-dim", "16", "--esm-layers", "1", "--esm-heads", "2"]


def fair_esm_state_dict(dim, layers, seed=0):
    """A fair-esm ESM-1b layout state dict of random weights."""
    from alphafold2_tpu_torch.models.embedder import EmbedderConfig

    cfg = EmbedderConfig(num_layers=layers, dim=dim, heads=2)
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    sd = {"embed_tokens.weight": r(cfg.vocab, dim),
          "embed_positions.weight": r(cfg.pos_table_rows, dim)}
    for name in ("emb_layer_norm_before", "emb_layer_norm_after"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = 1.0 + r(dim), r(dim)
    for i in range(layers):
        p = f"layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.self_attn.{proj}.weight"], sd[f"{p}.self_attn.{proj}.bias"] = \
                r(dim, dim), r(dim)
        for norm in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{p}.{norm}.weight"], sd[f"{p}.{norm}.bias"] = 1.0 + r(dim), r(dim)
        sd[f"{p}.fc1.weight"], sd[f"{p}.fc1.bias"] = r(4 * dim, dim), r(4 * dim)
        sd[f"{p}.fc2.weight"], sd[f"{p}.fc2.bias"] = r(dim, 4 * dim), r(dim)
    return sd


@pytest.mark.parametrize("layout", ["fair-esm", "transformers"])
def test_cli_loads_an_esm_checkpoint(layout, tmp_path, capsys):
    """--esm-ckpt on an npz written here from random weights, in either
    key style: the converter its keys name loads it, and its weights (not
    the random ones) make the embeddings: the first loss moves."""
    from alphafold2_tpu_torch.models import embedder as temb

    sd = fair_esm_state_dict(16, 1)
    if layout == "transformers":
        static = {v: k for k, v in temb._HF_STATIC.items()}
        stems = {v: k for k, v in temb._HF_LAYER.items()}
        hf = {}
        for key, val in sd.items():
            if key in static:
                hf["esm." + static[key]] = val
            else:
                _, idx, rest = key.split(".", 2)
                stem, leaf = rest.rsplit(".", 1)
                hf[f"encoder.layer.{idx}.{stems[stem]}.{leaf}"] = val
        sd = hf
    np.savez(tmp_path / "esm.npz", **sd)
    _, loaded = run_cli("--steps", "1", *ESM_TINY, "--esm-ckpt", str(tmp_path / "esm.npz"))
    assert f"({layout} layout)" in capsys.readouterr().out
    _, random = run_cli("--steps", "1", *ESM_TINY)
    assert float(loaded["loss"]) != float(random["loss"])


def test_cli_resume_is_bit_exact(tmp_path, capsys):
    """3 steps at once against 2 steps, then 1 resumed from the checkpoint:
    every param, moment and count bit for bit."""
    whole, _ = run_cli("--steps", "3", "--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "1")
    run_cli("--steps", "2", "--ckpt-dir", str(tmp_path / "b"), "--ckpt-every", "1")
    resumed, _ = run_cli("--steps", "1", "--ckpt-dir", str(tmp_path / "b"))
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["step"] == whole["step"] == 3
    for (pa, a), (pb, b) in zip(train_state_to_jax(whole), train_state_to_jax(resumed)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(pa))


def test_cli_fault_plan_rolls_back_to_the_fault_free_run(tmp_path, capsys):
    """A nan_grads fault at step 1 under --fault-plan: the guard rolls the
    step back, refetches its batch, and the run ends bit for bit the
    fault-free run's."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [{"kind": "nan_grads", "step": 1}]}))
    clean, _ = run_cli("--steps", "3")
    faulted, _ = run_cli("--steps", "3", "--fault-plan", str(plan))
    assert "rolled back" in capsys.readouterr().out
    assert faulted["step"] == 3
    for a, b in zip(tree_leaves(clean["params"]), tree_leaves(faulted["params"])):
        assert torch.equal(a, b)


def test_training_runs_after_an_inference_mode_forward():
    """A forward under torch.inference_mode first (the predict CLI's), then
    an e2e train step in the same process: the distogram bins cached by
    the first call are ordinary tensors, which the step's backward can
    save (inference tensors cannot be)."""
    from alphafold2_tpu_torch.geometry import distogram

    distogram._default_bins.cache_clear()
    _, tc = configs()
    tt = harness.TrainConfig(grad_accum=1)
    state = te2e.e2e_train_state_init(tc, tt, torch.Generator().manual_seed(0), "cpu")
    batch = tdata.synthetic_microbatch_fn(tdata.DataConfig(max_len=L, msa_rows=2), 1,
                                          source=tdata.synthetic_structure_batches)(0)
    with torch.inference_mode():
        te2e.predict_structure(state["params"], tc, batch["seq"][0], msa=batch["msa"][0],
                               device="cpu")
    _, metrics = harness.make_train_step(tc, tt, loss_fn=te2e.e2e_loss_fn, device="cpu")(
        state, batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0


def test_e2e_entry_points_raise_without_cuda(monkeypatch):
    """Without a card and without device="cpu" the e2e entry points raise
    (no CPU fallback); the explicit CPU request runs (the tests above)."""
    from alphafold2_tpu_torch.train_end2end import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = configs()
    tt = harness.TrainConfig(grad_accum=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te2e.e2e_train_state_init(tc, tt, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.make_train_step(tc, tt, loss_fn=te2e.e2e_loss_fn)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--steps", "1", "--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8"])


def test_resilient_batches_wraps_an_iterator():
    """The iterator form (train_end2end's esm stream under --fault-plan): a
    failing fetch is retried and takes the next record; the end of the data
    passes through as StopIteration; calling it with a step is refused."""

    class Flaky:
        def __init__(self):
            self.calls, self.items = 0, iter(range(3))

        def __iter__(self):
            return self

        def __next__(self):
            self.calls += 1
            if self.calls == 2:
                raise OSError("transient read error")
            return next(self.items)

    fetch = tdata.resilient_batches(Flaky(), backoff_s=0.0)
    assert not fetch.step_indexed
    assert [next(fetch) for _ in range(3)] == [0, 1, 2]
    assert fetch.retries == 1 and fetch.skipped == 0
    with pytest.raises(StopIteration):
        next(fetch)
    with pytest.raises(TypeError, match="iterated"):
        fetch(0)
