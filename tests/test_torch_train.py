"""Distogram pretraining on the port against the JAX package (CPU).

The same weights (`params_from_jax`), the same numpy batches: the loss and
its labels, the synthetic data, the optimizer and its schedule, and the
whole `make_train_step` (3 steps, 2 microbatches) against JAX's, also with
`remat` under each `remat_policy` and with warmup, cosine decay, clipping
and weight decay on; the training-mode dropout on its own (the two random
streams cannot match); `remat` and each `remat_policy` against no remat,
and which products each policy keeps through the recompute; the bf16
dense-mask repair against JAX bf16; and the CLI at a tiny width.

Tolerances (float32 unless stated): both sides compute the same function
in another summation order. Losses of magnitude ~4: 1e-5 absolute.
grad_norm: 1e-5 relative. Gradients: 1e-5 times max(1, the leaf's
largest entry). Params after 3 Adam steps: 1e-5 absolute, a thirtieth of
one step (a step moves an entry by about lr = 3e-4; an entry whose
gradient were rounding noise could differ by 2 lr, and none is here).
Labels and synthetic batches: exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_apply as jax_apply
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.training import data as jdata
from alphafold2_tpu.training import harness as jharness
from alphafold2_tpu.training import losses as jlosses
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_apply, params_from_jax
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_front
from alphafold2_tpu_torch.models.trunk import sequential_trunk_apply
from alphafold2_tpu_torch.ops.core import dropout
from alphafold2_tpu_torch.training import data, harness, losses

SMALL = dict(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=64)


# --- dropout ----------------------------------------------------------------


def test_dropout_keep_rate_scaling_and_repeatability():
    x = torch.ones(200_000)
    assert dropout(x, 0.0, torch.Generator().manual_seed(0)) is x
    assert dropout(x, 0.3, None) is x  # no generator: eval mode
    rate = 0.3
    y = dropout(x, rate, torch.Generator().manual_seed(1))
    kept = y != 0
    # the keep fraction within 5 binomial standard deviations of 1 - rate
    sd = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - (1 - rate)) < 5 * sd
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    again = dropout(x, rate, torch.Generator().manual_seed(1))
    assert torch.equal(y, again)
    assert not torch.equal(y, dropout(x, rate, torch.Generator().manual_seed(2)))


# --- losses and data --------------------------------------------------------


def test_boundaries_are_jax_linspace_bit_for_bit():
    want = np.asarray(jnp.linspace(2.0, 20.0, 37)[:-1])
    got = losses.distogram_boundaries().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_labels_and_loss_match_jax():
    rng = np.random.default_rng(0)
    coords = np.cumsum(3.8 * rng.normal(size=(2, 30, 3)), axis=1).astype(np.float32)
    mask = np.arange(30)[None] < np.array([[30], [21]])
    logits = rng.normal(size=(2, 30, 30, 37)).astype(np.float32)
    want = np.asarray(jlosses.bucketed_distance_matrix(coords, mask))
    got = losses.bucketed_distance_matrix(torch.from_numpy(coords), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == losses.IGNORE_INDEX).sum() == 30 * 30 - 21 * 21
    jl = float(jlosses.distogram_cross_entropy(logits, want))
    tl = float(losses.distogram_cross_entropy(torch.from_numpy(logits), got))
    assert abs(jl - tl) <= 1e-5


@pytest.mark.parametrize("msa_rows", [0, 3])
def test_synthetic_batches_equal_jax(msa_rows):
    cfg = dict(batch_size=2, max_len=20, msa_rows=msa_rows, seed=4)
    jit_, tit = (jdata.synthetic_batches(jdata.DataConfig(**cfg), start_index=5),
                 data.synthetic_batches(data.DataConfig(**cfg), start_index=5))
    jst = jdata.stack_microbatches(jit_, 3)
    tst = data.stack_microbatches(tit, 3)
    for _ in range(2):
        j, t = next(jst), next(tst)
        assert j.keys() == t.keys()
        for key in j:
            np.testing.assert_array_equal(t[key], j[key])
    jf = jdata.synthetic_microbatch_fn(jdata.DataConfig(**cfg), 2)(7)
    tf = data.synthetic_microbatch_fn(data.DataConfig(**cfg), 2)(7)
    for key in jf:
        np.testing.assert_array_equal(tf[key], jf[key])


# --- schedule and optimizer -------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(warmup_steps=4), dict(decay_steps=6, decay_floor=0.1),
     dict(warmup_steps=3, decay_steps=5, decay_floor=0.2)],
    ids=["constant", "warmup", "cosine", "warmup+cosine"],
)
def test_schedule_matches_optax(kw):
    want = jharness.make_schedule(jharness.TrainConfig(learning_rate=1e-3, **kw))
    got = harness.make_schedule(harness.TrainConfig(learning_rate=1e-3, **kw))
    for count in range(12):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12)
    if kw.get("warmup_steps"):
        assert got(0) == 0.0  # a warmup from 0 gives lr 0 on the first update


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("wd", [0.0, 0.05], ids=["nodecay", "decay"])
def test_optimizer_updates_match_optax(clip, wd):
    """Two updates (the bias correction changes between them) of
    clip_by_global_norm + adamw against optax; the gradient norm is above
    the clip threshold, so clipping acts. Bound 1e-6 on params of magnitude
    <= ~3: a few f32 ulps, as torch updates the moments with lerp where
    optax multiplies and adds."""
    kw = dict(learning_rate=1e-2, max_grad_norm=clip, weight_decay=wd, warmup_steps=2)
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params] for _ in range(2)]
    opt = jharness.make_optimizer(jharness.TrainConfig(**kw))
    jp, state = [jnp.asarray(p) for p in params], None
    state = opt.init(jp)
    leaves = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    topt = harness.make_optimizer(harness.TrainConfig(**kw), leaves)
    for count, g in enumerate(grads):
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for leaf, x in zip(leaves, g):
            leaf.grad = torch.from_numpy(x.copy())
        norm = topt.step(count)
        assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
        for leaf, want in zip(leaves, jp):
            np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)


# --- the train step ---------------------------------------------------------


def _params(jcfg, tcfg, seed=0):
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                    device="cpu")


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(attn_flash=True), dict(attn_gate=True),
     dict(depth=2, remat=True), dict(depth=2, remat=True, remat_policy="dots"),
     dict(depth=2, remat=True, remat_policy="dots_no_batch")],
    ids=["auto", "flash", "gate", "remat", "remat-dots", "remat-dots_no_batch"],
)
def test_train_step_matches_jax(kw):
    jcfg, tcfg = JaxConfig(**{**SMALL, **kw}), Alphafold2Config(**{**SMALL, **kw})
    _three_steps_match_jax(jcfg, tcfg, {})


def test_train_step_schedule_and_clip_match_jax():
    """The step with a warmup from 0 (lr 0 on the first update), cosine
    decay to a floor, global-norm clipping that acts (every step's norm is
    above 0.05) and weight decay, against JAX over 3 steps; the
    tolerances of the module docstring."""
    jcfg, tcfg = JaxConfig(**SMALL), Alphafold2Config(**SMALL)
    sched = dict(warmup_steps=1, decay_steps=3, decay_floor=0.1, max_grad_norm=0.05,
                 weight_decay=0.01)
    norms = _three_steps_match_jax(jcfg, tcfg, sched)
    assert min(norms) > 0.05


def _three_steps_match_jax(jcfg, tcfg, sched):
    """3 steps of 2 microbatches from the same params and batches: loss,
    grad_norm, the first step's mean gradient (without clipping) and the
    params after 3 steps against JAX. Returns the grad norms."""
    jparams, tparams = _params(jcfg, tcfg)
    jt = jharness.TrainConfig(grad_accum=2, **sched)
    tt = harness.TrainConfig(grad_accum=2, **sched)
    fetch = jdata.synthetic_microbatch_fn(jdata.DataConfig(max_len=24, seed=3), 2)
    jstate = {"params": jparams, "opt_state": jharness.make_optimizer(jt).init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = harness.train_state(tparams, tt)
    jstep = jax.jit(jharness.make_train_step(jcfg, jt))
    tstep = harness.make_train_step(tcfg, tt, device="cpu")

    # the first step's mean gradient, from JAX directly
    b0 = fetch(0)

    def mean_loss(p):
        return sum(jharness.distogram_loss_fn(p, jcfg, {k: v[n] for k, v in b0.items()}, None)
                   for n in range(2)) / 2

    jgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(mean_loss)(jparams)),
                             tcfg, device="cpu")
    norms = []
    for n in range(3):
        batch = fetch(n)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-5
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        norms.append(float(tm["grad_norm"]))
        if n == 0 and not tt.max_grad_norm:  # no clipping: the leaves hold the mean gradient
            for want, leaf in zip(tree_leaves(jgrads), tstate["optimizer"].leaves):
                atol = 1e-5 * max(1.0, want.abs().max().item())
                torch.testing.assert_close(leaf.grad, want, rtol=0, atol=atol)
    assert tstate["step"] == 3
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]), tcfg,
                           device="cpu")
    for w, leaf in zip(tree_leaves(want), tstate["optimizer"].leaves):
        torch.testing.assert_close(leaf.detach(), w, rtol=0, atol=1e-5)
    return norms


def test_remat_equals_no_remat():
    """remat recomputes each layer in the backward pass: the same math, so
    the same loss and gradients (dropout on: each layer's seed is drawn
    once, so the recompute draws the same masks)."""
    kw = dict(SMALL, depth=2, attn_dropout=0.1, ff_dropout=0.1)
    batch = data.synthetic_microbatch_fn(data.DataConfig(max_len=16, seed=1), 1)(0)
    mb = {k: v[0] for k, v in batch.items()}
    results = []
    for remat in (False, True):
        cfg = Alphafold2Config(**kw, remat=remat)
        state = harness.train_state_init(cfg, harness.TrainConfig(grad_accum=1),
                                         torch.Generator().manual_seed(0), "cpu")
        loss = harness.distogram_loss_fn(state["params"], cfg, mb,
                                         torch.Generator().manual_seed(5), "cpu")
        loss.backward()
        results.append((loss.item(), [p.grad.clone() if p.grad is not None else None
                                      for p in state["optimizer"].leaves]))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_remat_policy_equals_no_remat(policy):
    """A remat_policy keeps some products through the recompute and
    recomputes the rest: the same math, so the same loss and gradients as
    no remat, bit for bit (dropout on, an MSA stream, so the crosses and
    the MSA passes run too)."""
    kw = dict(SMALL, depth=2, attn_dropout=0.1, ff_dropout=0.1)
    batch = data.synthetic_microbatch_fn(data.DataConfig(max_len=16, msa_rows=3, seed=1), 1)(0)
    mb = {k: v[0] for k, v in batch.items()}
    results = []
    for fields in (dict(), dict(remat=True, remat_policy=policy)):
        cfg = Alphafold2Config(**kw, **fields)
        state = harness.train_state_init(cfg, harness.TrainConfig(grad_accum=1),
                                         torch.Generator().manual_seed(0), "cpu")
        loss = harness.distogram_loss_fn(state["params"], cfg, mb,
                                         torch.Generator().manual_seed(5), "cpu")
        loss.backward()
        results.append((loss.detach(), [p.grad.clone() for p in state["optimizer"].leaves]))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


PRODUCTS = {str(op): op for op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                                   torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)}


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products (mm, addmm, bmm, baddbmm) dispatched
    under it."""

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(PRODUCTS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in self.counts:
            self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch"])
def test_remat_policy_saves_its_products(policy):
    """Which products the backward recomputes under each policy: the
    backward's products with remat less those without it, each layer
    recomputed whole. None: every product of the trunk's forward; "dots":
    none; "dots_no_batch": the batched ones (bmm, the attention einsums),
    no mm or addmm (the dense layers). Counted with a TorchDispatchMode,
    at depth 2 with an MSA."""
    kw = dict(SMALL, depth=2)
    batch = data.synthetic_microbatch_fn(data.DataConfig(max_len=16, msa_rows=3, seed=1), 1)(0)
    mb = {k: v[0] for k, v in batch.items()}
    backward = {}
    for fields in (dict(), dict(remat=True, remat_policy=policy)):
        cfg = Alphafold2Config(**kw, **fields)
        state = harness.train_state_init(cfg, harness.TrainConfig(grad_accum=1),
                                         torch.Generator().manual_seed(0), "cpu")
        # the whole layer is recomputed (by default a recompute stops once
        # it has what the backward needs: the last layer's MSA update is not)
        with set_checkpoint_early_stop(False):
            loss = harness.distogram_loss_fn(state["params"], cfg, mb, None, "cpu")
            with _CountProducts() as mode:
                loss.backward()
        backward[cfg.remat] = mode.counts
    recomputed = {k: backward[True][k] - backward[False][k] for k in PRODUCTS}
    # the trunk's own forward products
    cfg = Alphafold2Config(**kw)
    params = harness.train_state_init(cfg, harness.TrainConfig(grad_accum=1),
                                      torch.Generator().manual_seed(0), "cpu")["params"]
    x, m, x_mask, m_mask = alphafold2_front(
        params, cfg, torch.as_tensor(mb["seq"]).long(), torch.as_tensor(mb["msa"]).long(),
        mask=torch.as_tensor(mb["mask"]), msa_mask=torch.as_tensor(mb["msa_mask"]))
    with _CountProducts() as mode:
        sequential_trunk_apply(params["trunk"], cfg, x, m, x_mask=x_mask, msa_mask=m_mask)
    trunk = mode.counts
    assert trunk["aten.mm.default"] > 0 and trunk["aten.bmm.default"] > 0
    saved = {None: (), "dots": tuple(PRODUCTS),
             "dots_no_batch": ("aten.mm.default", "aten.addmm.default")}[policy]
    for name in PRODUCTS:
        assert recomputed[name] == (0 if name in saved else trunk[name]), (name, recomputed)


def test_train_step_rejects_a_wrong_microbatch_count():
    cfg = Alphafold2Config(**SMALL)
    tt = harness.TrainConfig(grad_accum=2)
    state = harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cpu")
    batch = data.synthetic_microbatch_fn(data.DataConfig(max_len=8), 3)(0)
    with pytest.raises(ValueError, match="grad_accum=2"):
        harness.make_train_step(cfg, tt, device="cpu")(state, batch)


# --- the bf16 dense-mask repair ---------------------------------------------


@pytest.mark.parametrize("tied", [False, True], ids=["masked-dense", "tied-rows"])
def test_bf16_masked_dense_attention_matches_jax(tied):
    """bf16 with a padding mask on the dense path (and, tied, the MSA
    tied-row attention): the port once filled masked bf16 logits with the
    f32 minimum and raised; now it promotes first, as JAX does. Bound: 4
    bf16 ulps of the largest logit (the frameworks round at other places)."""
    kw = dict(SMALL, max_seq_len=32, attn_flash=False, msa_tie_row_attn=tied)
    jcfg = JaxConfig(**kw, dtype=jnp.bfloat16)
    tcfg = Alphafold2Config(**kw, dtype=torch.bfloat16)
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 20, (1, 12)).astype(np.int32)
    mask = np.ones((1, 12), bool)
    mask[:, 9:] = False
    msa = msa_mask = None
    if tied:
        msa = rng.integers(0, 21, (1, 3, 12)).astype(np.int32)
        msa_mask = rng.random((1, 3, 12)) > 0.2
        msa_mask[:, 0] = mask
    jl = np.asarray(jax_apply(jparams, jcfg, seq, msa, mask=mask, msa_mask=msa_mask),
                    np.float32)
    tl = alphafold2_apply(tparams, tcfg, seq, msa, mask=mask, msa_mask=msa_mask,
                          device="cpu")
    assert tl.dtype == torch.bfloat16
    tl = tl.float().numpy()
    assert np.isfinite(tl).all()
    pair = mask[:, :, None] & mask[:, None, :]
    bound = 4 * 2.0 ** -7 * np.abs(jl[pair]).max()
    assert np.abs(tl - jl)[pair].max() <= bound


# --- the CLI ----------------------------------------------------------------


def test_train_pre_cli_on_the_cpu(capsys):
    from alphafold2_tpu_torch import train_pre

    state, metrics = train_pre.main(["--steps", "2", "--dim", "16", "--depth", "1",
                                     "--heads", "2", "--dim-head", "8", "--len", "12",
                                     "--accum", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 1  loss" in out and "done" in out
    assert state["step"] == 2
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0


# the JAX training package's names the port does not export yet, each with
# the ROADMAP item that brings it
NOT_EXPORTED = {
    "CheckpointManager": "A12-orbax", "restore_or_init": "A12-orbax",
    "abstract_like": "A12-orbax",
    "sidechainnet_batches": "--data sidechainnet (not queued)",
    "sidechainnet_structure_batches": "--data sidechainnet (not queued)",
}


def test_the_training_package_exports_jax_names():
    """`alphafold2_tpu_torch.training` exports the JAX package's names less
    NOT_EXPORTED (plus `plan_segments`, the segmented step's planner),
    each the submodule's own object."""
    import alphafold2_tpu.training as jtraining
    import alphafold2_tpu_torch.training as ttraining

    assert set(ttraining.__all__) == (set(jtraining.__all__) - set(NOT_EXPORTED)
                                      | {"plan_segments"})
    assert not set(NOT_EXPORTED) - set(jtraining.__all__)
    assert ttraining.make_train_step is harness.make_train_step
    assert ttraining.distogram_cross_entropy is losses.distogram_cross_entropy
    for name in ttraining.__all__:
        assert getattr(ttraining, name) is not None


# --- the trainers' flags ------------------------------------------------------------

# the JAX trainers' flags (or choices) the port's CLIs lack, each with the
# ROADMAP item that brings it
MISSING_FLAGS = {
    "train_pre.py": {("--data", "sidechainnet"): "--data sidechainnet (not queued)"},
    "train_end2end.py": {("--data", None): "--data sidechainnet (not queued): the port's "
                                            "only source is the synthetic one"},
}


def cli_flags(path):
    """{flag: its literal keywords (default, choices, type, action, dest)}
    of every `add_argument` call in the file, and the `add_*_args` helpers
    it calls (the shared blocks, each package's own copy)."""
    import ast

    flags, helpers = {}, set()
    for node in ast.walk(ast.parse(open(path).read())):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and node.func.attr == "add_argument":
            kw = {}
            for k in node.keywords:
                if k.arg in ("default", "choices", "type", "action", "dest"):
                    try:
                        kw[k.arg] = ast.literal_eval(k.value)
                    except ValueError:
                        kw[k.arg] = ast.unparse(k.value)
            flags[node.args[0].value] = kw
        elif (isinstance(node.func, ast.Name) and node.func.id.startswith("add_")
              and node.func.id.endswith("_args")):
            helpers.add(node.func.id)
    return flags, helpers


@pytest.mark.parametrize("cli", ["train_pre.py", "train_end2end.py"])
def test_trainer_flags_are_the_jax_clis(cli):
    """An ast diff of the `add_argument` calls of the root CLI and the
    port's: the same flags with the same defaults, types and choices, the
    same shared blocks, plus `--device`, less MISSING_FLAGS; `--sp-shards`
    is there with JAX's default."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    jflags, jhelpers = cli_flags(root / cli)
    tflags, thelpers = cli_flags(root / "alphafold2_tpu_torch" / cli)
    assert thelpers == jhelpers
    assert set(tflags) - set(jflags) == {"--device"}
    missing = MISSING_FLAGS[cli]
    assert {f for f, choice in missing if choice is None} == set(jflags) - set(tflags)
    assert tflags["--sp-shards"] == jflags["--sp-shards"] == {"type": "int", "default": 0}
    for flag in set(jflags) & set(tflags):
        want = dict(jflags[flag])
        gone = {choice for f, choice in missing if f == flag}
        if gone:
            want["choices"] = [c for c in want["choices"] if c not in gone]
        assert tflags[flag] == want, flag
