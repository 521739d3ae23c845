"""trunk_schedule="branch_parallel" (models/trunk.py
`branch_parallel_layer_apply`), the port against JAX's branch_parallel
trunk and against the port's own serial schedule, float32 on the CPU
(JAX: tests/test_trunk_schedule.py).

On the CPU the branch-parallel layer issues the serial layer's ops in the
serial order, so against the serial schedule it is bit for bit: trunk
outputs, gradients, the eager train step and dropout's draws. Against JAX
(the same float32 function in another summation order): trunk outputs
1e-5 absolute, as tests/test_torch_sp_trunk.py holds them (values of
magnitude ~1-4); gradients 2e-6 * max(1, |ref|) per leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models.trunk import sequential_trunk_apply as jax_trunk
from alphafold2_tpu.models.trunk import trunk_layer_init as jax_layer_init
from alphafold2_tpu.parallel import make_mesh as jax_make_mesh
from alphafold2_tpu.parallel import msa_sharded_trunk_apply as jax_msa_sharded
from alphafold2_tpu.parallel import sp_trunk_apply as jax_sp_trunk
from alphafold2_tpu_torch import Alphafold2Config
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.models.convert import convert_tree
from alphafold2_tpu_torch.models.trunk import sequential_trunk_apply
from alphafold2_tpu_torch.parallel import make_mesh, msa_sharded_trunk_apply, sp_trunk_apply

ATOL = 1e-5
BASE = dict(dim=16, depth=2, heads=2, dim_head=8, max_seq_len=64, msa_tie_row_attn=True)


def setup(kw, n=16, rows=8, cols=16, seed=0):
    """JAX's layers and their port copy, inputs and masks as JAX's
    tests/test_trunk_schedule.py `_setup` makes them; the two schedules'
    configs on each side."""
    cfg_kw = {**BASE, **kw}
    jcfg = JaxConfig(**cfg_kw)
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 + jcfg.depth)
    jlayers = [jax_layer_init(k, jcfg) for k in keys[2:]]
    tlayers = convert_tree(jax.tree_util.tree_map(np.asarray, jlayers), "cpu")
    x = np.asarray(jax.random.normal(keys[0], (1, n, n, jcfg.dim)))
    m = np.asarray(jax.random.normal(keys[1], (1, rows, cols, jcfg.dim)))
    x_mask = np.ones((1, n, n), bool)
    x_mask[:, :, -3:] = False
    msa_mask = np.ones((1, rows, cols), bool)
    msa_mask[:, :, -2:] = False
    bp = {**cfg_kw, "trunk_schedule": "branch_parallel"}
    return (jcfg, JaxConfig(**bp), Alphafold2Config(**cfg_kw), Alphafold2Config(**bp),
            jlayers, tlayers, x, m, x_mask, msa_mask)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def assert_close(got, want, atol=ATOL):
    got = got.detach().numpy()
    assert got.shape == np.asarray(want).shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def test_config_takes_both_schedules_and_rejects_others():
    assert Alphafold2Config(dim=16, trunk_schedule="branch_parallel").trunk_schedule == \
        "branch_parallel"
    with pytest.raises(ValueError, match="trunk_schedule"):
        Alphafold2Config(dim=16, trunk_schedule="diagonal")


ARMS = [{}, {"scan_layers": True}, {"remat": True}, {"remat": True, "remat_policy": "dots"}]


@pytest.mark.parametrize("arm", ARMS, ids=["sequential", "scan", "remat", "remat-dots"])
def test_branch_parallel_matches_serial_and_jax(arm):
    """The trunk's outputs and the gradients of sum(x^2) + sum(m^2) in
    every layer leaf: bit for bit the serial schedule's, and JAX's
    branch_parallel trunk's (whose own test holds it to JAX's serial one)."""
    jser, jbp, tser, tbp, jl, tl, x, m, xm, mm = setup(arm)

    def port(cfg):
        leaves = list(tree_leaves(tl))
        for leaf in leaves:
            leaf.requires_grad_(True)
        xo, mo = sequential_trunk_apply(tl, cfg, t(x), t(m), x_mask=t(xm), msa_mask=t(mm))
        grads = torch.autograd.grad((xo ** 2).sum() + (mo ** 2).sum(), leaves)
        return xo.detach(), mo.detach(), grads

    def jloss(ls):
        xo, mo = jax_trunk(ls, jbp, x, m, x_mask=xm, msa_mask=mm)
        return jnp.sum(xo ** 2) + jnp.sum(mo ** 2), (xo, mo)

    xs, ms, gs = port(tser)
    xb, mb, gb = port(tbp)
    assert torch.equal(xb, xs) and torch.equal(mb, ms)
    assert all(torch.equal(a, b) for a, b in zip(gb, gs))

    jgrads, (jx, jm) = jax.jit(jax.grad(jloss, has_aux=True))(jl)
    assert_close(xb, jx)
    assert_close(mb, jm)
    for got, want in zip(gb, tree_leaves(convert_tree(
            jax.tree_util.tree_map(np.asarray, jgrads), "cpu"))):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2e-6 * max(1.0, want.abs().max().item()))


def test_layers_without_an_msa_run_serially():
    """With no MSA stream a layer has one track: branch_parallel is the
    serial layer, bit for bit."""
    _, _, tser, tbp, _, tl, x, _, xm, _ = setup({})
    with torch.no_grad():
        xs, ms = sequential_trunk_apply(tl, tser, t(x), None, x_mask=t(xm))
        xb, mb = sequential_trunk_apply(tl, tbp, t(x), None, x_mask=t(xm))
    assert ms is None and mb is None
    assert torch.equal(xb, xs)


def test_dropout_draws_in_the_serial_order():
    """Live dropout: each layer's ops draw from one generator in turn, in
    the serial order under either schedule, so a seed gives the serial
    masks bit for bit (with remat, which draws them again)."""
    _, _, tser, tbp, _, tl, x, m, xm, mm = setup(dict(attn_dropout=0.2, ff_dropout=0.2,
                                                      remat=True))
    outs = []
    for cfg in (tser, tbp):
        with torch.no_grad():
            outs.append(sequential_trunk_apply(tl, cfg, t(x), t(m), x_mask=t(xm),
                                               msa_mask=t(mm),
                                               rng=torch.Generator().manual_seed(4)))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0], sequential_trunk_apply(
        tl, tser, t(x), t(m), x_mask=t(xm), msa_mask=t(mm))[0].detach())


def jmesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    return jax_make_mesh({"seq": 4}, jax.devices()[:4])


SP_CASES = [("sp_seq", "flat"), ("sp_seq", "aligned"), ("sp_msa", "flat")]


@pytest.mark.parametrize("schedule,mode", SP_CASES, ids=[f"{s}-{m}" for s, m in SP_CASES])
def test_sp_branch_parallel_matches_serial_and_jax(schedule, mode):
    """The sequence-parallel trunks over 4 CPU shards (JAX's SP schedule's
    op order, no side stream): bit for bit the serial schedule's, and
    JAX's branch_parallel SP trunk's under shard_map."""
    jm, tm = jmesh(), make_mesh({"seq": 4}, devices=["cpu"] * 4)
    _, jbp, tser, tbp, jl, tl, x, m, xm, mm = setup(dict(cross_attn_mode=mode, depth=1))
    port_fn, jax_fn = ((sp_trunk_apply, jax_sp_trunk) if schedule == "sp_seq"
                       else (msa_sharded_trunk_apply, jax_msa_sharded))
    with torch.no_grad():
        xs, ms = port_fn(tl, tser, t(x), t(m), tm, x_mask=t(xm), msa_mask=t(mm))
        xb, mb = port_fn(tl, tbp, t(x), t(m), tm, x_mask=t(xm), msa_mask=t(mm))
    assert torch.equal(xb, xs) and torch.equal(mb, ms)
    want_x, want_m = jax.jit(lambda ls, a, b: jax_fn(
        ls, jbp, a, b, jm, x_mask=xm, msa_mask=mm))(jl, x, m)
    assert_close(xb, want_x)
    assert_close(mb, want_m)


def test_eager_train_step_matches_serial():
    """Two eager train steps (accum 2, a 3-row MSA in each batch) from the
    same params: loss, grad_norm and every param leaf bit for bit the
    serial schedule's."""
    from alphafold2_tpu_torch import alphafold2_init
    from alphafold2_tpu_torch.training import harness
    from alphafold2_tpu_torch.training.data import DataConfig, synthetic_microbatch_fn

    kw = dict(dim=16, depth=2, heads=2, dim_head=8, max_seq_len=32)
    tt = harness.TrainConfig(grad_accum=2)
    fetch = synthetic_microbatch_fn(DataConfig(max_len=12, msa_rows=3, seed=3), 2)
    runs = []
    for schedule in ("serial", "branch_parallel"):
        cfg = Alphafold2Config(**kw, trunk_schedule=schedule)
        state = harness.train_state(
            alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu"), tt)
        step = harness.make_train_step(cfg, tt, device="cpu")
        metrics = [step(state, fetch(n))[1] for n in range(2)]
        runs.append((metrics, [p.detach().clone() for p in state["optimizer"].leaves]))
    (ms, ps), (mb, pb) = runs
    for a, b in zip(ms, mb):
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["grad_norm"], b["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(ps, pb))


def test_branch_parallel_config_is_its_own_cache_tag():
    """The serving cache tags configs by repr: the schedules differ."""
    a = Alphafold2Config(dim=16)
    assert repr(a) != repr(dataclasses.replace(a, trunk_schedule="branch_parallel"))

