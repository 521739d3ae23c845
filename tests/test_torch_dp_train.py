"""The data-parallel training steps, port vs JAX package (CPU, float32).

The port's `parallel/train.py make_sharded_train_step` over two CPU shards
(`make_mesh({"data": 2}, devices=["cpu"] * 2)`) against JAX's
`make_sharded_train_step` over {"data": 2} of tests/conftest.py's virtual
CPU mesh (tp=False), on the same weights (`params_from_jax`) and padded
batches whose rows' valid counts differ between the shards, for the
distogram loss (the structure loss: tests/test_torch_dp_e2e_train.py);
the port's DP step with dropout (FF and
attention, dense and block-sparse, remat and the reversible trunk)
against its own single-process step on the global batch; the pod's step
outside a pod; the refusals.

Tolerances, chip_smoke.py phase 6a's (the same f32 function summed in
another order): loss 1e-5 absolute, grad_norm 1e-5 relative, params after
3 steps 1e-5, except entries whose first-step gradient is at most 1e-3 of
their leaf's largest: 2 lr 3 (Adam turns a rounding-noise gradient's sign
into +-lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.parallel import make_mesh as jax_make_mesh
from alphafold2_tpu.parallel import train as jtrain
from alphafold2_tpu.training import data as jdata
from alphafold2_tpu.training import harness as jharness
from alphafold2_tpu_torch import Alphafold2Config, params_from_jax
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.ops.core import dropout, rand_rows
from alphafold2_tpu_torch.parallel import (
    make_mesh,
    make_multihost_train_step,
    make_sharded_train_step,
    sharded_train_state_init,
)
from alphafold2_tpu_torch.training import harness
from alphafold2_tpu_torch.training.data import DataConfig, synthetic_microbatch_fn
from alphafold2_tpu_torch.utils.rng import Streams, rows_of, tagged_rows

SMALL = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small tensors (the suite runs
    several workers on a few cores), restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jmesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    return jax_make_mesh({"data": 2}, jax.devices()[:2])


def tmesh():
    return make_mesh({"data": 2}, devices=["cpu"] * 2)


def jax_state(jparams, jt):
    return {"params": jparams, "opt_state": jharness.make_optimizer(jt).init(jparams),
            "step": jnp.zeros((), jnp.int32)}


def unequal_counts(batch):
    """The two shards' valid-pair counts in each microbatch differ."""
    mask = np.asarray(batch["mask"])
    half = mask.shape[1] // 2
    pairs = (mask.sum(-1) ** 2)  # (accum, b)
    return all(pairs[n, :half].sum() != pairs[n, half:].sum() for n in range(len(mask)))


def held_params(want, got, noisy, lr, tol):
    """Phase 6a's params rule: `tol`, or 2 lr 3 on rounding-level entries."""
    for w, leaf, small in zip(want, got, noisy):
        d = (leaf.detach() - w).abs()
        if (~small).any():
            assert d[~small].max().item() <= tol
        assert d.max().item() <= 2 * lr * 3


def test_dp_distogram_step_matches_jax():
    """3 steps of 2 microbatches of 4 rows (2 a shard) at L = 16 with 4
    tied MSA rows, padded rows of unequal valid counts: loss, grad_norm and
    the params after 3 steps against JAX's sharded step, which computes the
    global batch's masked mean."""
    kw, rows = dict(msa_tie_row_attn=True), 4
    jcfg, tcfg = JaxConfig(**SMALL, **kw), Alphafold2Config(**SMALL, **kw)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    jt, tt = jharness.TrainConfig(grad_accum=2), harness.TrainConfig(grad_accum=2)
    fetch = jdata.synthetic_microbatch_fn(
        jdata.DataConfig(batch_size=4, max_len=16, msa_rows=rows, seed=3), 2)
    assert all(unequal_counts(fetch(n)) for n in range(3))
    jstep, _ = jtrain.make_sharded_train_step(jcfg, jt, jmesh(), fetch(0), tp=False,
                                              donate_state=False)
    tstep, placed = make_sharded_train_step(tcfg, tt, tmesh(), fetch(0), tp=False)
    assert placed.spec == () and placed.mesh.shape == {"data": 2}  # every leaf replicated
    jstate, tstate = jax_state(jparams, jt), harness.train_state(tparams, tt)
    noisy = []
    for n in range(3):
        batch = fetch(n)
        jstate, jmet = jstep(jstate, batch, None)
        tstate, tmet = tstep(tstate, batch)
        assert abs(float(jmet["loss"]) - float(tmet["loss"])) <= 1e-5
        assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-5)
        if n == 0:
            noisy = [leaf.grad.abs() <= 1e-3 * leaf.grad.abs().max()
                     for leaf in tstate["optimizer"].leaves]
    assert tstate["step"] == 3
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]), tcfg,
                           device="cpu")
    held_params(tree_leaves(want), tstate["optimizer"].leaves, noisy, tt.learning_rate, 1e-5)


DROPOUT = {
    "ff_attn": dict(ff_dropout=0.1, attn_dropout=0.1),
    "remat": dict(ff_dropout=0.1, attn_dropout=0.1, remat=True),
    "reversible": dict(ff_dropout=0.1, reversible=True),
    "sparse": dict(attn_dropout=0.1, sparse_self_attn=True, sparse_block_size=4,
                   sparse_num_local_blocks=2),
}


@pytest.mark.parametrize("case", list(DROPOUT))
def test_dp_step_with_dropout_is_the_global_step(case):
    """With live dropout, 2 CPU shards against the port's single-process
    step on the global batch from the same rngs, 3 steps: each shard draws
    its rows of the global masks (in the forward and in the backward's
    recomputes; the sparse kernels' Philox bits at the shard's bh offset),
    so loss, grad_norm and params agree at phase 6a's tolerances; without
    the rng (dropout off) the loss moves, so the masks were live."""
    cfg = Alphafold2Config(**SMALL, **DROPOUT[case])
    tt = harness.TrainConfig(grad_accum=2, learning_rate=1e-3)
    fetch = synthetic_microbatch_fn(DataConfig(batch_size=2, max_len=8, msa_rows=2, seed=5), 2)
    dense = harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cpu")
    dp, _ = sharded_train_state_init(torch.Generator().manual_seed(0), cfg, tt, tmesh())
    dense_step = harness.make_train_step(cfg, tt, device="cpu")
    dp_step, _ = make_sharded_train_step(cfg, tt, tmesh(), fetch(0))
    noisy = []
    for n in range(3):
        dense, want = dense_step(dense, fetch(n), torch.Generator().manual_seed(40 + n))
        dp, got = dp_step(dp, fetch(n), torch.Generator().manual_seed(40 + n))
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5
        assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=1e-5)
        if n == 0:
            noisy = [leaf.grad.abs() <= 1e-3 * leaf.grad.abs().max()
                     for leaf in dense["optimizer"].leaves]
            _, off = dense_step(harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0),
                                                         "cpu"), fetch(0))
            assert float(off["loss"]) != float(want["loss"])
    held_params(dense["optimizer"].leaves, dp["optimizer"].leaves, noisy, tt.learning_rate,
                1e-5)


def test_multihost_step_outside_a_pod_is_the_dense_step():
    """make_multihost_train_step in one process (no group): the dense step
    on the global batch, bit for bit, dropout included; `assemble` gives
    this process's rows with their place in the global batch."""
    cfg = Alphafold2Config(**SMALL, ff_dropout=0.1)
    tt = harness.TrainConfig(grad_accum=2)
    fetch = synthetic_microbatch_fn(DataConfig(batch_size=2, max_len=12, seed=1), 2)
    step, placed, assemble, mesh = make_multihost_train_step(cfg, tt, fetch(0), tp=False,
                                                             device="cpu")
    assert mesh.shape == {"data": 1} and mesh.devices == (torch.device("cpu"),)
    rows = assemble(fetch(0))
    assert (rows.start, rows.total) == (0, 2) and torch.equal(rows["seq"],
                                                              torch.as_tensor(fetch(0)["seq"]))
    a = harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cpu")
    b = harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cpu")
    dense = harness.make_train_step(cfg, tt, device="cpu")
    for n in range(2):
        a, ma = dense(a, fetch(n), torch.Generator().manual_seed(n))
        b, mb = step(b, assemble(fetch(n)), torch.Generator().manual_seed(n))
        assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"],
                                                                   mb["grad_norm"])
    assert all(torch.equal(x, y) for x, y in zip(a["optimizer"].state_tensors(),
                                                 b["optimizer"].state_tensors()))
    assert step.reduce_ms() is None  # CUDA events time the reduction on a card only


def test_refusals():
    """A loss without (numerator, denominator) terms, a batch that does not
    divide over the shards, a mesh other than "data", a chunked
    feed-forward with live dropout in a shard, and shard rows outside the
    batch are refused."""
    for rows in ((1, 2, 2), (-1, 1, 2), (0, 0, 2)):
        with pytest.raises(ValueError, match="outside a batch"):
            with tagged_rows(torch.Generator(), rows):
                pass
        with pytest.raises(ValueError, match="outside a batch"):
            Streams("cpu", rows=rows)
    cfg = Alphafold2Config(**SMALL)
    tt = harness.TrainConfig(grad_accum=1)
    batch = synthetic_microbatch_fn(DataConfig(batch_size=2, max_len=8), 1)(0)
    with pytest.raises(ValueError, match="totals the loss"):
        make_sharded_train_step(cfg, tt, tmesh(), batch, loss_fn=lambda *a: None)
    odd = synthetic_microbatch_fn(DataConfig(batch_size=3, max_len=8), 1)(0)
    with pytest.raises(ValueError, match="does not divide"):
        make_sharded_train_step(cfg, tt, tmesh(), odd)
    with pytest.raises(ValueError, match="'data' mesh"):
        make_sharded_train_step(cfg, tt, make_mesh({"seq": 2}, devices=["cpu"] * 2), batch)
    for build in (lambda: make_sharded_train_step(cfg, tt, tmesh(), batch, tp=True),
                  lambda: make_multihost_train_step(cfg, tt, batch, tp=True, device="cpu"),
                  lambda: sharded_train_state_init(torch.Generator(), cfg, tt, tmesh(), tp=True)):
        with pytest.raises(NotImplementedError, match="A13-tp"):
            build()
    chunked = Alphafold2Config(**SMALL, ff_dropout=0.1, ff_chunk_size=4)
    step, _ = make_sharded_train_step(chunked, tt, tmesh(), batch)
    state = harness.train_state_init(chunked, tt, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="chunked feed-forward"):
        step(state, batch, torch.Generator().manual_seed(0))


def test_shard_rows_ride_with_the_generator():
    """A shard's rows go with the generator tagged with them, onto any
    thread, and nowhere else: while a tagged generator draws on one thread,
    an untagged one on another draws the plain mask, and a tagged one on a
    second thread draws its rows of the whole batch's draw. A tag ends with
    its block or its Streams, and takes no weak reference to a generator
    (a CUDA generator takes none in some torch releases)."""
    import gc
    import threading
    import weakref

    x = torch.ones(4, 6)
    whole = torch.rand((4, 6), generator=torch.Generator().manual_seed(7))
    plain = torch.rand((2, 6), generator=torch.Generator().manual_seed(7))
    got, go, done = {}, threading.Event(), threading.Event()

    def other():
        go.wait()
        got["plain"] = rand_rows((2, 6), torch.Generator().manual_seed(7), "cpu")
        with tagged_rows(torch.Generator().manual_seed(7), (2, 2, 4)) as gen:
            got["rows"] = rand_rows((2, 6), gen, "cpu")
        done.set()

    worker = threading.Thread(target=other)
    worker.start()
    live = torch.Generator().manual_seed(7)
    with tagged_rows(live, (0, 2, 4)):
        assert weakref.getweakrefcount(live) == 0
        go.set()
        mask = dropout(x[:2], 0.5, live)  # a shard's draw beside the other thread's
        done.wait(30)
    worker.join(30)
    assert torch.equal(got["plain"], plain) and torch.equal(got["rows"], whole[2:4])
    assert torch.equal(mask, torch.where(whole[:2] >= 0.5, 2.0, 0.0))
    assert rows_of(live) is None  # untagged with its block: the plain draw
    assert torch.equal(rand_rows((2, 6), live.manual_seed(7), "cpu"), plain)
    streams = Streams("cpu", seed=3, rows=(1, 1, 2))
    gen = streams.key().generator()
    assert rows_of(gen) == (1, 1, 2) and weakref.getweakrefcount(gen) == 0
    del streams
    gc.collect()
    assert rows_of(gen) is None  # the tag went with its streams
    assert rows_of(Streams("cpu", seed=3).key().generator()) is None
