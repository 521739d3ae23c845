"""Sequence parallelism, port vs JAX package (CPU, float32).

The port's B3 plain version (`flash_fwd_lse` / `flash_bwd_lse` on CPU
tensors) against JAX's `flash_attention_lse` in Pallas interpret mode,
forward and gradient through both outputs; `merge_lse`; and the
sequence-parallel primitives over a 4-shard CPU mesh
(`make_mesh({"sp": 4}, devices=["cpu"] * 4)`) against the JAX ones under
`shard_map` on 4 devices of the virtual CPU mesh that tests/conftest.py
provides.

Tolerances: B3 and merge_lse compute the same f32 recurrence in another
block order (~1e-7 apart): 2e-6 absolute, gradients 2e-6 times max(1, the
largest reference entry), as tests/test_torch_flash.py. Ring attention:
both sides run per-hop (out, lse) and the same log-space merges; 1e-5 on
outputs, 2e-5 times max(1, |ref|) on gradients (sums over the ring of
merged hops). The axial, tied-row and Ulysses passes hold whole attention
layers (projections included, XLA vs ATen matmuls): 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from alphafold2_tpu.compat import shard_map
from alphafold2_tpu.ops import attention as jattn
from alphafold2_tpu.ops import flash as jflash
from alphafold2_tpu.ops import flash_kernel as jfk
from alphafold2_tpu.parallel import make_mesh as jax_make_mesh
from alphafold2_tpu.parallel import sequence as jseq
from alphafold2_tpu_torch.models.convert import convert_tree
from alphafold2_tpu_torch.ops import flash_kernel
from alphafold2_tpu_torch.ops.attention import AttentionConfig
from alphafold2_tpu_torch.ops.flash import _FlashLseKernel, hop_attention_lse, merge_lse
from alphafold2_tpu_torch.parallel import (
    KNOWN_AXES,
    axial_alltoall_transpose,
    make_mesh,
    ring_attention,
    sequence_parallel_axial_attention,
    tied_row_attention_sharded,
    ulysses_attention,
)

NS = 4  # shards
NEG = float("-inf")
SPEC = P(None, "sp", None, None)


def jmesh():
    if len(jax.devices()) < NS:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    return jax_make_mesh({"sp": NS}, jax.devices()[:NS])


def tmesh():
    return make_mesh({"sp": NS}, devices=["cpu"] * NS)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def assert_grads(got, want, rel=2e-6):
    for a, b in zip(got, want):
        b = np.asarray(b)
        a = a.detach().numpy()
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(1.0, float(np.abs(b).max())))


def folded(BH, i, j, dh, seed=0, masked_bh=()):
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(BH, i, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(BH, j, dh)).astype(np.float32) for _ in range(2))
    keep = rng.random((BH, j)) < 0.8
    keep[:, 0] = True
    for b in masked_bh:
        keep[b] = False
    bias = np.where(keep, 0.0, NEG).astype(np.float32)
    g_lse = rng.normal(size=(BH, i)).astype(np.float32)
    return q, k, v, bias, g, g_lse


B3_CASES = [(3, 16, 16, 16, ()), (4, 37, 53, 16, ()), (2, 130, 7, 32, ()),
            (5, 21, 200, 16, (1, 3))]
B3_IDS = ["square", "ragged", "long-i", "masked-rows"]


@pytest.mark.parametrize("BH,i,j,dh,masked", B3_CASES, ids=B3_IDS)
def test_b3_plain_matches_pallas_through_lse(BH, i, j, dh, masked):
    """flash_fwd_lse / flash_bwd_lse on CPU tensors against jax.vjp of
    flash_attention_lse with cotangents on both outputs; a row with lse =
    +inf gets exact zero gradients whatever its g_lse."""
    q, k, v, bias, g, g_lse = folded(BH, i, j, dh, masked_bh=masked)
    scale = dh ** -0.5
    (j_out, j_lse), vjp = jax.vjp(
        lambda q, k, v: jfk.flash_attention_lse(q, k, v, bias, scale), q, k, v)
    want = vjp((g, g_lse))
    tq, tk, tv, tb = map(t, (q, k, v, bias))
    out, lse = flash_kernel.flash_fwd_lse(tq, tk, tv, tb, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=2e-6)
    j_lse = np.asarray(j_lse)
    np.testing.assert_array_equal(np.isposinf(lse.numpy()), np.isposinf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(lse.numpy()[fin], j_lse[fin], rtol=0, atol=2e-6)
    grads = flash_kernel.flash_bwd_lse(tq, tk, tv, tb, out, lse, t(g), t(g_lse), scale)
    assert_grads(grads, want)
    for gr in grads:
        assert (gr[list(masked)] == 0).all()
    # g_lse = None is a zero lse cotangent: B1's backward
    np.testing.assert_array_equal(
        flash_kernel.flash_bwd_lse(tq, tk, tv, tb, out, lse, t(g), None, scale)[0].numpy(),
        flash_kernel.flash_bwd(tq, tk, tv, tb, out, lse, t(g), scale)[0].numpy())


@pytest.mark.parametrize("BH,i,j,dh,masked", B3_CASES[1:], ids=B3_IDS[1:])
def test_b3_autograd_routes_match_pallas(BH, i, j, dh, masked):
    """The CUDA route's autograd.Function on CPU tensors (its wrappers take
    the plain route there) and the hop's plain route (autograd through the
    plain forward) both give JAX's gradients of
    sum(out * g) + sum(lse * g_lse) over the live rows, through
    hop_attention_lse's +inf -> -inf flip."""
    q, k, v, bias, g, g_lse = folded(BH, i, j, dh, seed=2, masked_bh=masked)
    scale = dh ** -0.5
    live = np.ones((BH, i), bool)
    live[list(masked)] = False

    def jloss(q, k, v):
        out, lse = jflash.hop_attention_lse(q, k, v, bias, scale)
        return jnp.sum(out * g) + jnp.sum(jnp.where(live, lse, 0.0) * g_lse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    for route in ("function", "hop"):
        leaves = [t(a).requires_grad_() for a in (q, k, v)]
        if route == "function":
            out, lse = _FlashLseKernel.apply(*leaves, t(bias), scale)
            lse = torch.where(torch.isposinf(lse), NEG, lse)
        else:
            out, lse = hop_attention_lse(*leaves, t(bias), scale)
        assert torch.isneginf(lse[~t(live)]).all()
        loss = (out * t(g)).sum() + (torch.where(t(live), lse, 0.0) * t(g_lse)).sum()
        assert_grads(torch.autograd.grad(loss, leaves), want)


def test_merge_lse_matches_jax_with_empty_rows():
    """Rows live on both sides, on one side only, and on neither ((0, -inf)
    out); gradients through both outputs finite and equal to JAX's."""
    rng = np.random.default_rng(3)
    oa, ob = (rng.normal(size=(4, 6, 8)).astype(np.float32) for _ in range(2))
    la, lb = (rng.normal(size=(4, 6)).astype(np.float32) * 3 for _ in range(2))
    la[0, :2] = NEG   # a empty
    lb[1, 1:3] = NEG  # b empty
    la[2, 4:] = NEG
    lb[2, 4:] = NEG   # both empty
    go = rng.normal(size=(4, 6, 8)).astype(np.float32)
    gl = rng.normal(size=(4, 6)).astype(np.float32)
    both = np.isneginf(la) & np.isneginf(lb)
    (j_out, j_lse), vjp = jax.vjp(jflash.merge_lse, oa, la, ob, lb)
    want = vjp((go, np.where(both, 0.0, gl).astype(np.float32)))
    leaves = [t(a).requires_grad_() for a in (oa, la, ob, lb)]
    out, lse = merge_lse(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=2e-6)
    assert (out[t(both)] == 0).all() and torch.isneginf(lse[t(both)]).all()
    np.testing.assert_array_equal(np.isneginf(lse.detach().numpy()), np.isneginf(j_lse))
    fin = np.isfinite(np.asarray(j_lse))
    np.testing.assert_allclose(lse.detach().numpy()[fin], np.asarray(j_lse)[fin], rtol=0,
                               atol=2e-6)
    loss = (out * t(go)).sum() + torch.where(t(both), 0.0, lse * t(gl)).sum()
    assert_grads(torch.autograd.grad(loss, leaves), want)


def ring_data(seed, b=1, n=32, h=2, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, n), bool)
    mask[:, 8:16] = False  # one shard's keys all masked
    mask[:, 3] = False
    return q, k, v, mask


def jax_ring(mesh, mask_on, use_kernel):
    body = (lambda q, k, v, m: jseq.ring_attention(q, k, v, "sp", mask=m,
                                                   use_kernel=use_kernel))
    in_specs = (SPEC, SPEC, SPEC, P(None, "sp"))
    if not mask_on:
        body = (lambda q, k, v: jseq.ring_attention(q, k, v, "sp", use_kernel=use_kernel))
        in_specs = in_specs[:3]
    # check_vma=False: the interpret-mode workaround of the JAX package's
    # own kernel-ring test (tests/test_sequence_parallel.py)
    return shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=SPEC, check_vma=False)


def torch_ring(mesh, q, k, v, mask):
    shard = lambda a, dim=1: mesh.shard(a, dim)  # noqa: E731
    outs = ring_attention(shard(q), shard(k), shard(v), mesh,
                          masks=None if mask is None else shard(mask))
    return mesh.unshard(outs, 1)


@pytest.mark.parametrize("masked", [True, False], ids=["masked-shard", "unmasked"])
def test_ring_attention_matches_jax_kernel_ring(masked):
    """Forward and the gradient of sum(out^2) against JAX's ring with
    use_kernel=True (B3 per hop, interpret mode), one shard's keys fully
    masked: its hops have zero mass and weigh nothing."""
    jm, tm = jmesh(), tmesh()
    q, k, v, mask = ring_data(5)
    mask = mask if masked else None
    fn = jax_ring(jm, masked, True)
    args = (q, k, v) + ((mask,) if masked else ())
    want = jax.jit(fn)(*args)
    want_g = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v, *args[3:]) ** 2),
                              argnums=(0, 1, 2)))(q, k, v)
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    got = torch_ring(tm, *leaves, t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert_grads(torch.autograd.grad((got ** 2).sum(), leaves), want_g, rel=2e-5)


def test_ring_attention_matches_jax_stream_ring_cross():
    """Cross-attention shapes (nk_local != n_local), against JAX's default
    CPU ring (its stream_block arm: another summation order)."""
    jm, tm = jmesh(), tmesh()
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 40, 2, 16)).astype(np.float32) for _ in range(2))
    mask = rng.random((2, 40)) > 0.3
    mask[1] = False  # a batch row with no valid key: zeros
    fn = jax.jit(jax_ring(jm, True, "auto"))
    want = np.asarray(fn(q, k, v, mask))
    got = torch_ring(tm, *map(t, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[1] == 0).all()


def test_ring_attention_refuses_the_double_buffered_schedule():
    tm = tmesh()
    q = tm.shard(torch.zeros(1, 8, 1, 16), 1)
    with pytest.raises(NotImplementedError, match="A13"):
        ring_attention(q, q, q, tm, overlap=True)


def test_ulysses_matches_jax():
    jm, tm = jmesh(), tmesh()
    q, k, v, mask = ring_data(9, b=2, n=16, h=4, d=16)
    fn = jax.jit(shard_map(lambda q, k, v, m: jseq.ulysses_attention(q, k, v, "sp", mask=m),
                           mesh=jm, in_specs=(SPEC, SPEC, SPEC, P(None, "sp")),
                           out_specs=SPEC))
    want = np.asarray(fn(q, k, v, mask))
    outs = ulysses_attention(*(tm.shard(t(a), 1) for a in (q, k, v)), tm,
                             masks=tm.shard(t(mask), 1))
    np.testing.assert_allclose(tm.unshard(outs, 1).numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="heads"):
        ulysses_attention(*(tm.shard(torch.zeros(1, 8, 2, 16), 1) for _ in range(3)), tm)


def attn_params(dim=32, heads=2, dim_head=16, gate=False, axial=True, seed=0):
    jcfg = jattn.AttentionConfig(dim=dim, heads=heads, dim_head=dim_head, gate=gate)
    init = jattn.axial_attention_init if axial else jattn.attention_init
    jp = init(jax.random.PRNGKey(seed), jcfg)
    tp = convert_tree(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, AttentionConfig(dim=dim, heads=heads, dim_head=dim_head, gate=gate), tp


@pytest.mark.parametrize("masked", [True, False])
def test_sequence_parallel_axial_matches_jax(masked):
    jm, tm = jmesh(), tmesh()
    jcfg, jp, tcfg, tp = attn_params()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 8, 12, 32)).astype(np.float32)
    mask = rng.random((1, 8, 12)) > 0.2 if masked else None
    mspec = (P(None, "sp", None),) if masked else ()
    fn = jax.jit(shard_map(
        lambda p, x, *m: jseq.sequence_parallel_axial_attention(p, jcfg, x, "sp",
                                                                mask=m[0] if m else None),
        mesh=jm, in_specs=(P(), SPEC) + mspec, out_specs=SPEC))
    want = np.asarray(fn(jp, x, *((mask,) if masked else ())))
    outs = sequence_parallel_axial_attention(
        tp, tcfg, tm.shard(t(x), 1), tm, masks=None if mask is None else tm.shard(t(mask), 1))
    np.testing.assert_allclose(tm.unshard(outs, 1).numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="dropout"):
        sequence_parallel_axial_attention(tp, tcfg, tm.shard(t(x), 1), tm,
                                          rng=torch.Generator())


@pytest.mark.parametrize("gate", [False, True])
def test_tied_row_attention_sharded_matches_jax(gate):
    jm, tm = jmesh(), tmesh()
    jcfg, jp, tcfg, tp = attn_params(gate=gate, axial=False, seed=1)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 10, 32)).astype(np.float32)
    mask = rng.random((2, 8, 10)) > 0.1
    fn = jax.jit(shard_map(
        lambda p, x, m: jseq.tied_row_attention_sharded(p, jcfg, x, "sp", mask=m),
        mesh=jm, in_specs=(P(), SPEC, P(None, "sp", None)), out_specs=SPEC))
    want = np.asarray(fn(jp, x, mask))
    outs = tied_row_attention_sharded(tp, tcfg, tm.shard(t(x), 1), tm,
                                      masks=tm.shard(t(mask), 1))
    np.testing.assert_allclose(tm.unshard(outs, 1).numpy(), want, rtol=0, atol=1e-5)


def test_collectives_match_jax():
    """ppermute with an unlisted destination (zeros), the tiled all_gather,
    all_to_all and psum, and the grid transpose round trip, against the
    jax.lax collectives under shard_map."""
    jm, tm = jmesh(), tmesh()
    x = np.arange(2 * 8 * 12 * 3, dtype=np.float32).reshape(2, 8, 12, 3)
    perm = [(s, s - 1) for s in range(1, NS)]  # shard NS-1 receives nothing

    def body(x):
        return (jax.lax.ppermute(x, "sp", perm),
                jax.lax.all_to_all(x, "sp", split_axis=2, concat_axis=1, tiled=True),
                jax.lax.psum(x, "sp"))

    fn = jax.jit(shard_map(body, mesh=jm, in_specs=(SPEC,),
                           out_specs=(SPEC, SPEC, P(None, None, None, None)),
                           check_vma=False))
    j_perm, j_a2a, j_sum = map(np.asarray, fn(x))
    xs = tm.shard(t(x), 1)
    got_perm = tm.ppermute(xs, perm)
    assert (got_perm[NS - 1] == 0).all()
    np.testing.assert_array_equal(tm.unshard(got_perm, 1).numpy(), j_perm)
    # all_to_all: (2, 2, 12, 3) shards -> (2, 8, 3, 3), concatenated along the columns
    np.testing.assert_array_equal(tm.unshard(tm.all_to_all(xs, 2, 1), 2).numpy(),
                                  np.concatenate(np.split(j_a2a, NS, axis=1), axis=2))
    for s in tm.psum(xs):
        np.testing.assert_array_equal(s.numpy(), j_sum)
    for g in tm.all_gather(xs, 1):
        np.testing.assert_array_equal(g.numpy(), x)
    back = axial_alltoall_transpose(axial_alltoall_transpose(xs, tm), tm, row_sharded=False)
    np.testing.assert_array_equal(tm.unshard(back, 1).numpy(), x)
    assert tm.axis_index() == list(range(NS))


def test_mesh_placement_and_refusals(monkeypatch):
    tm = make_mesh({"seq": 3}, devices=["cpu"] * 5)
    assert tm.size == 3 and tm.shape == {"seq": 3}
    params = {"w": torch.ones(2), "layers": [{"b": torch.zeros(1)}]}
    reps = tm.replicate(params)
    assert all(r["w"] is params["w"] for r in reps)  # one device: the same tensors
    with pytest.raises(ValueError, match="divide"):
        tm.shard(torch.zeros(1, 4), 1)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        make_mesh({"rows": 2}, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="one named axis"):
        make_mesh({"seq": 2, "data": 2}, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        make_mesh({"seq": 2})
    assert {"data", "model", "seq", "sp", "pipe"} == KNOWN_AXES
