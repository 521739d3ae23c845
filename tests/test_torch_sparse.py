"""The port's block-sparse self-attention against the JAX package on the
CPU: the layout and index table, the gather version (forward and vjp)
against JAX's XLA gather and its Pallas kernel in interpret mode, the
kernels' plain versions (out, lse, dq, dk, dv), `sparse_attention_apply`
with padding, the model with `sparse_self_attn=(True, False)`, and a
sparse train step.

Tolerances: layouts are bit-equal. Attention outputs: 2e-6 in f32 (the
same f32 function summed in another order; values ~1) and 2e-2 in bf16
(the JAX test's bf16 bound); gradients 2e-6 * max(1, |ref|) in f32; lse
2e-6. Model logits 5e-6 on valid pairs in f32 (tests/test_torch_model.py)
and 4 bf16 ulps of the largest logit in bf16 (tests/test_torch_train.py).
Train step: loss 1e-5, grad_norm 1e-5 relative, gradients 1e-5 *
max(1, the leaf's largest), params 1e-5 (tests/test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_apply as jax_apply
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.ops import sparse as jsparse
from alphafold2_tpu.ops.attention import AttentionConfig as JaxAttentionConfig
from alphafold2_tpu.ops.attention import attention_init as jax_attention_init
from alphafold2_tpu.ops.sparse_kernel import _backward_pallas as jax_kernel_backward
from alphafold2_tpu.ops.sparse_kernel import _forward as jax_kernel_forward
from alphafold2_tpu.ops.sparse_kernel import block_sparse_attention_tpu
from alphafold2_tpu.training import data as jdata
from alphafold2_tpu.training import harness as jharness
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_apply, params_from_jax
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.models.convert import convert_tree
from alphafold2_tpu_torch.models.trunk import make_sparse_axial_fn
from alphafold2_tpu_torch.ops import sparse, sparse_kernel
from alphafold2_tpu_torch.ops.attention import AttentionConfig, attention_init
from alphafold2_tpu_torch.training import harness

SCFG = dict(block_size=4, num_local_blocks=2, num_global_blocks=1, num_random_blocks=2,
            max_seq_len=64)


def _cfgs(**kw):
    cfg = {**SCFG, **kw}
    return jsparse.SparseConfig(**cfg), sparse.SparseConfig(**cfg)


def _qkv(b=2, n=16, h=2, dh=8, seed=5, masked_row=True):
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(b, n, h, dh).astype(np.float32) for _ in range(4))
    mask = rs.rand(b, n) > 0.2
    if masked_row:
        mask[0] = False  # batch element 0: every key masked
    return q, k, v, g, mask


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


# --- the layout -------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(block_size=16, num_random_blocks=None,
                                             max_seq_len=2048, num_local_blocks=4),
                                dict(num_global_blocks=3, layout_seed=7),
                                dict(block_size=16, num_random_blocks=None, max_seq_len=384,
                                     num_local_blocks=4)],
                         ids=["small", "default", "3-global-seed7", "served-384"])
@pytest.mark.parametrize("B", [1, 5, 8, 24, 64])
def test_layout_and_index_table_bit_equal_to_jax(kw, B):
    jcfg, tcfg = _cfgs(**kw)
    np.testing.assert_array_equal(sparse.sparsity_layout(B, tcfg), jsparse.sparsity_layout(B, jcfg))
    ji, jv = jsparse.layout_block_indices(B, jcfg)
    ti, tv = sparse.layout_block_indices(B, tcfg)
    assert ti.dtype == ji.dtype and tv.dtype == jv.dtype
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    table = sparse.kernel_table(B, tcfg, "cpu")
    assert table.nnz == int(jsparse.sparsity_layout(B, jcfg).sum())
    np.testing.assert_array_equal(table.counts.numpy(), jv.sum(axis=1))
    assert sparse.active_fraction(B * tcfg.block_size, tcfg) == pytest.approx(
        jsparse.sparsity_layout(B, jcfg).mean())


def test_kernel_table_refuses_an_asymmetric_layout():
    idx = np.array([[0, 1], [1, 0]], np.int32)
    valid = np.array([[True, True], [True, False]])
    with pytest.raises(ValueError, match="symmetric"):
        sparse_kernel.block_table(idx, valid, 4, "cpu")


# --- the gather version -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_attention_and_vjp_match_jax(dtype):
    """Against JAX's XLA gather (forward, vjp) and its Pallas kernel in
    interpret mode (forward, vjp); in f32 with a fully masked batch element
    (JAX's bf16 gather fills masked logits with -inf there and its
    gradient is NaN; the port fills with the f32 minimum)."""
    jcfg, tcfg = _cfgs()
    masked = dtype == "f32"
    q, k, v, g, mask = _qkv(masked_row=masked)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    tq, tk, tv = (_t(x, tdt).requires_grad_() for x in (jq, jk, jv))
    out = sparse.block_sparse_attention(tq, tk, tv, tcfg, mask=torch.from_numpy(mask))
    assert out.dtype == tdt
    out.backward(_t(jg, tdt))
    got = [out.detach()] + [t.grad for t in (tq, tk, tv)]
    if masked:
        assert all((t[0] == 0).all() for t in got)
    for fn in (lambda *a: jsparse.block_sparse_attention(*a, jcfg, mask=mask),
               lambda *a: block_sparse_attention_tpu(*a, jcfg, jnp.asarray(mask))):
        ref, vjp = jax.vjp(fn, jq, jk, jv)
        want = [ref] + list(vjp(jg))
        for n_out, (a, b) in enumerate(zip(got, want)):
            b = np.asarray(b, np.float32)
            if dtype == "f32":
                tol = 2e-6 * max(1.0, np.abs(b).max())
            else:  # the JAX package's own bf16 bounds (tests/test_sparse.py)
                tol = 2e-2 if n_out == 0 else 1e-1
            np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=tol)


def test_kernel_plain_versions_match_jax_kernel():
    """The folded plain versions of B5f (out and lse, +inf on empty rows)
    and of B5 dq / dkv against the Pallas kernels in interpret mode."""
    jcfg, tcfg = _cfgs()
    q, k, v, g, mask = _qkv()
    b, n, h, dh = q.shape
    _, (j_out, j_lse) = jax_kernel_forward(*(jnp.asarray(x) for x in (q, k, v)), jcfg,
                                           jnp.asarray(mask))
    _, vjp = jax.vjp(lambda *a: block_sparse_attention_tpu(*a, jcfg, jnp.asarray(mask)),
                     *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))

    def fold(x):
        return _t(x).transpose(1, 2).reshape(b * h, n, dh).contiguous()

    bias = torch.where(torch.from_numpy(mask), 0.0, float("-inf")).float()
    table = sparse.kernel_table(n // tcfg.block_size, tcfg, "cpu")
    out, lse = sparse_kernel.sparse_fwd_plain(fold(q), fold(k), fold(v), bias, table, h,
                                              dh ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=2e-6)
    j_lse = np.asarray(j_lse).reshape(b * h, n)
    np.testing.assert_array_equal(np.isposinf(lse.numpy()), np.isposinf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(lse.numpy()[fin], j_lse[fin], rtol=0, atol=2e-6)
    grads = sparse_kernel.sparse_bwd_plain(fold(q), fold(k), fold(v), bias, table, h, out, lse,
                                           fold(g), dh ** -0.5)
    for got, want in zip(grads, jgrads):
        want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b * h, n, dh)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-6 * max(1.0, np.abs(want).max()))


def test_kernel_plain_versions_tile_over_heads(monkeypatch):
    """The plain versions' BH tiling changes nothing."""
    _, tcfg = _cfgs()
    q, k, v, g, mask = _qkv(b=3, seed=2)
    fold = lambda x: _t(x).transpose(1, 2).reshape(6, 16, 8).contiguous()  # noqa: E731
    bias = torch.where(torch.from_numpy(mask), 0.0, float("-inf")).float()
    table = sparse.kernel_table(4, tcfg, "cpu")
    args = (fold(q), fold(k), fold(v), bias, table, 2, 0.3)
    whole = sparse_kernel.sparse_fwd_plain(*args)
    monkeypatch.setattr(sparse_kernel, "PLAIN_TILE_ELEMS", 1)
    tiled = sparse_kernel.sparse_fwd_plain(*args)
    for a, b in zip(whole, tiled):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    dw = sparse_kernel.sparse_bwd_plain(*args[:6], *whole, fold(g), 0.3)
    monkeypatch.undo()
    dt = sparse_kernel.sparse_bwd_plain(*args[:6], *whole, fold(g), 0.3)
    for a, b in zip(dw, dt):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_plain_backward_split_is_autograd_of_the_plain_forward():
    """The dq / dkv split (`sparse_bwd_plain`, what the backward kernels
    compute) equals autograd through the one gather forward
    (`sparse_fwd_plain`, what the CPU model differentiates), a fully masked
    batch element included: f32, 2e-6 * max(1, |ref|)."""
    _, tcfg = _cfgs()
    q, k, v, g, mask = _qkv(b=2, seed=4)
    fold = lambda x: _t(x).transpose(1, 2).reshape(4, 16, 8).contiguous()  # noqa: E731
    bias = torch.where(torch.from_numpy(mask), 0.0, float("-inf")).float()
    table = sparse.kernel_table(4, tcfg, "cpu")
    tq, tk, tv = (fold(x).requires_grad_() for x in (q, k, v))
    out, lse = sparse_kernel.sparse_fwd_plain(tq, tk, tv, bias, table, 2, 0.3)
    out.backward(fold(g))
    split = sparse_kernel.sparse_bwd_plain(tq.detach(), tk.detach(), tv.detach(), bias, table, 2,
                                           out.detach(), lse, fold(g), 0.3)
    for want, got in zip((tq.grad, tk.grad, tv.grad), split):
        assert torch.isfinite(want).all() and (want[:2] == 0).all()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2e-6 * max(1.0, want.abs().max().item()))


def _listed_dq(q, k, v, bias, heads, lse, g, delta, scale, offsets, entries):
    """B5 dq as its wgmma route walks it (f32): each 128-row query tile
    over its listed 128-key stages, dense tiles with the pairs its
    warpgroups' masks leave out at -inf (bit 8 qb + kb of warpgroup
    (row % 128) // 64's mask)."""
    BH, n, dh = q.shape
    dq = torch.zeros_like(q)
    key_bias = bias[torch.arange(BH) // heads]
    for qt in range(len(offsets) - 1):
        rows = torch.arange(qt * 128, min(qt * 128 + 128, n))
        acc = torch.zeros(BH, len(rows), dh)
        for st, *masks in entries[offsets[qt]:offsets[qt + 1]].tolist():
            cols = torch.arange(st * 128, min(st * 128 + 128, n))
            r, c = rows[:, None] % 128, cols[None, :] % 128
            word = torch.tensor(masks, dtype=torch.int64)[r // 64] & 0xffffffff
            live = (word >> (8 * (r % 64 // 16) + c // 16)) & 1 == 1
            s_ = scale * q[:, rows] @ k[:, cols].transpose(1, 2) + torch.where(
                live, key_bias[:, None, cols], float("-inf"))
            p = torch.exp(s_ - lse[:, rows, None])
            ds = p * (g[:, rows] @ v[:, cols].transpose(1, 2) - delta[:, rows, None])
            acc += ds @ k[:, cols]
        dq[:, rows] = scale * acc
    return dq


def _listed_dkv(q, k, v, bias, heads, lse, g, delta, scale, offsets, entries):
    """B5 dkv as its wgmma route walks it (f32): each 128-key tile over its
    listed 64-query stages (`key_unions`), dense transposed tiles with the
    pairs its warpgroups' masks leave out at -inf (bit 4 kb + qb of
    warpgroup (key % 128) // 64's mask)."""
    BH, n, dh = q.shape
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    key_bias = bias[torch.arange(BH) // heads]
    for kt in range(len(offsets) - 1):
        keys = torch.arange(kt * 128, min(kt * 128 + 128, n))
        for st, *masks in entries[offsets[kt]:offsets[kt + 1]].tolist():
            qs = torch.arange(st * 64, min(st * 64 + 64, n))
            r, c = keys[:, None] % 128, qs[None, :] % 64
            word = torch.tensor(masks, dtype=torch.int64)[r // 64] & 0xffffffff
            live = (word >> (4 * (r % 64 // 16) + c // 16)) & 1 == 1
            st_ = scale * k[:, keys] @ q[:, qs].transpose(1, 2) + torch.where(
                live, key_bias[:, keys, None], float("-inf"))
            pt = torch.exp(st_ - lse[:, None, qs])
            dst = pt * (v[:, keys] @ g[:, qs].transpose(1, 2) - delta[:, None, qs])
            dv[:, keys] += pt @ g[:, qs]
            dk[:, keys] += dst @ q[:, qs]
    return dk * scale, dv


def test_listed_backward_walk_matches_plain_and_jax_kernel():
    """The wgmma routes' walk of the backward (each tile over its listed
    stages, the unattended pairs masked: `_listed_dq`, `_listed_dkv`)
    computes what `sparse_bwd_dq_plain` / `sparse_bwd_dkv_plain` and JAX's
    `_backward_pallas` (interpret mode) compute, at block size 16 with a
    ragged last tile and stage (13 blocks) and a fully masked batch element:
    f32, 2e-6 * max(1, |ref|) (test_kernel_plain_versions_match_jax_kernel's
    tolerance)."""
    jcfg, tcfg = _cfgs(block_size=16, max_seq_len=256)
    q, k, v, g, mask = _qkv(b=2, n=208, h=2, dh=8, seed=7)
    b, n, h, dh = q.shape
    scale = dh ** -0.5
    j_out, j_lse = jax_kernel_forward(*(jnp.asarray(x) for x in (q, k, v)), jcfg,
                                      jnp.asarray(mask))[1]
    jgrads = jax_kernel_backward(*(jnp.asarray(x) for x in (q, k, v)), jcfg, jnp.asarray(mask),
                                 j_out, j_lse, jnp.asarray(g))

    def fold(x):
        return _t(x).transpose(1, 2).reshape(b * h, n, dh).contiguous()

    bias = torch.where(torch.from_numpy(mask), 0.0, float("-inf")).float()
    table = sparse.kernel_table(n // 16, tcfg, "cpu")
    assert table.unions and table.key_unions
    out, lse = sparse_kernel.sparse_fwd_plain(fold(q), fold(k), fold(v), bias, table, h, scale)
    delta = (fold(g) * out).sum(-1)
    args = (fold(q), fold(k), fold(v), bias, h, lse, fold(g), delta, scale)
    walked = (_listed_dq(*args, *table.unions[:2]),) + _listed_dkv(*args, *table.key_unions)
    plain_args = (fold(q), fold(k), fold(v), bias, table, h, lse, fold(g), delta, scale)
    plain = (sparse_kernel.sparse_bwd_dq_plain(*plain_args),) + \
        sparse_kernel.sparse_bwd_dkv_plain(*plain_args)
    for got, want_plain, want_jax in zip(walked, plain, jgrads):
        assert (got[:h] == 0).all()  # batch element 0: every key masked
        torch.testing.assert_close(got, want_plain, rtol=0,
                                   atol=2e-6 * max(1.0, want_plain.abs().max().item()))
        want = np.asarray(want_jax).transpose(0, 2, 1, 3).reshape(b * h, n, dh)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-6 * max(1.0, np.abs(want).max()))


def test_kernel_wrappers_refuse_cpu_tensors():
    """`sparse_fwd` / `sparse_bwd` launch the CUDA kernels only; CPU
    tensors go to the plain versions by name."""
    _, tcfg = _cfgs()
    q, k, v, g, mask = _qkv(b=1, masked_row=False)
    fold = lambda x: _t(x).transpose(1, 2).reshape(2, 16, 8).contiguous()  # noqa: E731
    bias = torch.zeros((1, 16))
    table = sparse.kernel_table(4, tcfg, "cpu")
    args = (fold(q), fold(k), fold(v), bias, table, 2)
    with pytest.raises(ValueError, match="take CUDA tensors"):
        sparse_kernel.sparse_fwd(*args, 0.3)
    out, lse = sparse_kernel.sparse_fwd_plain(*args, 0.3)
    with pytest.raises(ValueError, match="take CUDA tensors"):
        sparse_kernel.sparse_bwd(*args, out, lse, fold(g), 0.3)


# --- sparse_attention_apply -----------------------------------------------------------


@pytest.mark.parametrize("n,with_mask", [(14, True), (14, False), (16, True)],
                         ids=["pad-mask", "pad-nomask", "nopad"])
def test_sparse_attention_apply_matches_jax(n, with_mask):
    jcfg, tcfg = _cfgs()
    jattn = JaxAttentionConfig(dim=16, heads=2, dim_head=8)
    jparams = jax_attention_init(jax.random.PRNGKey(3), jattn)
    tparams = convert_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tattn = AttentionConfig(dim=16, heads=2, dim_head=8)
    rs = np.random.RandomState(1)
    x = rs.randn(2, n, 16).astype(np.float32)
    mask = (rs.rand(2, n) > 0.3) if with_mask else None
    want = jsparse.sparse_attention_apply(jparams, jattn, jcfg, x, mask=mask)
    got = sparse.sparse_attention_apply(tparams, tattn, tcfg, _t(x),
                                        mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, n, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def test_sparse_axial_fn_refuses_tied_rows_and_context():
    cfg = Alphafold2Config(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=32,
                           sparse_self_attn=True, sparse_block_size=4)
    fn = make_sparse_axial_fn(cfg)
    params = attention_init(torch.Generator().manual_seed(0), cfg.self_attn_config(), "cpu")
    x = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="tied-row"):
        fn(params, x, axis="height", mask=None, tie_dim=3, rng=None)
    with pytest.raises(ValueError, match="self-attention only"):
        fn(params, x, axis="width", mask=None, tie_dim=None, rng=None, context=x)
    assert fn(params, x, axis="width", mask=None, tie_dim=None, rng=None).shape == (1, 8, 16)


# --- the model and the train step ------------------------------------------------------


MODEL = dict(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=32,
             sparse_self_attn=(True, False), sparse_block_size=4, sparse_num_random_blocks=1,
             sparse_num_local_blocks=2)


def _inputs(L=14, rows=3, pad=3):
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 20, (1, L)).astype(np.int32)
    mask = np.ones((1, L), bool)
    mask[:, L - pad:] = False
    msa = rng.integers(0, 21, (1, rows, L)).astype(np.int32)
    msa_mask = rng.random((1, rows, L)) > 0.2
    msa_mask[:, 0] = mask
    return seq, mask, msa, msa_mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kw", [dict(), dict(msa_tie_row_attn=True, attn_flash=True)],
                         ids=["dense", "tied-flash"])
def test_sparse_model_matches_jax(dtype, kw):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg = JaxConfig(**MODEL, **kw, dtype=jdt)
    tcfg = Alphafold2Config(**MODEL, **kw, dtype=tdt)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    seq, mask, msa, msa_mask = _inputs()
    jl = np.asarray(jax_apply(jparams, jcfg, seq, msa, mask=mask, msa_mask=msa_mask), np.float32)
    tl = alphafold2_apply(tparams, tcfg, seq, msa, mask=mask, msa_mask=msa_mask, device="cpu")
    assert tl.dtype == tdt
    tl = tl.float().numpy()
    assert np.isfinite(tl).all()
    pair = mask[:, :, None] & mask[:, None, :]
    bound = 5e-6 if dtype == "f32" else 4 * 2.0 ** -7 * np.abs(jl[pair]).max()
    assert np.abs(tl - jl)[pair].max() <= bound
    if dtype == "f32":
        # the sparse layer differs from its dense twin (7/8 of the blocks
        # are active here)
        dense = alphafold2_apply(tparams, Alphafold2Config(**{**MODEL, "sparse_self_attn": False},
                                                           **kw),
                                 seq, msa, mask=mask, msa_mask=msa_mask, device="cpu")
        assert np.abs(dense.numpy() - tl)[pair].max() > 100 * bound


def test_sparse_train_step_matches_jax():
    kw = dict(MODEL, depth=1, sparse_self_attn=True, max_seq_len=64)
    jcfg, tcfg = JaxConfig(**kw), Alphafold2Config(**kw)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    jt, tt = jharness.TrainConfig(grad_accum=2), harness.TrainConfig(grad_accum=2)
    fetch = jdata.synthetic_microbatch_fn(jdata.DataConfig(max_len=22, seed=3), 2)
    jstate = {"params": jparams, "opt_state": jharness.make_optimizer(jt).init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = harness.train_state(tparams, tt)
    jstep = jax.jit(jharness.make_train_step(jcfg, jt))
    tstep = harness.make_train_step(tcfg, tt, device="cpu")
    b0 = fetch(0)

    def mean_loss(p):
        return sum(jharness.distogram_loss_fn(p, jcfg, {k: v[n] for k, v in b0.items()}, None)
                   for n in range(2)) / 2

    jgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(mean_loss)(jparams)),
                             tcfg, device="cpu")
    for n in range(2):
        batch = fetch(n)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-5
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        if n == 0:
            for want, leaf in zip(tree_leaves(jgrads), tstate["optimizer"].leaves):
                atol = 1e-5 * max(1.0, want.abs().max().item())
                torch.testing.assert_close(leaf.grad, want, rtol=0, atol=atol)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]), tcfg,
                           device="cpu")
    for w, leaf in zip(tree_leaves(want), tstate["optimizer"].leaves):
        torch.testing.assert_close(leaf.detach(), w, rtol=0, atol=1e-5)


def test_dropout_takes_the_gather_version(monkeypatch):
    """Live attention dropout on the CPU runs the gather version with the
    rate, drawing its mask from the caller's generator: the same seed gives
    the same output, another seed another one, and no generator (eval
    mode) the output without dropout."""
    calls = []
    real = sparse.block_sparse_attention

    def spy(*args, **kwargs):
        calls.append(kwargs["dropout_rate"])
        return real(*args, **kwargs)

    monkeypatch.setattr(sparse, "block_sparse_attention", spy)
    _, tcfg = _cfgs()
    attn = AttentionConfig(dim=16, heads=2, dim_head=8, dropout=0.25)
    params = attention_init(torch.Generator().manual_seed(0), attn, "cpu")
    x = torch.randn(1, 16, 16)
    a = sparse.sparse_attention_apply(params, attn, tcfg, x, rng=torch.Generator().manual_seed(1))
    b = sparse.sparse_attention_apply(params, attn, tcfg, x, rng=torch.Generator().manual_seed(1))
    c = sparse.sparse_attention_apply(params, attn, tcfg, x, rng=torch.Generator().manual_seed(2))
    d = sparse.sparse_attention_apply(params, attn, tcfg, x)
    assert calls == [0.25] * 4
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    eval_cfg = AttentionConfig(dim=16, heads=2, dim_head=8)
    torch.testing.assert_close(d, sparse.sparse_attention_apply(params, eval_cfg, tcfg, x),
                               rtol=0, atol=0)


# --- the forward's routes and the wgmma route's stage lists ------------------------


def _shaped(BH, n, dh, dtype=torch.bfloat16):
    """A folded q of any size without the memory: a stride-0 view (route
    reads the dtype and the shape only)."""
    return torch.zeros(1, dtype=dtype).expand(BH, n, dh)


# B5f's calls on the main paths, (BH, n, max_seq_len): the sparse request's
# pair passes at L = 128, 256, 384 (heads 8, max_seq_len 384), the sparse
# train step's at crop 256 (max_seq_len 256), and the long cases
B5F_SHAPES = {
    "served L=128": (1024, 128, 384),
    "served L=256": (2048, 256, 384),
    "served L=384": (3072, 384, 384),
    "trained crop 256": (2048, 256, 256),
    "long n=4096": (8, 4096, 2048),
    "long n=8192": (4, 8192, 2048),
}


@pytest.mark.parametrize("case", list(B5F_SHAPES))
def test_route_takes_wgmma_on_every_served_and_trained_shape(case):
    BH, n, msl = B5F_SHAPES[case]
    table = sparse.kernel_table(n // 16, sparse.SparseConfig(block_size=16, max_seq_len=msl),
                                "cpu")
    assert sparse_kernel.unsupported(BH, n, 64, torch.bfloat16, 16) is None
    assert sparse_kernel.route(_shaped(BH, n, 64), table) == "wgmma"
    # the stage lists at 128- and 192-row tiles: one offset a tile, and one more
    offsets128, _, offsets192, _ = table.unions
    assert len(offsets128) == -(-n // 128) + 1 and len(offsets192) == -(-n // 192) + 1
    assert sparse_kernel.route(_shaped(BH, n, 64, torch.float32), table) == "f32"


@pytest.mark.parametrize("n,msl,rows", [(384, 384, 128), (384, 384, 192), (208, 256, 128),
                                        (4096, 2048, 192), (64, 64, 128)])
def test_union_list_encodes_the_layout(n, msl, rows):
    """The wgmma route's stage lists hold every active (query block, key
    block) pair exactly once as a mask bit, and nothing past n; every tile
    lists a stage."""
    B = n // 16
    layout = sparse.sparsity_layout(B, sparse.SparseConfig(block_size=16, max_seq_len=msl))
    offsets, entries = sparse_kernel.union_list(layout, rows)
    tb = rows // 16
    assert len(offsets) == -(-B // tb) + 1 and (np.diff(offsets) >= 1).all()
    got = np.zeros((len(offsets) * tb, -(-B // 8) * 8), bool)
    for qt in range(len(offsets) - 1):
        stages = entries[offsets[qt]:offsets[qt + 1], 0]
        assert (np.diff(stages) > 0).all()  # in key order, each once
        for st, *masks in entries[offsets[qt]:offsets[qt + 1]]:
            for wg, mask in enumerate(masks):
                for bit in range(32):
                    if (int(mask) & 0xffffffff) >> bit & 1:
                        got[qt * tb + 4 * wg + bit // 8, 8 * st + bit % 8] = True
    np.testing.assert_array_equal(got[:B, :B], layout)
    assert not got[B:].any() and not got[:, B:].any()


# the dkv route's layouts, (n, max_seq_len): served, crop 256, n = 4096, ragged (25 blocks)
DKV_LAYOUTS = {"served L=384": (384, 384), "trained crop 256": (256, 256),
               "long n=4096": (4096, 2048), "ragged n=400": (400, 512)}


@pytest.mark.parametrize("case", list(DKV_LAYOUTS))
def test_union_list_encodes_the_layout_at_the_dkv_tiling(case):
    """The dkv route's stage lists (128-key tiles of the transposed layout,
    64-query stages, a 16-bit mask a warpgroup) hold every active (query
    block, key block) pair exactly once as a mask bit and no other pair;
    every key tile lists a stage, in query order."""
    n, msl = DKV_LAYOUTS[case]
    B = n // 16
    layout = sparse.sparsity_layout(B, sparse.SparseConfig(block_size=16, max_seq_len=msl))
    offsets, entries = sparse_kernel.union_list(layout.T, sparse_kernel.KEY_TILE,
                                                sparse_kernel.QUERY_STAGE)
    assert len(offsets) == -(-B // 8) + 1 and (np.diff(offsets) >= 1).all()
    assert (entries[:, 3] == 0).all() and ((entries[:, 1:3].astype(np.int64) >> 16) == 0).all()
    hits = np.zeros((len(offsets) * 8, -(-B // 4) * 4), np.int64)  # (key block, query block)
    for kt in range(len(offsets) - 1):
        stages = entries[offsets[kt]:offsets[kt + 1], 0]
        assert (np.diff(stages) > 0).all()
        for st, *masks in entries[offsets[kt]:offsets[kt + 1]]:
            for wg, mask in enumerate(masks[:2]):
                for bit in range(16):
                    if int(mask) >> bit & 1:
                        hits[kt * 8 + 4 * wg + bit // 4, 4 * st + bit % 4] += 1
    np.testing.assert_array_equal(hits[:B, :B], layout.T.astype(np.int64))
    assert not hits[B:].any() and not hits[:, B:].any()


@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_block_table_builds_the_dkv_lists_only_at_block_size_16(bs):
    """Only a block-size-16 table carries the dkv route's stage lists
    (offsets and entries, int32 on the table's device, one offset a key
    tile and one more), equal to `union_list` of the transposed layout."""
    table = sparse.kernel_table(512 // bs, sparse.SparseConfig(block_size=bs, max_seq_len=512),
                                "cpu")
    if bs != 16:
        assert table.key_unions == ()
        return
    offsets, entries = table.key_unions
    assert offsets.dtype == entries.dtype == torch.int32 and offsets.device.type == "cpu"
    layout = sparse.sparsity_layout(32, sparse.SparseConfig(block_size=16, max_seq_len=512))
    want = sparse_kernel.union_list(layout.T, 128, 64)
    np.testing.assert_array_equal(offsets.numpy(), want[0])
    np.testing.assert_array_equal(entries.numpy(), want[1])


@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_block_table_builds_stage_lists_only_for_the_wgmma_block_size(bs):
    """Only a block-size-16 table carries the wgmma route's stage lists
    (int32, on the table's device); the other block sizes' routes never
    read them."""
    table = sparse.kernel_table(512 // bs, sparse.SparseConfig(block_size=bs, max_seq_len=512),
                                "cpu")
    if bs == 16:
        assert len(table.unions) == 4
        assert all(t.dtype == torch.int32 and t.device.type == "cpu" for t in table.unions)
    else:
        assert table.unions == ()


@pytest.mark.parametrize("bs,dh", [(32, 64), (64, 64), (128, 64), (16, 16), (16, 32),
                                   (128, 32)])
def test_route_takes_mma_sync_off_the_ldmatrix_shape(bs, dh):
    table = sparse.kernel_table(512 // bs, sparse.SparseConfig(block_size=bs, max_seq_len=512),
                                "cpu")
    assert sparse_kernel.route(_shaped(8, 512, dh), table) == "mma_sync"
    assert sparse_kernel.route(_shaped(8, 512, dh, torch.float32), table) == "f32"


# B5 dq's and dkv's calls on the training path and in phase 3 and the card
# tests, (BH, n, max_seq_len)
B5_BWD_SHAPES = {
    "trained crop 256": (2048, 256, 256),
    "phase 3 served L=384": (3072, 384, 384),
    "phase 3 long n=4096": (8, 4096, 2048),
    "phase 3 masked element n=1024": (6, 1024, 512),
    "card test ragged n=400": (6, 400, 512),
}


@pytest.mark.parametrize("case", list(B5_BWD_SHAPES))
def test_bwd_route_takes_wgmma_on_every_trained_and_phase3_shape(case):
    """bf16 at dh 64 and block size 16 takes the backward's wgmma route,
    with the dq lists (B5f's, one offset a 128-row tile and one more) and
    the dkv lists (one offset a 128-key tile and one more); f32 takes
    "f32"."""
    BH, n, msl = B5_BWD_SHAPES[case]
    table = sparse.kernel_table(n // 16, sparse.SparseConfig(block_size=16, max_seq_len=msl),
                                "cpu")
    assert sparse_kernel.bwd_route(_shaped(BH, n, 64), table) == "wgmma"
    assert len(table.unions[0]) == len(table.key_unions[0]) == -(-n // 128) + 1
    assert sparse_kernel.bwd_route(_shaped(BH, n, 64, torch.float32), table) == "f32"


@pytest.mark.parametrize("bs,dh", [(32, 64), (64, 64), (128, 64), (16, 16), (16, 32),
                                   (128, 32)])
def test_bwd_route_takes_mma_sync_off_the_wgmma_shape(bs, dh):
    table = sparse.kernel_table(512 // bs, sparse.SparseConfig(block_size=bs, max_seq_len=512),
                                "cpu")
    assert sparse_kernel.bwd_route(_shaped(8, 512, dh), table) == "mma_sync"
    assert sparse_kernel.bwd_route(_shaped(8, 512, dh, torch.float32), table) == "f32"


@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_launch_dq_and_dkv_refuse_a_route_the_call_cannot_take(kind):
    """`which` names a backward route; a route the call cannot take (the
    other dtype, wgmma off dh 64 / bs 16, an unknown name, wgmma on a table
    without its stage lists) is refused before anything is built or
    counted."""
    launch = getattr(sparse_kernel, f"launch_{kind}")
    table = sparse.kernel_table(4, sparse.SparseConfig(block_size=16, max_seq_len=64), "cpu")
    bias, lse = torch.zeros((1, 64)), torch.zeros((2, 64))
    sparse_kernel.reset_launches()
    q32 = torch.zeros((2, 64, 64))
    qb = q32.bfloat16()
    qb32 = torch.zeros((2, 64, 32), dtype=torch.bfloat16)
    for q, which in ((q32, "wgmma"), (q32, "mma_sync"), (qb, "f32"), (qb32, "wgmma"),
                     (qb, "tma")):
        with pytest.raises(ValueError, match=f"no '{which}' sparse {kind} route"):
            launch(q, q, q, bias, table, 2, lse, q, lse, 0.125, which=which)
    bare = dataclasses.replace(table, unions=(), key_unions=())
    with pytest.raises(ValueError, match=f"the {kind} wgmma route reads the stage lists"):
        launch(qb, qb, qb, bias, bare, 2, lse, qb, lse, 0.125)
    assert all(n == 0 for n in sparse_kernel.LAUNCHES.values())


def test_sparse_fwd_refuses_a_route_the_call_cannot_take():
    """`which` names a route; a route the call cannot take (the other dtype,
    wgmma off dh 64 / bs 16, an unknown name, wgmma on a table without its
    stage lists) is refused before anything is built or counted."""
    table = sparse.kernel_table(4, sparse.SparseConfig(block_size=16, max_seq_len=64), "cpu")
    bias = torch.zeros((1, 64))
    sparse_kernel.reset_launches()
    q32 = torch.zeros((2, 64, 64))
    qb = q32.bfloat16()
    qb32 = torch.zeros((2, 64, 32), dtype=torch.bfloat16)
    for q, which in ((q32, "wgmma"), (q32, "mma_sync"), (qb, "f32"), (qb32, "wgmma"),
                     (qb, "tma")):
        with pytest.raises(ValueError, match=f"no '{which}' sparse forward route"):
            sparse_kernel.sparse_fwd(q, q, q, bias, table, 2, 0.125, which=which)
    bare = dataclasses.replace(table, unions=())
    with pytest.raises(ValueError, match="reads the stage lists"):
        sparse_kernel.sparse_fwd(qb, qb, qb, bias, bare, 2, 0.125)
    with pytest.raises(ValueError, match="take CUDA tensors"):  # a route it can take: on to the card
        sparse_kernel.sparse_fwd(qb, qb, qb, bias, table, 2, 0.125, which="mma_sync")
    assert all(n == 0 for n in sparse_kernel.LAUNCHES.values())


def test_sparse_ablation_variants_match_the_source():
    """The sparse ablation tool's copies of csrc/sparse_attn.cu inline the
    shared wgmma pipeline (csrc/flash_fwd_wgmma.cuh) cut from its own text:
    each fragment it changes is still there once, and every copy differs
    from the others."""
    from alphafold2_tpu_torch.ops import cuda_build
    from alphafold2_tpu_torch.telemetry import sparse_ablation

    sources = sparse_ablation.variants()
    assert set(sources) == {"base", "no_mask", "no_ex2", "no_pv", "counters"}
    assert len(set(sources.values())) == len(sources)
    assert sources["base"] == (cuda_build.CSRC / "sparse_attn.cu").read_text()
    for name in ("no_mask", "no_ex2", "no_pv", "counters"):
        assert '#include "flash_fwd_wgmma.cuh"' not in sources[name]
        assert "void wgmma_fwd(" in sources[name]
    counters = sources["counters"]
    assert "af2_ablation_counters" in counters and counters.count("T[7] += 1;") == 1
    assert "wgmma_m64n64k16_rs_mn(o, &p" not in sources["no_pv"]
    assert "(on >> (j / 2))" not in sources["no_mask"]
    base = cuda_build.CSRC / "flash_fwd.cu"
    assert sparse_ablation.variants(base)["baseline"] == base.read_text()
    # --backward: the counters in the shared dkv pipeline or in the dq pipeline
    backward = sparse_ablation.backward_variants()
    assert set(backward) == {"dkv_counters", "dq_counters"}
    for name, header, fn in (("dkv_counters", "flash_bwd_dkv_wgmma.cuh", "wgmma_dkv("),
                             ("dq_counters", "flash_bwd_dq_wgmma.cuh", "wgmma_dq(")):
        copy = backward[name]
        assert f'#include "{header}"' not in copy and f"void {fn}" in copy
        assert copy.count("T[7] += 1;") == 1 and "af2_ablation_counters" in copy
    # a dq stage's two halves add into the same phases
    assert backward["dq_counters"].count("T[3] += tn - tc;") == 2


def test_flash_and_sparse_forwards_share_one_wgmma_pipeline():
    """The flash forward's and the block-sparse forward's wgmma routes are
    one pipeline: both sources include csrc/flash_fwd_wgmma.cuh and launch
    its `wgmma_fwd` through `launch_wgmma_fwd`, the sparse one with a stage
    list. So are the dense and the block-sparse dkv kernels: both include
    csrc/flash_bwd_dkv_wgmma.cuh and launch its `wgmma_dkv` through
    `launch_wgmma_dkv`, the sparse one listed; B5 dq's wgmma route is
    csrc/flash_bwd_dq_wgmma.cuh's `wgmma_dq`, listed. No source holds a copy
    of a pipeline's stages."""
    from alphafold2_tpu_torch.ops import cuda_build

    for name, listed in (("flash_fwd", "false"), ("sparse_attn", "true")):
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert '#include "flash_fwd_wgmma.cuh"' in src
        assert src.count("af2::fwd::wgmma_fwd<") == 1
        assert f", {listed}>(tm_q, tm_k, tm_v, tm_bias" in src
        assert "af2::fwd::launch_wgmma_fwd<" in src
    for name, listed in (("flash_bwd", "false"), ("sparse_attn", "true")):
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert '#include "flash_bwd_dkv_wgmma.cuh"' in src
        assert src.count("af2::dkv::wgmma_dkv<") == 1
        assert f", {listed}>(tm_q, tm_k, tm_v, tm_g, tm_bias, tm_dk, tm_dv" in src
        assert "af2::dkv::launch_wgmma_dkv<" in src
    src = (cuda_build.CSRC / "sparse_attn.cu").read_text()
    assert '#include "flash_bwd_dq_wgmma.cuh"' in src
    assert src.count("af2::dq::wgmma_dq<false, true>(") == 1
    assert "af2::dq::launch_wgmma_dq<false>(" in src
    for name in ("flash_fwd", "flash_bwd", "sparse_attn"):
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        for piece in ("wgmma_m64n128k16_ss(", "wgmma_m64n64k16_ss(", "wgmma_m64n64k16_rs_mn(",
                      "setmaxnreg"):
            assert piece not in src


def test_sparse_ablation_needs_a_card(monkeypatch):
    from alphafold2_tpu_torch.telemetry import sparse_ablation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        sparse_ablation.main([])
