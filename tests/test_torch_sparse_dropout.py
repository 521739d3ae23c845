"""Attention dropout in the block-sparse kernels (B5f, B5 dq, B5 dkv) and
their plain versions, on the CPU at small sizes.

The keep bits: `sparse_kernel.philox_keep` is Philox4x32-10 (Random123's
known answers, bit for bit), a function of (seed, bh, query, key) only:
the forward's gathered layout and the dkv version's transposed one read
the same bits, the kept share lies within 5 binomial sigmas of 1 - rate,
and the bits differ across bh, queries and keys. The function: the plain
forward and its vjp, fed JAX's own mask (its `bernoulli` draw, scattered
through the layout), match `alphafold2_tpu.ops.sparse.block_sparse_attention`
with dropout, f32 2e-6 * max(1, |ref|), with and without key padding; the
plain dq / dkv with dropout equal autograd of the plain forward with
dropout (2e-6 * max(1, |ref|)). The layer draws its seed once from its rng
(`sparse.draw_seed`), so a remat recompute draws the forward's mask (the
step bit for bit) and the reversible backward rebuilds it (1e-5). Train
steps take sparse configs with attention dropout on the card.

The kernels against these plain versions run on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 16).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops import sparse as jsparse
from alphafold2_tpu_torch import Alphafold2Config
from alphafold2_tpu_torch.ops import sparse, sparse_kernel
from alphafold2_tpu_torch.ops.attention import AttentionConfig, attention_init
from alphafold2_tpu_torch.training import data, harness

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


def _fold(x):
    b, n, h, dh = x.shape
    return torch.from_numpy(np.asarray(x)).transpose(1, 2).reshape(b * h, n, dh).contiguous()


def _seed(a, b):
    return torch.tensor([a, b], dtype=torch.int64)


# --- the bits -----------------------------------------------------------------------


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_matches_random123_known_answers(counter, key, want):
    """Philox4x32-10 on int64 tensors (csrc/philox.cuh's twin) against the
    Random123 known-answer vectors, bit for bit."""
    got = sparse_kernel.philox4x32(tuple(torch.tensor(c) for c in counter),
                                   tuple(torch.tensor(k) for k in key))
    assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_and_independence(rate):
    """Over 4 x 256 x 256 elements the kept share lies within 5 binomial
    sigmas of 1 - rate; rows, columns and heads draw different bits; a
    second seed draws other bits."""
    BH, n = 4, 256
    bh = torch.arange(BH)[:, None, None]
    rows, cols = torch.arange(n)[None, :, None], torch.arange(n)[None, None, :]
    keep = sparse_kernel.philox_keep(_seed(12345, 678), bh, rows, cols, rate)
    assert keep.shape == (BH, n, n) and keep.dtype == torch.bool
    count = keep.numel()
    sigma = math.sqrt(count * rate * (1 - rate))
    assert abs(keep.sum().item() - count * (1 - rate)) <= 5 * sigma
    for a, b in ((keep[0], keep[1]), (keep[:, 0], keep[:, 8]), (keep[:, :, 0], keep[:, :, 8]),
                 (keep[:, 0], keep[:, 1]), (keep[:, :, 0], keep[:, :, 1])):
        assert not torch.equal(a, b)
    other = sparse_kernel.philox_keep(_seed(12346, 678), bh, rows, cols, rate)
    assert not torch.equal(keep, other)
    salted = sparse_kernel.philox_keep(_seed(12345, 679), bh, rows, cols, rate)
    assert not torch.equal(keep, salted)


def test_threshold_is_an_integer_test():
    assert sparse_kernel.dropout_threshold(0.0) == 0
    assert sparse_kernel.dropout_threshold(0.5) == 2 ** 31
    assert sparse_kernel.dropout_threshold(0.1) == 429496730
    assert sparse_kernel.dropout_threshold(1 - 2 ** -40) == 2 ** 32 - 1


def _dense_keep(seed, BH, n, rate):
    return sparse_kernel.philox_keep(seed, torch.arange(BH)[:, None, None],
                                     torch.arange(n)[None, :, None],
                                     torch.arange(n)[None, None, :], rate)


@pytest.mark.parametrize("block_size", [4, 16])
def test_forward_and_dkv_layouts_read_the_same_bits(block_size):
    """The forward (query blocks over their slots) and the dkv version (key
    blocks over the query blocks of their own row) read each element's bit
    at its sequence coordinates: with a seed, the plain versions equal the
    same versions fed the dense mask of those coordinates, bit for bit."""
    _, tcfg = _cfgs(block_size=block_size, max_seq_len=256)
    n = 8 * block_size
    q, k, v, g, mask = _qkv(n=n, seed=3)
    fq, fk, fv, fg = (_fold(x) for x in (q, k, v, g))
    bias = torch.where(torch.from_numpy(mask), 0.0, float("-inf")).float()
    table = sparse.kernel_table(n // block_size, tcfg, "cpu")
    seed, rate = _seed(2 ** 61 + 17, 99), 0.3
    dense = _dense_keep(seed, fq.shape[0], n, rate)
    args = (fq, fk, fv, bias, table, 2, 0.3)
    out, lse = sparse_kernel.sparse_fwd_plain(*args, dropout_rate=rate, seed=seed)
    ref_out, ref_lse = sparse_kernel.sparse_fwd_plain(*args, dropout_rate=rate, keep=dense)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    undropped, plain_lse = sparse_kernel.sparse_fwd_plain(*args)
    assert torch.equal(lse, plain_lse) and not torch.equal(out, undropped)
    grads = sparse_kernel.sparse_bwd_plain(*args[:6], out, lse, fg, 0.3, dropout_rate=rate,
                                           seed=seed)
    refs = sparse_kernel.sparse_bwd_plain(*args[:6], out, lse, fg, 0.3, dropout_rate=rate,
                                          keep=dense)
    for a, b in zip(grads, refs):
        assert torch.equal(a, b)


# --- the function against JAX's --------------------------------------------------------


def _scatter_jax_mask(keep, idx, valid, b, h, n, bs):
    """JAX's (b, h, B, bs, A, bs) dropout draw as a dense (b * h, n, n)
    keep mask: slot a of query block r holds key block idx[r, a]."""
    dense = np.zeros((b * h, n, n), bool)
    B, A = idx.shape
    for r in range(B):
        for a in range(A):
            if valid[r, a]:
                c = idx[r, a]
                dense[:, r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = \
                    keep[:, :, r, :, a, :].reshape(b * h, bs, bs)
    return torch.from_numpy(dense)


@pytest.mark.parametrize("masked", [True, False], ids=["key padding", "no mask"])
def test_plain_forward_and_vjp_with_jax_mask_match_jax(masked):
    """The plain forward and its vjp (autograd), fed JAX's own dropout mask,
    against JAX's gather path with dropout (`block_sparse_attention`,
    dropout_rate 0.3): f32, 2e-6 * max(1, |ref|)."""
    jcfg, tcfg = _cfgs()
    q, k, v, g, mask = _qkv(masked_row=masked)
    b, n, h, dh = q.shape
    bs, rate = jcfg.block_size, 0.3
    rng = jax.random.PRNGKey(11)
    jmask = jnp.asarray(mask) if masked else None

    def jfn(q, k, v):
        return jsparse.block_sparse_attention(q, k, v, jcfg, mask=jmask, dropout_rate=rate,
                                              rng=rng)

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    idx, valid = jsparse.layout_block_indices(n // bs, jcfg)
    jkeep = np.asarray(jax.random.bernoulli(rng, 1.0 - rate, (b, h, n // bs, bs, idx.shape[1], bs)))
    dense = _scatter_jax_mask(jkeep, idx, valid, b, h, n, bs)

    fq, fk, fv = (_fold(x).requires_grad_() for x in (q, k, v))
    bias = (torch.where(torch.from_numpy(mask), 0.0, float("-inf")).float() if masked
            else torch.zeros((b, n)))
    table = sparse.kernel_table(n // bs, tcfg, "cpu")
    out, _ = sparse_kernel.sparse_fwd_plain(fq, fk, fv, bias, table, h, dh ** -0.5,
                                            dropout_rate=rate, keep=dense)
    out.backward(_fold(g))
    want = np.asarray(jout).transpose(0, 2, 1, 3).reshape(b * h, n, dh)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=2e-6 * max(1.0, np.abs(want).max()))
    undropped = jsparse.block_sparse_attention(*(jnp.asarray(x) for x in (q, k, v)), jcfg,
                                               mask=jmask)
    assert np.abs(np.asarray(undropped) - np.asarray(jout)).max() > 1e-2  # dropout is live
    for got, w in zip((fq.grad, fk.grad, fv.grad), jgrads):
        w = np.asarray(w).transpose(0, 2, 1, 3).reshape(b * h, n, dh)
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=2e-6 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_plain_backward_with_dropout_is_autograd_of_the_plain_forward(rate):
    """`sparse_bwd_plain` with the forward's seed (what B5 dq and dkv
    compute: dV = (P Z)^T dO, dS = P (dP Z - delta)) equals autograd
    through `sparse_fwd_plain` with the same seed, a fully masked batch
    element included: f32, 2e-6 * max(1, |ref|)."""
    _, tcfg = _cfgs()
    q, k, v, g, mask = _qkv(b=2, seed=4)
    bias = torch.where(torch.from_numpy(mask), 0.0, float("-inf")).float()
    table = sparse.kernel_table(4, tcfg, "cpu")
    seed = _seed(987654321, 5)
    tq, tk, tv = (_fold(x).requires_grad_() for x in (q, k, v))
    out, lse = sparse_kernel.sparse_fwd_plain(tq, tk, tv, bias, table, 2, 0.3,
                                              dropout_rate=rate, seed=seed)
    out.backward(_fold(g))
    split = sparse_kernel.sparse_bwd_plain(tq.detach(), tk.detach(), tv.detach(), bias, table, 2,
                                           out.detach(), lse, _fold(g), 0.3,
                                           dropout_rate=rate, seed=seed)
    for want, got in zip((tq.grad, tk.grad, tv.grad), split):
        assert torch.isfinite(want).all() and (want[:2] == 0).all()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2e-6 * max(1.0, want.abs().max().item()))


# --- the layer's seed ------------------------------------------------------------------


def test_the_layer_draws_one_seed_from_its_rng(monkeypatch):
    """`sparse_attention_apply` with live dropout draws its seed once from
    the generator (`draw_seed`: two int64, the generator moved by that one
    draw), and the seed is all the randomness the call takes: two
    generators whose draw is replaced by one seed give one output; eval
    mode (no rng) draws nothing and drops nothing."""
    _, tcfg = _cfgs()
    attn = AttentionConfig(dim=16, heads=2, dim_head=8, dropout=0.25)
    params = attention_init(torch.Generator().manual_seed(0), attn, "cpu")
    x = torch.randn(2, 14, 16, generator=torch.Generator().manual_seed(3))
    mask = torch.ones(2, 14, dtype=torch.bool)
    mask[1, 9:] = False
    rng, twin = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    got = sparse.sparse_attention_apply(params, attn, tcfg, x, mask=mask, rng=rng)
    seed = sparse.draw_seed(twin, "cpu")
    assert seed.dtype == torch.int64 and seed.shape == (2,)
    assert torch.equal(rng.get_state(), twin.get_state())
    draws = []
    monkeypatch.setattr(sparse, "draw_seed", lambda g, device: draws.append(g) or seed)
    for other in (torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)):
        assert torch.equal(sparse.sparse_attention_apply(params, attn, tcfg, x, mask=mask,
                                                         rng=other), got)
    assert len(draws) == 2
    eval_out = sparse.sparse_attention_apply(params, attn, tcfg, x, mask=mask)
    plain = sparse.sparse_attention_apply(params, AttentionConfig(dim=16, heads=2, dim_head=8),
                                          tcfg, x, mask=mask)
    assert torch.equal(eval_out, plain) and not torch.equal(got, plain)
    assert len(draws) == 2


def test_check_dropout_refuses_a_bad_seed_or_rate():
    cpu = torch.device("cpu")
    assert not sparse_kernel.check_dropout(0.0, _seed(1, 2), cpu)
    assert not sparse_kernel.check_dropout(0.1, None, cpu)
    assert sparse_kernel.check_dropout(0.1, _seed(1, 2), cpu)
    for bad in (torch.tensor([1, 2], dtype=torch.int32), torch.tensor([1, 2, 3]),
                torch.tensor([[1, 2]])):
        with pytest.raises(ValueError, match="dropout seed"):
            sparse_kernel.check_dropout(0.1, bad, cpu)
    with pytest.raises(ValueError, match="outside"):
        sparse_kernel.check_dropout(1.0, _seed(1, 2), cpu)


SPARSE = dict(dim=16, depth=2, heads=2, dim_head=8, max_seq_len=32,
              sparse_self_attn=(True, False), sparse_block_size=4, sparse_num_random_blocks=1,
              sparse_num_local_blocks=2, attn_dropout=0.2, ff_dropout=0.1)


def _step(cfg, rngs, accum=2):
    """make_train_step (CPU) over len(rngs) batches: per step (loss,
    grad_norm) and the final leaves."""
    tt = harness.TrainConfig(grad_accum=accum, max_grad_norm=1.0)
    state = harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cpu")
    step = harness.make_train_step(cfg, tt, device="cpu")
    fetch = data.synthetic_microbatch_fn(data.DataConfig(max_len=12, msa_rows=3, seed=1), accum)
    out = []
    for n, r in enumerate(rngs):
        _, m = step(state, fetch(n), torch.Generator().manual_seed(r))
        out.append((m["loss"], m["grad_norm"]))
    return out, [p.detach().clone() for p in state["optimizer"].leaves]


def test_sparse_step_with_dropout_draws_from_its_rng_and_remat_redraws_it():
    """A sparse layer with attention dropout in the step: the same rng gives
    the same step bit for bit, another rng another loss; remat with
    remat_policy "dots" recomputes the layer from its own pass generator,
    seeded alike, so it draws the forward's seed and mask: bit for bit."""
    cfg = Alphafold2Config(**SPARSE)
    a, b = _step(cfg, [5, 6]), _step(cfg, [5, 6])
    for (la, ga), (lb, gb) in zip(a[0], b[0]):
        assert torch.equal(la, lb) and torch.equal(ga, gb)
    assert not torch.equal(a[0][0][0], _step(cfg, [7, 6])[0][0][0])
    remat = _step(Alphafold2Config(**SPARSE, remat=True, remat_policy="dots"), [5, 6])
    for (la, ga), (lr, gr) in zip(a[0], remat[0]):
        assert torch.equal(la, lr) and torch.equal(ga, gr)
    assert all(torch.equal(x, y) for x, y in zip(a[1], remat[1]))


def test_reversible_sparse_dropout_rebuilds_the_forward_masks():
    """The reversible trunk with a sparse layer and attention dropout: the
    backward rebuilds each block with the forward's seed (its position's
    second pass), so its gradients equal plain autograd's through the same
    masks, 1e-5 of each leaf's largest (the same f32 function summed in
    another order), and another rng gives another loss."""
    from alphafold2_tpu_torch.models import reversible
    from alphafold2_tpu_torch.models.alphafold2 import alphafold2_init
    from alphafold2_tpu_torch.models.reversible import param_leaves

    cfg = Alphafold2Config(**dict(SPARSE, dim=32, reversible=True))
    layers = alphafold2_init(cfg, torch.Generator().manual_seed(4), "cpu")["trunk"]
    for t in param_leaves(layers):
        t.requires_grad_(True)
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 8, 8, 32).astype(np.float32))
    m = torch.from_numpy(rs.randn(2, 3, 8, 32).astype(np.float32))
    out = {}
    for reverse in (True, False):
        tx, tm = x.clone().requires_grad_(True), m.clone().requires_grad_(True)
        xo, mo = reversible.reversible_trunk_apply(layers, cfg, tx, tm, rng=torch.Generator()
                                                   .manual_seed(11), reverse=reverse)
        loss = (xo ** 2).sum() + (mo ** 2).sum()
        out[reverse] = (loss.item(), torch.autograd.grad(loss, [tx, tm] + param_leaves(layers)))
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())
    xo, mo = reversible.reversible_trunk_apply(layers, cfg, x, m,
                                               rng=torch.Generator().manual_seed(12))
    assert abs(((xo ** 2).sum() + (mo ** 2).sum()).item() - out[True][0]) > 1e-3


def test_train_steps_take_sparse_dropout_on_the_card(monkeypatch):
    """`make_train_step` on a CUDA device takes a sparse config with
    attention dropout (it built no step for one before the kernels had
    dropout); it still refuses an int8 config. The device is only named
    here: building the step launches nothing."""
    monkeypatch.setattr(harness, "resolve_device", lambda device: torch.device("cuda", 0))
    tcfg = harness.TrainConfig(grad_accum=1)
    assert callable(harness.make_train_step(Alphafold2Config(**SPARSE), tcfg, device="cuda"))
    with pytest.raises(ValueError, match="make_train_step: weight_dtype='int8'"):
        harness.make_train_step(Alphafold2Config(**SPARSE, weight_dtype="int8"), tcfg,
                                device="cuda")
