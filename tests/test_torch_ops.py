"""The port's primitives and attention against the JAX package on the same
parameters (JAX init -> convert_tree) and inputs, float32 on the CPU.

Tolerance: the same float32 functions in another summation order over
widths <= 128: ~1e-7 apart on values of magnitude ~1; bound 2e-6
absolute (5e-6 where a conv or two attention passes chain).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops import attention as jatt
from alphafold2_tpu.ops import core as jcore
from alphafold2_tpu.ops import feedforward as jff
from alphafold2_tpu_torch.models.convert import convert_tree
from alphafold2_tpu_torch.ops import attention as tatt
from alphafold2_tpu_torch.ops import core as tcore
from alphafold2_tpu_torch.ops import feedforward as tff

ATOL = 2e-6


def both(jparams):
    return jparams, convert_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_linear_and_layer_norm():
    jp, tp = both(jcore.linear_init(jax.random.PRNGKey(0), 24, 40))
    x = normal(3, 5, 24)
    close(tcore.linear(tp, torch.from_numpy(x)), jcore.linear(jp, x))
    jln = {"scale": normal(24, seed=1), "bias": normal(24, seed=2)}
    _, tln = both(jln)
    close(tcore.layer_norm(tln, torch.from_numpy(3 * x + 1)), jcore.layer_norm(jln, 3 * x + 1))


def test_embedding():
    jp, tp = both(jcore.embedding_init(jax.random.PRNGKey(1), 21, 16))
    ids = np.array([[0, 5, 20, 3]], np.int32)
    close(tcore.embedding(tp, torch.from_numpy(ids).long()), jcore.embedding(jp, ids))


@pytest.mark.parametrize("chunk", [0, 7], ids=["whole", "chunked"])
def test_feed_forward(chunk):
    jp, tp = both(jff.feed_forward_init(jax.random.PRNGKey(2), 16))
    x = normal(2, 5, 3, 16)
    close(tff.feed_forward_apply(tp, torch.from_numpy(x), chunk=chunk),
          jff.feed_forward_apply(jp, x, chunk=chunk))


def _cfgs(**kw):
    base = dict(dim=32, heads=2, dim_head=16)
    return jatt.AttentionConfig(**base, **kw), tatt.AttentionConfig(**base, **kw)


def _masks(b, n, seed):
    m = np.random.default_rng(seed).random((b, n)) > 0.25
    m[:, 0] = True
    return m


BRANCHES = {
    "dense": dict(flash=False),
    "flash": dict(flash=True),
    "auto-cpu": dict(),  # CPU "auto" keeps the JAX 2^27 rule: dense here
    "gated-dense": dict(flash=False, gate=True),
    "gated-flash": dict(flash=True, gate=True),
    "batch-chunked": dict(flash=True, batch_chunk=2),
}


@pytest.mark.parametrize("name", list(BRANCHES))
def test_self_attention_branches(name):
    jcfg, tcfg = _cfgs(**BRANCHES[name])
    jp, tp = both(jatt.attention_init(jax.random.PRNGKey(3), jcfg))
    if tcfg.gate:  # a non-trivial gate (the init is w=0, b=1)
        jp["to_gate"]["w"] = normal(32, 32, seed=9) * 0.3
        jp, tp = both(jp)
    x, mask = normal(5, 9, 32, seed=4), _masks(5, 9, 5)
    j = jatt.attention_apply(jp, jcfg, x, mask=mask)
    t = tatt.attention_apply(tp, tcfg, torch.from_numpy(x), mask=torch.from_numpy(mask))
    # compare valid query rows (masked rows: dense and flash give
    # different garbage, ops/flash.py contract)
    close(t[torch.from_numpy(mask)], np.asarray(j)[mask])


@pytest.mark.parametrize("compress", [1, 3], ids=["plain", "compressed"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_cross_attention(compress, flash):
    jcfg, tcfg = _cfgs(flash=flash, compress_ratio=compress)
    jp, tp = both(jatt.attention_init(jax.random.PRNGKey(4), jcfg))
    x, ctx = normal(2, 7, 32, seed=1), normal(2, 11, 32, seed=2)
    cm = _masks(2, 11, 3)
    j = jatt.attention_apply(jp, jcfg, x, context=ctx, context_mask=cm)
    t = tatt.attention_apply(tp, tcfg, torch.from_numpy(x), context=torch.from_numpy(ctx),
                             context_mask=torch.from_numpy(cm))
    close(t, j, atol=5e-6)


def test_tied_row_attention():
    jcfg, tcfg = _cfgs(flash=True)  # tied rows always take the dense path
    jp, tp = both(jatt.attention_init(jax.random.PRNGKey(5), jcfg))
    r = 3
    x, mask = normal(2 * r, 6, 32, seed=6), _masks(2 * r, 6, 7)
    j = jatt.attention_apply(jp, jcfg, x, mask=mask, tie_dim=r)
    t = tatt.attention_apply(tp, tcfg, torch.from_numpy(x), mask=torch.from_numpy(mask),
                             tie_dim=r)
    valid = mask.reshape(2, r, 6).all(1).repeat(r, axis=0)
    close(t[torch.from_numpy(valid)], np.asarray(j)[valid])


@pytest.mark.parametrize("tie_row", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_axial_attention(tie_row, flash):
    jcfg, tcfg = _cfgs(flash=flash)
    jp, tp = both(jatt.axial_attention_init(jax.random.PRNGKey(6), jcfg))
    x = normal(2, 4, 6, 32, seed=8)
    mask = np.ones((2, 4, 6), bool)
    mask[:, :, 5] = False
    j = jatt.axial_attention_apply(jp, jcfg, x, mask=mask, tie_row=tie_row)
    t = tatt.axial_attention_apply(tp, tcfg, torch.from_numpy(x),
                                   mask=torch.from_numpy(mask), tie_row=tie_row)
    close(t[torch.from_numpy(mask)], np.asarray(j)[mask], atol=5e-6)


def test_axial_attention_with_context():
    jcfg, tcfg = _cfgs(flash=True)
    jp, tp = both(jatt.axial_attention_init(jax.random.PRNGKey(7), jcfg))
    x, ctx = normal(1, 3, 5, 32, seed=1), normal(1, 4, 32, seed=2)
    cm = np.array([[True, True, False, True]])
    j = jatt.axial_attention_apply(jp, jcfg, x, context=ctx, context_mask=cm)
    t = tatt.axial_attention_apply(tp, tcfg, torch.from_numpy(x),
                                   context=torch.from_numpy(ctx),
                                   context_mask=torch.from_numpy(cm))
    close(t, j, atol=5e-6)


def test_cuda_auto_takes_flash_for_every_untied_attention():
    """On CUDA tensors "auto" means the flash path (the kernels) at any
    size the kernels take; on the CPU the JAX 2^27 logit rule holds."""
    _, tcfg = _cfgs()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not tatt._use_flash(tcfg, 2, 9, 9, cpu)
    assert tatt._use_flash(tcfg, 2048, 256, 256, cpu)  # 2^28 logits > 2^27
    assert tatt._use_flash(tcfg, 2, 9, 9, cuda)
    assert not tatt._use_flash(dataclasses.replace(tcfg, flash=False), 2, 9, 9, cuda)
    # a head width the kernels are not built for stays on the dense path
    wide = dataclasses.replace(tcfg, dim_head=128)
    assert not tatt._use_flash(wide, 2, 9, 9, cuda)
    assert tatt._use_flash(dataclasses.replace(wide, flash=True), 2, 9, 9, cuda)
