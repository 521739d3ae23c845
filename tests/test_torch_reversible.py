"""The port's reversible trunk (alphafold2_tpu_torch/models/reversible.py)
against the JAX package's, on the same parameters (JAX's
`reversible_trunk_init` through `params_from_jax`) and inputs, in float32
on the CPU, at JAX's own test config (tests/test_reversible.py: dim 32,
depth 3, 2 heads of 8; B, N, R, C = 2, 6, 3, 6).

Tolerances: outputs 1e-5 (the same float32 function, summed in another
order); gradients 1e-4 of each leaf's largest magnitude. The port's
`reverse=True` against its own `reverse=False` with live dropout (the same
masks, drawn at the same per-block positions): the loss 1e-5 relative, each
gradient leaf `rebuild_bound` (f32 rounding of the rebuilt inputs). The saved-tensor
test counts what autograd saves besides the parameters: with
`reverse=True` it does not grow with depth.
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
from alphafold2_tpu.models import reversible_trunk_apply as jax_rev_apply
from alphafold2_tpu.models import reversible_trunk_init as jax_rev_init
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_apply, params_from_jax
from alphafold2_tpu_torch.models import reversible
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_init
from alphafold2_tpu_torch.models.reversible import param_leaves

KW = dict(dim=32, depth=3, heads=2, dim_head=8, max_seq_len=64, reversible=True)
B, N, R, C = 2, 6, 3, 6


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _streams(seed=0, dim=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, N, dim).astype(np.float32)
    m = rng.randn(B, R, C, dim).astype(np.float32)
    x_mask = rng.rand(B, N, N) > 0.1
    msa_mask = rng.rand(B, R, C) > 0.1
    return x, m, x_mask, msa_mask


def _trunk(kw, seed=0):
    """(JAX stacked trunk, the port's layers, JAX cfg, port cfg)."""
    jcfg, tcfg = JaxConfig(**kw), Alphafold2Config(**kw)
    stacked = jax_rev_init(jax.random.PRNGKey(seed), jcfg)
    layers = params_from_jax({"trunk": _host(stacked)}, tcfg, device="cpu")["trunk"]
    return stacked, layers, jcfg, tcfg


def _port_loss(layers, cfg, x, m, x_mask, msa_mask, *, rng=None, reverse=True):
    xo, mo = reversible.reversible_trunk_apply(layers, cfg, x, m, x_mask=x_mask,
                                               msa_mask=msa_mask, rng=rng, reverse=reverse)
    return (xo ** 2).sum() + (mo ** 2).sum(), (xo, mo)


def _assert_grads_close(got, want, tol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        scale = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= tol * max(scale, 1e-30), (scale,)


def _jax_vs_port(kw, masks=True, seed=0):
    stacked, layers, jcfg, tcfg = _trunk(kw, seed)
    x, m, x_mask, msa_mask = _streams(seed=1, dim=kw["dim"])
    if not masks:
        x_mask = msa_mask = None

    def jloss(p, x, m):
        xo, mo = jax_rev_apply(p, jcfg, x, m, x_mask=x_mask, msa_mask=msa_mask)
        return jnp.sum(xo ** 2) + jnp.sum(mo ** 2), (xo, mo)

    (jv, (jxo, jmo)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        stacked, jnp.asarray(x), jnp.asarray(m))
    tx, tm = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(m).requires_grad_(True)
    for t in param_leaves(layers):
        t.requires_grad_(True)
    tmask = None if x_mask is None else torch.from_numpy(x_mask)
    tmmask = None if msa_mask is None else torch.from_numpy(msa_mask)
    tv, (txo, tmo) = _port_loss(layers, tcfg, tx, tm, tmask, tmmask)
    grads = torch.autograd.grad(tv, [tx, tm] + param_leaves(layers))
    np.testing.assert_allclose(txo.detach().numpy(), np.asarray(jxo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tmo.detach().numpy(), np.asarray(jmo), rtol=0, atol=1e-5)
    assert abs(float(tv.detach()) - float(jv)) <= 1e-5 * abs(float(jv))
    # JAX's parameter gradients unstacked into the port's layer order
    want_params = params_from_jax({"trunk": _host(jg[0])}, tcfg, device="cpu")["trunk"]
    _assert_grads_close(list(grads[:2]), [jg[1], jg[2]])
    _assert_grads_close(list(grads[2:]), [t.numpy() for t in param_leaves(want_params)])


def test_trunk_outputs_and_grads_match_jax():
    _jax_vs_port(KW)


def test_trunk_matches_jax_aligned_tied_compressed():
    # the north-star trunk's knobs: tied MSA rows, column-aligned crosses
    # with KV compression (the compress conv transposed per layer)
    _jax_vs_port(dict(KW, msa_tie_row_attn=True, cross_attn_mode="aligned",
                      cross_attn_compress_ratio=2), masks=False)


def test_trunk_sparse_layers_match_jax():
    kw = dict(KW, sparse_self_attn=(True, False, True), sparse_block_size=2,
              sparse_num_random_blocks=1, sparse_num_local_blocks=2)
    _jax_vs_port(kw, masks=False)


def rebuild_bound(cfg, want):
    """Bound on |reverse=True - reverse=False| for one f32 gradient leaf
    `want` (the plain side's). The forwards are the same ops; the reversible
    backward rebuilds each block's input by one f32 subtraction (x = y -
    f(x')), which rounds it by at most half an ulp, 2^-24 of the value. A
    leaf's gradient is a sum of products of the activations those blocks
    feed, so each rebuilt block on the backward's path moves it by at most
    2^-24 of its largest entry, and each side's own f32 summation order by
    2^-24 more: (8 depth + 2) 2^-24 max|want| (eight blocks a layer)."""
    return (8 * cfg.depth + 2) * 2.0 ** -24 * want.abs().max().item()


def test_reverse_matches_plain_autograd_with_dropout():
    cfg = Alphafold2Config(**dict(KW, attn_dropout=0.2, ff_dropout=0.2))
    layers = alphafold2_init(cfg, torch.Generator().manual_seed(4), "cpu")["trunk"]
    for t in param_leaves(layers):
        t.requires_grad_(True)
    x, m, x_mask, msa_mask = (torch.from_numpy(a) for a in _streams(seed=3))
    out = {}
    for reverse in (True, False):
        tx, tm = x.clone().requires_grad_(True), m.clone().requires_grad_(True)
        loss, _ = _port_loss(layers, cfg, tx, tm, x_mask, msa_mask,
                             rng=torch.Generator().manual_seed(11), reverse=reverse)
        out[reverse] = (float(loss.detach()),
                        torch.autograd.grad(loss, [tx, tm] + param_leaves(layers)))
    # dropout is live: another seed gives another loss
    other, _ = _port_loss(layers, cfg, x, m, x_mask, msa_mask,
                          rng=torch.Generator().manual_seed(12))
    assert abs(float(other.detach()) - out[True][0]) > 1e-3
    assert abs(out[True][0] - out[False][0]) <= 1e-5 * abs(out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert (a - b).abs().max().item() <= rebuild_bound(cfg, b), (a - b).abs().max()


def _saved_activation_bytes(depth, reverse):
    cfg = Alphafold2Config(**dict(KW, depth=depth))
    layers = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu")["trunk"]
    params = {t.untyped_storage().data_ptr() for t in param_leaves(layers)}
    for t in param_leaves(layers):
        t.requires_grad_(True)
    x, m, x_mask, msa_mask = (torch.from_numpy(a) for a in _streams())
    x.requires_grad_(True)
    m.requires_grad_(True)
    saved = []

    def pack(t):
        if t.untyped_storage().data_ptr() not in params:
            saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = _port_loss(layers, cfg, x, m, x_mask, msa_mask, reverse=reverse)
    loss.backward()
    assert all(t.grad is not None for t in param_leaves(layers))
    return sum(saved)


def test_saved_activations_do_not_grow_with_depth():
    rev = [_saved_activation_bytes(d, True) for d in (2, 4)]
    plain = [_saved_activation_bytes(d, False) for d in (2, 4)]
    assert rev[0] == rev[1] > 0
    assert plain[1] > plain[0] > rev[0]


def test_model_logits_match_jax():
    kw = dict(dim=32, depth=2, heads=2, dim_head=8, max_seq_len=64, reversible=True)
    jcfg, tcfg = JaxConfig(**kw), Alphafold2Config(**kw)
    jparams = jax_init(jax.random.PRNGKey(2), jcfg)
    tparams = params_from_jax(_host(jparams), tcfg, device="cpu")
    assert len(tparams["trunk"]) == 2 and "seq_ff2" in tparams["trunk"][0]
    rs = np.random.RandomState(5)
    seq = rs.randint(0, 21, size=(1, 8)).astype(np.int32)
    msa = rs.randint(0, 21, size=(1, 3, 8)).astype(np.int32)
    mask = np.ones((1, 8), bool)
    mask[:, 6:] = False
    want = np.asarray(jax_apply(jparams, jcfg, seq, msa, mask=mask))
    got = alphafold2_apply(tparams, tcfg, seq, msa, mask=mask, device="cpu").numpy()
    pair = mask[:, :, None] & mask[:, None, :]
    np.testing.assert_allclose(got[pair], want[pair], rtol=0, atol=1e-5)


def test_init_keeps_the_sequential_numbers():
    # a reversible layer draws its two extra feed-forwards after the six
    # blocks a sequential layer draws
    seq_cfg = Alphafold2Config(**dict(KW, depth=1, reversible=False))
    rev_cfg = Alphafold2Config(**dict(KW, depth=1))
    from alphafold2_tpu_torch.models.trunk import trunk_layer_init
    a = trunk_layer_init(torch.Generator().manual_seed(0), seq_cfg, "cpu")
    b = trunk_layer_init(torch.Generator().manual_seed(0), rev_cfg, "cpu", reversible=True)
    assert set(b) - set(a) == {"seq_ff2", "msa_ff2"}
    for x, y in zip(param_leaves(a), param_leaves({k: b[k] for k in a})):
        assert torch.equal(x, y)


def test_reconstruct_input_inverts_the_forward():
    cfg = Alphafold2Config(**KW)
    layers = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu")["trunk"]
    x, m, x_mask, msa_mask = (torch.from_numpy(a) for a in _streams())
    out = reversible.forward_state(layers, cfg, (x, x, m, m), x_mask=x_mask, msa_mask=msa_mask)
    back = reversible.reconstruct_input(layers, cfg, out, x_mask=x_mask, msa_mask=msa_mask)
    for got, want in zip(back, (x, x, m, m)):
        assert torch.allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["no-msa", "remat", "trunk_fn", "branch_parallel"])
def test_refusals(case):
    if case == "remat":
        with pytest.raises(ValueError, match="mutually exclusive"):
            Alphafold2Config(**dict(KW, remat=True))
        return
    if case == "branch_parallel":
        # constructs, and on the CPU runs serial's op order: the same bits
        cfg = Alphafold2Config(**dict(KW, trunk_schedule="branch_parallel"))
        serial = dataclasses.replace(cfg, trunk_schedule="serial")
        layers = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu")["trunk"]
        x, m, x_mask, msa_mask = (torch.from_numpy(a) for a in _streams())
        outs = [reversible.reversible_trunk_apply(layers, c, x, m, x_mask=x_mask,
                                                  msa_mask=msa_mask) for c in (cfg, serial)]
        assert all(torch.equal(a, b) for a, b in zip(*outs))
        return
    cfg = Alphafold2Config(**dict(KW, depth=1))
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    seq = np.zeros((1, 6), np.int32)
    if case == "no-msa":
        with pytest.raises(ValueError, match="requires an MSA stream"):
            alphafold2_apply(params, cfg, seq, device="cpu")
    else:
        with pytest.raises(ValueError, match="set reversible=False"):
            alphafold2_apply(params, cfg, seq, np.zeros((1, 2, 6), np.int32), device="cpu",
                             trunk_fn=lambda *a: a[2:4])


def test_remat_policy_is_unread_under_reversible():
    cfg = Alphafold2Config(**dict(KW, depth=1, remat_policy="dots"))
    plain = dataclasses.replace(cfg, remat_policy=None)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    seq = np.arange(6, dtype=np.int32)[None]
    msa = np.ones((1, 2, 6), np.int32)
    assert torch.equal(alphafold2_apply(params, cfg, seq, msa, device="cpu"),
                       alphafold2_apply(params, plain, seq, msa, device="cpu"))


def test_predict_structure_runs_reversible_under_inference_mode():
    """Both predict_structures take a reversible config through the same
    call; under torch.inference_mode the Function is only a forward, and
    the serving pipeline's logits are alphafold2_apply's."""
    from alphafold2_tpu_torch.serving.pipeline import predict_structure
    from alphafold2_tpu_torch.training import e2e

    cfg = Alphafold2Config(**dict(KW, depth=2, max_seq_len=48))
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    rs = np.random.RandomState(3)
    seq = rs.randint(0, 20, size=(1, 8)).astype(np.int32)
    msa = rs.randint(0, 21, size=(1, 3, 8)).astype(np.int32)
    with torch.inference_mode():
        out = predict_structure(params, cfg, seq, msa=msa, mds_iters=3, device="cpu")
        want = alphafold2_apply(params, cfg, seq, msa, device="cpu")
        ecfg = e2e.E2EConfig(model=cfg, mds_iters=3, mds_init="classical")
        eparams = e2e.e2e_params_init(ecfg, torch.Generator().manual_seed(1), "cpu")
        full = e2e.predict_structure(eparams, ecfg, seq, msa=msa, device="cpu")
    assert torch.equal(out["distogram_logits"], want)
    assert all(bool(torch.isfinite(out[k]).all()) for k in ("coords", "confidence", "stress"))
    assert full["refined"].shape == (1, 8, 14, 3) and bool(torch.isfinite(full["refined"]).all())
