"""Flash attention, port vs JAX package (CPU, float32).

The port's plain versions of the CUDA kernels B1f (`flash_fwd`) and B2f
(`flash_fwd_fused`) against the Pallas kernels they replace
(`flash_attention_lse` / the fused forward), run in Pallas interpret mode
on the CPU as tests/test_flash_kernel.py runs them; and the (B, i, h, dh)
dispatcher `flash_attention` against the JAX one. Out and lse are
compared; fully masked rows must give zeros and lse = +inf on both sides.
The backwards: B1b (`flash_bwd`) and B2b (`flash_bwd_fused`) on their
plain route against `jax.vjp` of the Pallas kernels, and the gradients of
the dispatcher against `jax.grad` of the JAX one.

Tolerance: both sides compute the same f32 recurrence with other block
sizes and summation orders over j <= 200 keys, ~1e-7 apart; the bound is
2e-6 absolute on outputs and lse of magnitude <= ~6. Gradients (sums over
i or j of products of such terms, magnitudes up to ~11): 2e-6 times
max(1, the largest reference entry).

The kernels themselves need the card: tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops import flash as jflash
from alphafold2_tpu.ops import flash_kernel as jfk
from alphafold2_tpu_torch.ops import cuda_build, flash_kernel
from alphafold2_tpu_torch.ops.flash import flash_attention

ATOL = 2e-6
NEG = float("-inf")


def folded_inputs(BH, i, j, dh, seed=0, masked_bh=(), key_p=0.8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BH, i, dh)).astype(np.float32)
    k = rng.normal(size=(BH, j, dh)).astype(np.float32)
    v = rng.normal(size=(BH, j, dh)).astype(np.float32)
    keep = rng.random((BH, j)) < key_p
    keep[:, 0] = True
    for b in masked_bh:
        keep[b] = False  # every query row of this (batch*head) row is empty
    bias = np.where(keep, 0.0, NEG).astype(np.float32)
    return q, k, v, bias


def assert_out_lse(t_out, t_lse, j_out, j_lse):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)
    j_lse = np.asarray(j_lse)
    t_lse = t_lse.numpy()
    np.testing.assert_array_equal(np.isposinf(t_lse), np.isposinf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(t_lse[fin], j_lse[fin], rtol=0, atol=ATOL)


@pytest.mark.parametrize(
    "BH,i,j,dh,masked",
    [
        (3, 16, 16, 16, ()),
        (4, 37, 53, 16, ()),       # ragged, i != j
        (2, 130, 7, 32, ()),       # i past one 128-row block, j tiny
        (5, 21, 200, 16, (1, 3)),  # fully masked rows
    ],
    ids=["square", "ragged", "long-i", "masked-rows"],
)
def test_b1f_plain_matches_pallas(BH, i, j, dh, masked):
    q, k, v, bias = folded_inputs(BH, i, j, dh, masked_bh=masked)
    scale = dh ** -0.5
    j_out, j_lse = jfk.flash_attention_lse(q, k, v, bias, scale)
    t_out, t_lse = flash_kernel.flash_fwd(*map(torch.from_numpy, (q, k, v, bias)), scale)
    assert_out_lse(t_out, t_lse, j_out, j_lse)
    if masked:
        assert (t_out.numpy()[list(masked)] == 0).all()
        assert np.isposinf(t_lse.numpy()[list(masked)]).all()


def _pallas_fused(q, k, v, bias, gate, scale):
    """The JAX fused forward with its lse (flash_attention_fused returns
    the output only)."""
    bias2d, gated = bias.ndim == 3, gate is not None
    gate_arg = gate if gated else jnp.zeros((q.shape[0], 1, q.shape[2]), q.dtype)
    out, res = jfk._forward_fused(q, k, v, bias, gate_arg, scale, 128, 128,
                                  bias2d, gated)
    lse, i0 = res[5], res[6]
    return out, lse.reshape(lse.shape[0], -1)[:, :i0]


@pytest.mark.parametrize(
    "mode,i,j",
    [("gate", 19, 45), ("bias2d", 33, 27), ("gate+bias2d", 40, 140)],
)
def test_b2f_plain_matches_pallas(mode, i, j):
    BH, dh = 3, 16
    q, k, v, key_bias = folded_inputs(BH, i, j, dh, seed=2, masked_bh=(2,))
    rng = np.random.default_rng(5)
    gate = rng.normal(size=(BH, i, dh)).astype(np.float32) if "gate" in mode else None
    if "bias2d" in mode:
        bias = (rng.normal(size=(BH, i, j)) + key_bias[:, None, :]).astype(np.float32)
        bias[0, 3] = NEG  # one fully masked query row in a live (bh) row
    else:
        bias = key_bias
    scale = dh ** -0.5
    j_out, j_lse = _pallas_fused(q, k, v, bias, gate, scale)
    if gate is not None:  # the public entry (its own block sizes) agrees
        np.testing.assert_allclose(
            np.asarray(jfk.flash_attention_fused(q, k, v, bias, scale, gate=gate)),
            np.asarray(j_out), rtol=0, atol=ATOL,
        )
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    t_out, t_lse = flash_kernel.flash_fwd_fused(t(q), t(k), t(v), t(bias), scale,
                                                gate=t(gate))
    assert_out_lse(t_out, t_lse, j_out, j_lse)


@pytest.mark.parametrize("mode", ["plain", "gate", "pair_bias", "gate+pair_bias"])
def test_dispatcher_matches_jax(mode):
    B, i, j, h, dh = 2, 14, 23, 2, 16
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, i, h, dh)).astype(np.float32)
    k = rng.normal(size=(B, j, h, dh)).astype(np.float32)
    v = rng.normal(size=(B, j, h, dh)).astype(np.float32)
    key_bias = np.where(rng.random((B, j)) < 0.7, 0.0, NEG).astype(np.float32)
    key_bias[:, 0] = 0.0
    gate = rng.normal(size=(B, i, h, dh)).astype(np.float32) if "gate" in mode else None
    pair = rng.normal(size=(B, h, i, j)).astype(np.float32) if "pair" in mode else None
    kw = dict(kv_block=8)  # several K/V blocks on both sides
    j_out = jflash.flash_attention(q, k, v, key_bias, pair_bias=pair, gate=gate,
                                   use_kernel=False, **kw)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    t_out = flash_attention(t(q), t(k), t(v), t(key_bias), pair_bias=t(pair),
                            gate=t(gate), **kw)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)


def assert_grads(got, want):
    for t, j in zip(got, want):
        j = np.asarray(j)
        atol = 2e-6 * max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=atol)


@pytest.mark.parametrize(
    "BH,i,j,dh,masked",
    [
        (3, 16, 16, 16, ()),
        (4, 37, 53, 16, ()),
        (2, 130, 7, 32, ()),
        (5, 21, 200, 16, (1, 3)),
    ],
    ids=["square", "ragged", "long-i", "masked-rows"],
)
def test_b1b_plain_matches_pallas_vjp(BH, i, j, dh, masked):
    q, k, v, bias = folded_inputs(BH, i, j, dh, masked_bh=masked)
    g = np.random.default_rng(9).normal(size=(BH, i, dh)).astype(np.float32)
    scale = dh ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: jfk.flash_attention_tpu(q, k, v, bias, scale), q, k, v)
    tq, tk, tv, tb, tg = map(torch.from_numpy, (q, k, v, bias, g))
    out, lse = flash_kernel.flash_fwd(tq, tk, tv, tb, scale)
    grads = flash_kernel.flash_bwd(tq, tk, tv, tb, out, lse, tg, scale)
    assert_grads(grads, vjp(g))
    for t in grads:  # fully masked rows: exact zeros, no NaN
        assert torch.isfinite(t).all()
        assert (t[list(masked)] == 0).all()


@pytest.mark.parametrize(
    "mode,i,j",
    [("gate", 19, 45), ("bias2d", 33, 27), ("gate+bias2d", 40, 140)],
)
def test_b2b_plain_matches_pallas_vjp(mode, i, j):
    """dq, dk, dv, d_bias (2-D mode) and d_gate against the Pallas fused
    kernel's VJP, with a fully masked (bh) row and, in 2-D mode, a fully
    masked query row."""
    BH, dh = 3, 16
    q, k, v, key_bias = folded_inputs(BH, i, j, dh, seed=2, masked_bh=(2,))
    rng = np.random.default_rng(5)
    gate = rng.normal(size=(BH, i, dh)).astype(np.float32) if "gate" in mode else None
    if "bias2d" in mode:
        bias = (rng.normal(size=(BH, i, j)) + key_bias[:, None, :]).astype(np.float32)
        bias[0, 3] = NEG
    else:
        bias = key_bias
    g = rng.normal(size=(BH, i, dh)).astype(np.float32)
    scale = dh ** -0.5
    primals = (q, k, v, bias) + ((gate,) if gate is not None else ())

    def pallas(q, k, v, bias, gate=None):
        return jfk.flash_attention_fused(q, k, v, bias, scale, gate=gate)

    _, vjp = jax.vjp(pallas, *primals)
    want = vjp(g)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out, lse = flash_kernel.flash_fwd_fused(t(q), t(k), t(v), t(bias), scale, gate=t(gate))
    dq, dk, dv, d_bias, d_gate = flash_kernel.flash_bwd_fused(
        t(q), t(k), t(v), t(bias), t(gate), out, lse, t(g), scale)
    assert_grads((dq, dk, dv), want[:3])
    if "bias2d" in mode:
        assert_grads((d_bias,), want[3:4])
        assert (d_bias[0, 3] == 0).all()
    else:
        assert d_bias is None
    if gate is not None:
        assert_grads((d_gate,), want[4:5])
    else:
        assert d_gate is None


@pytest.mark.parametrize("mode", ["plain", "gate", "pair_bias", "gate+pair_bias"])
def test_dispatcher_grads_match_jax(mode):
    """Gradients of `flash_attention` (autograd through the plain blockwise
    route, as JAX's `xla_ref` arm) against `jax.grad` of the JAX dispatcher
    with the kernel off, through a fixed random cotangent."""
    B, i, j, h, dh = 2, 14, 23, 2, 16
    rng = np.random.default_rng(11)
    q = rng.normal(size=(B, i, h, dh)).astype(np.float32)
    k = rng.normal(size=(B, j, h, dh)).astype(np.float32)
    v = rng.normal(size=(B, j, h, dh)).astype(np.float32)
    key_bias = np.where(rng.random((B, j)) < 0.7, 0.0, NEG).astype(np.float32)
    key_bias[:, 0] = 0.0
    gate = rng.normal(size=(B, i, h, dh)).astype(np.float32) if "gate" in mode else None
    pair = rng.normal(size=(B, h, i, j)).astype(np.float32) if "pair" in mode else None
    cot = rng.normal(size=(B, i, h, dh)).astype(np.float32)
    names = ["q", "k", "v"] + (["gate"] if gate is not None else []) \
        + (["pair"] if pair is not None else [])
    arrays = {"q": q, "k": k, "v": v, "gate": gate, "pair": pair}

    def jloss(*xs):
        a = dict(arrays, **dict(zip(names, xs)))
        out = jflash.flash_attention(a["q"], a["k"], a["v"], key_bias, pair_bias=a["pair"],
                                     gate=a["gate"], use_kernel=False, kv_block=8)
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(*(arrays[n] for n in names))
    ts = {n: torch.from_numpy(arrays[n]).requires_grad_() for n in names}
    out = flash_attention(ts["q"], ts["k"], ts["v"], torch.from_numpy(key_bias),
                          pair_bias=ts.get("pair"), gate=ts.get("gate"), kv_block=8)
    (out * torch.from_numpy(cot)).sum().backward()
    assert_grads([ts[n].grad for n in names], want)


@pytest.mark.parametrize("fused", [False, True], ids=["b1", "b2-gate-pair"])
def test_autograd_functions_route_through_the_wrappers(fused):
    """The CUDA route's autograd.Functions, run on CPU tensors (their
    wrappers take the plain route there): gradients equal autograd of the
    dispatcher's plain route, with None for the key-side bias."""
    from alphafold2_tpu_torch.ops.flash import _FlashKernel, _FusedFlashKernel

    BH, i, j, dh = 3, 13, 17, 16
    q, k, v, key_bias = map(torch.from_numpy, folded_inputs(BH, i, j, dh, masked_bh=(2,)))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    gen = torch.Generator().manual_seed(0)
    gate = torch.randn(BH, i, dh, generator=gen).requires_grad_() if fused else None
    pair = torch.randn(BH, i, j, generator=gen).requires_grad_() if fused else None
    cot = torch.randn(BH, i, dh, generator=gen)
    leaves = [q, k, v] + ([gate, pair] if fused else [])
    scale = dh ** -0.5
    if fused:
        out = _FusedFlashKernel.apply(q, k, v, pair + key_bias[:, None, :], gate, scale)
    else:
        out = _FlashKernel.apply(q, k, v, key_bias, scale)
    got = torch.autograd.grad(out, leaves, cot)
    # the same attention through the dispatcher's plain route: B = BH, h = 1
    ref = flash_attention(q[:, :, None], k[:, :, None], v[:, :, None], key_bias,
                          pair_bias=None if pair is None else pair[:, None],
                          gate=None if gate is None else gate[:, :, None], scale=scale)
    want = torch.autograd.grad(ref[:, :, 0], leaves, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_cpu_tensors_never_build_or_launch(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(cuda_build, "build", no_build)
    monkeypatch.setattr(cuda_build, "library", no_build)
    flash_kernel.reset_launches()
    q, k, v, bias = map(torch.from_numpy, folded_inputs(2, 9, 11, 16))
    flash_kernel.flash_fwd(q, k, v, bias, 0.25)
    flash_kernel.flash_fwd_fused(q, k, v, bias, 0.25, gate=q.clone())
    out, lse = flash_kernel.flash_fwd(q, k, v, bias, 0.25)
    flash_kernel.flash_bwd(q, k, v, bias, out, lse, q.clone(), 0.25)
    flash_kernel.flash_bwd_fused(q, k, v, bias, q.clone(), out, lse, q.clone(), 0.25)
    t = q[None].transpose(1, 2).requires_grad_()
    flash_attention(t, k[None].transpose(1, 2), v[None].transpose(1, 2)).sum().backward()
    assert set(flash_kernel.LAUNCHES.values()) == {0}


def test_fold_gives_the_kernels_an_aligned_contiguous_copy():
    from alphafold2_tpu_torch.ops.flash import fold_heads

    base = torch.arange(1 + 2 * 5 * 1 * 8, dtype=torch.bfloat16)
    t = base[1:].view(2, 5, 1, 8)  # one head: the fold is a view at an odd offset
    f = fold_heads(t)
    assert f.shape == (2, 5, 8) and f.is_contiguous() and f.data_ptr() % 16 == 0
    assert torch.equal(f, t.transpose(1, 2).reshape(2, 5, 8))


def test_fused_needs_bias2d_or_gate_and_supported_shapes():
    q, k, v, bias = map(torch.from_numpy, folded_inputs(1, 4, 4, 16))
    with pytest.raises(ValueError, match="use flash_fwd"):
        flash_kernel.flash_fwd_fused(q, k, v, bias, 0.25)
    assert flash_kernel.supported(147456, 7680, 64)
    assert flash_kernel.supported(7680, 147456, 64)
    assert not flash_kernel.supported(16, 16, 8)
    assert not flash_kernel.supported(16, 16, 128)
    assert not flash_kernel.supported(16, 0, 64)


def _shaped(BH, i, j, dh, dtype=torch.bfloat16, bias2d=False, gated=False, bias_offset=0):
    """Arguments of route() at any size without the memory: stride-0 views of
    one element (route reads shapes, dtypes and the bias's base only)."""
    one = lambda n, d, dt=dtype: torch.zeros(1, dtype=dt).expand(BH, n, d)  # noqa: E731
    bias = (torch.zeros(1 + bias_offset)[bias_offset:].expand(BH, i, j) if bias2d
            else torch.zeros(1 + bias_offset)[bias_offset:].expand(BH, j))
    return one(i, dh), one(j, dh), one(j, dh), bias, one(i, dh) if gated else None


# the served bf16 shapes at L = 384 (chip_smoke.py SLICE_SHAPES), the 2-D
# bias pair case and the SP request's B3 hop, (BH, i, j)
SERVED = {
    "pair axial": ((3072, 384, 384), {}),
    "cross pair<-msa": ((8, 147456, 7680), {}),
    "cross msa<-pair": ((8, 7680, 147456), {}),
    "pair axial gated": ((3072, 384, 384), {"gated": True}),
    "cross pair<-msa gated": ((8, 147456, 7680), {"gated": True}),
    "pair axial bias2d": ((3072, 384, 384), {"bias2d": True}),
    "B3 hop L=384 P=4": ((8, 1920, 36864), {}),
    "training pair L=128": ((1024, 128, 128), {}),
}


@pytest.mark.parametrize("case", list(SERVED))
def test_route_takes_wgmma_on_every_served_shape(case):
    (BH, i, j), kw = SERVED[case]
    assert flash_kernel.route(*_shaped(BH, i, j, 64, **kw)) == "wgmma"


@pytest.mark.parametrize("case,args,want", [
    ("dh 16", dict(BH=4, i=20, j=20, dh=16), "mma_sync"),
    ("dh 32", dict(BH=3, i=131, j=120, dh=32), "mma_sync"),
    ("dh 32 bias2d", dict(BH=3, i=131, j=120, dh=32, bias2d=True), "mma_sync"),
    ("bias2d ragged j 77", dict(BH=5, i=131, j=77, dh=64, bias2d=True), "mma_sync"),
    ("bias2d misaligned base", dict(BH=5, i=131, j=120, dh=64, bias2d=True, bias_offset=1),
     "mma_sync"),
    ("key bias ragged j 77", dict(BH=5, i=131, j=77, dh=64), "wgmma"),
    ("key bias misaligned base", dict(BH=5, i=131, j=120, dh=64, bias_offset=1), "wgmma"),
    ("gated bias2d", dict(BH=5, i=131, j=120, dh=64, bias2d=True, gated=True), "wgmma"),
    ("f32", dict(BH=5, i=131, j=120, dh=64, dtype=torch.float32), "f32"),
    ("f32 bias2d", dict(BH=5, i=131, j=120, dh=64, dtype=torch.float32, bias2d=True), "f32"),
])
def test_route_off_the_served_shapes(case, args, want):
    """dh 16 and 32 and a 2-D bias TMA cannot address (16-byte rows need j
    % 4 == 0, a 16-byte base) take mma_sync; the key-side bias is read by
    plain loads, so its length and base do not matter; f32 takes f32."""
    assert flash_kernel.route(*_shaped(**args)) == want


def test_cpu_tensors_never_call_route(monkeypatch):
    """On CPU tensors the forwards run their plain version before any route
    is decided, and build or launch nothing."""
    def refused(*a, **k):
        raise AssertionError("a CPU call reached the CUDA route")

    monkeypatch.setattr(flash_kernel, "route", refused)
    monkeypatch.setattr(flash_kernel, "launch_fwd", refused)
    monkeypatch.setattr(cuda_build, "build", refused)
    monkeypatch.setattr(cuda_build, "library", refused)
    flash_kernel.reset_launches()
    q, k, v, bias = map(torch.from_numpy, folded_inputs(2, 9, 12, 64))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    pair = torch.zeros(2, 9, 12)
    flash_kernel.flash_fwd(q, k, v, bias, 0.125)
    flash_kernel.flash_fwd_lse(q, k, v, bias, 0.125)
    flash_kernel.flash_fwd_fused(q, k, v, pair, 0.125, gate=q.clone())
    assert set(flash_kernel.LAUNCHES.values()) == {0}


def test_launch_fwd_refuses_a_route_the_dtype_has_not():
    """A route named by a measurement must fit the dtype (the C entries
    would read float32 data as bfloat16); refused before any build."""
    q, k, v, bias = map(torch.from_numpy, folded_inputs(2, 9, 12, 64))
    with pytest.raises(ValueError, match="no 'wgmma' route for torch.float32"):
        flash_kernel.launch_fwd(q, k, v, bias, 0.125, None, "flash_fwd", which="wgmma")
    with pytest.raises(ValueError, match="no 'f32' route for torch.bfloat16"):
        flash_kernel.launch_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, 0.125, None,
                                "flash_fwd", which="f32")
    assert {r: flash_kernel.LAUNCHES[f"flash_fwd_{r}"] for r in flash_kernel.ROUTES} == {
        r: 0 for r in flash_kernel.ROUTES}


# the trained dkv shapes (BH, i, j): pair axial at crop 128 and 256 (BH =
# 8L), gated or not (the gate acts outside the kernel, so the call is the
# same), the 2-D-bias row of chip_smoke.py phase 3, and B3's ring gradient
# at the L = 128 hop
DKV_SHAPES = {
    "pair axial L=128": ((1024, 128, 128), False),
    "pair axial L=128 gated": ((1024, 128, 128), False),
    "pair axial L=256": ((2048, 256, 256), False),
    "pair axial L=256 gated": ((2048, 256, 256), False),
    "pair axial L=128 bias2d": ((1024, 128, 128), True),
    "B3 ring gradient L=128 P=4": ((8, 640, 4096), False),
}


@pytest.mark.parametrize("case", list(DKV_SHAPES))
def test_dkv_route_takes_wgmma_on_every_trained_shape(case):
    (BH, i, j), bias2d = DKV_SHAPES[case]
    q, k, v, bias, _ = _shaped(BH, i, j, 64, bias2d=bias2d)
    assert flash_kernel.dkv_route(q, k, v, bias) == "wgmma"


@pytest.mark.parametrize("case,args,want", [
    ("dh 16", dict(BH=4, i=20, j=20, dh=16), "mma_sync"),
    ("dh 32", dict(BH=3, i=7, j=1000, dh=32), "mma_sync"),
    ("bias2d j % 4 != 0", dict(BH=5, i=131, j=77, dh=64, bias2d=True), "mma_sync"),
    ("bias2d misaligned base", dict(BH=5, i=131, j=76, dh=64, bias2d=True, bias_offset=1),
     "mma_sync"),
    ("key bias ragged j 77", dict(BH=5, i=131, j=77, dh=64), "wgmma"),
    ("key bias misaligned base", dict(BH=5, i=131, j=76, dh=64, bias_offset=1), "wgmma"),
    ("f32", dict(BH=5, i=131, j=76, dh=64, dtype=torch.float32), "f32"),
    ("f32 bias2d", dict(BH=5, i=131, j=76, dh=64, dtype=torch.float32, bias2d=True), "f32"),
])
def test_dkv_route_off_the_trained_shapes(case, args, want):
    """dh 16 and 32 and a 2-D bias TMA cannot address take the mma_sync dkv
    kernel; the key-side bias is read by plain loads; f32 takes f32."""
    q, k, v, bias, _ = _shaped(**args)
    assert flash_kernel.dkv_route(q, k, v, bias) == want


def test_cpu_tensors_never_call_dkv_route(monkeypatch):
    """On CPU tensors the backwards (B1b, B2b, B3) run their plain versions
    before any dkv route is decided, and build or launch nothing."""
    def refused(*a, **k):
        raise AssertionError("a CPU call reached a CUDA dkv route")

    for name in ("dkv_route", "dq_route", "launch_dkv", "launch_dq", "route"):
        monkeypatch.setattr(flash_kernel, name, refused)
    monkeypatch.setattr(cuda_build, "build", refused)
    monkeypatch.setattr(cuda_build, "library", refused)
    flash_kernel.reset_launches()
    q, k, v, bias = map(torch.from_numpy, folded_inputs(2, 9, 12, 64))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out, lse = flash_kernel.flash_fwd_plain(q, k, v, bias, 0.125)
    g = torch.ones_like(q)
    pair = torch.zeros(2, 9, 12)
    flash_kernel.flash_bwd(q, k, v, bias, out, lse, g, 0.125)
    flash_kernel.flash_bwd_fused(q, k, v, pair, q.clone(), out, lse, g, 0.125)
    flash_kernel.flash_bwd_lse(q, k, v, bias, out, lse, g, torch.ones_like(lse), 0.125)
    assert set(flash_kernel.LAUNCHES.values()) == {0}


def test_launch_dkv_refuses_a_route_the_dtype_has_not():
    """A dkv route named by a measurement must fit the dtype (the C entries
    would read float32 data as bfloat16); refused before any build."""
    q, k, v, bias = map(torch.from_numpy, folded_inputs(2, 9, 12, 64))
    lse = torch.zeros(2, 9)
    with pytest.raises(ValueError, match="no 'wgmma' dkv route for torch.float32"):
        flash_kernel.launch_dkv(q, k, v, bias, lse, q, lse, 0.125, "flash_bwd_dkv",
                                which="wgmma")
    with pytest.raises(ValueError, match="no 'mma_sync' dkv route for torch.float32"):
        flash_kernel.launch_dkv(q, k, v, bias, lse, q, lse, 0.125, "flash_bwd_dkv",
                                which="mma_sync")
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    with pytest.raises(ValueError, match="no 'f32' dkv route for torch.bfloat16"):
        flash_kernel.launch_dkv(qb, kb, vb, bias, lse, qb, lse, 0.125, "flash_bwd_dkv",
                                which="f32")
    assert {r: flash_kernel.LAUNCHES[f"flash_bwd_dkv_{r}"] for r in flash_kernel.ROUTES} == {
        r: 0 for r in flash_kernel.ROUTES}


# the trained dq shapes (BH, i, j): pair axial at crop 128 and 256 (BH =
# 8L), gated or not (the gate acts outside the kernel, so the call is the
# same), the 2-D-bias row of chip_smoke.py phase 3, and B3's ring gradient
# at the L = 128 hop
DQ_SHAPES = {
    "pair axial L=128": ((1024, 128, 128), False),
    "pair axial L=128 gated": ((1024, 128, 128), False),
    "pair axial L=256": ((2048, 256, 256), False),
    "pair axial L=256 gated": ((2048, 256, 256), False),
    "pair axial L=128 bias2d": ((1024, 128, 128), True),
    "B3 ring gradient L=128 P=4": ((8, 640, 4096), False),
}


@pytest.mark.parametrize("case", list(DQ_SHAPES))
def test_dq_route_takes_wgmma_on_every_trained_shape(case):
    (BH, i, j), bias2d = DQ_SHAPES[case]
    q, k, v, bias, _ = _shaped(BH, i, j, 64, bias2d=bias2d)
    assert flash_kernel.dq_route(q, k, v, bias) == "wgmma"


@pytest.mark.parametrize("case,args,want", [
    ("dh 16", dict(BH=4, i=20, j=20, dh=16), "mma_sync"),
    ("dh 32", dict(BH=3, i=7, j=1000, dh=32), "mma_sync"),
    ("bias2d j % 4 != 0", dict(BH=5, i=131, j=77, dh=64, bias2d=True), "mma_sync"),
    ("bias2d misaligned base", dict(BH=5, i=131, j=76, dh=64, bias2d=True, bias_offset=1),
     "mma_sync"),
    ("bias2d ragged i", dict(BH=5, i=131, j=76, dh=64, bias2d=True), "wgmma"),
    ("key bias ragged j 77", dict(BH=5, i=131, j=77, dh=64), "wgmma"),
    ("key bias misaligned base", dict(BH=5, i=131, j=76, dh=64, bias_offset=1), "wgmma"),
    ("short i, long j", dict(BH=3, i=7, j=1000, dh=64), "wgmma"),
    ("f32", dict(BH=5, i=131, j=76, dh=64, dtype=torch.float32), "f32"),
    ("f32 bias2d", dict(BH=5, i=131, j=76, dh=64, dtype=torch.float32, bias2d=True), "f32"),
])
def test_dq_route_off_the_trained_shapes(case, args, want):
    """dh 16 and 32 and a 2-D bias TMA cannot address take the mma_sync dq
    kernel; the key-side bias is read by plain loads, so its base and j are
    free; f32 takes f32."""
    q, k, v, bias, _ = _shaped(**args)
    assert flash_kernel.dq_route(q, k, v, bias) == want


@pytest.mark.parametrize("gated", [False, True])
def test_cpu_tensors_never_call_dq_route(monkeypatch, gated):
    """On CPU tensors the dispatcher's backward (B1b, or B2b with a gate)
    runs the plain versions under autograd before any dq route is decided,
    and builds or launches nothing."""
    def refused(*a, **k):
        raise AssertionError("a CPU call reached a CUDA dq route")

    for name in ("dq_route", "launch_dq"):
        monkeypatch.setattr(flash_kernel, name, refused)
    monkeypatch.setattr(cuda_build, "library", refused)
    flash_kernel.reset_launches()
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 12, 2, 64, generator=gen, requires_grad=True) for _ in range(3))
    gate = torch.randn(1, 12, 2, 64, generator=gen) if gated else None
    flash_attention(q, k, v, gate=gate).sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    assert set(flash_kernel.LAUNCHES.values()) == {0}


def test_launch_dq_refuses_a_route_the_dtype_has_not():
    """A dq route named by a measurement must fit the dtype (the C entries
    would read float32 data as bfloat16); refused before any build."""
    q, k, v, bias = map(torch.from_numpy, folded_inputs(2, 9, 12, 64))
    lse = torch.zeros(2, 9)
    for which in ("wgmma", "mma_sync"):
        with pytest.raises(ValueError, match=f"no '{which}' dq route for torch.float32"):
            flash_kernel.launch_dq(q, k, v, bias, lse, q, lse, 0.125, "flash_bwd_dq",
                                   which=which)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    with pytest.raises(ValueError, match="no 'f32' dq route for torch.bfloat16"):
        flash_kernel.launch_dq(qb, kb, vb, bias, lse, qb, lse, 0.125, "flash_bwd_dq",
                               which="f32")
    with pytest.raises(ValueError, match="no 'tma' dq route"):
        flash_kernel.launch_dq(qb, kb, vb, bias, lse, qb, lse, 0.125, "flash_bwd_dq",
                               which="tma")
    assert {r: flash_kernel.LAUNCHES[f"flash_bwd_dq_{r}"] for r in flash_kernel.ROUTES} == {
        r: 0 for r in flash_kernel.ROUTES}


def test_launch_dq_checks_its_grid_against_i():
    """Off the wgmma route the dq kernel has a block per (bh, 128-query
    tile): a call whose query tiles overflow the grid is refused before any
    build (stride-0 views: no memory). The wgmma route's blocks are
    persistent, so the backward's own checks no longer refuse it."""
    BH, i, j = 2 ** 20, 2 ** 20, 1
    q, k, v, bias, _ = _shaped(BH, i, j, 64, dtype=torch.float32)
    lse = torch.zeros(1).expand(BH, i)
    with pytest.raises(ValueError, match="owned rows exceed the kernel grid"):
        flash_kernel.launch_dq(q, k, v, bias, lse, q, lse, 0.125, "flash_bwd_dq")
    assert flash_kernel.LAUNCHES["flash_bwd_dq_f32"] == 0


def test_dense_and_sparse_dq_share_one_wgmma_pipeline():
    """The dense dq kernel's wgmma route is csrc/flash_bwd_dq_wgmma.cuh's
    `wgmma_dq`, unlisted, the pipeline B5 dq runs listed: flash_bwd.cu
    includes the header, holds `flash_bwd_dq_wgmma_kernel` as a thin
    __global__ around `wgmma_dq<BIAS2D, false>` (unlisted) and launches it
    through `launch_wgmma_dq` with an empty stage list. Neither source holds a copy
    of the pipeline's stages, and the mma_sync dq kernel stays for dh 16 and
    32."""
    src = (cuda_build.CSRC / "flash_bwd.cu").read_text()
    assert '#include "flash_bwd_dq_wgmma.cuh"' in src
    body = src.split("flash_bwd_dq_wgmma_kernel(", 1)[1].split("\n}\n", 1)[0]
    assert body.count(";") == 1 and "af2::dq::wgmma_dq<BIAS2D, false>(" in body
    assert src.count("af2::dq::wgmma_dq<") == 1
    assert src.count("af2::dq::launch_wgmma_dq<") == 2 and "every{nullptr, nullptr, 1}" in src
    assert "flash_bwd_dq_bf16_kernel" in src
    header = (cuda_build.CSRC / "flash_bwd_dq_wgmma.cuh").read_text()
    for source in (src, (cuda_build.CSRC / "sparse_attn.cu").read_text()):
        for piece in ("wgmma_m64n64k16_ss(", "wgmma_m64n64k16_rs_mn(", "setmaxnreg",
                      "mbar_wait(full("):
            assert piece not in source and piece in header


def test_flash_ablation_variants_match_the_source():
    """The ablation tool's copies of csrc/flash_fwd.cu are cut from the
    source's own text: each fragment it changes is still there once, and
    every copy differs from the others."""
    from alphafold2_tpu_torch.telemetry import flash_ablation

    sources = flash_ablation.variants()
    assert set(sources) == {"base", "turn_products", "no_turns", "no_overlap", "no_ex2",
                            "no_pv", "no_qk", "counters"}
    assert len(set(sources.values())) == len(sources)
    assert sources["base"] == (cuda_build.CSRC / "flash_fwd.cu").read_text()
    assert "af2_ablation_counters" in sources["counters"]
    assert sources["counters"].count("T[7] += 1;") == 1
    # the copies inline the shared pipeline; turn_products moves all three turns
    for name in set(sources) - {"base"}:
        assert '#include "flash_fwd_wgmma.cuh"' not in sources[name]
    assert sources["turn_products"].count("turn_wait();") == 3
    assert "softmax(c + 1, on);\n        turn_pass();" not in sources["turn_products"]


def test_flash_ablation_needs_a_card(monkeypatch):
    from alphafold2_tpu_torch.telemetry import flash_ablation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        flash_ablation.main()


def test_launch_dkv_checks_its_grid_against_j():
    """Off the wgmma route the dkv kernel has a block per (bh, 128-key
    tile): a call whose key tiles overflow the grid is refused before any
    build, however short i is (stride-0 views: no memory)."""
    BH, i, j = 2 ** 20, 1, 2 ** 20
    q, k, v, bias, _ = _shaped(BH, i, j, 64, dtype=torch.float32)
    lse = torch.zeros(1).expand(BH, i)
    with pytest.raises(ValueError, match="owned rows exceed the kernel grid"):
        flash_kernel.launch_dkv(q, k, v, bias, lse, q, lse, 0.125, "flash_bwd_dkv")
    assert flash_kernel.LAUNCHES["flash_bwd_dkv_f32"] == 0


def test_dkv_ablation_variants_match_the_source():
    """The dkv ablation tool's copies of csrc/flash_bwd.cu inline the shared
    dkv pipeline (csrc/flash_bwd_dkv_wgmma.cuh) cut from its own text: each
    fragment it changes is still there once, and every copy differs from
    the others."""
    from alphafold2_tpu_torch.telemetry import dkv_ablation

    sources = dkv_ablation.variants()
    assert set(sources) == {"base", "turns", "no_overlap", "no_ex2", "no_ss", "no_rs",
                            "no_store", "counters"}
    assert len(set(sources.values())) == len(sources)
    assert sources["base"] == (cuda_build.CSRC / "flash_bwd.cu").read_text()
    assert "af2_ablation_counters" in sources["counters"]
    assert sources["counters"].count("T[7] += 1;") == 1
    for name in set(sources) - {"base"}:
        assert '#include "flash_bwd_dkv_wgmma.cuh"' not in sources[name]
        assert "void wgmma_dkv(" in sources[name]
    assert "wgmma_m64n64k16_ss(" not in sources["no_ss"]
    assert sources["turns"].count("turn_wait();") == 2
    base = cuda_build.CSRC / "flash_fwd.cu"
    assert dkv_ablation.variants(base)["baseline"] == base.read_text()


def test_dkv_ablation_dq_counters_match_the_source():
    """The dq counters copy of csrc/flash_bwd.cu inlines the dq pipeline
    (csrc/flash_bwd_dq_wgmma.cuh, run unlisted there) cut from its own
    text, with counters around each phase of both 64-key halves of a stage
    and the entry points that read them; the dkv pipeline stays included.
    The sparse tool's dq copy is the same cut of sparse_attn.cu."""
    from alphafold2_tpu_torch.telemetry import dkv_ablation, sparse_ablation

    copy = dkv_ablation.with_dq_counters((cuda_build.CSRC / "flash_bwd.cu").read_text())
    assert '#include "flash_bwd_dq_wgmma.cuh"' not in copy and "void wgmma_dq(" in copy
    assert '#include "flash_bwd_dkv_wgmma.cuh"' in copy
    assert copy.count("T[7] += 1;") == 1 and copy.count("T[3] += tn - tc;") == 2
    assert "af2::dq::g_phase" in copy and "af2_ablation_counters" in copy
    assert "af2::dq::wgmma_dq<BIAS2D, false>" in copy
    sparse_copy = sparse_ablation.backward_variants()["dq_counters"]
    assert sparse_copy == dkv_ablation.with_dq_counters(
        (cuda_build.CSRC / "sparse_attn.cu").read_text())


def test_dkv_ablation_needs_a_card(monkeypatch):
    from alphafold2_tpu_torch.telemetry import dkv_ablation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        dkv_ablation.main([])
