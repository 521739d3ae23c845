"""The port's CUDA kernels against their plain versions, on the card: the
flash-attention kernels (B1, B2), the int8 product (B4), the
block-sparse attention kernels (B5) and the lse flash kernels of the ring
hops (B3), with ring attention over 4 shards on one card against 4 CPU
shards.

These tests need a CUDA device and skip on a host without one (the
kernels have no CPU mode). They import only torch and the port, so they
run on a GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from alphafold2_tpu_torch.ops import flash_kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def folded_inputs(BH, i, j, dh, device, seed=0, masked_bh=()):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)  # noqa: E731
    q, k, v = t(BH, i, dh), t(BH, j, dh), t(BH, j, dh)
    keep = rng.random((BH, j)) < 0.8
    keep[:, 0] = True
    for b in masked_bh:
        keep[b] = False
    bias = torch.from_numpy(np.where(keep, 0.0, -np.inf).astype(np.float32)).to(device)
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "gate", "bias2d", "gate+bias2d"])
def test_kernels_match_plain_on_card(cuda_device, dh, dtype, mode):
    """Kernel vs plain version on the same inputs. f32: both compute in f32
    (bound 1e-5). bf16: the kernel rounds the probabilities to bf16 for the
    P.V product (error ~2^-9 of the output's spread) and both round the
    output once; bound one bf16 ulp of the largest output (2^-7 relative).
    lse 1e-4."""
    BH, i, j = 6, 200, 77
    q, k, v, bias = folded_inputs(BH, i, j, dh, cuda_device, masked_bh=(4,))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    gate = torch.randn_like(q) if "gate" in mode else None
    if "bias2d" in mode:
        bias = (torch.randn(BH, i, j, device=cuda_device) + bias[:, None, :]).contiguous()
    name = "flash_fwd" if mode == "plain" else "flash_fwd_fused"
    fn = getattr(flash_kernel, name)
    args = (q, k, v, bias, dh ** -0.5) + ((gate,) if name == "flash_fwd_fused" else ())
    which = flash_kernel.route(q, k, v, bias, gate)
    before = dict(flash_kernel.LAUNCHES)
    out, lse = fn(*args)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES[name] == before[name] + 1
    assert flash_kernel.LAUNCHES[f"flash_fwd_{which}"] == before[f"flash_fwd_{which}"] + 1
    ref_out, ref_lse = flash_kernel.flash_fwd_plain(q, k, v, bias, dh ** -0.5, gate)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * ref_out.float().abs().max().item()
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert torch.equal(torch.isposinf(lse), torch.isposinf(ref_lse))
    assert (out[4] == 0).all() and torch.isposinf(lse[4]).all()
    fin = torch.isfinite(ref_lse)
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("mode", ["plain", "gate", "bias2d", "gate+bias2d"])
@pytest.mark.parametrize("BH,i", [(5, 131), (140, 383)], ids=["128-row tiles", "192-row tiles"])
def test_bf16_forward_routes_match_plain_on_card(cuda_device, which, mode, BH, i):
    """Both bf16 forward kernels on one call that `route` sends to wgmma
    (dh 64, j % 4 == 0: ragged i and j = 120, a fully masked bh, with a 2-D
    bias a fully masked query row), each held against the plain version
    with the bounds of test_kernels_match_plain_on_card; the launch counts
    under the wrapper's key and the route's, and no other. 140 x 383 fills
    an H100's 132 SMs with 192-row tiles, so without a 2-D bias the wgmma
    kernel runs three consumer warpgroups there (two at 5 x 131)."""
    j, dh = 120, 64
    q, k, v, bias = folded_inputs(BH, i, j, dh, cuda_device, seed=1, masked_bh=(1,))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    gate = torch.randn_like(q) if "gate" in mode else None
    if "bias2d" in mode:
        bias = (torch.randn(BH, i, j, device=cuda_device) + bias[:, None, :]).contiguous()
        bias[0, 3] = float("-inf")
    assert flash_kernel.route(q, k, v, bias, gate) == "wgmma"
    name = "flash_fwd" if mode == "plain" else "flash_fwd_fused"
    before = dict(flash_kernel.LAUNCHES)
    out, lse = flash_kernel.launch_fwd(q, k, v, bias, dh ** -0.5, gate, name, which=which)
    torch.cuda.synchronize()
    counted = {key: n - before[key] for key, n in flash_kernel.LAUNCHES.items()}
    assert counted == {key: int(key in (name, f"flash_fwd_{which}")) for key in counted}
    ref_out, ref_lse = flash_kernel.flash_fwd_plain(q, k, v, bias, dh ** -0.5, gate)
    tol = 2.0 ** -7 * ref_out.float().abs().max().item()
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert torch.equal(torch.isposinf(lse), torch.isposinf(ref_lse))
    assert (out[1] == 0).all() and torch.isposinf(lse[1]).all()
    if "bias2d" in mode:
        assert (out[0, 3] == 0).all() and torch.isposinf(lse[0, 3])
    fin = torch.isfinite(ref_lse)
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_wgmma_route_refuses_what_tma_cannot_address(cuda_device):
    """Forced onto the wgmma route, a call it cannot take (dh 32; a 2-D bias
    with j % 4 != 0) is refused by the C entry and raises; nothing counts."""
    q, k, v, bias = folded_inputs(2, 20, 77, 64, cuda_device)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    before = dict(flash_kernel.LAUNCHES)
    pair = torch.zeros(2, 20, 77, device=cuda_device)
    with pytest.raises(RuntimeError, match="wgmma route"):
        flash_kernel.launch_fwd(q, k, v, pair, 0.125, None, "flash_fwd_fused", which="wgmma")
    half = [x[..., :32].contiguous() for x in (q, k, v)]
    with pytest.raises(RuntimeError, match="wgmma route"):
        flash_kernel.launch_fwd(*half, bias, 0.125, None, "flash_fwd", which="wgmma")
    assert dict(flash_kernel.LAUNCHES) == before


@pytest.mark.cuda
def test_unsupported_shape_raises_on_card(cuda_device):
    q, k, v, bias = folded_inputs(2, 8, 8, 8, cuda_device)
    with pytest.raises(ValueError, match="does not support"):
        flash_kernel.flash_fwd(q, k, v, bias, 0.3)
    q, k, v, bias = folded_inputs(2, 8, 8, 16, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        flash_kernel.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, bias, 0.3)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:].view_as(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_kernel.flash_fwd(shifted, k, v, bias, 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "gate", "bias2d", "gate+bias2d"])
def test_backward_kernels_match_plain_on_card(cuda_device, dh, dtype, mode):
    """Each backward kernel pair (B1b for "plain", B2b otherwise) against
    `flash_bwd_plain` on the same inputs and the forward kernel's out and
    lse. f32: 1e-5 * max(1, max|ref|) per output (both in f32, another
    summation order). bf16: the elementwise bound of
    `chip_smoke.flash_bwd_bf16_bound` (the kernels round dS and P to bf16 before their
    products). d_bias is f32 on both sides: 1e-5 * max(1, max|ref|). d_gate
    is the same elementwise code on both sides. The fully masked (bh) row 4
    has zero gradients."""
    BH, i, j = 6, 200, 77
    q, k, v, bias = folded_inputs(BH, i, j, dh, cuda_device, masked_bh=(4,))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    gate = torch.randn_like(q) if "gate" in mode else None
    if "bias2d" in mode:
        bias = (torch.randn(BH, i, j, device=cuda_device) + bias[:, None, :]).contiguous()
        bias[0, 3] = float("-inf")  # a fully masked query row
    scale = dh ** -0.5
    if mode == "plain":
        out, lse = flash_kernel.flash_fwd(q, k, v, bias, scale)
    else:
        out, lse = flash_kernel.flash_fwd_fused(q, k, v, bias, scale, gate)
    g = torch.randn_like(q)
    before = dict(flash_kernel.LAUNCHES)
    if mode == "plain":
        dq, dk, dv = flash_kernel.flash_bwd(q, k, v, bias, out, lse, g, scale)
        d_bias = d_gate = None
        names = ("flash_bwd_dq", "flash_bwd_dkv")
    else:
        dq, dk, dv, d_bias, d_gate = flash_kernel.flash_bwd_fused(
            q, k, v, bias, gate, out, lse, g, scale)
        names = ("flash_bwd_fused_dq", "flash_bwd_fused_dkv")
    torch.cuda.synchronize()
    for name in names:
        assert flash_kernel.LAUNCHES[name] == before[name] + 1
    ref = flash_kernel.flash_bwd_plain(q, k, v, bias, out, lse, g, scale, gate)
    if dtype == torch.float32:
        bounds = [1e-5 * max(1.0, r.abs().max().item()) for r in ref[:3]]
    else:
        from chip_smoke import flash_bwd_bf16_bound

        bounds = flash_bwd_bf16_bound(q, k, v, bias, out, lse, g, scale, gate)
    for got, want, bound in zip((dq, dk, dv), ref[:3], bounds):
        assert torch.isfinite(got).all()
        assert ((got.float() - want.float()).abs() <= bound).all()
    for got in (dq, dk, dv):
        assert (got[4] == 0).all()
    if "bias2d" in mode:
        tol = 1e-5 * max(1.0, ref[3].abs().max().item())
        assert (d_bias - ref[3]).abs().max().item() <= tol
        assert (d_bias[0, 3] == 0).all()
    else:
        assert d_bias is None
    if gate is not None:
        assert torch.equal(d_gate, ref[4])


DKV_SHAPES = {  # (BH, i, j): ragged; past one wave of 128-key tiles; i < 64, long j
    "ragged": (5, 131, 76),
    "past one wave": (140, 383, 383),
    "short i, long j": (3, 7, 1000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("mode", ["plain", "gate", "bias2d", "gate+bias2d"])
@pytest.mark.parametrize("shape", list(DKV_SHAPES))
def test_bf16_dkv_routes_match_plain_on_card(cuda_device, which, mode, shape):
    """Both bf16 dkv kernels on one call, after the forward kernel, against
    `flash_bwd_dkv_plain` under the elementwise bound of
    `chip_smoke.flash_bwd_bf16_bound` (the kernels round dS and P to bf16
    before their products); the launch counts under the wrapper's key and
    the route's, and no other. The (bh) row 1 has every key masked: exact
    zeros; with a 2-D bias query row 3 of bh 0 is fully masked. Where
    `dkv_route` does not give wgmma (a 2-D bias with j % 4 != 0), the
    forced wgmma launch is refused and nothing counts."""
    BH, i, j = DKV_SHAPES[shape]
    dh, scale = 64, 0.125
    q, k, v, bias = folded_inputs(BH, i, j, dh, cuda_device, seed=2, masked_bh=(1,))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    gate = torch.randn_like(q) if "gate" in mode else None
    if "bias2d" in mode:
        bias = (torch.randn(BH, i, j, device=cuda_device) + bias[:, None, :]).contiguous()
        bias[0, 3] = float("-inf")
    if mode == "plain":
        out, lse = flash_kernel.flash_fwd(q, k, v, bias, scale)
    else:
        out, lse = flash_kernel.flash_fwd_fused(q, k, v, bias, scale, gate)
    g = torch.randn_like(q)
    g_eff, delta, _ = flash_kernel.cotangent_terms(out, g, gate)
    name = "flash_bwd_dkv" if mode == "plain" else "flash_bwd_fused_dkv"
    args = (q, k, v, bias, lse, g_eff, delta, scale, name)
    before = dict(flash_kernel.LAUNCHES)
    if which == "wgmma" and flash_kernel.dkv_route(q, k, v, bias) != "wgmma":
        with pytest.raises(RuntimeError, match="wgmma route"):
            flash_kernel.launch_dkv(*args, which=which)
        assert dict(flash_kernel.LAUNCHES) == before
        return
    dk, dv = flash_kernel.launch_dkv(*args, which=which)
    torch.cuda.synchronize()
    counted = {key: n - before[key] for key, n in flash_kernel.LAUNCHES.items()}
    assert counted == {key: int(key in (name, f"flash_bwd_dkv_{which}")) for key in counted}
    ref = flash_kernel.flash_bwd_dkv_plain(q, k, v, bias, lse, g_eff, delta, scale)
    from chip_smoke import flash_bwd_bf16_bound

    bounds = flash_bwd_bf16_bound(q, k, v, bias, out, lse, g, scale, gate)[1:]
    for got, want, bound in zip((dk, dv), ref, bounds):
        assert torch.isfinite(got).all()
        assert ((got.float() - want.float()).abs() <= bound).all()
        assert (got[1] == 0).all()


@pytest.mark.cuda
def test_wgmma_dkv_route_refuses_what_tma_cannot_address(cuda_device):
    """Forced onto the wgmma dkv route, a call it cannot take (dh 32; a 2-D
    bias with j % 4 != 0; a 2-D bias off a 16-byte boundary) is refused by
    the C entry and raises; nothing counts."""
    q, k, v, bias = folded_inputs(2, 20, 77, 64, cuda_device)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    lse = torch.zeros(2, 20, device=cuda_device)
    before = dict(flash_kernel.LAUNCHES)
    pair = torch.zeros(2, 20, 77, device=cuda_device)
    with pytest.raises(RuntimeError, match="wgmma route"):
        flash_kernel.launch_dkv(q, k, v, pair, lse, q, lse, 0.125, "flash_bwd_fused_dkv",
                                which="wgmma")
    k4, v4 = (x[:, :76].contiguous() for x in (k, v))
    shifted = torch.zeros(2 * 20 * 76 + 1, device=cuda_device)[1:].view(2, 20, 76)
    with pytest.raises(RuntimeError, match="wgmma route"):
        flash_kernel.launch_dkv(q, k4, v4, shifted, lse, q, lse, 0.125, "flash_bwd_fused_dkv",
                                which="wgmma")
    half = [x[..., :32].contiguous() for x in (q, k, v)]
    with pytest.raises(RuntimeError, match="wgmma route"):
        flash_kernel.launch_dkv(*half, bias, lse, half[0], lse, 0.125, "flash_bwd_dkv",
                                which="wgmma")
    assert dict(flash_kernel.LAUNCHES) == before


DQ_SHAPES = {  # (BH, i, j): ragged; i < 64, long j; past one wave of 128-query tiles
    "ragged": (5, 131, 76),
    "short i, long j": (3, 7, 1000),
    "past one wave": (140, 383, 383),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("mode", ["plain", "gate", "lse", "bias2d", "gate+bias2d"])
@pytest.mark.parametrize("shape", list(DQ_SHAPES))
def test_bf16_dq_routes_match_plain_on_card(cuda_device, which, mode, shape):
    """Both bf16 dq kernels on one call, after the forward kernel, against
    `flash_bwd_dq_plain` under the elementwise bound of
    `chip_smoke.flash_bwd_bf16_bound` (the kernels round dS to bf16 before
    dS.K): B1b ("plain"), gated B2b (the gate folded into the cotangent)
    and B3 ("lse": delta - g_lse with a nonzero g_lse), and B2b's 2-D bias
    with d_bias (f32 on both sides: 1e-5 * max(1, max|ref|)); the launch
    counts under the wrapper's key and the route's, and no other. The (bh)
    row 1 has every key masked: exact zeros, never NaN; with a 2-D bias
    query row 3 of bh 0 is fully masked. Where `dq_route` does not give
    wgmma (a 2-D bias with j % 4 != 0), the forced wgmma launch is refused
    and nothing counts."""
    BH, i, j = DQ_SHAPES[shape]
    dh, scale = 64, 0.125
    q, k, v, bias = folded_inputs(BH, i, j, dh, cuda_device, seed=4, masked_bh=(1,))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    gate = torch.randn_like(q) if "gate" in mode else None
    if "bias2d" in mode:
        bias = (torch.randn(BH, i, j, device=cuda_device) + bias[:, None, :]).contiguous()
        bias[0, 3] = float("-inf")
    if mode in ("plain", "lse"):
        out, lse = flash_kernel.flash_fwd(q, k, v, bias, scale)
    else:
        out, lse = flash_kernel.flash_fwd_fused(q, k, v, bias, scale, gate)
    g = torch.randn_like(q)
    g_lse = torch.randn(lse.shape, device=cuda_device) if mode == "lse" else None
    g_eff, delta, _ = flash_kernel.cotangent_terms(out, g, gate)
    if mode == "lse":
        delta = flash_kernel.lse_delta(out, g, g_lse).contiguous()
    name = {"plain": "flash_bwd_dq", "lse": "flash_bwd_lse_dq"}.get(mode, "flash_bwd_fused_dq")
    args = (q, k, v, bias, lse, g_eff, delta, scale, name)
    before = dict(flash_kernel.LAUNCHES)
    if which == "wgmma" and flash_kernel.dq_route(q, k, v, bias) != "wgmma":
        with pytest.raises(RuntimeError, match="wgmma route"):
            flash_kernel.launch_dq(*args, which=which)
        assert dict(flash_kernel.LAUNCHES) == before
        return
    dq, d_bias = flash_kernel.launch_dq(*args, which=which)
    torch.cuda.synchronize()
    counted = {key: n - before[key] for key, n in flash_kernel.LAUNCHES.items()}
    assert counted == {key: int(key in (name, f"flash_bwd_dq_{which}")) for key in counted}
    ref, ref_bias = flash_kernel.flash_bwd_dq_plain(q, k, v, bias, lse, g_eff, delta, scale)
    from chip_smoke import flash_bwd_bf16_bound

    bound = flash_bwd_bf16_bound(q, k, v, bias, out, lse, g, scale, gate, g_lse)[0]
    assert torch.isfinite(dq).all()
    assert ((dq.float() - ref.float()).abs() <= bound).all()
    assert (dq[1] == 0).all()
    if "bias2d" in mode:
        tol = 1e-5 * max(1.0, ref_bias.abs().max().item())
        assert (d_bias - ref_bias).abs().max().item() <= tol
        assert (d_bias[1] == 0).all() and (d_bias[0, 3] == 0).all()
    else:
        assert d_bias is None


@pytest.mark.cuda
def test_wgmma_dq_route_refuses_what_tma_cannot_address(cuda_device):
    """Forced onto the wgmma dq route, a call it cannot take (dh 32; q or
    dO off a 16-byte boundary; a 2-D bias with j % 4 != 0 or off a 16-byte
    boundary) is refused by the C entry and raises; nothing counts."""
    q, k, v, bias = folded_inputs(2, 20, 76, 64, cuda_device)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    lse = torch.zeros(2, 20, device=cuda_device)
    before = dict(flash_kernel.LAUNCHES)
    half = [x[..., :32].contiguous() for x in (q, k, v)]
    with pytest.raises(RuntimeError, match="wgmma route"):
        flash_kernel.launch_dq(*half, bias, lse, half[0], lse, 0.125, "flash_bwd_dq",
                               which="wgmma")
    shifted = torch.zeros(2 * 20 * 64 + 1, device=cuda_device,
                          dtype=torch.bfloat16)[1:].view(2, 20, 64)
    for q_, g_ in ((shifted, q), (q, shifted)):
        with pytest.raises(RuntimeError, match="wgmma route"):
            flash_kernel.launch_dq(q_, k, v, bias, lse, g_, lse, 0.125, "flash_bwd_dq",
                                   which="wgmma")
    k7, v7 = (torch.cat([x, x[:, :1]], 1) for x in (k, v))
    pair = torch.zeros(2, 20, 77, device=cuda_device)
    with pytest.raises(RuntimeError, match="wgmma route"):
        flash_kernel.launch_dq(q, k7, v7, pair, lse, q, lse, 0.125, "flash_bwd_fused_dq",
                               which="wgmma")
    shifted = torch.zeros(2 * 20 * 76 + 1, device=cuda_device)[1:].view(2, 20, 76)
    with pytest.raises(RuntimeError, match="wgmma route"):
        flash_kernel.launch_dq(q, k, v, shifted, lse, q, lse, 0.125, "flash_bwd_fused_dq",
                               which="wgmma")
    assert dict(flash_kernel.LAUNCHES) == before


@pytest.mark.cuda
def test_backward_on_card_raises_instead_of_falling_back(cuda_device, monkeypatch):
    """With the backward launch refused, loss.backward() on CUDA tensors
    raises; it never takes the plain route."""
    from alphafold2_tpu_torch.ops import flash

    def refused(*args, **kwargs):
        raise RuntimeError("backward kernel refused")

    def plain_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached flash_bwd_plain")

    monkeypatch.setattr(flash_kernel, "launch_dq", refused)
    monkeypatch.setattr(flash_kernel, "flash_bwd_plain", plain_called)
    q, k, v = (torch.randn(1, 16, 2, 16, device=cuda_device, requires_grad=True)
               for _ in range(3))
    for gate in (None, torch.randn(1, 16, 2, 16, device=cuda_device)):
        out = flash.flash_attention(q, k, v, gate=gate)
        with pytest.raises(RuntimeError, match="refused"):
            out.sum().backward()


# --- B4: the int8-weight product -----------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,per_tensor,bf16_route", [
    (1000, 200, 300, False, "cp_async"), (256, 256, 2048, False, "wgmma"),
    (37, 64, 16, True, "wgmma"), (1, 8, 3, False, "cp_async"),
    (1000, 256, 512, False, "wgmma"), (1000, 1024, 256, False, "wgmma"),
    (1, 256, 16, False, "wgmma")])
def test_quant_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n, per_tensor, bf16_route):
    """Kernel vs `quant_matmul_plain` on the same inputs, elementwise within
    `chip_smoke.quant_bound` (summation order: k * 2^-24 * s * sum |x||q|,
    plus one bf16 ulp of the output in bf16); an all-zero channel gives
    exact zeros. bf16 takes the wgmma kernel where TMA can address the
    tensors (ragged m, n = 16 and k = 1024 among them) and the cp.async
    kernel elsewhere; f32 its own; the launch counts under its route."""
    from alphafold2_tpu_torch.ops import quant, quant_kernel
    from chip_smoke import quant_bound

    rng = np.random.default_rng(m + n)
    w = rng.normal(size=(k, n)).astype(np.float32)
    w[:, n // 2] = 0.0
    qw, scale = quant.quantize_weight(torch.from_numpy(w), per_channel=not per_tensor)
    qw, scale = qw.to(cuda_device), scale.to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda_device, dtype)
    which = bf16_route if dtype == torch.bfloat16 else "f32"
    assert quant_kernel.route(x, qw) == which
    before = dict(quant_kernel.LAUNCHES)
    y = quant.quant_matmul(x, qw, scale)
    torch.cuda.synchronize()
    assert {name: n - before[name] for name, n in quant_kernel.LAUNCHES.items()} == {
        name: int(name in ("quant_matmul", f"quant_matmul_{which}")) for name in before}
    full = scale.float().reshape(-1).expand(n).contiguous()
    ref = quant_kernel.quant_matmul_plain(x, qw, full)
    assert y.dtype == dtype and y.shape == (m, n)
    assert ((y.float() - ref.float()).abs() <= quant_bound(x, qw, full, ref)).all()
    assert (y[:, n // 2] == 0).all()


@pytest.mark.cuda
def test_quant_kernel_misaligned_x_takes_cp_async(cuda_device):
    """A contiguous bf16 x whose base is off a 16-byte boundary (TMA cannot
    address it) runs on the cp.async kernel, within `quant_bound`."""
    from alphafold2_tpu_torch.ops import quant, quant_kernel
    from chip_smoke import quant_bound

    m, k, n = 1000, 256, 512
    rng = np.random.default_rng(7)
    qw, scale = quant.quantize_weight(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)))
    qw, scale = qw.to(cuda_device), scale.to(cuda_device)
    buf = torch.empty(m * k + 8, dtype=torch.bfloat16, device=cuda_device)
    x = buf[1:1 + m * k].view(m, k)
    x.copy_(torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)))
    assert quant_kernel.route(x, qw) == "cp_async"
    before = quant_kernel.LAUNCHES["quant_matmul_cp_async"]
    y = quant.quant_matmul(x, qw, scale)
    torch.cuda.synchronize()
    assert quant_kernel.LAUNCHES["quant_matmul_cp_async"] == before + 1
    ref = quant_kernel.quant_matmul_plain(x, qw, scale)
    assert ((y.float() - ref.float()).abs() <= quant_bound(x, qw, scale, ref)).all()


@pytest.mark.cuda
def test_quant_kernel_rejects_what_it_does_not_take(cuda_device):
    from alphafold2_tpu_torch.ops import quant

    qw = torch.ones((8, 4), dtype=torch.int8, device=cuda_device)
    scale = torch.ones(4, device=cuda_device)
    with pytest.raises(ValueError, match="does not take activations of dtype torch.float16"):
        quant.quant_matmul(torch.ones((2, 8), dtype=torch.float16, device=cuda_device), qw, scale)
    with pytest.raises(ValueError, match="int8"):
        quant.quant_matmul(torch.ones((2, 8), device=cuda_device), qw.float(), scale)


# --- B5: block-sparse attention ------------------------------------------------


def sparse_inputs(bs, dh, dtype, device, b=3, heads=2, n_blocks=6, seed=0):
    """Folded q, k, v, a key bias with batch element 1 fully masked, the
    kernels' table of a genuinely sparse layout, and a cotangent."""
    from alphafold2_tpu_torch.ops import sparse

    scfg = sparse.SparseConfig(block_size=bs, num_local_blocks=2, num_random_blocks=1,
                               max_seq_len=n_blocks * bs)
    n = n_blocks * bs
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, dtype)  # noqa: E731
    q, k, v, g = (t(b * heads, n, dh) for _ in range(4))
    keep = rng.random((b, n)) < 0.8
    keep[1] = False
    bias = torch.from_numpy(np.where(keep, 0.0, -np.inf).astype(np.float32)).to(device)
    table = sparse.kernel_table(n_blocks, scfg, str(device))
    return q, k, v, g, bias, table, heads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_sparse_kernels_match_plain_on_card(cuda_device, bs, dh, dtype):
    """B5f against `sparse_fwd_plain` (f32 1e-5; bf16 one bf16 ulp of the
    largest output; lse 1e-4) and B5 dq / dkv against `sparse_bwd_plain`
    (f32 1e-5 * max(1, max|ref|); bf16 `chip_smoke.sparse_bwd_bf16_bound`).
    The fully masked batch element (heads 2, 3) gives zeros, lse = +inf
    and zero gradients."""
    from alphafold2_tpu_torch.ops import sparse_kernel as sk
    from chip_smoke import sparse_bwd_bf16_bound

    q, k, v, g, bias, table, heads = sparse_inputs(bs, dh, dtype, cuda_device)
    scale = dh ** -0.5
    before = dict(sk.LAUNCHES)
    out, lse = sk.sparse_fwd(q, k, v, bias, table, heads, scale)
    dq, dk, dv = sk.sparse_bwd(q, k, v, bias, table, heads, out, lse, g, scale)
    torch.cuda.synchronize()
    which = sk.bwd_route(q, table)
    counted = ("sparse_fwd", f"sparse_fwd_{sk.route(q, table)}", "sparse_bwd_dq", "sparse_bwd_dkv",
               f"sparse_bwd_dq_{which}", f"sparse_bwd_dkv_{which}")
    assert {name: sk.LAUNCHES[name] - before[name] for name in before} == {
        name: int(name in counted) for name in before}
    ref_out, ref_lse = sk.sparse_fwd_plain(q, k, v, bias, table, heads, scale)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * ref_out.float().abs().max().item()
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert torch.equal(torch.isposinf(lse), torch.isposinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= 1e-4
    assert (out[2:4] == 0).all() and torch.isposinf(lse[2:4]).all()
    ref = sk.sparse_bwd_plain(q, k, v, bias, table, heads, out, lse, g, scale)
    if dtype == torch.float32:
        bounds = [1e-5 * max(1.0, r.abs().max().item()) for r in ref]
    else:
        bounds = sparse_bwd_bf16_bound(q, k, v, bias, table, heads, out, lse, g, scale)
    for got, want, bound in zip((dq, dk, dv), ref, bounds):
        assert torch.isfinite(got).all()
        assert ((got.float() - want.float()).abs() <= bound).all()
        assert (got[2:4] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,bs", [(64, 16), (32, 32), (16, 64)])
def test_sparse_dropout_kernels_match_plain_on_card(cuda_device, bs, dh, dtype, rate):
    """B5f, B5 dq and B5 dkv with attention dropout against the plain
    versions with the same seed tensor (the same keep bits, `philox_keep`),
    at the tolerances of test_sparse_kernels_match_plain_on_card (bf16
    backward: `chip_smoke.sparse_dropout_bf16_bound`, the bound on the
    dropped function). lse is the undropped one's; rate 0 gives the kernels
    without dropout bit for bit; each launch is counted under its dropout
    count too; the masked batch element gives zeros."""
    from alphafold2_tpu_torch.ops import sparse
    from alphafold2_tpu_torch.ops import sparse_kernel as sk
    from chip_smoke import sparse_dropout_bf16_bound

    q, k, v, g, bias, table, heads = sparse_inputs(bs, dh, dtype, cuda_device)
    scale = dh ** -0.5
    seed = sparse.draw_seed(torch.Generator(device=cuda_device).manual_seed(3), cuda_device)
    drop = dict(dropout_rate=rate, seed=seed)
    before = dict(sk.LAUNCHES)
    out, lse = sk.sparse_fwd(q, k, v, bias, table, heads, scale, **drop)
    dq, dk, dv = sk.sparse_bwd(q, k, v, bias, table, heads, out, lse, g, scale, **drop)
    torch.cuda.synchronize()
    for name in ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv"):
        assert sk.LAUNCHES[f"{name}_dropout"] == before[f"{name}_dropout"] + 1
    ref_out, ref_lse = sk.sparse_fwd_plain(q, k, v, bias, table, heads, scale, **drop)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * ref_out.float().abs().max().item()
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    fin = torch.isfinite(ref_lse)
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= 1e-4
    plain_out, plain_lse = sk.sparse_fwd(q, k, v, bias, table, heads, scale)
    assert torch.equal(lse, plain_lse) and not torch.equal(out, plain_out)
    zero = sk.sparse_fwd(q, k, v, bias, table, heads, scale, dropout_rate=0.0, seed=seed)
    assert torch.equal(zero[0], plain_out) and torch.equal(zero[1], plain_lse)
    assert (out[2:4] == 0).all() and torch.isposinf(lse[2:4]).all()
    if dtype == torch.float32:
        ref = sk.sparse_bwd_plain(q, k, v, bias, table, heads, out, lse, g, scale, **drop)
        bounds = [1e-5 * max(1.0, r.abs().max().item()) for r in ref]
    else:
        ref, bounds = sparse_dropout_bf16_bound(q, k, v, bias, table, heads, out, lse, g, scale,
                                                rate, seed)
    for got, want, bound in zip((dq, dk, dv), ref, bounds):
        assert torch.isfinite(got).all()
        assert ((got.float() - want.float()).abs() <= bound).all()
        assert (got[2:4] == 0).all()


# the wgmma route's cases: (b, heads, n, max_seq_len, masked batch elements)
WGMMA_CASES = {
    "global row (8, 4096, 64)": (1, 8, 4096, 2048, ()),
    "BH 3": (3, 1, 384, 384, ()),
    "BH 3, long": (3, 1, 1024, 512, ()),
    "n 16, one block": (2, 2, 16, 16, (1,)),
    "ragged tile n 208": (3, 2, 208, 256, (1,)),
    "masked element": (3, 2, 384, 384, (1,)),
    "masked element, long": (3, 2, 1024, 512, (1,)),
    "served pair axial (3072, 384, 64)": (384, 8, 384, 384, ()),
    "trained pair axial (2048, 256, 64)": (256, 8, 256, 256, ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_sparse_wgmma_route_matches_plain_on_card(cuda_device, case):
    """B5f's wgmma route (a tile's listed stages on wgmma, the unattended
    pairs masked) against `sparse_fwd_plain` under phase 3's tolerance (one
    bf16 ulp of the largest output, lse 1e-4), the masked batch elements
    giving zeros and lse = +inf; one launch counted on the route. The
    mma_sync route on the same call agrees too."""
    from alphafold2_tpu_torch.ops import sparse, sparse_kernel as sk

    b, heads, n, msl, masked = WGMMA_CASES[case]
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        cuda_device, torch.bfloat16)
    q, k, v = (t(b * heads, n, 64) for _ in range(3))
    keep = rng.random((b, n)) >= 0.05
    keep[:, 0] = True
    for i in masked:
        keep[i] = False
    bias = torch.from_numpy(np.where(keep, 0.0, -np.inf).astype(np.float32)).to(cuda_device)
    idx, valid = sparse.layout_block_indices(n // 16, sparse.SparseConfig(block_size=16,
                                                                          max_seq_len=msl))
    table = sk.block_table(idx, valid, 16, cuda_device)
    assert sk.route(q, table) == "wgmma"
    before = dict(sk.LAUNCHES)
    out, lse = sk.sparse_fwd(q, k, v, bias, table, heads, 0.125)
    torch.cuda.synchronize()
    assert {name: sk.LAUNCHES[name] - before[name] for name in before} == {
        name: int(name in ("sparse_fwd", "sparse_fwd_wgmma")) for name in before}
    ref_out, ref_lse = sk.sparse_fwd_plain(q, k, v, bias, table, heads, 0.125)
    tol = 2.0 ** -7 * ref_out.float().abs().max().item()
    fin = torch.isfinite(ref_lse)
    for got_out, got_lse in ((out, lse),
                             sk.sparse_fwd(q, k, v, bias, table, heads, 0.125, which="mma_sync")):
        assert torch.isfinite(got_out).all()
        assert (got_out.float() - ref_out.float()).abs().max().item() <= tol
        assert torch.equal(torch.isposinf(got_lse), torch.isposinf(ref_lse))
        assert (got_lse[fin] - ref_lse[fin]).abs().max().item() <= 1e-4
    for i in masked:
        rows = slice(i * heads, (i + 1) * heads)
        assert (out[rows] == 0).all() and torch.isposinf(lse[rows]).all()
    again = sk.sparse_fwd(q, k, v, bias, table, heads, 0.125)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)  # deterministic


# the backward's wgmma route's cases: (b, heads, n, max_seq_len, masked batch elements)
BWD_WGMMA_CASES = {
    "trained pair axial (2048, 256, 64)": (256, 8, 256, 256, ()),
    "global row (8, 4096, 64)": (1, 8, 4096, 2048, ()),
    "masked element n 1024": (3, 2, 1024, 512, (1,)),
    "ragged n 400 (25 blocks)": (3, 2, 400, 512, (1,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_WGMMA_CASES))
def test_sparse_bwd_routes_match_plain_on_card(cuda_device, case):
    """B5 dq and B5 dkv on both bf16 routes, wgmma (which `bwd_route`
    picks: a tile's listed stages, the unattended pairs masked) and
    mma_sync, on the same inputs against `sparse_bwd_dq_plain` and
    `sparse_bwd_dkv_plain` under phase 3's bound
    (`chip_smoke.sparse_bwd_bf16_bound`); the masked batch elements give
    exact zeros; each launch counted under its route; the wgmma route is
    deterministic."""
    from alphafold2_tpu_torch.ops import sparse, sparse_kernel as sk
    from chip_smoke import sparse_bwd_bf16_bound

    b, heads, n, msl, masked = BWD_WGMMA_CASES[case]
    rng = np.random.default_rng(5)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        cuda_device, torch.bfloat16)
    q, k, v, g = (t(b * heads, n, 64) for _ in range(4))
    keep = rng.random((b, n)) >= 0.05
    keep[:, 0] = True
    for i in masked:
        keep[i] = False
    bias = torch.from_numpy(np.where(keep, 0.0, -np.inf).astype(np.float32)).to(cuda_device)
    table = sparse.kernel_table(n // 16, sparse.SparseConfig(block_size=16, max_seq_len=msl),
                                str(cuda_device))
    assert sk.bwd_route(q, table) == "wgmma"
    out, lse = sk.sparse_fwd(q, k, v, bias, table, heads, 0.125)
    delta = flash_kernel.cotangent_terms(out, g)[1]
    args = (q, k, v, bias, table, heads, lse, g, delta, 0.125)
    refs = (sk.sparse_bwd_dq_plain(*args),) + sk.sparse_bwd_dkv_plain(*args)
    bounds = sparse_bwd_bf16_bound(q, k, v, bias, table, heads, out, lse, g, 0.125)
    for which in ("wgmma", "mma_sync"):
        before = dict(sk.LAUNCHES)
        grads = (sk.launch_dq(*args, which=which),) + sk.launch_dkv(*args, which=which)
        torch.cuda.synchronize()
        counted = ("sparse_bwd_dq", "sparse_bwd_dkv", f"sparse_bwd_dq_{which}",
                   f"sparse_bwd_dkv_{which}")
        assert {name: sk.LAUNCHES[name] - before[name] for name in before} == {
            name: int(name in counted) for name in before}
        for got, want, bound in zip(grads, refs, bounds):
            assert torch.isfinite(got).all()
            assert ((got.float() - want.float()).abs() <= bound).all(), which
            for i in masked:
                assert (got[i * heads:(i + 1) * heads] == 0).all()
        if which == "wgmma":
            again = (sk.launch_dq(*args),) + sk.launch_dkv(*args)
            assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
def test_sparse_unsupported_raises_on_card(cuda_device):
    from alphafold2_tpu_torch.ops import sparse_kernel as sk

    q, k, v, g, bias, table, heads = sparse_inputs(16, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="dim_head=8"):
        sk.sparse_fwd(q[..., :8].contiguous(), k[..., :8].contiguous(),
                      v[..., :8].contiguous(), bias, table, heads, 0.3)
    odd = dataclasses.replace(table, block_size=8)
    with pytest.raises(ValueError, match="block_size=8"):
        sk.sparse_fwd(q, k, v, bias, odd, heads, 0.3)


@pytest.mark.cuda
def test_card_routes_raise_instead_of_falling_back(cuda_device, monkeypatch):
    """With the launches refused, the int8 product, the sparse attention
    (forward through sparse_attention_apply, backward through autograd) and
    the flash backward's wgmma dkv and dq kernels raise on CUDA tensors; they
    never take their plain versions or another route."""
    from alphafold2_tpu_torch.ops import quant, quant_kernel, sparse, sparse_kernel
    from alphafold2_tpu_torch.ops.attention import AttentionConfig, attention_init

    def refused(*args, **kwargs):
        raise RuntimeError("kernel refused")

    def plain_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(quant_kernel, "launch", refused)
    monkeypatch.setattr(quant, "quant_matmul_plain", plain_called)
    with pytest.raises(RuntimeError, match="refused"):
        quant.quant_matmul(torch.ones((4, 8), device=cuda_device),
                           torch.ones((8, 4), dtype=torch.int8, device=cuda_device),
                           torch.ones(4, device=cuda_device))

    monkeypatch.setattr(sparse, "block_sparse_attention", plain_called)
    monkeypatch.setattr(sparse_kernel, "sparse_fwd_plain", plain_called)
    monkeypatch.setattr(sparse_kernel, "sparse_bwd_plain", plain_called)
    monkeypatch.setattr(sparse_kernel, "launch_dq", refused)
    cfg = AttentionConfig(dim=16, heads=2, dim_head=16)
    params = attention_init(torch.Generator().manual_seed(0), cfg, cuda_device)
    scfg = sparse.SparseConfig(block_size=16, max_seq_len=64)
    x = torch.randn(2, 40, 16, device=cuda_device, requires_grad=True)
    out = sparse.sparse_attention_apply(params, cfg, scfg, x)
    with pytest.raises(RuntimeError, match="refused"):
        out.sum().backward()
    monkeypatch.setattr(sparse_kernel, "_lib", refused)
    with pytest.raises(RuntimeError, match="refused"):
        sparse.sparse_attention_apply(params, cfg, scfg, x)

    # a failed wgmma dkv launch raises; the mma_sync dkv kernel is never tried
    real = flash_kernel._bwd_lib()

    class RefusingDkv:
        af2_flash_bwd_dq = real.af2_flash_bwd_dq
        af2_flash_bwd_dq_wgmma = real.af2_flash_bwd_dq_wgmma

        @staticmethod
        def af2_flash_bwd_dkv_wgmma(*args):
            return 98  # cudaErrorInvalidDeviceFunction

        @staticmethod
        def af2_flash_bwd_dkv(*args):
            raise AssertionError("the wgmma dkv launch fell back to the mma_sync kernel")

    monkeypatch.setattr(flash_kernel, "_bwd_lib", RefusingDkv)
    monkeypatch.setattr(flash_kernel, "flash_bwd_plain", plain_called)
    monkeypatch.setattr(flash_kernel, "flash_bwd_dkv_plain", plain_called)
    from alphafold2_tpu_torch.ops import flash

    qkv = [torch.randn(1, 32, 2, 64, device=cuda_device, dtype=torch.bfloat16,
                       requires_grad=True) for _ in range(3)]
    with pytest.raises(RuntimeError, match="wgmma route"):
        flash.flash_attention(*qkv).float().sum().backward()

    # a failed wgmma dq launch raises; the mma_sync dq kernel is never tried
    class RefusingDq:
        @staticmethod
        def af2_flash_bwd_dq_wgmma(*args):
            return 98  # cudaErrorInvalidDeviceFunction

        @staticmethod
        def af2_flash_bwd_dq(*args):
            raise AssertionError("the wgmma dq launch fell back to the mma_sync kernel")

    monkeypatch.setattr(flash_kernel, "_bwd_lib", RefusingDq)
    monkeypatch.setattr(flash_kernel, "flash_bwd_dq_plain", plain_called)
    with pytest.raises(RuntimeError, match="wgmma route"):
        flash.flash_attention(*qkv).float().sum().backward()

    # a failed launch on the sparse forward's wgmma route raises; the
    # mma_sync kernel is never tried
    class RefusingSparse:
        @staticmethod
        def af2_sparse_fwd_wgmma(*args):
            return 98  # cudaErrorInvalidDeviceFunction

        @staticmethod
        def af2_sparse_fwd(*args):
            raise AssertionError("the wgmma launch fell back to the mma_sync kernel")

    monkeypatch.setattr(sparse_kernel, "_lib", RefusingSparse)
    cfg64 = AttentionConfig(dim=128, heads=2, dim_head=64, dtype=torch.bfloat16)
    params64 = attention_init(torch.Generator().manual_seed(0), cfg64, cuda_device)
    x64 = torch.randn(2, 40, 128, device=cuda_device)
    with pytest.raises(RuntimeError, match="wgmma route"):
        sparse.sparse_attention_apply(params64, cfg64, scfg, x64)


@pytest.mark.cuda
def test_sparse_dropout_runs_the_kernels_on_card(cuda_device, monkeypatch):
    """Live attention dropout on a CUDA tensor runs B5f, B5 dq and B5 dkv
    with their dropout (each launch counted under its dropout count), never
    a plain or the gather version; the seed is drawn from the layer's
    generator on the card, so the same generator state gives the same
    output and gradients, another another. make_train_step takes a sparse
    config with attention dropout and its step runs the dropout kernels."""
    from alphafold2_tpu_torch import Alphafold2Config
    from alphafold2_tpu_torch.ops import sparse, sparse_kernel
    from alphafold2_tpu_torch.ops.attention import AttentionConfig, attention_init
    from alphafold2_tpu_torch.training import data, harness

    def plain_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for module, name in ((sparse, "block_sparse_attention"),
                         (sparse_kernel, "sparse_fwd_plain"), (sparse_kernel, "sparse_bwd_plain"),
                         (sparse_kernel, "sparse_bwd_dq_plain"),
                         (sparse_kernel, "sparse_bwd_dkv_plain")):
        monkeypatch.setattr(module, name, plain_called)
    cfg = AttentionConfig(dim=16, heads=2, dim_head=16, dropout=0.1)
    params = attention_init(torch.Generator().manual_seed(0), cfg, cuda_device)
    scfg = sparse.SparseConfig(block_size=16, max_seq_len=64)
    x = torch.randn(2, 40, 16, device=cuda_device, requires_grad=True)
    outs, grads = [], []
    for seed in (1, 1, 2):
        before = dict(sparse_kernel.LAUNCHES)
        rng = torch.Generator(device=cuda_device).manual_seed(seed)
        out = sparse.sparse_attention_apply(params, cfg, scfg, x, rng=rng)
        grads.append(torch.autograd.grad(out.sum(), x)[0])
        outs.append(out.detach())
        torch.cuda.synchronize()
        for name in ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv"):
            assert sparse_kernel.LAUNCHES[f"{name}_dropout"] == before[f"{name}_dropout"] + 1
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])
    assert not torch.equal(outs[0], outs[2])
    model = Alphafold2Config(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=64,
                             sparse_self_attn=True, attn_dropout=0.1)
    tcfg = harness.TrainConfig(grad_accum=1)
    state = harness.train_state_init(model, tcfg, torch.Generator().manual_seed(0), cuda_device)
    step = harness.make_train_step(model, tcfg, device=cuda_device)
    batch = data.synthetic_microbatch_fn(data.DataConfig(max_len=48, seed=2), 1)(0)
    before = sparse_kernel.LAUNCHES["sparse_fwd_dropout"]
    _, metrics = step(state, batch, torch.Generator().manual_seed(4))
    assert torch.isfinite(metrics["loss"])
    assert sparse_kernel.LAUNCHES["sparse_fwd_dropout"] > before


# --- B3: the lse flash kernels of the ring hops ----------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_kernels_match_plain_on_card(cuda_device, dh, dtype):
    """B3: `flash_fwd_lse` against flash_fwd_plain (tolerances as the B1
    forward's) and `flash_bwd_lse` with a random lse cotangent against
    `flash_bwd_lse_plain` (f32 1e-5 * max(1, max|ref|); bf16 the elementwise
    `chip_smoke.flash_bwd_bf16_bound` with g_lse). The fully masked (bh) row
    4 gives zeros, lse = +inf and zero gradients whatever its g_lse."""
    BH, i, j = 6, 200, 77
    q, k, v, bias = folded_inputs(BH, i, j, dh, cuda_device, masked_bh=(4,))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    scale = dh ** -0.5
    before = dict(flash_kernel.LAUNCHES)
    out, lse = flash_kernel.flash_fwd_lse(q, k, v, bias, scale)
    g = torch.randn_like(q)
    g_lse = torch.randn(lse.shape, device=cuda_device)
    dq, dk, dv = flash_kernel.flash_bwd_lse(q, k, v, bias, out, lse, g, g_lse, scale)
    torch.cuda.synchronize()
    for name in ("flash_fwd_lse", "flash_bwd_lse_dq", "flash_bwd_lse_dkv"):
        assert flash_kernel.LAUNCHES[name] == before[name] + 1
    ref_out, ref_lse = flash_kernel.flash_fwd_plain(q, k, v, bias, scale)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * ref_out.float().abs().max().item()
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert torch.equal(torch.isposinf(lse), torch.isposinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= 1e-4
    ref = flash_kernel.flash_bwd_lse_plain(q, k, v, bias, out, lse, g, g_lse, scale)
    if dtype == torch.float32:
        bounds = [1e-5 * max(1.0, r.abs().max().item()) for r in ref]
    else:
        from chip_smoke import flash_bwd_bf16_bound

        bounds = flash_bwd_bf16_bound(q, k, v, bias, out, lse, g, scale, g_lse=g_lse)
    for got, want, bound in zip((dq, dk, dv), ref, bounds):
        assert torch.isfinite(got).all()
        assert ((got.float() - want.float()).abs() <= bound).all()
        assert (got[4] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_attention_on_card_matches_cpu_shards(cuda_device, dtype):
    """ring_attention over 4 shards on one card (["cuda:0"] * 4: every hop
    through B3, every merge and ppermute real) against 4 CPU shards (the
    plain version under autograd): output and the gradient of
    sum(out^2), one shard's keys fully masked. f32: 1e-5 * max(1,
    max|ref|); bf16 (inputs rounded once, compared with the CPU's f32 on
    the same rounded inputs): each hop's output is rounded to bf16 before
    its merge and the kernels round P (and dS) to bf16, so 2^-5 of the
    largest output and of each largest gradient."""
    from alphafold2_tpu_torch.parallel import make_mesh, ring_attention

    P, n = 4, 256
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, n, 2, 64, generator=gen).to(dtype).float() for _ in range(3))
    mask = torch.rand(1, n, generator=gen) >= 0.1
    mask[:, n // P:2 * n // P] = False
    res = {}
    for dev, dt in (("cuda", dtype), ("cpu", torch.float32)):
        mesh = make_mesh({"seq": P}, devices=[dev] * P)
        leaves = [x.to(dev, dt).requires_grad_() for x in (q, k, v)]
        if dev == "cuda":
            before = dict(flash_kernel.LAUNCHES)
        out = mesh.unshard(ring_attention(*(mesh.shard(x, 1) for x in leaves), mesh,
                                          masks=mesh.shard(mask.to(dev), 1)), 1)
        grads = torch.autograd.grad((out.float() ** 2).sum(), leaves)
        res[dev] = [t.detach().float().cpu() for t in (out,) + grads]
        if dev == "cuda":
            torch.cuda.synchronize()
            for name in ("flash_fwd_lse", "flash_bwd_lse_dq", "flash_bwd_lse_dkv"):
                assert flash_kernel.LAUNCHES[name] == before[name] + P * P
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    for got, want in zip(res["cuda"], res["cpu"]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= rel * max(1.0, want.abs().max().item())


@pytest.mark.cuda
def test_ring_on_card_raises_instead_of_falling_back(cuda_device, monkeypatch):
    """A CUDA tensor on the ring reaches B3 or raises: with the plain
    forward made to fail, the kernel still carries the hops; with the
    launch refused, the ring raises; a head width the kernel lacks raises
    a ValueError naming it."""
    from alphafold2_tpu_torch.parallel import make_mesh, ring_attention

    def plain_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    def refused(*args, **kwargs):
        raise RuntimeError("kernel refused")

    monkeypatch.setattr(flash_kernel, "flash_fwd_plain", plain_called)
    monkeypatch.setattr(flash_kernel, "flash_bwd_lse_plain", plain_called)
    mesh = make_mesh({"seq": 2}, devices=[cuda_device] * 2)
    q = torch.randn(1, 32, 2, 16, device=cuda_device, requires_grad=True)
    out = mesh.unshard(ring_attention(mesh.shard(q, 1), mesh.shard(q, 1), mesh.shard(q, 1),
                                      mesh), 1)
    out.sum().backward()
    assert torch.isfinite(q.grad).all()
    with pytest.raises(ValueError, match="merge_lse"):
        x = torch.randn(1, 32, 2, 8, device=cuda_device)
        ring_attention(mesh.shard(x, 1), mesh.shard(x, 1), mesh.shard(x, 1), mesh)
    monkeypatch.setattr(flash_kernel, "_lib", refused)
    with pytest.raises(RuntimeError, match="refused"):
        ring_attention(mesh.shard(q, 1), mesh.shard(q, 1), mesh.shard(q, 1), mesh)
