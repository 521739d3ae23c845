"""The port's int8 serving arm against the JAX package on the CPU: PTQ,
the int8 product, weight residency, and the model and pipeline on an
int8 tree.

Tolerances: PTQ values, scales and byte counts are bit-equal (the same
IEEE divisions and half-to-even rounding). The product: both sides compute
x @ (q * s) in f32; against JAX's Pallas kernel (interpret mode), which
scales the f32 sum once instead, within k * 2^-24 * s * sum |x||q| per
output (summation order), plus one bf16 ulp of the output in bf16. Model
logits: 5e-6 on valid pairs (tests/test_torch_model.py's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_apply as jax_apply
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.ops import quant as jquant
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_apply, params_from_jax
from alphafold2_tpu_torch import predict_structure
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.ops import dispatch, quant, quant_kernel
from alphafold2_tpu_torch.serving import quant_residency
from alphafold2_tpu_torch.training import harness
from chip_smoke import QUANT_SHAPES

SMALL = dict(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=32)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_tree(seed=0, **kw):
    jcfg = JaxConfig(**{**SMALL, **kw})
    return jcfg, jax_init(jax.random.PRNGKey(seed), jcfg)


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/list tree, in order."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _paths(val, f"{prefix}/{key}")
    elif isinstance(tree, (list, tuple)):
        for n, val in enumerate(tree):
            yield from _paths(val, f"{prefix}/{n}")
    else:
        yield prefix, tree


# --- PTQ -----------------------------------------------------------------------


@pytest.mark.parametrize("per_channel", [True, False], ids=["channel", "tensor"])
@pytest.mark.parametrize("shape", [(24, 16), (3, 24, 16), (1, 1)], ids=["2d", "stacked", "1x1"])
def test_quantize_weight_is_bit_equal_to_jax(shape, per_channel):
    w = _rand(shape, 0) * 3
    w[..., shape[-1] // 2] = 0.0  # an all-zero channel: scale 0, values 0
    if shape[-2] >= 3:
        # channel 0 (and the tensor) has amax 127, so scale 1: exact ties
        # that half-to-even rounding must break the same way
        w[..., :3, 0] = [127.0, 2.5, -3.5]
    jq, js = jquant.quantize_weight(w, per_channel=per_channel)
    tq, ts = quant.quantize_weight(torch.from_numpy(w), per_channel=per_channel)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(quant.dequantize_weight(tq, ts).numpy(),
                                  np.asarray(jquant.dequantize_weight(jq, js)))
    with pytest.raises(ValueError, match="2-D dense weight"):
        quant.quantize_weight(torch.ones(8))


@pytest.mark.parametrize("kw", [dict(), dict(attn_gate=True, cross_attn_compress_ratio=2)],
                         ids=["plain", "gate-compress"])
def test_quantize_tree_and_bytes_match_jax(kw):
    """The default selection (trunk dense weights; the KV conv and the head
    stay f32) rewrites the same leaves to the same bits, and the byte counts
    agree, on the f32 tree and on the quantized one."""
    jcfg, jparams = _jax_tree(**kw)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              Alphafold2Config(**SMALL, **kw), device="cpu")
    jq = jquant.quantize_tree(jparams)
    tq = quant.quantize_tree(tparams)
    jl, tl = list(_paths(jax.tree_util.tree_map(np.asarray, jq))), list(_paths(tq))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    n_q = 0
    for (path, want), (_, got) in zip(jl, tl):
        if path.endswith("/qw"):
            n_q += 1
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), want)
        elif path.endswith("compress/w"):
            assert got.dtype == torch.float32  # excluded by name, re-laid out by convert
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    assert n_q == sum(1 for p, _ in quant.iter_linear_dicts(tq) if "trunk" in p
                      and "compress" not in p)
    assert quant.tree_weight_bytes(tq) == jquant.tree_weight_bytes(jq)
    assert quant.tree_weight_bytes(tparams) == jquant.tree_weight_bytes(jparams)
    assert quant.quantized_path_bytes(tparams) == jquant.quantized_path_bytes(jparams)
    assert quant.quantized_path_bytes(tq) == jquant.quantized_path_bytes(jq)
    back = jax.tree_util.tree_map(np.asarray, jquant.dequantize_tree(jq))
    for (path, want), (_, got) in zip(_paths(back), _paths(quant.dequantize_tree(tq))):
        if not path.endswith("compress/w"):
            np.testing.assert_array_equal(got.numpy(), want)


# --- the product -----------------------------------------------------------------


def _bound(x, qw, scale, ref, dtype):
    """k * 2^-24 * s * sum |x||q| per output, plus one bf16 ulp in bf16."""
    k = x.shape[-1]
    absum = np.abs(np.asarray(x, np.float32)) @ np.abs(np.asarray(qw, np.float32))
    bound = k * 2.0 ** -24 * np.abs(np.asarray(scale, np.float32)) * absum
    if dtype == jnp.bfloat16:
        bound = bound + 2.0 ** -7 * np.abs(ref)
    return bound


@pytest.mark.parametrize("per_channel", [True, False], ids=["channel", "tensor"])
@pytest.mark.parametrize("m,k,n,dtype", [(16, 32, 16, jnp.float32), (40, 48, 80, jnp.float32),
                                         (40, 48, 80, jnp.bfloat16), (1, 256, 8, jnp.float32)])
def test_quant_matmul_plain_matches_jax(m, k, n, dtype, per_channel):
    w = _rand((k, n), m + n)
    w[:, n // 2] = 0.0
    jq, js = jquant.quantize_weight(w, per_channel=per_channel)
    x = jnp.asarray(_rand((m, k), 1), dtype)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = torch.from_numpy(np.array(x, np.float32)).to(tdtype)
    got = quant.quant_matmul(tx, torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)))
    assert got.dtype == tdtype and got.shape == (m, n)
    got = got.float().numpy()
    xla = np.asarray(jquant.quant_matmul(x, jq, js, use_kernel=False), np.float32)
    # the same dequantize-then-multiply in f32 on both sides
    assert np.abs(got - xla).max() <= (1e-6 * k if dtype == jnp.float32 else 2.0 ** -7 *
                                       np.abs(xla).max())
    pallas = np.asarray(jquant.quant_matmul(x, jq, js, use_kernel=True), np.float32)
    full = np.broadcast_to(np.asarray(js, np.float32).reshape(-1), (n,))
    assert (np.abs(got - pallas) <= _bound(x, jq, full, pallas, dtype)).all()
    assert (got[:, n // 2] == 0).all()


def _misaligned(m, k, dtype):
    """A contiguous (m, k) view whose data starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(m * k + 8, dtype=dtype)
    step = buf.element_size()
    start = next(i for i in range(1, 16) if (buf.data_ptr() + i * step) % 16 != 0)
    return buf[start:start + m * k].view(m, k)


@pytest.mark.parametrize("case", [
    *[("wgmma", m, k, n, torch.bfloat16, False) for m, k, n in QUANT_SHAPES.values()],
    ("cp_async", 1000, 200, 300, torch.bfloat16, False),
    ("cp_async", 1, 256, 8, torch.bfloat16, False),
    ("cp_async", 1000, 256, 512, torch.bfloat16, True),
    ("wgmma", 1, 256, 16, torch.bfloat16, False),
    ("f32", 147456, 256, 512, torch.float32, False),
    ("f32", 1000, 200, 300, torch.float32, False),
], ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-{str(c[4]).split('.')[-1]}"
                 + ("-misaligned" if c[5] else ""))
def test_quant_kernel_route(case):
    """Which B4 kernel a CUDA call takes, from shapes, dtype and alignment
    alone (no card needed): every served int8 shape (chip_smoke.py's
    QUANT_SHAPES, L = 384) in bf16 takes the wgmma kernel; bf16 shapes TMA
    cannot address (k % 8, n % 16, a base off a 16-byte boundary) take the
    cp.async kernel; f32 takes the CUDA-core kernel."""
    want, m, k, n, dtype, misaligned = case
    x = _misaligned(m, k, dtype) if misaligned else torch.empty((m, k), dtype=dtype)
    qw = torch.empty((k, n), dtype=torch.int8)
    scale = torch.empty(n)
    assert quant_kernel.unsupported(x, qw, scale) is None
    assert quant_kernel.route(x, qw) == want
    if misaligned:  # the kernel gets x as it is: a contiguous view is not copied
        assert x.contiguous().data_ptr() == x.data_ptr()
        # a non-contiguous x is copied (aligned) before the launch
        wide = torch.empty((m, k + 8), dtype=dtype)[:, 8:]
        assert quant_kernel.route(wide, qw) == "wgmma"


def test_quant_ablation_variants_match_the_source():
    """The ablation tool's copies of csrc/quant_matmul.cu are cut from the
    source's own text: each fragment it takes out is still there once."""
    from alphafold2_tpu_torch.telemetry import quant_ablation

    sources = quant_ablation.variants()
    assert set(sources) == {"base", "no_convert", "no_epilogue", "no_store", "counters"}
    assert len({s for s in sources.values()}) == len(sources)
    assert "af2_ablation_counters" in sources["counters"]


def test_quant_kernel_route_refuses_float16():
    x = torch.empty((4, 256), dtype=torch.float16)
    qw = torch.empty((256, 512), dtype=torch.int8)
    assert "torch.float16" in quant_kernel.unsupported(x, qw, torch.empty(512))


def test_quant_matmul_shapes_scalar_scale_and_casts():
    w = _rand((24, 16), 4)
    qw, s = quant.quantize_weight(torch.from_numpy(w), per_channel=False)
    x = torch.from_numpy(_rand((2, 5, 24), 5))
    got = quant.quant_matmul(x, qw, s)
    assert got.shape == (2, 5, 16)
    want = quant.quant_matmul_plain(x.reshape(10, 24), qw, s.expand(16))
    torch.testing.assert_close(got.reshape(10, 16), want, rtol=0, atol=0)
    assert quant.quant_matmul(x, qw, s, dtype=torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="one \\(d_in, d_out\\) weight slice"):
        quant.quant_matmul(x, qw[None], s)
    with pytest.raises(ValueError, match="d_in"):
        quant.quant_matmul(x[..., :20], qw, s)


def test_quant_matmul_backward_raises():
    qw, s = quant.quantize_weight(torch.from_numpy(_rand((8, 4), 0)))
    x = torch.ones((3, 8), requires_grad=True)
    y = quant.quant_matmul(x, qw, s)
    with pytest.raises(NotImplementedError, match="inference-only"):
        y.sum().backward()


def test_dispatch_rule():
    """CPU tensors take the plain version; CUDA tensors take the kernel or
    raise naming what it does not take (no card is needed to check the
    rule); there is no request that sends a CUDA tensor to the plain
    version."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for op in ("flash_attention", "quant_matmul", "sparse_attention"):
        assert dispatch.resolve(op, cpu) == dispatch.PLAIN
        assert dispatch.resolve(op, cpu, "anything") == dispatch.PLAIN
        assert dispatch.resolve(op, cuda) == dispatch.KERNEL
        with pytest.raises(ValueError, match="does not take dtype x"):
            dispatch.resolve(op, cuda, "dtype x")
        with pytest.raises(ValueError, match="runs on cpu or cuda"):
            dispatch.resolve(op, torch.device("meta"))
    with pytest.raises(ValueError, match="unknown kernel op"):
        dispatch.resolve("conv", cpu)
    with pytest.raises(TypeError):
        quant.quant_matmul(torch.ones((2, 8)), torch.ones((8, 4), dtype=torch.int8),
                           torch.ones(4), use_kernel=False)


# --- residency -------------------------------------------------------------------


def test_resident_params_cache_and_identity_revalidation():
    quant_residency.clear_residency_cache()
    _, jparams = _jax_tree(depth=1)
    cfg = Alphafold2Config(**{**SMALL, "depth": 1}, weight_dtype="int8")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    tree, info = quant_residency.resident_params(params, cfg)
    assert info["weight_dtype"] == "int8" and not info["cached"]
    assert info["weight_bytes"] == quant.tree_weight_bytes(tree) < info["fp32_weight_bytes"]
    again, info2 = quant_residency.resident_params(params, cfg)
    assert again is tree and info2["cached"] and info2["tag"] == info["tag"]
    # a new source object under the same tag is quantized anew
    copy = quant.dequantize_tree(quant.quantize_tree(params, select=lambda p, w: False))
    fresh, info3 = quant_residency.resident_params(copy, cfg)
    assert fresh is not tree and not info3["cached"]
    # another tag misses; an f32 config serves the tree itself
    other, info4 = quant_residency.resident_params(params, cfg, params_tag="ckpt-2")
    assert other is not tree and info4["tag"] != info["tag"]
    f32_cfg = Alphafold2Config(**{**SMALL, "depth": 1})
    same, info5 = quant_residency.resident_params(params, f32_cfg)
    assert same is params and info5["weight_bytes"] == info5["fp32_weight_bytes"]
    assert quant_residency.residency_tag(cfg).startswith("int8-")
    quant_residency.clear_residency_cache()


# --- the model and the pipeline on an int8 tree ---------------------------------------


def _inputs(L=12, rows=3, pad=3):
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 20, (1, L)).astype(np.int32)
    mask = np.ones((1, L), bool)
    mask[:, L - pad:] = False
    msa = rng.integers(0, 21, (1, rows, L)).astype(np.int32)
    msa_mask = rng.random((1, rows, L)) > 0.2
    msa_mask[:, 0] = mask
    return seq, mask, msa, msa_mask


@pytest.mark.parametrize("kw", [dict(attn_flash=False), dict(attn_flash=True, attn_gate=True)],
                         ids=["dense", "flash-gate"])
def test_int8_model_matches_jax(kw):
    """The port's resident int8 tree against JAX's `quantize_tree(params)`,
    and a JAX int8 tree mapped over by `params_from_jax` (int8 leaves kept)
    computing exactly what the port's own tree computes."""
    jcfg = JaxConfig(**SMALL, **kw, weight_dtype="int8")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tcfg = Alphafold2Config(**SMALL, **kw, weight_dtype="int8")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    tq, _ = quant_residency.resident_params(tparams, tcfg)
    seq, mask, msa, msa_mask = _inputs()
    jl = np.asarray(jax_apply(jquant.quantize_tree(jparams), jcfg, seq, msa, mask=mask,
                              msa_mask=msa_mask))
    tl = alphafold2_apply(tq, tcfg, seq, msa, mask=mask, msa_mask=msa_mask, device="cpu")
    pair = mask[:, :, None] & mask[:, None, :]
    np.testing.assert_allclose(tl.numpy()[pair], jl[pair], rtol=0, atol=5e-6)

    converted = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jquant.quantize_tree(jparams)), tcfg, device="cpu")
    for a, b in zip(tree_leaves(converted), tree_leaves(tq)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    cl = alphafold2_apply(converted, tcfg, seq, msa, mask=mask, msa_mask=msa_mask, device="cpu")
    assert torch.equal(cl, tl)
    quant_residency.clear_residency_cache()


def test_predict_structure_int8_on_cpu():
    """An int8 request on the CPU: finite outputs, and the same logits as
    the f32 model on the dequantized tree (the plain product is x @
    dequant(q), the same f32 function)."""
    cfg = Alphafold2Config(**SMALL, weight_dtype="int8")
    f32_cfg = Alphafold2Config(**SMALL)
    params = quant.quantize_tree(
        params_from_jax(jax.tree_util.tree_map(np.asarray, _jax_tree()[1]), cfg, device="cpu"))
    seq, mask, msa, msa_mask = _inputs()
    out = predict_structure(params, cfg, seq, mask=mask, msa=msa, msa_mask=msa_mask,
                            mds_iters=5, device="cpu")
    ref = predict_structure(quant.dequantize_tree(params), f32_cfg, seq, mask=mask, msa=msa,
                            msa_mask=msa_mask, mds_iters=5, device="cpu")
    assert out["coords"].shape == (1, 12, 3)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    torch.testing.assert_close(out["distogram_logits"], ref["distogram_logits"], rtol=0,
                               atol=1e-6)


def test_training_refuses_int8():
    cfg = Alphafold2Config(**SMALL, weight_dtype="int8")
    tt = harness.TrainConfig(grad_accum=1)
    with pytest.raises(ValueError, match="make_train_step: weight_dtype='int8'"):
        harness.make_train_step(cfg, tt, device="cpu")
    with pytest.raises(ValueError, match="train_state_init: weight_dtype='int8'"):
        harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="inference-only"):
        quant.reject_quant_training(type("E2E", (), {"model": cfg})(), "e2e")
    quant.reject_quant_training(Alphafold2Config(**SMALL), "f32 passes")


def test_config_checks():
    assert Alphafold2Config(**SMALL, weight_dtype="int8").weight_dtype == "int8"
    with pytest.raises(ValueError, match="weight_dtype"):
        Alphafold2Config(**SMALL, weight_dtype="fp8")
    with pytest.raises(ValueError, match="attn_gate is not supported with sparse"):
        Alphafold2Config(**SMALL, attn_gate=True, sparse_self_attn=(True, False))


def test_predict_cli_int8_on_cpu(capsys, tmp_path):
    from alphafold2_tpu_torch import predict

    predict.main(["--seq", "MKTAYIAKQRQI", "--dim", "16", "--depth", "1", "--heads", "2",
                  "--dim-head", "8", "--mds-iters", "3", "--device", "cpu",
                  "--weight-dtype", "int8", "--out", str(tmp_path / "s.pdb")])
    out = capsys.readouterr().out
    assert "weights: int8" in out and "in f32" in out
    assert (tmp_path / "s.pdb").exists()
