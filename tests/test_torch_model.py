"""The PyTorch port's model forward against the JAX package on the same
parameters (alphafold2_init -> params_from_jax) and inputs, in float32 on
the CPU.

Tolerance: the two sides compute the same float32 function in another
summation order (XLA vs ATen matmuls over widths <= 256), so logits agree
to ~5e-7; the bound is 5e-6 absolute on logits of magnitude ~1-3.
Comparisons cover valid residue pairs only: on masked query rows the dense
path (uniform attention) and the flash path (key-side masking only)
legitimately give different finite garbage (ops/flash.py contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_apply as jax_apply
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_apply, params_from_jax

ATOL = 5e-6
SMALL = dict(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=32)


def make_params(seed=0, **kw):
    cfg_kw = {**SMALL, **kw}
    jparams = jax_init(jax.random.PRNGKey(seed), JaxConfig(**cfg_kw))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = Alphafold2Config(**cfg_kw)
    return jparams, JaxConfig(**cfg_kw), params_from_jax(tree, tcfg, device="cpu"), tcfg


def make_inputs(L=12, rows=3, b=1, seed=1, pad=3):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 20, (b, L)).astype(np.int32)
    mask = np.ones((b, L), bool)
    if pad:
        mask[:, L - pad:] = False
    msa = rng.integers(0, 21, (b, rows, L)).astype(np.int32)
    msa_mask = rng.random((b, rows, L)) > 0.2
    msa_mask[:, 0] = mask
    return seq, mask, msa, msa_mask


def run_both(jparams, jcfg, tparams, tcfg, seq, mask, msa=None, msa_mask=None):
    jl = jax.jit(lambda p, s, m, mm, mk: jax_apply(p, jcfg, s, m, mask=mk, msa_mask=mm))(
        jparams, seq, msa, msa_mask, mask
    )
    tl = alphafold2_apply(tparams, tcfg, seq, msa, mask=mask, msa_mask=msa_mask,
                          device="cpu")
    return np.asarray(jl), tl.numpy()


def assert_valid_close(jl, tl, mask, atol=ATOL):
    assert tl.shape == jl.shape
    assert np.isfinite(tl).all()
    pair = mask[:, :, None] & mask[:, None, :]
    np.testing.assert_allclose(tl[pair], jl[pair], rtol=0, atol=atol)


@pytest.mark.parametrize(
    "kw",
    [
        dict(attn_flash=False),
        dict(attn_flash=True),
        dict(attn_flash=True, attn_gate=True),
        dict(attn_flash=False, attn_gate=True),
        dict(attn_flash=True, cross_attn_mode="aligned"),
        dict(attn_flash=False, cross_attn_mode="aligned", msa_tie_row_attn=True),
        dict(attn_flash=True, cross_attn_compress_ratio=2, ff_chunk_size=50,
             attn_batch_chunk=5),
    ],
    ids=["dense", "flash", "flash-gate", "dense-gate", "aligned-flash",
         "aligned-dense-tied", "compressed-chunked"],
)
def test_logits_with_msa(kw):
    jparams, jcfg, tparams, tcfg = make_params(**kw)
    seq, mask, msa, msa_mask = make_inputs()
    jl, tl = run_both(jparams, jcfg, tparams, tcfg, seq, mask, msa, msa_mask)
    assert_valid_close(jl, tl, mask)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_logits_without_msa(flash):
    jparams, jcfg, tparams, tcfg = make_params(attn_flash=flash, depth=1)
    seq, mask, _, _ = make_inputs(L=10, b=2, pad=2)
    jl, tl = run_both(jparams, jcfg, tparams, tcfg, seq, mask)
    assert_valid_close(jl, tl, mask)


def test_embedds_stream():
    jparams, jcfg, tparams, tcfg = make_params(depth=1, num_embedds=24)
    seq, mask, _, _ = make_inputs(L=8, pad=0)
    emb = np.random.default_rng(3).normal(size=(1, 8, 24)).astype(np.float32)
    jl = jax_apply(jparams, jcfg, seq, embedds=emb)
    tl = alphafold2_apply(tparams, tcfg, seq, embedds=emb, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


def test_bf16_forward_runs_close():
    """bf16 rounds at other places in the two frameworks: the bound is the
    bf16 activation quantisation over two layers (~2^-8 relative per op)."""
    kw = {**SMALL, "attn_flash": True}
    jp = jax_init(jax.random.PRNGKey(0), JaxConfig(**kw, dtype=jnp.bfloat16))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         Alphafold2Config(**kw, dtype=torch.bfloat16), device="cpu")
    seq, mask, msa, msa_mask = make_inputs()
    jl = jax_apply(jp, JaxConfig(**kw, dtype=jnp.bfloat16), seq, msa,
                   mask=mask, msa_mask=msa_mask)
    tl = alphafold2_apply(tp, Alphafold2Config(**kw, dtype=torch.bfloat16), seq, msa,
                          mask=mask, msa_mask=msa_mask, device="cpu")
    assert tl.dtype == torch.bfloat16
    pair = mask[:, :, None] & mask[:, None, :]
    diff = np.abs(tl.float().numpy() - np.asarray(jl, np.float32))[pair]
    assert diff.max() < 0.1, diff.max()


def test_not_ported_options_raise():
    # ported: the reversible trunk (tests/test_torch_reversible.py), also
    # under the branch-parallel schedule (tests/test_torch_reversible_branch.py)
    assert Alphafold2Config(**SMALL, reversible=True).reversible
    rbp = Alphafold2Config(**SMALL, reversible=True, trunk_schedule="branch_parallel")
    assert rbp.reversible and rbp.trunk_schedule == "branch_parallel"
    # ported: the branch-parallel schedule (tests/test_torch_trunk_schedule.py)
    bp = Alphafold2Config(**SMALL, trunk_schedule="branch_parallel")
    assert bp.trunk_schedule == "branch_parallel"
    tcfg = Alphafold2Config(**SMALL, scan_layers=True)  # same math, a loop
    assert tcfg.scan_layers
    assert Alphafold2Config(**SMALL, remat=True).remat  # ported: checkpointed layers
    # ported: selective checkpointing; an unknown policy still raises
    assert Alphafold2Config(**SMALL, remat=True, remat_policy="dots").remat_policy == "dots"
    with pytest.raises(ValueError, match="remat_policy"):
        Alphafold2Config(**SMALL, remat=True, remat_policy="everything")


def test_templates_run_as_in_jax():
    """Templates, refused until the tower was ported, run through it:
    the logits equal JAX's (tests/test_torch_templates.py holds the rest)."""
    jparams, jcfg, tparams, tcfg = make_params(depth=1)
    seq, mask, _, _ = make_inputs(L=8, pad=0)
    templates = np.random.default_rng(2).integers(0, 37, (1, 1, 8, 8)).astype(np.int32)
    jl = jax_apply(jparams, jcfg, seq, templates=templates)
    tl = alphafold2_apply(tparams, tcfg, seq, templates=templates, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


def test_branch_parallel_runs_as_serial():
    """trunk_schedule="branch_parallel", refused until it was ported, runs:
    on the CPU the serial ops in the serial order, logits bit for bit."""
    _, _, tparams, tcfg = make_params()
    seq, mask, msa, msa_mask = make_inputs()
    bp = Alphafold2Config(**SMALL, trunk_schedule="branch_parallel")
    run = lambda cfg: alphafold2_apply(tparams, cfg, seq, msa, mask=mask,  # noqa: E731
                                       msa_mask=msa_mask, device="cpu")
    assert torch.equal(run(bp), run(tcfg))


def test_range_checks():
    _, _, tparams, tcfg = make_params(depth=1)
    with pytest.raises(ValueError, match="max_seq_len"):
        alphafold2_apply(tparams, tcfg, np.zeros((1, 40), np.int32), device="cpu")
    with pytest.raises(ValueError, match="max_num_msa"):
        alphafold2_apply(tparams, tcfg, np.zeros((1, 8), np.int32),
                         np.zeros((1, 25, 8), np.int32), device="cpu")
