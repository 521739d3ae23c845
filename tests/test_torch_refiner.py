"""The refiner (`alphafold2_tpu_torch/models/refiner.py`), port vs JAX
package, float32 on the CPU, on the same parameters (refiner_init ->
refiner_params_from_jax) and inputs made from a numpy seed.

The refiner is the identity on coordinates at init (its coordinate head's
last layer is zero), so a parity test on fresh parameters compares
nothing: every test first gives that layer random non-zero weights in the
tree both packages load. Tolerances: coordinates and node features 1e-5
absolute (the same f32 function in another summation order); atom_chunk
on and off equal to each other to 1e-6 (the same products a block at a
time); E(3) equivariance (a rotation, a reflection and a translation of
the input moves the output the same way, the features do not move) to
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import refiner as jref
from alphafold2_tpu_torch.models import refiner as tref
from alphafold2_tpu_torch.models.convert import refiner_params_from_jax

KW = dict(num_tokens=14, dim=32, depth=2, msg_dim=24)


def make(seed=0, atom_chunk=0):
    jcfg = jref.RefinerConfig(**KW, atom_chunk=atom_chunk)
    tcfg = tref.RefinerConfig(**KW, atom_chunk=atom_chunk)
    tree = jax.tree_util.tree_map(np.asarray, jref.refiner_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    for layer in tree["layers"]:
        head = layer["coord_mlp"]["l2"]
        assert not head["w"].any()  # zero at init in the JAX package
        head["w"] = rng.normal(size=head["w"].shape).astype(np.float32) * 0.3
        head["b"] = rng.normal(size=head["b"].shape).astype(np.float32) * 0.3
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jparams, jcfg, refiner_params_from_jax(tree, "cpu"), tcfg


def inputs(b=2, atoms=40, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 14, (b, atoms)).astype(np.int32)
    coords = (rng.normal(size=(b, atoms, 3)) * 4).astype(np.float32)
    coords[:, 5:9] = coords[:, 4:5]  # coincident atoms, as the proto cloud parks them
    mask = rng.random((b, atoms)) > 0.2
    return tokens, coords, mask


def test_port_init_has_the_jax_tree_and_is_the_identity():
    jcfg, tcfg = jref.RefinerConfig(**KW), tref.RefinerConfig(**KW)
    jtree = jax.tree_util.tree_map(np.asarray, jref.refiner_init(jax.random.PRNGKey(0), jcfg))
    tparams = tref.refiner_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(np.shape, jtree)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tparams) == \
        jax.tree_util.tree_map(tuple, shapes, is_leaf=lambda x: isinstance(x, tuple))
    tokens, coords, mask = inputs()
    out, _ = tref.refiner_apply(tparams, tcfg, torch.from_numpy(tokens).long(),
                                torch.from_numpy(coords), torch.from_numpy(mask))
    assert torch.equal(out, torch.from_numpy(coords))


@pytest.mark.parametrize("masked", [False, True], ids=["all-atoms", "masked"])
def test_refiner_apply_matches_jax(masked):
    jp, jc, tp, tc = make()
    tokens, coords, mask = inputs()
    m = mask if masked else None
    jx, jh = jref.refiner_apply(jp, jc, jnp.asarray(tokens), jnp.asarray(coords),
                                None if m is None else jnp.asarray(m))
    tx, th = tref.refiner_apply(tp, tc, torch.from_numpy(tokens).long(), torch.from_numpy(coords),
                                None if m is None else torch.from_numpy(m))
    assert float((tx - torch.from_numpy(coords)).abs().max()) > 1e-2  # the head moves atoms
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    if masked:  # masked atoms do not move
        np.testing.assert_array_equal(tx.numpy()[~mask], coords[~mask])


def test_atom_chunk_gives_the_same_forward_and_gradient():
    """Query blocks of 16 (ragged: 40 atoms) against all at once: the same
    forward, and under autograd (each block checkpointed) the same
    gradient, to 1e-6; JAX's chunked forward agrees at 1e-5."""
    jp, jc, tp, tc = make(atom_chunk=16)
    _, _, _, tc0 = make()
    tokens, coords, mask = inputs()
    tt, tm = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
    c1 = torch.from_numpy(coords).requires_grad_(True)
    c0 = torch.from_numpy(coords).requires_grad_(True)
    x1, h1 = tref.refiner_apply(tp, tc, tt, c1, tm)
    x0, h0 = tref.refiner_apply(tp, tc0, tt, c0, tm)
    torch.testing.assert_close(x1, x0, rtol=0, atol=1e-6)
    torch.testing.assert_close(h1, h0, rtol=0, atol=1e-6)
    g1, = torch.autograd.grad(x1.square().sum(), c1)
    g0, = torch.autograd.grad(x0.square().sum(), c0)
    torch.testing.assert_close(g1, g0, rtol=0, atol=1e-6 * max(1.0, float(g0.abs().max())))
    jx, _ = jref.refiner_apply(jp, jc, jnp.asarray(tokens), jnp.asarray(coords), jnp.asarray(mask))
    np.testing.assert_allclose(x1.detach().numpy(), np.asarray(jx), rtol=0, atol=1e-5)


def test_refiner_is_e3_equivariant():
    _, _, tp, tc = make(seed=3)
    tokens, coords, mask = inputs(seed=4)
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    Q = Q * np.array([1.0, 1.0, -np.linalg.det(Q)])  # a rotation
    for R in (Q, Q * np.array([1.0, 1.0, -1.0])):  # and a rotoreflection
        R = torch.from_numpy(R.astype(np.float32))
        shift = torch.tensor([3.0, -2.0, 5.0])
        tt, tm = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
        x, h = tref.refiner_apply(tp, tc, tt, torch.from_numpy(coords), tm)
        xr, hr = tref.refiner_apply(tp, tc, tt, torch.from_numpy(coords) @ R.T + shift, tm)
        torch.testing.assert_close(xr, x @ R.T + shift, rtol=0, atol=1e-4)
        torch.testing.assert_close(hr, h, rtol=0, atol=1e-4)
