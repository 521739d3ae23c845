"""The geometry (`alphafold2_tpu_torch/geometry/`), port vs JAX package,
float32 on the CPU, on the same inputs made from a numpy seed.

Tolerances: masks and bucket labels equal; dihedrals and phi ratios 1e-6;
kabsch, rmsd / gdt / tmscore and nerf / sidechain_container 1e-5;
center_distogram 1e-6 in all six center x wide modes; MDS from a shared
random init with the convergence freeze firing: the same frozen iteration
and the stress history at 1e-5 relative (with a 1e-6 absolute floor: near
convergence the stress is a cancellation of ~10 A float32 distances); MDS gradients to distances and
weights at 2e-6 * max(1, |ref|) for bwd_iters None and 3, and exactly zero
for 0. MDS is defined only up to a rigid motion and a reflection, and the
classical init's eigenvector signs differ between the two `eigh` calls, so
outputs are compared through pairwise distances or Kabsch-aligned, never
raw.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import geometry as jgeo
from alphafold2_tpu.geometry import distogram as jdistogram
from alphafold2_tpu_torch import geometry as tgeo
from alphafold2_tpu_torch.geometry import distogram as tdistogram

# the modules (the packages re-export the functions under the same names)
jmds = importlib.import_module("alphafold2_tpu.geometry.mds")
tmds = importlib.import_module("alphafold2_tpu_torch.geometry.mds")

RNG_SEED = 0


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def pairwise(c):
    """(..., N, 3) -> (..., N, N) distances."""
    c = np.asarray(c, np.float64)
    return np.linalg.norm(c[..., :, None, :] - c[..., None, :, :], axis=-1)


def ideal_backbone(L, phi=-1.05, psi=-0.80, omega=np.pi):
    """An ideal (N, CA, C) backbone of L residues, (3L, 3), built by NeRF
    in numpy: bond lengths N-CA 1.458, CA-C 1.525, C-N 1.329; angles 1.94,
    2.03, 2.12 rad; dihedrals psi, omega, phi in turn (alpha helix by
    default: mostly negative phi, the protein hand)."""
    bonds = (1.329, 1.458, 1.525)  # into N, CA, C
    angles = (2.12, 1.94, 2.03)
    dihedrals = (psi, omega, phi)
    pts = [np.array([-1.2, 0.8, 0.0]), np.array([0.0, 0.0, 0.0]), np.array([1.525, 0.0, 0.0])]
    for k in range(3, 3 * L):
        a, b, c = pts[-3], pts[-2], pts[-1]
        l, th, chi = bonds[k % 3], angles[k % 3], dihedrals[k % 3]
        bc = c - b
        bc /= np.linalg.norm(bc)
        n = np.cross(b - a, bc)
        n /= np.linalg.norm(n)
        m = np.stack([bc, np.cross(n, bc), n], axis=1)
        d2 = np.array([-l * np.cos(th), l * np.sin(th) * np.cos(chi), l * np.sin(th) * np.sin(chi)])
        pts.append(c + m @ d2)
    return np.stack(pts).astype(np.float32)


# --- masks, dihedrals, kabsch, metrics, nerf ------------------------------------


def test_masks_equal_the_jax_masks():
    rng = np.random.default_rng(RNG_SEED)
    tokens = rng.integers(0, 21, (2, 9)).astype(np.int32)
    np.testing.assert_array_equal(tgeo.scn_cloud_mask(torch.from_numpy(tokens)).numpy(),
                                  np.asarray(jgeo.scn_cloud_mask(tokens)))
    np.testing.assert_array_equal(
        tgeo.scn_cloud_mask(torch.from_numpy(tokens), boolean=False).numpy(),
        np.asarray(jgeo.scn_cloud_mask(tokens, boolean=False)))
    for boolean in (True, False):
        for l_aa in (3, 14):
            for a, b in zip(tgeo.scn_backbone_mask(tokens, boolean=boolean, l_aa=l_aa),
                            jgeo.scn_backbone_mask(tokens, boolean=boolean, l_aa=l_aa)):
                assert a.shape == (9 * l_aa,) or not boolean  # flat, no batch axis
                np.testing.assert_array_equal(a, b)


def test_dihedrals_and_phi_ratios_match():
    rng = np.random.default_rng(RNG_SEED)
    c = rng.normal(size=(4, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeo.get_dihedral(*t(c)).numpy(),
                               np.asarray(jgeo.get_dihedral(*j(c))), rtol=0, atol=1e-6)
    coords = rng.normal(size=(3, 3, 24)).astype(np.float32) * 3
    n_mask, ca_mask = jgeo.scn_backbone_mask(np.zeros((1, 8)), l_aa=3)
    for prop in (True, False):
        np.testing.assert_allclose(
            tgeo.calc_phis(t(coords), n_mask, ca_mask, prop=prop).numpy(),
            np.asarray(jgeo.calc_phis(j(coords), n_mask, ca_mask, prop=prop)), rtol=0, atol=1e-6)
    c_mask = ~(n_mask | ca_mask)
    np.testing.assert_allclose(
        tgeo.calc_phis(t(coords), n_mask, ca_mask, C_mask=c_mask).numpy(),
        np.asarray(jgeo.calc_phis(j(coords), n_mask, ca_mask, C_mask=c_mask)), atol=1e-6)
    # an alpha-helical backbone is mostly negative phi
    bb = ideal_backbone(10).T[None]
    assert float(tgeo.calc_phis(t(bb), n_mask[:30], ca_mask[:30])[0]) == 1.0


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_kabsch_and_metrics_match(weighted):
    rng = np.random.default_rng(RNG_SEED)
    X = rng.normal(size=(2, 3, 20)).astype(np.float32) * 5
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    Y = (np.einsum("ij,bjn->bin", R, X) + rng.normal(size=(2, 3, 20)) * 0.3 + 2.0).astype(
        np.float32)
    mask = rng.random((2, 20)) > 0.3 if weighted else None
    jw = None if mask is None else jnp.asarray(mask)
    tw = None if mask is None else torch.from_numpy(mask)
    ja, jb = jgeo.kabsch(j(X), j(Y), weights=jw)
    ta, tb = tgeo.kabsch(t(X), t(Y), weights=tw)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-5)
    jA, jB = np.asarray(ja), np.asarray(jb)
    tA, tB = t(jA), t(jB)
    pairs = [
        (tgeo.rmsd(tA, tB, mask=tw), jgeo.rmsd(jA, jB, mask=jw)),
        (tgeo.gdt(tA, tB, mask=tw), jgeo.gdt(jA, jB, mask=jw)),
        (tgeo.GDT(tA, tB, mode="HA", weights=[1, 2, 3, 4], mask=tw),
         jgeo.GDT(jA, jB, mode="HA", weights=[1, 2, 3, 4], mask=jw)),
        (tgeo.gdt(tA, tB, mask=tw, norm_len=30), jgeo.gdt(jA, jB, mask=jw, norm_len=30)),
        (tgeo.tmscore(tA, tB, mask=tw), jgeo.tmscore(jA, jB, mask=jw)),
        (tgeo.TMscore(tA, tB, mask=tw, norm_len=40), jgeo.TMscore(jA, jB, mask=jw, norm_len=40)),
        (tgeo.RMSD(tA[0], tB[0]), jgeo.RMSD(jA[0], jB[0])),
        (tgeo.Kabsch(tA[0], tB[0])[0], jgeo.Kabsch(jA[0], jB[0])[0]),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="norm_len"):
        tgeo.gdt(tA, tB, mask=tw, norm_len=5)


def test_kabsch_fixes_the_reflection():
    """Y a proper rotation of X's mirror image: the alignment is a proper
    rotation (det +1), as JAX's."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1, 3, 12)).astype(np.float32)
    Y = X * np.array([1, 1, -1], np.float32)[None, :, None]
    ta, tb = tgeo.kabsch(t(X), t(Y))
    ja, _ = jgeo.kabsch(j(X), j(Y))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    # a proper rotation keeps X's own pairwise distances
    np.testing.assert_allclose(pairwise(ta.numpy()[0].T), pairwise(X[0].T), atol=1e-5)


@pytest.mark.parametrize("place_oxygen", [False, True], ids=["parked", "oxygen"])
def test_nerf_and_sidechain_container_match(place_oxygen):
    rng = np.random.default_rng(RNG_SEED)
    a, b, c = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3))
    l, th, chi = (rng.uniform(0.5, 2.0, 4).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        tgeo.nerf(t(a), t(b), t(c), t(l), t(th), t(chi)).numpy(),
        np.asarray(jgeo.nerf(j(a), j(b), j(c), j(l), j(th), j(chi))), rtol=0, atol=1e-5)
    bb = np.stack([ideal_backbone(7), ideal_backbone(7, phi=1.0)])
    got = tgeo.sidechain_container(t(bb), place_oxygen=place_oxygen).numpy()
    want = np.asarray(jgeo.sidechain_container(j(bb), place_oxygen=place_oxygen))
    assert got.shape == (2, 7, 14, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- distogram ------------------------------------------------------------------


@pytest.mark.parametrize("center", ["mean", "median"])
@pytest.mark.parametrize("wide", ["std", "var", "none"])
def test_center_distogram_modes_match(center, wide):
    rng = np.random.default_rng(RNG_SEED)
    logits = rng.normal(size=(2, 9, 9, 37)).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    tc, tw = tgeo.center_distogram(t(probs), center=center, wide=wide)
    jc, jw = jgeo.center_distogram(j(probs), center=center, wide=wide)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6 * 30)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    bins = np.linspace(3.0, 15.0, 37)
    tc, tw = tgeo.center_distogram(t(probs), bins=bins, center=center, wide=wide)
    jc, jw = jgeo.center_distogram(j(probs), bins=bins, center=center, wide=wide)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


def test_center_distogram_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="center mode"):
        tgeo.center_distogram(torch.ones(1, 2, 2, 37) / 37, center="mode")


def test_bucketize_distances_equal():
    rng = np.random.default_rng(RNG_SEED)
    coords = rng.normal(size=(2, 11, 3)).astype(np.float32) * 8
    mask = rng.random((2, 11)) > 0.2
    for m in (None, mask):
        got = tdistogram.bucketize_distances(t(coords), None if m is None
                                             else torch.from_numpy(m)).numpy()
        want = np.asarray(jdistogram.bucketize_distances(j(coords), m))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# --- MDS ------------------------------------------------------------------------


def _exact_distances(b=2, n=24, seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 3)) * 4
    d = pairwise(pts).astype(np.float32)
    w = rng.uniform(0.99, 1.0, d.shape).astype(np.float32)
    return d, (w + w.transpose(0, 2, 1)) / 2


def _frozen_at(history):
    """The first iteration whose (whole batch's) stress equals the last."""
    h = np.asarray(history)
    return int(np.argmax((h == h[-1]).all(axis=1)))


def test_mds_random_init_freeze_matches_jax():
    """The port's Guttman steps with the freeze from JAX's own random init
    (2 uniform(key) - 1): the freeze fires at the same iteration and the
    histories agree to 1e-5 relative; the coordinates' distances too."""
    d, w = _exact_distances()
    key = jax.random.PRNGKey(3)
    jc, jh = jmds.mds(j(d), j(w), iters=150, tol=1e-3, key=key, init="random")
    init = 2.0 * jax.random.uniform(key, d.shape[:2] + (3,), jnp.float32) - 1.0
    tc, th, (_, done) = tmds.guttman(t(d), t(w), t(init), 150, tol=1e-3)
    assert bool(done)
    k = _frozen_at(jh)
    assert 0 < k < 149 and _frozen_at(th.numpy()) == k
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pairwise(tc.numpy().transpose(0, 2, 1)),
                               pairwise(np.asarray(jc).transpose(0, 2, 1)), atol=1e-3)
    # the port's own random init is seeded by its generator (JAX's key)
    a = tmds.mds(t(d), iters=3, generator=torch.Generator().manual_seed(4))[0]
    b = tmds.mds(t(d), iters=3, generator=torch.Generator().manual_seed(4))[0]
    assert torch.equal(a, b) and torch.equal(tmds.mds(t(d), iters=3)[0],
                                             tmds.mds(t(d), iters=3)[0])


def test_mds_classical_freeze_matches_jax():
    """Classical init and the default tol on exact distances: the freeze
    fires at the same iteration; distances agree."""
    d, w = _exact_distances(seed=5)
    jc, jh = jmds.mds(j(d), j(w), iters=30, init="classical")
    tc, th = tmds.mds(t(d), t(w), iters=30, init="classical")
    assert _frozen_at(th.numpy()) == _frozen_at(jh) < 29
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pairwise(tc.numpy().transpose(0, 2, 1)),
                               pairwise(np.asarray(jc).transpose(0, 2, 1)), atol=1e-3)


@pytest.mark.parametrize("bwd_iters", [None, 0, 3], ids=["full", "detached", "tail3"])
def test_mds_gradients_match_jax(bwd_iters):
    """The gradient of a rigid-motion- and reflection-invariant function of
    the MDS output (sum of R * pairwise distances) to the target distances
    and the weights, classical init (detached in both), default tol:
    2e-6 * max(1, |ref|); bwd_iters=0 detaches MDS entirely (zero)."""
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(1, 16, 3)) * 3
    d = (pairwise(pts) + np.abs(rng.normal(size=(1, 16, 16))) * 0.2).astype(np.float32)
    d = (d + d.transpose(0, 2, 1)) / 2
    d[:, np.arange(16), np.arange(16)] = 0.0
    w = rng.uniform(0.3, 1.0, d.shape).astype(np.float32)
    w = (w + w.transpose(0, 2, 1)) / 2
    R = rng.normal(size=(1, 16, 16)).astype(np.float32)

    def jloss(dd, ww):
        c, _ = jmds.mds(dd, ww, iters=10, bwd_iters=bwd_iters, init="classical")
        x = jnp.transpose(c, (0, 2, 1))
        dist = jnp.sqrt(jnp.sum((x[:, :, None] - x[:, None]) ** 2, -1) + 1e-12)
        return jnp.sum(dist * R)

    jgd, jgw = jax.grad(jloss, argnums=(0, 1))(j(d), j(w))
    td, tw = t(d).requires_grad_(True), t(w).requires_grad_(True)
    c, _ = tmds.mds(td, tw, iters=10, bwd_iters=bwd_iters, init="classical")
    x = c.transpose(1, 2)
    dist = torch.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1) + 1e-12)
    loss = (dist * t(R)).sum()
    if bwd_iters == 0:
        assert not loss.requires_grad
        assert not np.asarray(jgd).any() and not np.asarray(jgw).any()
        return
    gd, gw = torch.autograd.grad(loss, (td, tw))
    for got, want in ((gd, jgd), (gw, jgw)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-6 * max(1.0, np.abs(want).max()))


def test_mdscaling_flip_matches_jax():
    """An alpha-helical backbone's exact distances: both packages
    reconstruct it and `fix_mirror` brings both to the protein hand
    (mostly negative phi); their raw phi ratios agree, the fixed outputs
    agree up to a proper rotation, and the flip is the z axis of the
    structures whose ratio was below 0.5."""
    L = 12
    bb = ideal_backbone(L)
    d = pairwise(bb[None]).astype(np.float32)
    n_mask, ca_mask = tgeo.scn_backbone_mask(np.zeros((1, L)), l_aa=3)
    kw = dict(iters=5, init="classical", N_mask=n_mask, CA_mask=ca_mask)
    t_raw, _ = tgeo.mdscaling(t(d), fix_mirror=False, **kw)
    j_raw, _ = jgeo.mdscaling(j(d), fix_mirror=False, **kw)
    t_ratio = float(tgeo.calc_phis(t_raw, n_mask, ca_mask)[0])
    j_ratio = float(jgeo.calc_phis(j_raw, n_mask, ca_mask)[0])
    assert t_ratio in (0.0, 1.0) and j_ratio in (0.0, 1.0)  # a clean hand either way
    t_fix, _ = tgeo.mdscaling(t(d), **kw)
    j_fix, _ = jgeo.mdscaling(j(d), **kw)
    assert float(tgeo.calc_phis(t_fix, n_mask, ca_mask)[0]) == 1.0
    assert float(jgeo.calc_phis(j_fix, n_mask, ca_mask)[0]) == 1.0
    flipped = t_raw.clone()
    if t_ratio < 0.5:
        flipped[:, -1] = -flipped[:, -1]
    assert torch.equal(t_fix, flipped)
    aligned, ref = tgeo.kabsch(t_fix, t(j_fix))
    assert float(tgeo.rmsd(aligned, ref)[0]) < 1e-3
    truth = t(bb.T[None])
    aligned, ref = tgeo.kabsch(t_fix, truth)
    assert float(tgeo.rmsd(aligned, ref)[0]) < 1e-2
    with pytest.raises(ValueError, match="N_mask and CA_mask"):
        tgeo.MDScaling(t(d), iters=2)


def test_mds_signatures_and_defaults_match_jax():
    """mds, mdscaling and center_distogram take JAX's parameters with JAX's
    defaults, in JAX's order, apart from key -> generator (a CPU
    torch.Generator, the same place and default None) and unroll (a
    lax.scan knob with no counterpart)."""
    def params(fn, drop=()):
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
                if p.name not in drop]

    def as_jax(ps):
        return [("key" if n == "generator" else n, v) for n, v in ps]

    for tf, jf in ((tmds.mds, jmds.mds), (tmds.mdscaling, jmds.mdscaling),
                   (tgeo.center_distogram, jgeo.center_distogram),
                   (tdistogram.bucketize_distances, jdistogram.bucketize_distances)):
        jfn = getattr(jf, "__wrapped__", jf)
        assert as_jax(params(tf)) == params(jfn, drop=("unroll",)), tf.__name__
    assert params(tmds.mds)[:4] == [("pre_dist_mat", inspect.Parameter.empty),
                                    ("weights", None), ("iters", 10), ("tol", 1e-5)]
    assert dict(params(tmds.mds))["init"] == "random"
    assert sorted(tgeo.__all__) == sorted(jgeo.__all__)
