"""Stress-majorisation MDS: distance matrix -> 3D coordinates
(counterpart of alphafold2_tpu/geometry/mds.py).

A fixed number of weighted Guttman steps from the classical (Torgerson)
init or a random one, with the JAX package's convergence freeze: once the
batch's mean improvement of the normalised stress drops to `tol`, no
further update is taken (one batch-global flag, applied with
`torch.where`, so the step count never depends on the data and the loop
stays capturable). The serving paths pass `tol=-inf`, as the JAX serving
pipeline does, so a request's iterations never depend on its batch-mates;
there the freeze cannot fire on a finite stress and its ops are skipped.

`mds` is three steps that callers may also run apart: `classical_gram`
(the double-centred squared distances), `torch.linalg.eigh` of it and
`classical_embed`, then `guttman`. The serving engine's captured graphs
run the first and the last on the card and `eigh` between them, eagerly
(serving/executable.py): `eigh` checks its solver's status on the host,
which a graph cannot hold. The random init has no `eigh`: the engine's
graph draws it from a generator on the card (`initial_coords`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from alphafold2_tpu_torch.geometry.dihedral import calc_phis
from alphafold2_tpu_torch.ops.core import rand_rows


def _pairwise_dist(coords, eps: float = 1e-12):
    """Batched euclidean distances with the JAX package's eps. coords: (b, N, 3)."""
    d2 = ((coords[:, :, None, :] - coords[:, None, :, :]) ** 2).sum(dim=-1)
    return torch.sqrt(d2 + eps)


def classical_gram(pre_dist_mat):
    """The Torgerson Gram matrix: the squared distances double-centred,
    -1/2 (D^2 - row means - column means + mean). (b, N, N)."""
    d2 = pre_dist_mat.square()
    row = d2.mean(dim=-1, keepdim=True)
    col = d2.mean(dim=-2, keepdim=True)
    tot = d2.mean(dim=(-1, -2), keepdim=True)
    return -0.5 * (d2 - row - col + tot)


def classical_embed(evals, evecs):
    """The classical init from the Gram matrix's eigenpairs (`eigh`'s
    ascending order): the top-3 eigenvectors scaled by the square roots of
    their eigenvalues. Returns (b, N, 3)."""
    top_vals = evals[..., -3:].clamp_min(0.0)
    return evecs[..., -3:] * torch.sqrt(top_vals)[..., None, :]


def guttman(pre_dist_mat, weights, coords, iters: int, *, tol: float,
            freeze: bool = True, best=None, done=None):
    """`iters` weighted Guttman steps from coords (b, N, 3) on target
    distances and weights (b, N, N).

    tol: the freeze's threshold on the batch's mean improvement of the
    normalised stress; -inf never freezes (the serving paths). freeze=False
    takes every update whatever `tol` (the differentiable tail of
    `mds(bwd_iters=)`). best (b,) and done () carry the best stress and the
    flag between calls (default: +inf, False).

    Returns coords (b, 3, N), the normalised stress of every iteration
    (iters, b) as the JAX package records it (the best so far; the frozen
    value repeated once frozen), and the final (best, done)."""
    b, n = pre_dist_mat.shape[0], pre_dist_mat.shape[-1]
    eye = torch.eye(n, dtype=pre_dist_mat.dtype, device=pre_dist_mat.device)
    if best is None:
        best = torch.full((b,), math.inf, dtype=pre_dist_mat.dtype, device=pre_dist_mat.device)
    if done is None:
        done = torch.zeros((), dtype=torch.bool, device=pre_dist_mat.device)
    freeze = freeze and tol > -math.inf
    history = []
    for _ in range(iters):
        dist = _pairwise_dist(coords)
        stress = 0.5 * (weights * (dist - pre_dist_mat) ** 2).sum(dim=(-1, -2))
        dist = torch.where(dist == 0.0, 1e-7, dist)
        ratio = weights * (pre_dist_mat / dist)
        b_mat = -ratio + eye[None] * ratio.sum(dim=-1, keepdim=True)
        new_coords = torch.matmul(b_mat, coords) / n
        norm_stress = stress / torch.linalg.norm(new_coords, dim=(-1, -2))
        if freeze:
            # once converged the update is not taken (the reference's
            # break before the assignment, utils.py:343-350)
            done = done | ((best - norm_stress).mean() <= tol)
            coords = torch.where(done, coords, new_coords)
            best = torch.where(done, best, norm_stress)
        else:
            coords, best = new_coords, norm_stress
        history.append(best)
    hist = torch.stack(history) if history else best.new_empty((0, b))
    return coords.transpose(1, 2), hist, (best, done)


def initial_coords(pre_dist_mat, init: str = "classical",
                   generator: Optional[torch.Generator] = None):
    """The start of the Guttman steps for (b, N, N) distances, detached (no
    gradient flows into the init): "classical" (Torgerson: eigh of the
    double-centred squared distances) or "random" (uniform in [-1, 1],
    drawn from `generator`: on the distances' device when the generator
    lies there, the draw a CUDA graph replays from the generator's seed;
    else on the CPU, from a CPU generator, and moved, which a graph
    capture refuses: it would freeze the draw). (b, N, 3)."""
    if init == "classical":
        return classical_embed(*torch.linalg.eigh(classical_gram(pre_dist_mat.detach())))
    if init == "random":
        batch, n, _ = pre_dist_mat.shape
        device = pre_dist_mat.device
        on = generator is not None and generator.device.type == device.type
        if on and generator.device.index in (None, device.index):  # "cuda": the current card
            return 2.0 * rand_rows((batch, n, 3), generator, device, pre_dist_mat.dtype) - 1.0
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise ValueError(
                "initial_coords: a random init from a CPU generator inside a CUDA graph "
                "capture would copy one draw into the graph; pass a generator on "
                f"{device} registered with the graph")
        coords = 2.0 * rand_rows((batch, n, 3), generator, "cpu", pre_dist_mat.dtype) - 1.0
        return coords.to(device)
    raise ValueError(f"unknown mds init {init!r}")


def mds(pre_dist_mat, weights=None, iters: int = 10, tol: float = 1e-5,
        generator: Optional[torch.Generator] = None, bwd_iters: Optional[int] = None,
        init: str = "random"):
    """Weighted stress majorisation, the JAX package's `mds` (its `key` is
    `generator` here, a CPU generator, default seeded 0 as JAX's default key
    is PRNGKey(0); `unroll`, a lax.scan knob, has no counterpart).

    pre_dist_mat: (batch, N, N) or (N, N) target distances; weights: the
    same shape, per-pair confidence (default ones); iters: the iteration
    count; tol: the convergence freeze (`guttman`); init: "random" or
    "classical" (`initial_coords`).

    bwd_iters: backpropagate through the last `bwd_iters` iterations only.
    The first iters - bwd_iters run with the freeze and detached (their
    history rows too); the tail runs without the freeze (a frozen update
    would pass the detached carry through and zero the gradient).
    bwd_iters=0 detaches MDS entirely.

    Returns coords (batch, 3, N) and the normalised stress of every
    iteration (iters, batch)."""
    if pre_dist_mat.dim() == 2:
        pre_dist_mat = pre_dist_mat[None]
    if weights is None:
        weights = torch.ones_like(pre_dist_mat)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    coords = initial_coords(pre_dist_mat, init, generator)
    if bwd_iters is None or bwd_iters >= iters:
        coords, history, _ = guttman(pre_dist_mat, weights, coords, iters, tol=tol)
        return coords, history
    with torch.no_grad():
        coords, head, (best, done) = guttman(pre_dist_mat, weights, coords,
                                             iters - bwd_iters, tol=tol)
    if bwd_iters == 0:
        return coords, head
    coords, tail, _ = guttman(pre_dist_mat, weights, coords.transpose(1, 2), bwd_iters,
                              tol=tol, freeze=False, best=best, done=done)
    return coords, torch.cat([head, tail])


def mdscaling(pre_dist_mat, weights=None, iters: int = 10, tol: float = 1e-5,
              fix_mirror: bool = True, N_mask=None, CA_mask=None, C_mask=None,
              generator: Optional[torch.Generator] = None,
              bwd_iters: Optional[int] = None, init: str = "random"):
    """`mds` with the chirality (mirror-image) fix: MDS is defined only up
    to a reflection, and real backbones have mostly negative phi, so each
    structure whose fraction of negative phis (`calc_phis`) is below 0.5
    has its z axis flipped. N_mask / CA_mask: the static backbone masks
    (`scn_backbone_mask`), required with fix_mirror. Returns (coords
    (batch, 3, N), stress history)."""
    preds, stresses = mds(pre_dist_mat, weights=weights, iters=iters, tol=tol,
                          generator=generator, bwd_iters=bwd_iters, init=init)
    if not fix_mirror:
        return preds, stresses
    if N_mask is None or CA_mask is None:
        raise ValueError(
            "fix_mirror=True requires N_mask and CA_mask (backbone atom masks); "
            "pass fix_mirror=False to skip chirality correction"
        )
    flip = calc_phis(preds, N_mask, CA_mask, C_mask, prop=True) < 0.5
    z = torch.where(flip[:, None], -preds[:, -1], preds[:, -1])
    return torch.cat([preds[:, :-1], z[:, None]], dim=1), stresses


def MDScaling(pre_dist_mat, **kwargs):
    """Public wrapper (reference utils.py:671-696): (N, N) or (batch, N, N)."""
    return mdscaling(pre_dist_mat, **kwargs)
