"""Stress-majorisation MDS: distance matrix -> 3D coordinates
(counterpart of alphafold2_tpu/geometry/mds.py, inference path).

A fixed number of Guttman iterations, with no convergence freeze (the
JAX pipeline runs `tol=-inf` so a request's iteration count never depends
on its batch-mates), from the classical (Torgerson) init or a random one.

`mds` is three steps that callers may also run apart: `classical_gram`
(the double-centred squared distances), `torch.linalg.eigh` of it and
`classical_embed`, then `guttman`. The serving engine's captured graphs
run the first and the last on the card and `eigh` between them, eagerly
(serving/executable.py): `eigh` checks its solver's status on the host,
which a graph cannot hold.
"""

from __future__ import annotations

from typing import Optional

import torch


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


def guttman(pre_dist_mat, weights, coords, iters: int):
    """`iters` weighted Guttman steps from coords (b, N, 3) on target
    distances and weights (b, N, N). Returns coords (b, 3, N) and the
    normalised stress of every iteration (iters, b), each measured before
    that iteration's update, as the JAX package records it."""
    n = pre_dist_mat.shape[-1]
    eye = torch.eye(n, dtype=pre_dist_mat.dtype, device=pre_dist_mat.device)
    history = []
    for _ in range(iters):
        dist = _pairwise_dist(coords)
        stress = 0.5 * (weights * (dist - pre_dist_mat) ** 2).sum(dim=(-1, -2))
        dist = torch.where(dist == 0.0, 1e-7, dist)
        ratio = weights * (pre_dist_mat / dist)
        b_mat = -ratio + eye[None] * ratio.sum(dim=-1, keepdim=True)
        coords = torch.matmul(b_mat, coords) / n
        history.append(stress / torch.linalg.norm(coords, dim=(-1, -2)))
    return coords.transpose(1, 2), torch.stack(history)


def initial_coords(pre_dist_mat, init: str = "classical",
                   generator: Optional[torch.Generator] = None):
    """The start of the Guttman steps for (b, N, N) distances: "classical"
    or "random" (uniform in [-1, 1], drawn from `generator`, a CPU
    generator, then moved to the distances' device). (b, N, 3)."""
    if init == "classical":
        return classical_embed(*torch.linalg.eigh(classical_gram(pre_dist_mat)))
    if init == "random":
        batch, n, _ = pre_dist_mat.shape
        coords = 2.0 * torch.rand((batch, n, 3), generator=generator,
                                  dtype=pre_dist_mat.dtype) - 1.0
        return coords.to(pre_dist_mat.device)
    raise ValueError(f"unknown mds init {init!r}")


def mds(pre_dist_mat, weights=None, iters: int = 10, init: str = "classical",
        generator: Optional[torch.Generator] = None):
    """Weighted stress majorisation with a fixed iteration count.

    pre_dist_mat: (batch, N, N) or (N, N) target distances; weights: the
    same shape, per-pair confidence (default ones); init: "classical" or
    "random" (`initial_coords`). Returns coords (batch, 3, N) and the
    normalised stress of every iteration (iters, batch) (`guttman`)."""
    if pre_dist_mat.dim() == 2:
        pre_dist_mat = pre_dist_mat[None]
    if weights is None:
        weights = torch.ones_like(pre_dist_mat)
    coords = initial_coords(pre_dist_mat, init, generator)
    return guttman(pre_dist_mat, weights, coords, iters)
