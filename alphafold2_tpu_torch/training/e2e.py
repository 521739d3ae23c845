"""End-to-end structure prediction, the forward half (counterpart of
alphafold2_tpu/training/e2e.py): the trunk on the x3-elongated sequence
(one token per backbone atom N, CA, C) -> distogram -> centering -> MDS
with the mirror fix -> the side-chain lift -> the E(3)-equivariant
refiner.

The geometry runs in float32 whatever the trunk's dtype (it divides by
distances and small weights). `predict_structure` is differentiable; an
inference caller wraps it in `torch.inference_mode()` (the predict CLI
does). The SVD and `eigh` of the geometry synchronise with the host on the
card, so the path runs eagerly.

Training (`make_e2e_loss_fn`, `e2e_train_state_init`) is not ported yet:
both raise, naming ROADMAP A8-e2e-train.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from alphafold2_tpu_torch.constants import NUM_COORDS_PER_RES
from alphafold2_tpu_torch.device import as_device_tensor, resolve_device
from alphafold2_tpu_torch.geometry import (
    center_distogram,
    mdscaling,
    scn_backbone_mask,
    scn_cloud_mask,
    sidechain_container,
)
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_apply, alphafold2_init
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.refiner import RefinerConfig, refiner_apply, refiner_init


@dataclasses.dataclass(frozen=True)
class E2EConfig:
    """The full structure workload's config, the JAX package's fields.
    mds_bwd_iters: backpropagate MDS through its last K iterations only
    (None: all). mds_unroll is a lax.scan knob with no meaning here: kept
    as a field, unread, so configs and checkpoints carry across. mds_init:
    "random" (reference parity) or "classical"."""

    model: Alphafold2Config
    refiner: RefinerConfig = RefinerConfig(num_tokens=NUM_COORDS_PER_RES)
    mds_iters: int = 200
    mds_bwd_iters: Optional[int] = None
    mds_unroll: int = 1
    mds_init: str = "random"
    fix_mirror: bool = True
    place_oxygen: bool = True
    dispersion_weight: float = 0.1
    weights_eps: float = 1e-3


def elongate(seq, factor: int = 3):
    """Repeat each residue token `factor` times: (b, L) -> (b, L * factor)."""
    return torch.repeat_interleave(seq, factor, dim=-1)


def predict_structure(params, ecfg: E2EConfig, seq, mask=None, rng=None, msa=None,
                      msa_mask=None, embedds=None, templates=None, templates_mask=None,
                      model_apply_fn=None, *, mds_generator: Optional[torch.Generator] = None,
                      device=None, stage=None):
    """Full forward: sequence (b, L) -> refined (b, L, 14, 3) atom cloud.

    params: {"model": ..., "refiner": ...} on the run's device. mask: (b,
    L) bool; msa / msa_mask as `alphafold2_apply`'s; embedds: (b, 3L, n),
    residue embeddings already elongated x3; templates / templates_mask:
    (b, T, 3L, 3L), over the elongated grid. rng: the trunk's dropout
    generator (JAX's model key); mds_generator: the random MDS init's CPU
    generator (JAX's MDS key; default seeded 0). device: where the default
    forward runs (default CUDA; "cpu" for the CPU). model_apply_fn: a
    forward override with `alphafold2_apply`'s signature that places its
    own work (the sequence-parallel forward), given rng only when one is
    set; the geometry and the refiner run where its logits land. stage: a
    callable name -> context manager entered around each stage, "trunk",
    "distogram" (softmax + centering), "mds" (with the mirror fix),
    "sidechain" and "refiner" (a caller's timer; default none).

    Returns a dict: refined (b, L, 14, 3), proto (b, L, 14, 3) the lifted
    cloud before refinement, distogram_weights (b, 3L, 3L), cloud_mask (b,
    L, 14) bool and distogram_logits (b, 3L, 3L, buckets) f32."""
    seq = torch.as_tensor(seq)
    b, length = seq.shape
    seq3 = elongate(seq.long())
    mask_t = None if mask is None else torch.as_tensor(mask).bool()
    mask3 = None if mask_t is None else elongate(mask_t)
    kw = dict(mask=mask3, msa_mask=msa_mask, embedds=embedds)
    if templates is not None:
        kw.update(templates=templates, templates_mask=templates_mask)
    stage = stage or (lambda name: contextlib.nullcontext())
    with stage("trunk"):
        if model_apply_fn is None:
            logits = alphafold2_apply(params["model"], ecfg.model, seq3, msa, rng=rng,
                                      device=resolve_device(device), **kw)
        else:
            if device is not None:
                raise ValueError("model_apply_fn places its own work; pass no device")
            logits = model_apply_fn(params["model"], ecfg.model, seq3, msa, **kw,
                                    **({} if rng is None else {"rng": rng}))
    dev = logits.device
    with stage("distogram"):
        logits = logits.float()
        probs = torch.softmax(logits, dim=-1)
        distances, weights = center_distogram(probs)

    with stage("mds"):
        # the chirality masks over the flat (L * 3) backbone atom axis
        n_mask, ca_mask = scn_backbone_mask(seq, l_aa=3)
        coords, _ = mdscaling(distances, weights=weights, iters=ecfg.mds_iters,
                              fix_mirror=ecfg.fix_mirror, N_mask=n_mask, CA_mask=ca_mask,
                              generator=mds_generator, bwd_iters=ecfg.mds_bwd_iters,
                              init=ecfg.mds_init)  # (b, 3, 3L)
    with stage("sidechain"):
        proto = sidechain_container(coords.transpose(1, 2), place_oxygen=ecfg.place_oxygen)

    with stage("refiner"):
        cloud_mask = scn_cloud_mask(seq.to(dev))
        if mask_t is not None:
            cloud_mask = cloud_mask & as_device_tensor(mask_t, dev)[..., None]
        num_atoms = length * NUM_COORDS_PER_RES
        atom_tokens = torch.arange(NUM_COORDS_PER_RES, device=dev).expand(
            b, length, NUM_COORDS_PER_RES).reshape(b, num_atoms)
        refined, _ = refiner_apply(params["refiner"], ecfg.refiner, atom_tokens,
                                   proto.reshape(b, num_atoms, 3),
                                   mask=cloud_mask.reshape(b, num_atoms))
    return {
        "refined": refined.reshape(b, length, NUM_COORDS_PER_RES, 3),
        "proto": proto,
        "distogram_weights": weights,
        "cloud_mask": cloud_mask,
        "distogram_logits": logits,
    }


def e2e_params_init(ecfg: E2EConfig, generator: torch.Generator, device):
    """The joint (trunk, refiner) parameters, {"model", "refiner"}: the
    inference entry points' init (no optimizer state)."""
    device = resolve_device(device)
    return {
        "model": alphafold2_init(ecfg.model, generator, device),
        "refiner": refiner_init(ecfg.refiner, generator, device),
    }


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name}: end-to-end structure training is not ported to PyTorch yet "
        f"(ROADMAP A8-e2e-train)")


def make_e2e_loss_fn(model_apply_fn=None):
    """Not ported yet: raises naming ROADMAP A8-e2e-train."""
    _not_ported("make_e2e_loss_fn")


def e2e_train_state_init(*args, **kwargs):
    """Not ported yet: raises naming ROADMAP A8-e2e-train."""
    _not_ported("e2e_train_state_init")
