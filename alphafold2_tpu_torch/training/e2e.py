"""End-to-end structure prediction and training (counterpart of
alphafold2_tpu/training/e2e.py): the trunk on the x3-elongated sequence
(one token per backbone atom N, CA, C) -> distogram -> centering -> MDS
with the mirror fix -> the side-chain lift -> the E(3)-equivariant
refiner -> (training) the Kabsch-aligned RMSD plus the distogram
dispersion term.

The geometry runs in float32 whatever the trunk's dtype (it divides by
distances and small weights). `predict_structure` is differentiable; an
inference caller wraps it in `torch.inference_mode()` (the predict CLI
does), and `e2e_loss_fn` backpropagates through the refiner, the lift,
the Guttman iterations and the centering into the trunk, as JAX's
`jax.grad` does. The SVD of `kabsch` and the classical init's `eigh` read
the host on the card, and so does the random init's CPU draw, so the path
and its train step run eagerly (`training/harness.py make_train_step`);
`CapturedTrainStep` refuses an `E2EConfig` (ROADMAP A8-e2e-capture).
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
    kabsch,
    mdscaling,
    scn_backbone_mask,
    scn_cloud_mask,
    sidechain_container,
)
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_apply, alphafold2_init
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.refiner import RefinerConfig, refiner_apply, refiner_init
from alphafold2_tpu_torch.ops.quant import reject_quant_training
from alphafold2_tpu_torch.training.harness import TrainConfig, train_state
from alphafold2_tpu_torch.training.losses import combine_parts
from alphafold2_tpu_torch.utils.rng import Key, tagged_rows


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


def mds_generator(ecfg: E2EConfig, rng) -> torch.Generator:
    """The random MDS init's CPU generator for one microbatch. Without rng it
    is seeded 0 (JAX's `PRNGKey(0)`); with rng, and `mds_init="random"`, it
    is seeded by one draw from rng in [0, 2^63 - 1), taken before the trunk
    seeds its dropout streams, or, when rng is a utils/rng.py Key (the
    train step's microbatch position), by the seed of rng.fold_in("mds"),
    so each microbatch of a step gets its own. The classical init draws
    nothing (rng's stream is predict_structure's). JAX splits its key
    instead, so the port's random inits are not JAX's draws: a parity check
    hands both packages the same start."""
    if rng is None or ecfg.mds_init != "random":
        return torch.Generator().manual_seed(0)
    if isinstance(rng, Key):
        return torch.Generator().manual_seed(rng.fold_in("mds").seed)
    seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=rng))
    return torch.Generator().manual_seed(seed)


def structure_loss(out, ecfg: E2EConfig, batch):
    """The loss of `predict_structure`'s output `out` against batch["coords"]
    (b, L, 14, 3) (and the optional batch["atom_mask"]): `make_e2e_loss_fn`'s
    value."""
    return combine_parts(structure_loss_parts(out, ecfg, batch))


def structure_loss_parts(out, ecfg: E2EConfig, batch):
    """`structure_loss` as (numerator, denominator) terms (`training/
    losses.py combine_parts`): the summed RMSD over the structures and
    their count, dispersion_weight x the summed dispersion over the pairs
    of positive weight and their count."""
    dev = out["refined"].device
    b, length = out["cloud_mask"].shape[:2]
    num_atoms = length * NUM_COORDS_PER_RES
    w = out["cloud_mask"].reshape(b, num_atoms).float()
    if batch.get("atom_mask") is not None:
        w = w * as_device_tensor(batch["atom_mask"], dev).reshape(b, num_atoms).float()
    pred = out["refined"].reshape(b, num_atoms, 3).transpose(1, 2)
    true = as_device_tensor(batch["coords"], dev, torch.float32).reshape(
        b, num_atoms, 3).transpose(1, 2)
    pred_aligned, true_centered = kabsch(pred, true, weights=w)
    sq = (pred_aligned - true_centered).square().sum(dim=-2)  # (b, atoms)
    rmsd = torch.sqrt((sq * w).sum(dim=-1) / w.sum(dim=-1).clamp_min(1.0))
    dw = out["distogram_weights"]
    valid = (dw > 0).float()
    per_pair = (1.0 / (dw + ecfg.weights_eps) - 1.0).abs() * valid
    count = torch.full((), b, dtype=torch.float32, device=dev)
    return [(rmsd.sum(), count), (ecfg.dispersion_weight * per_pair.sum(), valid.sum())]


def make_e2e_loss_fn(model_apply_fn=None):
    """The end-to-end structure loss around any model apply function with
    `alphafold2_apply`'s signature (`predict_structure`'s model_apply_fn;
    None: the default forward on `device`).

    `loss_fn(params, ecfg, batch, rng=None, device=None)`, the port's loss
    signature (`training/harness.py make_train_step`): batch {"seq": (b, L)
    int, "mask": (b, L) bool, "coords": (b, L, 14, 3) the true atom cloud,
    optional "msa" / "msa_mask", "embedds" (b, 3L, n) elongated x3, and
    "atom_mask" (b, L, 14) bool, the atoms resolved}; rng: the trunk's
    dropout generator, from which the random MDS init's generator is drawn
    (`mds_generator`). Returns a 0-d f32 tensor, the mean over structures
    of the Kabsch-aligned RMSD, sqrt(sum sq w / max(sum w, 1)) with w the
    cloud mask times the atom mask, plus dispersion_weight x the mean of
    |1 / (dw + weights_eps) - 1| over the pairs whose distogram weight dw
    is positive (censored pairs have dw = 0 and no gradient). The
    alignment's rotation is a constant to the gradient (`kabsch` detaches
    its SVD, as JAX's stop_gradient does). `structure_loss` is the part after
    the forward."""

    def parts(params, ecfg: E2EConfig, batch, rng=None, device=None, rows=None):
        # rows: a data-parallel shard's (start, count, total) batch rows,
        # which the MDS init's draw (in the forward only) takes of the
        # whole batch's
        with tagged_rows(mds_generator(ecfg, rng), rows) as gen:
            out = predict_structure(
                params, ecfg, batch["seq"], mask=batch.get("mask"), rng=rng,
                msa=batch.get("msa"), msa_mask=batch.get("msa_mask"),
                embedds=batch.get("embedds"), model_apply_fn=model_apply_fn,
                mds_generator=gen, device=None if model_apply_fn is not None else device)
        return structure_loss_parts(out, ecfg, batch)

    def loss_fn(params, ecfg: E2EConfig, batch, rng=None, device=None):
        return combine_parts(parts(params, ecfg, batch, rng, device))

    # the loss as (numerator, denominator) terms, for a data-parallel step
    loss_fn.parts = parts
    return loss_fn


# the default (single-device forward) e2e loss
e2e_loss_fn = make_e2e_loss_fn()


def e2e_train_state_init(ecfg: E2EConfig, tcfg: TrainConfig, generator: torch.Generator,
                         device=None) -> dict:
    """`training/harness.py train_state` over the joint {"model", "refiner"}
    parameters from `generator` (a CPU generator) on `device` (default
    CUDA; "cpu" for the CPU). An int8 config is refused (inference-only)."""
    reject_quant_training(ecfg, "e2e_train_state_init")
    return train_state(e2e_params_init(ecfg, generator, device), tcfg)
