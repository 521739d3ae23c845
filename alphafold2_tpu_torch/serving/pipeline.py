"""Sequence -> structure inference (counterpart of
alphafold2_tpu/serving/pipeline.py `predict_structure`, without early
exit).

Trunk forward -> distogram softmax -> centering -> stress-majorisation MDS
-> entropy confidence. Batch-capable: tokens are (b, L) and every output
carries the batch axis.

`predict_structure` runs the steps in turn; the serving engine's captured
graphs (serving/executable.py) run the same functions on the same tensors,
so both give the same values bit for bit: the forward and
`distogram_geometry` (graph one), the classical init's eigen
decomposition (`eigh`, eager between the graphs), then `classical_embed`
and `guttman` (graph two); with the random init, the draw (`initial_coords`
from a generator on the card) in graph one and no `eigh`.
"""

from __future__ import annotations

from typing import Optional

import torch

from alphafold2_tpu_torch.device import as_device_tensor, resolve_device
from alphafold2_tpu_torch.geometry.distogram import center_distogram, distogram_confidence
from alphafold2_tpu_torch.geometry.mds import guttman, initial_coords
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_apply


def distogram_geometry(logits, mask=None):
    """Trunk logits -> what the geometry reads, all float32 whatever the
    trunk dtype (it divides by distances and small weights): a dict of
    distogram_logits (b, L, L, buckets), the MDS targets distances and
    weights (b, L, L) and the confidence (b, L). mask: (b, L) bool tensor
    or None; pad pairs get zero distance and zero weight."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    distances, weights = center_distogram(probs)
    if mask is not None:
        # zero both channels for pad pairs: the weights silence them in
        # the Guttman steps, but the classical init double-centres the
        # raw distances unweighted
        pair_mask = (mask[:, :, None] & mask[:, None, :]).to(weights.dtype)
        weights = weights * pair_mask
        distances = distances * pair_mask
    return {"distogram_logits": logits, "distances": distances, "weights": weights,
            "confidence": distogram_confidence(probs, mask=mask)}


def predict_structure(params, cfg, tokens, *, mask=None, msa=None,
                      msa_mask=None, embedds=None, templates=None,
                      templates_mask=None, mds_iters: int = 200,
                      mds_init: str = "classical",
                      generator: Optional[torch.Generator] = None,
                      device=None, model_apply_fn=None):
    """Tokens (+ optional MSA or embedds) -> CA trace + confidence.

    tokens: (b, L) int residue tokens, padded positions excluded by mask
    (b, L) bool; msa / msa_mask: (b, rows, L); embedds: (b, L, num_embedds);
    templates / templates_mask: (b, T, L, L) int buckets or float distances
    in Angstroms, and bool (the template tower, `alphafold2_apply`).
    mds_iters / mds_init: the MDS iteration budget (always run in full)
    and its start; `generator` seeds the random init (a generator on the
    run's device draws there, a CPU generator on the host). Runs on `device`
    (default CUDA; device="cpu" for the CPU), where the params must lie.

    model_apply_fn: a forward override with `alphafold2_apply`'s keyword
    signature, called as fn(params, cfg, tokens, msa, mask=, msa_mask=,
    embedds=, templates=, templates_mask=), e.g. the
    sequence-parallel forward (`functools.partial(alphafold2_apply_sp,
    mesh=mesh)`, parallel/sp_trunk.py). It places its own work, so it
    takes no `device`; the geometry runs on the device of its logits.

    Returns a dict of tensors on that device: coords (b, L, 3), confidence
    (b, L), stress (b,) (the final normalised MDS stress) and
    distogram_logits (b, L, L, buckets) float32."""
    with torch.inference_mode():
        if model_apply_fn is None:
            dev = resolve_device(device)
            logits = alphafold2_apply(
                params, cfg, tokens, msa, mask=mask, msa_mask=msa_mask,
                embedds=embedds, templates=templates, templates_mask=templates_mask,
                device=dev,
            )
        else:
            if device is not None:
                raise ValueError("model_apply_fn places its own work; pass no device")
            logits = model_apply_fn(
                params, cfg, tokens, msa, mask=mask, msa_mask=msa_mask,
                embedds=embedds, templates=templates, templates_mask=templates_mask,
            )
            dev = logits.device
        geo = distogram_geometry(logits, as_device_tensor(mask, dev, torch.bool))
        coords = initial_coords(geo["distances"], mds_init, generator)
        # no convergence freeze: its flag averages the improvement over the
        # batch, which would make a request's coordinates depend on its
        # batch-mates (the JAX serving pipeline passes tol=-inf too)
        coords, stresses, _ = guttman(geo["distances"], geo["weights"], coords, mds_iters,
                                      tol=float("-inf"))
    return {
        "coords": coords.transpose(1, 2),
        "confidence": geo["confidence"],
        "stress": stresses[-1],
        "distogram_logits": geo["distogram_logits"],
    }
