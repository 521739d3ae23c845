"""Sequence -> structure inference (counterpart of
alphafold2_tpu/serving/pipeline.py `predict_structure`).

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

Trunk-depth early exit (`early_exit_depths`, `early_exit_kl`; JAX's
`_staged_trunk_logits`) runs the trunk in stages: `staged_front` (the
front, the first segment, the head) and then `staged_step` for each
later checkpoint (a segment, the head, the per-sample KL test and the
`where` updates of the state), the state's tensors updated in place. The
captured engine replays one graph a stage on the same state and skips the
rest once every sample has frozen, as this loop does.
"""

from __future__ import annotations

from typing import Optional

import torch

from alphafold2_tpu_torch.device import as_device_tensor, check_params_device, resolve_device
from alphafold2_tpu_torch.geometry.distogram import center_distogram, distogram_confidence
from alphafold2_tpu_torch.geometry.mds import guttman, initial_coords
from alphafold2_tpu_torch.models.alphafold2 import (
    alphafold2_apply,
    alphafold2_front,
    alphafold2_head,
)
from alphafold2_tpu_torch.models.trunk import sequential_trunk_apply


def exit_checkpoints(cfg, exit_depths, exit_kl) -> tuple:
    """The early exit's checkpoint depths, sorted and deduped, with
    cfg.depth appended; raises JAX's refusals with JAX's messages."""
    if cfg.reversible:
        raise ValueError(
            "early exit segments the sequential layer list; the "
            "reversible trunk is depth-stacked — set reversible=False"
        )
    checkpoints = tuple(sorted({int(d) for d in exit_depths}))
    if len(checkpoints) < 2:
        raise ValueError(
            f"early exit needs >= 2 checkpoint depths (the first is the "
            f"delta-KL baseline and can never exit), got {checkpoints}"
        )
    if checkpoints[0] < 1 or checkpoints[-1] >= cfg.depth:
        raise ValueError(
            f"early-exit depths must satisfy 1 <= d < depth={cfg.depth}, "
            f"got {checkpoints}"
        )
    if len(set(cfg.layer_sparse)) > 1:
        # sequential_trunk_apply indexes cfg.layer_sparse by local layer
        # position: a layer slice is flag-correct only when every layer
        # shares the flag
        raise ValueError(
            "early exit requires uniform sparse_self_attn flags across "
            "the trunk (layer slices re-index cfg.layer_sparse from 0)"
        )
    if exit_kl <= 0:
        raise ValueError(f"early_exit_kl must be > 0, got {exit_kl}")
    return checkpoints + (cfg.depth,)


def _head_logp(params, cfg, x):
    logits = alphafold2_head(params, cfg, x).float()
    return logits, torch.log_softmax(logits, dim=-1)


def staged_front(params, cfg, tokens, msa=None, *, mask=None, msa_mask=None,
                 embedds=None, templates=None, templates_mask=None, upto: int):
    """Stage 0 of the staged trunk: the front, layers [0, upto) and the
    head. Inputs are tensors on the params' device. Returns the state: the
    streams x, m and their masks, the pair weights pm (mask_i & mask_j,
    float32) and their per-sample count denom (at least 1), out_logits and
    prev_logp (b, L, L, buckets) float32, frozen (b,) bool (all False: the
    first checkpoint is the baseline and never exits) and exit_depth (b,)
    int32 (cfg.depth)."""
    x, m, x_mask, m_mask = alphafold2_front(
        params, cfg, tokens, msa, mask=mask, msa_mask=msa_mask, embedds=embedds,
        templates=templates, templates_mask=templates_mask)
    x, m = sequential_trunk_apply(params["trunk"][:upto], cfg, x, m, x_mask=x_mask,
                                  msa_mask=m_mask)
    b, n = tokens.shape
    if mask is not None:
        pm = (mask[:, :, None] & mask[:, None, :]).float()
    else:
        pm = torch.ones((b, n, n), dtype=torch.float32, device=tokens.device)
    out_logits, prev_logp = _head_logp(params, cfg, x)
    return {"x": x, "m": m, "x_mask": x_mask, "m_mask": m_mask, "pm": pm,
            "denom": pm.sum(dim=(1, 2)).clamp_min(1.0), "out_logits": out_logits,
            "prev_logp": prev_logp,
            "frozen": torch.zeros((b,), dtype=torch.bool, device=tokens.device),
            "exit_depth": torch.full((b,), cfg.depth, dtype=torch.int32,
                                     device=tokens.device)}


def staged_step(params, cfg, state, start: int, stop: int, exit_kl: float):
    """One later stage of the staged trunk: layers [start, stop), the head,
    and the per-sample masked-mean KL(prev || cur) of the two checkpoints'
    distograms (float32, on log_softmax, pad pairs zeroed). A live sample
    takes the new logits, and freezes at depth `stop` when its KL is at
    most `exit_kl`; a frozen sample keeps what it had (per-sample
    `torch.where`, no data-dependent shape). Updates the state's x, m,
    out_logits, prev_logp, frozen and exit_depth in place, so a captured
    graph of it writes where the next one reads."""
    x, m = sequential_trunk_apply(params["trunk"][start:stop], cfg, state["x"], state["m"],
                                  x_mask=state["x_mask"], msa_mask=state["m_mask"])
    logits, logp = _head_logp(params, cfg, x)
    prev = state["prev_logp"]
    kl = (prev.exp() * (prev - logp)).sum(dim=-1)
    kl = (kl * state["pm"]).sum(dim=(1, 2)) / state["denom"]
    live = ~state["frozen"]
    newly = live & (kl <= exit_kl)
    out = torch.where(live[:, None, None, None], logits, state["out_logits"])
    depth = torch.where(newly, torch.full_like(state["exit_depth"], stop), state["exit_depth"])
    state["x"].copy_(x)
    if m is not None:
        state["m"].copy_(m)
    state["out_logits"].copy_(out)
    state["prev_logp"].copy_(logp)
    state["frozen"].copy_(state["frozen"] | newly)
    state["exit_depth"].copy_(depth)
    return state


def staged_trunk_logits(params, cfg, tokens, msa=None, *, mask=None, msa_mask=None,
                        embedds=None, templates=None, templates_mask=None,
                        exit_depths=(), exit_kl: float):
    """The trunk forward with confidence-gated depth early exit (JAX's
    `_staged_trunk_logits`): the stages in turn, the rest skipped once
    every sample has frozen (one host read a stage; the values are those of
    running every stage). Inputs are tensors on the params' device.
    Returns (logits (b, L, L, buckets) float32, exit_depth (b,) int32)."""
    checkpoints = exit_checkpoints(cfg, exit_depths, exit_kl)
    state = staged_front(params, cfg, tokens, msa, mask=mask, msa_mask=msa_mask,
                         embedds=embedds, templates=templates,
                         templates_mask=templates_mask, upto=checkpoints[0])
    for start, stop in zip(checkpoints[:-1], checkpoints[1:]):
        staged_step(params, cfg, state, start, stop, exit_kl)
        if stop < cfg.depth and bool(state["frozen"].all()):
            break
    return state["out_logits"], state["exit_depth"]


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
                      device=None, model_apply_fn=None, early_exit_depths=(),
                      early_exit_kl: float = 0.0):
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

    early_exit_depths / early_exit_kl: trunk-depth early exit. When the
    depths are given the trunk runs in segments and a sample freezes its
    distogram at the first checkpoint depth whose masked-mean KL from the
    previous checkpoint is <= early_exit_kl (the first checkpoint is the
    baseline and never exits; `staged_trunk_logits`). Refused with
    model_apply_fn and with a reversible trunk.

    Returns a dict of tensors on that device: coords (b, L, 3), confidence
    (b, L), stress (b,) (the final normalised MDS stress) and
    distogram_logits (b, L, L, buckets) float32; with early exit armed,
    also exit_depth (b,) int32, the depth each sample's distogram froze
    at."""
    exit_depth = None
    with torch.inference_mode():
        if early_exit_depths:
            if model_apply_fn is not None:
                raise ValueError(
                    "early exit drives the trunk itself (front/segments/"
                    "head); it cannot compose with model_apply_fn overrides"
                )
            dev = resolve_device(device)
            check_params_device(params, dev)
            logits, exit_depth = staged_trunk_logits(
                params, cfg, as_device_tensor(tokens, dev, torch.long),
                as_device_tensor(msa, dev, torch.long),
                mask=as_device_tensor(mask, dev, torch.bool),
                msa_mask=as_device_tensor(msa_mask, dev, torch.bool),
                embedds=as_device_tensor(embedds, dev, torch.float32),
                templates=as_device_tensor(templates, dev),
                templates_mask=as_device_tensor(templates_mask, dev, torch.bool),
                exit_depths=early_exit_depths, exit_kl=float(early_exit_kl))
        elif model_apply_fn is None:
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
    out = {
        "coords": coords.transpose(1, 2),
        "confidence": geo["confidence"],
        "stress": stresses[-1],
        "distogram_logits": geo["distogram_logits"],
    }
    if exit_depth is not None:
        out["exit_depth"] = exit_depth
    return out
