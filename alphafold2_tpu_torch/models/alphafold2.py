"""The Alphafold2 model: embeddings -> dual-track trunk -> distogram head
(counterpart of alphafold2_tpu/models/alphafold2.py).

The pair representation is the outer sum of token embeddings plus an
axial positional embedding; the MSA stream is token + column-position +
row-position embeddings, or a projection of precomputed language-model
embeddings (`embedds`). The head symmetrises the pair rep and projects to
distogram buckets. The template tower is not ported yet (ROADMAP A4): its
weights are made, as the JAX init makes them, and stay unread.

`alphafold2_apply` is differentiable (the training path); the inference
callers run it under their own `torch.inference_mode()`.
"""

from __future__ import annotations

import torch

from alphafold2_tpu_torch.device import (
    as_device_tensor,
    check_params_device,
    resolve_device,
)
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.trunk import (
    prenorm_axial_init,
    prenorm_ff_init,
    sequential_trunk_apply,
    trunk_layer_init,
)
from alphafold2_tpu_torch.ops.attention import attention_init
from alphafold2_tpu_torch.ops.core import (
    embedding,
    embedding_init,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
)


def template_tower_init(gen, cfg: Alphafold2Config, device):
    """The template embeddings and tower (the JAX init's leaves and
    distributions, alphafold2_tpu/models/alphafold2.py:77-99). Nothing
    reads them until the tower is ported (ROADMAP A4); they are in the tree
    so that a checkpoint holds the JAX package's layout."""
    self_cfg = cfg.self_attn_config()
    return {
        "template_emb": embedding_init(gen, cfg.num_buckets, cfg.dim, device),
        "template_pos_emb": embedding_init(gen, cfg.max_seq_len, cfg.dim, device),
        "template_pos_emb_ax": embedding_init(gen, cfg.max_seq_len, cfg.dim, device),
        "template_tower": [
            {
                "seq_attn": prenorm_axial_init(gen, cfg, self_cfg, device),
                "template_attn": prenorm_axial_init(gen, cfg, self_cfg, device),
                "joint_attn": {"norm": layer_norm_init(cfg.dim, device),
                               "attn": attention_init(gen, self_cfg, device)},
                "template_ff": prenorm_ff_init(gen, cfg, device),
            }
            for _ in range(cfg.template_attn_depth)
        ],
    }


def alphafold2_init(cfg: Alphafold2Config, generator: torch.Generator, device):
    """The port's own parameter init (the JAX init's distributions; the
    numbers differ, as a torch.Generator is not a JAX key). `generator` is
    a CPU generator; the tensors are moved to `device`. The template
    leaves are drawn last, so the others keep the numbers they had before
    the template leaves were added."""
    gen, dev = generator, resolve_device(device)
    params = {
        "token_emb": embedding_init(gen, cfg.num_tokens, cfg.dim, dev),
        "pos_emb": embedding_init(gen, cfg.max_seq_len, cfg.dim, dev),
        "pos_emb_ax": embedding_init(gen, cfg.max_seq_len, cfg.dim, dev),
        "msa_pos_emb": embedding_init(gen, cfg.max_seq_len, cfg.dim, dev),
        "msa_num_pos_emb": embedding_init(gen, cfg.max_num_msa, cfg.dim, dev),
        "embedd_project": linear_init(gen, cfg.num_embedds, cfg.dim, dev),
        "head_norm": layer_norm_init(cfg.dim, dev),
        "head_out": linear_init(gen, cfg.dim, cfg.num_buckets, dev),
        "trunk": [trunk_layer_init(gen, cfg, dev) for _ in range(cfg.depth)],
    }
    params.update(template_tower_init(gen, cfg, dev))
    return params


def alphafold2_front(params, cfg: Alphafold2Config, seq, msa=None, *,
                     mask=None, msa_mask=None, embedds=None):
    """Everything before the trunk. Returns (x, m, x_mask, m_mask): the
    pair grid, the MSA stream (or None) and their masks."""
    b, n = seq.shape
    e = embedding(params["token_emb"], seq, dtype=cfg.dtype)
    x = e[:, :, None, :] + e[:, None, :, :]
    # the JAX package's quirk, kept for parity: a pair is valid when EITHER
    # residue is
    x_mask = None if mask is None else mask[:, :, None] | mask[:, None, :]

    if n > cfg.max_seq_len:
        raise ValueError(f"sequence length {n} exceeds max_seq_len={cfg.max_seq_len}")
    n_range = torch.arange(n, device=seq.device)
    pos = (
        embedding(params["pos_emb"], n_range, dtype=cfg.dtype)[:, None, :]
        + embedding(params["pos_emb_ax"], n_range, dtype=cfg.dtype)[None, :, :]
    )
    x = x + pos[None]

    m = None
    m_mask = msa_mask
    if msa is not None:
        rows, cols = msa.shape[1], msa.shape[2]
        if rows > cfg.max_num_msa:
            raise ValueError(
                f"msa has {rows} rows but the row-position table holds "
                f"max_num_msa={cfg.max_num_msa}; raise max_num_msa in the "
                f"config (reference constants.py MAX_NUM_MSA)"
            )
        if cols > cfg.max_seq_len:
            raise ValueError(
                f"msa has {cols} columns but the position table holds "
                f"max_seq_len={cfg.max_seq_len}"
            )
        m = embedding(params["token_emb"], msa, dtype=cfg.dtype)
        m = m + embedding(params["msa_pos_emb"], torch.arange(cols, device=msa.device),
                          dtype=cfg.dtype)[None, None]
        m = m + embedding(params["msa_num_pos_emb"], torch.arange(rows, device=msa.device),
                          dtype=cfg.dtype)[None, :, None, :]
    elif embedds is not None:
        p = linear(params["embedd_project"], embedds, dtype=cfg.dtype)
        m = p[:, :, None, :] + p[:, None, :, :]  # (b, n, n, d) grid stream
        if m_mask is None:
            m_mask = x_mask
    return x, m, x_mask, m_mask


def alphafold2_head(params, cfg: Alphafold2Config, x):
    """Distogram head: symmetrise, LayerNorm, project."""
    x = (x + x.transpose(1, 2)) * 0.5
    x = layer_norm(params["head_norm"], x)
    return linear(params["head_out"], x, dtype=cfg.dtype)


def alphafold2_apply(params, cfg: Alphafold2Config, seq, msa=None, *,
                     mask=None, msa_mask=None, embedds=None, templates=None,
                     templates_mask=None, rng=None, device=None, trunk_fn=None):
    """Forward pass, differentiable in the parameters.

    seq: (b, n) int tokens; msa: (b, rows, cols) int tokens or None;
    mask: (b, n) bool; msa_mask: (b, rows, cols) bool; embedds:
    (b, n, num_embedds) float, the MSA substitute when msa is None; rng:
    an optional CPU generator for dropout (None: eval mode). Inputs may be
    numpy arrays or tensors; they are moved to `device` (default CUDA;
    pass device="cpu" for the CPU), where the params must lie. trunk_fn
    overrides the trunk (the sequence-parallel one,
    parallel/sp_trunk.py alphafold2_apply_sp), called as
    trunk_fn(params["trunk"], cfg, x, m, x_mask, msa_mask, rng) and
    returning (x, m). Returns distogram logits (b, n, n, num_buckets) in
    cfg.dtype."""
    if templates is not None or templates_mask is not None:
        raise NotImplementedError(
            "the template tower is not ported to PyTorch yet (ROADMAP A4)"
        )
    dev = resolve_device(device)
    check_params_device(params, dev)
    seq = as_device_tensor(seq, dev, torch.long)
    msa = as_device_tensor(msa, dev, torch.long)
    mask = as_device_tensor(mask, dev, torch.bool)
    msa_mask = as_device_tensor(msa_mask, dev, torch.bool)
    embedds = as_device_tensor(embedds, dev, torch.float32)
    x, m, x_mask, m_mask = alphafold2_front(
        params, cfg, seq, msa, mask=mask, msa_mask=msa_mask, embedds=embedds
    )
    if trunk_fn is not None:
        if cfg.reversible:
            # the reversible trunk's params are not the layer list the
            # hook's contract hands over
            raise ValueError("trunk_fn overrides receive the sequential layer list; "
                             "set reversible=False")
        x, _ = trunk_fn(params["trunk"], cfg, x, m, x_mask, m_mask, rng)
    else:
        x, _ = sequential_trunk_apply(params["trunk"], cfg, x, m, x_mask=x_mask,
                                      msa_mask=m_mask, rng=rng)
    return alphafold2_head(params, cfg, x)
