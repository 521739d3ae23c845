"""The Alphafold2 model: embeddings -> dual-track trunk -> distogram head
(counterpart of alphafold2_tpu/models/alphafold2.py).

The pair representation is the outer sum of token embeddings plus an
axial positional embedding; the MSA stream is token + column-position +
row-position embeddings, or a projection of precomputed language-model
embeddings (`embedds`). The head symmetrises the pair rep and projects to
distogram buckets. Templates run through a pre-trunk tower
(`template_tower_apply`) with attention along the template axis.

Reference quirks kept for parity with the JAX package: the tower's seq
self-attention has NO residual; templates without `templates_mask` run
unmasked.

`alphafold2_apply` is differentiable (the training path); the inference
callers run it under their own `torch.inference_mode()`.
"""

from __future__ import annotations

import numpy as np
import torch

from alphafold2_tpu_torch.constants import DISTANCE_THRESHOLDS
from alphafold2_tpu_torch.device import (
    as_device_tensor,
    check_params_device,
    resolve_device,
)
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.reversible import reversible_trunk_apply, reversible_trunk_init
from alphafold2_tpu_torch.models.trunk import (
    dropout_live,
    prenorm_axial_apply,
    prenorm_axial_init,
    prenorm_ff_apply,
    prenorm_ff_init,
    sequential_trunk_apply,
    trunk_layer_init,
)
from alphafold2_tpu_torch.ops.attention import attention_apply, attention_init
from alphafold2_tpu_torch.ops.core import (
    embedding,
    embedding_init,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
)
from alphafold2_tpu_torch.utils.rng import as_key


def template_tower_init(gen, cfg: Alphafold2Config, device):
    """The template embeddings and tower (the JAX init's leaves and
    distributions, alphafold2_tpu/models/alphafold2.py:77-99)."""
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
    the template leaves were added. A reversible config's trunk layers
    carry eight blocks (models/reversible.py)."""
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
        "trunk": (reversible_trunk_init(gen, cfg, dev) if cfg.reversible
                  else [trunk_layer_init(gen, cfg, dev) for _ in range(cfg.depth)]),
    }
    params.update(template_tower_init(gen, cfg, dev))
    return params


def template_buckets(cfg: Alphafold2Config, templates):
    """Templates as distogram-bucket ids: integer templates pass as they
    are; float templates are raw distances in Angstroms, bucketed as the
    JAX package buckets them (searchsorted over the thresholds but the
    last, side left; the threshold range resampled to cfg.num_buckets
    when that differs from the table's 37)."""
    if not templates.dtype.is_floating_point:
        return templates.long()
    table = np.asarray(DISTANCE_THRESHOLDS, np.float32)
    bins = table if cfg.num_buckets == len(table) else np.linspace(
        table[0], table[-1], cfg.num_buckets)
    edges = torch.as_tensor(np.asarray(bins[:-1], np.float32), device=templates.device)
    return torch.searchsorted(edges, templates.float().contiguous())


def template_tower_apply(params, cfg: Alphafold2Config, x, x_mask, templates,
                          templates_mask, rng):
    """The pre-trunk template tower (alphafold2_tpu/models/alphafold2.py
    :116-182). x: pair rep (b, n, n, d); templates: (b, T, n, n) bucket
    ids; templates_mask: (b, T, n, n) bool or None; rng: dropout's
    position (a utils/rng.py Key or a CPU generator; None: eval mode):
    tower layer i draws its masks from position rng.fold_in("tower", i),
    its ops in turn, as each trunk layer does from its own. Per layer: the
    pair rep's axial self-attention (no residual, the reference quirk), the
    templates' axial self-attention (residual), attention along the
    template axis over [x; t_1..t_T] at each pair position (prenorm,
    residual; masked only when both templates_mask and the pair mask are
    given) and the templates' feed-forward (residual). Returns x."""
    b, num_t, n, _ = templates.shape
    d = cfg.dim
    self_cfg = cfg.self_attn_config()

    t = embedding(params["template_emb"], templates, dtype=cfg.dtype)
    n_range = torch.arange(n, device=x.device)
    pos = (
        embedding(params["template_pos_emb"], n_range, dtype=cfg.dtype)[:, None, :]
        + embedding(params["template_pos_emb_ax"], n_range, dtype=cfg.dtype)[None, :, :]
    )
    t = (t + pos[None, None]).reshape(b * num_t, n, n, d)
    t_mask = None if templates_mask is None else templates_mask.reshape(b * num_t, n, n)
    y_mask = None
    if templates_mask is not None and x_mask is not None:
        tm = templates_mask.reshape(b, num_t, n * n).transpose(1, 2)
        y_mask = torch.cat([x_mask.reshape(b, n * n, 1), tm], dim=2).reshape(
            b * n * n, num_t + 1)

    key = as_key(rng, x.device) if dropout_live(cfg, rng) else None
    for index, layer in enumerate(params["template_tower"]):
        gen = None if key is None else key.fold_in("tower", index).generator()
        x = prenorm_axial_apply(layer["seq_attn"], self_cfg, x, mask=x_mask, rng=gen)
        t = prenorm_axial_apply(layer["template_attn"], self_cfg, t, mask=t_mask,
                                rng=gen) + t
        # per pair position, the length-(T + 1) sequence [x; t_1..t_T]
        t_tok = t.reshape(b, num_t, n * n, d).transpose(1, 2)
        y = torch.cat([x.reshape(b, n * n, 1, d), t_tok], dim=2).reshape(
            b * n * n, num_t + 1, d)
        y = attention_apply(layer["joint_attn"]["attn"], self_cfg,
                            layer_norm(layer["joint_attn"]["norm"], y),
                            mask=y_mask, rng=gen) + y
        y = y.reshape(b, n * n, num_t + 1, d)
        x = y[:, :, 0].reshape(b, n, n, d)
        t = y[:, :, 1:].transpose(1, 2).reshape(b * num_t, n, n, d)
        t = prenorm_ff_apply(layer["template_ff"], cfg, t, gen) + t
    return x


def alphafold2_front(params, cfg: Alphafold2Config, seq, msa=None, *,
                     mask=None, msa_mask=None, embedds=None, templates=None,
                     templates_mask=None, rng=None):
    """Everything before the trunk: the embeddings, the MSA stream and,
    given templates, the template tower. Returns (x, m, x_mask, m_mask):
    the pair grid, the MSA stream (or None) and their masks."""
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
    if templates is not None:
        x = template_tower_apply(params, cfg, x, x_mask,
                                  template_buckets(cfg, templates), templates_mask, rng)
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
    (b, n, num_embedds) float, the MSA substitute when msa is None;
    templates: (b, T, n, n) distogram-bucket ints, or floats read as raw
    distances in Angstroms (`template_buckets`); templates_mask: (b, T, n,
    n) bool; rng: dropout's position (a utils/rng.py Key, or a CPU
    generator that seeds new streams with one draw; None: eval mode): the
    template tower's layers draw at rng.fold_in("tower", i), the trunk's at
    rng.fold_in("trunk", i) (a reversible layer's blocks one level
    deeper). Inputs may be numpy arrays or tensors; they are moved to
    `device` (default CUDA; pass device="cpu" for the CPU), where the
    params must lie. trunk_fn
    overrides the trunk (the sequence-parallel one,
    parallel/sp_trunk.py alphafold2_apply_sp), called as
    trunk_fn(params["trunk"], cfg, x, m, x_mask, msa_mask, rng) and
    returning (x, m); a reversible config refuses it. A reversible config
    runs `reversible_trunk_apply` (which needs an MSA stream: msa or
    embedds). Returns distogram logits (b, n, n, num_buckets) in
    cfg.dtype."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    seq = as_device_tensor(seq, dev, torch.long)
    msa = as_device_tensor(msa, dev, torch.long)
    mask = as_device_tensor(mask, dev, torch.bool)
    msa_mask = as_device_tensor(msa_mask, dev, torch.bool)
    embedds = as_device_tensor(embedds, dev, torch.float32)
    templates = as_device_tensor(templates, dev)  # int buckets or float distances
    templates_mask = as_device_tensor(templates_mask, dev, torch.bool)
    rng = as_key(rng, dev) if dropout_live(cfg, rng) else None
    x, m, x_mask, m_mask = alphafold2_front(
        params, cfg, seq, msa, mask=mask, msa_mask=msa_mask, embedds=embedds,
        templates=templates, templates_mask=templates_mask, rng=rng,
    )
    if trunk_fn is not None:
        if cfg.reversible:
            # the reversible trunk's params are not the layer list the
            # hook's contract hands over
            raise ValueError("trunk_fn overrides receive the sequential layer list; "
                             "set reversible=False")
        x, _ = trunk_fn(params["trunk"], cfg, x, m, x_mask, m_mask, rng)
    elif cfg.reversible:
        x, _ = reversible_trunk_apply(params["trunk"], cfg, x, m, x_mask=x_mask,
                                      msa_mask=m_mask, rng=rng)
    else:
        x, _ = sequential_trunk_apply(params["trunk"], cfg, x, m, x_mask=x_mask,
                                      msa_mask=m_mask, rng=rng)
    return alphafold2_head(params, cfg, x)
