"""E(3)-equivariant structure refiner (counterpart of
alphafold2_tpu/models/refiner.py): EGNN-style message passing over a dense
atom cloud, with the JAX package's parameter tree.

  h_ij  = MLP(h_i, h_j, |x_i - x_j|^2)         invariant messages
  a_ij  = sigmoid(w . h_ij)                    attention gate
  x_i  <- x_i + mean_j a_ij (x_i - x_j) / (|.| + 1) phi_x(h_ij)
  h_i  <- LayerNorm(h_i + MLP(h_i, sum_j a_ij h_ij) ... / count)

The pair tensors are dense (b, A, A, msg_dim) with a boolean mask. The
edge MLP's first layer is linear over concat(h_i, h_j, |.|^2), so it is
applied per node and broadcast-added; `atom_chunk` runs the query atoms in
blocks (the same forward; under autograd each block is checkpointed), so
only a (b, chunk, A, msg_dim) block lives at once. The products are
plain matmuls and einsums: no TPU kernel runs here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.ops.core import (
    embedding,
    embedding_init,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
)


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    """The reference's SE3Transformer kwargs (train_end2end.py:86-94: 10
    atom types, dim 64, depth 2). coord_scale scales each layer's
    coordinate delta; the last coordinate layer is zero at init, so an
    untrained refiner is the identity on coordinates. atom_chunk: query
    atoms a block (0 = all at once)."""

    num_tokens: int = 10
    dim: int = 64
    depth: int = 2
    msg_dim: int = 64
    dtype: torch.dtype = torch.float32
    coord_scale: float = 1.0
    atom_chunk: int = 0


def _mlp_init(gen, d_in, d_hidden, d_out, device):
    return {"l1": linear_init(gen, d_in, d_hidden, device),
            "l2": linear_init(gen, d_hidden, d_out, device)}


def _mlp(params, x, dtype):
    return linear(params["l2"], F.silu(linear(params["l1"], x, dtype=dtype)), dtype=dtype)


def refiner_init(cfg: RefinerConfig, generator: torch.Generator, device):
    """Random parameters in the JAX package's tree, drawn from the CPU
    `generator` and moved to `device`; each layer's coord_mlp.l2 is zero."""
    device = resolve_device(device)
    params = {
        "token_emb": embedding_init(generator, cfg.num_tokens, cfg.dim, device),
        "out_norm": layer_norm_init(cfg.dim, device),
        "layers": [],
    }
    for _ in range(cfg.depth):
        layer = {
            "edge_mlp": _mlp_init(generator, 2 * cfg.dim + 1, cfg.msg_dim, cfg.msg_dim, device),
            "att": linear_init(generator, cfg.msg_dim, 1, device),
            "coord_mlp": _mlp_init(generator, cfg.msg_dim, cfg.msg_dim, 1, device),
            "node_mlp": _mlp_init(generator, cfg.dim + cfg.msg_dim, cfg.dim, cfg.dim, device),
            "norm": layer_norm_init(cfg.dim, device),
        }
        layer["coord_mlp"]["l2"] = {k: torch.zeros_like(v)
                                    for k, v in layer["coord_mlp"]["l2"].items()}
        params["layers"].append(layer)
    return params


def _message_pass(layer, dtype, hq_pre, hk_pre, coords_q, coords_all, pair_mask_q, w_sq, b1):
    """Messages from every atom to a block of query atoms: hq_pre,
    coords_q, pair_mask_q are the block's (b, qb, ...) slices, hk_pre and
    coords_all the (b, A, ...) key side. Returns the block's coordinate
    delta (b, qb, 3) f32 and gated message sum (b, qb, msg)."""
    diff = coords_q[:, :, None, :] - coords_all[:, None, :, :]  # (b, qb, A, 3)
    sqdist = diff.square().sum(dim=-1, keepdim=True)
    pre = hq_pre[:, :, None, :] + hk_pre[:, None, :, :] + sqdist.to(dtype) * w_sq + b1
    m = linear(layer["edge_mlp"]["l2"], F.silu(pre), dtype=dtype)
    gate = torch.sigmoid(linear(layer["att"], m, dtype=dtype))  # (b, qb, A, 1)
    gate = torch.where(pair_mask_q[..., None], gate, 0.0)
    coef = _mlp(layer["coord_mlp"], m, dtype).float()
    # clamp before the sqrt: coincident atoms (the proto cloud parks every
    # side-chain slot at one point) and the diagonal have sqdist == 0,
    # where sqrt's gradient is inf
    norm = torch.sqrt(sqdist.clamp_min(1e-12))
    direction = torch.where(pair_mask_q[..., None], diff, 0.0) / (norm + 1.0)
    delta = (gate.float() * coef * direction).sum(dim=2)
    agg = (gate * m).sum(dim=2)
    return delta, agg


def refiner_apply(params, cfg: RefinerConfig, tokens, coords, mask=None):
    """Refine an atom point cloud.

    tokens: (b, A) int atom-type ids; coords: (b, A, 3) float; mask: (b, A)
    bool atom presence (masked atoms neither send messages nor move).
    Tensors on the params' device. Returns (refined coords (b, A, 3) f32,
    node features (b, A, dim))."""
    b, num_atoms = tokens.shape
    dtype = cfg.dtype
    dev = coords.device
    coords = coords.float()
    if mask is None:
        mask = torch.ones((b, num_atoms), dtype=torch.bool, device=dev)
    eye = torch.eye(num_atoms, dtype=torch.bool, device=dev)[None]
    pair_mask = mask[:, :, None] & mask[:, None, :] & ~eye
    denom = pair_mask.sum(dim=-1, keepdim=True).clamp_min(1).float()
    h = embedding(params["token_emb"], tokens, dtype=dtype)
    chunk = cfg.atom_chunk
    for layer in params["layers"]:
        d = h.shape[-1]
        w1 = layer["edge_mlp"]["l1"]["w"].to(dtype)
        b1 = layer["edge_mlp"]["l1"]["b"].to(dtype)
        hd = h.to(dtype)
        hq_pre, hk_pre, w_sq = hd @ w1[:d], hd @ w1[d:2 * d], w1[2 * d]
        if not chunk or num_atoms <= chunk:
            delta, agg = _message_pass(layer, dtype, hq_pre, hk_pre, coords, coords,
                                       pair_mask, w_sq, b1)
        else:
            parts = []
            for s in range(0, num_atoms, chunk):
                args = (layer, dtype, hq_pre[:, s:s + chunk], hk_pre, coords[:, s:s + chunk],
                        coords, pair_mask[:, s:s + chunk], w_sq, b1)
                parts.append(checkpoint(_message_pass, *args, use_reentrant=False)
                             if torch.is_grad_enabled() else _message_pass(*args))
            delta = torch.cat([p[0] for p in parts], dim=1)
            agg = torch.cat([p[1] for p in parts], dim=1)
        delta = delta / denom
        coords = coords + cfg.coord_scale * torch.where(mask[..., None], delta, 0.0)
        agg = agg / denom.to(agg.dtype)
        upd = _mlp(layer["node_mlp"], torch.cat([h, agg], dim=-1), dtype)
        h = layer_norm(layer["norm"], h + upd)
    return coords, h
