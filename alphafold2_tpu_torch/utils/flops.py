"""Analytic model-FLOP accounting (a copy of alphafold2_tpu/utils/flops.py
for the port's config), so a run on the card can state its MFU.

The formulas count the matmul FLOPs (2*M*N*K per dot) of the model as
configured; the elementwise, softmax and norm work (a few percent) is left
out, so an MFU derived from them is conservative. Shapes follow
alphafold2_apply: pair grid (b, n, n, dim); MSA (b, r, c, dim).
"""

from __future__ import annotations

from alphafold2_tpu_torch.models.config import Alphafold2Config

# NVIDIA H100 SXM, dense bf16 on the tensor cores (data sheet, 700 W)
H100_PEAK_BF16_FLOPS = 989e12


def attention_flops(tokens_q: float, tokens_kv: float, j_eff: float, dim: int,
                    inner: int) -> float:
    """One multi-head attention pass: to_q + to_out, to_kv, QK^T + PV.
    j_eff: keys each query attends."""
    proj_q_out = 4.0 * tokens_q * dim * inner
    proj_kv = 4.0 * tokens_kv * dim * inner
    attn = 4.0 * tokens_q * j_eff * inner
    return proj_q_out + proj_kv + attn


def ff_flops(tokens: float, dim: int, mult: int = 4) -> float:
    """GEGLU feed-forward: d -> 2*mult*d, then mult*d -> d."""
    return tokens * (4.0 * mult * dim * dim + 2.0 * mult * dim * dim)


def trunk_layer_op_flops(cfg: Alphafold2Config, n: int, r: int, c: int) -> dict:
    """Per-op matmul FLOPs of ONE trunk layer at pair side n, MSA r x c."""
    d, w = cfg.dim, cfg.heads * cfg.dim_head
    rho = max(1, cfg.cross_attn_compress_ratio)
    # grouped strided KV-compression conv, applied to k and v
    conv = (lambda j_kv: 4.0 * j_kv * w * w / cfg.heads) if rho > 1 else (
        lambda j_kv: 0.0)

    ops = {"pair_axial": 2 * attention_flops(n * n, n * n, n, d, w)}
    if r and c:
        ops["msa_axial"] = (attention_flops(r * c, r * c, c, d, w)
                            + attention_flops(r * c, r * c, r, d, w))
        if cfg.cross_attn_mode == "aligned":
            f = max(1, n // c)
            ops["cross_pair_from_msa"] = attention_flops(
                n * n, r * c, max(1.0, r / rho), d, w) + conv(r * c)
            ops["cross_msa_from_pair"] = attention_flops(
                r * c, n * n, max(1.0, n * f / rho), d, w) + conv(n * n)
        else:
            ops["cross_pair_from_msa"] = attention_flops(
                n * n, r * c, r * c / rho, d, w) + conv(r * c)
            ops["cross_msa_from_pair"] = attention_flops(
                r * c, n * n, n * n / rho, d, w) + conv(n * n)
    ffs_per_stream = 2 if cfg.reversible else 1
    ops["ff_pair"] = ffs_per_stream * ff_flops(n * n, d)
    if r and c:
        ops["ff_msa"] = ffs_per_stream * ff_flops(r * c, d)
    return ops


def trunk_layer_flops(cfg: Alphafold2Config, n: int, r: int, c: int) -> float:
    return sum(trunk_layer_op_flops(cfg, n, r, c).values())


def model_fwd_flops(cfg: Alphafold2Config, n: int, r: int, c: int) -> float:
    """The whole alphafold2_apply forward: trunk + distogram head."""
    head = 2.0 * n * n * cfg.dim * cfg.num_buckets
    return cfg.depth * trunk_layer_flops(cfg, n, r, c) + head


def train_step_flops(cfg: Alphafold2Config, n: int, r: int, c: int,
                     grad_accum: int = 1) -> float:
    """One optimizer step: the backward of a matmul chain costs ~2x its
    forward, and a remat'd (or reversible) trunk recomputes the forward:
    multiplier 4 then, 3 otherwise."""
    mult = 4.0 if (cfg.reversible or cfg.remat) else 3.0
    return grad_accum * mult * model_fwd_flops(cfg, n, r, c)
