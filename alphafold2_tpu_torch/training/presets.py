"""The north-star configuration, built in one place (counterpart of
alphafold2_tpu/training/presets.py).

BASELINE.md's config 5: the full end-to-end structure train step — the
reversible tied-row trunk on the (3 * 384)^2 pair grid, 128 MSA rows,
the column-aligned crosses, distogram -> MDS -> side-chain lift -> EGNN
refiner -> weighted Kabsch RMSD — dim 256, 8 heads, bfloat16.

Three tiers, as in JAX: "north_star" (the target), "smoke" (tiny CPU
shapes) and "proportional" (1/8 of the crop, the north star's ratios).
`smoke=True` is the old spelling of tier="smoke".

One planned difference: the north-star tier's attention knobs. JAX sets
`attn_batch_chunk` and `attn_flash_tile_elems` by depth
(`depth_aware_attn_defaults`), thresholds measured on a TPU for XLA's
streaming path and its memory. The port's flash kernels tile on their own
and have no such measurement, so every tier keeps the port's defaults
(`attn_batch_chunk` 0, `attn_flash_tile_elems` 2^25), which are the
smoke and proportional tiers' values in JAX. The dtype maps
`jnp.bfloat16` to `torch.bfloat16`.
"""

from __future__ import annotations

import dataclasses

import torch

from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.refiner import RefinerConfig
from alphafold2_tpu_torch.training.e2e import E2EConfig

NORTH_STAR_CROP = 384
NORTH_STAR_MSA_ROWS = 128
SMOKE_CROP = 16
SMOKE_MSA_ROWS = 4
# the proportional tier keeps the north star's ratios (crop : MSA rows =
# 3 : 1, compress ratio 4, aligned crosses, the reversible tied-row trunk)
# at 1/8 of the crop
PROPORTIONAL_CROP = 48
PROPORTIONAL_MSA_ROWS = 16


def north_star_e2e_config(depth: int, *, smoke: bool = False, tier: str | None = None,
                          model_overrides: dict | None = None,
                          e2e_overrides: dict | None = None):
    """The north-star E2EConfig (BASELINE.md config 5) at `depth`.

    Returns (ecfg, crop, msa_rows). model_overrides / e2e_overrides are
    `dataclasses.replace` patches of the model / e2e config: an unknown
    field raises TypeError. tier: "north_star" (default), "smoke" or
    "proportional"; smoke=True is tier="smoke"."""
    if smoke and tier not in (None, "smoke"):
        raise ValueError(f"smoke=True conflicts with tier={tier!r}")
    tier = tier or ("smoke" if smoke else "north_star")
    # one row a tier: crop, msa_rows, dim, dim_head, compress, refiner dim,
    # MDS iterations, MDS init (the north star's 25 from the classical
    # init is the JAX package's promoted default)
    crop, msa_rows, dim, dim_head, compress, rdim, mds_iters, mds_init = {
        "north_star": (NORTH_STAR_CROP, NORTH_STAR_MSA_ROWS, 256, 64, 4, 64, 25, "classical"),
        "smoke": (SMOKE_CROP, SMOKE_MSA_ROWS, 32, 16, 1, 16, 5, "random"),
        "proportional": (PROPORTIONAL_CROP, PROPORTIONAL_MSA_ROWS, 64, 16, 4, 32, 25, "random"),
    }[tier]
    north_star = tier == "north_star"
    dtype = torch.bfloat16 if north_star else torch.float32
    model = Alphafold2Config(
        dim=dim, depth=depth, heads=8, dim_head=dim_head, max_seq_len=2048,
        max_num_msa=max(msa_rows, 20), dtype=dtype,
        reversible=True,  # activation memory that does not grow with depth
        msa_tie_row_attn=True,
        cross_attn_compress_ratio=compress,
        cross_attn_mode="aligned",
        attn_flash="auto",
        attn_batch_chunk=0, attn_flash_tile_elems=1 << 25,
        # bounds the 2048-wide GEGLU intermediate on the pair stream
        ff_chunk_size=32768 if north_star else 0,
    )
    if model_overrides:
        model = dataclasses.replace(model, **model_overrides)
    ecfg = E2EConfig(
        model=model,
        refiner=RefinerConfig(num_tokens=14, dim=rdim, depth=2, msg_dim=rdim, dtype=dtype,
                              # bounds the (A, A, msg) message tensor at 5376 atoms
                              atom_chunk=256 if north_star else 0),
        mds_iters=mds_iters,
        mds_init=mds_init,
    )
    if e2e_overrides:
        ecfg = dataclasses.replace(ecfg, **e2e_overrides)
    return ecfg, crop, msa_rows
