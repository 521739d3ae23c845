"""The port's north-star preset (alphafold2_tpu_torch/training/presets.py)
against the JAX package's, field by field in all three tiers: the model,
the refiner and the e2e config. Two named differences: the north-star
tier's attention knobs (`attn_batch_chunk`, `attn_flash_tile_elems`),
which JAX sets by depth from TPU measurements and the port leaves at its
own defaults, and the dtype (`jnp.bfloat16` <-> `torch.bfloat16`).
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from alphafold2_tpu.training import presets as jax_presets
from alphafold2_tpu_torch.training import presets

ATTN_KNOBS = ("attn_batch_chunk", "attn_flash_tile_elems")
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _assert_same(jcfg, tcfg, skip=()):
    for f in dataclasses.fields(tcfg):
        if f.name in skip or f.name in ("model", "refiner"):
            continue
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "dtype":
            want = DTYPES[want]
        assert got == want, (f.name, got, want)


@pytest.mark.parametrize("tier,depth", [("north_star", 48), ("north_star", 2),
                                        ("smoke", 2), ("proportional", 4)])
def test_preset_matches_jax(tier, depth):
    jecfg, jcrop, jrows = jax_presets.north_star_e2e_config(depth, tier=tier)
    ecfg, crop, rows = presets.north_star_e2e_config(depth, tier=tier)
    assert (crop, rows) == (jcrop, jrows)
    skip = ATTN_KNOBS if tier == "north_star" else ()
    _assert_same(jecfg.model, ecfg.model, skip)
    _assert_same(jecfg.refiner, ecfg.refiner)
    _assert_same(jecfg, ecfg)
    assert ecfg.model.reversible and ecfg.model.depth == depth
    # the port's own attention defaults in every tier
    assert (ecfg.model.attn_batch_chunk, ecfg.model.attn_flash_tile_elems) == (0, 1 << 25)


def test_constants_match_jax():
    for name in ("NORTH_STAR_CROP", "NORTH_STAR_MSA_ROWS", "SMOKE_CROP", "SMOKE_MSA_ROWS",
                 "PROPORTIONAL_CROP", "PROPORTIONAL_MSA_ROWS"):
        assert getattr(presets, name) == getattr(jax_presets, name), name


def test_smoke_spelling_and_conflict():
    assert presets.north_star_e2e_config(2, smoke=True) == presets.north_star_e2e_config(
        2, tier="smoke")
    with pytest.raises(ValueError, match="conflicts"):
        presets.north_star_e2e_config(2, smoke=True, tier="proportional")


def test_overrides_patch_the_right_configs():
    ecfg, _, _ = presets.north_star_e2e_config(
        2, model_overrides={"reversible": False, "remat": True},
        e2e_overrides={"mds_iters": 200, "mds_init": "random"})
    assert not ecfg.model.reversible and ecfg.model.remat
    assert (ecfg.mds_iters, ecfg.mds_init) == (200, "random")
    # the rest of the tier stays
    assert ecfg.model.dim == 256 and ecfg.model.dtype == torch.bfloat16
    assert ecfg.refiner.atom_chunk == 256


@pytest.mark.parametrize("which", ["model_overrides", "e2e_overrides"])
def test_unknown_override_fails_loudly(which):
    with pytest.raises(TypeError):
        presets.north_star_e2e_config(2, **{which: {"no_such_knob": 1}})


def test_reversible_and_remat_override_is_refused():
    with pytest.raises(ValueError, match="mutually exclusive"):
        presets.north_star_e2e_config(2, model_overrides={"remat": True})

