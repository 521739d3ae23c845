"""The port's partition-rule registry (`alphafold2_tpu_torch/parallel/rules.py`)
against the JAX package's (`alphafold2_tpu/parallel/rules.py`).

The port matches JAX's rules over its train state as `models/convert.py`
lays it out in JAX's layout (params, optax's mu / nu mirrors, counts, the
reversible trunk's depth-stacked leaves): for each leaf of a state
converted from the same JAX init, the port's spec is JAX's spec as a
tuple, under the tensor-parallel and the replicated rules. Unmatched and
rank-incompatible leaves raise, as in tests/test_partition_rules.py; the
placements replicate on a "data" mesh and refuse a "model" one (A13-tp).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.parallel import rules as jrules
from alphafold2_tpu.training import harness as jharness
from alphafold2_tpu_torch import Alphafold2Config, params_from_jax
from alphafold2_tpu_torch.parallel import make_mesh, rules, sharding
from alphafold2_tpu_torch.training import harness

FLAGSHIP = dict(dim=16, depth=2, heads=2, dim_head=8, max_seq_len=32, msa_tie_row_attn=True,
                cross_attn_compress_ratio=2)


@functools.lru_cache(maxsize=None)
def state_pair(reversible):
    """(JAX train state, the port's train state) of one JAX init (read,
    never changed, by the tests that share it)."""
    kw = dict(FLAGSHIP, reversible=reversible)
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig(**kw))
    jt = jharness.TrainConfig(grad_accum=1)
    jstate = {"params": jparams, "opt_state": jharness.make_optimizer(jt).init(jparams),
              "step": np.zeros((), np.int32)}
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              Alphafold2Config(**kw), device="cpu")
    return jstate, harness.train_state(tparams, harness.TrainConfig(grad_accum=1))


def jax_specs(jrule_set, jstate):
    specs = jrules.match_partition_rules(jrule_set, jstate)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {jrules.tree_path_string(path): tuple(spec) for path, spec in flat}


@pytest.mark.parametrize("tp", [True, False], ids=["tp_rules", "replicated"])
@pytest.mark.parametrize("reversible", [False, True], ids=["dense", "reversible"])
def test_every_leaf_gets_jaxs_spec(reversible, tp):
    """Every leaf of the converted state (params, mu / nu, counts, step),
    by name and in JAX's flatten order, carries JAX's spec as a tuple;
    the reversible state's stacked trunk leaves included."""
    jstate, tstate = state_pair(reversible)
    want = jax_specs(jrules.partition_rules(tp), jstate)
    got = rules.match_partition_rules(rules.partition_rules(tp), tstate)
    assert list(got) == list(want)
    assert got == want
    names = [n for n in got if "/mu/" in n or "/nu/" in n]
    assert names and any(n.startswith("params/") for n in got)
    if reversible and tp:
        stacked = [s for n, s in got.items() if "trunk" in n and n.endswith("to_q/w")]
        assert stacked and all(s == (None, None, "model") for s in stacked)


def test_registry_is_jaxs():
    """The same regexes and specs, the specs as tuples."""
    assert [(p, tuple(s)) for p, s in jrules.TP_RULES] == list(rules.TP_RULES)
    assert [(p, tuple(s)) for p, s in jrules.REPLICATED_RULES] == list(rules.REPLICATED_RULES)
    assert rules.rule_axes(rules.TP_RULES) == jrules.rule_axes(jrules.TP_RULES) == {"model"}
    assert rules.rule_axes(rules.REPLICATED_RULES) == set()


def test_scalar_leaves_replicate_without_the_rules():
    tree = {"step": torch.zeros(()), "one": torch.zeros((1,))}
    got = rules.match_partition_rules([(r"never_matches_anything", ("model",))], tree)
    assert got == {"one": (), "step": ()}


def test_unmatched_leaf_raises():
    tree = {"novel_module": {"mystery_kernel": torch.zeros((4, 4))}}
    with pytest.raises(ValueError, match="no partition rule matched"):
        rules.match_partition_rules(rules.TP_RULES, tree)
    assert rules.unmatched_leaves(rules.TP_RULES, tree) == [("novel_module/mystery_kernel",
                                                             (4, 4))]


def test_rank_incompatible_rule_raises():
    with pytest.raises(ValueError, match="rank"):
        rules.spec_for_leaf("x/to_q/w", torch.zeros((2, 2, 3, 4)), rules.TP_RULES)
    tree = {"to_q": {"w": torch.zeros((2, 2, 3, 4))}}
    assert rules.unmatched_leaves(rules.TP_RULES, tree) == [("to_q/w", (2, 2, 3, 4))]


def test_placements_replicate_on_a_data_mesh_and_refuse_a_model_mesh():
    """state_shardings binds every leaf replicated to a "data" mesh;
    batch_shardings splits axis 1 over "data"; a "model" mesh is refused
    naming A13-tp."""
    _, tstate = state_pair(False)
    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    placed = sharding.state_shardings(mesh, tstate, tp=True)
    assert placed and all(p == sharding.Placement(mesh, ()) for p in placed.values())
    batch = {"seq": np.zeros((2, 4, 8)), "mask": np.zeros((2, 4, 8), bool)}
    assert sharding.batch_shardings(mesh, batch)["seq"].spec == (None, "data", None)
    assert sharding.batch_shardings(mesh, batch, microbatched=False)["mask"].spec == (
        "data", None, None)
    assert sharding.replicated(mesh) == sharding.Placement(mesh, ())
    assert sharding.host_to_global(tstate, placed) is tstate  # one process: as it is
    model = make_mesh({"model": 2}, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="A13-tp"):
        sharding.state_shardings(model, tstate)
    with pytest.raises(NotImplementedError, match="A13-tp"):
        sharding.batch_shardings(model, batch)
