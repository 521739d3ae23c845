"""The partition-rule registry (counterpart of alphafold2_tpu/parallel/rules.py):
a regex over a leaf's slash-joined path names its placement, first match
wins, and the matched spec is adapted to the leaf's rank.

The rules are the JAX package's, matched over the names and layouts
`models/convert.py` gives the port's tree in JAX's layout: a train state
(`training/harness.py train_state`) as `train_state_to_jax` lays it out
(params, AdamW's moments under optax's `opt_state/1/0/mu|nu/...`, the
reversible trunk's leaves stacked along a leading depth axis, the
KV-compression conv as (k, in/groups, out)); a parameter tree as
`params_to_jax` lays it out. A spec is a plain tuple of mesh-axis names
(None: not partitioned), JAX's `PartitionSpec` as a tuple; () replicates.

The port trains data-parallel, where every leaf is replicated
(`REPLICATED_RULES`); the tensor-parallel rules (`TP_RULES`) name the
layout that ROADMAP A13-tp would bind to a "model" axis, and the coverage
checks (an unmatched or rank-incompatible non-scalar leaf raises) hold
over either.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

Spec = Tuple[Optional[str], ...]
Rule = Tuple[str, Spec]

#: Tensor-parallel rules over the "model" mesh axis (JAX's TP_RULES), at
#: each leaf's base rank; the trailing name-anchored rule closes the
#: parameter vocabulary, so a leaf outside it is an unmatched-leaf error.
TP_RULES: Tuple[Rule, ...] = (
    # column-parallel: shard the output (head / FF-inner) dim
    (r"(^|/)(to_q|to_kv|proj_in)/w$", (None, "model")),
    (r"(^|/)(to_q|to_kv|proj_in)/b$", ("model",)),
    # row-parallel: shard the input dim
    (r"(^|/)(to_out|proj_out)/w$", ("model", None)),
    # KV-compression conv kernel (k, in_per_group, out) / bias (out,)
    (r"(^|/)compress/w$", (None, None, "model")),
    (r"(^|/)compress/b$", ("model",)),
    # the rest of the parameter vocabulary stays replicated
    (r"(^|/)(w|b|table|scale|bias|qw)$", ()),
)

#: Fully replicated (tp=False, or a mesh without a "model" axis).
REPLICATED_RULES: Tuple[Rule, ...] = ((r".", ()),)


def partition_rules(tp: bool = True) -> Tuple[Rule, ...]:
    """TP_RULES when the mesh has a "model" axis to shard over, else
    everything replicated."""
    return TP_RULES if tp else REPLICATED_RULES


def rule_axes(rules: Sequence[Rule]) -> set:
    """Every mesh-axis name a rule set names."""
    axes: set = set()
    for _pattern, spec in rules:
        for entry in spec:
            if isinstance(entry, (tuple, list)):
                axes.update(entry)
            elif entry is not None:
                axes.add(entry)
    return axes


def path_string(segs, sep: str = "/") -> str:
    """A `models/convert.py` path ([["k", key], ["i", n], ["a", name], ...])
    as JAX's `tree_path_string` names the same leaf."""
    return sep.join(str(seg[1]) for seg in segs)


def named_leaves(tree: Any, sep: str = "/") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) of every leaf in JAX's layout and flatten order: a
    train state through `train_state_to_jax`, any other tree of tensors
    through `params_to_jax`."""
    from alphafold2_tpu_torch.models.convert import (
        leaf_paths,
        params_to_jax,
        train_state_to_jax,
    )

    if isinstance(tree, dict) and "optimizer" in tree and "params" in tree:
        items = train_state_to_jax(tree)
    else:
        items = leaf_paths(params_to_jax(tree))
    for segs, leaf in items:
        yield path_string(segs, sep), leaf


def named_tree_map(f: Callable[[str, Any], Any], tree: Any, *, sep: str = "/") -> dict:
    """{name: f(name, leaf)} over `named_leaves(tree)`: the port's trees
    are not pytrees, so the result is flat, in JAX's flatten order."""
    return {name: f(name, leaf) for name, leaf in named_leaves(tree, sep)}


def _is_scalar(leaf) -> bool:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return True  # a non-array leaf replicates
    return len(shape) == 0 or int(np.prod(tuple(shape))) == 1


def spec_for_leaf(name: str, leaf, rules: Sequence[Rule]) -> Optional[Spec]:
    """First-match spec for one leaf, rank-adapted; None when no rule
    matches a non-scalar leaf. A spec of k entries applies to a rank-k
    leaf; a rank-(k + 1) leaf is depth-stacked (the reversible trunk) and
    gets (None, *spec); any other rank under a partitioning spec raises."""
    if _is_scalar(leaf):
        return ()
    for pattern, spec in rules:
        if re.search(pattern, name) is None:
            continue
        k = len(spec)
        if k == 0:
            return ()
        ndim = len(leaf.shape)
        if ndim == k:
            return tuple(spec)
        if ndim == k + 1:
            return (None, *spec)
        raise ValueError(
            f"partition rule {pattern!r} matched {name!r} but its spec {spec} is written "
            f"for rank {k} (or depth-stacked rank {k + 1}) and the leaf has rank {ndim} — "
            "fix the rule or the parameter layout")
    return None


def match_partition_rules(rules: Sequence[Rule], tree: Any, *, sep: str = "/") -> dict:
    """{name: spec} for every leaf of `tree` (`named_leaves`). Scalar
    leaves replicate without the rules; a non-scalar leaf no rule matches
    raises."""

    def get_spec(name: str, leaf) -> Spec:
        spec = spec_for_leaf(name, leaf, rules)
        if spec is None:
            raise ValueError(
                f"no partition rule matched {name!r} (shape {tuple(leaf.shape)}) — add a "
                "rule to the registry (alphafold2_tpu_torch/parallel/rules.py); unmatched "
                "non-scalar leaves do not silently replicate")
        return spec

    return named_tree_map(get_spec, tree, sep=sep)


def unmatched_leaves(rules: Sequence[Rule], tree: Any, *,
                     sep: str = "/") -> List[Tuple[str, tuple]]:
    """(name, shape) of every non-scalar leaf no rule matches, a
    rank-incompatible match counting as unmatched."""
    missing: List[Tuple[str, tuple]] = []
    for name, leaf in named_leaves(tree, sep):
        try:
            spec = spec_for_leaf(name, leaf, rules)
        except ValueError:
            spec = None
        if spec is None:
            missing.append((name, tuple(getattr(leaf, "shape", ()))))
    return missing

