"""The port's parameters and train state <-> the JAX package's layout.

`params_from_jax(tree, cfg, device)` maps the JAX package's parameter
pytree (the output of `alphafold2_init`, leaves as numpy arrays) onto the
port's parameter dicts, so both sides compute the same function;
`params_to_jax(params)` is its inverse. The port keeps the JAX names and
layouts, with two exceptions: the KV-compression conv weight, (k,
in/groups, out) in JAX, is (out, in/groups, k) for
`torch.nn.functional.conv1d` (the reverse of
alphafold2_tpu/models/convert.py's torch -> JAX map); and the reversible
trunk, a dict of depth-stacked leaves in JAX, is the port's list of
layer dicts (`unstack_layers`; `stack_layers` stacks it back). The template
tower's leaves map like the trunk's; so do the embedder's, the refiner's
and the end-to-end {"model", "refiner"} tree's (`embedder_params_from_jax`,
`refiner_params_from_jax`, `e2e_params_from_jax`). `params_from_jax` makes leaves
float32, but int8 and bool leaves keep their type, so an int8 tree from
the JAX package's `quantize_tree` maps over as {"qw": int8, "scale": f32}.

The state bridge maps the port's train state (`training/harness.py
train_state`: the params, `ClippedAdamW`, the update count) onto the JAX
package's `TrainState` tree, leaf by leaf, as (path, host array) pairs in
`jax.tree_util` flatten order (dict keys sorted, a path segment ["k",
key], ["i", index] or ["a", attribute], as the checkpoint manifests write
them):

  params                      <-> ["k","params"], ...
  AdamW's per-leaf step       <-> ["k","opt_state"],["i",1],["i",0],["a","count"]
  AdamW's exp_avg, exp_avg_sq <-> ... ["a","mu"], ... / ... ["a","nu"], ...
  state["step"]               <-> ["k","opt_state"],["i",1],["i",2],["a","count"]
                                  and ["k","step"]

(optax's `chain(clip_by_global_norm, adamw)` state: the clip's
`EmptyState`, then `ScaleByAdamState`, the weight decay's `EmptyState`
and `ScaleByScheduleState`; the empty states hold no leaves.) A restore
copies into the live tensors and never rebinds one, so a captured train
step (`training/executable.py`) keeps its addresses.

A reversible trunk's leaves, and AdamW's moments of them, map onto the
stacked leaves of JAX's trunk and of optax's `mu` / `nu` (paths ["k",
"trunk"], ["k", block], ..., with no ["i", layer] segment), layer l at
index l of the depth axis. The layout changes only at the edges: on the
way out `params_to_jax` stacks the trunk, on the way in `_per_layer`
splits the stored leaves; the path code between them is per layer.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from alphafold2_tpu_torch.device import resolve_device, tree_leaves
from alphafold2_tpu_torch.models.config import Alphafold2Config


def convert_tree(tree, device, path=()):
    """Map any JAX parameter subtree (numpy leaves) onto `device`."""
    if isinstance(tree, dict):
        return {k: convert_tree(v, device, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [convert_tree(v, device, path) for v in tree]
    arr = np.array(tree)  # a writable copy
    if arr.dtype not in (np.int8, np.bool_):
        # floats (bf16 included) become f32; int8 (a quantized "qw") and
        # bool leaves keep their type
        arr = arr.astype(np.float32)
    if path[-2:] == ("compress", "w"):
        arr = np.transpose(arr, (2, 1, 0))  # (k, in/g, out) -> (out, in/g, k)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def unstack_layers(stacked):
    """A depth-stacked JAX trunk (every leaf (depth, ...), the reversible
    trunk's layout) as a list of per-layer trees (JAX `unstack_layers`).
    Raises unless every leaf leads with the same depth."""
    depths = {np.shape(a)[0] if np.ndim(a) else None for a in tree_leaves(stacked)}
    if len(depths) != 1 or None in depths:
        raise ValueError(f"a stacked trunk's leaves must share their leading (depth) axis, "
                         f"got {sorted(map(str, depths))}")
    (depth,) = depths

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [layer(v, i) for v in tree]
        return np.asarray(tree)[i]

    return [layer(stacked, i) for i in range(depth)]


def params_from_jax(tree, cfg: Alphafold2Config, device=None):
    """Map a JAX parameter tree (numpy leaves) onto `device` (default CUDA).
    `cfg` is the port config the tree was made for; its depth is checked
    against the tree's trunk. A reversible config's JAX trunk is a dict of
    depth-stacked leaves (`reversible_trunk_init`): it is unstacked into
    the port's list of layer dicts, the depth read from the leading axis,
    and each layer's compress-conv weight transposed after unstacking."""
    trunk = tree.get("trunk")
    if cfg.reversible:
        if not isinstance(trunk, dict):
            raise ValueError("expected a reversible trunk: a dict of depth-stacked leaves")
        tree = dict(tree, trunk=unstack_layers(trunk))
    elif not isinstance(trunk, (list, tuple)):
        raise ValueError("expected a sequential trunk: a list of layer params")
    if len(tree["trunk"]) != cfg.depth:
        raise ValueError(f"tree has {len(tree['trunk'])} trunk layers, cfg.depth={cfg.depth}")
    return convert_tree(tree, resolve_device(device))


def embedder_params_from_jax(tree, device=None):
    """Map the JAX embedder's tree (`embedder_init`, numpy leaves) onto
    `device` (default CUDA): the same names and layouts."""
    return convert_tree(tree, resolve_device(device))


def refiner_params_from_jax(tree, device=None):
    """Map the JAX refiner's tree (`refiner_init`, numpy leaves) onto
    `device` (default CUDA): the same names and layouts."""
    return convert_tree(tree, resolve_device(device))


def e2e_params_from_jax(tree, ecfg, device=None):
    """Map the JAX end-to-end tree {"model", "refiner"} (`e2e_params_init`,
    numpy leaves) onto `device` (default CUDA); `ecfg` is the port's
    E2EConfig (its model config checks the trunk's depth). The inverse is
    `params_to_jax`, which takes any tree of the port's."""
    return {"model": params_from_jax(tree["model"], ecfg.model, device),
            "refiner": refiner_params_from_jax(tree["refiner"], device)}


# --- the inverse map and the state bridge -------------------------------------

_COMPRESS = ("compress", "w")
PARAMS = [["k", "params"]]
_ADAM = [["k", "opt_state"], ["i", 1], ["i", 0]]
ADAM_COUNT = _ADAM + [["a", "count"]]
SCHEDULE_COUNT = [["k", "opt_state"], ["i", 1], ["i", 2], ["a", "count"]]
STEP = [["k", "step"]]


def leaf_paths(tree, prefix=()):
    """(path segments, leaf) pairs in `jax.tree_util` flatten order: dict
    keys sorted, sequences in order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaf_paths(tree[key], prefix + (["k", key],))
    elif isinstance(tree, (list, tuple)):
        for n, val in enumerate(tree):
            yield from leaf_paths(val, prefix + (["i", n],))
    else:
        yield list(prefix), tree


def _is_compress(segs) -> bool:
    return tuple(s[1] for s in segs[-2:]) == _COMPRESS


_TRUNK = ["k", "trunk"]


def _is_reversible_trunk(val) -> bool:
    # a reversible layer, and only one, carries the second feed-forwards
    return (isinstance(val, (list, tuple)) and len(val) > 0 and isinstance(val[0], dict)
            and "seq_ff2" in val[0])


def stack_layers(layers):
    """Per-layer host trees as one tree of depth-stacked leaves (JAX
    `stack_layers`; the inverse of `unstack_layers`)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in layers]) for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_layers(list(parts)) for parts in zip(*layers)]
    return torch.stack(layers) if isinstance(first, torch.Tensor) else np.stack(layers)


def host_leaf(t: torch.Tensor, segs):
    """A tensor of the port's tree as a host leaf in JAX's layout: a numpy
    array, or a CPU tensor for a dtype numpy lacks (bfloat16)."""
    t = t.detach()
    if _is_compress(segs):
        t = t.permute(2, 1, 0)  # (out, in/g, k) -> (k, in/g, out)
    t = t.contiguous().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def params_to_jax(tree, path=()):
    """The port's parameter tree as numpy arrays in the JAX package's layout
    (the inverse of `params_from_jax`: a reversible trunk's layers, each
    laid out first, stacked back; bfloat16 leaves stay CPU tensors)."""
    if isinstance(tree, dict):
        out = {k: params_to_jax(v, path + (["k", k],)) for k, v in tree.items()}
        if _is_reversible_trunk(tree.get("trunk")):
            out["trunk"] = stack_layers(out["trunk"])
        return out
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v, path + (["i", n],)) for n, v in enumerate(tree)]
    return host_leaf(tree, list(path))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _adamw_state(opt, p):
    return opt.adamw.state.get(p) or {}


def train_state_to_jax(state):
    """The port's train state as (path, host leaf) pairs of the JAX
    package's `TrainState`, in its flatten order (through `params_to_jax`,
    so a reversible trunk's params and moments are stacked as optax holds
    them). AdamW's moments of a leaf it has not stepped yet are zeros
    (optax's init)."""
    opt, step = state["optimizer"], int(state["step"])
    steps = [_adamw_state(opt, p)["step"] for p in tree_leaves(state["params"])
             if _adamw_state(opt, p)]
    counts = set(torch.stack([t.detach().float() for t in steps]).cpu().tolist()
                 if steps else [0.0])
    if len(counts) > 1:
        raise ValueError(f"AdamW's per-leaf step counts differ: {sorted(counts)}")
    count = np.asarray(int(counts.pop()), np.int32)
    items = [(ADAM_COUNT, count)]
    for moment, name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        def get(p, moment=moment):
            m = _adamw_state(opt, p).get(moment)
            return torch.zeros_like(p) if m is None else m

        items += [(_ADAM + [["a", name]] + segs, a)
                  for segs, a in leaf_paths(params_to_jax(_map(get, state["params"])))]
    items.append((SCHEDULE_COUNT, np.asarray(step, np.int32)))
    items += [(PARAMS + segs, a) for segs, a in leaf_paths(params_to_jax(state["params"]))]
    items.append((STEP, np.asarray(step, np.int32)))
    return items


def _as_tensor(arr) -> torch.Tensor:
    return arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))


def _per_layer(stored: dict) -> dict:
    """`stored` with each depth-stacked trunk leaf (JAX's reversible layout:
    a ["k", block] segment right after ["k", "trunk"]) split along its
    depth axis into the port's per-layer paths (["i", layer] after ["k",
    "trunk"]); every other leaf as it is."""
    out = {}
    for key, arr in stored.items():
        segs = json.loads(key)
        at = next((n + 1 for n in range(len(segs) - 1)
                   if segs[n] == _TRUNK and segs[n + 1][0] == "k"), None)
        if at is None:
            out[key] = arr
            continue
        for layer, part in enumerate(arr):
            out[json.dumps(segs[:at] + [["i", layer]] + segs[at:])] = part
    return out


def _copy_leaf(dst: torch.Tensor, stored: dict, segs, what: str) -> None:
    key = json.dumps(segs)
    if key not in stored:
        raise KeyError(f"{what} has no leaf at {key}: the model and the checkpoint "
                       f"layouts differ")
    src = _as_tensor(stored[key])
    if _is_compress(segs):
        src = src.permute(2, 1, 0)  # (k, in/g, out) -> (out, in/g, k)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: the leaf at {key} is {tuple(src.shape)}, the model's "
                         f"{tuple(dst.shape)}; build the model with the checkpoint's config")
    with torch.no_grad():
        dst.copy_(src)


def params_from_stored(params, stored: dict, what: str) -> None:
    """Copy a stored train state's params (`stored`: json-dumped paths to
    host arrays, as a checkpoint holds them; a reversible trunk stacked or
    per layer) into the tensors of `params`, in place. Raises on a leaf
    missing, on a shape that differs and on a stored param the model
    lacks."""
    stored = _per_layer(stored)
    wanted = set()
    for segs, p in leaf_paths(params):
        _copy_leaf(p, stored, PARAMS + segs, what)
        wanted.add(json.dumps(PARAMS + segs))
    head = json.dumps(PARAMS)[:-1]
    extra = sorted(k for k in stored if k.startswith(head) and k not in wanted)
    if extra:
        raise KeyError(f"{what} holds {len(extra)} leaves the model lacks, e.g. {extra[0]}: "
                       f"build the model with the checkpoint's config")


def train_state_from_stored(state, stored: dict, what: str) -> None:
    """Copy a stored JAX `TrainState` (json-dumped path -> host array) into
    the port's live train state, in place: the params, AdamW's moments and
    step counts (made first where AdamW has not made them), and
    state["step"]."""
    stored = _per_layer(stored)
    opt = state["optimizer"]
    opt.init_state()
    params_from_stored(state["params"], stored, what)
    count = float(_as_tensor(stored[json.dumps(ADAM_COUNT)]))
    for segs, p in leaf_paths(state["params"]):
        st = opt.adamw.state[p]
        _copy_leaf(st["exp_avg"], stored, _ADAM + [["a", "mu"]] + segs, what)
        _copy_leaf(st["exp_avg_sq"], stored, _ADAM + [["a", "nu"]] + segs, what)
        st["step"].fill_(count)
    state["step"] = int(_as_tensor(stored[json.dumps(STEP)]))
