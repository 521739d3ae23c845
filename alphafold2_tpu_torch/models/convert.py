"""JAX parameters -> the port's parameters.

`params_from_jax(tree, cfg, device)` maps the JAX package's parameter
pytree (the output of `alphafold2_init`, leaves as numpy arrays) onto the
port's parameter dicts, so both sides compute the same function. The port
keeps the JAX names and layouts, with one exception: the KV-compression
conv weight, (k, in/groups, out) in JAX, is (out, in/groups, k) for
`torch.nn.functional.conv1d` (the reverse of
alphafold2_tpu/models/convert.py's torch -> JAX map). Weights of parts the
port does not run yet (the template tower) are carried over unread. Leaves
become float32, but int8 and bool leaves keep their type, so an int8 tree
from the JAX package's `quantize_tree` maps over as {"qw": int8, "scale":
f32}.
"""

from __future__ import annotations

import numpy as np
import torch

from alphafold2_tpu_torch.device import resolve_device
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


def params_from_jax(tree, cfg: Alphafold2Config, device=None):
    """Map a JAX parameter tree (numpy leaves) onto `device` (default CUDA).
    `cfg` is the port config the tree was made for; its depth is checked
    against the tree's trunk."""
    if "trunk" not in tree or not isinstance(tree["trunk"], (list, tuple)):
        raise ValueError("expected a sequential trunk: a list of layer params")
    if len(tree["trunk"]) != cfg.depth:
        raise ValueError(f"tree has {len(tree['trunk'])} trunk layers, cfg.depth={cfg.depth}")
    return convert_tree(tree, resolve_device(device))
