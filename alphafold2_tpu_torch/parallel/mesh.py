"""A single-controller device mesh and its collectives (counterpart of
alphafold2_tpu/parallel/mesh.py `make_mesh` and of the `jax.lax`
collectives the sequence-parallel code calls inside `shard_map`).

The JAX package runs sequence parallelism as one program over a mesh of
devices: `shard_map` splits the inputs, each device runs the body on its
shard, and `ppermute`, `all_gather`, `all_to_all` and `psum` move data
between them. The port keeps the single controller: one Python process
holds a list of shards, shard s on `mesh.devices[s]`, and every op of the
body maps over that list. The collectives are `.to(device)`, `cat` and
`split`, so autograd flows through them, and they never write into a
shard: on a mesh that repeats a device, a "copy" to that device is the
same tensor.

`make_mesh({"seq": P})` takes the first P distinct CUDA devices and raises
when there are fewer, as the JAX package does. An explicit `devices=` list
may repeat a device (`["cuda:0"] * 4`, `["cpu"] * 4`): the counterpart of
the JAX tests' virtual CPU mesh, which runs every collective and every
ring hop on one device.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
from torch.utils.weak import WeakIdKeyDictionary

# Canonical mesh-axis names (the JAX package's registry, which its
# sharding lint checks every axis literal against):
#   "data" batch data parallelism; "model" tensor parallelism; "seq"
#   sequence/context parallelism; "sp" the SP trunk's row axis (the
#   tests' short name); "pipe" pipeline parallelism.
KNOWN_AXES = frozenset({"data", "model", "seq", "sp", "pipe"})


def _normalize(device) -> torch.device:
    """A device as tensors report it ("cuda" gains its index)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """One named axis of `len(devices)` shards; shard s lives on
    `devices[s]`. `replicate` caches the per-device copies of a weight
    tree, so repeated requests do not copy weights between cards again."""

    def __init__(self, axis_name: str, devices: Sequence[torch.device]):
        self.axis_name = axis_name
        self.devices = tuple(_normalize(d) for d in devices)
        # device -> {source tensor (by identity): (its version, its copy
        # there)}; an entry dies with its source
        self._copies = {d: WeakIdKeyDictionary() for d in set(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.size}

    def __repr__(self) -> str:
        return f"Mesh({self.axis_name!r}, {[str(d) for d in self.devices]})"

    # --- placement (shard_map's in_specs / out_specs) ----------------------

    def shard(self, x, dim: int):
        """Split x into `size` equal pieces along `dim`, piece s onto
        device s (an in_spec sharding that axis). None passes."""
        if x is None:
            return [None] * self.size
        if x.shape[dim] % self.size:
            raise ValueError(
                f"axis {dim} of length {x.shape[dim]} does not divide over the "
                f"'{self.axis_name}' mesh axis ({self.size})"
            )
        return [t.to(d) for t, d in zip(x.chunk(self.size, dim), self.devices)]

    def unshard(self, xs, dim: int):
        """The pieces concatenated along `dim` on the first device (an
        out_spec sharding that axis)."""
        return torch.cat([t.to(self.devices[0]) for t in xs], dim)

    def broadcast(self, x):
        """x on every device (an in_spec that replicates it). None passes."""
        return [None if x is None else x.to(d) for d in self.devices]

    def _copy(self, t, device):
        if t.device == device:
            return t
        if t.requires_grad and torch.is_grad_enabled():
            return t.to(device)  # keep the graph: no cache
        cache = self._copies[device]
        hit = cache.get(t)
        # an in-place update (an optimizer step) moves the source's version:
        # its old copy is stale
        if hit is None or hit[0] != t._version:
            hit = cache[t] = (t._version, t.to(device))
        return hit[1]

    def replicate(self, tree):
        """Per-shard copies of a tree of tensors (dicts, lists, tuples),
        one per distinct device, cached while the source tensors live and
        are not updated in place: a shard on a repeated device gets the
        same tensors."""
        def place(node, device):
            if isinstance(node, dict):
                return {k: place(v, device) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(place(v, device) for v in node)
            if isinstance(node, torch.Tensor):
                return self._copy(node, device)
            return node

        per_device = {d: place(tree, d) for d in set(self.devices)}
        return [per_device[d] for d in self.devices]

    # --- collectives (jax.lax over the mesh axis) ---------------------------

    def axis_index(self):
        """Each shard's index along the axis."""
        return list(range(self.size))

    def ppermute(self, xs, perm):
        """Shard dst receives shard src's tensor for each (src, dst) in
        `perm`; a destination that no pair names receives zeros."""
        out = [None] * self.size
        for src, dst in perm:
            if out[dst] is not None:
                raise ValueError(f"ppermute: destination {dst} named twice in {perm}")
            out[dst] = xs[src].to(self.devices[dst])
        return [torch.zeros_like(xs[s]) if t is None else t for s, t in enumerate(out)]

    def _per_device(self, fn):
        """fn(device) once per distinct device, as a per-shard list."""
        done = {d: fn(d) for d in set(self.devices)}
        return [done[d] for d in self.devices]

    def all_gather(self, xs, dim: int):
        """Every shard's tensor concatenated along `dim` in shard order, on
        every device (tiled all_gather)."""
        return self._per_device(lambda d: torch.cat([t.to(d) for t in xs], dim))

    def all_to_all(self, xs, split_dim: int, concat_dim: int):
        """Shard s receives piece s of every shard's tensor split into
        `size` pieces along `split_dim`, concatenated along `concat_dim` in
        source order (tiled all_to_all)."""
        pieces = [t.chunk(self.size, split_dim) for t in xs]
        if any(len(p) != self.size or p[0].shape != p[-1].shape for p in pieces):
            raise ValueError(
                f"all_to_all: axis {split_dim} of length {xs[0].shape[split_dim]} "
                f"does not divide over {self.size} shards"
            )
        return [torch.cat([p[s].to(d) for p in pieces], concat_dim)
                for s, d in enumerate(self.devices)]

    def psum(self, xs):
        """The sum of every shard's tensor, in shard order, on every
        device."""
        def total(d):
            acc = xs[0].to(d)
            for t in xs[1:]:
                acc = acc + t.to(d)
            return acc

        return self._per_device(total)


def make_mesh(axes: Mapping[str, int], devices: Optional[Sequence] = None) -> Mesh:
    """A mesh with one named axis {name: size}. `devices` defaults to the
    first `size` CUDA devices (distinct cards); fewer raises. An explicit
    list may repeat a device; its first `size` entries are used."""
    if len(axes) != 1:
        raise ValueError(f"the port's mesh has one named axis, got {dict(axes)}")
    ((name, size),) = axes.items()
    if name not in KNOWN_AXES:
        raise ValueError(f"unknown mesh axis {name!r}; known: {sorted(KNOWN_AXES)}")
    if size < 1:
        raise ValueError(f"mesh axis {name!r} needs at least one device, got {size}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < size:
            raise ValueError(
                f"mesh {dict(axes)} needs {size} CUDA devices, this host has {n}; "
                f"pass devices= to place several shards on one device "
                f"(['cuda:0'] * {size} or ['cpu'] * {size})"
            )
        devices = [torch.device("cuda", s) for s in range(size)]
    devices = list(devices)
    if len(devices) < size:
        raise ValueError(f"need {size} devices for mesh {dict(axes)}, have {len(devices)}")
    return Mesh(name, devices[:size])
