"""Crash-consistent checkpoints (counterpart of the verified manager of
alphafold2_tpu/training/checkpoint.py, in its file format).

A step is `step_{:08d}.npz` (leaves `leaf_{i:05d}`) beside
`step_{:08d}.npz.manifest.json` (`step`, `sha256` of the npz, `leaves`,
`paths`, `leaf_meta`), both written to a tmp file, fsynced and moved into
place with `os.replace`, the manifest after the data. A step whose
manifest is missing or whose hash does not match is invisible: `restore`
falls back to the newest step that verifies, and `_prune` never deletes
the newest verified step. The JAX package's manager reads what this one
writes and the other way round: the port's train state is written as the
JAX `TrainState` tree (`models/convert.py train_state_to_jax`), and a
bfloat16 leaf as flat uint8 with its dtype and shape in the manifest,
decoded here through torch (a uint8 tensor viewed as `torch.bfloat16`),
without ml_dtypes.

A restore into a live train state copies into its tensors (`copy_`) and
never rebinds one, so a captured train step keeps its addresses; AdamW's
per-leaf state is made first where the optimizer has not made it yet.

Not ported: the orbax `CheckpointManager` (orbax imports jax): the port
always writes the verified format (so train_pre's `--ckpt-verify`
changes nothing), and an orbax directory raises naming ROADMAP
A12-orbax. The
multi-process branches (process 0 writes, barriers, the cross-process
sha256 check) raise naming A13.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from alphafold2_tpu_torch.models.convert import (
    host_leaf,
    leaf_paths,
    params_from_stored,
    train_state_from_stored,
    train_state_to_jax,
)

_STATE_FMT = "step_{:08d}.npz"
_MANIFEST_SUFFIX = ".manifest.json"


def _refuse_multi_process(what: str) -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} with {dist.get_world_size()} processes: multi-process checkpointing "
            f"(process 0 writes, barriers, the cross-process sha256 check) is not ported "
            f"yet (ROADMAP A13-ckpt)")


def _refuse_orbax(directory: str) -> None:
    """An orbax directory holds one subdirectory a step (named by its
    number) with `_CHECKPOINT_METADATA` inside."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if os.path.isdir(path) and (name.isdigit() or "orbax-checkpoint-tmp" in name):
            raise NotImplementedError(
                f"{directory} holds an orbax checkpoint ({name}/): the port reads the "
                f"verified npz format only; orbax imports jax and is not ported (ROADMAP "
                f"A12-orbax). Write the checkpoint with --ckpt-verify")


def _host_items(state):
    """(path, host leaf) pairs of what is saved: a port train state as the
    JAX `TrainState` tree, any other tree of tensors or arrays leaf by leaf
    in flatten order."""
    if isinstance(state, dict) and "optimizer" in state:
        return train_state_to_jax(state)
    return [(segs, host_leaf(x, segs) if isinstance(x, torch.Tensor) else np.asarray(x))
            for segs, x in leaf_paths(state)]


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _pack_leaf(leaf):
    """(storable array, meta) for one host leaf: a numpy array as it is, a
    tensor of a dtype numpy lacks (bfloat16, float8) as flat uint8 with the
    true dtype and shape in the manifest, as the JAX package stores an
    ml_dtypes leaf."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).removeprefix("torch.")
        raw = leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
        return raw, {"dtype": name, "shape": list(leaf.shape), "packed": True}
    arr = np.asarray(leaf)
    return arr, {"dtype": str(arr.dtype), "shape": list(arr.shape), "packed": False}


def _unpack_leaf(arr: np.ndarray, meta):
    """A stored leaf back: a numpy array, or for a packed leaf a CPU tensor
    of its dtype (`torch.bfloat16` for the JAX package's bf16 leaves)."""
    if not meta or not meta.get("packed"):
        return arr
    dtype = getattr(torch, meta["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"stored leaf dtype {meta['dtype']!r} has no torch dtype")
    raw = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).copy())
    return raw.view(dtype).reshape(meta["shape"])


def _rebuild_from_paths(items):
    """Nested dict/list tree from (path segments, leaf) pairs (the JAX
    package's no-template restore: sequences come back as lists over the
    indices present, so optax's leaf-free EmptyState drops out)."""
    root: dict = {}
    for segs, arr in items:
        node = root
        for kind, key in segs[:-1]:
            node = node.setdefault((kind, key), {})
        kind, key = segs[-1]
        node[(kind, key)] = arr

    def materialize(node):
        if not isinstance(node, dict):
            return node
        if node and all(k[0] == "i" for k in node):
            return [materialize(node[k]) for k in sorted(node)]
        return {key: materialize(v) for (kind, key), v in node.items()}

    return materialize(root)


class VerifiedCheckpointManager:
    """Crash-consistent, content-verified checkpoints. Synchronous: a write
    is durable before the train loop passes the next preemption poll.
    `fault_hook(step, state_path, manifest_path)` runs after each completed
    write (reliability/faults.py `FaultInjector.checkpoint_hook` damages
    the files there as a crash mid-write would)."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval_steps: int = 1,
                 fault_hook: Optional[Callable[[int, str, str], None]] = None):
        self.directory = os.path.abspath(directory)
        _refuse_orbax(self.directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, save_interval_steps)
        self._fault_hook = fault_hook
        self._closed = False
        # steps whose sha256 already checked out (the files are immutable
        # once their manifest matches)
        self._verified = set()

    # -- paths / verification ------------------------------------------------

    def _state_path(self, step: int) -> str:
        return os.path.join(self.directory, _STATE_FMT.format(step))

    def _manifest_path(self, step: int) -> str:
        return self._state_path(step) + _MANIFEST_SUFFIX

    def all_steps(self):
        """Every step with a state file on disk, verified or not, ascending."""
        steps = []
        for p in glob.glob(os.path.join(self.directory, "step_*.npz")):
            name = os.path.basename(p)
            try:
                steps.append(int(name[len("step_"):-len(".npz")]))
            except ValueError:
                continue
        return sorted(steps)

    def verify(self, step: int) -> bool:
        """True when the step's manifest exists and its sha256 matches the
        data file (hashed once a step a manager; existence re-checked)."""
        state_path, manifest_path = self._state_path(step), self._manifest_path(step)
        if not (os.path.exists(state_path) and os.path.exists(manifest_path)):
            self._verified.discard(step)
            return False
        if step in self._verified:
            return True
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        ok = manifest.get("step") == step and manifest.get("sha256") == _sha256_file(state_path)
        if ok:
            self._verified.add(step)
        return ok

    def verified_steps(self):
        return [s for s in self.all_steps() if self.verify(s)]

    def latest_step(self) -> Optional[int]:
        """Newest VERIFIED step (corrupt or torn steps are invisible here)."""
        steps = self.verified_steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------

    def save(self, state: Any, step: Optional[int] = None, force: bool = False) -> bool:
        """Write `state` (a port train state, or any tree of tensors and
        arrays) at `step` (default state["step"]) when `force` or the step
        is on the save interval. Returns whether it wrote."""
        if self._closed:
            raise RuntimeError("save() on a closed VerifiedCheckpointManager")
        _refuse_multi_process("VerifiedCheckpointManager.save")
        if step is None:
            step = int(state["step"])
        if not force and step % self.save_interval_steps != 0:
            return False
        items = _host_items(state)
        arrays, leaf_meta = {}, []
        for i, (_, leaf) in enumerate(items):
            packed, meta = _pack_leaf(leaf)
            arrays[f"leaf_{i:05d}"] = packed
            leaf_meta.append(meta)

        state_path = self._state_path(step)
        tmp = state_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, state_path)

        manifest = {"step": step, "sha256": _sha256_file(state_path), "leaves": len(items),
                    "paths": [segs for segs, _ in items], "leaf_meta": leaf_meta}
        manifest_path = self._manifest_path(step)
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, manifest_path)

        if self._fault_hook is not None:
            self._fault_hook(step, state_path, manifest_path)
        self._prune()
        return True

    def _prune(self):
        """Drop the oldest steps beyond max_to_keep, never the newest
        verified one (with the newest file torn it is the only restore
        target)."""
        if self.max_to_keep is None or self.max_to_keep < 1:
            return
        steps = self.all_steps()
        excess = len(steps) - self.max_to_keep
        if excess <= 0:
            return
        newest_verified = self.latest_step()
        for step in steps:
            if excess <= 0:
                break
            if step == newest_verified:
                continue
            for p in (self._state_path(step), self._manifest_path(step)):
                if os.path.exists(p):
                    os.unlink(p)
            self._verified.discard(step)
            excess -= 1

    # -- restore ------------------------------------------------------------

    def _load(self, step: int):
        """(manifest paths, host leaves) of a step, in stored order."""
        with open(self._manifest_path(step)) as f:
            manifest = json.load(f)
        meta = manifest.get("leaf_meta") or [None] * manifest["leaves"]
        with np.load(self._state_path(step)) as data:
            leaves = [_unpack_leaf(data[f"leaf_{i:05d}"], meta[i])
                      for i in range(manifest["leaves"])]
        return manifest["paths"], leaves

    def _choose(self, step: Optional[int]) -> int:
        """`step` (it must verify) or the newest step that verifies, with a
        warning a step skipped."""
        if step is not None:
            if not self.verify(step):
                raise FileNotFoundError(f"checkpoint step {step} in {self.directory} is "
                                        f"missing or failed sha256 verification")
            return step
        candidates = self.all_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        for s in reversed(candidates):
            if self.verify(s):
                return s
            print(f"warning: checkpoint step {s} in {self.directory} failed "
                  "verification (torn write or corruption) — falling back")
        raise FileNotFoundError(f"no checkpoint under {self.directory} passes verification "
                                f"(steps on disk: {candidates})")

    def restore(self, into: Any = None, step: Optional[int] = None) -> Any:
        """Restore `step` or, by default, the newest step that verifies.
        `into`: a live port train state, restored in place and returned;
        None returns the stored tree (numpy arrays; CPU tensors for dtypes
        numpy lacks) as the JAX package's no-template restore does."""
        _refuse_multi_process("VerifiedCheckpointManager.restore")
        step = self._choose(step)
        paths, leaves = self._load(step)
        if into is None:
            return _rebuild_from_paths(zip(paths, leaves))
        stored = {json.dumps(segs): leaf for segs, leaf in zip(paths, leaves)}
        train_state_from_stored(into, stored, f"checkpoint step {step} of {self.directory}")
        return into

    def restore_params(self, params, step: Optional[int] = None) -> int:
        """Copy a train state's params (step `step`, default the newest that
        verifies) into the tensors of `params`, in place. Returns the step."""
        _refuse_multi_process("VerifiedCheckpointManager.restore_params")
        step = self._choose(step)
        paths, leaves = self._load(step)
        stored = {json.dumps(segs): leaf for segs, leaf in zip(paths, leaves)}
        params_from_stored(params, stored, f"checkpoint step {step} of {self.directory}")
        return step

    # -- lifecycle ----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def wait(self):
        """Writes are synchronous; nothing to drain."""

    def close(self):
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def open_or_init(ckpt_dir: Optional[str], init_fn, *init_args, save_every: int = 1,
                 fault_hook=None):
    """Entry-script idiom: (mgr, state, resumed). `init_fn(*init_args)`
    builds the live train state; when `ckpt_dir` holds a verified step the
    newest one is restored into that state in place (as the JAX package
    does, a directory with no verified step cold-starts). mgr is None
    without a ckpt_dir; call `mgr.save(state)` every step and its interval
    decides."""
    state = init_fn(*init_args)
    if ckpt_dir is None:
        return None, state, False
    mgr = VerifiedCheckpointManager(ckpt_dir, save_interval_steps=max(1, save_every),
                                    fault_hook=fault_hook)
    if mgr.latest_step() is None:
        return mgr, state, False
    mgr.restore(into=state)
    return mgr, state, True


def restore_params_for_inference(ckpt_dir: Optional[str], params_fn):
    """Inference-entry idiom of predict and serve: `params_fn()` builds the
    params (the cold start, and the tensors a restore copies into), then
    the newest verified step's params are restored into them when
    `ckpt_dir` holds one. Returns (params, step, resumed); step is 0 on a
    cold start. Callers use f"{ckpt_dir}@step{step}" as the result cache's
    fingerprint."""
    params = params_fn()
    if ckpt_dir is None:
        print("no --ckpt-dir: using randomly initialized params")
        return params, 0, False
    mgr = VerifiedCheckpointManager(ckpt_dir)
    if not mgr.all_steps():
        print(f"warning: no checkpoint in {ckpt_dir}; random params")
        return params, 0, False
    step = mgr.restore_params(params)
    print(f"restored step-{step} params from {ckpt_dir}")
    return params, step, True


def finish(mgr: Optional[VerifiedCheckpointManager], state: Any):
    """End of training: save the last step if the cadence missed it, then
    close. A no-op on an already-closed manager (a preempted run saved and
    closed it)."""
    if mgr is None or mgr.closed:
        return
    step = int(state["step"])
    if mgr.latest_step() != step:
        mgr.save(state, force=True)
    mgr.close()
