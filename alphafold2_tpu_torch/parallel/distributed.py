"""Joining a pod of processes (counterpart of
alphafold2_tpu/parallel/distributed.py).

The JAX package joins its pod through `jax.distributed.initialize`, after
which `jax.devices()` spans every process's chips. The port joins through
`torch.distributed.init_process_group`: one process a card, each holding
the whole train state, the gradients all-reduced between them
(`parallel/train.py make_multihost_train_step`).

Launch contract (one command per process), as in the JAX package:

    AF2_COORDINATOR=host0:8476 AF2_NUM_PROCESSES=2 AF2_PROCESS_ID=$i \\
        python -m alphafold2_tpu_torch.train_pre ...

`AF2_COORDINATOR` is process 0's `host:port`, where the group's TCP
store listens (`tcp://host:port`). `AF2_AUTO_INIT=1` joins instead from the
variables a launcher such as `torchrun` sets (`RANK`, `WORLD_SIZE`,
`MASTER_ADDR`, `MASTER_PORT`: `init_method="env://"`), the counterpart of
a TPU pod's auto-detection. Without a coordinator, or with one process,
nothing is joined.

The backend is NCCL when the process trains on CUDA and gloo on the CPU;
a library caller may name another (`backend="gloo"` reduces CUDA tensors
through the host, which lets two processes share one card). A process
takes card `local_rank % torch.cuda.device_count()`, local_rank being
`LOCAL_RANK` where a launcher sets it and the process index otherwise;
NCCL ranks that would share a card are refused, since NCCL cannot run two
ranks on one device.

The JAX module refuses to join after its backend has initialized, which
would leave the process on a one-process view while it claims membership.
The port's counterpart: a default process group that already exists with
another world size or rank than the one asked for is refused, since every
collective would then run over that other group; one with the same world
size and rank is taken as joined.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

_TRUE = ("1", "true", "yes", "on")


# --- the launch contract's variables (the JAX package's ops/knobs.py) -------


def env_coordinator() -> Optional[str]:
    """AF2_COORDINATOR: host:port of process 0's store."""
    return os.environ.get("AF2_COORDINATOR", "") or None


def env_num_processes() -> int:
    """AF2_NUM_PROCESSES: the pod's process count (0 or unset: one)."""
    raw = os.environ.get("AF2_NUM_PROCESSES", "")
    return int(raw) if raw else 0


def env_process_id() -> Optional[int]:
    """AF2_PROCESS_ID: this process's index (None when unset)."""
    raw = os.environ.get("AF2_PROCESS_ID", "")
    return int(raw) if raw else None


def env_auto_init() -> bool:
    """AF2_AUTO_INIT: join from a launcher's env:// variables."""
    return os.environ.get("AF2_AUTO_INIT", "").strip().lower() in _TRUE


# --- the joined world --------------------------------------------------------


def joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 outside a pod)."""
    return dist.get_rank() if joined() else 0


def process_count() -> int:
    """The pod's world size (1 outside a pod)."""
    return dist.get_world_size() if joined() else 1


def _local_rank(process: int, local_rank: Optional[int]) -> int:
    if local_rank is not None:
        return local_rank
    raw = os.environ.get("LOCAL_RANK", "")
    return int(raw) if raw else process


def pod_device(process: int, device=None, local_rank: Optional[int] = None) -> torch.device:
    """The device process `process` trains on: the CPU when `device` says
    so, else card local_rank % torch.cuda.device_count() (local_rank:
    LOCAL_RANK, else the process index)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to join on the CPU")
    return torch.device("cuda", _local_rank(process, local_rank) % torch.cuda.device_count())


def initialize_from_env(
    *,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
    local_rank: Optional[int] = None,
) -> bool:
    """Join the pod if one is configured; else a no-op. Returns True when
    this process is in a process group.

    Reads AF2_COORDINATOR / AF2_NUM_PROCESSES / AF2_PROCESS_ID (explicit
    arguments win), or AF2_AUTO_INIT=1 for a launcher's env:// variables.
    `device`: what the process trains on (None: CUDA, "cpu": the CPU),
    which picks the backend (NCCL on CUDA, gloo on the CPU) unless
    `backend` names one; a named backend joins even a world of one, so
    that a one-process run goes through the collectives. On CUDA the
    process's card (`pod_device`) becomes the current device before the
    group forms.
    """
    coordinator = coordinator or env_coordinator()
    if num_processes is None:
        num_processes = env_num_processes()
    if process_id is None:
        process_id = env_process_id()
    if coordinator and (num_processes > 1 or (backend is not None and num_processes == 1)):
        method = f"tcp://{coordinator}"
    elif env_auto_init():
        method = "env://"
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
        process_id = int(os.environ.get("RANK", "0"))
    else:
        return False
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a pod of {num_processes} processes "
                         "(set AF2_PROCESS_ID)")
    if joined():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise RuntimeError(
                f"a default process group of world size {dist.get_world_size()} (rank "
                f"{dist.get_rank()}) already exists, but this process was asked to join as "
                f"process {process_id} of {num_processes}: every collective would run over "
                "the other group. Call initialize_from_env (distributed_startup) once, "
                "before anything forms a group.")
        return True
    dev = pod_device(process_id, device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = _local_rank(process_id, local_rank)
        if backend == "nccl" and local >= torch.cuda.device_count():
            raise ValueError(
                f"process {process_id} (local rank {local}) would share card {dev} with local "
                f"rank {local % torch.cuda.device_count()}: NCCL runs one rank a card, and this "
                f"host has {torch.cuda.device_count()}. Run at most that many processes on it "
                "(ROADMAP A13), or pass backend='gloo' from a library call.")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=method, world_size=num_processes,
                            rank=process_id)
    return True


def distributed_startup(label: str = "", device=None) -> bool:
    """The trainers' startup: join the pod when one is configured (before
    anything else touches a card), and print one line naming this
    process's place in it. Returns True when a pod was joined."""
    joined_now = initialize_from_env(device=device)
    if joined_now:
        tag = f"{label}: " if label else ""
        dev = pod_device(process_index(), device)
        print(f"{tag}joined multi-host runtime: process {process_index()}/{process_count()}, "
              f"1 local / {process_count()} global devices ({dev}, {dist.get_backend()})",
              flush=True)
    return joined_now


# --- CPU-pod rehearsals (the tests' workers) ----------------------------------


def free_local_port() -> int:
    """An OS-assigned free TCP port for a localhost coordinator."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cpu_pod_env(
    *,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    repo_path: Optional[str] = None,
    extra: Optional[Mapping[str, str]] = None,
) -> dict:
    """The environment of one process of a pod rehearsed on one host: the
    launcher variables of another launch removed (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK, AF2_AUTO_INIT), gloo bound to the
    loopback device for a localhost coordinator, one intra-op thread a
    process, and `repo_path` first on PYTHONPATH. With `coordinator` set,
    the AF2_COORDINATOR / AF2_NUM_PROCESSES / AF2_PROCESS_ID contract;
    `extra` wins over everything."""
    env = dict(os.environ)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                "AF2_AUTO_INIT"):
        env.pop(var, None)
    env.setdefault("OMP_NUM_THREADS", "1")
    if coordinator is not None:
        env["AF2_COORDINATOR"] = coordinator
        env["AF2_NUM_PROCESSES"] = str(num_processes)
        env["AF2_PROCESS_ID"] = str(process_id)
        if coordinator.split(":")[0] in ("localhost", "127.0.0.1"):
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if repo_path:
        env["PYTHONPATH"] = os.pathsep.join(
            [repo_path] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(dict(extra) if extra else {})
    return env


def process_local_batch_size(global_batch: int) -> int:
    """This process's share of a batch axis split over the pod."""
    if global_batch % process_count():
        raise ValueError(f"global batch {global_batch} must divide across "
                         f"{process_count()} processes")
    return global_batch // process_count()
