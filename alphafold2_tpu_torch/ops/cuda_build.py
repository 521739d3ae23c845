"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface and compiles with `nvcc`
alone (no PyTorch headers) into `build/kernels/lib<name>-<hash>.so`
beside the package, where `<hash>` covers the source, the shared
`csrc/*.cuh` headers and the flags, so an edited source is rebuilt and an
unchanged one is reused. Building happens
at first use, never at import: a host without `nvcc` imports every module.
`build()` starts one `nvcc` per source, all at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str        # nvcc's output (ptxas register and spill report)


_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build only on a host with the CUDA toolkit"
        )
    return nvcc


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared device helpers
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile the named sources (default: all) that are not built yet,
    one `nvcc` each, started together. Raises with nvcc's output when a
    compile fails."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Built] = {}
    running = {}
    for name in names:
        target = _target(name)
        if target.exists():
            done[name] = Built(name, target, 0.0, "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)
        done[name] = Built(name, target, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    if name not in _LOADED:
        built = build([name])[name]
        _LOADED[name] = ctypes.CDLL(str(built.path))
    return _LOADED[name]


def check_launch(rc: int, what: str) -> None:
    """Raise unless a C entry point returned 0 (cudaSuccess) for its launch:
    a refused launch never runs, and a later synchronize does not report it."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {rc}")
