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


def _compile(jobs: Dict[str, tuple]) -> Dict[str, Built]:
    """Run one `nvcc` a job (name -> (source, output)), all started
    together. Raises with nvcc's output when a compile fails."""
    running = {}
    for name, (src, out) in jobs.items():
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, out, time.perf_counter())
    done, failures = {}, []
    for name, (proc, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}:\n{log}")
            continue
        done[name] = Built(name, Path(out), time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile the named sources (default: all) that are not built yet,
    one `nvcc` each, started together. Raises with nvcc's output when a
    compile fails."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Built] = {}
    jobs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            done[name] = Built(name, target, 0.0, "")
        else:
            jobs[name] = (CSRC / f"{name}.cu", target.with_suffix(f".{os.getpid()}.tmp"))
    for name, built in _compile(jobs).items():
        target = _target(name)
        os.replace(built.path, target)
        done[name] = dataclasses.replace(built, path=target)
    return done


def build_variants(variants: Dict[str, str], work: Path) -> Dict[str, Built]:
    """Compile copies of a source (name -> its text) in `work`, beside the
    shared headers, one `nvcc` each, started together: the measurement
    tools' ablations. Raises with nvcc's output when a compile fails."""
    work.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (work / header.name).write_text(header.read_text())
    for name, text in variants.items():
        (work / f"{name}.cu").write_text(text)
    return _compile({name: (work / f"{name}.cu", work / f"lib{name}.so") for name in variants})


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
