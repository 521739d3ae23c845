"""ctypes bindings for the C++ prefetch loader of `csrc/af2_runtime.cc` (a
copy of the root `csrc/af2_runtime.cc`; counterpart of
alphafold2_tpu/runtime/native.py's `NativePrefetchLoader`).

The library builds at first use, never at import: `g++ -O3 -std=c++17
-shared -fPIC -pthread` into `build/runtime/libaf2runtime-<hash>.so` beside
the package, where `<hash>` covers the source and the flags. The compile
writes a temporary name and `os.replace`s it into place, so two processes
never load a half-written library. A failed build or load raises with the
compiler's output: nothing falls back. The source's PDB codec is not
bound: no entry point of the port reads or writes PDB files through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "af2_runtime.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libaf2runtime-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The library, compiled first if it is not built yet. Raises with
    g++'s output when the compile fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native runtime failed: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native runtime failed: {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, target)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.af2_loader_create2.restype = ctypes.c_void_p
        lib.af2_loader_create2.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.af2_loader_next.restype = ctypes.c_int
        lib.af2_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ]
        lib.af2_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# --- the prefetch loader -------------------------------------------------------------


class NativePrefetchLoader:
    """Threaded C++ batch loader over an in-memory structure dataset.

    dataset: (seq_tokens (L,), coords (L, atoms, 3)) pairs of any lengths.
    The workers (`n_threads`, each drawing from its own generator, so with
    more than one the batch order varies from run to run) pick proteins at
    random, crop them at a random offset to `max_len`, pad and assemble
    static-shape batches off the GIL into a bounded queue. With `buckets`
    (ascending lengths whose largest is `max_len`) a protein goes to the
    smallest bucket that holds it (cropped to the largest otherwise) and a
    batch is emitted when its bucket has `batch_size` proteins.

    Iterating yields {"seq": (b, L) int32, "mask": (b, L) bool, "coords":
    (b, L, atoms, 3) float32} with L = max_len, or the batch's bucket and
    "bucket": L with buckets."""

    def __init__(self, dataset, batch_size: int, max_len: int, atoms_per_res: int = 14,
                 pad_token: int = 20, seed: int = 0, n_threads: int = 2,
                 queue_capacity: int = 4, buckets: Optional[tuple] = None):
        if not dataset:
            raise ValueError("NativePrefetchLoader needs a non-empty dataset")
        if buckets:
            buckets = tuple(sorted(set(int(x) for x in buckets)))
            if max_len != buckets[-1]:
                raise ValueError(
                    f"max_len ({max_len}) must equal the largest bucket ({buckets[-1]}) — "
                    f"the top bucket IS the crop length")
        self.buckets = buckets or None
        self.batch = batch_size
        self.max_len = max_len
        self.atoms = atoms_per_res
        self.pad_token = pad_token
        self._handle = None
        self._closed = False

        seqs = [np.asarray(s, np.int32).reshape(-1) for s, _ in dataset]
        coords = [np.asarray(c, np.float32).reshape(len(s), atoms_per_res, 3)
                  for s, (_, c) in zip(seqs, dataset)]
        self._offsets = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=self._offsets[1:])
        self._seqs = np.concatenate(seqs)
        self._coords = np.concatenate(coords).reshape(-1)

        self._lib = _load()
        bk = np.asarray(self.buckets or (), np.int32)
        self._handle = self._lib.af2_loader_create2(
            _ptr(self._seqs, ctypes.c_int32), _ptr(self._offsets, ctypes.c_int64),
            len(seqs), _ptr(self._coords, ctypes.c_float), atoms_per_res, batch_size,
            self.max_len, pad_token, seed, n_threads, queue_capacity,
            _ptr(bk, ctypes.c_int32), len(bk))
        if not self._handle:
            raise ValueError(
                f"af2_loader_create2 refused the loader (batch {batch_size}, max_len "
                f"{max_len}, buckets {self.buckets})")

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next()

    def next(self) -> dict:
        if self._closed:
            raise RuntimeError("loader is closed")
        b, L, A = self.batch, self.max_len, self.atoms
        # max-size buffers; the C++ side writes compact rows at the batch's
        # bucket length and returns it, so the filled prefix reshapes to
        # contiguous (b, bl, ...) arrays
        seq = np.empty(b * L, np.int32)
        mask = np.empty(b * L, np.uint8)
        coords = np.empty(b * L * A * 3, np.float32)
        bl = self._lib.af2_loader_next(self._handle, _ptr(seq, ctypes.c_int32),
                                       _ptr(mask, ctypes.c_uint8),
                                       _ptr(coords, ctypes.c_float))
        out = {"seq": seq[: b * bl].reshape(b, bl),
               "mask": mask[: b * bl].reshape(b, bl).astype(bool),
               "coords": coords[: b * bl * A * 3].reshape(b, bl, A, 3)}
        if self.buckets:
            out["bucket"] = int(bl)
        return out

    def close(self):
        self._closed = True
        if self._handle is not None:
            self._lib.af2_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

