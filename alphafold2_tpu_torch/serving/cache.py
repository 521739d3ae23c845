"""Result LRU cache: repeated queries are free (counterpart of
alphafold2_tpu/serving/cache.py, copied).

Keyed by (sequence, MSA content and mask, engine config tag), so a hit is
the identical computation: the engine's tag covers the model config, the
MDS knobs, the seed, the checkpoint fingerprint, the bucket ladder and the
device the engine serves on (serving/engine.py `config_tag`). Identical
requests still in flight share one computation (the engine's coalescing
map), so a herd of them costs one dispatch.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Any, Optional

import numpy as np


def request_key(seq: str, msa: Optional[np.ndarray], config_tag: str,
                msa_mask: Optional[np.ndarray] = None) -> str:
    """Stable content hash of one request against one engine config: the
    MSA and its mask by bytes, so equal alignments hit whatever the object
    (the same alignment under another mask is another computation)."""
    h = hashlib.sha256()
    h.update(config_tag.encode())
    h.update(b"\x00seq\x00")
    h.update(seq.encode())
    if msa is not None:
        arr = np.ascontiguousarray(np.asarray(msa, np.int32))
        h.update(b"\x00msa\x00")
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    if msa_mask is not None:
        arr = np.ascontiguousarray(np.asarray(msa_mask, bool))
        h.update(b"\x00msa_mask\x00")
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class ResultCache:
    """Thread-safe LRU over prediction results; capacity 0 disables it
    (every get misses, puts are dropped)."""

    def __init__(self, capacity: int = 256):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._data: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
            return None

    def put(self, key: str, value):
        if self.capacity == 0:
            return
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def snapshot(self) -> dict:
        with self._lock:
            hits, misses, size = self.hits, self.misses, len(self._data)
        total = hits + misses
        return {"hits": hits, "misses": misses, "size": size, "capacity": self.capacity,
                "hit_rate": (hits / total) if total else 0.0}
