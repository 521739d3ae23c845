"""Fleet-wide artifact store: content-addressed result/feature cache.

The port's copy of alphafold2_tpu/serving/artifact_store.py: the same names, messages,
metric names and on-disk formats; Python and numpy only.

The first tier that makes the FLEET — not a replica — the unit of
memoization. Every cache below this one is
process-local: the result LRU lives per engine (serving/cache.py),
coalescing happens per replica, and the featurize tier recomputes
features any replica has already seen. At millions of users the
traffic is heavily redundant (popular proteins, proteome sweeps,
retried submissions) and the cheapest request is the one that never
touches a chip, so redundancy absorbed HERE is chip capacity returned
to the fleet — measured directly by the cost plane as a drop in
amortized chip-seconds per request.

Two levels, one content-addressed keyspace:

  * an in-memory HOT RING — an LRU bounded by entries AND bytes,
    shared by every pool of the fleet;
  * a DISK tier (optional: ``ArtifactStoreConfig.root``, deployed as a
    sibling of ``--flight-dir``) that survives restarts and is shared
    by every serving process pointed at it.

Keys are the existing ``request_key`` scheme (serving/cache.py)
extended with a STORE TAG that folds in the dispatch
``resolution_tag`` and the deploy's ``params_tag`` (plus everything
else that moves the numerics: model config, MDS knobs, bucket ladder,
SP plan inputs) — so a rolling update or a kernel-resolution change
re-keys the whole tier and stale entries become unreachable rather
than wrong. On disk each tag gets its own directory
(``<root>/<kind>/<tag-digest>/<content-hash>.art``), which is what
lets the budget sweep garbage-collect a retired deploy's entries
wholesale (`sweep`).

Persistence is write-to-temp + ``os.replace`` (atomic on POSIX: a
reader never sees a half-written file under the final name) and every
payload carries a sha256 over its bytes, verified on read. Any
corruption — torn tail, truncation, poisoned bytes, a file evicted
mid-read by another process's sweep — counts into
``cache_corrupt_total``, deletes the bad entry, and reads as a MISS:
the degradation mode is recompute, never a wrong or partial answer.

Thread safety: one lock guards the hot ring and the counters; all
disk I/O and (de)serialization happen OUTSIDE it, so a slow disk can
never stall a reader that the ring could have served. ``_sweep_lock``
serializes sweeps and is never taken under ``_lock``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import tempfile
import threading
from collections import OrderedDict
from typing import Iterable, Optional, Tuple

import numpy as np

from alphafold2_tpu_torch.serving.engine import PredictionResult
from alphafold2_tpu_torch.serving.featurize import FeatureBundle
from alphafold2_tpu_torch.telemetry import MetricRegistry

#: on-disk entry framing: magic + 64 hex sha256 of the payload + "\n" + payload
_MAGIC = b"AF2ART1\n"
_HEADER_LEN = len(_MAGIC) + 64 + 1

#: artifact kinds (the first path segment on disk)
KIND_RESULT = "result"
KIND_FEATURES = "features"


class ArtifactCorruptError(Exception):
    """A disk entry failed framing/checksum/decode validation."""


def _read_bytes(path: str) -> bytes:
    """The read seam: module-level so the chaos suite can interpose a
    mid-read eviction (file deleted between the exists() check and the
    read) without monkeypatching builtins."""
    with open(path, "rb") as fh:
        return fh.read()


def tag_digest(tag: str) -> str:
    """Stable short digest of a store tag — the on-disk directory name
    (tags are long reprs; the digest keeps paths sane)."""
    return hashlib.sha256(tag.encode()).hexdigest()[:16]


# ------------------------------------------------------------- serialization

def _pack(arrays: dict, meta: dict) -> bytes:
    """Frame arrays + JSON meta as one checksummed blob. The meta rides
    inside the npz as a uint8 array (no pickle anywhere: `np.load` runs
    with allow_pickle=False, so a poisoned entry can corrupt a READ,
    never execute code)."""
    payload = {k: np.ascontiguousarray(v)
               for k, v in arrays.items() if v is not None}
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    blob = buf.getvalue()
    digest = hashlib.sha256(blob).hexdigest().encode()
    return _MAGIC + digest + b"\n" + blob


def _unpack(data: bytes) -> Tuple[dict, dict]:
    """Inverse of `_pack`; raises ArtifactCorruptError on ANY framing,
    checksum, or decode problem (one failure class: recompute)."""
    if len(data) < _HEADER_LEN or not data.startswith(_MAGIC):
        raise ArtifactCorruptError("bad magic / truncated header")
    digest = data[len(_MAGIC):len(_MAGIC) + 64]
    if data[_HEADER_LEN - 1:_HEADER_LEN] != b"\n":
        raise ArtifactCorruptError("bad header framing")
    blob = data[_HEADER_LEN:]
    if hashlib.sha256(blob).hexdigest().encode() != digest:
        raise ArtifactCorruptError("payload checksum mismatch")
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    except ArtifactCorruptError:
        raise
    except Exception as e:  # noqa: BLE001 — any decode failure is the
        # same operational fact: the entry cannot be trusted
        raise ArtifactCorruptError(f"payload decode failed: {e}") from None
    if not isinstance(meta, dict):
        raise ArtifactCorruptError("meta is not an object")
    return arrays, meta


def _encode_result(result: PredictionResult) -> Tuple[dict, dict]:
    return (
        {"coords": np.asarray(result.coords),
         "confidence": np.asarray(result.confidence)},
        {"kind": KIND_RESULT, "seq": result.seq,
         "stress": float(result.stress), "bucket": int(result.bucket)},
    )


def _decode_result(arrays: dict, meta: dict) -> PredictionResult:
    try:
        return PredictionResult(
            seq=str(meta["seq"]),
            coords=arrays["coords"],
            confidence=arrays["confidence"],
            stress=float(meta["stress"]),
            bucket=int(meta["bucket"]),
            from_cache=True,
            latency_s=0.0,
        )
    except KeyError as e:
        raise ArtifactCorruptError(f"result entry missing field {e}") from None


def _encode_features(bundle: FeatureBundle) -> Tuple[dict, dict]:
    return (
        {"tokens": np.asarray(bundle.tokens),
         "msa": bundle.msa, "msa_mask": bundle.msa_mask},
        {"kind": KIND_FEATURES, "seq": bundle.seq,
         "bucket": int(bundle.bucket),
         "has_msa": bundle.msa is not None,
         "has_msa_mask": bundle.msa_mask is not None},
    )


def _decode_features(arrays: dict, meta: dict) -> FeatureBundle:
    try:
        if bool(meta["has_msa"]) != ("msa" in arrays) or (
                bool(meta["has_msa_mask"]) != ("msa_mask" in arrays)):
            raise ArtifactCorruptError("feature entry meta/array mismatch")
        return FeatureBundle(
            seq=str(meta["seq"]),
            tokens=arrays["tokens"],
            msa=arrays.get("msa"),
            msa_mask=arrays.get("msa_mask"),
            bucket=int(meta["bucket"]),
        )
    except KeyError as e:
        raise ArtifactCorruptError(
            f"feature entry missing field {e}") from None


_CODECS = {
    KIND_RESULT: (_encode_result, _decode_result),
    KIND_FEATURES: (_encode_features, _decode_features),
}


def _entry_nbytes(arrays: dict, meta: dict) -> int:
    """Hot-ring accounting estimate: array payload + a small meta floor."""
    n = 256
    for v in arrays.values():
        if v is not None:
            n += np.asarray(v).nbytes
    return n


# --------------------------------------------------------------------- store

@dataclasses.dataclass(frozen=True)
class ArtifactStoreConfig:
    """Sizing/eviction knobs (docs/OPERATIONS.md "Artifact store")."""

    root: Optional[str] = None      # disk tier directory (None = memory-only)
    memory_entries: int = 256       # hot-ring entry cap (0 disables the ring)
    memory_bytes: int = 256 << 20   # hot-ring byte budget
    disk_bytes: int = 2 << 30       # disk budget the sweep enforces
    sweep_every_writes: int = 64    # opportunistic sweep cadence (disk puts)

    def __post_init__(self):
        if self.memory_entries < 0 or self.memory_bytes < 0:
            raise ValueError("memory budgets must be >= 0")
        if self.disk_bytes < 0:
            raise ValueError(f"disk_bytes must be >= 0, got {self.disk_bytes}")
        if self.sweep_every_writes < 1:
            raise ValueError("sweep_every_writes must be >= 1")


class ArtifactStore:
    """Content-addressed two-level cache over results and feature bundles.

    API surface the fleet uses:

      * ``lookup_result(tag, key)`` / ``put_result(tag, key, result)``
      * ``lookup_features(tag, key)`` / ``put_features(tag, key, bundle)``
      * ``set_current_tags(tags)`` — the tag lifecycle hook: the fleet
        declares which store tags are live after (re)configuration and
        every rolling update; ``sweep()`` garbage-collects everything
        else from both levels
      * ``sweep()`` — tag GC + disk byte-budget enforcement (oldest
        mtime first) + gauge refresh
      * ``snapshot()`` / ``publish_gauges()`` — the /statusz and
        /metrics views

    Lookups return ``(obj, level)`` with level ``"memory"`` or
    ``"disk"`` so callers can stamp cache provenance per flight, or
    ``None`` on a miss. A corrupt disk entry is counted, deleted, and
    reported as a miss — recompute, never a wrong answer.
    """

    def __init__(self, cfg: ArtifactStoreConfig = ArtifactStoreConfig(),
                 registry: Optional[MetricRegistry] = None):
        self.cfg = cfg
        self.registry = registry if registry is not None else MetricRegistry()
        self._lock = threading.Lock()
        self._sweep_lock = threading.Lock()
        # hot ring: (kind, tag, key) -> (obj, nbytes); tag kept verbatim
        # so sweep() can purge stale-tag entries without digest inversion
        self._ring: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._ring_bytes = 0
        self._current_tags = frozenset()        # tag strings
        self._current_digests = frozenset()     # their path digests
        self._disk_bytes_est = 0
        self._writes_since_sweep = 0
        # plain-int mirrors of the counters: snapshot() must not scrape
        # the registry to describe its own store
        self._stats = {
            "hits_memory": 0, "hits_disk": 0, "misses": 0, "corrupt": 0,
            "evictions_memory": 0, "evictions_disk": 0, "disk_writes": 0,
        }
        self._register_metrics()
        if cfg.root:
            os.makedirs(cfg.root, exist_ok=True)
            self._disk_bytes_est = self._scan_disk_usage()
            self._disk_bytes_g.set(self._disk_bytes_est)

    def _register_metrics(self):
        reg = self.registry
        self._hit_counters = {
            (kind, level): reg.counter(
                "artifact_store_hits_total",
                help="fleet artifact-store hits by kind and level",
                kind=kind, level=level)
            for kind in (KIND_RESULT, KIND_FEATURES)
            for level in ("memory", "disk")
        }
        self._miss_counters = {
            kind: reg.counter(
                "artifact_store_misses_total",
                help="fleet artifact-store misses by kind", kind=kind)
            for kind in (KIND_RESULT, KIND_FEATURES)
        }
        self._corrupt_counters = {
            kind: reg.counter(
                "cache_corrupt_total",
                help="disk entries that failed checksum/framing/decode "
                     "(or vanished mid-read) and fell through to "
                     "recompute", kind=kind)
            for kind in (KIND_RESULT, KIND_FEATURES)
        }
        self._evict_counters = {
            level: reg.counter(
                "artifact_store_evictions_total",
                help="entries evicted (memory ring LRU; disk sweep "
                     "tag-GC + byte budget)", level=level)
            for level in ("memory", "disk")
        }
        self._write_counter = reg.counter(
            "artifact_store_disk_writes_total",
            help="atomic write-then-rename persists to the disk tier")
        self._mem_bytes_g = reg.gauge(
            "artifact_store_memory_bytes",
            help="hot-ring resident bytes (estimate)")
        self._mem_entries_g = reg.gauge(
            "artifact_store_memory_entries", help="hot-ring entries")
        self._disk_bytes_g = reg.gauge(
            "artifact_store_disk_bytes",
            help="disk-tier bytes (exact after a sweep, estimated "
                 "between sweeps)")

    def bind_registry(self, registry: MetricRegistry):
        """Re-home the store's metric families into `registry`.

        The fleet calls this when attaching a store that was built
        standalone (serve.py constructs the store before the fleet — and
        its registry — exist), so ONE /metrics scrape carries the fleet
        and store families together. Counts carry over exactly: every
        re-registered counter is seeded from its predecessor's value, so
        a pre-warmed store loses no history at attach time."""
        if registry is self.registry:
            return
        old_maps = (self._hit_counters, self._miss_counters,
                    self._corrupt_counters, self._evict_counters)
        old_write = self._write_counter
        self.registry = registry
        self._register_metrics()
        for old, new in zip(old_maps,
                            (self._hit_counters, self._miss_counters,
                             self._corrupt_counters, self._evict_counters)):
            for labels, handle in old.items():
                if handle.value:
                    new[labels].inc(handle.value)
        if old_write.value:
            self._write_counter.inc(old_write.value)
        self.publish_gauges()

    # ------------------------------------------------------------ tag state

    def set_current_tags(self, tags: Iterable[str]):
        """Declare the live store tags (one per capability pool + the
        feature tag). Entries under any OTHER tag are unreachable by
        construction (the key embeds the tag) and become sweep fodder."""
        tags = frozenset(str(t) for t in tags)
        with self._lock:
            self._current_tags = tags
            self._current_digests = frozenset(tag_digest(t) for t in tags)

    # -------------------------------------------------------------- lookups

    def lookup_result(self, tag: str, key: str):
        return self._lookup(KIND_RESULT, tag, key)

    def lookup_features(self, tag: str, key: str):
        return self._lookup(KIND_FEATURES, tag, key)

    def put_result(self, tag: str, key: str, result: PredictionResult):
        # normalize BEFORE the hot ring sees it: a memory hit must read
        # exactly like a disk decode (from_cache=True, zero latency) —
        # callers re-stamp their own per-request provenance on delivery
        if not result.from_cache or result.latency_s:
            result = dataclasses.replace(result, from_cache=True,
                                         latency_s=0.0)
        self._put(KIND_RESULT, tag, key, result)

    def put_features(self, tag: str, key: str, bundle: FeatureBundle):
        self._put(KIND_FEATURES, tag, key, bundle)

    def _path(self, kind: str, tag: str, key: str) -> str:
        return os.path.join(self.cfg.root, kind, tag_digest(tag),
                            key + ".art")

    def _lookup(self, kind: str, tag: str, key: str):
        ring_key = (kind, tag, key)
        with self._lock:
            hit = self._ring.get(ring_key)
            if hit is not None:
                self._ring.move_to_end(ring_key)
                self._stats["hits_memory"] += 1
                self._hit_counters[(kind, "memory")].inc()
                return hit[0], "memory"
        obj = self._read_disk(kind, tag, key)
        if obj is None:
            with self._lock:
                self._stats["misses"] += 1
            self._miss_counters[kind].inc()
            return None
        self._ring_put(kind, tag, key, obj)
        with self._lock:
            self._stats["hits_disk"] += 1
        self._hit_counters[(kind, "disk")].inc()
        return obj, "disk"

    def _read_disk(self, kind: str, tag: str, key: str):
        if not self.cfg.root:
            return None
        path = self._path(kind, tag, key)
        if not os.path.exists(path):
            return None
        try:
            data = _read_bytes(path)
        except FileNotFoundError:
            # mid-read eviction: the entry existed an instant ago and a
            # concurrent sweep (this process or a sibling serving the
            # same disk tier) removed it — same degradation contract as
            # corruption: count it, recompute
            self._count_corrupt(kind)
            return None
        except OSError:
            self._count_corrupt(kind)
            return None
        try:
            arrays, meta = _unpack(data)
            if meta.get("kind") != kind:
                raise ArtifactCorruptError(
                    f"entry kind {meta.get('kind')!r} under {kind!r} path")
            obj = _CODECS[kind][1](arrays, meta)
        except ArtifactCorruptError:
            self._count_corrupt(kind)
            # a poisoned entry must not poison the next reader too
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        try:
            os.utime(path)  # refresh mtime: the sweep evicts oldest-first
        except OSError:
            pass
        return obj

    def _count_corrupt(self, kind: str):
        with self._lock:
            self._stats["corrupt"] += 1
        self._corrupt_counters[kind].inc()

    # ---------------------------------------------------------------- puts

    def _ring_put(self, kind: str, tag: str, key: str, obj):
        if self.cfg.memory_entries == 0:
            return
        nbytes = 0
        try:
            arrays, meta = _CODECS[kind][0](obj)
            nbytes = _entry_nbytes(arrays, meta)
        except Exception:  # noqa: BLE001 — sizing must never block caching
            nbytes = 4096
        evicted = 0
        with self._lock:
            ring_key = (kind, tag, key)
            old = self._ring.pop(ring_key, None)
            if old is not None:
                self._ring_bytes -= old[1]
            self._ring[ring_key] = (obj, nbytes)
            self._ring_bytes += nbytes
            while self._ring and (
                    len(self._ring) > self.cfg.memory_entries
                    or self._ring_bytes > self.cfg.memory_bytes):
                _, (_, n) = self._ring.popitem(last=False)
                self._ring_bytes -= n
                evicted += 1
            if evicted:
                self._stats["evictions_memory"] += evicted
            mem_bytes, mem_entries = self._ring_bytes, len(self._ring)
        if evicted:
            self._evict_counters["memory"].inc(evicted)
        self._mem_bytes_g.set(mem_bytes)
        self._mem_entries_g.set(mem_entries)

    def _put(self, kind: str, tag: str, key: str, obj):
        self._ring_put(kind, tag, key, obj)
        if not self.cfg.root:
            return
        try:
            arrays, meta = _CODECS[kind][0](obj)
            blob = _pack(arrays, meta)
        except Exception:  # noqa: BLE001 — an unserializable artifact
            # degrades to memory-only caching, never a failed request
            return
        path = self._path(kind, tag, key)
        d = os.path.dirname(path)
        try:
            os.makedirs(d, exist_ok=True)
            # atomic write-then-rename (the FlightRecorder idiom, but
            # with a unique temp name: two replicas persisting the same
            # key concurrently must not interleave into one .tmp)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as fh:
                    fh.write(blob)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            return  # a full/readonly disk degrades to memory-only caching
        self._write_counter.inc()
        with self._lock:
            self._stats["disk_writes"] += 1
            self._disk_bytes_est += len(blob)
            self._writes_since_sweep += 1
            over = (self._disk_bytes_est > self.cfg.disk_bytes
                    or self._writes_since_sweep
                    >= self.cfg.sweep_every_writes)
        self._disk_bytes_g.set(self._disk_bytes_est)
        if over:
            self.sweep()

    # --------------------------------------------------------------- sweep

    def _scan_disk_usage(self) -> int:
        total = 0
        for dirpath, _dirnames, filenames in os.walk(self.cfg.root):
            for fn in filenames:
                try:
                    total += os.path.getsize(os.path.join(dirpath, fn))
                except OSError:
                    pass
        return total

    def sweep(self) -> dict:
        """The budget sweep: (1) GC every disk entry whose tag directory
        is not a CURRENT tag (a retired deploy's whole keyspace goes at
        once), (2) enforce the byte budget oldest-mtime-first over what
        remains, (3) purge stale-tag hot-ring entries, (4) refresh the
        gauges to exact numbers. Cheap enough to run inline on the put
        path (`sweep_every_writes`) and explicitly after a rolling
        update; concurrent calls serialize on `_sweep_lock`."""
        with self._lock:
            digests = self._current_digests
            tags = self._current_tags
        out = {"gc_files": 0, "gc_bytes": 0,
               "budget_files": 0, "budget_bytes": 0,
               "ring_purged": 0, "disk_bytes": 0}
        with self._sweep_lock:
            if self.cfg.root:
                files = []  # (mtime, size, path)
                for kind in (KIND_RESULT, KIND_FEATURES):
                    kdir = os.path.join(self.cfg.root, kind)
                    try:
                        tagdirs = os.listdir(kdir)
                    except OSError:
                        continue
                    for td in tagdirs:
                        tdir = os.path.join(kdir, td)
                        stale = digests and td not in digests
                        try:
                            names = os.listdir(tdir)
                        except OSError:
                            continue
                        for fn in names:
                            p = os.path.join(tdir, fn)
                            try:
                                st = os.stat(p)
                            except OSError:
                                continue
                            if stale or fn.endswith(".tmp"):
                                try:
                                    os.unlink(p)
                                    out["gc_files"] += 1
                                    out["gc_bytes"] += st.st_size
                                except OSError:
                                    pass
                            else:
                                files.append((st.st_mtime, st.st_size, p))
                        if stale:
                            try:
                                os.rmdir(tdir)
                            except OSError:
                                pass
                total = sum(size for _, size, _ in files)
                if total > self.cfg.disk_bytes:
                    for _, size, p in sorted(files):
                        try:
                            os.unlink(p)
                        except OSError:
                            continue
                        total -= size
                        out["budget_files"] += 1
                        out["budget_bytes"] += size
                        if total <= self.cfg.disk_bytes:
                            break
                out["disk_bytes"] = total
            evicted_disk = out["gc_files"] + out["budget_files"]
            with self._lock:
                if tags:
                    stale_keys = [k for k in self._ring if k[1] not in tags]
                    for k in stale_keys:
                        _, n = self._ring.pop(k)
                        self._ring_bytes -= n
                    out["ring_purged"] = len(stale_keys)
                self._disk_bytes_est = out["disk_bytes"]
                self._writes_since_sweep = 0
                if evicted_disk:
                    self._stats["evictions_disk"] += evicted_disk
                if out["ring_purged"]:
                    self._stats["evictions_memory"] += out["ring_purged"]
                mem_bytes, mem_entries = self._ring_bytes, len(self._ring)
            if evicted_disk:
                self._evict_counters["disk"].inc(evicted_disk)
            if out["ring_purged"]:
                self._evict_counters["memory"].inc(out["ring_purged"])
            self._disk_bytes_g.set(out["disk_bytes"])
            self._mem_bytes_g.set(mem_bytes)
            self._mem_entries_g.set(mem_entries)
        return out

    # ------------------------------------------------------------- reading

    def publish_gauges(self):
        with self._lock:
            mem_bytes, mem_entries = self._ring_bytes, len(self._ring)
            disk_bytes = self._disk_bytes_est
        self._mem_bytes_g.set(mem_bytes)
        self._mem_entries_g.set(mem_entries)
        if self.cfg.root:
            self._disk_bytes_g.set(disk_bytes)

    def snapshot(self) -> dict:
        """JSON-ready store view for /statusz and stats flushes."""
        with self._lock:
            stats = dict(self._stats)
            mem_bytes, mem_entries = self._ring_bytes, len(self._ring)
            disk_bytes = self._disk_bytes_est
            n_tags = len(self._current_tags)
        hits = stats["hits_memory"] + stats["hits_disk"]
        total = hits + stats["misses"]
        return {
            "memory": {
                "entries": mem_entries,
                "bytes": mem_bytes,
                "entry_capacity": self.cfg.memory_entries,
                "byte_budget": self.cfg.memory_bytes,
            },
            "disk": {
                "root": self.cfg.root,
                "bytes": disk_bytes,
                "byte_budget": self.cfg.disk_bytes,
                "writes": stats["disk_writes"],
            },
            "current_tags": n_tags,
            "hits_memory": stats["hits_memory"],
            "hits_disk": stats["hits_disk"],
            "misses": stats["misses"],
            "corrupt": stats["corrupt"],
            "evictions_memory": stats["evictions_memory"],
            "evictions_disk": stats["evictions_disk"],
            "hit_rate": (hits / total) if total else 0.0,
        }
