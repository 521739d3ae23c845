"""Durable intake journal: the crash-safe write-ahead log of accepted work.

The port's copy of alphafold2_tpu/serving/journal.py: the same names, messages,
metric names and on-disk formats; Python and numpy only.

Every reliability feature below this layer — breaker, health-monitor
drain/reinstate, featurize requeue, the artifact store — protects
requests from REPLICA failure. None of them survives the death of the
serving process itself: every accepted-but-unfinished request lives only
in process memory (admission queue, featurize queue, replica in-flight
sets), so a crash or `kill -9` silently loses all of it and the clients
wait on sockets that will never answer. At ParaFold scale the front door
is the long-lived contract with users; the request plane has to be
durable, not just the replicas behind it.

The journal is a write-ahead intake log, deployed as a sibling of
``--flight-dir`` / the artifact store:

  accept   when the fleet ACCEPTS a request (before any dispatch), one
           record — seq + optional MSA arrays + priority + the ABSOLUTE
           wall-clock deadline — is written to ``<root>/<stem>.jr`` via
           write-to-temp + ``os.replace`` (atomic: a crash mid-write
           leaves a temp file, never a torn record under the final name).
  settle   when the request reaches ANY terminal state (result, typed
           error, shed), its record is unlinked. An absent record IS the
           terminal mark — there is no separate commit record to tear.

On restart, ``pending()`` returns every record that never settled and the
fleet replays each through its normal ``submit()`` path. Idempotence is
by construction, not bookkeeping: a replayed request re-enters front-door
coalescing and the content-addressed artifact store, so work that DID
complete before the crash (result persisted, settle unlink lost) replays
as a store hit, identical replayed payloads coalesce to one dispatch, and
the at-least-once journal yields exactly-zero duplicate chip dispatches.

Same checksum-verify-or-degrade discipline as ``artifact_store.py``: every
record carries a sha256 over its payload (own magic, ``AF2JRN1``), arrays
ride an npz with ``allow_pickle=False`` (a poisoned record can fail a
read, never execute code), and ANY framing/checksum/decode problem counts
into ``journal_corrupt_total``, quarantines (unlinks) the bad record, and
skips it — a torn journal entry degrades to one counted lost request,
never a crash or a wrong answer.

Thread safety: one leaf lock guards the live-record map; all disk I/O and
(de)serialization happen outside it. Record filenames are derived from
the trace id, so concurrent accepts never collide on a path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import re
import tempfile
import threading
from typing import List, Optional

import numpy as np

from alphafold2_tpu_torch.telemetry import MetricRegistry

#: on-disk record framing: magic + 64 hex sha256 of the payload + "\n" + payload
_MAGIC = b"AF2JRN1\n"
_HEADER_LEN = len(_MAGIC) + 64 + 1

_RECORD_SUFFIX = ".jr"
_STEM_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


class JournalCorruptError(Exception):
    """A journal record failed framing/checksum/decode validation."""


def _read_bytes(path: str) -> bytes:
    """The read seam (artifact_store stance): module-level so tests can
    interpose torn/vanished reads without monkeypatching builtins."""
    with open(path, "rb") as fh:
        return fh.read()


def _stem(trace_id: str) -> str:
    """Filesystem-safe record name for a trace id. Fleet-minted ids are
    16 hex chars and pass through unchanged; a caller-supplied id with
    hostile characters gets a stable digest stem (the real id still
    rides the record meta)."""
    if _STEM_RE.match(trace_id):
        return trace_id
    return "x" + hashlib.sha256(trace_id.encode()).hexdigest()[:32]


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One accepted-but-unsettled request, as recovered by `pending()`.
    `deadline_unix` is ABSOLUTE wall-clock (time.time) or None — a
    relative deadline would silently extend across a restart."""

    trace_id: str
    seq: str
    msa: Optional[np.ndarray]
    msa_mask: Optional[np.ndarray]
    priority: int
    deadline_unix: Optional[float]
    accepted_at_unix: float


def _pack_record(rec: JournalRecord) -> bytes:
    arrays = {}
    if rec.msa is not None:
        arrays["msa"] = np.ascontiguousarray(rec.msa)
    if rec.msa_mask is not None:
        arrays["msa_mask"] = np.ascontiguousarray(rec.msa_mask)
    meta = {
        "v": 1,
        "trace_id": rec.trace_id,
        "seq": rec.seq,
        "priority": int(rec.priority),
        "deadline_unix": rec.deadline_unix,
        "accepted_at_unix": rec.accepted_at_unix,
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    blob = buf.getvalue()
    digest = hashlib.sha256(blob).hexdigest().encode()
    return _MAGIC + digest + b"\n" + blob


def _unpack_record(data: bytes) -> JournalRecord:
    """Inverse of `_pack_record`; raises JournalCorruptError on ANY
    framing, checksum, or decode problem (one failure class: counted
    skip)."""
    if len(data) < _HEADER_LEN or not data.startswith(_MAGIC):
        raise JournalCorruptError("bad magic / truncated header")
    digest = data[len(_MAGIC):len(_MAGIC) + 64]
    if data[_HEADER_LEN - 1:_HEADER_LEN] != b"\n":
        raise JournalCorruptError("bad header framing")
    blob = data[_HEADER_LEN:]
    if hashlib.sha256(blob).hexdigest().encode() != digest:
        raise JournalCorruptError("payload checksum mismatch")
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
            msa = z["msa"] if "msa" in z.files else None
            msa_mask = z["msa_mask"] if "msa_mask" in z.files else None
    except JournalCorruptError:
        raise
    except Exception as e:  # np.load / json raise a zoo of types
        raise JournalCorruptError(f"payload decode failed: {e!r}") from e
    if meta.get("v") != 1 or "trace_id" not in meta or "seq" not in meta:
        raise JournalCorruptError(f"bad record meta: {meta!r}")
    return JournalRecord(
        trace_id=str(meta["trace_id"]),
        seq=str(meta["seq"]),
        msa=msa,
        msa_mask=msa_mask,
        priority=int(meta.get("priority", 0)),
        deadline_unix=(None if meta.get("deadline_unix") is None
                       else float(meta["deadline_unix"])),
        accepted_at_unix=float(meta.get("accepted_at_unix", 0.0)),
    )


class IntakeJournal:
    """Write-ahead intake journal over one directory.

    One instance per serving process; multiple processes may point at the
    same root (records are per-trace files, writes are atomic), though
    replay is meant to run before traffic is admitted.
    """

    def __init__(self, root: str, registry: Optional[MetricRegistry] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._live = {}  # stem -> path of accepted, not-yet-settled records
        self._accepted = 0
        self._settled = 0
        self._corrupt = 0
        self._write_errors = 0
        self._registry = registry
        if registry is not None:
            self.bind_registry(registry)

    def bind_registry(self, registry: MetricRegistry) -> "IntakeJournal":
        self._registry = registry
        registry.gauge(
            "journal_pending",
            help="journal records accepted but not yet settled",
        ).set(self.pending_count())
        return self

    def _count(self, event: str):
        reg = self._registry
        if reg is not None:
            reg.counter("journal_records_total", event=event).inc()
            with self._lock:
                pending = len(self._live)
            reg.gauge("journal_pending").set(pending)

    # ------------------------------------------------------------- lifecycle

    def accept(self, trace_id: str, seq: str, *,
               msa: Optional[np.ndarray] = None,
               msa_mask: Optional[np.ndarray] = None,
               priority: int = 0,
               deadline_unix: Optional[float] = None,
               accepted_at_unix: float = 0.0) -> bool:
        """Durably record an accepted request BEFORE any dispatch work.
        Returns False (and counts a write_error) if the disk write failed
        — the journal degrades to best-effort rather than failing the
        request it was meant to protect."""
        rec = JournalRecord(
            trace_id=trace_id, seq=seq, msa=msa, msa_mask=msa_mask,
            priority=priority, deadline_unix=deadline_unix,
            accepted_at_unix=accepted_at_unix,
        )
        stem = _stem(trace_id)
        path = os.path.join(self.root, stem + _RECORD_SUFFIX)
        try:
            blob = _pack_record(rec)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
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
            with self._lock:
                self._write_errors += 1
            self._count("write_error")
            return False
        with self._lock:
            self._accepted += 1
            self._live[stem] = path
        self._count("accept")
        return True

    def settle(self, trace_id: str) -> bool:
        """Mark a request terminal: unlink its record (the absent record
        IS the terminal mark — nothing to tear). Unknown / already-settled
        ids no-op cheaply; crash between the request's completion and this
        unlink is safe because replay is idempotent through the artifact
        store."""
        stem = _stem(trace_id)
        with self._lock:
            path = self._live.pop(stem, None)
            if path is not None:
                self._settled += 1
        if path is None:
            return False
        try:
            os.unlink(path)
        except OSError:
            pass  # already gone (concurrent settle / external sweep)
        self._count("settle")
        return True

    # ------------------------------------------------------------- recovery

    def pending(self) -> List[JournalRecord]:
        """Scan the root for unsettled records (a RESTART's view — also
        adopts records written by a previous process). A corrupt/torn
        record counts into `journal_corrupt_total`, is quarantined
        (unlinked), and skipped — never a crash."""
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return []
        out: List[JournalRecord] = []
        reg = self._registry
        for name in names:
            if not name.endswith(_RECORD_SUFFIX):
                if name.endswith(".tmp"):
                    # a crash mid-accept: the temp never reached its
                    # final name, so the request was never accepted —
                    # sweep the debris
                    try:
                        os.unlink(os.path.join(self.root, name))
                    except OSError:
                        pass
                continue
            path = os.path.join(self.root, name)
            try:
                rec = _unpack_record(_read_bytes(path))
            except (JournalCorruptError, OSError):
                with self._lock:
                    self._corrupt += 1
                if reg is not None:
                    reg.counter(
                        "journal_corrupt_total",
                        help="journal records dropped for failed "
                             "framing/checksum/decode",
                    ).inc()
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            stem = name[:-len(_RECORD_SUFFIX)]
            with self._lock:
                self._live[stem] = path
            out.append(rec)
        if reg is not None:
            reg.gauge("journal_pending").set(self.pending_count())
        return out

    # ------------------------------------------------------------- reading

    def pending_count(self) -> int:
        with self._lock:
            return len(self._live)

    def stats(self) -> dict:
        with self._lock:
            return {
                "root": self.root,
                "pending": len(self._live),
                "accepted": self._accepted,
                "settled": self._settled,
                "corrupt": self._corrupt,
                "write_errors": self._write_errors,
            }
