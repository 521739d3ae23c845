"""Step-cadence scalar logging (counterpart of
alphafold2_tpu/telemetry/logger.py): `MetricsLogger`, the trainers' and the
engine's JSONL stream of windowed steps/sec and scalar metrics, in the JAX
package's exact record format.

Where JAX makes one `jax.device_get` a log call, the port makes one
device-to-host copy a device: the call's tensor scalars are stacked as
float64 (exact for every float and integer the loss and norms come in)
and copied once, never one `.item()` a scalar. The copy is the call's one
synchronization; a captured step's loss is a clone out of the graph's
memory, so the next replay cannot overwrite what a log call reads.
Logging from inside a CUDA graph capture raises.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch


def per_process_metrics_path(path: str, process_index: int) -> str:
    """The per-process sidecar path: process 0 keeps `path`, process i > 0
    writes `<stem>.p<i><ext>`."""
    if process_index == 0:
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}.p{process_index}{ext}"


def _to_float_scalars(metrics: dict) -> Dict[str, float]:
    """{key: float} with every tensor fetched in one copy a device. A
    non-scalar is reduced to its mean with a warning naming its key; an
    empty one raises."""
    vals, on_device = {}, {}
    for key, v in metrics.items():
        if torch.is_tensor(v):
            if v.numel() == 0:
                raise ValueError(f"metric {key!r} is an empty tensor (shape "
                                 f"{tuple(v.shape)}); log a scalar or a non-empty tensor")
            if v.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"metric {key!r}: a log call inside a CUDA graph capture "
                                   f"would synchronize the capturing stream")
            if v.numel() > 1:
                warnings.warn(f"metric {key!r} has shape {tuple(v.shape)}; logging its mean "
                              f"— pass a scalar (or reduce explicitly) to silence this",
                              stacklevel=4)
                v = v.detach().double().mean()
            on_device.setdefault(v.device, []).append((key, v.detach().reshape(())))
            vals[key] = None  # keep the caller's key order
            continue
        arr = np.asarray(v)
        if arr.size == 0:
            raise ValueError(f"metric {key!r} is an empty array (shape {arr.shape}); "
                             f"log a scalar or a non-empty array")
        if arr.size > 1:
            warnings.warn(f"metric {key!r} has shape {arr.shape}; logging its mean — "
                          f"pass a scalar (or reduce explicitly) to silence this",
                          stacklevel=4)
            vals[key] = float(arr.mean())
        else:
            vals[key] = float(arr.reshape(()))
    for items in on_device.values():
        host = torch.stack([t.to(torch.float64) for _, t in items]).cpu().tolist()
        for (key, _), x in zip(items, host):
            vals[key] = x
    return vals


class MetricsLogger:
    """Step-cadence scalar logging with throughput tracking.

    `print_every`: print every N-th step's record; None prints none (the
    port's CLIs print their own step lines, unchanged by the logger).
    `process_index` stamps every record with its writer's rank; `tail()`
    serves the recent scalar records (the trainer `/statusz` loss tail)
    from a bounded ring.
    """

    def __init__(self, jsonl_path: Optional[str] = None, print_every: Optional[int] = 10,
                 process_index: Optional[int] = None, tail_window: int = 256):
        self.jsonl_path = jsonl_path
        self.print_every = print_every
        self.process_index = process_index
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._t_last = time.perf_counter()
        self._step_last: Optional[int] = None
        # written by the training thread, read by the ops plane's HTTP
        # thread: both sides take the lock
        self._tail = collections.deque(maxlen=tail_window)
        self._tail_lock = threading.Lock()

    def log(self, step: int, metrics: dict):
        """Record metrics for `step`. Values may be tensors (fetched here,
        one copy a device) or plain numbers."""
        now = time.perf_counter()
        vals = _to_float_scalars(metrics)
        # throughput only when the step advanced (a second log call at the
        # same step, e.g. eval scores, must not zero it)
        if self._step_last is not None and step > self._step_last and now > self._t_last:
            vals["steps_per_sec"] = (step - self._step_last) / (now - self._t_last)
            self._t_last, self._step_last = now, step
        elif self._step_last is None or step > self._step_last:
            self._t_last, self._step_last = now, step

        record = {"step": step, **{k: round(v, 6) for k, v in vals.items()}}
        if self.process_index is not None:
            record["process_index"] = self.process_index
        with self._tail_lock:
            self._tail.append(record)
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self.print_every is not None and step % self.print_every == 0:
            parts = "  ".join(f"{k} {v:.4f}" for k, v in vals.items())
            print(f"step {step}  {parts}")
        return vals

    def event(self, step: int, kind: str, **fields):
        """A structured non-scalar record (restart causes, preemptions):
        JSON fields pass through verbatim, tagged `"event"`; always
        printed."""
        record = {"step": step, "event": kind, **fields}
        if self.process_index is not None:
            record["process_index"] = self.process_index
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        parts = "  ".join(f"{k}={v}" for k, v in fields.items())
        print(f"step {step}  [{kind}]  {parts}")
        return record

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """The most recent scalar records, newest last."""
        with self._tail_lock:
            records = list(self._tail)
        return records[-n:] if n is not None else records

    def close(self):
        # idempotent: a context exit followed by close() must not touch a
        # closed file
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
