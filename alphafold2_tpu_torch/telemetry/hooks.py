"""Profiling hooks (counterpart of the helpers in
alphafold2_tpu/telemetry/profiling.py; the port's `telemetry/profiling.py`
is its profiling CLI, which imports the serving package, so the helpers
the serving metrics import live here):

  * `CompileTracker`: a context manager around a compile site (the port's
    compile is a CUDA graph capture: a serving (bucket, rung), a train
    step's batch shape): per-label count and wall seconds as registry
    metrics, and a span;
  * `host_memory_gauges`: the process's resident and peak resident bytes;
  * `device_memory_gauges`: the CUDA caching allocator's counters
    (`torch.cuda.memory_stats`: host-side bookkeeping that never reaches the card, so
    a ticker thread may read them while another thread captures a graph);
  * `flops_gauges`: the analytic FLOPs of a forward and a train step
    (`utils/flops.py`), so MFU follows from any scrape;
  * `profile_trace`: a `torch.profiler` window written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from alphafold2_tpu_torch.telemetry.registry import MetricRegistry
from alphafold2_tpu_torch.telemetry.trace import NULL_TRACER, Tracer


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Profile the enclosed window with `torch.profiler` (the CPU, and the
    card when CUDA is up) and write its Chrome trace to
    `<log_dir>/trace.json` (Perfetto or chrome://tracing)."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class CompileTracker:
    """Compile accounting around a capture or a first call.

    ``with tracker.track(bucket=256): exe = CapturedExecutable(...)``
    lands, per label set:
      * counter  `<prefix>_total`          — completed compile events
      * gauge    `<prefix>_seconds_total`  — cumulative wall seconds
      * gauge    `<prefix>_last_seconds`   — the most recent compile
      * counter  `<prefix>_failed_total`   — compiles that raised
    and one `<prefix>` span (cat="compile"). A failed compile moves only
    the failure counter; its span carries `error` and the exception
    propagates unchanged.
    """

    def __init__(self, registry: MetricRegistry, tracer: Tracer = NULL_TRACER,
                 prefix: str = "compile"):
        self.registry = registry
        self.tracer = tracer
        self.prefix = prefix

    @contextlib.contextmanager
    def track(self, **labels):
        with self.tracer.span(self.prefix, cat="compile", **labels):
            t0 = time.perf_counter()
            try:
                yield
            except BaseException:
                self.registry.counter(
                    f"{self.prefix}_failed_total",
                    help="compile attempts that raised", **labels).inc()
                raise
            dt = time.perf_counter() - t0
            self.registry.counter(
                f"{self.prefix}_total",
                help="completed compile events", **labels).inc()
            self.registry.gauge(
                f"{self.prefix}_seconds_total",
                help="cumulative compile wall seconds", **labels).inc(dt)
            self.registry.gauge(
                f"{self.prefix}_last_seconds",
                help="wall seconds of the most recent compile",
                **labels).set(dt)


def host_memory_gauges(registry: MetricRegistry) -> dict:
    """`host_memory_bytes{kind=rss}` (/proc/self/status) and
    `{kind=peak_rss}` (`resource.getrusage`); returns {"rss_bytes",
    "peak_rss_bytes"}, 0.0 for a field the platform cannot report."""
    peak = rss = 0.0
    try:
        import resource
        import sys

        ru = resource.getrusage(resource.RUSAGE_SELF)
        # ru_maxrss is kilobytes on Linux, bytes on macOS
        peak = float(ru.ru_maxrss) * (1.0 if sys.platform == "darwin" else 1024.0)
    except (ImportError, OSError):  # resource is POSIX-only
        pass
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    rss = float(line.split()[1]) * 1024.0  # kB field
                    break
    except OSError:
        rss = peak  # no procfs: the peak is the honest upper bound
    out = {"rss_bytes": rss, "peak_rss_bytes": peak}
    help_ = "process host memory (resource.getrusage / /proc/self/status)"
    registry.gauge("host_memory_bytes", help=help_, kind="rss").set(rss)
    registry.gauge("host_memory_bytes", help=help_, kind="peak_rss").set(peak)
    return out


# gauge kind -> `torch.cuda.memory_stats` key (the JAX gauges' names where
# the caching allocator has the same quantity)
DEVICE_MEMORY_KINDS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "bytes_reserved": "reserved_bytes.all.current",
    "peak_bytes_reserved": "reserved_bytes.all.peak",
    "num_allocs": "allocation.all.allocated",
    "num_alloc_retries": "num_alloc_retries",
    "num_ooms": "num_ooms",
}


def device_memory_gauges(registry: MetricRegistry, device=None) -> Optional[dict]:
    """`device_memory_bytes{device, kind}` from the CUDA caching
    allocator's counters; returns {kind: value}, or None when the process
    has not brought the card up (a CPU run: absence is not zero memory).
    Reads host-side bookkeeping only: no `mem_get_info`, no
    synchronization, never initializes CUDA."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    stats = torch.cuda.memory_stats(dev)
    out = {kind: float(stats.get(key, 0)) for kind, key in DEVICE_MEMORY_KINDS.items()}
    for kind, value in out.items():
        registry.gauge("device_memory_bytes",
                       help="the CUDA caching allocator's counters (torch.cuda.memory_stats)",
                       device=str(dev.index), kind=kind).set(value)
    return out


def flops_gauges(registry: MetricRegistry, model_cfg, n: int, r: int, c: int,
                 grad_accum: int = 1) -> dict:
    """`model_forward_flops` and `model_train_step_flops` at pair side n,
    MSA r x c (`utils/flops.py`)."""
    from alphafold2_tpu_torch.utils.flops import model_fwd_flops, train_step_flops

    fwd = model_fwd_flops(model_cfg, n, r, c)
    step = train_step_flops(model_cfg, n, r, c, grad_accum=grad_accum)
    registry.gauge(
        "model_forward_flops",
        help="analytic matmul FLOPs of one forward (utils/flops.py)",
    ).set(fwd)
    registry.gauge(
        "model_train_step_flops",
        help="analytic matmul FLOPs of one optimizer step",
    ).set(step)
    return {"forward_flops": fwd, "train_step_flops": step}
