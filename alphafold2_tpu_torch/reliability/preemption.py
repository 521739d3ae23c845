"""Preemption-safe shutdown: catch SIGTERM, checkpoint, exit clean
(counterpart of alphafold2_tpu/reliability/preemption.py).

A preemptible VM gets a SIGTERM and a short grace window. The handler
turns the signal into a flag that `training/resilience.py run_resilient`
polls at each step boundary; on it the loop saves the current state,
closes the checkpoint manager and raises `Preempted`, and the next run
resumes from that checkpoint bit for bit.

The handler only sets an Event and remembers the signum (nothing
async-signal-unsafe); the work happens on the polling thread. Install is
main-thread-only; `deliver()` is the in-process stand-in the fault
injector uses. One process only: the JAX package's pod consensus (a
global OR of the flag across processes) waits for ROADMAP A13.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class Preempted(RuntimeError):
    """Raised by the guarded loop after a preemption's final save; carries
    `step` and `checkpointed`, so an entry script can print an honest
    resume message and exit 0."""

    def __init__(self, step: int, message: str = "", checkpointed: bool = True):
        self.step = step
        self.checkpointed = checkpointed
        if not message:
            message = (
                f"preempted: final checkpoint saved at step {step}; "
                "rerun with the same --ckpt-dir to resume"
                if checkpointed else
                f"preempted at step {step} with NO checkpoint manager — "
                "progress was not saved; rerun with --ckpt-dir to make "
                "future preemptions resumable"
            )
        super().__init__(message)


class PreemptionHandler:
    """Latching SIGTERM flag with handler install/restore: usable
    uninstalled (the fault injector delivers via `deliver()`), as a
    context manager, or through install()/uninstall(). (The JAX package's
    drain callbacks serve its fleet, not ported: ROADMAP A11b.)"""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._signum: Optional[int] = None
        self._previous = {}
        self._installed = False

    def _handler(self, signum, frame):
        self._signum = signum
        self._event.set()

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handler)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def deliver(self, signum: int = signal.SIGTERM):
        """In-process delivery (what a SIGTERM does, minus the kernel)."""
        self._handler(signum, None)

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def check(self) -> bool:
        """Poll point: True once preempted."""
        return self._event.is_set()
