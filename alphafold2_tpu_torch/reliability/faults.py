"""Deterministic fault injection: a seeded schedule of failures
(counterpart of alphafold2_tpu/reliability/faults.py, its training hooks).

A `FaultPlan` is a declarative list of faults, loadable from JSON (the
`--fault-plan` trainer flag), and a `FaultInjector` its stateful executor:
each hook site asks whether a fault fires at the current index and
delivers it at most `count` times. The same plan against the same seeds
gives the same failures, so the chaos tests assert bit-exact recovery.

`FaultPlan` parses every kind of the JAX package's `FAULT_KINDS`, so any
plan file it takes loads here. The port delivers the training hooks only:

  training/harness.py     `with_fault_injection(step_fn, injector)`:
                          `step_exception`, `nan_grads` (the step's
                          reported loss and grad_norm come back NaN, so
                          `StepGuard` must roll back) and `preempt`;
  training/data.py        `resilient_batches(..., injector=...)`:
                          `data_error` and `slow_data` at fetch index N;
  training/checkpoint.py  `VerifiedCheckpointManager(fault_hook=
                          injector.checkpoint_hook())`: `ckpt_corrupt`
                          (truncate / corrupt / no_manifest).

`check_training_plan` refuses a plan with a serving, replica, featurize,
autoscaler or process-crash kind, naming ROADMAP A11b: those hooks live in
the serving fleet, not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import List, Optional

import numpy as np

FAULT_KINDS = (
    "step_exception",   # raise InjectedFault before train step `at`
    "nan_grads",        # step `at` reports NaN loss/grad_norm (rollback bait)
    "preempt",          # SIGTERM-style preemption request at step `at`
    "ckpt_corrupt",     # damage the checkpoint written for step `at`
    "data_error",       # raise InjectedFault at batch fetch index `at`
    "slow_data",        # sleep `delay_s` at batch fetch index `at`
    "request_error",    # serving dispatch `at`: raise (not ported: A11b)
    "slow_request",     # serving dispatch `at`: sleep `delay_s` (A11b)
    "hung_request",     # serving dispatch `at`: sleep `hang_s` (A11b)
    "kill_replica",     # named fleet replica: fail from `at` on (A11b)
    "slow_replica",     # named fleet replica: sleep per dispatch (A11b)
    "flap_replica",     # named fleet replica: fail `count` dispatches (A11b)
    "slow_featurize",   # featurize tier: sleep at job `at` (A11b)
    "kill_featurize_worker",  # featurize tier: kill a worker (A11b)
    "scale_flap",       # autoscaler: forced up/down demands (A11b)
    "crash_process",    # kill -9 the serving process at dispatch `at` (A11b)
    "straggle_dispatch",  # named fleet replica: a slow success (A11b)
)

#: the kinds the port delivers (the training hooks)
TRAINING_FAULT_KINDS = ("step_exception", "nan_grads", "preempt", "ckpt_corrupt",
                        "data_error", "slow_data")

#: kinds that target one named fleet replica and require `replica`
REPLICA_FAULT_KINDS = ("kill_replica", "slow_replica", "flap_replica", "straggle_dispatch")

_CKPT_MODES = ("truncate", "corrupt", "no_manifest")


class InjectedFault(RuntimeError):
    """The exception every raising fault kind delivers, so recovery logs
    tell injected failures from organic ones."""


class WorkerKilled(InjectedFault):
    """`kill_featurize_worker`'s delivery (alphafold2_tpu/reliability/
    faults.py:111): the featurize pool (serving/featurize.py) treats it as
    the WORKER dying (respawn the thread, requeue the job) rather than the
    request failing, as an organic thread death differs from a bad
    input."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. Fires while `index >= at` and fewer than
    `count` deliveries have happened (count=1 fires once, at `at`)."""

    kind: str
    at: int = 0
    count: int = 1
    mode: str = "truncate"      # ckpt_corrupt: truncate | corrupt | no_manifest
    delay_s: float = 0.05       # slow_* sleep
    hang_s: float = 30.0        # hung_request sleep
    replica: str = ""           # *_replica kinds: the named fleet replica
    message: str = ""

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.kind == "ckpt_corrupt" and self.mode not in _CKPT_MODES:
            raise ValueError(f"ckpt_corrupt mode {self.mode!r} not in {_CKPT_MODES}")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.kind in REPLICA_FAULT_KINDS and not self.replica:
            raise ValueError(f"{self.kind} requires a 'replica' name (e.g. \"r0\") — a "
                             f"replica-scoped fault with no target would silently no-op")
        if self.replica and self.kind not in REPLICA_FAULT_KINDS:
            raise ValueError(f"'replica' is only meaningful for {REPLICA_FAULT_KINDS}, "
                             f"not {self.kind!r}")

    def describe(self) -> str:
        if self.message:
            return self.message
        where = f"replica {self.replica!r}, " if self.replica else ""
        return f"injected {self.kind} ({where}index {self.at})"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Immutable fault schedule; `injector()` mints a fresh executor (one
    a run: the delivery counters live on the injector)."""

    faults: tuple = ()
    seed: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        unknown_top = set(d) - {"faults", "seed"}
        if unknown_top:
            raise ValueError(f"unknown fault-plan key(s) {sorted(unknown_top)}; a plan is "
                             f"{{\"seed\": int, \"faults\": [...]}}")
        allowed = {f.name for f in dataclasses.fields(Fault)}
        faults = []
        for i, f in enumerate(d.get("faults", ())):
            f = dict(f)
            for alias in ("step", "index"):  # read naturally in hand-written plans
                if alias in f:
                    f["at"] = f.pop(alias)
            unknown = set(f) - allowed
            if unknown:
                raise ValueError(f"fault #{i} ({f.get('kind', '?')!r}): unknown field(s) "
                                 f"{sorted(unknown)}; allowed: "
                                 f"{sorted(allowed | {'step', 'index'})}")
            faults.append(Fault(**f))
        return cls(faults=tuple(faults), seed=int(d.get("seed", 0)))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [dataclasses.asdict(f) for f in self.faults]}, indent=2)

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)


def check_training_plan(plan: FaultPlan, what: str) -> None:
    """Refuse a plan whose faults the port has no hook for (the serving
    fleet's kinds), naming ROADMAP A11b."""
    other = sorted({f.kind for f in plan.faults} - set(TRAINING_FAULT_KINDS))
    if other:
        raise NotImplementedError(
            f"{what}: fault kind(s) {other} need the serving fleet's hooks, which are not "
            f"ported yet (ROADMAP A11b); the port delivers {TRAINING_FAULT_KINDS}")


def poison_metrics(metrics: dict) -> dict:
    """NaN the health signals a step reports (loss, grad_norm): what a
    NaN-poisoned gradient looks like to the supervisor."""
    out = dict(metrics)
    for key in ("loss", "grad_norm"):
        if key in out:
            out[key] = np.float32(np.nan)
    return out


class FaultInjector:
    """Stateful executor of a FaultPlan's training faults (thread-safe)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._fired = [0] * len(plan.faults)
        self._preemption = None  # bound PreemptionHandler for `preempt`
        self.delivered: List[str] = []  # audit log of delivered faults

    def bind_preemption(self, handler):
        """Attach the PreemptionHandler that `preempt` faults trip."""
        self._preemption = handler
        return self

    def _take(self, kind: str, index: int) -> Optional[Fault]:
        """Claim a matching fault (at most `count` deliveries), or None."""
        with self._lock:
            for i, f in enumerate(self.plan.faults):
                if f.kind != kind or index < f.at or self._fired[i] >= f.count:
                    continue
                self._fired[i] += 1
                self.delivered.append(f"{kind}@{index}")
                return f
        return None

    def exhausted(self) -> bool:
        """True when every scheduled fault has delivered all its counts."""
        with self._lock:
            return all(fired >= f.count for fired, f in zip(self._fired, self.plan.faults))

    # -- hook: training step (training/harness.py) --------------------------

    def before_train_step(self, step: int, batch):
        """Before each train step: returns the batch or raises
        (step_exception) / trips preemption."""
        if self._take("preempt", step) is not None:
            if self._preemption is None:
                raise RuntimeError("preempt fault scheduled but no PreemptionHandler bound "
                                   "(injector.bind_preemption)")
            self._preemption.deliver()
        f = self._take("step_exception", step)
        if f is not None:
            raise InjectedFault(f.describe())
        return batch

    def after_train_step(self, step: int, new_state, metrics):
        """On each step's result: a `nan_grads` fault makes the reported
        metrics non-finite, which StepGuard must roll back."""
        if self._take("nan_grads", step) is not None:
            return new_state, poison_metrics(metrics)
        return new_state, metrics

    # -- hook: data pipeline (training/data.py) ------------------------------

    def before_batch(self, index: int):
        f = self._take("slow_data", index)
        if f is not None:
            time.sleep(f.delay_s)
        f = self._take("data_error", index)
        if f is not None:
            raise InjectedFault(f.describe())

    # -- hook: checkpoint writes (training/checkpoint.py) --------------------

    def checkpoint_hook(self):
        """The VerifiedCheckpointManager fault_hook: called with (step,
        state_path, manifest_path) after a completed write, it damages the
        files as a crash mid-write would."""

        def hook(step: int, state_path: str, manifest_path: str):
            f = self._take("ckpt_corrupt", step)
            if f is None:
                return
            if f.mode == "no_manifest":  # a crash between data and manifest
                os.unlink(manifest_path)
                return
            size = os.path.getsize(state_path)
            with open(state_path, "r+b") as fh:
                if f.mode == "truncate":
                    fh.truncate(max(1, size // 2))  # torn write
                else:  # corrupt: flip bytes mid-file, size kept
                    fh.seek(size // 2)
                    fh.write(b"\xde\xad\xbe\xef")

        return hook
