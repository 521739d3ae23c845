"""Deterministic fault injection: a seeded schedule of failures
(counterpart of alphafold2_tpu/reliability/faults.py).

A `FaultPlan` is a declarative list of faults, loadable from JSON (the
`--fault-plan` flag), and a `FaultInjector` its stateful executor: each
hook site asks whether a fault fires at the current index and delivers it
at most `count` times. The same plan against the same seeds gives the
same failures, so the chaos tests assert bit-exact recovery.

`FaultPlan` parses every kind of the JAX package's `FAULT_KINDS`, so any
plan file it takes loads here. Hook sites:

  training/harness.py     `with_fault_injection(step_fn, injector)`:
                          `step_exception`, `nan_grads` (the step's
                          reported loss and grad_norm come back NaN, so
                          `StepGuard` must roll back) and `preempt`;
  training/data.py        `resilient_batches(..., injector=...)`:
                          `data_error` and `slow_data` at fetch index N;
  training/checkpoint.py  `VerifiedCheckpointManager(fault_hook=
                          injector.checkpoint_hook())`: `ckpt_corrupt`
                          (truncate / corrupt / no_manifest);
  serving/engine.py       `ServingEngine(fault_hook=injector.serving_hook())`:
                          `request_error`, `slow_request`, `hung_request`
                          at dispatch index N, and `crash_process` at the
                          process-wide dispatch index;
  serving/fleet.py        each replica's `injector.replica_hook(name)`:
                          `kill_replica` (latched: every dispatch from
                          `at` on fails, re-probes included), `slow_replica`,
                          `flap_replica` (`count` failures, then healthy),
                          `straggle_dispatch` (a slow success); the
                          featurize tier's `featurize_hook()`:
                          `slow_featurize`, `kill_featurize_worker`;
  serving/autoscale.py    `ReplicaAutoscaler(fault_hook=injector.autoscale_hook())`:
                          `scale_flap`, forced alternating up/down demands at
                          tick index N (`count` of them) that the hysteresis
                          window must absorb.

Replica indices are per-replica counters kept by the INJECTOR, not the
engine, so they survive the engine restarts a drain and reinstatement
make. A plan may mix the families, as the JAX package's CLIs take it: a
kind whose hook the running process does not have never fires (the
training CLIs deliver the training kinds, `serve` the serving kinds,
`scale_flap` among them).

Validate a hand-written plan before paying for a run:

  python -m alphafold2_tpu_torch.reliability.faults --check plan.json
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
    "request_error",    # serving dispatch `at`: raise InjectedFault
    "slow_request",     # serving dispatch `at`: sleep `delay_s`
    "hung_request",     # serving dispatch `at`: sleep `hang_s` (watchdog fodder)
    "kill_replica",     # named fleet replica: fail every dispatch from `at` on
    "slow_replica",     # named fleet replica: sleep `delay_s` per dispatch
    "flap_replica",     # named fleet replica: fail `count` dispatches, recover
    "slow_featurize",   # featurize tier: sleep `delay_s` at job `at`
    "kill_featurize_worker",  # featurize tier: kill the worker serving job `at`
    "scale_flap",       # autoscaler: forced alternating up/down demands at tick `at`
    "crash_process",    # kill -9 the serving process at process-wide dispatch `at`
    "straggle_dispatch",  # named fleet replica: a slow success (the hedge trigger)
)

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


def poison_metrics(metrics: dict) -> dict:
    """NaN the health signals a step reports (loss, grad_norm): what a
    NaN-poisoned gradient looks like to the supervisor."""
    out = dict(metrics)
    for key in ("loss", "grad_norm"):
        if key in out:
            out[key] = np.float32(np.nan)
    return out


class FaultInjector:
    """Stateful executor of a FaultPlan. Thread-safe: the serving hooks run
    on engine workers and the fleet's threads, the training hooks on the
    main thread."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._fired = [0] * len(plan.faults)
        self._replica_dispatch = {}  # replica name -> injector-side counter
        self._preemption = None  # bound PreemptionHandler for `preempt`
        self.delivered: List[str] = []  # audit log of delivered faults
        # fault-free dispatch hooks skip the crash counter's lock
        self._has_crash = any(f.kind == "crash_process" for f in plan.faults)

    def bind_preemption(self, handler):
        """Attach the PreemptionHandler that `preempt` faults trip."""
        self._preemption = handler
        return self

    def _take(self, kind: str, index: int, replica: str = "") -> Optional[Fault]:
        """Claim a matching fault (at most `count` deliveries), or None.
        `kill_replica` is latched: it delivers past any count, so a killed
        replica stays dead across re-probes; the audit log records its
        first delivery only."""
        with self._lock:
            for i, f in enumerate(self.plan.faults):
                if f.kind != kind or f.replica != replica or index < f.at:
                    continue
                if f.kind != "kill_replica" and self._fired[i] >= f.count:
                    continue
                self._fired[i] += 1
                if f.kind != "kill_replica" or self._fired[i] == 1:
                    tag = f"{kind}[{replica}]" if replica else kind
                    self.delivered.append(f"{tag}@{index}")
                return f
        return None

    def exhausted(self) -> bool:
        """True when every scheduled fault has delivered all its counts (a
        latched kill after one delivery)."""
        with self._lock:
            return all(fired >= (1 if f.kind == "kill_replica" else f.count)
                       for fired, f in zip(self._fired, self.plan.faults))

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

    def _maybe_crash(self):
        """Deliver a scheduled `crash_process` at the process-wide dispatch
        index (every serving and replica hook advances one shared counter):
        die as `kill -9` does, exit code 137, no atexit and no flush. The
        intake journal (serving/journal.py) is what must survive it."""
        if not self._has_crash:
            return
        with self._lock:
            index = self._replica_dispatch.get("__process__", 0)
            self._replica_dispatch["__process__"] = index + 1
        if self._take("crash_process", index) is not None:
            os._exit(137)

    # -- hook: serving dispatch (serving/engine.py) --------------------------

    def serving_hook(self):
        """The ServingEngine fault_hook: called with (dispatch_index,
        bucket) at the top of every dispatch."""

        def hook(index: int, bucket: int):
            self._maybe_crash()
            f = self._take("slow_request", index)
            if f is not None:
                time.sleep(f.delay_s)
            f = self._take("hung_request", index)
            if f is not None:
                # a wedged device call: far past the watchdog, on the
                # (abandonable) dispatch thread
                time.sleep(f.hang_s)
            f = self._take("request_error", index)
            if f is not None:
                raise InjectedFault(f.describe())

        return hook

    # -- hook: fleet replica dispatch (serving/fleet.py) ---------------------

    def replica_hook(self, name: str):
        """A ServingEngine fault_hook scoped to fleet replica `name`,
        delivering kill / slow / flap / straggle faults at an injector-side
        per-replica index (a reinstated replica's fresh engine restarts its
        own counter; the schedule must not rewind with it). Health probes
        dispatch through it too, so a killed replica fails its re-probes."""

        def hook(engine_index: int, bucket: int):
            self._maybe_crash()
            with self._lock:
                index = self._replica_dispatch.get(name, 0)
                self._replica_dispatch[name] = index + 1
            f = self._take("slow_replica", index, replica=name)
            if f is not None:
                time.sleep(f.delay_s)
            f = self._take("straggle_dispatch", index, replica=name)
            if f is not None:
                # stalled but SUCCEEDS: the hedge timer, not the failure
                # path, should beat it
                time.sleep(f.delay_s)
            f = self._take("kill_replica", index, replica=name)
            if f is not None:
                raise InjectedFault(f.describe())
            f = self._take("flap_replica", index, replica=name)
            if f is not None:
                raise InjectedFault(f.describe())

        return hook

    # -- hook: featurize tier (serving/featurize.py) -------------------------

    def featurize_hook(self):
        """The FeaturizePool fault_hook: called with the pool's job index at
        the top of every job, delivering at an injector-side index (a
        respawned worker must not rewind the schedule). `slow_featurize`
        sleeps on the worker; `kill_featurize_worker` raises `WorkerKilled`,
        which the pool turns into a worker death and a requeue."""

        def hook(engine_index: int):
            with self._lock:
                index = self._replica_dispatch.get("__featurize__", 0)
                self._replica_dispatch["__featurize__"] = index + 1
            f = self._take("slow_featurize", index)
            if f is not None:
                time.sleep(f.delay_s)
            f = self._take("kill_featurize_worker", index)
            if f is not None:
                raise WorkerKilled(f.describe())

        return hook

    # -- hook: autoscaler ticks (serving/autoscale.py) -----------------------

    def autoscale_hook(self):
        """The ReplicaAutoscaler fault_hook: called with the tick index on
        every evaluation, it returns a forced demand ("up" / "down",
        alternating a delivery) while a `scale_flap` fault is live, None
        otherwise. A forced demand skips the policy's sustain counts but
        not its hysteresis window, which must absorb the flapping."""
        flips = [0]

        def hook(tick_index: int) -> Optional[str]:
            f = self._take("scale_flap", tick_index)
            if f is None:
                return None
            flips[0] += 1
            return "up" if flips[0] % 2 else "down"

        return hook


def _check_main(argv=None) -> int:
    """`python -m alphafold2_tpu_torch.reliability.faults --check plan.json`:
    validate a plan's schema without running anything. Exit 0 printing the
    parsed schedule, or 2 with the precise rejection (the same validation
    every loading path runs)."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="python -m alphafold2_tpu_torch.reliability.faults",
                                 description="validate a chaos fault-plan JSON schema")
    ap.add_argument("--check", required=True, metavar="PLAN_JSON",
                    help="path to the fault-plan JSON to validate")
    args = ap.parse_args(argv)
    try:
        plan = FaultPlan.from_file(args.check)
    except (ValueError, TypeError, KeyError) as e:
        print(f"INVALID {args.check}: {e}", file=sys.stderr)
        return 2
    except (OSError, json.JSONDecodeError) as e:
        print(f"UNREADABLE {args.check}: {e}", file=sys.stderr)
        return 2
    print(f"OK {args.check}: {len(plan.faults)} fault(s), seed {plan.seed}")
    for f in plan.faults:
        extra = []
        if f.replica:
            extra.append(f"replica={f.replica}")
        if f.kind == "ckpt_corrupt":
            extra.append(f"mode={f.mode}")
        if f.kind in ("slow_request", "slow_replica", "slow_featurize", "slow_data",
                      "straggle_dispatch"):
            extra.append(f"delay_s={f.delay_s}")
        if f.kind == "crash_process":
            extra.append("exit=137")
        if f.kind == "hung_request":
            extra.append(f"hang_s={f.hang_s}")
        count = "latched" if f.kind == "kill_replica" else f"count={f.count}"
        print(f"  {f.kind:16s} at={f.at:<5d} {count}"
              + (f"  ({', '.join(extra)})" if extra else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(_check_main())
