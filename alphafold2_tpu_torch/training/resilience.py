"""Failure detection and recovery for the training loop (counterpart of
alphafold2_tpu/training/resilience.py, redesigned for state that changes
in place).

The JAX guard keeps a reference to the last good state, since a JAX array
never changes, and a restart binds a new state object. The port's step
updates the params and AdamW's moments in place, on the card inside a
CUDA graph that holds their addresses, and `CapturedTrainStep` refuses
any state object but the one it captured. So here:

  * `StepGuard` keeps a device snapshot of the last good state: every
    tensor a step updates (the params, AdamW's step counts and moments,
    `ClippedAdamW.state_tensors`) and the update count. After a good step
    it copies the live tensors into the snapshot, and a rollback copies
    the snapshot back into the same tensors and returns the same state
    object. Both copies are one `torch._foreach_copy_` each (a few
    multi-tensor kernels on the card instead of one launch a tensor); the
    snapshot costs the state's bytes once more in device memory;
  * `run_resilient` restarts from the newest verified checkpoint, or
    failing that from the guard's snapshot, into the live tensors; the
    captured graph is never captured again.

A step is bad when its loss or gradient norm is not finite; the guard's
read of the two is the step's one host sync. Not ported: the metrics
logger's restart events, the tracer, the goodput ledger and
`--metrics-log` (ROADMAP A14); the abort message names every restart's
cause.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from alphafold2_tpu_torch.reliability.faults import FaultPlan, check_training_plan
from alphafold2_tpu_torch.reliability.preemption import Preempted
from alphafold2_tpu_torch.training.checkpoint import finish


class BadStepError(RuntimeError):
    """Raised when non-finite steps persist beyond the tolerated window."""


def _finite_metrics(metrics) -> bool:
    vals = [metrics[k] for k in ("loss", "grad_norm") if k in metrics]
    if all(isinstance(v, torch.Tensor) for v in vals):
        vals = torch.stack([v.detach().float().reshape(()) for v in vals]).tolist()
    return all(math.isfinite(float(v)) for v in vals)


class StepGuard:
    """Rolls back non-finite steps in place; aborts when they persist."""

    def __init__(self, state, max_consecutive_bad: int = 3):
        self.state = state
        self.max_consecutive_bad = max_consecutive_bad
        self.bad_streak = 0
        self._live = state["optimizer"].state_tensors()
        with torch.no_grad():
            self._snapshot = [t.detach().clone() for t in self._live]
        self.good_step = int(state["step"])

    def snapshot(self) -> None:
        """The live state is good: copy it into the snapshot."""
        with torch.no_grad():
            torch._foreach_copy_(self._snapshot, self._live)
        self.good_step = int(self.state["step"])

    def rollback(self) -> None:
        """Copy the snapshot back into the live tensors."""
        with torch.no_grad():
            torch._foreach_copy_(self._live, self._snapshot)
        self.state["step"] = self.good_step

    def check(self, new_state, metrics) -> tuple:
        """Returns (the state to continue from, whether the step was good):
        the same state object either way, rolled back when bad."""
        if new_state is not self.state:
            raise ValueError("StepGuard: the step returned another state object than the "
                             "guarded one (the port's step updates its state in place)")
        if _finite_metrics(metrics):
            self.snapshot()
            self.bad_streak = 0
            return self.state, True
        self.bad_streak += 1
        if self.bad_streak >= self.max_consecutive_bad:
            raise BadStepError(f"{self.bad_streak} consecutive non-finite losses; "
                               "aborting instead of training on garbage")
        self.rollback()
        return self.state, False


def run_resilient(step_fn: Callable, state, batches, *, steps: int,
                  make_rng: Optional[Callable[[int], object]] = None, mgr=None,
                  on_metrics: Optional[Callable[[int, dict], None]] = None,
                  max_restarts: int = 3, max_consecutive_bad: int = 3, preemption=None):
    """Supervised training loop with rollback and checkpoint-restore retry.

    step_fn: (state, batch, rng) -> (state, metrics), updating `state` in
    place (`make_train_step`, `CapturedTrainStep`, either wrapped by
    `with_fault_injection`). batches: an iterator, or a step-indexed
    `fetch(step)` (`synthetic_microbatch_fn`, a `ResilientBatches` around
    one), with which a retried step refetches its batch and recovery is
    bit-exact. steps: steps to run from state["step"]. make_rng: step ->
    the step's rng (None: no rng). mgr: a `VerifiedCheckpointManager`;
    saves ride its interval and restarts restore from it. max_restarts:
    the consecutive exception budget; past it the abort names every cause.
    preemption: a `PreemptionHandler` polled at each step boundary; on its
    flag the loop saves, closes the manager and raises `Preempted`.
    Returns the state (the same object)."""
    start = int(state["step"])
    target = start + steps
    restarts = 0
    causes = []  # (step, exception type, message head) per restart
    guard = StepGuard(state, max_consecutive_bad=max_consecutive_bad)
    # a ResilientBatches says which form it wraps (it is callable in both)
    step_indexed = getattr(batches, "step_indexed", callable(batches))

    def fetch(step):
        try:
            return batches(step) if step_indexed else next(batches)
        except StopIteration:
            raise RuntimeError(f"data exhausted at step {step} (before target {target}); "
                               "not a recoverable fault") from None

    while True:
        step = int(state["step"])
        if preemption is not None and preemption.check():
            if mgr is not None:
                mgr.save(state, force=True)
                mgr.wait()
                mgr.close()
            raise Preempted(step, checkpointed=mgr is not None)
        if step >= target:
            break
        try:
            batch = fetch(step)
            new_state, metrics = step_fn(state, batch,
                                         None if make_rng is None else make_rng(step))
            state, ok = guard.check(new_state, metrics)
            if ok:
                restarts = 0  # the budget is on consecutive failures
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if mgr is not None:
                    mgr.save(state)
            else:
                print(f"step {step}: non-finite loss — rolled back, retrying")
        except (BadStepError, KeyboardInterrupt):
            raise
        except Exception as e:  # the crash-recovery path
            restarts += 1
            causes.append((step, type(e).__name__, str(e).splitlines()[0][:200]))
            if restarts > max_restarts:
                chain = "; ".join(f"{name}({msg!r}) at step {s}" for s, name, msg in causes)
                raise RuntimeError(f"restart budget exhausted (max_restarts={max_restarts}) "
                                   f"at step {step}; cause chain: {chain}") from e
            if mgr is not None and mgr.latest_step() is not None:
                mgr.restore(into=state)
                guard.snapshot()
                where = f"checkpoint step {int(state['step'])}"
            else:
                guard.rollback()
                where = "last good in-memory state"
            guard.bad_streak = 0  # the restored state is clean
            print(f"step {step}: {type(e).__name__}: {e} — "
                  f"restart {restarts}/{max_restarts} from {where}")
    finish(mgr, state)
    return state


# --- the trainer CLI's recovery flags ------------------------------------------


def add_resilience_args(ap):
    """--max-restarts, --ckpt-verify and --fault-plan (the JAX trainers'
    block)."""
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="run under the run_resilient supervisor with this consecutive "
                         "crash-restart budget (0 = plain loop)")
    ap.add_argument("--ckpt-verify", action="store_true",
                    help="accepted for the JAX CLI's flags: the port always writes "
                         "crash-consistent checkpoints (tmp-then-replace writes, a sha256 "
                         "manifest a step, restore falling back past torn steps)")
    ap.add_argument("--fault-plan", default=None, metavar="PATH",
                    help="JSON fault schedule (reliability/faults.py FaultPlan) injected "
                         "into the step, data and checkpoint hooks; implies the "
                         "resilient loop")


def resilient_mode(args) -> bool:
    """True when the trainer runs under `run_resilient` (either flag opts in)."""
    return args.max_restarts > 0 or args.fault_plan is not None


def chaos_from_args(args):
    """(injector, checkpoint fault hook, effective max_restarts) from the
    recovery flags; a plan without a restart budget gets 3. A plan with a
    kind the port has no hook for raises (ROADMAP A11b)."""
    injector, ckpt_hook = None, None
    if args.fault_plan is not None:
        plan = FaultPlan.from_file(args.fault_plan)
        check_training_plan(plan, "--fault-plan")
        injector = plan.injector()
        ckpt_hook = injector.checkpoint_hook()
    max_restarts = args.max_restarts or (3 if args.fault_plan else 0)
    return injector, ckpt_hook, max_restarts
