"""The port's recovery layer on the CPU: `StepGuard`, `run_resilient`, the
fault plans and preemption (the JAX package's tests/test_resilience.py and
the training cases of tests/test_chaos.py).

The recovery invariant: a faulted run ends bit-equal to the fault-free run
(a step-indexed fetch refetches a retried step's batch): NaN rollback, a
restart from the checkpoint or from the guard's snapshot, a damaged
checkpoint, a transient data error, preemption then resume. The port's
step updates its state in place, so the guard rolls back into the same
tensors of the same state object (the captured step refuses any other).
Against the JAX package's `run_resilient` under the same plan and from the
same params the final params agree to 1e-5 (`test_torch_train.py`'s bound
for a step: the same function in another summation order).
"""

import json

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.reliability import FaultPlan as JaxFaultPlan
from alphafold2_tpu.reliability.faults import FAULT_KINDS as JAX_FAULT_KINDS
from alphafold2_tpu.training import harness as jharness
from alphafold2_tpu.training import resilience as jresilience
from alphafold2_tpu.training.checkpoint import VerifiedCheckpointManager as JaxManager
from alphafold2_tpu_torch import Alphafold2Config, params_from_jax
from alphafold2_tpu_torch.reliability.faults import (
    FAULT_KINDS,
    REPLICA_FAULT_KINDS,
    Fault,
    FaultPlan,
    InjectedFault,
    check_training_plan,
)
from alphafold2_tpu_torch.reliability.preemption import Preempted, PreemptionHandler
from alphafold2_tpu_torch.training.checkpoint import VerifiedCheckpointManager, open_or_init
from alphafold2_tpu_torch.training.data import (
    DataConfig,
    resilient_batches,
    synthetic_microbatch_fn,
)
from alphafold2_tpu_torch.training.harness import (
    TrainConfig,
    make_train_step,
    train_state,
    train_state_init,
    with_fault_injection,
)
from alphafold2_tpu_torch.training.resilience import BadStepError, StepGuard, run_resilient

KW = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=64)
CFG = Alphafold2Config(**KW)
TCFG = TrainConfig(learning_rate=1e-3, grad_accum=1)
DCFG = DataConfig(batch_size=1, max_len=8)
TINY = ["--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8", "--len", "8",
        "--accum", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def step_fn():
    return make_train_step(CFG, TCFG, device="cpu")


def fresh_state():
    return train_state_init(CFG, TCFG, torch.Generator().manual_seed(0), "cpu")


def run_guarded(step_fn, *, steps, injector=None, mgr=None, fetch=None, preemption=None,
                max_restarts=3, state=None):
    return run_resilient(
        with_fault_injection(step_fn, injector), fresh_state() if state is None else state,
        fetch if fetch is not None else synthetic_microbatch_fn(DCFG, 1),
        steps=steps, mgr=mgr, max_restarts=max_restarts, preemption=preemption)


def assert_states_equal(a, b):
    """Every tensor a step updates (params, AdamW's steps and moments) bit
    for bit, and the update count."""
    assert a["step"] == b["step"]
    ta, tb = a["optimizer"].state_tensors(), b["optimizer"].state_tensors()
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


def plan(*faults):
    return FaultPlan(faults=tuple(faults))


# --- plans ------------------------------------------------------------------------


def test_fault_plan_parses_every_kind_as_the_jax_package_does():
    """A plan with every kind of FAULT_KINDS loads, as the JAX package loads
    it (the same schedule back from to_json); the port delivers the
    training kinds and refuses the others naming A11b."""
    assert FAULT_KINDS == JAX_FAULT_KINDS
    d = {"seed": 3, "faults": [
        dict({"kind": k, "step": i, "count": 2},
             **({"replica": "r0"} if k in REPLICA_FAULT_KINDS else {}),
             **({"mode": "no_manifest"} if k == "ckpt_corrupt" else {}))
        for i, k in enumerate(FAULT_KINDS)]}
    p, jp = FaultPlan.from_json(json.dumps(d)), JaxFaultPlan.from_json(json.dumps(d))
    assert json.loads(p.to_json()) == json.loads(jp.to_json())
    assert FaultPlan.from_json(p.to_json()) == p
    assert [f.kind for f in p.faults] == list(FAULT_KINDS) and p.faults[3].at == 3
    with pytest.raises(NotImplementedError, match="A11b"):
        check_training_plan(p, "train_pre")
    check_training_plan(plan(Fault("nan_grads"), Fault("slow_data", delay_s=0.0)), "train_pre")
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(kind="meteor_strike")
    with pytest.raises(ValueError, match="mode"):
        Fault(kind="ckpt_corrupt", mode="gentle")
    with pytest.raises(ValueError, match="unknown field"):
        FaultPlan.from_dict({"faults": [{"kind": "nan_grads", "stpe": 2}]})
    inj = plan(Fault("data_error", at=1)).injector()
    inj.before_batch(0)  # below `at`: silent
    with pytest.raises(InjectedFault):
        inj.before_batch(1)
    assert inj.exhausted()


# --- the guard --------------------------------------------------------------------


def test_rollback_keeps_the_state_object_and_its_tensors(step_fn):
    """A bad step is rolled back by copying the snapshot into the live
    tensors: the guard returns the same state object, every tensor keeps
    its address (a captured graph's check holds), and the values are the
    last good step's bit for bit, AdamW's moments and counts included."""
    state = fresh_state()
    guard = StepGuard(state)
    live = state["optimizer"].state_tensors()
    ptrs = [t.data_ptr() for t in live]
    fetch = synthetic_microbatch_fn(DCFG, 1)
    out, ok = guard.check(*step_fn(state, fetch(0)))
    assert ok and out is state
    good = [t.detach().clone() for t in live]
    _, metrics = step_fn(state, fetch(1))
    assert state["step"] == 2 and not torch.equal(live[0], good[0])
    out, ok = guard.check(state, dict(metrics, loss=torch.tensor(float("nan"))))
    assert not ok and out is state and state["step"] == 1
    assert [t.data_ptr() for t in state["optimizer"].state_tensors()] == ptrs
    assert all(torch.equal(t, g) for t, g in zip(live, good))
    with pytest.raises(ValueError, match="another state"):
        guard.check(fresh_state(), metrics)


def test_three_consecutive_bad_steps_raise_bad_step_error(step_fn):
    inj = plan(Fault("nan_grads", at=1, count=3)).injector()
    with pytest.raises(BadStepError, match="3 consecutive"):
        run_guarded(step_fn, steps=3, injector=inj)


# --- the fault matrix, against a fault-free run -------------------------------------


def test_nan_grads_rolls_back_bit_exact(step_fn):
    baseline = run_guarded(step_fn, steps=3)
    inj = plan(Fault("nan_grads", at=1)).injector()
    state = fresh_state()
    ptrs = [t.data_ptr() for t in state["optimizer"].state_tensors()]
    final = run_guarded(step_fn, steps=3, injector=inj, state=state)
    assert inj.exhausted() and final is state
    assert [t.data_ptr() for t in final["optimizer"].state_tensors()] == ptrs
    assert_states_equal(baseline, final)


@pytest.mark.parametrize("with_mgr", [True, False], ids=["checkpoint", "snapshot"])
def test_step_exception_restarts_bit_exact(step_fn, tmp_path, capsys, with_mgr):
    """A crash before step 2: the state comes back from the newest
    checkpoint (or, without a manager, the guard's snapshot) into the live
    tensors, the step is replayed, the run ends bit-equal."""
    baseline = run_guarded(step_fn, steps=4)
    inj = plan(Fault("step_exception", at=2)).injector()
    mgr = VerifiedCheckpointManager(str(tmp_path / "ck")) if with_mgr else None
    final = run_guarded(step_fn, steps=4, injector=inj, mgr=mgr)
    assert inj.exhausted() and final["step"] == 4
    out = capsys.readouterr().out
    assert ("from checkpoint step 2" if with_mgr else "from last good in-memory state") in out
    assert_states_equal(baseline, final)


def test_ckpt_corruption_falls_back_and_recovers_bit_exact(step_fn, tmp_path, capsys):
    """The step-3 checkpoint is torn; a crash at step 3 restores from step
    2, replays, and ends bit-equal."""
    baseline = run_guarded(step_fn, steps=4)
    inj = plan(Fault("ckpt_corrupt", at=3, mode="truncate"),
               Fault("step_exception", at=3)).injector()
    mgr = VerifiedCheckpointManager(str(tmp_path / "ck"), fault_hook=inj.checkpoint_hook())
    final = run_guarded(step_fn, steps=4, injector=inj, mgr=mgr)
    assert inj.exhausted()
    assert "failed verification" in capsys.readouterr().out
    assert_states_equal(baseline, final)


def test_transient_data_error_retries_bit_exact(step_fn):
    baseline = run_guarded(step_fn, steps=3)
    inj = plan(Fault("data_error", at=1)).injector()
    fetch = resilient_batches(synthetic_microbatch_fn(DCFG, 1), injector=inj,
                              max_retries=2, backoff_s=0.0)
    final = run_guarded(step_fn, steps=3, fetch=fetch)
    assert inj.exhausted() and fetch.retries == 1 and fetch.skipped == 0
    assert_states_equal(baseline, final)


def test_skip_budget_aborts_on_a_broken_source():
    inj = plan(Fault("data_error", at=0, count=10_000)).injector()
    fetch = resilient_batches(synthetic_microbatch_fn(DCFG, 1), injector=inj,
                              max_retries=1, backoff_s=0.0, max_skipped=2)
    with pytest.raises(RuntimeError, match="max_skipped"):
        for _ in range(50):
            fetch(0)


def test_preemption_saves_and_a_second_run_resumes_bit_exact(step_fn, tmp_path):
    """`preempt` before step 3: the loop saves at the next boundary (step
    4) and raises Preempted; a fresh state restored by open_or_init runs the
    last step and ends bit-equal to the uninterrupted 5 steps."""
    baseline = run_guarded(step_fn, steps=5)
    handler = PreemptionHandler()
    inj = plan(Fault("preempt", at=3)).injector().bind_preemption(handler)
    path = str(tmp_path / "ck")
    with pytest.raises(Preempted) as exc_info:
        run_guarded(step_fn, steps=5, injector=inj, mgr=VerifiedCheckpointManager(path),
                    preemption=handler)
    assert exc_info.value.step == 4 and exc_info.value.checkpointed
    mgr, state, resumed = open_or_init(path, fresh_state)
    assert resumed and state["step"] == 4
    final = run_guarded(step_fn, steps=1, state=state, mgr=mgr)
    assert_states_equal(baseline, final)


def test_preemption_without_a_manager_is_honest(step_fn):
    handler = PreemptionHandler()
    inj = plan(Fault("preempt", at=1)).injector().bind_preemption(handler)
    with pytest.raises(Preempted) as exc_info:
        run_guarded(step_fn, steps=3, injector=inj, preemption=handler)
    assert not exc_info.value.checkpointed and "not saved" in str(exc_info.value)


def test_restart_budget_is_consecutive_and_its_abort_names_every_cause(step_fn):
    """Failures separated by good steps do not add up; a budget exhausted
    raises naming the whole cause chain, the last exception chained."""
    inj = plan(Fault("step_exception", at=1), Fault("step_exception", at=2),
               Fault("step_exception", at=4)).injector()
    final = run_guarded(step_fn, steps=6, injector=inj, max_restarts=2)
    assert final["step"] == 6 and inj.exhausted()
    calls = [0]

    def always_crash(state, batch, rng):
        calls[0] += 1
        raise RuntimeError(f"hard failure #{calls[0]}")

    with pytest.raises(RuntimeError, match="cause chain") as exc_info:
        run_resilient(always_crash, fresh_state(), synthetic_microbatch_fn(DCFG, 1),
                      steps=2, max_restarts=2)
    msg = str(exc_info.value)
    assert "hard failure #1" in msg and "hard failure #3" in msg
    assert exc_info.value.__cause__ is not None
    with pytest.raises(RuntimeError, match="data exhausted"):
        run_resilient(step_fn, fresh_state(), iter([synthetic_microbatch_fn(DCFG, 1)(0)]),
                      steps=3)


# --- against the JAX package ----------------------------------------------------------


def test_port_and_jax_run_resilient_agree_under_the_same_plan(tmp_path):
    """From the same params (`params_from_jax`) and batches, the same plan
    (a NaN step, a crash restored from a torn-then-fallback checkpoint, a
    transient data error) through both packages' run_resilient: both
    deliver every fault, end at step 5, and their params agree to 1e-5."""
    spec = json.dumps({"faults": [
        {"kind": "nan_grads", "step": 1},
        {"kind": "ckpt_corrupt", "step": 3, "mode": "truncate"},
        {"kind": "step_exception", "step": 3},
        {"kind": "data_error", "index": 2}]})
    jcfg, jt = JaxConfig(**KW), jharness.TrainConfig(learning_rate=1e-3, grad_accum=1)
    jstate = jharness.train_state_init(jax.random.PRNGKey(0), jcfg, jt)
    from alphafold2_tpu.training import data as jdata

    jinj = JaxFaultPlan.from_json(spec).injector()
    jfinal = jresilience.run_resilient(
        jharness.with_fault_injection(jax.jit(jharness.make_train_step(jcfg, jt)), jinj),
        jstate, jdata.resilient_batches(
            jdata.synthetic_microbatch_fn(jdata.DataConfig(batch_size=1, max_len=8), 1),
            injector=jinj, backoff_s=0.0),
        steps=5, make_rng=lambda i: jax.random.fold_in(jax.random.PRNGKey(1), i),
        mgr=JaxManager(str(tmp_path / "j"), fault_hook=jinj.checkpoint_hook()))

    tstate = train_state(params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                                         CFG, device="cpu"), TCFG)
    inj = FaultPlan.from_json(spec).injector()
    final = run_resilient(
        with_fault_injection(make_train_step(CFG, TCFG, device="cpu"), inj), tstate,
        resilient_batches(synthetic_microbatch_fn(DCFG, 1), injector=inj, backoff_s=0.0),
        steps=5, mgr=VerifiedCheckpointManager(str(tmp_path / "t"),
                                               fault_hook=inj.checkpoint_hook()))
    assert inj.exhausted() and jinj.exhausted()
    assert sorted(inj.delivered) == sorted(jinj.delivered)
    assert final["step"] == int(jfinal["step"]) == 5
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jfinal["params"]), CFG,
                           device="cpu")
    for w, leaf in zip(jax.tree_util.tree_leaves(want), final["optimizer"].leaves):
        torch.testing.assert_close(leaf.detach(), w, rtol=0, atol=1e-5)


# --- the CLI ---------------------------------------------------------------------------


@pytest.mark.parametrize("stop", ["steps", "preempt"])
def test_train_pre_stopped_and_resumed_ends_with_the_uninterrupted_state(tmp_path, capsys,
                                                                         stop):
    """`train_pre --ckpt-dir --ckpt-every 2` for 4 steps, against a run
    stopped after 2 steps (its last step saved by `finish`) or preempted
    by a fault plan before step 2 (saved at the boundary, exit without an
    error), then resumed for the rest: the same state bit for bit, the
    same step-4 checkpoint file."""
    from alphafold2_tpu_torch import train_pre

    whole, _ = train_pre.main(TINY + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a"),
                                      "--ckpt-every", "2"])
    args = TINY + ["--ckpt-dir", str(tmp_path / "b"), "--ckpt-every", "2"]
    if stop == "steps":
        first, _ = train_pre.main(args + ["--steps", "2"])
    else:
        (tmp_path / "plan.json").write_text(json.dumps(
            {"faults": [{"kind": "preempt", "step": 1}]}))
        first, metrics = train_pre.main(args + ["--steps", "4", "--fault-plan",
                                                str(tmp_path / "plan.json")])
        assert metrics is None and "preempted: final checkpoint saved at step 2" in \
            capsys.readouterr().out
    assert first["step"] == 2
    resumed, _ = train_pre.main(args + ["--steps", "2"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert_states_equal(whole, resumed)
    a = np.load(tmp_path / "a" / "step_00000004.npz")
    b = np.load(tmp_path / "b" / "step_00000004.npz")
    assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_train_pre_refuses_a_serving_fault_kind(tmp_path):
    from alphafold2_tpu_torch import train_pre

    (tmp_path / "plan.json").write_text(json.dumps(
        {"faults": [{"kind": "request_error", "step": 1}]}))
    with pytest.raises(NotImplementedError, match="A11b"):
        train_pre.main(TINY + ["--steps", "1", "--fault-plan", str(tmp_path / "plan.json")])
