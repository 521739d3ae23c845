"""The port's serving fleet (alphafold2_tpu_torch/serving/fleet.py) against
the JAX package's (alphafold2_tpu/serving/fleet.py) on the CPU.

  (a) scripted scenarios through both packages' `ServingFleet` over fake
      engines (each package's own `ServingEngine` with the device call
      stubbed at `_call_executable`): kill, flap and slow a replica, a
      total outage with and without a degraded tier, the retry budget
      draining and refilling, hedged dispatch, pool routing by length, the
      cascade's accept and escalate, artifact-store hits and coalesced
      followers, and journal replay. Requests go one at a time (or wait on
      an event the test holds), so routing is deterministic: both fleets
      must end every request the same way and count the same `fleet_*`
      (and retry-budget, cascade, front-door, store and journal) counters;
  (b) a real tiny engine pair (one bucket, dim 16, depth 1) from the same
      weights (`params_from_jax`): the fleets' results agree within
      tests/test_torch_pipeline.py's request tolerances, and a requeued
      result is bit for bit the port's bare engine's;
  (c) the serving, replica and featurize fault kinds against JAX's
      `FaultInjector`: the same deliveries on the same calls;
  (d) the CLI (the verify skill's fleet chaos recipe through the port) and
      the fleet's ops server.

Every wait is bounded; nothing sleeps to order events."""

import dataclasses
import json
import os
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.reliability import faults as jfaults
from alphafold2_tpu.serving import artifact_store as jstore
from alphafold2_tpu.serving import cascade as jcascade
from alphafold2_tpu.serving import engine as jengine
from alphafold2_tpu.serving import fleet as jfleet
from alphafold2_tpu.serving import journal as jjournal
from alphafold2_tpu_torch import Alphafold2Config, params_from_jax
from alphafold2_tpu_torch.constants import AA_ORDER
from alphafold2_tpu_torch.reliability import faults as tfaults
from alphafold2_tpu_torch.serving import artifact_store as tstore
from alphafold2_tpu_torch.serving import cascade as tcascade
from alphafold2_tpu_torch.serving import engine as tengine
from alphafold2_tpu_torch.serving import fleet as tfleet
from alphafold2_tpu_torch.serving import journal as tjournal

WAIT = 30  # seconds: the bound of every wait
TINY = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)


def seq_of(length, offset=0):
    return "".join(AA_ORDER[(offset + i) % len(AA_ORDER)] for i in range(length))


class Gate:
    """Holds the dispatches of the named replicas until `release()`."""

    def __init__(self):
        self.replicas = set()
        self.entered = threading.Event()
        self._open = threading.Event()

    def hold(self, *names):
        self.replicas = set(names)
        self._open.clear()
        self.entered.clear()

    def release(self):
        self._open.set()

    def wait(self, name):
        if name in self.replicas and not self._open.is_set():
            self.entered.set()
            if not self._open.wait(WAIT):
                raise RuntimeError("gate never released")


def fake_engine_class(base):
    """`base` (a package's ServingEngine) with the device call stubbed: each
    request's confidence is 0.9 for an even length and 0.2 for an odd one
    (the cascade's accept and escalate), coords and stress a function of
    the tokens."""

    class FakeEngine(base):
        gate = None

        def _call_executable(self, bucket, tokens, mask, msa=None, msa_mask=None):
            if self.gate is not None:
                self.gate.wait(self.replica_name)
            B, Lb = tokens.shape
            lengths = np.asarray(mask).sum(-1)
            conf = np.where(lengths % 2 == 0, 0.9, 0.2).astype(np.float32)
            coords = np.repeat(np.asarray(tokens, np.float32)[..., None], 3, -1)
            return {"coords": coords,
                    "confidence": np.repeat(conf[:, None], Lb, 1),
                    "stress": (lengths / 100.0).astype(np.float32)}

    return FakeEngine


PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", cfg=JaxConfig(**TINY), engine=jengine, fleet=jfleet, faults=jfaults,
        store=jstore, cascade=jcascade, journal=jjournal,
        Fake=fake_engine_class(jengine.ServingEngine), engine_kw={}, fleet_kw={}),
    "torch": types.SimpleNamespace(
        name="torch", cfg=Alphafold2Config(**TINY), engine=tengine, fleet=tfleet,
        faults=tfaults, store=tstore, cascade=tcascade, journal=tjournal,
        Fake=fake_engine_class(tengine.ServingEngine), engine_kw={"device": "cpu"},
        fleet_kw={"device": "cpu"}),
}


def scfg_of(ns, **overrides):
    base = dict(buckets=(8, 16), max_batch=2, max_queue=8, max_wait_s=0.0,
                request_timeout_s=30.0, cache_capacity=0)
    base.update(overrides)
    return ns.engine.ServingConfig(**base)


def fleet_of(ns, *faults, gate=None, scfg=None, **overrides):
    """A fleet of fake engines: no heartbeats, a replica down on its first
    failure, no reinstatement unless a test asks for one."""
    base = dict(replicas=2, probe_interval_s=0, reprobe_interval_s=30.0,
                fail_threshold=1, requeue_limit=2)
    base.update(overrides)
    injector = (ns.faults.FaultPlan(faults=tuple(ns.faults.Fault(**f) for f in faults))
                .injector() if faults else None)
    extra = {k: base.pop(k) for k in ("artifact_store", "journal") if k in base}

    def factory(name, cfg, hook):
        eng = ns.Fake({}, ns.cfg, cfg, fault_hook=hook, replica_name=name, **ns.engine_kw)
        eng.gate = gate
        return eng

    fleet = ns.fleet.ServingFleet({}, ns.cfg, scfg or scfg_of(ns),
                                  ns.fleet.FleetConfig(**base), engine_factory=factory,
                                  injector=injector, **extra, **ns.fleet_kw)
    return fleet, injector


def outcome(req):
    try:
        r = req.result(WAIT)
    except TimeoutError:
        raise
    except Exception as e:  # noqa: BLE001 — the typed error is the outcome
        return ("error", type(e).__name__, getattr(e, "code", None))
    return ("completed", r.replica, r.degraded, r.requeues, r.tier, r.from_cache, r.bucket,
            round(float(r.stress), 6), round(float(r.mean_confidence), 4))


def submit(fleet, seq, **kw):
    """Submit, with a synchronous rejection as the outcome."""
    try:
        return fleet.submit(seq, **kw)
    except Exception as e:  # noqa: BLE001
        done = types.SimpleNamespace(result=lambda timeout=None, e=e: (_ for _ in ()).throw(e))
        return done


COUNTED = ("fleet_", "retry_budget_", "cascade_", "frontdoor_", "artifact_store_",
           "journal_")


def counters(fleet):
    snap = fleet.stats()["telemetry"]["metrics"]["counters"]
    return {k: v for k, v in snap.items() if k.startswith(COUNTED)
            and not k.startswith("hedge_wasted")}


def wait_until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.01)


def one_by_one(fleet, seqs):
    return [outcome(submit(fleet, s)) for s in seqs]


SEQS = [seq_of(4 + i % 5, offset=i) for i in range(6)]


# --- the scenarios: each returns what both packages must agree on -------------------


def scenario_kill(ns):
    fleet, inj = fleet_of(ns, dict(kind="kill_replica", replica="r0", at=0))
    try:
        out = one_by_one(fleet, SEQS)
        return out, counters(fleet), inj.delivered, fleet.health()["replicas"]
    finally:
        fleet.shutdown(timeout=WAIT)


def scenario_flap(ns):
    fleet, inj = fleet_of(ns, dict(kind="flap_replica", replica="r0", at=0, count=3),
                          reprobe_interval_s=0.02, tick_interval_s=0.01)
    try:
        out = one_by_one(fleet, SEQS[:1])
        wait_until(lambda: fleet.health()["replicas"]["r0"] == "healthy"
                   and fleet.stats()["health"]["targets"]["r0"]["reinstatements"] >= 1,
                   "r0's reinstatement")
        out += one_by_one(fleet, SEQS[1:])
        return out, counters(fleet), inj.exhausted(), fleet.health()["replicas"]
    finally:
        fleet.shutdown(timeout=WAIT)


def scenario_slow(ns):
    fleet, inj = fleet_of(ns, dict(kind="slow_replica", replica="r0", at=0, count=2,
                                   delay_s=0.01))
    try:
        return one_by_one(fleet, SEQS), counters(fleet), inj.delivered
    finally:
        fleet.shutdown(timeout=WAIT)


def scenario_outage(ns, degraded):
    fleet, inj = fleet_of(ns, dict(kind="kill_replica", replica="r0", at=0),
                          dict(kind="kill_replica", replica="r1", at=0),
                          degraded_mds_iters=1 if degraded else 0)
    try:
        out = one_by_one(fleet, SEQS[:3])
        return out, counters(fleet), fleet.health()["status"]
    finally:
        fleet.shutdown(timeout=WAIT)


def scenario_retry_budget(ns):
    """Capacity 1, a full refill a success: r0 fails twice and r1 once, so
    the first request spends the token on its failover and sheds on the
    second failure, the second sheds at once, and the third's success
    refills the bucket."""
    fleet, _ = fleet_of(ns, dict(kind="flap_replica", replica="r0", at=0, count=2),
                        dict(kind="flap_replica", replica="r1", at=0, count=1),
                        fail_threshold=10, requeue_limit=3, retry_budget_capacity=1,
                        retry_budget_refill=1.0)
    try:
        out = one_by_one(fleet, SEQS[:4])
        snap = fleet.stats()["retry_budget"]
        return out, counters(fleet), {k: snap[k] for k in ("tokens", "spent", "denied")}
    finally:
        fleet.shutdown(timeout=WAIT)


def scenario_hedge(ns):
    """Two fast requests arm the hedger's p95; the third is held on r0, gets
    a hedge on r1 that settles first, and r0's late completion is the
    loser (its seconds in hedge_wasted_chip_seconds_total)."""
    gate = Gate()
    fleet, _ = fleet_of(ns, gate=gate, hedge_p95_factor=1.0, hedge_min_samples=2,
                        hedge_min_delay_s=0.02, hedge_rate_cap=1.0, tick_interval_s=0.01)
    try:
        out = one_by_one(fleet, SEQS[:2])
        gate.hold("r0")
        req = fleet.submit(SEQS[2])
        out.append(outcome(req))
        gate.release()
        wait_until(lambda: fleet.stats()["hedging"]["wasted_chip_seconds"] > 0,
                   "the hedge loser's completion")
        hedging = fleet.stats()["hedging"]
        return out, counters(fleet), (hedging["issued"], hedging["outstanding"])
    finally:
        gate.release()
        fleet.shutdown(timeout=WAIT)


def scenario_pools(ns):
    pools = (ns.fleet.PoolSpec("short", replicas=1, buckets=(8,)),
             ns.fleet.PoolSpec("long", replicas=1, buckets=(16,)))
    fleet, _ = fleet_of(ns, pools=pools)
    try:
        out = one_by_one(fleet, [seq_of(5), seq_of(12, 1), seq_of(7, 2), seq_of(20, 3)])
        return out, counters(fleet), sorted(fleet.stats()["pools"])
    finally:
        fleet.shutdown(timeout=WAIT)


def scenario_cascade(ns):
    pools = (ns.fleet.PoolSpec("draft", replicas=1, mds_iters=2),
             ns.fleet.PoolSpec("full", replicas=1))
    policy = ns.cascade.CascadePolicy(draft_pool="draft", min_confidence=0.5)
    fleet, _ = fleet_of(ns, pools=pools, cascade_policy=policy)
    try:
        out = one_by_one(fleet, [seq_of(n, n) for n in (4, 5, 6, 7)])
        cascade = fleet.stats()["cascade"]
        return out, counters(fleet), {k: v for k, v in cascade.items() if k != "policy"}
    finally:
        fleet.shutdown(timeout=WAIT)


def scenario_store(ns):
    """A leader held on its replica, two identical followers coalesced onto
    it, then the same sequence again from the store (after the settle path
    has run: the followers resolve there, after the store's put)."""
    gate = Gate()
    store = ns.store.ArtifactStore(ns.store.ArtifactStoreConfig(root=None))
    fleet, _ = fleet_of(ns, gate=gate, replicas=1, artifact_store=store)
    try:
        gate.hold("r0")
        leader = fleet.submit(SEQS[0])
        assert gate.entered.wait(WAIT)
        followers = [fleet.submit(SEQS[0]) for _ in range(2)]
        gate.release()
        out = [outcome(r) for r in [leader, *followers]]
        out += one_by_one(fleet, [SEQS[0], SEQS[1]])
        return out, counters(fleet), sorted(fleet.stats())
    finally:
        gate.release()
        fleet.shutdown(timeout=WAIT)


def scenario_journal(ns, root):
    """Records a previous process accepted and never settled: two live, one
    past its deadline. The fleet replays the live ones through submit and
    settles all three. r0 holds the first replayed request until the
    second has been routed (to r1), so the routing is the same every run."""
    journal = ns.journal.IntakeJournal(str(root / ns.name))
    now = time.time()
    for i, seq in enumerate(SEQS[:2]):
        journal.accept(f"t{i}", seq, priority=1, deadline_unix=now + 300,
                       accepted_at_unix=now)
    journal.accept("t9", SEQS[2], priority=1, deadline_unix=now - 1, accepted_at_unix=now)
    gate = Gate()
    gate.hold("r0")
    fleet, _ = fleet_of(ns, gate=gate, journal=journal)
    try:
        replayed = fleet.replay_journal()
        assert gate.entered.wait(WAIT)
        wait_until(lambda: fleet.stats()["replicas"]["r1"]["dispatches"] >= 1,
                   "the second replayed request's dispatch")
        gate.release()
        out = [outcome(r) for r in replayed["requests"]]
        # a settle removes the record before it counts it: wait for all
        # three (the two replayed, the expired one)
        wait_until(lambda: journal.pending_count() == 0 and counters(fleet).get(
            'journal_records_total{event="settle"}', 0) >= 3, "the journal's settles")
        summary = {k: replayed[k] for k in ("replayed", "expired", "failed")}
        return out, counters(fleet), summary, sorted(fleet.stats())
    finally:
        gate.release()
        fleet.shutdown(timeout=WAIT)


SCENARIOS = {
    "kill_replica": scenario_kill,
    "flap_replica": scenario_flap,
    "slow_replica": scenario_slow,
    "outage_degraded": lambda ns: scenario_outage(ns, True),
    "outage_no_degraded": lambda ns: scenario_outage(ns, False),
    "retry_budget": scenario_retry_budget,
    "hedge": scenario_hedge,
    "pools": scenario_pools,
    "cascade": scenario_cascade,
    "store_coalesce": scenario_store,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_jax_fleet(name):
    got = SCENARIOS[name](PKGS["torch"])
    want = SCENARIOS[name](PKGS["jax"])
    assert got == want
    outcomes = got[0]
    assert outcomes and all(o[0] in ("completed", "error") for o in outcomes)


def test_journal_replay_matches_the_jax_fleet(tmp_path):
    got = scenario_journal(PKGS["torch"], tmp_path)
    want = scenario_journal(PKGS["jax"], tmp_path)
    assert got == want
    assert got[2] == {"replayed": 2, "expired": 1, "failed": 0}


def test_scenario_expectations():
    """What the scenarios above must show, read off the port's run."""
    t = PKGS["torch"]
    out, ctr, _, states = scenario_kill(t)
    assert out[0][:4] == ("completed", "r1", False, 1) and states["r0"] == "down"
    assert all(o[:2] == ("completed", "r1") for o in out[1:])
    out, _, _ = scenario_outage(t, True)
    assert [o[2] for o in out] == [True] * 3
    out, _, _ = scenario_outage(t, False)
    assert {o[2] for o in out} == {"no_healthy_replica"}
    out, _, budget = scenario_retry_budget(t)
    assert [o[0] if o[0] == "completed" else o[2] for o in out] == [
        "retry_budget_exhausted", "retry_budget_exhausted", "completed", "completed"]
    assert budget["tokens"] == 1.0
    out, ctr, hedging = scenario_hedge(t)
    assert out[2][1] == "r1" and hedging == (1, 0)
    assert ctr['fleet_hedge_total{pool="default"}'] == 1
    out, _, _ = scenario_pools(t)
    assert [o[1] if o[0] == "completed" else o[2] for o in out] == [
        "r0", "r1", "r0", "sequence_too_long"]
    out, _, cascade = scenario_cascade(t)
    assert [o[4] for o in out] == ["draft", "escalated", "draft", "escalated"]
    out, _, _ = scenario_store(t)
    assert [o[5] for o in out] == [False, True, True, True, False]
    assert out[3][1] == ""  # served by the store, no replica


# --- (b) a real tiny engine pair ---------------------------------------------------


def test_real_engines_requeue_bit_for_bit_and_match_jax():
    """One bucket, dim 16, depth 1, the same weights: r0 killed, so the
    request requeues to r1. The port's requeued result is bit for bit the
    port's bare engine's; the two packages' fleets agree within the
    pipeline tolerances (pairwise distances 1e-3 A, confidence 5e-6,
    stress 1e-4 relative)."""
    jcfg = JaxConfig(**TINY)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tcfg = Alphafold2Config(**TINY)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    scfg = dict(buckets=(16,), max_batch=1, max_wait_s=0.0, mds_iters=20,
                request_timeout_s=300.0, cache_capacity=0)
    seq = seq_of(11)
    bare = tengine.ServingEngine(tparams, tcfg, tengine.ServingConfig(**scfg), device="cpu")
    try:
        want = bare.predict(seq, timeout=WAIT)
    finally:
        bare.shutdown()
    fcfg = dict(replicas=2, probe_interval_s=0, reprobe_interval_s=30.0, fail_threshold=1,
                default_timeout_s=300.0)
    results = {}
    for ns, params, kw in ((PKGS["torch"], tparams, {"device": "cpu"}),
                           (PKGS["jax"], jparams, {})):
        inj = ns.faults.FaultPlan(faults=(ns.faults.Fault("kill_replica", replica="r0"),)
                                  ).injector()
        fleet = ns.fleet.ServingFleet(params, ns.cfg, ns.engine.ServingConfig(**scfg),
                                      ns.fleet.FleetConfig(**fcfg), injector=inj, **kw)
        try:
            results[ns.name] = fleet.predict(seq, timeout=WAIT * 4)
        finally:
            fleet.shutdown(timeout=WAIT)
    got, ref = results["torch"], results["jax"]
    assert (got.replica, got.requeues) == (ref.replica, ref.requeues) == ("r1", 1)
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.confidence, want.confidence)
    assert got.stress == want.stress

    def pairwise(c):
        c = np.asarray(c, np.float64)
        return np.linalg.norm(c[:, None] - c[None], axis=-1)

    np.testing.assert_allclose(got.confidence, ref.confidence, rtol=0, atol=5e-6)
    np.testing.assert_allclose(got.stress, ref.stress, rtol=1e-4)
    np.testing.assert_allclose(pairwise(got.coords), pairwise(ref.coords), rtol=0, atol=1e-3)


# --- (c) the fault kinds against JAX's injector -----------------------------------


def drive_hooks(ns, monkeypatch):
    """One call sequence through every serving hook: (site, index) ->
    "ok" or the raised exception's class name; crash_process's exit is
    intercepted."""
    exits = []
    monkeypatch.setattr(os, "_exit", lambda code: exits.append(code))
    F = ns.faults.Fault
    plan = ns.faults.FaultPlan(faults=(
        F("request_error", at=1), F("slow_request", at=0, delay_s=0.0),
        F("hung_request", at=2, hang_s=0.0), F("kill_replica", replica="r0", at=2),
        F("slow_replica", replica="r1", at=0, count=2, delay_s=0.0),
        F("flap_replica", replica="r1", at=1, count=2),
        F("straggle_dispatch", replica="r2", at=1, delay_s=0.0),
        F("slow_featurize", at=1, delay_s=0.0), F("kill_featurize_worker", at=2),
        F("crash_process", at=7)))
    inj = plan.injector()
    hooks = [("serving", inj.serving_hook())] + [
        (name, inj.replica_hook(name)) for name in ("r0", "r1", "r2")]
    feat = inj.featurize_hook()
    log = []
    for i in range(4):
        for site, hook in hooks:
            try:
                hook(i, 16)
                log.append((site, i, "ok"))
            except Exception as e:  # noqa: BLE001 — the delivery is the result
                log.append((site, i, type(e).__name__))
        try:
            feat(i)
            log.append(("featurize", i, "ok"))
        except Exception as e:  # noqa: BLE001
            log.append(("featurize", i, type(e).__name__))
    return log, inj.delivered, inj.exhausted(), exits


def test_fault_hooks_deliver_as_the_jax_injector_does(monkeypatch):
    got = drive_hooks(PKGS["torch"], monkeypatch)
    want = drive_hooks(PKGS["jax"], monkeypatch)
    assert got == want
    assert ("r0", 3, "InjectedFault") in got[0] and ("featurize", 2, "WorkerKilled") in got[0]
    assert got[3] == [137]  # crash_process at the process-wide dispatch index 7
    assert got[2]


def test_serving_plans_refuse_the_autoscaler_and_training_kinds():
    """A serving plan with a training kind, refused until the refusal was
    dropped, is taken as JAX's serve takes it: the training kind has no
    serving hook and never fires. `scale_flap`, refused while the
    autoscaler was not ported, is a serving kind, and the autoscaler's
    hook delivers it as JAX's does: alternating forced demands at the
    scheduled tick indices."""
    got, want = [], []
    for faults, out in ((tfaults, got), (jfaults, want)):
        F = faults.Fault
        inj = faults.FaultPlan(faults=(F("scale_flap", at=2, count=3), F("nan_grads", at=0),
                                       F("kill_replica", replica="r0", at=1))).injector()
        hook, replica, serving = inj.autoscale_hook(), inj.replica_hook("r0"), \
            inj.serving_hook()
        out.extend([hook(i) for i in range(7)])
        for i in range(3):
            serving(i, 8)
            try:
                replica(i, 8)
                out.append(None)
            except faults.InjectedFault as e:
                out.append(str(e)[:40])
        out.extend([inj.exhausted(), list(inj.delivered)])
    assert got == want and got[:7] == [None, None, "up", "down", "up", None, None]
    assert got[-2] is False and not any("nan_grads" in d for d in got[-1])


@pytest.mark.parametrize("path", ["docs/examples/fleet_chaos_plan.json",
                                  "docs/examples/disagg_chaos_plan.json"])
def test_plan_checker_prints_the_jax_checker_lines(path, capsys):
    assert tfaults._check_main(["--check", path]) == 0
    got = capsys.readouterr().out
    assert jfaults._check_main(["--check", path]) == 0
    assert got == capsys.readouterr().out
    assert ("latched" in got) if "fleet" in path else ("scale_flap" in got)


# --- the engine's seams, the store tag, the refusals ------------------------------


def test_engine_seams_pool_label_fault_hook_and_features():
    calls = []
    cfg = scfg_of(PKGS["torch"], buckets=(8,), max_batch=1)
    eng = PKGS["torch"].Fake({}, PKGS["torch"].cfg, cfg, device="cpu", pool_name="short",
                             fault_hook=lambda i, b: calls.append((i, b)))
    try:
        assert eng.cell_for(8)["pool"] == "short"
        bundle = tengine.featurize_request(seq_of(5), None, None, ladder=eng._ladder,
                                           msa_rows=0)
        req = eng.submit("ignored", features=bundle)
        done = []
        req.add_done_callback(done.append)
        assert req.result(WAIT).seq == seq_of(5) and done == [req]
        assert req.peek()[1] is None and calls == [(0, 8)]
    finally:
        eng.shutdown()


def test_store_tag_names_the_device_routes():
    fleet, _ = fleet_of(PKGS["torch"], replicas=1,
                        artifact_store=tstore.ArtifactStore(tstore.ArtifactStoreConfig()))
    try:
        assert "dispatch[cpu](plain)" in fleet._store_tag("default")
    finally:
        fleet.shutdown(timeout=WAIT)
    from alphafold2_tpu_torch.ops.dispatch import resolution_tag

    assert resolution_tag("cuda") == "dispatch[cuda](flash=wgmma,quant=wgmma,sparse=wgmma)"


def test_sp_pools_and_model_overrides_are_refused():
    """Pipelined dispatch, the SP pool and the forward override, each refused
    until it was ported, are taken: a fleet's base config at
    pipeline_depth=1 builds pipelined replicas of JAX's outcomes (every
    pool inherits the knob, as JAX's do), a PoolSpec with sp_shards
    validates as JAX's does, and an engine keeps the override it was
    given."""
    got = {}
    for name in ("jax", "torch"):
        ns = PKGS[name]
        fleet, _ = fleet_of(ns, replicas=1, scfg=scfg_of(ns, pipeline_depth=1),
                            pools=(ns.fleet.PoolSpec("a", buckets=(8,)),
                                   ns.fleet.PoolSpec("b", buckets=(16,))))
        try:
            got[name] = ([outcome(fleet.submit(seq_of(n))) for n in (5, 12)],
                         sorted(rep["engine"]["pipeline"]["depth"]
                                for rep in fleet.stats()["replicas"].values()))
        finally:
            fleet.shutdown(timeout=WAIT)
    assert got["torch"] == got["jax"] and got["torch"][1] == [1, 1]
    spec = dict(sp_shards=4, buckets=(8, 16), sp_schedules=[[16, "sp_seq"]])
    assert (dataclasses.asdict(tfleet.PoolSpec("long", **spec))
            == dataclasses.asdict(jfleet.PoolSpec("long", **spec)))
    with pytest.raises(ValueError, match="sp_schedules without sp_shards"):
        tfleet.PoolSpec("long", sp_schedules=((16, "sp_seq"),))
    fn = lambda *a, **k: None  # noqa: E731
    eng = tengine.ServingEngine({}, PKGS["torch"].cfg, scfg_of(PKGS["torch"]), device="cpu",
                                model_apply_fn=fn)
    try:
        assert eng._model_apply_fn is fn and eng.chips == 1
    finally:
        eng.shutdown()


# --- (d) the CLI and the ops server ---------------------------------------------


def test_cli_fleet_chaos_recipe(tmp_path, capsys):
    """The verify skill's fleet recipe through the port: exit 0, nothing
    lost, requeues, sheds and degraded answers, the registry counting the
    same numbers, and the JAX fleet's stats keys."""
    from alphafold2_tpu_torch import serve

    out = tmp_path / "f.json"
    rc = serve.main(["--device", "cpu", "--demo", "24", "--replicas", "3", "--buckets",
                     "16,32", "--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8",
                     "--mds-iters", "4", "--max-batch", "2", "--queue-size", "4",
                     "--fleet-queue", "4", "--degrade-depth", "3", "--reprobe-interval", "0.3",
                     "--fault-plan", "docs/examples/fleet_chaos_plan.json", "--stats-json",
                     str(out)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "fleet served" in printed and "(DEGRADED)" in printed
    stats = json.loads(out.read_text())
    reqs = stats["requests"]
    assert reqs["failed"] == 0 and reqs["in_flight"] == 0
    assert reqs["requeued"] >= 1 and reqs["shed"] >= 1 and reqs["degraded"] >= 1
    c = stats["telemetry"]["metrics"]["counters"]
    assert c["fleet_requeue_total"] == reqs["requeued"]
    assert c["fleet_degraded_total"] == reqs["degraded"]
    assert sum(v for k, v in c.items() if k.startswith("fleet_shed_total")) == reqs["shed"]
    jfleet_, _ = fleet_of(PKGS["jax"], replicas=3, degraded_mds_iters=1)
    try:
        want = jfleet_.stats()
    finally:
        jfleet_.shutdown(timeout=WAIT)
    assert set(stats) == set(want) and set(reqs) == set(want["requests"])


CLI_TINY = ["--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8", "--buckets",
            "8,16", "--mds-iters", "2", "--max-batch", "2"]


@pytest.mark.parametrize("argv, match", [
    (["--pipeline-depth", "2"], "pipelined dispatch, depth 2"),
    (["--sp-shards", "2"], "SP plan over 2 shards"),
    (["--max-replicas", "4"], "autoscaler: replicas in [1, 4]"),
    (["--min-replicas", "1", "--max-replicas", "4"], "autoscaler: replicas in [1, 4]"),
    (["--max-replicas", "4", "--scale-policy", "p.json"], "cooldowns 0.5/7.5s"),
    (["--max-replicas", "4", "--scale-grace", "5"], "scale-down(s)"),
    (["--pools", '[{"name": "long", "sp_shards": 4}]'], "pools ['long']"),
], ids=["pipeline_depth", "sp_shards", "max_replicas", "min_replicas", "scale_policy",
        "scale_grace", "sp_pool"])
def test_cli_refused_flags_name_their_roadmap_item(argv, match, tmp_path, capsys):
    """Pipelined dispatch's, the SP arm's and the autoscaler's flags, each
    refused naming its ROADMAP item until it was ported, run: each prints
    what it armed (`--pipeline-depth 2` the engine's window; `--sp-shards
    2` two CPU shards; a pool of 4) and the replay exits 0."""
    from alphafold2_tpu_torch import serve

    argv = [str(tmp_path / a) if a == "p.json" else a for a in argv]
    (tmp_path / "p.json").write_text(json.dumps({"up_cooldown_s": 0.5,
                                                 "down_cooldown_s": 7.5}))
    assert serve.main(["--demo", "2", "--device", "cpu", *CLI_TINY, *argv]) == 0
    assert match in capsys.readouterr().out


def test_cli_refuses_a_scale_flap_plan(tmp_path, capsys):
    """Refused while the autoscaler was not ported; now the plan reaches
    the autoscaler's hook, which delivers its forced demands."""
    from alphafold2_tpu_torch import serve

    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [{"kind": "scale_flap", "at": 0}]}))
    assert serve.main(["--demo", "2", "--device", "cpu", *CLI_TINY, "--replicas", "2",
                       "--max-replicas", "3", "--ops-tick", "0.05", "--scale-grace", "1",
                       "--fault-plan", str(plan)]) == 0
    out = capsys.readouterr().out
    assert "scale_flap@0" in out and "autoscaler:" in out


def test_ops_server_for_fleet_serves_the_fleet_registry():
    import urllib.request

    from alphafold2_tpu_torch.telemetry import ops_server_for_fleet, parse_prometheus_text

    fleet, _ = fleet_of(PKGS["torch"], retry_budget_capacity=4)
    ops = ops_server_for_fleet(fleet, tick_interval_s=0.05)
    ops.add_tick(fleet.sample_gauges)
    ops.start()
    try:
        one_by_one(fleet, SEQS[:3])
        with urllib.request.urlopen(ops.url + "/metrics", timeout=WAIT) as r:
            text = r.read().decode()
        with urllib.request.urlopen(ops.url + "/statusz", timeout=WAIT) as r:
            status = json.loads(r.read())
        with urllib.request.urlopen(ops.url + "/healthz", timeout=WAIT) as r:
            health = json.loads(r.read())
        parsed = parse_prometheus_text(text)
        assert parsed[("fleet_requests_total", (("outcome", "completed"),))] == 3
        again = parse_prometheus_text(fleet.registry.to_prometheus())
        assert {k: v for k, v in parsed.items() if k[0] == "fleet_requests_total"} == \
            {k: v for k, v in again.items() if k[0] == "fleet_requests_total"}
        assert status["stats"]["requests"]["completed"] == 3
        assert "retry_budget" in status["backpressure"] and health["status"] == "ok"
    finally:
        ops.stop()
        fleet.shutdown(timeout=WAIT)


def test_fleet_dataclasses_are_jaxs():
    names = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(tfleet.FleetConfig) == names(jfleet.FleetConfig)
    assert names(tfleet.PoolSpec) == names(jfleet.PoolSpec)


def test_the_card_has_one_graph_pool_that_starts_afresh_past_its_last_graph(monkeypatch):
    """`GraphPool(device)` is the card's one instance (its lock is every
    engine's `graph_lock`); graphs capture into one pool handle while any
    of them lives, and past the last one the next capture gets a new
    handle (the allocator must never see a released pool again)."""
    import gc

    from alphafold2_tpu_torch.serving import executable

    handles = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, next(handles)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 7)
    monkeypatch.setattr(executable.GraphPool, "_cards", {})

    class Graph:  # stands in for torch.cuda.CUDAGraph
        pass

    card = executable.GraphPool("cuda")
    assert executable.GraphPool("cuda:7") is card and executable.device_lock("cuda") is card.lock
    assert executable.device_lock("cpu") is None
    a, b = Graph(), Graph()
    assert card.pool_for(a) == card.pool_for(b) == (0, 0)
    del a
    gc.collect()
    assert card.pool_for(Graph()) == (0, 0)  # b still lives (the temporary is collected)
    del b
    gc.collect()
    c = Graph()
    assert card.pool_for(c) == (0, 1)
