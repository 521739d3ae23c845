"""The serving plane's host modules in the port (reliability/retry_budget.py,
reliability/health.py, serving/admission.py, frontdoor.py, featurize.py,
journal.py, artifact_store.py, cascade.py) against their JAX counterparts
on the CPU.

Each pair is driven by the same scripted sequence of operations, on fake
clocks where the module reads one, and every observable (return values,
raised error types and messages, snapshots, the metric registries'
snapshots) is held equal step by step. The on-disk formats are read both
ways: a journal record and an artifact-store entry (a result and a
feature bundle) written by the port are read by the JAX module, and the
reverse; a corrupted record or entry raises the matching `*CorruptError`
in both packages and degrades the same way.
"""

import dataclasses
import glob
import os
import threading

import numpy as np
import pytest

from alphafold2_tpu.reliability import faults as j_faults
from alphafold2_tpu.reliability import health as j_health
from alphafold2_tpu.reliability import retry_budget as j_retry
from alphafold2_tpu.serving import admission as j_admission
from alphafold2_tpu.serving import artifact_store as j_store
from alphafold2_tpu.serving import cascade as j_cascade
from alphafold2_tpu.serving import engine as j_engine
from alphafold2_tpu.serving import featurize as j_featurize
from alphafold2_tpu.serving import frontdoor as j_frontdoor
from alphafold2_tpu.serving import journal as j_journal
from alphafold2_tpu.serving.bucketing import BucketLadder as JLadder
from alphafold2_tpu.telemetry import MetricRegistry as JRegistry
from alphafold2_tpu_torch.reliability import faults as t_faults
from alphafold2_tpu_torch.reliability import health as t_health
from alphafold2_tpu_torch.reliability import retry_budget as t_retry
from alphafold2_tpu_torch.serving import admission as t_admission
from alphafold2_tpu_torch.serving import artifact_store as t_store
from alphafold2_tpu_torch.serving import cascade as t_cascade
from alphafold2_tpu_torch.serving import engine as t_engine
from alphafold2_tpu_torch.serving import featurize as t_featurize
from alphafold2_tpu_torch.serving import frontdoor as t_frontdoor
from alphafold2_tpu_torch.serving import journal as t_journal
from alphafold2_tpu_torch.serving.bucketing import BucketLadder as TLadder
from alphafold2_tpu_torch.telemetry import MetricRegistry as TRegistry

class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def outcome(fn):
    """What a call gave: ("ok", value) or ("raise", error class name,
    message, retry_after_s when the error carries one)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the comparison
        return ("raise", type(e).__name__, str(e), getattr(e, "retry_after_s", None))


def metrics(registry):
    return registry.snapshot()


# ------------------------------------------------------------- retry budget


def retry_script(mod, registry_cls):
    clock = FakeClock()
    reg = registry_cls()
    budget = mod.RetryBudget(3, refill_ratio=0.5, min_retry_after_s=0.1,
                             max_retry_after_s=5.0, clock=clock).bind_registry(reg)
    trace = []
    for step, op in enumerate(["spend", "spend", "spend", "spend", "success", "spend",
                               "success", "success", "spend", "spend", "success", "success",
                               "success", "success", "success", "spend"]):
        clock.advance(0.25 * (1 + step % 3))
        if op == "spend":
            trace.append(("spend", budget.try_spend(("featurize", "failover", "hedge")[step % 3])))
        else:
            budget.on_success()
        trace.append((budget.tokens(), budget.retry_after_s(), budget.snapshot()))
    return trace, metrics(reg)


def test_retry_budget_spends_and_refills_as_jax():
    assert retry_script(t_retry, TRegistry) == retry_script(j_retry, JRegistry)


@pytest.mark.parametrize("kw", [dict(capacity=0), dict(capacity=2, refill_ratio=0.0),
                                dict(capacity=2, refill_ratio=1.5)],
                         ids=["capacity", "ratio_zero", "ratio_high"])
def test_retry_budget_refusals_as_jax(kw):
    assert (outcome(lambda: t_retry.RetryBudget(**kw))
            == outcome(lambda: j_retry.RetryBudget(**kw)))


# ------------------------------------------------------------------- health


def health_script(mod):
    clock = FakeClock()
    log = []
    probes = {"a": [True, False, False, False, True, True], "b": [False] * 20,
              "c": [True] * 20}
    mon = mod.HealthMonitor(probe_interval_s=1.0, reprobe_interval_s=0.5, fail_threshold=2,
                            clock=clock)
    for name in probes:
        mon.register(name, probe=lambda n=name: probes[n].pop(0) if probes[n] else True,
                     on_drain=lambda n, why: log.append(("drain", n, why)),
                     on_reinstate=lambda n: log.append(("reinstate", n)))
    trace = [outcome(lambda: mon.register("a"))]
    script = [("tick",), ("fail", "c", "hung"), ("ok", "c"), ("fail", "c", "x"),
              ("fail", "c", "y"), ("tick",), ("tick",), ("force", "b", "operator"),
              ("tick",), ("tick",), ("tick",), ("retire", "c"), ("tick",), ("tick",),
              ("unregister", "c"), ("tick",), ("tick",), ("tick",)]
    for op in script:
        clock.advance(0.6)
        if op[0] == "tick":
            mon.tick()
        elif op[0] == "fail":
            trace.append(mon.record_failure(op[1], op[2]))
        elif op[0] == "ok":
            mon.record_success(op[1])
        elif op[0] == "force":
            mon.force_down(op[1], op[2])
        elif op[0] == "retire":
            mon.retire(op[1])
        else:
            mon.unregister(op[1])
        trace.append((mon.snapshot(), sorted(mon.healthy_targets()),
                      {n: mon.state(n).value for n in mon.snapshot()["targets"]}))
    return trace, log


def test_health_state_transitions_as_jax():
    assert health_script(t_health) == health_script(j_health)


# ---------------------------------------------------------------- admission


@dataclasses.dataclass(eq=False)
class Entry:
    name: str
    priority: object
    deadline: object = None
    enqueued_at: float = 0.0


def admission_script(mod):
    clock = FakeClock()
    ctl = mod.AdmissionController(mod.AdmissionConfig(capacity=3), clock=clock)
    trace = []

    def offer(name, prio, ttl=None):
        e = Entry(name, prio, None if ttl is None else clock() + ttl, clock())
        got = outcome(lambda: ctl.offer(e))
        if got[0] == "ok":
            got = ("ok", None if got[1] is None else got[1].name)
        trace.append(("offer", name, got))

    def poll():
        entry, expired = ctl.poll(timeout=0)
        trace.append(("poll", None if entry is None else entry.name,
                      [e.name for e in expired]))

    offer("b1", "batch")
    offer("n1", "normal", ttl=1.0)
    offer("b2", "batch")
    offer("i1", "interactive")      # evicts b2, the newest of the lowest class
    offer("b3", "batch")            # full of equal-or-better work: shed
    ctl.note_served(0.4)
    offer("n2", 1)                  # evicts b1
    trace.append(("snapshot", ctl.snapshot(), ctl.depth(), [e.name for e in ctl.entries()]))
    ctl.requeue(Entry("r1", "normal"))  # ahead of its class, over capacity
    trace.append(("depth", ctl.depth(), [e.name for e in ctl.entries()]))
    clock.advance(2.0)              # n1's deadline passes
    ctl.note_served(1.2)
    for _ in range(5):
        poll()
    trace.append(outcome(lambda: mod.resolve_priority("urgent")))
    trace.append(outcome(lambda: mod.AdmissionConfig(capacity=0)))
    offer("x", "normal")
    trace.append(("drain", [e.name for e in ctl.drain()], ctl.snapshot()))
    return trace


def test_admission_order_eviction_and_requeue_as_jax():
    assert admission_script(t_admission) == admission_script(j_admission)


# ---------------------------------------------------------------- front door


def frontdoor_script(mod, registry_cls):
    reg = registry_cls()
    door = mod.FrontDoor(reg)
    trace = []
    for key, entry in [("k1", "a"), ("k1", "b"), ("k2", "c"), ("k1", "d"), ("k2", "e"),
                       ("k3", "f")]:
        trace.append((door.register(key, entry), door.depth(), door.snapshot()))
    trace.append((door.settle("k1"), door.settle("k1"), door.settle("nope"), door.snapshot()))
    trace.append((door.register("k1", "g"), door.register("k1", "h")))
    trace.append((sorted(door.drain()), door.depth(), door.snapshot()))
    return trace, metrics(reg)


def test_frontdoor_coalescing_as_jax():
    assert frontdoor_script(t_frontdoor, TRegistry) == frontdoor_script(j_frontdoor, JRegistry)


# ---------------------------------------------------------------- featurize


FEATURIZE_CASES = {
    "plain": dict(seq="  mktayiakqr "),
    "msa": dict(seq="MKTAYI", msa=[[1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 0, 20]], rows=2),
    "msa_mask": dict(seq="MKTAYI", msa=[[1, 2, 3, 4, 5, 6]],
                     msa_mask=[[1, 1, 0, 1, 1, 0]], rows=4),
    "invalid": dict(seq="MKTAYZX1"),
    "too_long": dict(seq="A" * 40),
    "mask_without_msa": dict(seq="MKTA", msa_mask=[[1, 1, 1, 1]], rows=2),
    "sequence_only": dict(seq="MKTA", msa=[[1, 2, 3, 4]]),
    "msa_width": dict(seq="MKTA", msa=[[1, 2, 3]], rows=2),
    "msa_rows": dict(seq="MKTA", msa=[[1, 2, 3, 4]] * 3, rows=2),
    "mask_shape": dict(seq="MKTA", msa=[[1, 2, 3, 4]], msa_mask=[[1, 1, 1]], rows=2),
}


def bundle_fields(b):
    return {f.name: (getattr(b, f.name).tolist() if isinstance(getattr(b, f.name), np.ndarray)
                     else getattr(b, f.name)) for f in dataclasses.fields(b)}


def featurize_outcome(mod, ladder_cls, case):
    kw = dict(FEATURIZE_CASES[case])
    seq, rows = kw.pop("seq"), kw.pop("rows", 0)
    got = outcome(lambda: mod.featurize_request(seq, kw.get("msa"), kw.get("msa_mask"),
                                                ladder=ladder_cls((8, 16, 32)), msa_rows=rows))
    if got[0] == "ok":
        b = got[1]
        return ("ok", bundle_fields(b), b.length,
                {k: str(v.dtype) for k, v in (("tokens", b.tokens), ("msa", b.msa),
                                              ("msa_mask", b.msa_mask)) if v is not None})
    return got


@pytest.mark.parametrize("case", list(FEATURIZE_CASES))
def test_featurize_request_bundles_and_errors_as_jax(case):
    assert (featurize_outcome(t_featurize, TLadder, case)
            == featurize_outcome(j_featurize, JLadder, case))


def test_the_engine_featurizes_through_the_module():
    assert t_engine.featurize_request is t_featurize.featurize_request


def pool_run(mod, faults_mod, ladder_cls, registry_cls):
    """Five jobs through a one-worker pool whose first job kills its
    worker: the job is requeued and every job resolves once with the
    bundle `featurize_request` gives; one invalid sequence fails with its
    typed error."""
    done = {}
    finished = threading.Event()

    def on_done(i):
        def cb(bundle, exc):
            done[i] = (bundle_fields(bundle) if bundle is not None
                       else (type(exc).__name__, str(exc)))
            if len(done) == 5:
                finished.set()
        return cb

    def hook(idx):
        if idx == 0:
            raise faults_mod.WorkerKilled("injected worker death")

    reg = registry_cls()
    pool = mod.FeaturizePool(mod.FeaturizeConfig(workers=1, retry_limit=1),
                             ladder_cls((8, 16)), msa_rows=2, registry=reg, fault_hook=hook)
    try:
        for i, seq in enumerate(["MKTAYI", "ACDEFGHIKL", "MKB", "WWWW", "MKTAYIAKQR"]):
            pool.submit(seq, on_done=on_done(i), trace_id=f"t{i}")
        assert finished.wait(30)
        stats = pool.stats()
    finally:
        pool.shutdown()
    keep = ("workers", "configured_workers", "queue_depth", "queue_capacity", "in_flight",
            "requests", "worker_deaths")
    return done, {k: stats[k] for k in keep}


def test_featurize_pool_requeues_a_killed_workers_job_as_jax():
    got = pool_run(t_featurize, t_faults, TLadder, TRegistry)
    want = pool_run(j_featurize, j_faults, JLadder, JRegistry)
    assert got == want
    assert got[1]["worker_deaths"] == 1 and got[0][2][0] == "InvalidSequenceError"


def test_worker_killed_is_an_injected_fault():
    assert issubclass(t_faults.WorkerKilled, t_faults.InjectedFault)


# ------------------------------------------------------------------ cascade


def result_of(mod, conf, stress, L=6):
    return mod.PredictionResult(seq="A" * L, coords=np.zeros((L, 3), np.float32),
                                confidence=np.asarray(conf, np.float32), stress=stress,
                                bucket=8, from_cache=False, latency_s=0.1)


CASCADE_POLICIES = [dict(), dict(draft_pool=""), dict(draft_pool="degraded"),
                    dict(min_confidence=1.5), dict(max_stress=-1.0),
                    dict(max_draft_length=-2), dict(min_confidence=0.0),
                    dict(min_confidence=0.4, max_stress=0.3, max_draft_length=200)]


@pytest.mark.parametrize("i", range(len(CASCADE_POLICIES)))
def test_cascade_policy_validation_as_jax(i):
    kw = CASCADE_POLICIES[i]
    assert (outcome(lambda: dataclasses.asdict(t_cascade.CascadePolicy(**kw)))
            == outcome(lambda: dataclasses.asdict(j_cascade.CascadePolicy(**kw))))


def test_cascade_policy_from_dict_and_file_as_jax(tmp_path):
    path = tmp_path / "policy.json"
    path.write_text('{"draft_pool": "fast", "min_confidence": 0.3}')
    for d in ({"min_confidence": 0.3, "max_stres": 1.0}, {"draft_pool": "fast"}):
        assert (outcome(lambda: dataclasses.asdict(t_cascade.CascadePolicy.from_dict(d)))
                == outcome(lambda: dataclasses.asdict(j_cascade.CascadePolicy.from_dict(d))))
    assert (dataclasses.asdict(t_cascade.CascadePolicy.from_file(str(path)))
            == dataclasses.asdict(j_cascade.CascadePolicy.from_file(str(path))))


def cascade_script(mod, engine_mod, registry_cls):
    scorer = mod.EntropyStressScorer(mod.CascadePolicy(min_confidence=0.5, max_stress=0.2))
    reg = registry_cls()
    ledger = mod.CascadeLedger(reg)
    verdicts = []
    for conf, stress in [([0.9] * 6, 0.1), ([0.2] * 6, 0.1), ([0.7] * 6, 0.5),
                         ([np.nan] * 6, 0.1), ([], 0.0), ([0.5, 0.6, 0.4, 0.5, 0.5, 0.5], 0.2)]:
        v = scorer.score(result_of(engine_mod, conf, stress, L=len(conf)))
        verdicts.append(dataclasses.asdict(v))
        ledger.note_scored(v)
        ledger.note_served("draft" if v.accept else "escalated",
                           confidence=v.confidence, stress=v.stress,
                           exit_depth=(2 if v.accept else 0))
    ledger.note_bypass("too_long")
    ledger.note_bypass("draft_unavailable")
    ledger.note_served("full", confidence=0.8, stress=0.05, exit_depth=3)
    ledger.note_early_exit(2)
    ledger.publish()
    return verdicts, ledger.escalation_rate(), ledger.snapshot(), metrics(reg)


def test_cascade_scorer_verdicts_and_ledger_as_jax():
    got = cascade_script(t_cascade, t_engine, TRegistry)
    assert got == cascade_script(j_cascade, j_engine, JRegistry)
    assert got[2]["early_exits"] == {2: 3, 3: 1}  # two accepted drafts, two notes


# ------------------------------------------------------------------ journal


def journal_records():
    rng = np.random.default_rng(0)
    return [
        dict(trace_id="0123456789abcdef", seq="MKTAYIAKQR", priority=0,
             deadline_unix=1.7e9 + 30.5, accepted_at_unix=1.7e9),
        dict(trace_id="a/b c:d", seq="ACDE",
             msa=rng.integers(0, 21, (3, 4)).astype(np.int32),
             msa_mask=rng.random((3, 4)) > 0.2, priority=2, deadline_unix=None,
             accepted_at_unix=1.7e9 + 1.0),
    ]


def record_fields(rec):
    return {f.name: (getattr(rec, f.name).tolist()
                     if isinstance(getattr(rec, f.name), np.ndarray) else getattr(rec, f.name))
            for f in dataclasses.fields(rec)}


@pytest.mark.parametrize("writer, reader", [(t_journal, j_journal), (j_journal, t_journal)],
                         ids=["torch_to_jax", "jax_to_torch"])
def test_journal_records_read_both_ways(tmp_path, writer, reader):
    journal = writer.IntakeJournal(str(tmp_path))
    for rec in journal_records():
        rec = dict(rec)
        assert journal.accept(rec.pop("trace_id"), rec.pop("seq"), **rec)
    got = sorted((record_fields(r) for r in reader.IntakeJournal(str(tmp_path)).pending()),
                 key=lambda r: r["trace_id"])
    want = sorted((record_fields(r) for r in journal.pending()), key=lambda r: r["trace_id"])
    assert got == want and len(got) == 2
    assert got[0]["msa"] is None or isinstance(got[0]["msa"], list)
    assert sorted(os.listdir(tmp_path)) == sorted(
        writer._stem(r["trace_id"]) + ".jr" for r in journal_records())


@pytest.mark.parametrize("damage", ["truncate", "flip", "magic"])
def test_a_corrupt_journal_record_raises_and_degrades_as_jax(tmp_path, damage):
    j = t_journal.IntakeJournal(str(tmp_path / "j"))
    rec = dict(journal_records()[1])
    j.accept(rec.pop("trace_id"), rec.pop("seq"), **rec)
    (path,) = glob.glob(str(tmp_path / "j" / "*.jr"))
    data = open(path, "rb").read()
    bad = {"truncate": data[: len(data) // 2],
           "flip": data[:-20] + bytes([data[-20] ^ 0xFF]) + data[-19:],
           "magic": b"XXXXXXX\n" + data[8:]}[damage]
    results = []
    for mod, registry_cls in ((t_journal, TRegistry), (j_journal, JRegistry)):
        with pytest.raises(mod.JournalCorruptError) as e:
            mod._unpack_record(bad)
        root = tmp_path / mod.__name__.split(".")[0]
        os.makedirs(root)
        open(root / os.path.basename(path), "wb").write(bad)
        reg = registry_cls()
        journal = mod.IntakeJournal(str(root), registry=reg)
        stats = dict(journal.stats(), root=None)  # each package's own directory
        results.append((str(e.value), journal.pending(), stats, os.listdir(root),
                        metrics(reg)))
    assert results[0] == results[1]
    assert results[0][3] == []  # quarantined


# ------------------------------------------------------------ artifact store


def features_of(mod, ladder_cls):
    return mod.featurize_request("MKTAYI", [[1, 2, 3, 4, 5, 6], [0, 1, 0, 1, 0, 1]],
                                 [[1, 1, 1, 1, 1, 1], [1, 0, 1, 0, 1, 0]],
                                 ladder=ladder_cls((8, 16)), msa_rows=2)


def full_result(mod):
    rng = np.random.default_rng(1)
    return mod.PredictionResult(seq="MKTAYI", coords=rng.normal(size=(6, 3)).astype(np.float32),
                                confidence=rng.random(6).astype(np.float32), stress=0.125,
                                bucket=8, from_cache=False, latency_s=0.5, replica="r0",
                                trace_id="abc", mean_confidence=0.5, exit_depth=2,
                                tier="draft")


TAG = "af2store:" + repr(("model", 256, 0.125, (128, 256), "dispatch[cuda](...)"))
KEY = "0" * 64


def store_view(found):
    """A lookup's (object, level) as comparable fields."""
    if found is None:
        return None
    obj, level = found
    return level, (bundle_fields(obj) if hasattr(obj, "tokens") else
                   {f.name: (getattr(obj, f.name).tolist()
                             if isinstance(getattr(obj, f.name), np.ndarray)
                             else getattr(obj, f.name))
                    for f in dataclasses.fields(obj)})


@pytest.mark.parametrize("writer, reader", [("torch", "jax"), ("jax", "torch")],
                         ids=["torch_to_jax", "jax_to_torch"])
def test_artifact_store_entries_read_both_ways(tmp_path, writer, reader):
    mods = {"torch": (t_store, t_engine, t_featurize, TLadder),
            "jax": (j_store, j_engine, j_featurize, JLadder)}
    store_w, engine_w, feat_w, ladder_w = mods[writer]
    w = store_w.ArtifactStore(store_w.ArtifactStoreConfig(root=str(tmp_path)))
    w.put_result(TAG, KEY, full_result(engine_w))
    w.put_features(TAG, KEY, features_of(feat_w, ladder_w))
    store_r, engine_r, feat_r, ladder_r = mods[reader]
    r = store_r.ArtifactStore(store_r.ArtifactStoreConfig(root=str(tmp_path)))
    got_result, got_features = r.lookup_result(TAG, KEY), r.lookup_features(TAG, KEY)
    assert got_result[1] == "disk" and isinstance(got_result[0], engine_r.PredictionResult)
    assert isinstance(got_features[0], feat_r.FeatureBundle)
    # what the reader's own store gives back from its own write
    own = store_r.ArtifactStore(store_r.ArtifactStoreConfig(root=str(tmp_path / "own")))
    own.put_result(TAG, KEY, full_result(engine_r))
    own.put_features(TAG, KEY, features_of(feat_r, ladder_r))
    fresh = store_r.ArtifactStore(store_r.ArtifactStoreConfig(root=str(tmp_path / "own")))
    assert store_view(got_result) == store_view(fresh.lookup_result(TAG, KEY))
    assert store_view(got_features) == store_view(fresh.lookup_features(TAG, KEY))
    # the result keeps what the format stores, and no more
    fields = store_view(got_result)[1]
    assert fields["from_cache"] and fields["exit_depth"] == 0 and fields["stress"] == 0.125
    assert sorted(p.relative_to(tmp_path).as_posix()
                  for p in tmp_path.glob("*/*/*.art")) == sorted(
        p.relative_to(tmp_path / "own").as_posix() for p in (tmp_path / "own").glob("*/*/*.art"))


@pytest.mark.parametrize("tag", ["", "af2store:x", TAG, "é" * 40])
def test_tag_digest_as_jax(tag):
    assert t_store.tag_digest(tag) == j_store.tag_digest(tag)


@pytest.mark.parametrize("damage", ["truncate", "flip", "magic", "framing"])
def test_a_corrupt_artifact_raises_and_degrades_as_jax(tmp_path, damage):
    w = t_store.ArtifactStore(t_store.ArtifactStoreConfig(root=str(tmp_path / "w")))
    w.put_result(TAG, KEY, full_result(t_engine))
    (path,) = glob.glob(str(tmp_path / "w" / "*" / "*" / "*.art"))
    data = open(path, "rb").read()
    header = len(t_store._MAGIC) + 64
    bad = {"truncate": data[: len(data) // 2],
           "flip": data[:-30] + bytes([data[-30] ^ 0xFF]) + data[-29:],
           "magic": b"X" + data[1:],
           "framing": data[:header] + b"?" + data[header + 1:]}[damage]
    rel = os.path.relpath(path, tmp_path / "w")
    results = []
    for mod, registry_cls in ((t_store, TRegistry), (j_store, JRegistry)):
        with pytest.raises(mod.ArtifactCorruptError) as e:
            mod._unpack(bad)
        root = tmp_path / mod.__name__.split(".")[0]
        os.makedirs(os.path.dirname(root / rel))
        open(root / rel, "wb").write(bad)
        reg = registry_cls()
        store = mod.ArtifactStore(mod.ArtifactStoreConfig(root=str(root)), registry=reg)
        snap = store.snapshot()
        snap["disk"]["root"] = None  # each package's own directory
        results.append((str(e.value), store.lookup_result(TAG, KEY),
                        os.path.exists(root / rel), snap, metrics(reg)))
    assert results[0] == results[1]
    assert results[0][1] is None and not results[0][2]  # a miss; the entry deleted
