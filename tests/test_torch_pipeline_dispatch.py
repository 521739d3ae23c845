"""Pipelined dispatch in the port's engine (alphafold2_tpu_torch/serving/
engine.py `pipeline_depth`) against the JAX engine's, on the CPU.

  (a) scripted streams through a fake engine of each package: each
      package's own `ServingEngine` with `_call_executable` and `_realize`
      overridden by the same hooks (tests/test_pipeline_dispatch.py's
      scenarios: overlap and billing, a wedged batch in flight, a draining
      shutdown, a settle-side poison batch, the drain EMA at depths 0, 1
      and 2). Both must end every request the same way and count the same
      counters, `stats()["pipeline"]` and execute spans; their overlap
      ratios lie within the scripted timing's tolerance of each other; and
      each one's goodput causes sum to its wall within 1e-9 s, read at one
      frozen instant. The port's own case: a wedged dispatch half (on the
      card the enqueue waits for its graph one) fires the watchdog and the
      next batch is served;
  (b) the real tiny model (buckets 8 and 16, the batch ladder, the
      classical and the random init, early exit at depth 3): every result
      of the pipelined engine at depths 1 and 2 is bit for bit the depth-0
      engine's, whose batches are the same (submitted at once, full
      batches leave as they fill, the rest at the draining shutdown); the
      depth-0 engine against JAX's on converted params at
      tests/test_torch_serving.py's tolerances;
  (c) `serve --pipeline-depth`, and a 2-replica `ServingFleet` at depth 2
      on tests/test_chaos.py's mid-pipeline kill against JAX's fleet.

Every wait is bounded."""

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
from alphafold2_tpu.serving import engine as jengine
from alphafold2_tpu.serving import fleet as jfleet
from alphafold2_tpu.serving import journal as jjournal
from alphafold2_tpu.telemetry import costs as jcosts
from alphafold2_tpu.telemetry import trace as jtrace
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_init, params_from_jax
from alphafold2_tpu_torch.constants import AA_ORDER
from alphafold2_tpu_torch.reliability import faults as tfaults
from alphafold2_tpu_torch.serving import artifact_store as tstore
from alphafold2_tpu_torch.serving import engine as tengine
from alphafold2_tpu_torch.serving import fleet as tfleet
from alphafold2_tpu_torch.serving import journal as tjournal
from alphafold2_tpu_torch.serving.errors import HungBatchError
from alphafold2_tpu_torch.telemetry import costs as tcosts
from alphafold2_tpu_torch.telemetry import trace as ttrace

WAIT = 30  # seconds: the bound of every wait
TINY = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)
AA = AA_ORDER.replace("W", "")  # all-W sequences are the poison marker
W_TOKEN = AA_ORDER.index("W")


def seq_of(length, offset=0):
    return "".join(AA[(offset + i) % len(AA)] for i in range(length))


class FreezableClock:
    """`time.monotonic` until `freeze()`: then one instant, so a goodput
    ledger's causes and its wall are read together."""

    def __init__(self):
        self.frozen = None

    def __call__(self):
        return time.monotonic() if self.frozen is None else self.frozen

    def freeze(self):
        self.frozen = time.monotonic()


def fake_engine_class(base):
    """`base` (a package's ServingEngine) with the device call stubbed:
    `call_hook(bucket, tokens, mask)` runs in `_call_executable` (the
    dispatch), `realize_hook(out)` in `_realize` (with pipelining, the
    settle thread)."""

    class FakeEngine(base):
        def __init__(self, *args, call_hook=None, realize_hook=None, **kwargs):
            self.batch_rows = []  # (B, Lb) a dispatch: the rung it ran at
            self._hook, self._realize_hook = call_hook, realize_hook
            super().__init__(*args, **kwargs)

        def _call_executable(self, bucket, tokens, mask, msa=None, msa_mask=None):
            self.batch_rows.append(tokens.shape)
            if self._hook is not None:
                self._hook(bucket, tokens, mask)
            B, Lb = tokens.shape
            return {"coords": np.zeros((B, Lb, 3), np.float32),
                    "confidence": np.full((B, Lb), 0.5, np.float32),
                    "stress": np.zeros((B,), np.float32),
                    "poison": bool(np.any(np.asarray(tokens) == W_TOKEN))}

        def _realize(self, out):
            if self._realize_hook is not None:
                self._realize_hook(out)
            return out

    return FakeEngine


PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", cfg=JaxConfig(**TINY), engine=jengine, Fake=fake_engine_class(
            jengine.ServingEngine), Tracer=jtrace.Tracer, Ledger=jcosts.ServeGoodputLedger,
        kw={}, fleet=jfleet, fleet_kw={}, faults=jfaults, store=jstore, journal=jjournal),
    "torch": types.SimpleNamespace(
        name="torch", cfg=Alphafold2Config(**TINY), engine=tengine, Fake=fake_engine_class(
            tengine.ServingEngine), Tracer=ttrace.Tracer, Ledger=tcosts.ServeGoodputLedger,
        kw={"device": "cpu"}, fleet=tfleet, fleet_kw={"device": "cpu"}, faults=tfaults,
        store=tstore, journal=tjournal),
}


def fake_engine(pkg, **overrides):
    """(engine, clock): a fake of `pkg` with a live tracer and a goodput
    ledger on a freezable clock."""
    hooks = {k: overrides.pop(k) for k in ("call_hook", "realize_hook") if k in overrides}
    base = dict(buckets=(8, 16), max_batch=4, max_queue=16, max_wait_s=0.05,
                request_timeout_s=30.0, cache_capacity=0, mds_iters=4)
    base.update(overrides)
    clock = FreezableClock()
    eng = pkg.Fake({}, pkg.cfg, pkg.engine.ServingConfig(**base), tracer=pkg.Tracer(),
                   goodput=pkg.Ledger(clock=clock), **hooks, **pkg.kw)
    return eng, clock


def outcome(req):
    try:
        return ("completed", req.result(timeout=WAIT).coords.shape)
    except Exception as e:  # noqa: BLE001 — an outcome
        return ("failed", type(e).__name__)


def summary(eng, clock):
    """What both packages must agree on, read after the engine settled:
    the terminal counters, the error codes, the batch count,
    `stats()["pipeline"]`'s depth and in-flight count, and each execute
    span's (dispatch, trace ids); plus the overlap ratio and the frozen
    goodput sums, checked per package."""
    st = eng.stats()
    clock.freeze()
    totals = eng.goodput.totals("engine")
    pipe = st.get("pipeline", {})
    spans = [s for s in eng._tracer.spans() if s["name"] == "serving.execute"]
    return {
        "requests": {k: st["requests"][k] for k in ("submitted", "completed", "failed",
                                                    "timed_out", "in_flight")},
        "errors": st["errors"],
        "batches": st["batches"]["count"],
        "pipeline": {k: pipe.get(k) for k in ("depth", "inflight")},
        "execute": sorted((s["attrs"]["dispatch"], tuple(s["attrs"]["trace_ids"]))
                          for s in spans),
        "execute_s": sorted(s["dur_s"] for s in spans),
        "overlap": pipe.get("overlap_ratio"), "window_s": pipe.get("window_seconds"),
        "totals": totals, "wall": eng.goodput.wall("engine"),
        "chip_s": eng.costs.fleet_chip_seconds_total(),
    }


def agree(a, b):
    """The two packages' summaries agree on everything but the clocks."""
    for key in ("requests", "errors", "batches", "pipeline", "execute"):
        assert a[key] == b[key], key
    for s in (a, b):
        # no second billed twice: the causes sum to the frozen wall
        assert sum(s["totals"].values()) == pytest.approx(s["wall"], abs=1e-9)


def run_both(scenario):
    out = {name: scenario(pkg) for name, pkg in PKGS.items()}
    agree(out["jax"], out["torch"])
    return out


# --- (a) scripted streams -----------------------------------------------------------


def test_pipelined_overlap_and_billing_reconcile():
    """Depth 2, max_batch 1, each realization 50 ms on the settle thread,
    6 requests: batch k's span covers batch k-1's realization, so the
    overlap ratio is ~1.83 (spans 0.05 + 5 x 0.10 over windows 6 x 0.05)
    in both packages, the watermark keeps goodput summing to the wall,
    and the cost ledger, the execute account and the windows agree."""
    def scenario(pkg):
        eng, clock = fake_engine(pkg, max_batch=1, pipeline_depth=2,
                                 realize_hook=lambda out: time.sleep(0.05))
        try:
            reqs = [eng.submit(seq_of(4 + i % 3, offset=i), trace_id=f"{i:016x}")
                    for i in range(6)]
            got = [outcome(r) for r in reqs]
            s = summary(eng, clock)
        finally:
            eng.shutdown(timeout=WAIT)
        assert got == [("completed", (4 + i % 3, 3)) for i in range(6)]
        execute = s["totals"]["execute"]
        assert s["window_s"] == pytest.approx(execute, rel=1e-6)
        assert s["chip_s"] == pytest.approx(execute, rel=1e-6)
        assert all(d >= 0.05 for d in s["execute_s"])
        return s

    out = run_both(scenario)
    t, j = out["torch"], out["jax"]
    assert t["pipeline"] == {"depth": 2, "inflight": 0} and len(t["execute"]) == 6
    for s in (t, j):
        assert 1.5 < s["overlap"] < 2.1, s["overlap"]
    assert abs(t["overlap"] - j["overlap"]) < 0.25


def test_watchdog_isolates_wedged_inflight_neighbor():
    """The first realization wedges past the watchdog: its request fails
    with HungBatchError, the neighbour in flight behind it gets a fresh
    window and completes, the settle thread survives for fresh traffic."""
    def scenario(pkg):
        wedge, state, lock = threading.Event(), {"n": 0}, threading.Lock()

        def realize_hook(out):
            with lock:
                state["n"] += 1
                first = state["n"] == 1
            if first:
                wedge.wait(WAIT)

        eng, clock = fake_engine(pkg, max_batch=1, pipeline_depth=2,
                                 watchdog_timeout_s=0.25, realize_hook=realize_hook)
        try:
            victim = eng.submit(seq_of(4), trace_id="0" * 16)
            neighbor = eng.submit(seq_of(5), trace_id="1" * 16)
            got = [outcome(victim), outcome(neighbor)]
            fresh = outcome(eng.submit(seq_of(6), trace_id="2" * 16))
            s = summary(eng, clock)
            alive = eng.health()["settle_alive"]
        finally:
            wedge.set()
            eng.shutdown(timeout=WAIT)
        assert got == [("failed", "HungBatchError"), ("completed", (5, 3))]
        assert fresh == ("completed", (6, 3)) and alive
        return s

    out = run_both(scenario)
    assert out["torch"]["errors"] == {"hung_batch": 1}
    assert out["torch"]["requests"]["completed"] == 2


def test_shutdown_drain_settles_all_inflight():
    """Batches enqueued when shutdown(drain=True) lands still settle (the
    sentinel goes in last) and the settle thread is joined."""
    def scenario(pkg):
        dispatched = threading.Event()

        def realize_hook(out):
            dispatched.set()
            time.sleep(0.15)

        eng, clock = fake_engine(pkg, max_batch=1, pipeline_depth=2, realize_hook=realize_hook)
        reqs = [eng.submit(seq_of(4), trace_id="a" * 16),
                eng.submit(seq_of(5), trace_id="b" * 16)]
        assert dispatched.wait(10)
        eng.shutdown(drain=True, timeout=WAIT)
        got = [outcome(r) for r in reqs]
        assert not eng._settle_thread.is_alive()
        assert got == [("completed", (4, 3)), ("completed", (5, 3))]
        return summary(eng, clock)

    out = run_both(scenario)
    assert out["torch"]["pipeline"] == {"depth": 2, "inflight": 0}


def test_settle_side_poison_splits_to_singles():
    """A batch of three that fails at its realization (the settle thread)
    splits into singles, which run synchronously there: only the poison
    request fails, and the rungs are 3, then 1, 1, 1."""
    def scenario(pkg):
        def realize_hook(out):
            if out["poison"]:
                raise RuntimeError("injected device fault")

        eng, clock = fake_engine(pkg, max_batch=3, batch_ladder=True, pipeline_depth=2,
                                 max_wait_s=0.5, realize_hook=realize_hook)
        try:
            reqs = [eng.submit(seq, trace_id=f"{i:016x}")
                    for i, seq in enumerate((seq_of(4), "W" * 5, seq_of(6)))]
            got = [outcome(r) for r in reqs]
            s = summary(eng, clock)
            rows = list(eng.batch_rows)
        finally:
            eng.shutdown(timeout=WAIT)
        assert got == [("completed", (4, 3)), ("failed", "PredictionError"),
                       ("completed", (6, 3))]
        assert rows == [(3, 8), (1, 8), (1, 8), (1, 8)]
        return s

    out = run_both(scenario)
    # the failed batch settles no execute span; each single's sync dispatch
    # opens its own
    assert [d for d, _ in out["torch"]["execute"]] == [1, 2, 3]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_drain_ema_feeds_from_settled_batches(depth):
    """The drain EMA arms from settled batches at every depth: three
    predictions one at a time, each realized in 20 ms, quote ~20 ms a
    request in both packages."""
    def scenario(pkg):
        eng, clock = fake_engine(pkg, max_batch=1, pipeline_depth=depth,
                                 realize_hook=lambda out: time.sleep(0.02))
        try:
            for i in range(3):
                eng.submit(seq_of(4, offset=i), trace_id=f"{i:016x}").result(timeout=WAIT)
            with eng._rate_lock:
                ema = eng._sec_per_req_ema
            s = summary(eng, clock)
        finally:
            eng.shutdown(timeout=WAIT)
        assert 0.02 <= ema < 0.1, ema
        return s

    out = run_both(scenario)
    assert out["torch"]["pipeline"] == ({"depth": depth, "inflight": 0} if depth
                                        else {"depth": None, "inflight": None})


def test_wedged_dispatch_half_fires_the_watchdog_and_the_next_batch_serves():
    """The port's own case: on the card a pipelined dispatch waits for its
    graph one (the eager eigh's status read), so the watchdog guards the
    enqueue too. A first dispatch wedged past it fails its batch with
    HungBatchError, releases its window slot, and the next batch is
    served."""
    release, calls = threading.Event(), []

    def call_hook(bucket, tokens, mask):
        calls.append(tokens.shape)
        if len(calls) == 1:
            release.wait(WAIT)

    eng, clock = fake_engine(PKGS["torch"], max_batch=1, pipeline_depth=1,
                             watchdog_timeout_s=0.25, call_hook=call_hook)
    try:
        victim = eng.submit(seq_of(4))
        with pytest.raises(HungBatchError, match="enqueue abandoned"):
            victim.result(timeout=WAIT)
        assert eng.submit(seq_of(5)).result(timeout=WAIT).coords.shape == (5, 3)
        s = summary(eng, clock)
    finally:
        release.set()
        eng.shutdown(timeout=WAIT)
    assert s["errors"] == {"hung_batch": 1} and s["pipeline"] == {"depth": 1, "inflight": 0}
    assert s["requests"]["completed"] == 1 and s["requests"]["failed"] == 1


def test_pipeline_depth_is_validated_as_jax_validates_it():
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="pipeline_depth must be >= 0"):
            pkg.engine.ServingConfig(pipeline_depth=-1)
        assert pkg.engine.ServingConfig(pipeline_depth=3).pipeline_depth == 3


# --- (b) the real tiny model --------------------------------------------------------

TINY3 = dict(TINY, depth=3)
REAL = dict(buckets=(8, 16), max_batch=4, batch_ladder=True, max_wait_s=10.0,
            request_timeout_s=300.0, cache_capacity=0, mds_iters=6)
# (mds_init, early exit, stream lengths): full batches of 4 leave as they
# fill, the rest at the draining shutdown. The random init's seeds follow
# the dispatch order, so its stream keeps to one bucket
REAL_CASES = {
    "classical": ("classical", False, [3, 5, 8, 9, 12, 16, 6, 14, 4, 7, 15, 10, 2, 8, 11]),
    "random": ("random", False, [3, 5, 8, 7, 6, 4, 2, 8, 5]),
    "early_exit": ("classical", True, [3, 5, 8, 9, 12, 16, 6, 14, 4, 7]),
}


@pytest.fixture(scope="module")
def real_params():
    out = {}
    for key, kw in (("depth1", TINY), ("depth3", TINY3)):
        out[key] = alphafold2_init(Alphafold2Config(**kw), torch.Generator().manual_seed(0),
                                   "cpu")
    return out


def serve_stream(params, cfg, scfg, lengths):
    """Every result of `lengths` submitted at once, after a draining
    shutdown."""
    eng = tengine.ServingEngine(params, cfg, scfg, device="cpu")
    try:
        reqs = [eng.submit(seq_of(n, offset=i)) for i, n in enumerate(lengths)]
    finally:
        eng.shutdown(drain=True, timeout=300)
    stats = eng.stats()
    assert stats["requests"]["completed"] == len(lengths), stats["requests"]
    return [r.result(timeout=1) for r in reqs], stats


@pytest.mark.parametrize("case", list(REAL_CASES))
def test_pipelined_results_are_the_synchronous_engines_bit_for_bit(case, real_params):
    """Depths 1 and 2 against depth 0 on the same stream and batches: coords,
    confidence, stress and exit depth equal bit for bit."""
    init, early_exit, lengths = REAL_CASES[case]
    cfg = Alphafold2Config(**(TINY3 if early_exit else TINY))
    params = real_params["depth3" if early_exit else "depth1"]
    fields = dict(REAL, mds_init=init)
    if early_exit:
        fields.update(early_exit_depths=(1, 2), early_exit_kl=1e-3)
    runs = {d: serve_stream(params, cfg, tengine.ServingConfig(**fields, pipeline_depth=d),
                            lengths) for d in (0, 1, 2)}
    ref, ref_stats = runs[0]
    for d in (1, 2):
        got, stats = runs[d]
        assert stats["pipeline"]["depth"] == d and stats["pipeline"]["inflight"] == 0
        assert stats["batches"]["recent_sizes"] == ref_stats["batches"]["recent_sizes"]
        for r, g in zip(ref, got):
            assert np.array_equal(r.coords, g.coords) and np.array_equal(r.confidence,
                                                                         g.confidence)
            assert r.stress == g.stress and r.exit_depth == g.exit_depth
            assert r.bucket == g.bucket
    if early_exit:
        assert {r.exit_depth for r in ref} <= {1, 2, 3}


def test_depth0_engine_matches_the_jax_engine_on_the_same_weights():
    """The port's depth-0 engine (the reference the pipelined one is held
    to) against JAX's on converted weights, the classical stream:
    distances 1e-3 A, confidence 5e-6, stress 1e-4 relative
    (tests/test_torch_serving.py's engine tolerances)."""
    kw = dict(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=16)
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig(**kw))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              Alphafold2Config(**kw), device="cpu")
    lengths = REAL_CASES["classical"][2][:10]
    fields = dict(REAL, mds_iters=50)
    jeng = jengine.ServingEngine(jparams, JaxConfig(**kw), jengine.ServingConfig(**fields))
    try:
        jreqs = [jeng.submit(seq_of(n, offset=i)) for i, n in enumerate(lengths)]
    finally:
        jeng.shutdown(drain=True, timeout=300)
    jres = [r.result(timeout=1) for r in jreqs]
    tres, _ = serve_stream(tparams, Alphafold2Config(**kw), tengine.ServingConfig(**fields),
                           lengths)

    def pairwise(c):
        c = np.asarray(c, np.float64)
        return np.linalg.norm(c[:, None] - c[None], axis=-1)

    for n, j, t in zip(lengths, jres, tres):
        assert t.bucket == j.bucket and t.coords.shape == (n, 3)
        np.testing.assert_allclose(t.confidence, j.confidence, rtol=0, atol=5e-6)
        np.testing.assert_allclose(t.stress, j.stress, rtol=1e-4)
        np.testing.assert_allclose(pairwise(t.coords), pairwise(j.coords), rtol=0, atol=1e-3)


# --- (c) the CLI and the fleet ------------------------------------------------------


def test_cli_serves_with_a_pipeline_depth(capsys):
    from alphafold2_tpu_torch import serve

    rc = serve.main(["--demo", "2", "--device", "cpu", "--pipeline-depth", "2", "--buckets",
                     "16", "--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8",
                     "--mds-iters", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "pipelined dispatch, depth 2" in out and "served 2 request(s)" in out


def mid_pipeline_kill(pkg, tmp_path):
    """tests/test_chaos.py's mid-pipeline kill through `pkg`'s fleet: two
    replicas at depth 2 with the ladder, r0 killed at its second dispatch
    while its first batch is in flight (each realization 100 ms), an
    artifact store and an intake journal."""
    rows, rows_lock = [], threading.Lock()

    class Counting(pkg.Fake):
        def _call_executable(self, bucket, tokens, mask, msa=None, msa_mask=None):
            with rows_lock:
                rows.append(tokens.shape[0])
            return super()._call_executable(bucket, tokens, mask, msa=msa, msa_mask=msa_mask)

    inj = pkg.faults.FaultPlan(faults=(pkg.faults.Fault("kill_replica", replica="r0",
                                                        at=1),)).injector()
    scfg = pkg.engine.ServingConfig(buckets=(8, 16), max_batch=1, max_queue=8, max_wait_s=0.0,
                                    request_timeout_s=30.0, cache_capacity=0,
                                    batch_ladder=True, pipeline_depth=2)
    fleet = pkg.fleet.ServingFleet(
        {}, pkg.cfg, scfg,
        pkg.fleet.FleetConfig(replicas=2, probe_interval_s=0, reprobe_interval_s=30.0,
                              fail_threshold=1, requeue_limit=2),
        engine_factory=lambda n, c, h: Counting({}, pkg.cfg, c, fault_hook=h,
                                                realize_hook=lambda out: time.sleep(0.1),
                                                **pkg.kw),
        injector=inj,
        artifact_store=pkg.store.ArtifactStore(pkg.store.ArtifactStoreConfig(root=None)),
        journal=pkg.journal.IntakeJournal(str(tmp_path / pkg.name)), **pkg.fleet_kw)
    try:
        reqs = [fleet.submit(seq_of(4 + i % 3, offset=i)) for i in range(6)]
        results = [r.result(timeout=WAIT) for r in reqs]
        st = fleet.stats()
        deadline = time.monotonic() + 10
        while fleet._journal.pending_count() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        return {
            "completed": st["requests"]["completed"], "failed": st["requests"]["failed"],
            "in_flight": st["requests"]["in_flight"],
            "requeued_once_at_most": all(r.requeues <= 1 for r in results),
            "requeued": st["requests"]["requeued"] >= 1
            and st["requests"]["requeued"] == sum(r.requeues for r in results),
            "r0_settled_in_flight": any(r.replica == "r0" and r.requeues == 0
                                        for r in results),
            "one_dispatch_each": sorted(rows) == [1] * 6,
            "r0": st["health"]["targets"]["r0"]["state"],
            "journal": fleet._journal.pending_count(),
            "exhausted": inj.exhausted(),
        }
    finally:
        fleet.shutdown(timeout=WAIT)


def test_fleet_kill_replica_mid_pipeline_gives_the_jax_outcomes(tmp_path):
    got = mid_pipeline_kill(PKGS["torch"], tmp_path)
    want = mid_pipeline_kill(PKGS["jax"], tmp_path)
    assert got == want
    assert got == {"completed": 6, "failed": 0, "in_flight": 0, "requeued_once_at_most": True,
                   "requeued": True, "r0_settled_in_flight": True, "one_dispatch_each": True,
                   "r0": "down", "journal": 0, "exhausted": True}
