"""The port's serving cost plane against the JAX package's
(`alphafold2_tpu/telemetry/costs.py`), and the engine's telemetry, on the
CPU. The ledgers and the flight book take the same calls and the same
injected clock in both packages and agree exactly; the engine's cost cells
carry JAX's analytic FLOPs and priced bytes; its spans, flights and goodput
are driven through a fake clock and stand-in executables, so no assertion
reads a wall clock."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from alphafold2_tpu import telemetry as jtel
from alphafold2_tpu_torch import telemetry as ttel
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_init
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.serving import engine as engine_mod
from alphafold2_tpu_torch.serving.engine import ServingConfig, ServingEngine
from alphafold2_tpu_torch.telemetry import hooks

TINY = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)


class Clock:
    def __init__(self, t=50.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ------------------------------------------------------------ the ledgers


def _cost_scenario(pkg):
    reg = pkg.MetricRegistry()
    led = pkg.ExecutableCostLedger(reg)
    a = led.register_cell(pool="default", bucket=64, schedule="dense", backend_arm="kernel",
                          weight_dtype="f32", forward_flops=3.5e9, residency_bytes=123456,
                          chips=1, max_batch=4)
    b = led.register_cell(pool="default", bucket=128, schedule="dense@b2", backend_arm="kernel",
                          weight_dtype="int8", forward_flops=1.25e10, residency_bytes=654321,
                          chips=1, max_batch=2)
    led.publish()  # analytic columns only
    for secs, n in ((0.5, 4), (0.25, 2), (0.125, 3)):
        led.observe_batch(a, device_seconds=secs, requests=n)
    led.observe_batch(b, device_seconds=2.0, requests=1)
    led.observe_batch(("pool2", 32, "dense", "plain", "f32"), device_seconds=1.0, requests=2)
    led.set_peak(989e12)
    led.publish()
    led.observe_batch(a, device_seconds=0.5, requests=4)
    led.publish()
    return led, reg


def test_cost_ledger_cells_gauges_and_rates_match_jax():
    (j, jreg), (t, treg) = _cost_scenario(jtel), _cost_scenario(ttel)
    assert t.cells() == j.cells()
    assert t.snapshot() == j.snapshot()
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert ttel.flatten_snapshot(treg.snapshot()) == jtel.flatten_snapshot(jreg.snapshot())
    for pool in ("default", "pool2", "none"):
        assert t.pool_rate_rps(pool) == j.pool_rate_rps(pool)
    assert t.fleet_chip_seconds_total() == j.fleet_chip_seconds_total()
    cell = t.cells()[0]
    assert cell["mfu"] == cell["flops_per_sec_per_chip"] / 989e12


def _goodput_scenario(pkg):
    clock = Clock()
    reg = pkg.MetricRegistry()
    led = pkg.ServeGoodputLedger(reg, clock=clock)
    led.register("r0", "default")
    led.register("r1", "int8")
    clock.advance(1.0)
    led.add("r0", "compile", 0.75)
    led.add("r0", "execute", 0.125)
    led.add("r1", "execute", 0.5)
    led.add("r0", "execute", 0.0)  # ignored
    with led.probe_span("r1"):
        clock.advance(0.25)
        led.add("r1", "execute", 0.0625)  # the probe's own execute
    led.add("r1", "requeue", 0.03125)
    led.register("r0", "pool-b")  # re-pool keeps the clock
    clock.advance(2.0)
    led.publish()
    return led, reg, clock


def test_serve_goodput_matches_jax_and_sums_to_wall():
    (j, jreg, jclock), (t, treg, tclock) = _goodput_scenario(jtel), _goodput_scenario(ttel)
    assert t.snapshot() == j.snapshot()
    assert treg.to_prometheus() == jreg.to_prometheus()
    for name in ("r0", "r1"):
        assert sum(t.totals(name).values()) == pytest.approx(t.wall(name), abs=1e-9)
    assert t.totals("r1")["probe"] == 0.25 - 0.0625
    for pkg in (jtel, ttel):
        with pytest.raises(ValueError):
            pkg.ServeGoodputLedger().add("r", "idle", 1.0)


def _flight_scenario(pkg):
    clock = Clock(1000.0)
    book = pkg.FlightBook(capacity=3, clock=clock)
    for i in range(5):
        clock.advance(1.0)
        book.begin(f"id{i}", length=10 + i, pool="default", bucket=16)
    book.begin("id4", length=99)  # a resubmission
    book.note("id3", "dispatch", batch=2)
    book.note("gone", "dispatch")  # evicted or unknown: dropped
    book.finish("id3", "completed", replica="", latency_s=0.5)
    book.finish("id4", "failed", code="prediction_failed")
    return book


def test_flight_book_records_match_jax():
    j, t = _flight_scenario(jtel), _flight_scenario(ttel)
    for tid in ("id0", "id2", "id3", "id4"):
        assert t.get(tid) == j.get(tid)
    assert t.recent() == j.recent() == ["id2", "id3", "id4"]
    assert t.snapshot() == j.snapshot() == {"records": 3, "capacity": 3, "evicted": 2}
    with pytest.raises(ValueError):
        ttel.FlightBook(capacity=0)


# ------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def tiny_params():
    return alphafold2_init(Alphafold2Config(**TINY), torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("dtype, weight_dtype, ladder", [
    ("f32", "f32", False), ("f32", "int8", True), ("bf16", "f32", True),
], ids=["f32", "int8_ladder", "bf16_ladder"])
def test_engine_cells_price_like_jax(tiny_params, dtype, weight_dtype, ladder):
    """Each (bucket, rung) cell: JAX's `model_fwd_flops` at the bucket and
    `sp_arm.schedule_residency(schedule="dense")` bytes, exactly."""
    import jax.numpy as jnp

    from alphafold2_tpu.models import Alphafold2Config as JaxConfig
    from alphafold2_tpu.serving import sp_arm
    from alphafold2_tpu.utils.flops import model_fwd_flops

    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    cfg = Alphafold2Config(**TINY, dtype=tdt, weight_dtype=weight_dtype)
    jcfg = JaxConfig(**TINY, dtype=jdt, weight_dtype=weight_dtype)
    scfg = ServingConfig(buckets=(8, 16), max_batch=4, batch_ladder=ladder, msa_rows=3,
                         mds_iters=2)
    eng = ServingEngine(tiny_params, cfg, scfg, device="cpu")
    try:
        cells = eng.stats()["costs"]["cells"]
    finally:
        eng.shutdown()
    shapes = (1, 2, 4) if ladder else (4,)
    assert len(cells) == 2 * len(shapes)
    for cell in cells:
        b, s = cell["bucket"], cell["max_batch"]
        assert cell["schedule"] == (f"dense@b{s}" if ladder else "dense")
        assert (cell["backend_arm"], cell["weight_dtype"]) == ("plain", weight_dtype)
        assert cell["forward_flops"] == model_fwd_flops(jcfg, n=b, r=3, c=b)
        want = sp_arm.schedule_residency(jcfg, bucket=b, batch=s, msa_rows=3,
                                         schedule="dense", shards=1)
        assert cell["residency_bytes"] == want.total_bytes
        assert cell["batches"] == 0 and cell["chip_seconds_per_request"] is None


def test_engine_stats_keys_match_the_jax_engine(tiny_params):
    """The port's stats() has the JAX engine's keys plus its own `device`,
    `captures` and `launches`, with the cost plane and the span summary
    present even when nothing was passed in."""
    import jax

    from alphafold2_tpu.models import Alphafold2Config as JaxConfig
    from alphafold2_tpu.models import alphafold2_init as jax_init
    from alphafold2_tpu.serving import ServingConfig as JaxServingConfig
    from alphafold2_tpu.serving import ServingEngine as JaxServingEngine

    scfg = dict(buckets=(8,), max_batch=1, mds_iters=2, request_timeout_s=300.0)
    jeng = JaxServingEngine(jax_init(jax.random.PRNGKey(0), JaxConfig(**TINY)),
                            JaxConfig(**TINY), JaxServingConfig(**scfg))
    teng = ServingEngine(tiny_params, Alphafold2Config(**TINY), ServingConfig(**scfg),
                         device="cpu")
    try:
        for eng in (jeng, teng):
            eng.predict("ACDEF", timeout=300)
        jstats, tstats = jeng.stats(), teng.stats()
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert set(tstats) - {"device", "captures", "launches"} == set(jstats)
    assert set(tstats["telemetry"]) == set(jstats["telemetry"]) == {"metrics", "spans"}
    assert tstats["telemetry"]["spans"] == jstats["telemetry"]["spans"] == {}
    assert set(tstats["serve_goodput"]["replicas"]) == {"engine"}
    # private ledgers publish into the engine's registry
    gauges = tstats["telemetry"]["metrics"]["gauges"]
    assert 'serve_goodput_ratio{pool="default",replica="engine"}' in gauges
    assert tstats["capability"] == jstats["capability"]
    assert [c["requests"] for c in tstats["costs"]["cells"]] == \
        [c["requests"] for c in jstats["costs"]["cells"]] == [1]
    json.dumps(tstats)


@pytest.mark.parametrize("passed, timed", [
    ({}, False), ({"tracer": "off"}, False), ({"tracer": "on"}, True),
    ({"cost_ledger": True}, True), ({"goodput": True}, False),
], ids=["nothing", "tracer_off", "tracer_on", "cost_ledger", "goodput"])
def test_engine_times_the_device_only_when_asked(tiny_params, passed, timed):
    """CUDA-event device timing is on under a live tracer or a cost ledger
    passed in, and off otherwise; a ledger passed in is the one the engine
    fills, publishes and reports."""
    kwargs = {}
    if "tracer" in passed:
        kwargs["tracer"] = ttel.Tracer(enabled=passed["tracer"] == "on")
    if "cost_ledger" in passed:
        kwargs["cost_ledger"] = ttel.ExecutableCostLedger(ttel.MetricRegistry())
    if "goodput" in passed:
        kwargs["goodput"] = ttel.ServeGoodputLedger()
    eng = ServingEngine(tiny_params, Alphafold2Config(**TINY),
                        ServingConfig(buckets=(8,), max_batch=1, mds_iters=2), device="cpu",
                        **kwargs)
    try:
        eng.predict("ACDEF", timeout=300)
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert eng._device_timing is timed
    if "cost_ledger" in kwargs:
        assert eng.costs is kwargs["cost_ledger"]
        assert stats["costs"] == eng.costs.snapshot()
    if "goodput" in kwargs:
        assert eng.goodput is kwargs["goodput"]
        assert set(stats["serve_goodput"]["replicas"]) == {"engine"}
    assert [c["batches"] for c in stats["costs"]["cells"]] == [1]


class FakeTime:
    """Stands in for the engine's and the capture tracker's `time`: moves
    only when the stand-in executables move it."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    perf_counter = monotonic

    def advance(self, dt):
        self.t += dt


CAPTURE_S, CALL_S = 10.0, 0.5  # the stand-ins' seconds


@pytest.fixture
def timed_engine(monkeypatch):
    """An engine on the CPU whose executables are stand-ins: building one
    (the capture) takes CAPTURE_S on the fake clock, a call CALL_S."""
    clock = FakeTime()
    monkeypatch.setattr(engine_mod, "time", clock)
    monkeypatch.setattr(hooks, "time", clock)

    class StandIn:
        def __init__(self, *args, **kwargs):
            clock.advance(CAPTURE_S)
            self.seconds, self.launches, self.replays = CAPTURE_S, {}, 0

        def __call__(self, tokens, mask, msa=None, msa_mask=None, *, seed=None):
            clock.advance(CALL_S)
            self.replays += 1
            B, Lb = tokens.shape
            return {"coords": torch.zeros(B, Lb, 3), "confidence": torch.full((B, Lb), 0.5),
                    "stress": torch.zeros(B)}

    monkeypatch.setattr(engine_mod, "EagerExecutable", StandIn)
    made = []

    def build(**kwargs):
        tracer = ttel.Tracer(clock=clock.monotonic)
        goodput = ttel.ServeGoodputLedger(clock=clock.monotonic)
        flights = ttel.FlightBook(clock=clock.monotonic)
        scfg = ServingConfig(buckets=(8, 16), max_batch=1, max_wait_s=0.0,
                             request_timeout_s=None, mds_iters=2, **kwargs)
        eng = ServingEngine({}, Alphafold2Config(**TINY), scfg, device="cpu", tracer=tracer,
                            goodput=goodput, flights=flights, replica_name="r0")
        made.append(eng)
        return eng, clock

    yield build
    for eng in made:
        eng.shutdown()


def test_engine_spans_carry_each_requests_trace_id(timed_engine):
    eng, _ = timed_engine()
    seqs = ["ACDE", "ACDEFGHIK", "MKTA", "MKTAYIAKQR"]
    reqs = [eng.submit(s, trace_id=f"{i:016x}") for i, s in enumerate(seqs)]
    results = [r.result(timeout=30) for r in reqs]
    spans = eng._tracer.spans()
    for req, res in zip(reqs, results):
        tid = req.trace_id
        assert res.trace_id == tid
        mine = {s["name"] for s in spans if s["attrs"].get("trace_id") == tid
                or tid in s["attrs"].get("trace_ids", ())}
        assert {"serving.enqueue", "serving.queue_wait", "serving.batch", "serving.execute",
                "serving.respond"} <= mine
        flight = eng.flights.get(tid)
        assert flight["outcome"] == "completed" and flight["bucket"] == res.bucket
        assert flight["replica"] == "r0" and flight["schedule"] == "dense"
    # each bucket's first batch captured inside its execute span, under its ids
    captures = [s for s in spans if s["name"] == "serving_capture"]
    assert len(captures) == 2 and all(s["attrs"]["trace_ids"] for s in captures)
    assert all(s["attrs"]["replica"] == "r0" for s in spans
               if s["name"].startswith("serving."))
    summary = eng.stats()["telemetry"]["spans"]
    assert summary["serving.execute"]["count"] == 4


def test_engine_keeps_the_capture_out_of_execute_and_the_ema(timed_engine):
    eng, clock = timed_engine(batch_ladder=True)
    for s in ("ACDE", "ACDEFGHIK", "MKTA", "MKTAYIAKQR", "ACD"):
        eng.predict(s, timeout=30)
    stats = eng.stats()
    buckets = stats["serve_goodput"]["replicas"]["r0"]["buckets"]
    assert buckets["compile"] == 2 * CAPTURE_S
    assert buckets["execute"] == 5 * CALL_S
    assert sum(buckets.values()) == pytest.approx(eng.goodput.wall("r0"), abs=1e-9)
    measured = [c for c in stats["costs"]["cells"] if c["batches"]]
    assert {(c["bucket"], c["max_batch"]) for c in measured} == {(8, 1), (16, 1)}
    for c in measured:
        assert c["ema_batch_seconds"] == CALL_S and c["device_seconds"] == c["batches"] * CALL_S
    gauges = stats["telemetry"]["metrics"]["gauges"]
    assert gauges['serving_capture_seconds_total{bucket="8"}'] == CAPTURE_S


def test_engine_failed_dispatch_bills_requeue(timed_engine, monkeypatch):
    eng, clock = timed_engine()
    eng.predict("ACDE", timeout=30)  # builds bucket 8

    def broken(*args, **kwargs):
        clock.advance(0.25)
        raise RuntimeError("device fault")

    monkeypatch.setattr(eng, "_realize", broken)
    with pytest.raises(Exception, match="prediction failed"):
        eng.predict("MKTA", timeout=30)
    rec = eng.flights.get(eng.flights.recent()[-1])
    assert rec["outcome"] == "failed" and rec["code"] == "prediction_failed"
    buckets = eng.goodput.totals("r0")
    assert buckets["requeue"] == 0.25 + CALL_S and buckets["execute"] == CALL_S


def test_engine_flights_seal_cache_hits_coalescing_and_rejections(timed_engine):
    eng, _ = timed_engine(cache_capacity=8)
    first = eng.submit("ACDE", trace_id="a" * 16)
    first.result(timeout=30)
    hit = eng.submit("ACDE", trace_id="b" * 16)
    assert hit.result(timeout=30).trace_id == "b" * 16
    assert eng.flights.get("b" * 16)["outcome"] == "completed"
    assert eng.flights.get("b" * 16)["from_cache"] is True
    with pytest.raises(Exception):
        eng.submit("ACDE1", trace_id="c" * 16)  # invalid: rejected before a record
    assert eng.flights.get("c" * 16) is None
    enqueue = [s for s in eng._tracer.spans() if s["name"] == "serving.enqueue"]
    assert enqueue[-1]["attrs"]["error"] == "InvalidSequenceError"


def test_engine_incident_hook_hears_the_breaker(timed_engine, monkeypatch):
    heard = []
    eng, _ = timed_engine(breaker_threshold=1)
    eng._incident_hook = lambda kind, **attrs: heard.append((kind, attrs["replica"]))
    monkeypatch.setattr(eng, "_realize", lambda out: (_ for _ in ()).throw(RuntimeError("x")))
    with pytest.raises(Exception):
        eng.predict("ACDE", timeout=30)
    assert heard == [("breaker_open", "r0")]


def test_engine_cost_gauges_publish_to_its_registry(timed_engine):
    eng, _ = timed_engine()
    eng.costs.set_peak(1e12)
    eng.predict("ACDE", timeout=30)
    eng.sample_gauges()
    parsed = ttel.parse_prometheus_text(eng.metrics.registry.to_prometheus())
    names = {name for name, _ in parsed}
    assert {"serve_forward_flops", "serve_residency_bytes", "serve_cell_requests_total",
            "serve_chip_seconds_per_request", "serve_mfu"} <= names
    cell = eng.cell_for(8)
    assert cell == {"pool": "default", "bucket": 8, "schedule": "dense",
                    "backend_arm": "plain", "weight_dtype": "f32"}
    assert eng.cell_for(99) == {}
    assert dataclasses.asdict(eng.predict("ACDE", timeout=30))["trace_id"]
    assert np.isfinite(eng.stats()["costs"]["cells"][0]["ema_batch_seconds"])
