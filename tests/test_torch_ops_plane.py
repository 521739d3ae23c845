"""The port's operations plane against the JAX package's
(`alphafold2_tpu/telemetry/ops_plane.py`, `slo.py`), on the CPU: the SLO
engine and the flight recorder take the same registry deltas and the same
injected clock in both packages and agree exactly; the ops server answers
every endpoint (servers bind port 0 on 127.0.0.1, stop in a `finally`, and
each HTTP call has a timeout); `/profilez` drives `torch.profiler` under
the engine's graph lock; then `serve` and `predict` with their telemetry
flags. No assertion reads a wall clock."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from alphafold2_tpu import telemetry as jtel
from alphafold2_tpu_torch import telemetry as ttel
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.serving.engine import ServingConfig, ServingEngine

HTTP_S = 5  # the bound of every HTTP call


def get(url):
    """(status, body) of one GET; HTTP errors are answers too."""
    try:
        with urllib.request.urlopen(url, timeout=HTTP_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _shed(**overrides):
    base = dict(name="shed_rate", kind="ratio",
                bad=[{"metric": "serving_requests_total", "labels": {"outcome": "rejected"}}],
                total=[{"metric": "serving_requests_total", "labels": {"outcome": "submitted"}}],
                objective=0.9, fast_burn=1.0, slow_burn=1.0)
    base.update(overrides)
    return base


def _slo_scenario(pkg, tmp_path):
    reg = pkg.MetricRegistry()
    submitted = reg.counter("serving_requests_total", outcome="submitted")
    rejected = reg.counter("serving_requests_total", outcome="rejected")
    latency = reg.histogram("serving_request_latency_seconds")
    cfg = pkg.SloConfig.from_dict({
        "fast_window_s": 10, "slow_window_s": 30,
        "objectives": [_shed(), {"name": "latency_p95", "kind": "quantile",
                                 "metric": "serving_request_latency_seconds",
                                 "quantile": 0.95, "threshold": 1.0,
                                 "fast_burn": 2.0, "slow_burn": 1.0}]})
    t = [0.0]
    rec = pkg.FlightRecorder(str(tmp_path), registry=reg, clock=lambda: t[0],
                             min_interval_s=0.0)
    pages = []

    def on_page(name, transition, info):
        pages.append((name, transition))
        rec.slo_page_hook(name, transition, info)

    slo = pkg.SloEngine(reg, cfg, on_page=on_page, clock=lambda: t[0])
    outs = []
    steps = [(0.0, 10, 0, 0.1), (5.0, 10, 5, 0.2), (9.0, 2, 0, 5.0), (16.0, 100, 0, 5.0),
             (30.0, 50, 0, 0.1), (45.0, 0, 3, 0.1)]
    for now, n_sub, n_rej, lat in steps:
        t[0] = now
        submitted.inc(n_sub)
        rejected.inc(n_rej)
        for _ in range(20):
            latency.observe(lat)
        rec.poll()
        outs.append(slo.evaluate(now=now))
    return reg, slo, rec, outs, pages


def _bundle(path):
    b = json.load(open(path))
    b.pop("spans")
    return b


def test_slo_engine_and_flight_recorder_match_jax(tmp_path):
    j = _slo_scenario(jtel, tmp_path / "j")
    t = _slo_scenario(ttel, tmp_path / "t")
    assert t[3] == j[3]                       # burn rates and active flags, tick by tick
    assert t[4] == j[4]                       # the alert transitions
    assert [p[1] for p in t[4]].count("firing") >= 2
    assert t[1].events() == j[1].events()
    assert t[1].snapshot() == j[1].snapshot()
    assert t[0].to_prometheus() == j[0].to_prometheus()
    tb, jb = t[2].snapshot(), j[2].snapshot()
    assert [p.rsplit("/", 1)[1] for p in tb["bundles"]] == \
        [p.rsplit("/", 1)[1] for p in jb["bundles"]]
    for tp, jp in zip(tb["bundles"], jb["bundles"]):
        assert _bundle(tp) == _bundle(jp)


@pytest.mark.parametrize("bad", [
    {"objectives": [_shed(kind="mean")]},
    {"objectives": [_shed(objective=1.0)]},
    {"objectives": [_shed(typo=1)]},
    {"objectives": [_shed(), _shed()]},
    {"fast_window_s": 60, "slow_window_s": 30, "objectives": []},
    {"objectives": [], "extra": 1},
], ids=["kind", "target", "unknown_key", "duplicate", "windows", "config_key"])
def test_slo_config_refuses_what_jax_refuses(bad):
    for pkg in (jtel, ttel):
        with pytest.raises(ValueError):
            pkg.SloConfig.from_dict(bad)


def test_default_slo_configs_match_jax(tmp_path):
    for prefix in ("serving", "fleet"):
        assert repr(ttel.default_slo_config(prefix)) == repr(jtel.default_slo_config(prefix))
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"fast_window_s": 5, "slow_window_s": 50,
                                "objectives": [_shed()]}))
    assert repr(ttel.SloConfig.from_file(str(path))) == repr(jtel.SloConfig.from_file(str(path)))


def test_flight_recorder_rate_limit_and_ring_bound(tmp_path):
    t = [0.0]
    reg = ttel.MetricRegistry()
    rec = ttel.FlightRecorder(str(tmp_path), registry=reg, capacity=4, min_interval_s=10.0,
                              clock=lambda: t[0])
    assert rec.incident("watchdog_fire", dispatch=1) is not None
    t[0] = 1.0
    assert rec.incident("watchdog_fire") is None
    assert rec.incident("breaker_open") is not None
    for i in range(10):
        rec.note("filler", i=i)
    snap = rec.snapshot()
    assert snap["events"] == 4 and snap["suppressed_bundles"] == 1 and len(snap["bundles"]) == 2
    counters = reg.snapshot()["counters"]
    assert counters['flight_incidents_total{kind="watchdog_fire"}'] == 2
    assert counters["flight_bundles_written_total"] == 2


# ------------------------------------------------------------ the server


class StubEngine(ServingEngine):
    """The engine with the device call stubbed at `_call_executable`."""

    def _call_executable(self, bucket, tokens, mask, msa=None, msa_mask=None):
        B, Lb = tokens.shape
        return {"coords": np.zeros((B, Lb, 3), np.float32),
                "confidence": np.full((B, Lb), 0.5, np.float32),
                "stress": np.zeros((B,), np.float32)}


TINY = Alphafold2Config(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)


def stub_engine(**kwargs):
    scfg = ServingConfig(buckets=(8, 16), max_batch=2, max_wait_s=0.01, mds_iters=2)
    return StubEngine({}, TINY, scfg, device="cpu", **kwargs)


def test_ops_server_over_an_engine_answers_every_endpoint(tmp_path):
    tracer = ttel.Tracer()
    rec = ttel.FlightRecorder(str(tmp_path / "flight"), tracer=tracer)
    eng = stub_engine(tracer=tracer, flights=ttel.FlightBook(), incident_hook=rec.incident)
    rec.bind(registry=eng.metrics.registry, stats_fn=eng.stats)
    slo = ttel.SloEngine(eng.metrics.registry, ttel.default_slo_config("serving"),
                         on_page=rec.slo_page_hook)
    ops = ttel.ops_server_for_engine(eng, tracer=tracer, slo=slo, recorder=rec,
                                     tick_interval_s=0.05)
    ops.add_tick(eng.sample_gauges)
    try:
        ops.start()
        req = eng.submit("ACDEFG", trace_id="f" * 16)
        req.result(timeout=30)
        ops.tick()
        base = ops.url
        code, body = get(base + "/metrics")
        assert code == 200
        parsed = ttel.parse_prometheus_text(body.decode())
        stats = eng.stats()
        assert parsed[("serving_requests_total", (("outcome", "completed"),))] == \
            stats["requests"]["completed"] == 1
        assert ("slo_burn_rate", (("objective", "availability"), ("window", "fast"))) in parsed
        code, body = get(base + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, body = get(base + "/statusz")
        status = json.loads(body)
        assert {"health", "metrics", "spans", "stats", "slo", "flight_recorder",
                "flights"} <= set(status)
        assert status["spans"]["serving.execute"]["count"] == 1
        code, body = get(base + f"/explainz?trace_id={'f' * 16}")
        flight = json.loads(body)
        assert code == 200 and flight["outcome"] == "completed"
        assert [e["event"] for e in flight["events"]] == ["submitted", "terminal"]
        assert get(base + "/explainz")[0] == 400
        assert get(base + "/explainz?trace_id=nope")[0] == 404
        assert get(base + "/profilez")[0] == 404  # no profiler wired
        code, body = get(base + "/threadz")
        assert code == 200 and any(t["name"] == "af2-serve" for t in json.loads(body)["threads"])
        assert get(base + "/nope")[0] == 404
        assert set(json.loads(get(base + "/")[1])["endpoints"]) >= {"/metrics", "/profilez"}
        eng.shutdown()
        code, body = get(base + "/healthz")
        assert code == 503 and json.loads(body)["status"] == "down"
    finally:
        eng.shutdown()
        ops.stop()


def test_profilez_is_bounded_rate_limited_and_waits_for_the_graph_lock(tmp_path):
    lock = threading.Lock()
    reg = ttel.MetricRegistry()
    prof = ttel.ProfileCapturer(str(tmp_path), registry=reg, max_duration_s=0.05,
                                min_interval_s=3600.0, lock=lock)
    ops = ttel.OpsServer(registry=reg, profiler=prof)
    try:
        ops.start()
        with lock:  # a capture or a replay holds the graph lock
            code, body = get(ops.url + "/profilez?duration_s=5")
            info = json.loads(body)
            assert code == 200 and info["status"] == "capturing"
            assert info["duration_s"] == 0.05  # clamped
            assert get(ops.url + "/profilez")[0] == 409  # busy: still waiting for the lock
            assert not (tmp_path / "profile-001" / "trace.json").exists()
        prof.close()
        assert json.load(open(info["trace"]))["traceEvents"] is not None
        assert get(ops.url + "/profilez")[0] == 429
        assert get(ops.url + "/profilez?duration_s=x")[0] == 400
        counters = reg.snapshot()["counters"]
        assert counters['profilez_captures_total{outcome="started"}'] == 1
        assert counters['profilez_captures_total{outcome="rejected_busy"}'] == 1
        assert counters['profilez_captures_total{outcome="rejected_rate_limited"}'] == 1
        snap = prof.snapshot()
        assert snap["running"] is None and "error" not in snap["captures"][0]
    finally:
        ops.stop()


def test_the_fleet_server_is_refused():
    """The fleet's server (refused naming A11b-3 until the fleet was
    ported) refuses an object that is not a fleet, as JAX's does; over a
    fleet it serves (tests/test_torch_fleet.py)."""
    with pytest.raises(AttributeError, match="registry"):
        ttel.ops_plane.ops_server_for_fleet(object())


# --------------------------------------------------------------- the CLIs


def test_serve_cli_telemetry_flags_write_their_outputs(tmp_path, capsys):
    from alphafold2_tpu_torch import serve

    out = {k: str(tmp_path / k) for k in ("stats.json", "trace.json", "batches.jsonl",
                                           "port", "flight")}
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"fast_window_s": 5, "slow_window_s": 10,
                               "objectives": [_shed()]}))
    rc = serve.main(["--demo", "8", "--buckets", "16,32", "--max-batch", "2", "--mds-iters", "4",
                     "--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8",
                     "--device", "cpu", "--stats-json", out["stats.json"], "--stats-interval",
                     "0.05", "--trace-out", out["trace.json"], "--metrics-jsonl",
                     out["batches.jsonl"], "--ops-port", "0", "--ops-port-file", out["port"],
                     "--ops-tick", "0.05", "--slo-config", str(slo), "--flight-dir",
                     out["flight"], "--peak-tflops", "1"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "ops plane listening on http://127.0.0.1:" in printed and "SLO:" in printed
    stats = json.load(open(out["stats.json"]))
    # 8 records and one repeat, which completes from the cache or coalesces
    assert stats["requests"]["completed"] + stats["requests"]["coalesced"] == 9
    assert stats["requests"]["failed"] == 0
    assert all("mfu" in c for c in stats["costs"]["cells"] if c["batches"])
    records = [json.loads(line) for line in open(out["batches.jsonl"])]
    assert len(records) == stats["batches"]["count"]
    assert {"batch_requests", "batch_shape", "batch_occupancy", "batch_latency_s"} <= \
        set(records[0])
    names = {e["name"] for e in json.load(open(out["trace.json"]))["traceEvents"]}
    assert {"serving.enqueue", "serving.queue_wait", "serving.batch", "serving.execute",
            "serving.respond", "serving_capture"} <= names
    assert int(open(out["port"]).read()) > 0


@pytest.mark.parametrize("argv, match", [
    (["--slo-config", "x.json"], "requires --ops-port"),
    (["--stats-interval", "1"], "requires --stats-json"),
    (["--ops-port-file", "p"], "requires --ops-port"),
    (["--replicas", "2", "--scale-grace", "5"], "--scale-grace requires --max-replicas"),
], ids=["slo_config", "stats_interval", "ops_port_file", "replicas"])
def test_serve_cli_refuses_flags_as_jax_does(argv, match, capsys):
    from alphafold2_tpu_torch import serve

    with pytest.raises(SystemExit):
        serve.main(["--demo", "2", "--device", "cpu"] + argv)
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("full_atom", [False, True], ids=["ca", "full_atom"])
def test_predict_cli_writes_its_trace(full_atom, tmp_path):
    from alphafold2_tpu_torch import predict

    trace_out = tmp_path / "trace.json"
    predict.main(["--seq", "MKTAYIAKQRQI", "--dim", "16", "--depth", "1", "--heads", "2",
                  "--dim-head", "8", "--mds-iters", "3", "--device", "cpu", "--out",
                  str(tmp_path / "p.pdb"), "--trace-out", str(trace_out)]
                 + (["--full-atom"] if full_atom else []))
    spans = [e for e in json.load(open(trace_out))["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["predict.forward", "predict.write_pdb"]
    assert all(e["args"]["length"] == 12 for e in spans)
    assert all(e["args"].get("full_atom", False) is full_atom for e in spans)
