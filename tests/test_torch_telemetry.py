"""The port's tracer, metric registry, metrics logger and profiling hooks
against the JAX package's (`alphafold2_tpu/telemetry/`), on the CPU: the
same sequence of calls and the same injected clock through both objects,
and the Prometheus text, its parse, the snapshots, the tracer's summary and
its Chrome and JSONL exports, and the logger's records (less the time
fields) are equal. No assertion reads a wall clock."""

import json

import numpy as np
import pytest
import torch

from alphafold2_tpu import telemetry as jtel
from alphafold2_tpu_torch import telemetry as ttel
from alphafold2_tpu_torch.telemetry import registry as treg
from alphafold2_tpu_torch.telemetry import trace


class Clock:
    """An injectable clock that moves only when told."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


PACKAGES = {"jax": jtel, "port": ttel}


# ------------------------------------------------------------------ tracer


def _trace_scenario(pkg, max_spans):
    """One tracer driven through nesting, attributes, a retro-recorded span,
    both trace bindings, an error and (at a small bound) overflow."""
    clock = Clock()
    tr = pkg.Tracer(clock=clock, max_spans=max_spans)
    with tr.span("serving.batch", cat="serving", bucket=16, n=2) as sp:
        clock.advance(0.25)
        with tr.bind_trace(["a" * 16, "b" * 16]):
            with tr.span("serving.execute", cat="serving", dispatch=0):
                clock.advance(1.5)
        sp.set("late", True)
    with tr.bind_trace("c" * 16):
        with tr.span("serving.enqueue", cat="serving", length=7):
            clock.advance(0.125)
        assert tr.current_trace_id() == "c" * 16
    tr.add("serving.queue_wait", 0.75, cat="serving", bucket=16, trace_id="d" * 16)
    with pytest.raises(KeyError):
        with tr.span("train.step", cat="train", step=3):
            clock.advance(2.0)
            raise KeyError("boom")
    for i in range(3):
        with tr.span("train.fetch", cat="train", step=i):
            clock.advance(0.5 * (i + 1))
    return tr


@pytest.mark.parametrize("max_spans", [100, 4], ids=["kept", "dropped"])
def test_tracer_summary_and_exports_match_jax(max_spans, tmp_path):
    j, t = (_trace_scenario(PACKAGES[k], max_spans) for k in ("jax", "port"))
    assert t.summary() == j.summary()
    assert t.chrome_trace() == j.chrome_trace()
    assert t.dropped == j.dropped == (4 if max_spans == 4 else 0)
    paths = []
    for name, tr in (("jax", j), ("port", t)):
        path = tmp_path / f"{name}.jsonl"
        tr.export_jsonl(str(path))
        paths.append([json.loads(line) for line in path.read_text().splitlines()])
    assert paths[0] == paths[1]
    chrome = tmp_path / "port.json"
    t.export_chrome(str(chrome))
    assert json.loads(chrome.read_text()) == j.chrome_trace()


def test_disabled_tracer_is_the_shared_no_op():
    spans = {id(trace.NULL_TRACER.span("x", cat="y", k=1)) for _ in range(3)}
    assert spans == {id(trace._NULL_SPAN)}
    with trace.NULL_TRACER.span("x") as sp, trace.NULL_TRACER.bind_trace("abc"):
        sp.set("k", 1)
    trace.NULL_TRACER.add("x", 1.0)
    assert trace.NULL_TRACER.spans() == [] and trace.NULL_TRACER.summary() == {}
    ids = {trace.new_trace_id() for _ in range(64)}
    assert len(ids) == 64 and all(len(i) == 16 for i in ids)
    with pytest.raises(ValueError):
        ttel.Tracer(max_spans=0)


# ---------------------------------------------------------------- registry


def _registry_scenario(pkg):
    reg = pkg.MetricRegistry(histogram_window=8)
    reg.counter("serving_requests_total", help="request-terminal outcomes",
                outcome="submitted").inc(3)
    reg.counter("serving_requests_total", outcome="failed").inc()
    reg.counter("serving_requests_total", outcome="submitted").inc(-1)
    reg.gauge("serve_batch_pad_ratio", help="padded / live").set(0.375)
    reg.gauge("serving_weight_bytes", tag='a"b\\c\nd', weight_dtype="int8").set(12345)
    reg.gauge("depth").inc(2.5)
    h = reg.histogram("serving_request_latency_seconds", help="latency", bucket="64")
    for v in (0.001, 0.02, 0.3, 0.3, 4.0, 200.0, 0.0, 7.5, 11.0, 0.05):
        h.observe(v)
    reg.histogram("empty_seconds")
    return reg


def test_registry_exposition_parse_and_snapshots_match_jax():
    j, t = _registry_scenario(jtel), _registry_scenario(ttel)
    text = t.to_prometheus()
    assert text == j.to_prometheus()
    assert ttel.parse_prometheus_text(text) == jtel.parse_prometheus_text(text)
    parsed = ttel.parse_prometheus_text(text)
    assert parsed[("serving_request_latency_seconds_bucket",
                   (("bucket", "64"), ("le", "+Inf")))] == 10
    assert parsed[("serving_weight_bytes", (("tag", 'a"b\\c\nd'),
                                            ("weight_dtype", "int8")))] == 12345
    assert t.snapshot() == j.snapshot()
    assert ttel.flatten_snapshot(t.snapshot()) == jtel.flatten_snapshot(j.snapshot())
    nested = {"a": {"b": 1, "c": True, "d": {"e": 2.5}}, "f": "text", "g": [1]}
    assert ttel.flatten_snapshot(nested, "x") == jtel.flatten_snapshot(nested, "x")
    assert {n: kind for n, (kind, _) in t.collect().items()} == \
        {n: kind for n, (kind, _) in j.collect().items()}


@pytest.mark.parametrize("bound", [0.005, 1.0, 2.5, 120.0, 1e-9, 12345678.9, float("inf")])
def test_format_le_matches_jax(bound):
    from alphafold2_tpu.telemetry.registry import format_le

    assert treg.format_le(bound) == format_le(bound)


def test_histogram_buckets_are_cumulative_and_match_jax():
    from alphafold2_tpu.telemetry.registry import Histogram

    bounds = (0.1, 1.0, 10.0)
    j, t = Histogram(window=4, bounds=bounds), treg.Histogram(window=4, bounds=bounds)
    for v in (0.05, 0.1, 0.5, 3.0, 30.0, 1.0):
        j.observe(v)
        t.observe(v)
    assert t.exposition() == j.exposition()
    assert t.snapshot() == j.snapshot()
    assert list(t.buckets().values()) == [2, 4, 5, 6]
    with pytest.raises(ValueError):
        treg.Histogram(bounds=(1.0, 0.5))


def test_disabled_registry_is_a_no_op():
    reg = ttel.NULL_REGISTRY
    c = reg.counter("x_total", k="v")
    assert c is reg.gauge("y") is reg.histogram("z")
    c.inc(5)
    c.set(3)
    c.observe(1.0)
    assert c.value == 0.0 and c.percentile(50) == 0.0 and c.snapshot() == {}
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert reg.to_prometheus() == "" and reg.collect() == {}


@pytest.mark.parametrize("call", [
    lambda r: r.counter("bad name"),
    lambda r: r.counter("ok_total", **{"bad-label": "x"}),
    lambda r: (r.counter("flip"), r.gauge("flip")),
], ids=["name", "label", "type_flip"])
def test_registry_refusals_match_jax(call):
    for pkg in (jtel, ttel):
        with pytest.raises(ValueError):
            call(pkg.MetricRegistry())


def test_parse_prometheus_text_refuses_what_jax_refuses():
    for pkg in (jtel, ttel):
        with pytest.raises(ValueError, match="unparseable"):
            pkg.parse_prometheus_text("# HELP x y\nx{a=\"1\"\n")


# ------------------------------------------------------------------ logger


def _log_scenario(logger, tensor):
    logger.log(0, {"loss": tensor(2.5, "f32"), "grad_norm": tensor(0.125, "bf16"), "n": 3})
    logger.log(0, {"eval_loss": tensor(1.75, "f32")})
    logger.event(1, "restart", error="ValueError", restart=1, causes=[{"step": 1}])
    logger.log(2, {"loss": tensor(2.25, "f32"), "count": tensor(7, "i32"), "x": 0.1})
    logger.log(10, {"loss": 1.0})


def _jax_tensor(v, kind):
    import jax.numpy as jnp

    return jnp.asarray(v, {"f32": jnp.float32, "bf16": jnp.bfloat16, "i32": jnp.int32}[kind])


def _torch_tensor(v, kind):
    return torch.tensor(v, dtype={"f32": torch.float32, "bf16": torch.bfloat16,
                                  "i32": torch.int32}[kind])


def _records(path):
    out = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("steps_per_sec", None)  # a time field
        out.append(rec)
    return out


@pytest.mark.parametrize("process_index", [None, 3])
def test_metrics_logger_records_match_jax(process_index, tmp_path, monkeypatch, capsys):
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with jtel.MetricsLogger(jpath, print_every=5, process_index=process_index) as j:
        _log_scenario(j, _jax_tensor)
    jout = capsys.readouterr().out

    def no_item(self):
        raise AssertionError("the logger fetched a tensor scalar by scalar")

    monkeypatch.setattr(torch.Tensor, "item", no_item)
    with ttel.MetricsLogger(tpath, print_every=5, process_index=process_index) as t:
        _log_scenario(t, _torch_tensor)
        tail = t.tail(2)
    tout = capsys.readouterr().out
    assert _records(tpath) == _records(jpath)
    assert [ln for ln in tout.splitlines() if "steps_per_sec" not in ln] == \
        [ln for ln in jout.splitlines() if "steps_per_sec" not in ln]
    assert [r["step"] for r in tail] == [2, 10]
    t.close()  # idempotent


def test_metrics_logger_reduces_and_refuses_like_jax(tmp_path):
    t = ttel.MetricsLogger(None)
    with pytest.warns(UserWarning, match="'v' has shape"):
        vals = t.log(1, {"v": torch.tensor([1.0, 2.0, 4.0])})
    assert vals["v"] == pytest.approx(7.0 / 3.0)
    with pytest.raises(ValueError, match="empty"):
        t.log(2, {"e": torch.zeros(0)})
    for pkg in (jtel, ttel):
        assert pkg.per_process_metrics_path("/a/m.jsonl", 0) == "/a/m.jsonl"
        assert pkg.per_process_metrics_path("/a/m.jsonl", 2) == "/a/m.p2.jsonl"


# ------------------------------------------------------------------- hooks


def _tracked(pkg, fail):
    reg = pkg.MetricRegistry()
    tr = pkg.Tracer()
    tracker = pkg.CompileTracker(reg, tracer=tr, prefix="serving_capture")
    with tracker.track(bucket="16"):
        pass
    if fail:
        with pytest.raises(RuntimeError):
            with tracker.track(bucket="32"):
                raise RuntimeError("capture failed")
    return reg, tr


@pytest.mark.parametrize("fail", [False, True], ids=["built", "failed"])
def test_compile_tracker_records_what_jax_records(fail):
    (jreg, jtr), (treg_, ttr) = _tracked(jtel, fail), _tracked(ttel, fail)
    jsnap, tsnap = jreg.snapshot(), treg_.snapshot()
    assert tsnap["counters"] == jsnap["counters"]
    assert sorted(tsnap["gauges"]) == sorted(jsnap["gauges"])
    assert [(s["name"], s["cat"], s["attrs"]) for s in ttr.spans()] == \
        [(s["name"], s["cat"], s["attrs"]) for s in jtr.spans()]


def test_memory_and_flops_gauges():
    from alphafold2_tpu.models import Alphafold2Config as JaxConfig

    from alphafold2_tpu_torch.models.config import Alphafold2Config

    reg = ttel.MetricRegistry()
    host = ttel.host_memory_gauges(reg)
    assert set(host) == {"rss_bytes", "peak_rss_bytes"} and host["peak_rss_bytes"] > 0
    # a process that never brought the card up reports no device memory
    assert ttel.device_memory_gauges(reg) is None
    kw = dict(dim=32, depth=2, heads=2, dim_head=16)
    jreg = jtel.MetricRegistry()
    assert ttel.flops_gauges(reg, Alphafold2Config(**kw), 64, 8, 64, grad_accum=2) == \
        jtel.flops_gauges(jreg, JaxConfig(**kw), 64, 8, 64, grad_accum=2)
    assert reg.snapshot()["gauges"]["model_forward_flops"] == \
        jreg.snapshot()["gauges"]["model_forward_flops"]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with ttel.profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert events
    with ttel.profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


# ----------------------------------------------------------------- package


def test_the_package_exports_jax_names_less_the_fleet_and_multi_process():
    left_out = {"MetricFederation", "FederatedRegistryView", "relabeled_exposition"}
    assert set(ttel.__all__) == set(jtel.__all__) - left_out
    for name in ttel.__all__:
        assert getattr(ttel, name) is not None


def test_telemetry_args_and_trace_export_match_jax(tmp_path, capsys):
    import argparse

    parsers = []
    for pkg in (jtel, ttel):
        ap = argparse.ArgumentParser()
        pkg.add_telemetry_args(ap)
        parsers.append(ap)
    assert [(a.dest, a.default, a.help) for a in parsers[1]._actions] == \
        [(a.dest, a.default, a.help) for a in parsers[0]._actions]
    off = parsers[1].parse_args([])
    assert ttel.tracer_from_args(off) is ttel.NULL_TRACER
    out = str(tmp_path / "t.json")
    args = parsers[1].parse_args(["--trace-out", out, "--trace-max-spans", "2"])
    tr = ttel.tracer_from_args(args)
    for _ in range(3):
        with tr.span("x"):
            pass
    ttel.finish_trace(tr, args)
    assert "(2 span(s), 1 dropped)" in capsys.readouterr().out
    doc = json.load(open(out))
    assert doc["otherData"] == {"dropped_spans": 1}
    assert np.isfinite(doc["traceEvents"][-1]["dur"])
