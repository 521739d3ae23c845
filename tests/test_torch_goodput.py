"""The port's training observability plane against the JAX package's
(`alphafold2_tpu/telemetry/goodput.py`, `training/resilience.py`), on the
CPU: the ledgers, the straggler detector and the supervised loop take the
same calls and the same injected clock in both packages and agree exactly;
then the trainers' CLIs with the telemetry flags. No assertion reads a wall
clock."""

import argparse
import json
import urllib.request

import numpy as np
import pytest
import torch

from alphafold2_tpu import telemetry as jtel
from alphafold2_tpu.telemetry import goodput as jgood
from alphafold2_tpu_torch import telemetry as ttel
from alphafold2_tpu_torch.telemetry import goodput as tgood

SMALL = ["--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8", "--device", "cpu"]


class Clock:
    def __init__(self, t=10.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _ledger_scenario(mod, pkg):
    clock = Clock()
    reg = pkg.MetricRegistry()
    led = mod.GoodputLedger(reg, clock=clock)
    led.set_workload(2.0e12, peak_flops=989e12)
    for step in range(3):
        with led.account("data_fetch"):
            clock.advance(0.125)
        with led.account(led.step_bucket()):
            clock.advance(1.0 if step == 0 else 0.25)
            with led.account("assembly"):  # exclusive time: taken from the step
                clock.advance(0.0625)
        led.step_complete(step)
        clock.advance(0.03125)  # idle
        if step == 1:
            with led.account("checkpoint"):
                clock.advance(0.5)
            with led.account("eval"):
                clock.advance(0.25)
    led.publish()
    return led, reg, clock


def test_goodput_ledger_matches_jax():
    (j, jreg, jc), (t, treg, tc) = (_ledger_scenario(jgood, jtel),
                                    _ledger_scenario(tgood, ttel))
    assert t.snapshot() == j.snapshot()
    assert t.totals() == j.totals()
    assert sum(t.totals().values()) == pytest.approx(t.wall(), abs=1e-9)
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert t.health(horizon_s=0.1) == j.health(horizon_s=0.1)
    assert t.health()["status"] == "ok"
    jc.advance(1.0)
    tc.advance(1.0)
    assert t.health(horizon_s=0.5) == j.health(horizon_s=0.5)
    assert t.health(horizon_s=0.5)["status"] == "down"
    assert t.mfu() == j.mfu() and t.badput() == j.badput()
    with pytest.raises(ValueError):
        with t.account("idle"):
            pass


class Recorder:
    def __init__(self):
        self.incidents = []

    def incident(self, kind, **attrs):
        self.incidents.append((kind, attrs))


def _detector_scenario(mod, pkg):
    reg, rec = pkg.MetricRegistry(), Recorder()
    det = mod.StragglerDetector(recorder=rec, registry=reg, patience=2, min_seconds=0.01)
    for step, (fetch, run) in enumerate([(0.5, 0.1), (0.6, 0.1), (0.7, 0.1), (0.01, 0.1),
                                         (0.5, 0.1), (0.5, 0.1)]):
        det.observe_local(step, fetch_s=fetch, step_s=run)
    return reg, rec


def test_straggler_detector_matches_jax():
    (jreg, jrec), (treg, trec) = (_detector_scenario(jgood, jtel),
                                  _detector_scenario(tgood, ttel))
    assert trec.incidents == jrec.incidents
    assert [k for k, _ in trec.incidents] == ["train_data_stall", "train_data_stall"]
    assert treg.to_prometheus() == jreg.to_prometheus()
    for kwargs in ({"stall_fraction": 1.0}, {"patience": 0}):
        with pytest.raises(ValueError):
            tgood.StragglerDetector(**kwargs)


@pytest.mark.parametrize("world, argv", [(2, ["--flight-dir", "x"]),
                                         (1, ["--federate-every", "10"])],
                         ids=["two_processes", "federate_every"])
def test_more_than_one_process_is_refused(monkeypatch, world, argv):
    monkeypatch.setattr(tgood, "process_topology", lambda: (0, world))
    ap = argparse.ArgumentParser()
    ttel.add_observability_args(ap)
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        ttel.build_train_telemetry(ap.parse_args(argv), registry=ttel.MetricRegistry())


def test_observability_flags_match_jax_less_multi_process_help():
    parsers = []
    for pkg in (jtel, ttel):
        ap = argparse.ArgumentParser()
        pkg.add_observability_args(ap)
        parsers.append(ap)
    # --federate-every is the multi-process federation: unset here, and set it raises (A13)
    assert [(a.dest, None if a.dest == "federate_every" else a.default, a.type)
            for a in parsers[1]._actions] == \
        [(a.dest, None if a.dest == "federate_every" else a.default, a.type)
         for a in parsers[0]._actions]
    assert parsers[1].parse_args([]).federate_every is None
    for argv, on in (([], False), (["--ops-port", "0"], True), (["--flight-dir", "d"], True)):
        args = parsers[1].parse_args(argv)
        assert ttel.observability_enabled(args) is on
        assert jtel.observability_enabled(parsers[0].parse_args(argv)) is on


def test_build_train_telemetry_null_and_full_plane(tmp_path):
    ap = argparse.ArgumentParser()
    ttel.add_observability_args(ap)
    off = ttel.build_train_telemetry(ap.parse_args([]), registry=ttel.NULL_REGISTRY)
    assert off is ttel.NULL_TRAIN_TELEMETRY
    assert off.step_bucket() == "step" and off.account("step") is not None
    port_file = tmp_path / "port"
    args = ap.parse_args(["--ops-port", "0", "--ops-port-file", str(port_file),
                          "--flight-dir", str(tmp_path / "flight"), "--peak-tflops", "1"])
    reg = ttel.MetricRegistry()
    logger = ttel.MetricsLogger(None)
    tel = ttel.build_train_telemetry(args, registry=reg, logger=logger, step_flops=1e9)
    try:
        with tel.account("step"):
            pass
        tel.step_complete(0)
        logger.log(0, {"loss": 1.5})
        base = f"http://127.0.0.1:{int(port_file.read_text())}"
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            assert r.status == 200 and json.loads(r.read())["steps"] == 1
        with urllib.request.urlopen(base + "/statusz", timeout=5) as r:
            status = json.loads(r.read())
        assert status["stats"]["loss_tail"] == [{"step": 0, "loss": 1.5}]
        assert status["stats"]["goodput"]["steps"] == 1
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            parsed = ttel.parse_prometheus_text(r.read().decode())
        assert parsed[("train_steps_total", ())] == 1.0
        assert "flight_recorder" in status
    finally:
        tel.close()
    assert tel.ops is None


# ------------------------------------------------------ the supervised loop


def _jax_host_step(clock):
    def step(state, batch, rng=None):
        clock.advance(0.5)
        return ({"step": np.int32(int(state["step"]) + 1), "w": state["w"] + np.float32(0.5)},
                {"loss": np.float32(0.1), "grad_norm": np.float32(0.2)})
    return step


class _Optimizer:
    """What `StepGuard` snapshots: the tensors a step updates."""

    def __init__(self, w):
        self.w = w

    def state_tensors(self):
        return [self.w]


def _port_host_step(clock):
    def step(state, batch, rng=None):
        clock.advance(0.5)
        state["optimizer"].w += 0.5
        state["step"] += 1
        return state, {"loss": torch.tensor(0.1), "grad_norm": torch.tensor(0.2)}
    return step


def _supervised(pkg, fault_plan, tmp_path, name):
    """One supervised run of 5 steps (3 s of fetch and 0.5 s a step on the
    injected clock), a fault plan injected, under a tracer, a ledger and a
    logger on that clock."""
    if pkg is jtel:
        from alphafold2_tpu.reliability import FaultPlan
        from alphafold2_tpu.training import run_resilient, with_fault_injection
    else:
        from alphafold2_tpu_torch.reliability.faults import FaultPlan
        from alphafold2_tpu_torch.training.harness import with_fault_injection
        from alphafold2_tpu_torch.training.resilience import run_resilient
    clock = Clock()
    tracer = pkg.Tracer(clock=clock)
    reg = pkg.MetricRegistry()
    ledger = (jgood if pkg is jtel else tgood).GoodputLedger(reg, clock=clock)
    tel = pkg.TrainTelemetry(ledger=ledger)
    path = str(tmp_path / f"{name}.jsonl")
    logger = pkg.MetricsLogger(path)
    if pkg is jtel:
        step, state = _jax_host_step(clock), {"step": np.int32(0), "w": np.float32(1.0)}
    else:
        step = _port_host_step(clock)
        state = {"step": 0, "optimizer": _Optimizer(torch.tensor(1.0))}
    injector = FaultPlan.from_dict({"faults": fault_plan}).injector()

    def fetch(i):
        clock.advance(0.125)
        return {"x": np.float32(i)}

    run_resilient(with_fault_injection(step, injector), state, fetch, steps=5,
                  make_rng=lambda i: None, max_restarts=2, logger=logger, tracer=tracer,
                  telemetry=tel, on_metrics=logger.log)
    logger.close()
    records = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("steps_per_sec", None)
        records.append(rec)
    spans = [(s["name"], s["cat"], s["ts_s"], s["dur_s"], s["depth"], s["attrs"])
             for s in tracer.spans()]
    return ledger.snapshot(), reg.to_prometheus(), spans, records


@pytest.mark.parametrize("faults", [
    [],
    [{"kind": "step_exception", "at": 2}],
    [{"kind": "nan_grads", "at": 1}],
], ids=["clean", "step_exception", "nan_grads"])
def test_run_resilient_spans_goodput_and_events_match_jax(faults, tmp_path):
    j = _supervised(jtel, faults, tmp_path, "j")
    t = _supervised(ttel, faults, tmp_path, "t")
    assert t[0] == j[0]   # the ledger: compile for step 0, then step, restore
    assert t[1] == j[1]   # its metrics
    assert t[2] == j[2]   # the spans: train.fetch / step / metrics_fetch / restore
    assert t[3] == j[3]   # the logger: losses, restart events, the summary
    assert t[0]["steps"] == 5 and t[0]["buckets"]["compile"] > 0
    if faults and faults[0]["kind"] == "step_exception":
        assert any(r.get("event") == "restart" for r in t[3])
        assert t[0]["buckets"]["restore"] >= 0


# ------------------------------------------------------------- the CLIs


def _jsonl(path):
    return [json.loads(line) for line in open(path)]


def test_train_pre_cli_telemetry_flags_write_their_outputs(tmp_path, capsys):
    from alphafold2_tpu_torch import train_pre

    base = SMALL + ["--steps", "4", "--len", "16", "--accum", "2"]
    _, plain = train_pre.main(base)
    log, trace_out = tmp_path / "m.jsonl", tmp_path / "trace.json"
    _, metrics = train_pre.main(base + [
        "--metrics-log", str(log), "--eval-every", "2", "--trace-out", str(trace_out),
        "--ops-port", "0", "--flight-dir", str(tmp_path / "flight")])
    out = capsys.readouterr().out
    # telemetry changes no number
    assert torch.equal(metrics["loss"], plain["loss"])
    records = _jsonl(log)
    assert [r["step"] for r in records] == [0, 1, 2, 3]
    assert [("eval_loss" in r) for r in records] == [False, True, False, True]
    names = {e["name"] for e in json.load(open(trace_out))["traceEvents"]}
    assert {"train.fetch", "train.step", "train.metrics_fetch", "train.eval",
            "train_compile"} <= names
    sidecar = json.load(open(str(trace_out) + ".metrics.json"))
    assert sidecar["gauges"]["model_train_step_flops"] > 0
    assert "trainer ops plane on http://127.0.0.1:" in out and "goodput" in out


def test_train_pre_resilient_loop_logs_and_traces(tmp_path):
    from alphafold2_tpu_torch import train_pre

    log, trace_out = tmp_path / "m.jsonl", tmp_path / "trace.json"
    train_pre.main(SMALL + ["--steps", "3", "--len", "16", "--accum", "2", "--max-restarts",
                            "1", "--metrics-log", str(log), "--trace-out", str(trace_out)])
    records = _jsonl(log)
    assert [r["step"] for r in records if "loss" in r] == [0, 1, 2]
    assert records[-1]["event"] == "resilience_summary"
    names = [e["name"] for e in json.load(open(trace_out))["traceEvents"]]
    assert names.count("train.step") == 3


def test_train_end2end_cli_telemetry_flags_write_their_outputs(tmp_path):
    from alphafold2_tpu_torch import train_end2end

    base = SMALL + ["--steps", "3", "--len", "8", "--mds-iters", "5"]
    _, plain = train_end2end.main(base)
    log, trace_out, prof = tmp_path / "m.jsonl", tmp_path / "trace.json", tmp_path / "prof"
    _, metrics = train_end2end.main(base + [
        "--metrics-jsonl", str(log), "--eval-every", "2", "--trace-out", str(trace_out),
        "--profile-dir", str(prof), "--profile-steps", "1"])
    assert torch.equal(metrics["loss"], plain["loss"])
    records = _jsonl(log)
    assert [r["step"] for r in records] == [0, 1, 1, 2]
    assert set(records[2]) == {"step", "rmsd", "gdt_ts", "gdt_ha", "tm"}
    assert json.load(open(prof / "trace.json"))["traceEvents"]
    names = {e["name"] for e in json.load(open(trace_out))["traceEvents"]}
    assert {"train.fetch", "train.step", "train.metrics_fetch", "train.eval"} <= names


def test_trainer_clis_refuse_more_than_one_process(monkeypatch, tmp_path):
    from alphafold2_tpu_torch import train_end2end, train_pre

    monkeypatch.setattr(tgood, "process_topology", lambda: (1, 4))
    for main, extra in ((train_pre.main, ["--len", "16", "--accum", "2"]),
                        (train_end2end.main, ["--len", "8", "--mds-iters", "5"])):
        with pytest.raises(NotImplementedError, match="ROADMAP A13"):
            main(SMALL + ["--steps", "1", "--ops-port", "0"] + extra)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_structure_eval_matches_jax(masked):
    """train_end2end's eval scores against the JAX package's
    `structure_eval` on the same clouds (f32; 1e-5, the Kabsch SVD's
    summation order)."""
    from alphafold2_tpu.utils.observability import structure_eval as jax_eval

    from alphafold2_tpu_torch.geometry.metrics import structure_eval

    rng = np.random.default_rng(3)
    true = np.cumsum(rng.normal(0, 2.0, (2, 42, 3)), axis=1).astype(np.float32)
    pred = (true + rng.normal(0, 1.5, true.shape)).astype(np.float32)
    mask = (rng.random((2, 42)) > 0.2) if masked else None
    got = structure_eval(torch.from_numpy(pred), torch.from_numpy(true),
                         mask=None if mask is None else torch.from_numpy(mask))
    want = jax_eval(pred, true, mask=mask)
    assert set(got) == set(want) == {"rmsd", "gdt_ts", "gdt_ha", "tm"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
