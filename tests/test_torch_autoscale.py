"""The port's replica autoscaler (alphafold2_tpu_torch/serving/autoscale.py)
against the JAX package's (alphafold2_tpu/serving/autoscale.py) on the CPU.

  (a) the decision matrix of tests/test_autoscale.py (queue-wait, burn,
      occupancy and headroom triggers, the idle hysteresis window, the
      bounds, a refused scale-down, the incident hook, a `scale_flap` plan
      through each package's own `FaultInjector`, pool-scoped scalers):
      both packages' `ReplicaAutoscaler` drive identical stub fleets on
      the same scripted clock and registry signals, and must take the
      same decisions and record the same events;
  (b) `add_replica` / `remove_replica` through the health monitor's drain
      path on real tiny CPU engines: nothing lost, the retired replica
      leaves the pool; a real fleet's per-pool scalers in its stats;
  (c) the verify skill's autoscaler recipe (flow 13: the featurize tier,
      the autoscaler under `docs/examples/disagg_chaos_plan.json`) and
      its pools recipe (flow 16: a dense pool beside an `sp_shards` pool,
      a per-pool autoscaler each) through the port's CLI with
      `--device cpu`, asserting the skill's invariants.

Every wait is bounded; the matrix never sleeps (an injected clock)."""

import json
import time
import types

import numpy as np
import pytest
import torch

from alphafold2_tpu.reliability import faults as jfaults
from alphafold2_tpu.serving import autoscale as jautoscale
from alphafold2_tpu.serving.errors import ScaleRejectedError as JaxScaleRejected
from alphafold2_tpu.telemetry import MetricRegistry as JaxRegistry
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_init
from alphafold2_tpu_torch.constants import AA_ORDER
from alphafold2_tpu_torch.reliability import faults as tfaults
from alphafold2_tpu_torch.serving import autoscale as tautoscale
from alphafold2_tpu_torch.serving.engine import ServingConfig
from alphafold2_tpu_torch.serving.errors import ScaleRejectedError
from alphafold2_tpu_torch.serving.fleet import FleetConfig, PoolSpec, ServingFleet
from alphafold2_tpu_torch.telemetry import MetricRegistry

WAIT = 60  # seconds: the bound of every wait
PKGS = {
    "jax": types.SimpleNamespace(autoscale=jautoscale, faults=jfaults, Registry=JaxRegistry,
                                 Rejected=JaxScaleRejected),
    "torch": types.SimpleNamespace(autoscale=tautoscale, faults=tfaults,
                                   Registry=MetricRegistry, Rejected=ScaleRejectedError),
}


def seq_of(length, offset=0):
    return "".join(AA_ORDER[(offset + i) % len(AA_ORDER)] for i in range(length))


# --- (a) the decision matrix, both packages ---------------------------------------


class StubFleet:
    """A scaling target that counts replicas a pool, records actions, and
    can refuse a scale-down (tests/test_autoscale.py's StubFleet and
    PooledStubFleet in one)."""

    _closed = False

    def __init__(self, pkg, registry, counts=None, refuse_down=None):
        self.pkg, self.registry = pkg, registry
        self.counts = dict(counts or {"": 1})
        self.actions, self.counted_errors = [], []
        self.refuse_down = refuse_down

    def sample_gauges(self):
        pass

    def replica_count(self, pool=None):
        return sum(self.counts.values()) if pool is None else self.counts[pool]

    def add_replica(self, pool=None):
        key = pool if pool is not None else ""
        self.counts[key] += 1
        self.actions.append(("up", key))
        return f"r{sum(self.counts.values()) - 1}"

    def remove_replica(self, name=None, pool=None):
        if self.refuse_down is not None:
            raise self.pkg.Rejected(self.refuse_down)
        key = pool if pool is not None else ""
        self.counts[key] -= 1
        self.actions.append(("down", key))
        return f"r{sum(self.counts.values())}"

    def _count_error(self, exc):
        self.counted_errors.append(exc.code)


class Run:
    """One package's scaler(s) over a stub fleet, an injected clock and a
    fresh registry; `transcript()` is what the two packages must agree on."""

    def __init__(self, pkg, pools=("",), counts=None, refuse_down=None, flap=None, **policy):
        self.pkg = pkg
        self.registry = pkg.Registry()
        self.fleet = StubFleet(pkg, self.registry, counts or {p: 1 for p in pools},
                               refuse_down)
        base = dict(min_replicas=1, max_replicas=3, up_sustain=2, down_sustain=2,
                    up_cooldown_s=1.0, down_cooldown_s=5.0)
        base.update(policy)
        self.t = [0.0]
        self.incidents = []
        self.injector = None
        if flap is not None:
            F = pkg.faults
            self.injector = F.FaultPlan(faults=(F.Fault("scale_flap", **flap),)).injector()
        self.scalers = {
            p: pkg.autoscale.ReplicaAutoscaler(
                self.fleet, pkg.autoscale.ScalePolicy(**base), registry=self.registry,
                clock=lambda: self.t[0], pool=p,
                fault_hook=self.injector.autoscale_hook() if self.injector else None,
                incident_hook=lambda kind, **a: self.incidents.append((kind, a)))
            for p in pools}

    def gauge(self, name, value, **labels):
        self.registry.gauge(name, **labels).set(value)

    def waits(self, value, n=8, **labels):
        hist = self.registry.histogram(
            "fleet_pool_queue_wait_seconds" if labels else "fleet_queue_wait_seconds", **labels)
        for _ in range(n):
            hist.observe(value)

    def tick(self, dt=0.0, pools=None):
        for p in pools or self.scalers:
            self.scalers[p].tick()
        self.t[0] += dt

    def transcript(self):
        return {
            "counts": dict(self.fleet.counts), "actions": list(self.fleet.actions),
            "counted_errors": list(self.fleet.counted_errors),
            "events": {p: s.events() for p, s in self.scalers.items()},
            "snapshots": {p: s.snapshot() for p, s in self.scalers.items()},
            "incidents": list(self.incidents),
            "delivered": list(self.injector.delivered) if self.injector else None,
            "exhausted": self.injector.exhausted() if self.injector else None,
            "counters": {k: v for k, v in self.registry.snapshot()["counters"].items()
                         if k.startswith("autoscale_")},
        }


def queue_wait(pkg):
    run = Run(pkg)
    run.waits(5.0)  # p95 far past the 2.0 s threshold
    run.gauge("fleet_queue_depth", 3)
    run.tick(1.0)  # sustain 1/2
    run.tick(1.0)  # 2/2: up
    return run


def burn_and_occupancy(pkg):
    run = Run(pkg, up_sustain=1)
    run.gauge("fleet_queue_depth", 1)
    run.gauge("slo_burn_rate", 3.0, objective="queue_wait_p95", window="fast")
    run.tick(2.0)  # the burn trigger, with a live queue
    run.gauge("fleet_queue_depth", 0)
    run.gauge("slo_burn_rate", 0.0, objective="queue_wait_p95", window="fast")
    run.gauge("fleet_occupancy", 0.95)
    run.tick(2.0)  # occupancy needs no queue
    return run


def burn_without_queue(pkg):
    run = Run(pkg, up_sustain=1)
    run.gauge("slo_burn_rate", 9.0, objective="x", window="fast")
    run.gauge("fleet_queue_depth", 0)
    run.tick()
    return run


def idle_hysteresis(pkg):
    run = Run(pkg, up_sustain=1, down_sustain=2)
    run.gauge("fleet_occupancy", 0.95)
    run.tick()  # up at t=0
    run.gauge("fleet_occupancy", 0.0)
    run.gauge("fleet_queue_depth", 0)
    for _ in range(4):  # idle, inside the 5 s window: suppressed
        run.t[0] += 0.5
        run.tick()
    run.t[0] = 10.0  # past down_cooldown_s
    run.tick()
    run.tick()
    return run


def scale_flap(pkg):
    """Forced alternating demands skip sustain but not the window."""
    run = Run(pkg, flap=dict(at=0, count=6), up_cooldown_s=2.0, down_cooldown_s=2.0,
              max_replicas=5)
    for _ in range(6):
        run.tick(0.5)
    return run


def bounds(pkg):
    run = Run(pkg, up_sustain=1, down_sustain=1, max_replicas=1, min_replicas=1,
              up_cooldown_s=0.0, down_cooldown_s=0.0)
    run.gauge("fleet_occupancy", 0.95)
    run.tick(1.0)  # at max: suppressed
    run.gauge("fleet_occupancy", 0.0)
    run.tick()  # at min: suppressed
    return run


def rejected_down(pkg):
    run = Run(pkg, counts={"": 2}, refuse_down="r1 is down — refusing", up_sustain=1,
              down_sustain=1, down_cooldown_s=0.0)
    run.gauge("fleet_queue_depth", 0)
    run.gauge("fleet_occupancy", 0.0)
    run.tick()
    return run


def headroom(pkg):
    """The capacity-model trigger: inert while the gauge is absent, then
    fires with an empty queue once headroom falls to the threshold."""
    run = Run(pkg, pools=("long",), up_sustain=1, up_headroom=0.2)
    run.tick(1.0)  # no gauge: nothing
    run.gauge("fleet_pool_headroom_ratio", 0.5, pool="long")
    run.tick(1.0)
    run.gauge("fleet_pool_headroom_ratio", 0.1, pool="long")
    run.tick(1.0)
    return run


def pools(pkg):
    """Two pool scalers over one registry: the saturated pool grows off its
    own signals while the idle one shrinks, the hot global families read
    by neither."""
    run = Run(pkg, pools=("short", "long"), counts={"short": 2, "long": 1}, up_sustain=2,
              down_sustain=2, up_cooldown_s=0.0, down_cooldown_s=0.0)
    run.gauge("fleet_queue_depth", 9)
    run.gauge("fleet_occupancy", 1.0)
    run.gauge("fleet_pool_queue_depth", 5, pool="long")
    run.gauge("fleet_pool_occupancy", 1.0, pool="long")
    run.waits(10.0, n=40, pool="long")
    run.gauge("fleet_pool_queue_depth", 0, pool="short")
    run.gauge("fleet_pool_occupancy", 0.0, pool="short")
    run.registry.histogram("fleet_pool_queue_wait_seconds", pool="short")
    for _ in range(3):
        run.tick(1.0)
    return run


SCENARIOS = {f.__name__: f for f in (queue_wait, burn_and_occupancy, burn_without_queue,
                                     idle_hysteresis, scale_flap, bounds, rejected_down,
                                     headroom, pools)}

# what each scenario must come to, beyond agreeing with JAX
EXPECT = {
    "queue_wait": lambda tr: tr["actions"] == [("up", "")],
    "burn_and_occupancy": lambda tr: tr["actions"] == [("up", ""), ("up", "")],
    "burn_without_queue": lambda tr: tr["actions"] == [],
    "idle_hysteresis": lambda tr: (tr["actions"] == [("up", ""), ("down", "")]
                                   and tr["snapshots"][""]["decisions"]["suppressed"] >= 1),
    "scale_flap": lambda tr: (tr["exhausted"] and tr["actions"]
                              and tr["snapshots"][""]["decisions"]["suppressed"] >= 1
                              and all(b["ts"] - a["ts"] >= 2.0 for a, b in zip(
                                  [e for e in tr["events"][""] if e["action"] in ("up", "down")],
                                  [e for e in tr["events"][""] if e["action"] in ("up", "down")][1:]))),
    "bounds": lambda tr: ({e.get("reason") for e in tr["events"][""]} == {"at_max", "at_min"}
                          and tr["actions"] == []),
    "rejected_down": lambda tr: (tr["counted_errors"] == ["scale_rejected"]
                                 and tr["snapshots"][""]["decisions"]["rejected"] == 1),
    "headroom": lambda tr: (tr["actions"] == [("up", "long")]
                            and tr["incidents"][0][0] == "scale_up"),
    "pools": lambda tr: (("up", "long") in tr["actions"] and ("down", "short") in tr["actions"]
                         and ("up", "short") not in tr["actions"]
                         and ("down", "long") not in tr["actions"]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_and_events_equal_jax(name):
    got = SCENARIOS[name](PKGS["torch"]).transcript()
    want = SCENARIOS[name](PKGS["jax"]).transcript()
    assert got == want
    assert EXPECT[name](got), got


def test_incident_hook_reports_scale_actions_as_jax():
    trs = {}
    for key, pkg in PKGS.items():
        run = Run(pkg, up_sustain=1)
        run.gauge("fleet_occupancy", 0.95)
        run.tick()
        trs[key] = run.incidents
    assert trs["torch"] == trs["jax"] and [k for k, _ in trs["torch"]] == ["scale_up"]


@pytest.mark.parametrize("bad", [{"max_replicaz": 3}, {"min_replicas": 3, "max_replicas": 2},
                                 {"up_occupancy": 0.2, "down_occupancy": 0.5},
                                 {"up_headroom": 1.0}, {"up_sustain": 0}])
def test_policy_validation_is_jax_validation(bad):
    errors = []
    for pkg in (PKGS["torch"], PKGS["jax"]):
        with pytest.raises(ValueError) as info:
            pkg.autoscale.ScalePolicy.from_dict(bad)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_policy_file_round_trip(tmp_path):
    p = tmp_path / "policy.json"
    p.write_text(json.dumps({"min_replicas": 2, "max_replicas": 5, "down_cooldown_s": 7.5}))
    got = tautoscale.ScalePolicy.from_file(str(p))
    want = jautoscale.ScalePolicy.from_file(str(p))
    import dataclasses

    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.min_replicas == 2 and got.down_cooldown_s == 7.5


# --- (b) real engines on the CPU ---------------------------------------------------


TINY = Alphafold2Config(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)


@pytest.fixture(scope="module")
def tiny_params():
    return alphafold2_init(TINY, torch.Generator().manual_seed(0), "cpu")


def fleet_of(params, **fleet):
    scfg = ServingConfig(buckets=(8, 16), max_batch=2, max_queue=16, max_wait_s=0.0,
                         request_timeout_s=WAIT, cache_capacity=0, mds_iters=2)
    base = dict(replicas=1, probe_interval_s=0, reprobe_interval_s=0.05, fail_threshold=1,
                requeue_limit=2)
    base.update(fleet)
    return ServingFleet(params, TINY, scfg, FleetConfig(**base), device="cpu")


def wait_until(cond, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    pytest.fail(f"{what} within {WAIT} s")


def test_add_and_remove_replica_through_the_drain_path(tiny_params):
    """A scale-up builds a real engine beside the serving one; a
    scale-down drains the victim (its queued work requeues onto the
    survivor), shuts it down, releases its graphs and unregisters it;
    nothing is lost, and the survivor's results equal the bare first
    round's."""
    fleet = fleet_of(tiny_params)
    try:
        first = {seq_of(5 + i % 4, offset=i): fleet.submit(seq_of(5 + i % 4, offset=i))
                 for i in range(6)}
        first = {s: r.result(timeout=WAIT) for s, r in first.items()}
        name = fleet.add_replica()
        assert name == "r1" and fleet.replica_count() == 2
        assert fleet.stats()["replicas"]["r1"]["engine"] is not None
        reqs = [fleet.submit(s) for s in list(first) * 2]
        removed = fleet.remove_replica()
        wait_until(lambda: fleet.replica_count() == 1
                   and removed not in fleet._health.snapshot()["targets"],
                   "the retired replica never left the pool")
        for req, seq in zip(reqs, list(first) * 2):
            res = req.result(timeout=WAIT)
            assert np.array_equal(res.coords, first[seq].coords)
        stats = fleet.stats()
        assert stats["requests"]["failed"] == 0 and stats["requests"]["in_flight"] == 0
        with pytest.raises(ScaleRejectedError, match="below one"):
            fleet.remove_replica()
    finally:
        fleet.shutdown(timeout=WAIT)


def test_an_armed_scaler_grows_and_shrinks_a_real_fleet(tiny_params):
    """The autoscaler's own ticks over a real CPU fleet: a forced scale_flap
    demand grows it, the idle tail shrinks it after the window; both
    acted events are spaced at least the cooldown apart, and the fleet's
    stats carry the scaler's snapshot."""
    fleet = fleet_of(tiny_params)
    inj = tfaults.FaultPlan(faults=(tfaults.Fault("scale_flap", at=0, count=1),)).injector()
    t = [0.0]
    scaler = tautoscale.ReplicaAutoscaler(
        fleet, tautoscale.ScalePolicy(max_replicas=2, up_cooldown_s=0.5, down_cooldown_s=1.0,
                                      down_sustain=2),
        clock=lambda: t[0], fault_hook=inj.autoscale_hook())
    try:
        scaler.tick()  # the forced "up"
        assert fleet.replica_count() == 2
        res = [fleet.submit(seq_of(6, offset=i)).result(timeout=WAIT) for i in range(4)]
        assert all(np.isfinite(r.coords).all() for r in res)
        for _ in range(4):  # idle: down once the window has passed
            t[0] += 0.5
            scaler.tick()
        wait_until(lambda: fleet.replica_count() == 1, "the idle scale-down")
        acted = scaler.scale_events()
        assert [e["action"] for e in acted] == ["up", "down"]
        assert acted[1]["ts"] - acted[0]["ts"] >= 1.0
        assert fleet.stats()["autoscale"]["decisions"]["up"] == 1
    finally:
        fleet.shutdown(timeout=WAIT)


def test_pool_scalers_surface_in_fleet_stats(tiny_params):
    fleet = ServingFleet(
        tiny_params, TINY,
        ServingConfig(buckets=(8, 16), max_batch=2, max_wait_s=0.0, cache_capacity=0,
                      mds_iters=2),
        FleetConfig(probe_interval_s=0, pools=(PoolSpec("short", buckets=(8,)),
                                               PoolSpec("long", buckets=(8, 16), sp_shards=2))),
        device="cpu", sp_devices=["cpu"] * 2)
    try:
        scalers = [tautoscale.ReplicaAutoscaler(fleet, tautoscale.ScalePolicy(max_replicas=2),
                                                pool=p) for p in ("short", "long")]
        for sc in scalers:
            sc.start(0.05)
        assert fleet.submit(seq_of(14)).result(timeout=WAIT).bucket == 16
        stats = fleet.stats()
        assert sorted(stats["autoscale_pools"]) == ["long", "short"]
        assert stats["autoscale_pools"]["long"]["pool"] == "long"
    finally:
        fleet.shutdown(timeout=WAIT)
    assert all(sc._thread is None for sc in scalers)


def test_a_probe_in_flight_does_not_reinstate_a_retired_target():
    """A replica retired while its first health probe is still running
    (an autoscaler's scale-down of a replica it just added, on a card whose
    lock the probe waits for) is drained and unregistered on the next
    tick; the probe's success does not bring it back. The JAX monitor
    reinstates it here (module docstring of reliability/health.py)."""
    import threading

    from alphafold2_tpu_torch.reliability.health import HealthMonitor

    entered, release = threading.Event(), threading.Event()
    drained = []

    def probe():
        entered.set()
        return release.wait(WAIT)

    mon = HealthMonitor(probe_interval_s=3600, reprobe_interval_s=0.05, fail_threshold=1)
    mon.register("r4", probe=probe, on_drain=lambda name, reason: drained.append(reason))
    ticker = threading.Thread(target=mon.tick)
    ticker.start()
    assert entered.wait(WAIT)  # the first probe is running
    mon.retire("r4", "scale_down")
    release.set()
    ticker.join(WAIT)
    assert mon.snapshot()["targets"]["r4"]["state"] == "down"
    mon.tick()
    assert drained == ["scale_down"] and "r4" not in mon.snapshot()["targets"]


# --- (c) the CLI recipes ------------------------------------------------------------


def test_cli_autoscaler_chaos_recipe(tmp_path, capsys):
    """Flow 13 through the port: the featurize tier and the autoscaler
    under the committed chaos plan (slow and killed featurize workers, a
    scale_flap), `--scale-grace` for the idle tail. rc 0, nothing lost, at
    least one scale-up and one scale-down with the acted events spaced at
    least the up cooldown apart, the worker death survived, a scale_up
    flight bundle, and the summary lines."""
    from alphafold2_tpu_torch import serve

    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps({"up_queue_wait_p95_s": 0.5, "up_occupancy": 0.5,
                                  "up_sustain": 1, "down_sustain": 2, "up_cooldown_s": 0.5,
                                  "down_cooldown_s": 2.0}))
    stats_path, flight = tmp_path / "d.json", tmp_path / "flight"
    rc = serve.main(["--device", "cpu", "--demo", "20", "--buckets", "16,32", "--dim", "16",
                     "--depth", "1", "--heads", "2", "--dim-head", "8", "--mds-iters", "2",
                     "--max-batch", "2", "--min-replicas", "1", "--max-replicas", "3",
                     "--featurize-workers", "2", "--scale-policy", str(policy),
                     "--scale-grace", "20", "--ops-tick", "0.2", "--reprobe-interval", "0.3",
                     "--fault-plan", "docs/examples/disagg_chaos_plan.json",
                     "--flight-dir", str(flight), "--stats-json", str(stats_path)])
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    stats = json.loads(stats_path.read_text())
    reqs = stats["requests"]
    assert reqs["failed"] == 0 and reqs["in_flight"] == 0 and reqs["completed"] >= 20
    dec = stats["autoscale"]["decisions"]
    assert dec["up"] >= 1 and dec["down"] >= 1, stats["autoscale"]
    acted = [e for e in stats["autoscale"]["events"] if e["action"] in ("up", "down")]
    assert all(b["ts"] - a["ts"] >= 0.5 for a, b in zip(acted, acted[1:]))
    assert stats["featurize"]["worker_deaths"] >= 1
    assert stats["featurize"]["requests"]["requeued"] >= 1
    assert "slow_featurize@0" in out and "scale_flap@2" in out
    assert list(flight.glob("incident-*-scale_up.json"))
    assert "featurize tier:" in out and "autoscaler: " in out and "scale-up(s)" in out


def test_cli_pools_recipe_with_an_sp_pool(tmp_path, capsys):
    """Flow 16 through the port: a dense pool and an `sp_shards` pool (two
    CPU shards, sp_seq forced at 32) with a per-pool autoscaler each, and
    a 48-mer past every pool's ceiling. The replay exits 1 for that one
    submit-time rejection (serve's exit code counts it), nothing else
    fails, and each routed length lands in its pool."""
    from alphafold2_tpu_torch import serve

    fasta = tmp_path / "mixed.fasta"
    lengths = [5, 9, 12, 16, 20, 24, 28, 32, 7, 30, 48]
    fasta.write_text("".join(f">q{i}_L{n}\n{seq_of(n, offset=i)}\n"
                             for i, n in enumerate(lengths)))
    stats_path = tmp_path / "p.json"
    pools = json.dumps([{"name": "short", "replicas": 1, "buckets": [8, 16]},
                        {"name": "long", "replicas": 1, "sp_shards": 2,
                         "buckets": [8, 16, 32], "sp_schedules": [[32, "sp_seq"]]}])
    rc = serve.main(["--device", "cpu", "--fasta", str(fasta), "--buckets", "8,16",
                     "--max-batch", "2", "--mds-iters", "4", "--dim", "16", "--depth", "1",
                     "--heads", "2", "--dim-head", "8", "--pools", pools,
                     "--min-replicas", "1", "--max-replicas", "2", "--scale-grace", "2",
                     "--stats-json", str(stats_path)])
    out = capsys.readouterr().out
    assert rc == 1, out[-3000:]
    stats = json.loads(stats_path.read_text())
    reqs = stats["requests"]
    assert reqs["failed"] == 0 and reqs["in_flight"] == 0
    assert stats["shed"] == {"too_long": 1} and stats["errors"] == {"sequence_too_long": 1}
    routed = {k: v for k, v in stats["telemetry"]["metrics"]["counters"].items()
              if k.startswith("fleet_routed_total")}
    assert routed['fleet_routed_total{pool="short"}'] == sum(1 for n in lengths if n <= 16)
    assert routed['fleet_routed_total{pool="long"}'] == sum(1 for n in lengths if 16 < n <= 32)
    long_reps = [r for r in stats["replicas"].values()
                 if r["pool"] == "long" and r["engine"] is not None]
    assert long_reps and all(r["engine"]["sp"]["schedules"]["32"]["schedule"] == "sp_seq"
                             for r in long_reps)
    assert sorted(stats["autoscale_pools"]) == ["long", "short"]
    assert "autoscaler [short]:" in out and "autoscaler [long]:" in out
