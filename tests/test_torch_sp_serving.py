"""The port's SP serving arm (alphafold2_tpu_torch/serving/sp_arm.py and
the engine's `sp_shards`) against the JAX package's on the CPU:

  * the pricing (`schedule_residency`), the heuristic (`choose_schedule`)
    and the ladder plan (`plan_bucket_schedules`) bit-equal to JAX's over
    f32 / bf16 / int8 models, buckets, MSA rows, budgets and 2 or 4
    shards; the overrides and the config's validation fail with JAX's
    messages;
  * an SP engine on two CPU shards (`sp_devices=["cpu"] * 2`; "sp_seq"
    forced at the top bucket, "sp_msa" at the other) against the JAX SP
    engine on the same weights (`params_from_jax`; conftest's 8 virtual
    CPU devices give JAX its mesh) within the engine parity test's
    tolerances, and against the port's dense engine within JAX's own SP
    test's; SP and dense never share a cache keyspace;
  * the placement rule: a mesh over distinct cards is refused naming
    ROADMAP A13 (checked through `check_mesh_placement` and the engine's
    build with a device list, no card needed), and chip-seconds bill the
    distinct devices a mesh occupies, not its shard count.

MDS fixes a structure only up to a rigid transform, so coordinates are
compared through pairwise distances. Every wait is bounded."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.serving import ServingConfig as JaxServingConfig
from alphafold2_tpu.serving import ServingEngine as JaxServingEngine
from alphafold2_tpu.serving import sp_arm as jsp
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_init, params_from_jax
from alphafold2_tpu_torch.constants import AA_ORDER, aa_to_tokens
from alphafold2_tpu_torch.parallel import alphafold2_apply_sp, make_mesh
from alphafold2_tpu_torch.serving import fleet as tfleet
from alphafold2_tpu_torch.serving import sp_arm as tsp
from alphafold2_tpu_torch.serving.engine import ServingConfig, ServingEngine

WAIT = 300  # seconds: the bound of every wait on a result
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs(weight_dtype="f32", dtype="f32", **fields):
    """The same model config in both packages."""
    kw = dict(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=64, weight_dtype=weight_dtype)
    kw.update(fields)
    jd, td = DTYPES[dtype]
    return JaxConfig(**kw, dtype=jd), Alphafold2Config(**kw, dtype=td)


def seq_of(n, offset=0):
    aa = AA_ORDER.replace("W", "")
    return "".join(aa[(offset + i) % len(aa)] for i in range(n))


def pairwise(c):
    c = np.asarray(c, np.float64)
    return np.linalg.norm(c[:, None] - c[None], axis=-1)


# --- pricing and the plan, bit-equal ------------------------------------------


@pytest.mark.parametrize("weight_dtype, dtype", [("f32", "f32"), ("f32", "bf16"),
                                                 ("int8", "f32"), ("int8", "bf16")])
@pytest.mark.parametrize("shards", [2, 4])
def test_schedule_residency_is_jax_bytes(weight_dtype, dtype, shards):
    jcfg, tcfg = configs(weight_dtype, dtype)
    weight_bytes = jsp.weight_residency_bytes(jcfg)
    assert tsp.weight_residency_bytes(tcfg) == weight_bytes
    assert tsp.schedule_residency(tcfg, bucket=16, batch=1, msa_rows=4, schedule="sp_seq",
                                  shards=shards).weight_bytes == weight_bytes
    for bucket in (8, 12, 16, 64):
        for rows in (0, 3, 4, 8):
            for schedule in tsp.SP_SCHEDULES:
                kw = dict(bucket=bucket, batch=3, msa_rows=rows, schedule=schedule,
                          shards=shards, weight_bytes=weight_bytes)
                got = tsp.schedule_residency(tcfg, **kw)
                want = jsp.schedule_residency(jcfg, **kw)
                assert got.as_dict() == want.as_dict(), kw
                assert got.total_bytes == want.total_bytes


def test_weight_bytes_of_the_north_star_shaped_model_are_jax_bytes():
    """Depth 12 at dim 256 (JAX's SP test's long-bucket model), both
    precisions: the meta-device tree prices what JAX's eval_shape does."""
    for wd in ("f32", "int8"):
        kw = dict(dim=256, depth=12, heads=8, dim_head=64, max_seq_len=1024, weight_dtype=wd)
        assert (tsp.weight_residency_bytes(Alphafold2Config(**kw))
                == jsp.weight_residency_bytes(JaxConfig(**kw)))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("weight_dtype, dtype", [("f32", "f32"), ("f32", "bf16"),
                                                 ("int8", "bf16")])
def test_choose_schedule_and_plan_are_jax_decisions(shards, weight_dtype, dtype, monkeypatch):
    jcfg, tcfg = configs(weight_dtype, dtype)
    # JAX prices the weight tree with a fresh eval_shape on every plan: price
    # it once here (the bytes themselves are held equal above)
    weight_bytes = jsp.weight_residency_bytes(jcfg)
    assert tsp.weight_residency_bytes(tcfg) == weight_bytes
    monkeypatch.setattr(jsp, "weight_residency_bytes", lambda cfg: weight_bytes)
    buckets = (8, 12, 16, 32, 64)
    # budgets from everything-fits down to nothing-fits, through each cut's
    # own total at the top bucket
    edges = sorted({jsp.schedule_residency(jcfg, bucket=64, batch=2, msa_rows=8,
                                           schedule=s, shards=shards).total_bytes
                    for s in jsp.SP_SCHEDULES})
    budgets = [1.0, float(1 << 40)] + [float(e) for e in edges] + [e - 1.0 for e in edges]
    for rows in (0, 3, 8):
        for hbm in budgets:
            for bucket in buckets:
                kw = dict(bucket=bucket, batch=2, msa_rows=rows, shards=shards, hbm_bytes=hbm,
                          weight_bytes=weight_bytes)
                assert (tsp.choose_schedule(tcfg, **kw).as_dict()
                        == jsp.choose_schedule(jcfg, **kw).as_dict()), kw
            kw = dict(buckets=buckets, batch=2, msa_rows=rows, shards=shards, hbm_bytes=hbm)
            got = tsp.plan_bucket_schedules(tcfg, **kw)
            want = jsp.plan_bucket_schedules(jcfg, **kw)
            assert {b: r.as_dict() for b, r in got.items()} == \
                {b: r.as_dict() for b, r in want.items()}, kw
    # an override wins over the heuristic, in both
    kw = dict(buckets=buckets, batch=2, msa_rows=8, shards=shards, hbm_bytes=float(1 << 40),
              overrides={16: "sp_seq", 32: "sp_msa"})
    got = tsp.plan_bucket_schedules(tcfg, **kw)
    assert {b: r.as_dict() for b, r in got.items()} == \
        {b: r.as_dict() for b, r in jsp.plan_bucket_schedules(jcfg, **kw).items()}
    assert got[16].schedule == "sp_seq" and got[32].schedule == "sp_msa"
    assert got[8].schedule == "dense"


def raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", ["off_ladder", "infeasible_msa", "infeasible_divide",
                                  "unknown_schedule"])
def test_plan_overrides_fail_with_jax_messages(case):
    jcfg, tcfg = configs()
    kw = dict(buckets=(8, 16), batch=2, msa_rows=0, shards=2, hbm_bytes=float(1 << 40))
    overrides = {"off_ladder": {32: "sp_seq"}, "infeasible_msa": {16: "sp_msa"},
                 "infeasible_divide": {16: "sp_seq"}, "unknown_schedule": {16: "ring"}}[case]
    if case == "infeasible_divide":
        kw.update(shards=3)
    got = raised(lambda: tsp.plan_bucket_schedules(tcfg, **kw, overrides=overrides))
    assert got == raised(lambda: jsp.plan_bucket_schedules(jcfg, **kw, overrides=overrides))


@pytest.mark.parametrize("fields", [
    dict(sp_shards=1), dict(sp_shards=-2), dict(sp_shards=2, sp_hbm_gb=0.0),
    dict(sp_shards=2, sp_schedules=((16, "ring"),)), dict(sp_schedules=((16, "sp_seq"),)),
    dict(sp_shards=2, early_exit_depths=(1, 2), early_exit_kl=0.01),
], ids=["one_shard", "negative", "budget", "unknown_schedule", "schedules_without_shards",
        "early_exit"])
def test_config_validation_is_jax_validation(fields):
    assert raised(lambda: ServingConfig(**fields)) == raised(lambda: JaxServingConfig(**fields))


def test_config_normalizes_the_overrides_as_jax_does():
    fields = dict(sp_shards=2, sp_schedules=[[16, "sp_seq"], (8, "dense")])
    assert ServingConfig(**fields).sp_schedules == JaxServingConfig(**fields).sp_schedules


def test_apply_fn_and_mesh_refusals():
    assert tsp.make_sp_apply_fn(None, "dense") is None
    with pytest.raises(ValueError, match="unknown SP schedule"):
        tsp.make_sp_apply_fn(None, "nope")
    with pytest.raises(ValueError, match="devices"):
        tsp.build_sp_mesh(10_000)  # no host has that many cards
    _, tcfg = configs()
    fn = tsp.make_sp_apply_fn(tsp.build_sp_mesh(2, ["cpu"] * 2), "sp_seq")
    with pytest.raises(ValueError, match="embedds"):
        fn({}, tcfg, np.zeros((1, 8), np.int32), None, embedds=np.zeros((1, 8, 4)))
    mesh = tsp.build_sp_mesh(2, ["cpu"] * 4)  # an explicit list: its first entries
    assert mesh.size == 2 and mesh.axis_name == "sp"


# --- the placement rule ---------------------------------------------------------


def test_distinct_cards_are_refused_naming_a13():
    """No card is needed: the rule reads device names. A mesh over two
    cards is A13's; one over the engine's card is served; one on another
    device than the engine's is a ValueError."""
    with pytest.raises(NotImplementedError, match="ROADMAP A13") as info:
        tsp.check_mesh_placement(["cuda:0", "cuda:1", "cuda:0", "cuda:1"], "cuda:0")
    assert "['cuda:0', 'cuda:1']" in str(info.value)
    tsp.check_mesh_placement(["cuda:0"] * 4, "cuda:0")
    tsp.check_mesh_placement([torch.device("cpu")] * 2, "cpu")
    with pytest.raises(ValueError, match="serves on cuda:0"):
        tsp.check_mesh_placement(["cuda:1"] * 4, "cuda:0")
    with pytest.raises(ValueError, match="serves on cpu"):
        tsp.check_mesh_placement(["cuda:0"] * 2, "cpu")


def test_engine_build_refuses_a_mesh_over_distinct_cards():
    _, tcfg = configs()
    params = alphafold2_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        ServingEngine(params, tcfg, ServingConfig(buckets=(8, 16), sp_shards=2),
                      device="cpu", sp_devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingEngine(params, tcfg, ServingConfig(buckets=(8, 16), sp_shards=2),
                      device="cpu", sp_devices=["cpu"] * 2,
                      model_apply_fn=lambda *a, **k: None)


def test_chip_seconds_bill_distinct_devices():
    """Two shards on the CPU occupy one device: the SP bucket's cost cell
    and the fleet's hedge-waste rule count 1, where the JAX engine counts
    its 2 shards; a custom engine without `chips` falls back to JAX's
    shard count."""
    jcfg, tcfg = configs()
    params = alphafold2_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    scfg = dict(buckets=(8, 16), max_batch=2, sp_shards=2, sp_schedules=((16, "sp_seq"),))
    eng = ServingEngine(params, tcfg, ServingConfig(**scfg), device="cpu",
                        sp_devices=["cpu"] * 2)
    jeng = JaxServingEngine(jax_init(jax.random.PRNGKey(0), jcfg), jcfg,
                            JaxServingConfig(**scfg))
    try:
        cells = {(c["bucket"], c["schedule"]): c for c in eng.stats()["costs"]["cells"]}
        jcells = {(c["bucket"], c["schedule"]): c for c in jeng.stats()["costs"]["cells"]}
        assert set(cells) == set(jcells) == {(8, "dense"), (16, "sp_seq")}
        assert jcells[(16, "sp_seq")]["chips"] == 2 and cells[(16, "sp_seq")]["chips"] == 1
        for key in cells:  # priced alike, per shard
            assert cells[key]["residency_bytes"] == jcells[key]["residency_bytes"]
        assert eng.chips == 1 and eng.stats()["sp"]["chips"] == 1
        assert tfleet._chips(types.SimpleNamespace(engine=eng, cfg=eng.cfg)) == 1
        assert tfleet._chips(types.SimpleNamespace(engine=object(), cfg=eng.cfg)) == 2
    finally:
        eng.shutdown()
        jeng.shutdown()


# --- the SP engine against JAX's and against the dense engine ----------------------


@pytest.fixture(scope="module")
def weights():
    """dim 32, depth 2 (the MSA<-pair ring of layer 0 reaches the logits),
    from JAX's init, in both packages."""
    jcfg, tcfg = configs(max_num_msa=4)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def sp_stream():
    rng = np.random.default_rng(0)
    stream = []
    for i, n in enumerate([16, 5, 14, 8, 11, 3]):
        seq = seq_of(n, offset=i)
        msa = None
        if i % 2:
            msa = np.stack([aa_to_tokens(seq), rng.integers(0, 21, n)]).astype(np.int32)
        stream.append((seq, msa))
    return stream


SP_SCFG = dict(buckets=(8, 16), max_batch=2, max_wait_s=0.02, msa_rows=2, mds_iters=50,
               request_timeout_s=WAIT)
SP_PLAN = dict(sp_shards=2, sp_schedules=((8, "sp_msa"), (16, "sp_seq")))


def serve(engine, stream):
    try:
        return [r.result(timeout=WAIT) for r in [engine.submit(s, msa=m) for s, m in stream]]
    finally:
        engine.shutdown()


def test_sp_engine_matches_the_jax_sp_engine(weights):
    """Both packages' SP engines (sp_seq at 16, sp_msa at 8, two shards),
    the same weights and stream: pairwise distances 1e-3 A, confidence
    5e-6, stress 1e-4 relative (tests/test_torch_serving.py's engine
    tolerances), the same plan and per-shard pricing."""
    jcfg, tcfg, jparams, tparams = weights
    jeng = JaxServingEngine(jparams, jcfg, JaxServingConfig(**SP_SCFG, **SP_PLAN))
    teng = ServingEngine(tparams, tcfg, ServingConfig(**SP_SCFG, **SP_PLAN), device="cpu",
                         sp_devices=["cpu"] * 2)
    jsnap, tsnap = jeng.stats()["sp"], teng.stats()["sp"]
    assert {k: tsnap[k] for k in jsnap} == jsnap
    assert tsnap["devices"] == ["cpu", "cpu"]
    stream = sp_stream()
    jres, tres = serve(jeng, stream), serve(teng, stream)
    for (seq, _), j, t in zip(stream, jres, tres):
        assert t.bucket == j.bucket and t.coords.shape == (len(seq), 3)
        np.testing.assert_allclose(t.confidence, j.confidence, rtol=0, atol=5e-6)
        np.testing.assert_allclose(t.stress, j.stress, rtol=1e-4)
        np.testing.assert_allclose(pairwise(t.coords), pairwise(j.coords), rtol=0, atol=1e-3)
    assert {r.bucket for r in tres} == {8, 16}


def test_sp_engine_matches_the_dense_engine(weights):
    """The port's SP engine against its dense engine on the same weights,
    within JAX's own SP-vs-dense test's tolerances (distances 2e-3,
    confidence 5e-4, stress 1e-3); the two config tags differ and the
    plan reaches stats() and the capability."""
    _, tcfg, _, tparams = weights
    dense = ServingEngine(tparams, tcfg, ServingConfig(**SP_SCFG), device="cpu")
    sp = ServingEngine(tparams, tcfg, ServingConfig(**SP_SCFG, **SP_PLAN), device="cpu",
                       sp_devices=["cpu"] * 2)
    assert dense.config_tag != sp.config_tag
    snap = sp.stats()
    assert snap["sp"]["schedules"]["16"]["schedule"] == "sp_seq"
    assert snap["sp"]["schedules"]["8"]["schedule"] == "sp_msa"
    assert snap["capability"]["sp_shards"] == 2 and "sp" not in dense.stats()
    stream = sp_stream()
    a, b = serve(dense, stream), serve(sp, stream)
    for x, y in zip(a, b):
        assert x.bucket == y.bucket
        np.testing.assert_allclose(pairwise(y.coords), pairwise(x.coords), atol=2e-3)
        np.testing.assert_allclose(y.confidence, x.confidence, atol=5e-4)
        assert abs(x.stress - y.stress) < 1e-3


def test_sp_engine_equals_predict_structure_with_the_sp_forward(weights):
    """An SP bucket's executable is `predict_structure(model_apply_fn=the
    SP forward)` on the padded batch, bit for bit; a `model_apply_fn`
    engine (the same forward for every bucket) serves the same bits."""
    from alphafold2_tpu_torch import predict_structure
    from alphafold2_tpu_torch.serving.bucketing import pad_batch

    _, tcfg, _, tparams = weights
    scfg = dict(SP_SCFG, msa_rows=0, mds_iters=8)
    sp = ServingEngine(tparams, tcfg, ServingConfig(**scfg, sp_shards=2,
                                                    sp_schedules=((16, "sp_seq"),)),
                       device="cpu", sp_devices=["cpu"] * 2)
    mesh = make_mesh({"sp": 2}, devices=["cpu"] * 2)
    forward = functools.partial(alphafold2_apply_sp, mesh=mesh, schedule="sp_seq")
    over = ServingEngine(tparams, tcfg, ServingConfig(**scfg), device="cpu",
                         model_apply_fn=forward)
    seq = seq_of(13)
    got, via_override = serve(sp, [(seq, None)])[0], serve(over, [(seq, None)])[0]
    tokens, mask, _ = pad_batch([aa_to_tokens(seq)], 16, 2)
    want = predict_structure(tparams, tcfg, tokens, mask=mask, mds_iters=8,
                             model_apply_fn=forward)
    for res in (got, via_override):
        assert np.array_equal(res.coords, want["coords"][0, :13].numpy())
        assert np.array_equal(res.confidence, want["confidence"][0, :13].numpy())
        assert res.stress == float(want["stress"][0])


def test_sp_pools_serve_through_the_fleet(weights):
    """`PoolSpec(sp_shards=2)` builds its replicas with the SP arm on the
    fleet's `sp_devices`; each pool's replica states its plan."""
    _, tcfg, _, tparams = weights
    scfg = ServingConfig(**dict(SP_SCFG, msa_rows=0, mds_iters=4))
    fleet = tfleet.ServingFleet(
        tparams, tcfg, scfg,
        tfleet.FleetConfig(probe_interval_s=0, pools=(
            tfleet.PoolSpec("short", buckets=(8,)),
            tfleet.PoolSpec("long", sp_shards=2, buckets=(8, 16),
                            sp_schedules=((16, "sp_seq"),)))),
        device="cpu", sp_devices=["cpu"] * 4)
    try:
        res = [fleet.submit(seq_of(n, offset=n)).result(timeout=WAIT) for n in (5, 14, 7, 16)]
        stats = fleet.stats()
    finally:
        fleet.shutdown(timeout=WAIT)
    assert [r.bucket for r in res] == [8, 16, 8, 16]
    reps = stats["replicas"]
    long_rep = next(r for r in reps.values() if r.get("pool") == "long")
    assert long_rep["capability"]["sp_shards"] == 2
    assert long_rep["engine"]["sp"]["schedules"]["16"]["schedule"] == "sp_seq"
    assert long_rep["engine"]["sp"]["devices"] == ["cpu", "cpu"]
    assert stats["requests"]["failed"] == 0 and stats["requests"]["in_flight"] == 0


def test_cli_sp_shards_on_cpu_shards(tmp_path, capsys):
    """`serve --sp-shards 2 --device cpu`: two CPU shards, the budget
    forcing sharded cuts (flow 16's single-engine recipe); the stats JSON
    carries the plan."""
    import json

    from alphafold2_tpu_torch import serve

    out = tmp_path / "sp.json"
    rc = serve.main(["--device", "cpu", "--demo", "4", "--buckets", "8,16", "--max-batch",
                     "2", "--mds-iters", "4", "--dim", "16", "--depth", "1", "--heads", "2",
                     "--dim-head", "8", "--sp-shards", "2", "--sp-hbm-gb", "0.0001",
                     "--stats-json", str(out)])
    assert rc == 0
    stats = json.loads(out.read_text())
    assert {r["schedule"] for r in stats["sp"]["schedules"].values()} == {"sp_seq"}
    assert stats["sp"]["devices"] == ["cpu", "cpu"] and stats["requests"]["failed"] == 0
    assert "SP plan over 2 shards" in capsys.readouterr().out


def test_early_exit_with_sp_stays_refused():
    """As in JAX: the config refuses the pair, and an engine with early
    exit refuses a forward override."""
    with pytest.raises(ValueError, match="cannot compose with the SP arm"):
        ServingConfig(buckets=(8,), sp_shards=2, early_exit_depths=(1, 2), early_exit_kl=0.1)
    tcfg = configs(depth=3)[1]
    params = alphafold2_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingEngine(params, tcfg, ServingConfig(buckets=(8,), early_exit_depths=(1, 2),
                                                  early_exit_kl=0.1),
                      device="cpu", model_apply_fn=lambda *a, **k: None)
