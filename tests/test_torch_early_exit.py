"""Trunk-depth early exit in the port (serving/pipeline.py
`staged_trunk_logits`, the engine's knobs and per-exit-depth cost cells)
against the JAX package on the CPU: the same weights (the JAX init through
`params_from_jax`) and the same seeded inputs.

The staged `predict_structure` is held to JAX's at three thresholds: one
no sample meets (1e-12), one every sample meets at the first checkpoint
that can exit (1e9), and one between the per-sample KLs (the geometric
midpoint of their widest gap, so some samples exit and some do not):
`exit_depth` equal, logits within 5e-6 on valid pairs, confidence within
1e-5. With nothing exiting the staged path equals the port's plain path
bit for bit; with every sample exiting at d the logits equal the model
cut to depth d. The refusals carry JAX's messages, compared string for
string. The engine tests mirror tests/test_cascade.py's early-exit layer
on the port's engine. The captured staged executable's card test is in
tests/test_torch_serving.py, which a GPU host without JAX can run.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import Alphafold2Config as JaxConfig
from alphafold2_tpu.models import alphafold2_init as jax_init
from alphafold2_tpu.serving import engine as jax_engine
from alphafold2_tpu.serving.pipeline import predict_structure as jax_predict
from alphafold2_tpu.utils.flops import model_fwd_flops as jax_fwd_flops
from alphafold2_tpu_torch import Alphafold2Config, params_from_jax, predict_structure
from alphafold2_tpu_torch.constants import AA_ORDER
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_apply
from alphafold2_tpu_torch.serving import engine as torch_engine
from alphafold2_tpu_torch.serving.bucketing import pad_batch
from alphafold2_tpu_torch.serving.executable import CapturedExecutable, EagerExecutable
from alphafold2_tpu_torch.serving.pipeline import staged_front, staged_step

KW = dict(dim=32, depth=4, heads=2, dim_head=16, max_seq_len=16)
DEPTHS = (1, 2, 3)
B, L = 4, 16


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**KW)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tcfg = Alphafold2Config(**KW)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def batch(seed=0):
    """Four distinct sequences, the second padded from 11 residues, with a
    3-row MSA."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 20, (B, L)).astype(np.int32)
    mask = np.ones((B, L), bool)
    mask[1, 11:] = False
    tokens[~mask] = 20
    msa = rng.integers(0, 21, (B, 3, L)).astype(np.int32)
    msa[:, 0] = tokens
    msa_mask = np.broadcast_to(mask[:, None], msa.shape).copy()
    return tokens, mask, msa, msa_mask


def stage_kls(params, cfg, tokens, mask, msa=None, msa_mask=None, depths=DEPTHS):
    """Per-sample masked-mean KL(prev || cur) at each later checkpoint
    (rows: checkpoints depths[1:] then cfg.depth), from the port's stages
    with nothing freezing."""
    cps = tuple(depths) + (cfg.depth,)
    with torch.inference_mode():
        t = lambda a, dt: None if a is None else torch.as_tensor(a, dtype=dt)  # noqa: E731
        state = staged_front(params, cfg, t(tokens, torch.long), t(msa, torch.long),
                             mask=t(mask, torch.bool), msa_mask=t(msa_mask, torch.bool),
                             upto=cps[0])
        rows = []
        for start, stop in zip(cps[:-1], cps[1:]):
            prev = state["prev_logp"].clone()
            staged_step(params, cfg, state, start, stop, exit_kl=1e-30)
            cur = state["prev_logp"]
            kl = ((prev.exp() * (prev - cur)).sum(-1) * state["pm"]).sum((1, 2)) / state["denom"]
            rows.append(kl.double().numpy())
    return np.stack(rows)


def midpoint_threshold(kls):
    """The geometric midpoint of the widest gap (in log space) between the
    sorted KLs of the checkpoints that can exit (all rows but the last)
    among the gaps that leave at least one sample exiting and one not (a
    sample exits when one of its KLs is at or under the threshold): the
    rule of chip_smoke.py 18a. Returns (threshold, the log gap)."""
    first = kls[:-1].min(axis=0)
    v = np.sort(kls[:-1].ravel())
    best = None
    for lo, hi in zip(v[:-1], v[1:]):
        mid = float(np.sqrt(lo * hi))
        if 0 < int((first <= mid).sum()) < len(first) and (
                best is None or np.log(hi / lo) > best[1]):
            best = (mid, float(np.log(hi / lo)))
    assert best is not None, kls
    return best


def run_both(models, kl, depths=DEPTHS, seed=0):
    jcfg, jparams, tcfg, tparams = models
    tokens, mask, msa, msa_mask = batch(seed)
    kw = dict(mask=mask, msa=msa, msa_mask=msa_mask, mds_iters=6)
    j = jax_predict(jparams, jcfg, tokens, early_exit_depths=depths, early_exit_kl=kl, **kw)
    t = predict_structure(tparams, tcfg, tokens, early_exit_depths=depths, early_exit_kl=kl,
                          device="cpu", **kw)
    return ({k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()},
            mask)


def jax_stage_kls(jparams, jcfg, tokens, mask, msa, msa_mask, depths=DEPTHS):
    """`stage_kls` from JAX's logits of the model cut to each checkpoint
    depth, in float64."""
    from alphafold2_tpu.models import alphafold2_apply as jax_apply

    def logp(d):
        lg = np.asarray(jax_apply(dict(jparams, trunk=jparams["trunk"][:d]),
                                  dataclasses.replace(jcfg, depth=d), tokens, msa, mask=mask,
                                  msa_mask=msa_mask), np.float64)
        top = lg.max(-1, keepdims=True)
        return lg - top - np.log(np.exp(lg - top).sum(-1, keepdims=True))

    pm = (mask[:, :, None] & mask[:, None, :]).astype(np.float64)
    lps = [logp(d) for d in tuple(depths) + (jcfg.depth,)]
    return np.stack([((np.exp(a) * (a - b)).sum(-1) * pm).sum((1, 2)) / pm.sum((1, 2))
                     for a, b in zip(lps[:-1], lps[1:])])


def test_midpoint_threshold_separates_the_samples(models):
    """The mid threshold splits the samples, and the gap it sits in is over
    1e3 times the port's KL departure from JAX's, so both packages put
    every sample on the same side of it."""
    jcfg, jparams, tcfg, tparams = models
    inputs = batch()
    kls = stage_kls(tparams, tcfg, *inputs)
    threshold, _ = midpoint_threshold(kls)
    v = np.sort(kls[:-1].ravel())
    gap = v[v > threshold].min() - v[v <= threshold].max()
    assert kls.shape == (len(DEPTHS), B) and (kls > 0).all()
    departure = np.abs(kls - jax_stage_kls(jparams, jcfg, *inputs)).max()
    assert gap > 1e3 * departure, (gap, departure)
    below = kls[:-1] <= threshold
    assert below.any() and not below.all()


@pytest.mark.parametrize("which", ["none", "all", "mid"])
def test_staged_predict_structure_matches_jax(models, which):
    _, _, tcfg, tparams = models
    kl = {"none": 1e-12, "all": 1e9}.get(which)
    if kl is None:
        kl, _ = midpoint_threshold(stage_kls(tparams, tcfg, *batch()))
    j, t, mask = run_both(models, kl)
    np.testing.assert_array_equal(t["exit_depth"], j["exit_depth"])
    assert t["exit_depth"].dtype == np.int32
    pair = mask[:, :, None] & mask[:, None, :]
    np.testing.assert_allclose(t["distogram_logits"][pair], j["distogram_logits"][pair],
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(t["confidence"], j["confidence"], rtol=0, atol=1e-5)
    want = {"none": [4, 4, 4, 4], "all": [2, 2, 2, 2]}.get(which)
    if want is not None:
        np.testing.assert_array_equal(t["exit_depth"], want)
    else:
        assert len(set(t["exit_depth"].tolist())) > 1  # mixed exits


def test_nothing_exiting_equals_the_plain_path_bit_for_bit(models):
    _, _, tcfg, tparams = models
    tokens, mask, msa, msa_mask = batch(1)
    kw = dict(mask=mask, msa=msa, msa_mask=msa_mask, mds_iters=6, device="cpu")
    plain = predict_structure(tparams, tcfg, tokens, **kw)
    staged = predict_structure(tparams, tcfg, tokens, early_exit_depths=DEPTHS,
                               early_exit_kl=1e-12, **kw)
    for k, v in plain.items():
        assert torch.equal(staged[k], v), k
    assert "exit_depth" not in plain
    assert staged["exit_depth"].tolist() == [tcfg.depth] * B


@pytest.mark.parametrize("depths, d", [((1, 2, 3), 2), ((2, 3), 3)], ids=["exit2", "exit3"])
def test_every_sample_exiting_at_d_equals_the_model_cut_to_d(models, depths, d):
    _, _, tcfg, tparams = models
    tokens, mask, msa, msa_mask = batch(2)
    out = predict_structure(tparams, tcfg, tokens, mask=mask, msa=msa, msa_mask=msa_mask,
                            mds_iters=6, device="cpu", early_exit_depths=depths,
                            early_exit_kl=1e9)
    assert out["exit_depth"].tolist() == [d] * B
    cut = dataclasses.replace(tcfg, depth=d)
    with torch.inference_mode():
        logits = alphafold2_apply(dict(tparams, trunk=tparams["trunk"][:d]), cut, tokens, msa,
                                  mask=mask, msa_mask=msa_mask, device="cpu").float()
    assert torch.equal(out["distogram_logits"], logits)


def test_staged_trunk_skips_the_stages_after_every_sample_froze(models, monkeypatch):
    """The eager loop stops once every sample has frozen: with every sample
    exiting at depth 2 the last stage never runs (its layers are never
    read), and the result is what running it would give."""
    from alphafold2_tpu_torch.serving import pipeline

    _, _, tcfg, tparams = models
    calls = []
    real = pipeline.staged_step
    monkeypatch.setattr(pipeline, "staged_step",
                        lambda *a, **k: calls.append(a[3:5]) or real(*a, **k))
    tokens, mask, msa, msa_mask = batch(3)
    out = predict_structure(tparams, tcfg, tokens, mask=mask, msa=msa, msa_mask=msa_mask,
                            mds_iters=6, device="cpu", early_exit_depths=DEPTHS,
                            early_exit_kl=1e9)
    assert calls == [(1, 2)]
    assert out["exit_depth"].tolist() == [2] * B


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["reversible", "one_checkpoint", "zero_depth", "full_depth",
                                  "nonuniform_sparse", "kl_zero", "model_apply_fn"])
def test_refusals_carry_jax_messages(models, case):
    jcfg, jparams, tcfg, tparams = models
    depths, kl, fields, extra = DEPTHS, 0.1, {}, {}
    if case == "reversible":
        fields = {"reversible": True}
    elif case == "one_checkpoint":
        depths = (2, 2)
    elif case == "zero_depth":
        depths = (0, 2)
    elif case == "full_depth":
        depths = (1, KW["depth"])
    elif case == "nonuniform_sparse":
        fields = {"sparse_self_attn": (True, False, False, False)}
    elif case == "kl_zero":
        kl = 0.0
    elif case == "model_apply_fn":
        extra = {"model_apply_fn": lambda *a, **k: None}
    tokens = np.zeros((1, 8), np.int32)
    jmsg = _message(lambda: jax_predict(jparams, dataclasses.replace(jcfg, **fields), tokens,
                                        early_exit_depths=depths, early_exit_kl=kl, **extra))
    tmsg = _message(lambda: predict_structure(
        tparams, dataclasses.replace(tcfg, **fields), tokens, early_exit_depths=depths,
        early_exit_kl=kl, device=None if extra else "cpu", **extra))
    assert tmsg == jmsg


# ------------------------------------------------------------------ the engine


def _config_message(mod, **kw):
    with pytest.raises(ValueError) as e:
        mod.ServingConfig(buckets=(8,), **kw)
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(early_exit_depths=(2,), early_exit_kl=0.01),
    dict(early_exit_depths=(0, 2), early_exit_kl=0.01),
    dict(early_exit_depths=(1, 2), early_exit_kl=0.0),
    dict(early_exit_kl=0.5),
    dict(early_exit_depths=(1, 2), early_exit_kl=0.01, sp_shards=2),
], ids=["one_checkpoint", "zero_depth", "kl_zero", "kl_without_depths", "sp_shards"])
def test_serving_config_validates_like_jax(kw):
    assert _config_message(torch_engine, **kw) == _config_message(jax_engine, **kw)


def test_serving_config_sorts_and_dedupes_depths():
    cfg = torch_engine.ServingConfig(buckets=(8,), early_exit_depths=(2, 1, 2),
                                     early_exit_kl=0.01)
    assert cfg.early_exit_depths == (1, 2)


def test_prediction_result_fields_are_jaxs():
    names = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(torch_engine.PredictionResult) == names(jax_engine.PredictionResult)


DEEP = dict(dim=16, depth=4, heads=2, dim_head=8, max_seq_len=32)


@pytest.fixture(scope="module")
def deep():
    jcfg = JaxConfig(**DEEP)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tcfg = Alphafold2Config(**DEEP)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                                tcfg, device="cpu")


def seq_of(length, offset=0):
    aa = AA_ORDER.replace("W", "")
    return "".join(aa[(offset + i) % len(aa)] for i in range(length))


def engine(params, cfg, **kw):
    base = dict(buckets=(16,), max_batch=2, max_queue=4, mds_iters=4,
                request_timeout_s=300.0, cache_capacity=0)
    return torch_engine.ServingEngine(params, cfg, torch_engine.ServingConfig(**{**base, **kw}),
                                      device="cpu")


def test_engine_bills_early_exits_into_per_depth_cost_cells(deep):
    _, _, tcfg, tparams = deep
    eng = engine(tparams, tcfg, early_exit_depths=(1, 2), early_exit_kl=1e9)
    try:
        res = eng.predict(seq_of(8))
        assert res.exit_depth == 2
        assert res.mean_confidence == pytest.approx(float(np.asarray(res.confidence).mean()))
        snap = eng.costs.snapshot()
        by_sched = {c["schedule"]: c for c in snap["cells"]}
        assert by_sched["dense@exit2"]["requests"] == 1
        assert by_sched["dense"]["requests"] == 0
        assert by_sched["dense@exit2"]["forward_flops"] < by_sched["dense"]["forward_flops"]
        total = sum(c["device_seconds"] * c["chips"] for c in snap["cells"])
        assert total > 0.0
        assert total == pytest.approx(eng.costs.fleet_chip_seconds_total(), rel=1e-6)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("ladder", [False, True], ids=["plain", "batch_ladder"])
def test_exit_cells_and_their_prices_match_jax(deep, ladder):
    """The cells the port registers are JAX's (schedules, forward FLOPs), and
    a batch with mixed exits splits its seconds over them as JAX's engine
    splits them."""
    jcfg, jparams, tcfg, tparams = deep
    kw = dict(buckets=(16,), max_batch=4, cache_capacity=0, batch_ladder=ladder,
              early_exit_depths=(1, 2, 3), early_exit_kl=0.1)
    jeng = jax_engine.ServingEngine(jparams, jcfg, jax_engine.ServingConfig(**kw))
    teng = torch_engine.ServingEngine(tparams, tcfg, torch_engine.ServingConfig(**kw),
                                      device="cpu")
    try:
        exits = np.array([2, 4, 3, 2], np.int32)
        for eng in (jeng, teng):
            eng._bill_batch(16, 4, 1.5, [None] * 4, exits)
        cells = lambda e: {c["schedule"]: (c["forward_flops"], c["requests"],  # noqa: E731
                                           c["device_seconds"])
                           for c in e.costs.snapshot()["cells"]}
        tc, jc = cells(teng), cells(jeng)
        assert tc.keys() == jc.keys()
        for sched in tc:
            assert tc[sched][:2] == jc[sched][:2], sched
            assert tc[sched][2] == pytest.approx(jc[sched][2], rel=1e-12), sched
        suffix = "@b4" if ladder else ""
        assert tc[f"dense@exit2{suffix}"][1] == 2 and tc[f"dense@exit3{suffix}"][1] == 1
        assert tc[f"dense{suffix}"][1] == 1
        for d in (2, 3):
            assert tc[f"dense@exit{d}{suffix}"][0] == jax_fwd_flops(
                dataclasses.replace(jcfg, depth=d), n=16, r=0, c=16)
        assert sum(v[2] for v in tc.values()) == pytest.approx(1.5, rel=1e-12)
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_early_exit_knobs_move_the_config_tag(deep):
    _, _, tcfg, tparams = deep
    engines = [engine(tparams, tcfg, max_batch=1),
               engine(tparams, tcfg, max_batch=1, early_exit_depths=(1, 2), early_exit_kl=0.5),
               engine(tparams, tcfg, max_batch=1, early_exit_depths=(1, 2),
                      early_exit_kl=0.05)]
    try:
        assert len({e.config_tag for e in engines}) == 3
    finally:
        for e in engines:
            e.shutdown()


@pytest.mark.parametrize("case", ["model_apply_fn", "depth", "reversible", "nonuniform_sparse"])
def test_engine_rejects_early_exit_incompatibilities_like_jax(deep, case):
    jcfg, jparams, tcfg, tparams = deep
    depths, fields, extra = (1, 2), {}, {}
    if case == "model_apply_fn":
        extra = {"model_apply_fn": lambda *a, **k: None}
    elif case == "depth":
        depths = (1, DEEP["depth"])
    elif case == "reversible":
        fields = {"reversible": True}
    else:
        fields = {"sparse_self_attn": (True, False, False, False)}
    kw = dict(buckets=(16,), early_exit_depths=depths, early_exit_kl=0.1)
    jmsg = _message(lambda: jax_engine.ServingEngine(
        jparams, dataclasses.replace(jcfg, **fields), jax_engine.ServingConfig(**kw), **extra))
    tmsg = _message(lambda: torch_engine.ServingEngine(
        tparams, dataclasses.replace(tcfg, **fields), torch_engine.ServingConfig(**kw),
        device="cpu", **extra))
    assert tmsg == jmsg


def test_engine_serves_mixed_exits_as_predict_structure(models):
    """A batch of four requests through the engine at the midpoint
    threshold: each result's exit_depth, coordinates and confidence are
    the staged `predict_structure`'s on the padded batch."""
    _, _, tcfg, tparams = models
    tokens, mask, _, _ = batch()
    seqs = ["".join(AA_ORDER[t] for t in row[m]) for row, m in zip(tokens, mask)]
    ref_tokens, ref_mask, _ = pad_batch([np.asarray(t[m]) for t, m in zip(tokens, mask)], 16, 4)
    kl, _ = midpoint_threshold(stage_kls(tparams, tcfg, ref_tokens, ref_mask))
    eng = engine(tparams, tcfg, max_batch=4, max_wait_s=5.0, early_exit_depths=DEPTHS,
                 early_exit_kl=kl)
    try:
        reqs = [eng.submit(s) for s in seqs]
        got = [r.result(timeout=60) for r in reqs]
        stats = eng.stats()
    finally:
        eng.shutdown()
    ref = predict_structure(tparams, tcfg, ref_tokens, mask=ref_mask, mds_iters=4, device="cpu",
                            early_exit_depths=DEPTHS, early_exit_kl=kl)
    assert stats["batches"]["count"] == 1
    for i, r in enumerate(got):
        n = len(seqs[i])
        assert r.exit_depth == int(ref["exit_depth"][i])
        np.testing.assert_array_equal(r.coords, ref["coords"][i, :n].numpy())
        np.testing.assert_array_equal(r.confidence, ref["confidence"][i, :n].numpy())
    cells = {c["schedule"]: c["requests"] for c in stats["costs"]["cells"]}
    for d in (2, 3, 4):
        n = sum(r.exit_depth == d for r in got)
        assert cells["dense" if d == 4 else f"dense@exit{d}"] == n


def test_eager_executable_returns_exit_depth(models):
    _, _, tcfg, tparams = models
    tokens, mask, msa, msa_mask = batch()
    exe = EagerExecutable(tparams, tcfg, mds_iters=4, mds_init="classical",
                          device=torch.device("cpu"), early_exit_depths=DEPTHS,
                          early_exit_kl=1e9)
    out = exe(tokens, mask, msa, msa_mask)
    assert set(out) == {"coords", "confidence", "stress", "exit_depth"}
    assert out["exit_depth"].tolist() == [2] * B


@pytest.mark.parametrize("kl", [1e-12, 1e9], ids=["none", "all"])
def test_captured_stages_compose_to_the_staged_pipeline_on_the_cpu(models, kl):
    """The captured executable's stage functions, run here on CPU tensors
    outside any graph and skipped as a replay skips them: the staged
    `predict_structure` bit for bit (coords, confidence, stress, logits,
    exit_depth), and the stage counts show the skipped stage."""
    _, _, tcfg, tparams = models
    tokens, mask, msa, msa_mask = batch()
    exe = object.__new__(CapturedExecutable)  # the stages without a capture
    exe.params, exe.cfg, exe.device, exe.mds_iters = tparams, tcfg, torch.device("cpu"), 6
    exe.random, exe.exit_kl = False, kl
    exe.checkpoints = DEPTHS + (tcfg.depth,)
    exe.outputs = ("coords", "confidence", "stress", "exit_depth")
    exe.stage_replays = [0] * 4
    with torch.inference_mode():
        exe.tokens, exe.mask = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
        exe.msa, exe.msa_mask = torch.from_numpy(msa).long(), torch.from_numpy(msa_mask)
        exe.evals = exe.evecs = None
        exe.stage_graphs = [type("Stage", (), {"replay": lambda self, k=k: exe._stage(k)})()
                            for k in range(4)]
        exe._replay_stages()
        exe.geo, exe.start = exe._front()
        exe._eigh()
        got = dict(exe._back(), distogram_logits=exe.logits)
    ref = predict_structure(tparams, tcfg, tokens, mask=mask, msa=msa, msa_mask=msa_mask,
                            mds_iters=6, device="cpu", early_exit_depths=DEPTHS,
                            early_exit_kl=kl)
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k
    assert exe.stage_replays == ([1, 1, 1, 1] if kl < 1 else [1, 1, 0, 0])
    exe.stage_launches = [{"flash_fwd": 2}, {"flash_fwd": 3}, {"flash_fwd": 5}, {"flash_fwd": 7}]
    exe.tail_launches, exe.replays = {"quant_matmul": 1}, 1
    want = {"flash_fwd": 17 if kl < 1 else 5, "quant_matmul": 1}
    assert exe.replayed_launches() == want
