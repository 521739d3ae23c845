"""The port's serving engine (alphafold2_tpu_torch/serving/engine.py) on the
CPU: the ported counterparts of tests/test_serving.py's engine tests
(bucketing, submit-time validation, batch assembly, backpressure, poison
isolation, deadlines, the result cache and coalescing, shutdown, stats,
the error codes, the config tag, the int8 arm) and of tests/test_chaos.py's
breaker and watchdog tests, the engine against the JAX engine on the same
weights, the refused knobs, and the CLI.

Scheduler tests stub the device call at the `_call_executable` seam
(`FakeModelEngine`); the rest run the tiny real model eagerly on the CPU.
Every wait is bounded. The captured executable needs a card: its test is
marked `cuda` and skips here; on a GPU host (no JAX needed: this module
imports JAX only inside the tests that compare with it)

    python -m pytest --noconftest -m cuda tests/test_torch_serving.py -q
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from alphafold2_tpu_torch import Alphafold2Config, alphafold2_init, predict_structure
from alphafold2_tpu_torch.constants import AA_ORDER, PAD_TOKEN_ID, aa_to_tokens
from alphafold2_tpu_torch.reliability.breaker import CircuitBreaker, CircuitState
from alphafold2_tpu_torch.serving import errors
from alphafold2_tpu_torch.serving.bucketing import BucketLadder, batch_shape_ladder, pad_batch
from alphafold2_tpu_torch.serving.engine import ServingConfig, ServingEngine
from alphafold2_tpu_torch.serving.errors import (
    CircuitOpenError,
    EngineClosedError,
    HungBatchError,
    InvalidSequenceError,
    PredictionError,
    QueueFullError,
    RequestTimeoutError,
    RequestTooLongError,
    ServingError,
)

TINY = Alphafold2Config(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)
# vocabulary minus W: all-W sequences are the poison marker in failure tests
AA = AA_ORDER.replace("W", "")
W_TOKEN = AA_ORDER.index("W")
WAIT = 30  # seconds: the bound of every wait on a result


@pytest.fixture(scope="module")
def tiny_params():
    return alphafold2_init(TINY, torch.Generator().manual_seed(0), "cpu")


def seq_of(length, offset=0):
    return "".join(AA[(offset + i) % len(AA)] for i in range(length))


def serving_cfg(**overrides):
    base = dict(buckets=(8, 16), max_batch=3, max_queue=8, max_wait_s=0.05,
                request_timeout_s=30.0, mds_iters=4)
    base.update(overrides)
    return ServingConfig(**base)


class FakeModelEngine(ServingEngine):
    """The engine with the device call stubbed at `_call_executable`.
    `call_hook(bucket, tokens, mask)` runs first: tests block the worker
    or raise there."""

    def __init__(self, *args, call_hook=None, **kwargs):
        self.calls = 0
        self._hook = call_hook
        super().__init__(*args, **kwargs)

    def _call_executable(self, bucket, tokens, mask, msa=None, msa_mask=None):
        self.calls += 1
        if self._hook is not None:
            self._hook(bucket, tokens, mask)
        B, Lb = tokens.shape
        return {"coords": np.zeros((B, Lb, 3), np.float32),
                "confidence": np.full((B, Lb), 0.5, np.float32),
                "stress": np.zeros((B,), np.float32)}


def fake_engine(**overrides):
    hook = overrides.pop("call_hook", None)
    # params are never touched when _call_executable is stubbed
    return FakeModelEngine({}, TINY, serving_cfg(**overrides), device="cpu", call_hook=hook)


def blocking_hook():
    """(hook, entered, release): the hook parks the worker in the model
    call until `release` is set."""
    entered, release = threading.Event(), threading.Event()

    def hook(bucket, tokens, mask):
        entered.set()
        release.wait(WAIT)

    return hook, entered, release


# --------------------------------------------------------------- bucketing


def test_bucket_ladder_selection_and_rejection():
    ladder = BucketLadder((128, 64, 64, 256))  # unsorted + dup input
    assert ladder.buckets == (64, 128, 256)
    assert ladder.bucket_for(1) == 64
    assert ladder.bucket_for(64) == 64
    assert ladder.bucket_for(65) == 128
    assert ladder.bucket_for(256) == 256
    with pytest.raises(RequestTooLongError):
        ladder.bucket_for(257)
    with pytest.raises(ValueError):
        BucketLadder(())
    assert batch_shape_ladder(1) == (1,)
    assert batch_shape_ladder(4) == (1, 2, 4)
    assert batch_shape_ladder(6) == (1, 2, 4, 6)


def test_pad_batch_duplicates_last_row():
    rows = [aa_to_tokens("ACD"), aa_to_tokens("ACDEF")]
    tokens, mask, n_real = pad_batch(rows, bucket=8, max_batch=4)
    assert tokens.shape == (4, 8) and mask.shape == (4, 8)
    assert n_real == 2
    assert mask[0].sum() == 3 and mask[1].sum() == 5
    assert (tokens[0, 3:] == PAD_TOKEN_ID).all()
    # filler slots duplicate the last real row (no all-pad rows feeding a
    # zero-weight MDS)
    assert (tokens[2] == tokens[1]).all() and (mask[3] == mask[1]).all()


# ------------------------------------------------- submit-time validation


def test_submit_rejects_invalid_and_oversized():
    eng = fake_engine()
    try:
        with pytest.raises(InvalidSequenceError):
            eng.submit("ACXZ")  # X, Z outside the vocabulary
        with pytest.raises(InvalidSequenceError):
            eng.submit("")
        with pytest.raises(RequestTooLongError):
            eng.submit(seq_of(17))  # largest bucket is 16
        with pytest.raises(ServingError):
            eng.submit(seq_of(4), msa=np.zeros((2, 4), np.int32))  # msa_rows=0
        with pytest.raises(ServingError):
            eng.submit(seq_of(4), msa_mask=np.ones((2, 4), bool))  # mask, no msa
        assert eng.stats()["requests"]["rejected"] == 5
        assert eng.calls == 0
    finally:
        eng.shutdown()


def test_random_mds_init_incompatible_with_cache():
    with pytest.raises(ValueError, match="random"):
        serving_cfg(mds_init="random", cache_capacity=8)
    serving_cfg(mds_init="random", cache_capacity=0)  # explicit opt-out OK


def test_results_do_not_alias_the_cache():
    eng = fake_engine()
    try:
        seq = seq_of(6)
        first = eng.predict(seq, timeout=WAIT)
        first.coords += 99.0  # client-side in-place edit
        second = eng.submit(seq).result(timeout=WAIT)
        assert second.from_cache
        assert second.coords.max() < 99.0  # the cache entry stayed pristine
        second.confidence[:] = -1.0
        assert eng.submit(seq).result(timeout=WAIT).confidence.min() >= 0.0
    finally:
        eng.shutdown()


def test_strict_aa_to_tokens_modes():
    assert aa_to_tokens("AXA").tolist() == [0, PAD_TOKEN_ID, 0]
    with pytest.raises(ValueError, match="X"):
        aa_to_tokens("AXA", strict=True)


# ------------------------------------------------------- batch assembly


def test_burst_becomes_one_batch_and_max_batch_splits():
    eng = fake_engine(max_wait_s=0.5)
    try:
        # the worker waits up to max_wait for more: a burst of max_batch
        # same-bucket requests forms ONE full batch
        reqs = [eng.submit(seq_of(4, offset=i)) for i in range(3)]
        for r in reqs:
            r.result(timeout=WAIT)
        stats = eng.stats()
        assert stats["batches"]["count"] == 1
        assert stats["batches"]["recent_sizes"] == [3]
        # 4 more with max_batch=3: a full batch plus a max-wait partial one
        reqs = [eng.submit(seq_of(5, offset=10 + i)) for i in range(4)]
        for r in reqs:
            r.result(timeout=WAIT)
        sizes = eng.stats()["batches"]["recent_sizes"]
        assert sum(sizes) == 7
        assert max(sizes) <= 3
    finally:
        eng.shutdown()


def test_partial_batch_dispatches_after_max_wait():
    eng = fake_engine(max_wait_s=0.05)
    try:
        res = eng.submit(seq_of(6)).result(timeout=WAIT)
        assert res.coords.shape == (6, 3)
        stats = eng.stats()
        assert stats["batches"]["recent_sizes"] == [1]
        assert stats["batches"]["mean_occupancy"] < 1.0
    finally:
        eng.shutdown()


def test_batch_ladder_runs_the_smallest_rung():
    """With the batch-shape ladder a lone request runs at rung 1 and a
    burst of 3 at rung 4 (max_batch 4): the stub sees each batch's rows."""
    shapes = []
    eng = fake_engine(max_batch=4, max_wait_s=0.3, batch_ladder=True,
                      call_hook=lambda b, tokens, m: shapes.append(tokens.shape[0]))
    try:
        eng.submit(seq_of(5)).result(timeout=WAIT)
        reqs = [eng.submit(seq_of(4, offset=i)) for i in range(3)]
        for r in reqs:
            r.result(timeout=WAIT)
        assert shapes == [1, 4]
        st = eng.stats()
        assert st["batch_shapes"] == [1, 2, 4]
        assert st["batches"]["pad_ratio"] == pytest.approx(1 / 4)
    finally:
        eng.shutdown()


# ------------------------------------------------------- backpressure


def test_queue_full_rejects_instead_of_blocking():
    hook, entered, release = blocking_hook()
    eng = fake_engine(max_queue=2, max_batch=1, max_wait_s=0.0, call_hook=hook)
    try:
        first = eng.submit(seq_of(3))
        assert entered.wait(WAIT)  # the worker is wedged inside the model call
        q1 = eng.submit(seq_of(4))
        q2 = eng.submit(seq_of(5))
        t0 = time.monotonic()
        with pytest.raises(QueueFullError):
            eng.submit(seq_of(6))
        assert time.monotonic() - t0 < 1.0  # rejected, not blocked
        assert eng.stats()["requests"]["rejected"] == 1
        release.set()
        for r in (first, q1, q2):
            r.result(timeout=WAIT)
    finally:
        release.set()
        eng.shutdown()


# ------------------------------------------------- failure isolation


def test_poison_request_fails_alone_and_engine_keeps_serving():
    def hook(bucket, tokens, mask):
        for row, m in zip(tokens, mask):
            if m.any() and (row[m] == W_TOKEN).all():
                raise RuntimeError("poison row")

    eng = fake_engine(max_wait_s=0.5, call_hook=hook)
    try:
        good1 = eng.submit(seq_of(4))
        poison = eng.submit("WWWW")
        good2 = eng.submit(seq_of(5, offset=3))
        # the batch of 3 fails, each is retried alone: only the poison fails
        assert good1.result(timeout=WAIT).coords.shape == (4, 3)
        assert good2.result(timeout=WAIT).coords.shape == (5, 3)
        with pytest.raises(PredictionError) as exc_info:
            poison.result(timeout=WAIT)
        assert "poison row" in str(exc_info.value)
        assert eng.submit(seq_of(7)).result(timeout=WAIT).confidence.shape == (7,)
        stats = eng.stats()
        assert stats["requests"]["failed"] == 1
        assert stats["requests"]["completed"] == 3
    finally:
        eng.shutdown()


# ------------------------------------------------- deadlines and timeouts


def test_request_deadline_expires_scheduler_side():
    hook, entered, release = blocking_hook()
    eng = fake_engine(max_batch=1, max_wait_s=0.0, call_hook=hook)
    try:
        blocker = eng.submit(seq_of(3))
        assert entered.wait(WAIT)
        victim = eng.submit(seq_of(4), timeout=0.001)
        # the caller's wait budget is independent of the request deadline;
        # this bounded wait also outlasts the deadline while the worker is
        # wedged
        with pytest.raises(TimeoutError):
            victim.result(timeout=0.05)
        release.set()
        blocker.result(timeout=WAIT)
        with pytest.raises(RequestTimeoutError):
            victim.result(timeout=WAIT)
        assert eng.stats()["requests"]["timed_out"] == 1
    finally:
        release.set()
        eng.shutdown()


# ------------------------------------------------- result cache + coalescing


def test_cache_hit_returns_without_touching_the_model():
    eng = fake_engine()
    try:
        seq = seq_of(6)
        first = eng.predict(seq, timeout=WAIT)
        calls_after_first = eng.calls
        second = eng.predict(seq, timeout=WAIT)
        assert eng.calls == calls_after_first
        assert second.from_cache and not first.from_cache
        np.testing.assert_array_equal(first.coords, second.coords)
        snap = eng.stats()["cache"]
        assert snap["hits"] == 1 and snap["hit_rate"] > 0
        eng.predict(seq_of(6, offset=2), timeout=WAIT)
        assert eng.calls == calls_after_first + 1
    finally:
        eng.shutdown()


def test_identical_inflight_requests_coalesce():
    hook, entered, release = blocking_hook()
    eng = fake_engine(max_batch=1, max_wait_s=0.0, call_hook=hook)
    try:
        blocker = eng.submit(seq_of(3))
        assert entered.wait(WAIT)
        a = eng.submit(seq_of(4))
        b = eng.submit(seq_of(4))  # identical, still queued: the same future
        assert a is b
        release.set()
        blocker.result(timeout=WAIT)
        assert a.result(timeout=WAIT).coords.shape == (4, 3)
        assert eng.stats()["requests"]["coalesced"] == 1
    finally:
        release.set()
        eng.shutdown()


# ------------------------------------------------------------ shutdown


def test_shutdown_drains_pending_requests():
    eng = fake_engine(max_wait_s=5.0)  # long wait: only the drain can flush
    try:
        reqs = [eng.submit(seq_of(4, offset=i)) for i in range(5)]
        eng.shutdown(drain=True, timeout=WAIT)
        for i, r in enumerate(reqs):
            assert r.result(timeout=1).coords.shape == (4, 3), i
        with pytest.raises(EngineClosedError):
            eng.submit(seq_of(3))
    finally:
        eng.shutdown()


def test_worker_crash_fails_pending_and_closes_engine():
    hook, entered, release = blocking_hook()
    eng = fake_engine(max_batch=1, max_wait_s=0.0, call_hook=hook)

    def boom(*args, **kwargs):
        raise RuntimeError("metrics sink exploded")

    # crash the scheduler outside the guarded model call
    eng.metrics.observe_batch = boom
    first = eng.submit(seq_of(4))
    assert entered.wait(WAIT)
    stranded = eng.submit(seq_of(5))
    release.set()
    first.result(timeout=WAIT)  # resolved before the crash propagates
    with pytest.raises(PredictionError, match="worker crashed"):
        stranded.result(timeout=WAIT)
    eng._worker.join(timeout=WAIT)
    assert not eng._worker.is_alive()
    with pytest.raises(EngineClosedError):
        eng.submit(seq_of(6))
    assert eng.health()["status"] == "down"


def test_shutdown_without_drain_fails_pending():
    hook, entered, release = blocking_hook()
    eng = fake_engine(max_batch=1, max_wait_s=0.0, call_hook=hook)
    blocker = eng.submit(seq_of(3))
    assert entered.wait(WAIT)
    pending = [eng.submit(seq_of(4)), eng.submit(seq_of(5))]
    timer = threading.Timer(0.05, release.set)
    timer.start()
    eng.shutdown(drain=False, timeout=WAIT)
    timer.join(WAIT)
    blocker.result(timeout=1)  # the in-flight batch still completed
    for r in pending:
        with pytest.raises(EngineClosedError):
            r.result(timeout=1)


# ------------------------------------------- breaker and watchdog (chaos)


def failing_hook(n_failures):
    """A hook whose first `n_failures` calls raise."""
    calls = {"n": 0}

    def hook(bucket, tokens, mask):
        calls["n"] += 1
        if calls["n"] <= n_failures:
            raise RuntimeError(f"injected failure {calls['n']}")

    return hook


def test_circuit_opens_fast_rejects_and_recovers_via_probe():
    """An always-failing model opens the circuit within the threshold,
    submit() fast-rejects while it is open, and one half-open probe closes
    it once the model heals; every error counted by code. The breaker's
    clock is stepped past its window instead of slept through."""
    THRESHOLD = 3
    eng = fake_engine(breaker_threshold=THRESHOLD, breaker_reset_s=10.0,
                      call_hook=failing_hook(THRESHOLD))
    clock = [0.0]
    eng._breaker._clock = lambda: clock[0]
    try:
        for i in range(THRESHOLD):
            with pytest.raises(PredictionError):
                eng.submit(seq_of(4, offset=i)).result(timeout=WAIT)
        assert eng.stats()["breaker"]["state"] == "open"
        assert eng.health()["status"] == "degraded"
        t0 = time.monotonic()
        with pytest.raises(CircuitOpenError):
            eng.submit(seq_of(4, offset=9))
        assert time.monotonic() - t0 < 1.0  # fast-reject, no queue time
        clock[0] = 10.0  # past breaker_reset_s: half-open admits a probe
        probe = eng.submit(seq_of(4, offset=10))
        assert probe.result(timeout=WAIT).coords.shape == (4, 3)
        snap = eng.stats()
        assert snap["breaker"]["state"] == "closed"
        assert snap["breaker"]["trips"] == 1
        assert snap["errors"]["prediction_failed"] == THRESHOLD
        assert snap["errors"]["circuit_open"] == 1
        assert eng.submit(seq_of(6)).result(timeout=WAIT).coords.shape == (6, 3)
    finally:
        eng.shutdown(timeout=WAIT)


def test_breaker_half_open_failure_reopens():
    eng = fake_engine(breaker_threshold=2, breaker_reset_s=10.0, call_hook=failing_hook(3))
    clock = [0.0]
    eng._breaker._clock = lambda: clock[0]
    try:
        for i in range(2):
            with pytest.raises(PredictionError):
                eng.submit(seq_of(4, offset=i)).result(timeout=WAIT)
        assert eng.stats()["breaker"]["state"] == "open"
        clock[0] = 10.0
        with pytest.raises(PredictionError):  # the probe fails (3rd failure)
            eng.submit(seq_of(4, offset=5)).result(timeout=WAIT)
        assert eng.stats()["breaker"]["state"] == "open"
        assert eng.stats()["breaker"]["trips"] == 2
        clock[0] = 20.0
        assert eng.submit(seq_of(7)).result(timeout=WAIT).coords.shape == (7, 3)
        assert eng.stats()["breaker"]["state"] == "closed"
    finally:
        eng.shutdown(timeout=WAIT)


def test_breaker_state_machine_deterministic_clock():
    t = [0.0]
    b = CircuitBreaker(threshold=2, reset_s=10.0, clock=lambda: t[0])
    assert b.allow() and b.state is CircuitState.CLOSED
    b.record_failure()
    assert b.allow()  # one failure: still closed
    b.record_failure()
    assert b.state is CircuitState.OPEN and not b.allow()
    t[0] = 9.9
    assert not b.allow()  # window not elapsed
    t[0] = 10.0
    assert b.allow()      # half-open probe claimed
    assert b.state is CircuitState.HALF_OPEN and not b.allow()
    b.abandon_probe()     # probe never dispatched
    assert b.state is CircuitState.OPEN
    assert b.allow()      # immediately reclaimable: window NOT restarted
    b.record_failure()    # probe failed: reopen, fresh window
    assert b.state is CircuitState.OPEN and not b.allow()
    t[0] = 20.0
    assert b.allow()
    b.record_success()
    assert b.state is CircuitState.CLOSED and b.snapshot()["trips"] == 2


def test_breaker_jitter_is_seeded_and_deterministic():
    def windows(seed):
        t = [0.0]
        b = CircuitBreaker(threshold=1, reset_s=10.0, jitter=0.5, seed=seed,
                           clock=lambda: t[0])
        out = []
        for _ in range(3):
            b.record_failure()
            out.append(b.snapshot()["current_reset_s"])
            t[0] += 100.0
            assert b.allow()  # half-open
        return out

    a, again, other = windows(1), windows(1), windows(2)
    assert a == again and a != other
    assert all(10.0 <= w <= 15.0 for w in a + other)


def test_hung_batch_watchdog_fails_batch_not_worker():
    """A wedged dispatch trips the watchdog: its requests fail with the
    stable hung_batch code while the worker keeps serving."""
    hung, release = [True], threading.Event()

    def hook(bucket, tokens, mask):
        if hung[0]:
            hung[0] = False
            release.wait(WAIT)

    eng = fake_engine(watchdog_timeout_s=0.25, call_hook=hook)
    try:
        with pytest.raises(HungBatchError, match="watchdog"):
            eng.submit(seq_of(4)).result(timeout=WAIT)
        assert eng.submit(seq_of(5)).result(timeout=WAIT).coords.shape == (5, 3)
        stats = eng.stats()
        assert stats["errors"]["hung_batch"] == 1
        assert stats["requests"]["completed"] == 1
    finally:
        release.set()
        eng.shutdown(timeout=WAIT)


def test_slow_request_completes_under_watchdog():
    eng = fake_engine(watchdog_timeout_s=5.0,
                      call_hook=lambda b, t, m: threading.Event().wait(0.05))
    try:
        assert eng.submit(seq_of(4)).result(timeout=WAIT).coords.shape == (4, 3)
        assert "hung_batch" not in eng.stats()["errors"]
    finally:
        eng.shutdown(timeout=WAIT)


# ------------------------------------------- real model on the CPU


def test_mixed_length_stream_compiles_at_most_len_buckets(tiny_params):
    eng = ServingEngine(tiny_params, TINY,
                        serving_cfg(max_batch=2, max_queue=16, max_wait_s=0.02,
                                    request_timeout_s=300.0), device="cpu")
    try:
        lengths = [3, 5, 8, 9, 12, 16, 4, 10, 2, 15]
        reqs = [eng.submit(seq_of(n, offset=i)) for i, n in enumerate(lengths)]
        results = [r.result(timeout=300) for r in reqs]
        assert eng.compile_count <= 2
        by_bucket = eng.stats()["compiles"]["seconds_by_bucket"]
        assert set(by_bucket) <= {"8", "16"}
        for n, res in zip(lengths, results):
            assert res.coords.shape == (n, 3)
            assert res.confidence.shape == (n,)
            assert np.isfinite(res.coords).all()
            assert np.isfinite(res.confidence).all()
            assert 0.0 <= res.confidence.min() <= res.confidence.max() <= 1.0
            assert res.bucket == (8 if n <= 8 else 16)
        again = eng.predict(seq_of(lengths[0], offset=0), timeout=WAIT)
        assert again.from_cache
        assert eng.compile_count <= 2
    finally:
        eng.shutdown()


def test_result_independent_of_batch_composition(tiny_params):
    """The cache contract (equal key == identical computation) needs a
    structure to depend only on (sequence, bucket), never on its
    batchmates."""
    eng = ServingEngine(tiny_params, TINY,
                        serving_cfg(buckets=(8,), max_batch=3, cache_capacity=0,
                                    max_wait_s=0.3, request_timeout_s=300.0), device="cpu")
    try:
        seq = seq_of(6)
        solo = eng.predict(seq, timeout=300)
        batched = [eng.submit(seq), eng.submit(seq_of(7, offset=3)),
                   eng.submit(seq_of(5, offset=8))]
        mixed = batched[0].result(timeout=300)
        assert not mixed.from_cache
        np.testing.assert_array_equal(solo.coords, mixed.coords)
        np.testing.assert_array_equal(solo.confidence, mixed.confidence)
        for r in batched[1:]:
            r.result(timeout=300)
    finally:
        eng.shutdown()


def test_engine_result_is_predict_structure_on_the_padded_batch(tiny_params):
    """A served result is `predict_structure` on the padded request, sliced
    to its length, bit for bit (the CPU executable is that function)."""
    eng = ServingEngine(tiny_params, TINY, serving_cfg(buckets=(8,), max_batch=1),
                        device="cpu")
    try:
        res = eng.predict(seq_of(6), timeout=WAIT)
    finally:
        eng.shutdown()
    tokens, mask, _ = pad_batch([aa_to_tokens(seq_of(6))], 8, 1)
    ref = predict_structure(tiny_params, TINY, tokens, mask=mask, mds_iters=4, device="cpu")
    np.testing.assert_array_equal(res.coords, ref["coords"][0, :6].numpy())
    np.testing.assert_array_equal(res.confidence, ref["confidence"][0, :6].numpy())
    assert res.stress == float(ref["stress"][0])


def test_captured_stages_compose_to_predict_structure_on_the_cpu(tiny_params):
    """The captured executable's three stages (graph one, the eager eigh,
    graph two) run here on CPU tensors, outside any graph: they are
    `predict_structure` split, bit for bit (coords, confidence, stress,
    logits) on a padded MSA batch. The card test below holds the same
    under capture."""
    from alphafold2_tpu_torch.serving.executable import CapturedExecutable

    rng = np.random.default_rng(0)
    tokens, mask, _ = pad_batch([rng.integers(0, 20, n) for n in (16, 10)], 16, 2)
    msa = rng.integers(0, 21, (2, 3, 16)).astype(np.int32)
    msa_mask = np.broadcast_to(mask[:, None], msa.shape).copy()
    exe = object.__new__(CapturedExecutable)  # the stages without a capture
    exe.params, exe.cfg, exe.device, exe.mds_iters = tiny_params, TINY, torch.device("cpu"), 6
    exe.random = False  # the classical init
    with torch.inference_mode():
        exe.tokens, exe.mask = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
        exe.msa, exe.msa_mask = torch.from_numpy(msa).long(), torch.from_numpy(msa_mask)
        exe.evals = exe.evecs = None
        exe.geo, exe.start = exe._front()
        exe._eigh()
        got = dict(exe._back(), distogram_logits=exe.logits)
    ref = predict_structure(tiny_params, TINY, tokens, mask=mask, msa=msa, msa_mask=msa_mask,
                            mds_iters=6, device="cpu")
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k
    assert exe.evecs.stride() == torch.linalg.eigh(exe.start)[1].stride()


def test_msa_configured_engine_serves_with_and_without_msa(tiny_params):
    eng = ServingEngine(tiny_params, TINY,
                        serving_cfg(buckets=(8,), max_batch=2, msa_rows=4,
                                    request_timeout_s=300.0), device="cpu")
    try:
        seq = seq_of(6)
        msa = np.stack([aa_to_tokens(seq), aa_to_tokens(seq_of(6, offset=1))])
        with_msa = eng.submit(seq, msa=msa)
        without = eng.submit(seq)
        # the same alignment under another mask is another computation
        masked = eng.submit(seq, msa=msa,
                            msa_mask=np.stack([np.ones(6, bool), np.zeros(6, bool)]))
        r1, r2 = with_msa.result(timeout=300), without.result(timeout=300)
        r3 = masked.result(timeout=300)
        assert with_msa is not without and masked is not with_msa
        assert not r3.from_cache
        assert not np.allclose(r1.coords, r3.coords)
        for r in (r1, r2):
            assert r.coords.shape == (6, 3)
            assert np.isfinite(r.coords).all() and np.isfinite(r.confidence).all()
        assert eng.compile_count == 1  # one executable covers both forms
        assert not np.allclose(r1.coords, r2.coords)  # the alignment reaches the model
        with pytest.raises(ServingError, match="at most msa_rows"):
            eng.submit(seq, msa=np.tile(aa_to_tokens(seq), (5, 1)))
    finally:
        eng.shutdown()


def test_stats_snapshot_is_json_ready():
    eng = fake_engine()
    try:
        eng.predict(seq_of(5), timeout=WAIT)
        parsed = json.loads(json.dumps(eng.stats()))
        for key in ("requests", "batches", "compiles", "errors", "latency", "queue", "cache",
                    "buckets", "captures", "launches", "device", "weights", "telemetry"):
            assert key in parsed, key
        assert parsed["latency"]["count"] == 1
        assert parsed["queue"]["capacity"] == 8
        assert parsed["device"] == "cpu"
        assert eng.health() == {"status": "ok", "closed": False, "worker_alive": True,
                                "queue_depth": 0, "queue_capacity": 8}
    finally:
        eng.shutdown()


# ------------------------------------------------- error codes (wire format)


def test_error_codes_are_stable_and_serializable():
    """Every ServingError carries a distinct stable code and a JSON wire
    form; the port's codes are the JAX package's, class by class."""
    from alphafold2_tpu.serving import errors as jax_errors

    classes = [c for c in vars(errors).values()
               if isinstance(c, type) and issubclass(c, errors.ServingError)]
    assert len(classes) == 15
    assert len({c.code for c in classes}) == len(classes)  # codes distinct
    for cls in classes:
        assert cls.code == getattr(jax_errors, cls.__name__).code
        assert cls.http_status == getattr(jax_errors, cls.__name__).http_status
        exc = cls("boom")
        assert json.loads(json.dumps(exc.to_json())) == {
            "code": cls.code, "error": cls.__name__, "message": "boom"}


def test_retry_after_s_rides_the_wire_format():
    exc = QueueFullError("full", retry_after_s=1.5)
    assert exc.retry_after_s == 1.5
    assert exc.to_json()["retry_after_s"] == 1.5
    assert "retry_after_s" not in QueueFullError("full").to_json()


def test_engine_queue_full_carries_retry_after():
    hook, entered, release = blocking_hook()
    eng = fake_engine(max_queue=1, max_batch=1, max_wait_s=0.0, call_hook=hook)
    try:
        first = eng.submit(seq_of(3))
        assert entered.wait(WAIT)
        eng.submit(seq_of(4))
        with pytest.raises(QueueFullError) as exc_info:
            eng.submit(seq_of(5))
        assert exc_info.value.retry_after_s is not None
        assert exc_info.value.retry_after_s > 0
        release.set()
        first.result(timeout=WAIT)
    finally:
        release.set()
        eng.shutdown()


def test_per_code_error_counts_surface_in_stats():
    eng = fake_engine()
    try:
        with pytest.raises(InvalidSequenceError):
            eng.submit("ACXZ")
        with pytest.raises(RequestTooLongError):
            eng.submit(seq_of(17))
        with pytest.raises(InvalidSequenceError):
            eng.submit("")
        errs = eng.stats()["errors"]
        assert errs["invalid_sequence"] == 2
        assert errs["sequence_too_long"] == 1
    finally:
        eng.shutdown()
    with pytest.raises(EngineClosedError):
        eng.submit(seq_of(4))
    assert eng.stats()["errors"]["engine_closed"] == 1


# ------------------------------------------------- config tag and residency


def test_config_tag_covers_weight_dtype_gate_and_sparse(tiny_params):
    """The result cache keys on the config tag, which must never alias
    results across the gated attention (other math and params), the int8
    arm (rounded weights) or the block-sparse layers. The tag reprs the
    whole Alphafold2Config, so each lands in it by construction."""
    scfg = serving_cfg(buckets=(8,))
    variants = {
        "base": TINY,
        "gated": dataclasses.replace(TINY, attn_gate=True),
        "int8": dataclasses.replace(TINY, weight_dtype="int8"),
        "sparse": dataclasses.replace(TINY, sparse_self_attn=True),
        "bf16": dataclasses.replace(TINY, dtype=torch.bfloat16),
    }
    tags = {}
    for name, cfg in variants.items():
        params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu")
        eng = ServingEngine(params, cfg, scfg, device="cpu")
        tags[name] = eng.config_tag
        eng.shutdown(drain=False)
    assert len(set(tags.values())) == len(tags), tags


def test_config_tag_covers_the_device_and_the_ladder(tiny_params):
    """The port's counterpart of the JAX engine's backend-arm pin: the
    card's kernels and the CPU's plain versions agree only to rounding, so
    the tag carries the device type; the same settings give the same tag,
    another ladder or batch ladder another."""
    engines = [ServingEngine(tiny_params, TINY, serving_cfg(**kw), device="cpu")
               for kw in ({}, {}, {"buckets": (16,)}, {"batch_ladder": True})]
    try:
        tags = [e.config_tag for e in engines]
        assert tags[0] == tags[1]
        assert len({tags[0], tags[2], tags[3]}) == 3
        assert "'cpu'" in tags[0]
    finally:
        for e in engines:
            e.shutdown(drain=False)


def test_engine_int8_quantizes_at_build_and_serves(tiny_params):
    """weight_dtype='int8': the engine serves the PTQ tree (qw/scale
    leaves, fewer bytes), reports the residency in stats() and the
    serving_weight_bytes gauge, and serves finite structures."""
    from alphafold2_tpu_torch.ops.quant import is_quantized_linear, iter_linear_dicts
    from alphafold2_tpu_torch.serving.quant_residency import clear_residency_cache

    clear_residency_cache()
    eng = ServingEngine(tiny_params, dataclasses.replace(TINY, weight_dtype="int8"),
                        serving_cfg(buckets=(8,), max_batch=2), device="cpu")
    try:
        assert [p for p, d in iter_linear_dicts(eng._params) if is_quantized_linear(d)]
        res = eng._weight_residency
        assert res["weight_dtype"] == "int8"
        assert res["weight_bytes"] < res["fp32_weight_bytes"]
        r = eng.predict(seq_of(6), timeout=WAIT)
        assert np.isfinite(r.coords).all() and np.isfinite(r.confidence).all()
        st = eng.stats()
        assert st["weights"]["weight_dtype"] == "int8"
        assert st["weights"]["weight_bytes"] == res["weight_bytes"]
        gauges = st["telemetry"]["metrics"]["gauges"]
        assert any(k.startswith("serving_weight_bytes") and v == res["weight_bytes"]
                   for k, v in gauges.items())
    finally:
        eng.shutdown(drain=False)
        clear_residency_cache()


def test_params_on_another_device_are_refused(tiny_params):
    meta = dict(tiny_params, head_out={"w": tiny_params["head_out"]["w"].to("meta"),
                                       "b": tiny_params["head_out"]["b"]})
    with pytest.raises(ValueError, match="parameters lie on"):
        ServingEngine(meta, TINY, serving_cfg(), device="cpu")


# ------------------------------------------------- the refused knobs


# early exit, the SP arm and pipelined dispatch are ported: a knob alone is
# now JAX's validation error (each early-exit knob needs the other; one
# shard is no SP arm; a negative depth is no window), the test of its
# message under the knob's old id
@pytest.mark.parametrize("fields, exc, match", [
    ({"sp_shards": 1}, ValueError, r"sp_shards must be 0 \(dense\) or >= 2"),
    ({"sp_schedules": ((16, "sp_seq"),)}, ValueError, "sp_shards=0"),
    ({"early_exit_depths": (1, 2)}, ValueError, "early_exit_kl must be > 0"),
    ({"early_exit_kl": 0.1}, ValueError, "without early_exit_depths"),
    ({"pipeline_depth": -1}, ValueError, "pipeline_depth must be >= 0"),
], ids=["sp_shards", "sp_schedules", "early_exit_depths", "early_exit_kl", "pipeline_depth"])
def test_refused_config_knob_names_its_roadmap_item(fields, exc, match):
    with pytest.raises(exc, match=match):
        serving_cfg(**fields)
    if "pipeline_depth" in fields:
        # the knob is taken: a depth-2 engine serves through its settle thread
        eng = fake_engine(pipeline_depth=2)
        try:
            assert eng.predict(seq_of(5), timeout=WAIT).coords.shape == (5, 3)
            assert eng.stats()["pipeline"]["depth"] == 2 and eng.health()["settle_alive"]
        finally:
            eng.shutdown()


@pytest.mark.parametrize("seam, item", [("fault_hook", "A11b"), ("pool_name", "A11b-3"),
                                        ("model_apply_fn", "A11b")])
def test_refused_engine_seam_names_its_roadmap_item(seam, item, tiny_params):
    """The engine's seams, each refused naming `item` until its part was
    ported, are taken now: `pool_name` labels the engine's cost cells,
    `fault_hook` runs at each dispatch, and `model_apply_fn` (the forward
    override) replaces the forward of every bucket's executable."""
    if seam == "model_apply_fn":
        from alphafold2_tpu_torch import alphafold2_apply

        calls = []

        def forward(*args, **kwargs):
            calls.append(args[2].shape)
            return alphafold2_apply(*args, device="cpu", **kwargs)

        cfg = serving_cfg(buckets=(8,), max_batch=1)
        plain = ServingEngine(tiny_params, TINY, cfg, device="cpu")
        over = ServingEngine(tiny_params, TINY, cfg, device="cpu", model_apply_fn=forward)
        try:
            a, b = plain.predict(seq_of(6), timeout=WAIT), over.predict(seq_of(6), timeout=WAIT)
        finally:
            plain.shutdown()
            over.shutdown()
        assert calls == [(1, 8)] and np.array_equal(a.coords, b.coords)
        return
    calls = []
    value = "short" if seam == "pool_name" else (lambda i, b: calls.append((i, b)))
    eng = FakeModelEngine({}, TINY, serving_cfg(buckets=(8,), max_batch=1), device="cpu",
                          **{seam: value})
    try:
        eng.predict(seq_of(5), timeout=WAIT)
        assert eng.cell_for(8)["pool"] == ("short" if seam == "pool_name" else "default")
        assert calls == ([(0, 8)] if seam == "fault_hook" else [])
    finally:
        eng.shutdown()


def test_random_mds_init_serves_on_the_cpu(tiny_params):
    eng = ServingEngine(tiny_params, TINY,
                        serving_cfg(buckets=(8,), max_batch=1, mds_init="random",
                                    cache_capacity=0), device="cpu")
    try:
        a, b = (eng.predict(seq_of(6), timeout=WAIT) for _ in range(2))
        assert np.isfinite(a.coords).all()
        assert not np.array_equal(a.coords, b.coords)  # a fresh draw each batch
    finally:
        eng.shutdown()


@pytest.mark.parametrize("flag", [
    ["--replicas", "2"], ["--fault-plan", "plan.json"], ["--artifact-store", "auto"],
    ["--journal", "auto"], ["--featurize-workers", "2"], ["--retry-budget", "8"],
    ["--cascade", "{}"]], ids=["replicas", "fault_plan", "artifact_store", "journal",
                               "featurize_workers", "retry_budget", "cascade"])
def test_cli_refuses_fleet_flags(flag, tmp_path, capsys):
    """These flags were refused (ROADMAP A11b-3) until the fleet was ported.
    Each is taken now with the JAX CLI's meaning: the fleet's selectors
    (--replicas, --featurize-workers) run the demo through the fleet, the
    store and the journal without one print the JAX CLI's warning, a
    retry budget without one is unused, --cascade without --pools is the
    JAX CLI's refusal, and a plan loads and delivers."""
    from alphafold2_tpu_torch import serve

    flag = list(flag)
    if flag[0] == "--fault-plan":
        plan = tmp_path / "plan.json"
        plan.write_text(json.dumps({"faults": [{"kind": "slow_request", "at": 0,
                                                "delay_s": 0.0}]}))
        flag[1] = str(plan)
    if flag[0] == "--cascade":
        with pytest.raises(SystemExit):
            serve.main(["--demo", "2", "--device", "cpu", *flag])
        assert "--cascade requires --pools" in capsys.readouterr().err
        return
    rc = serve.main(["--demo", "2", "--buckets", "16", "--dim", "16", "--depth", "1",
                     "--heads", "2", "--dim-head", "8", "--mds-iters", "2", "--device", "cpu",
                     *flag])
    printed = capsys.readouterr().out
    assert rc == 0
    if flag[0] in ("--replicas", "--featurize-workers"):
        assert "fleet served" in printed
    elif flag[0] == "--fault-plan":
        assert "faults delivered: ['slow_request@0']" in printed
    elif flag[0] in ("--artifact-store", "--journal"):
        assert "WARNING" in printed and "fleet mode only" in printed


# ------------------------------------------------- the CLI


def test_cli_demo_replays_through_the_engine(tmp_path, capsys):
    """The port's serve.py on the CPU (the verify skill's flow): a demo
    stream over two buckets, twice; one executable a bucket, batches of
    more than one, the second pass from the cache, a parseable PDB a
    record."""
    from alphafold2_tpu_torch import serve
    from alphafold2_tpu_torch.geometry.pdb import parse_pdb

    stats_path, out_dir = tmp_path / "stats.json", tmp_path / "pdb"
    rc = serve.main(["--demo", "12", "--buckets", "8,16", "--max-batch", "4", "--mds-iters",
                     "4", "--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8",
                     "--passes", "2", "--device", "cpu", "--stats-json", str(stats_path),
                     "--out-dir", str(out_dir)])
    assert rc == 0
    stats = json.loads(stats_path.read_text())
    assert stats["compiles"]["count"] <= 2
    assert stats["batches"]["mean_requests_per_batch"] > 1
    assert stats["requests"]["failed"] == 0
    assert stats["cache"]["hit_rate"] > 0
    pdbs = sorted(out_dir.glob("*.pdb"))
    assert len(pdbs) >= 12
    structure = parse_pdb(str(pdbs[0]))
    assert np.isfinite(structure.coords()).all()
    assert "served" in capsys.readouterr().out


def test_cli_defaults_match_the_jax_cli():
    """Every flag the two serve CLIs share parses to the same default
    (`--request-timeout` 600 s, as JAX's; `--device` is the port's own)."""
    import argparse
    import importlib.util
    import pathlib

    from alphafold2_tpu_torch import serve

    class Parsed(Exception):
        pass

    def parser_of(main):
        real = argparse.ArgumentParser.parse_args

        def capture(self, *args, **kwargs):
            raise Parsed(self)

        argparse.ArgumentParser.parse_args = capture
        try:
            main()
        except Parsed as e:
            return {o: a.default for a in e.args[0]._actions for o in a.option_strings}
        finally:
            argparse.ArgumentParser.parse_args = real
        raise AssertionError("the CLI never parsed its arguments")

    spec = importlib.util.spec_from_file_location(
        "jax_serve_cli", pathlib.Path(__file__).resolve().parents[1] / "serve.py")
    jserve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jserve)
    jax_defaults, port_defaults = parser_of(jserve.main), parser_of(serve.main)
    assert set(port_defaults) - set(jax_defaults) == {"--device"}
    assert set(jax_defaults) <= set(port_defaults)
    assert {o: port_defaults[o] for o in jax_defaults} == jax_defaults
    assert port_defaults["--request-timeout"] == 600.0


# ------------------------------------------------- against the JAX engine


def test_engine_matches_the_jax_engine_on_the_same_weights():
    """The port's engine against the JAX `ServingEngine` on the same
    weights (`params_from_jax`), the same mixed-length stream (some with
    MSAs) and buckets (8, 16). MDS is fixed only up to a rigid transform,
    so coordinates are compared through pairwise distances (1e-3 A),
    with confidence 5e-6 and stress 1e-4 relative (tests/test_torch_
    pipeline.py's request tolerances: the same float32 function in another
    summation order, 50 Guttman steps)."""
    import jax

    from alphafold2_tpu.models import Alphafold2Config as JaxConfig
    from alphafold2_tpu.models import alphafold2_init as jax_init
    from alphafold2_tpu.serving import ServingConfig as JaxServingConfig
    from alphafold2_tpu.serving import ServingEngine as JaxServingEngine
    from alphafold2_tpu_torch import params_from_jax

    kw = dict(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=16)
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig(**kw))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              Alphafold2Config(**kw), device="cpu")
    scfg = dict(buckets=(8, 16), max_batch=2, max_wait_s=0.02, msa_rows=2, mds_iters=50,
                request_timeout_s=300.0)
    rng = np.random.default_rng(0)
    stream = []
    for i, n in enumerate([3, 5, 8, 9, 12, 16, 6, 14]):
        seq = seq_of(n, offset=i)
        msa = None
        if i % 2:
            msa = np.stack([aa_to_tokens(seq), rng.integers(0, 21, n)]).astype(np.int32)
        stream.append((seq, msa))
    jeng = JaxServingEngine(jparams, JaxConfig(**kw), JaxServingConfig(**scfg))
    teng = ServingEngine(tparams, Alphafold2Config(**kw), ServingConfig(**scfg), device="cpu")
    try:
        jres = [r.result(timeout=300) for r in [jeng.submit(s, msa=m) for s, m in stream]]
        tres = [r.result(timeout=300) for r in [teng.submit(s, msa=m) for s, m in stream]]
    finally:
        jeng.shutdown()
        teng.shutdown()

    def pairwise(c):
        c = np.asarray(c, np.float64)
        return np.linalg.norm(c[:, None] - c[None], axis=-1)

    for (seq, _), j, t in zip(stream, jres, tres):
        assert t.bucket == j.bucket and t.coords.shape == (len(seq), 3)
        np.testing.assert_allclose(t.confidence, j.confidence, rtol=0, atol=5e-6)
        np.testing.assert_allclose(t.stress, j.stress, rtol=1e-4)
        np.testing.assert_allclose(pairwise(t.coords), pairwise(j.coords), rtol=0, atol=1e-3)
    assert teng.compile_count == jeng.compile_count == 2


# ------------------------------------------------- the card


@pytest.mark.cuda
def test_captured_request_matches_eager_bit_for_bit():
    """On the card every (bucket, rung) is a captured graph pair: its
    request equals eager `predict_structure` on the same padded inputs bit
    for bit (coords, confidence, stress, logits), on a first batch and
    again on a second one (new inputs through the same graphs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine captures CUDA graphs there")
    from alphafold2_tpu_torch.serving.executable import CapturedExecutable, GraphPool

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Alphafold2Config(dim=64, depth=2, heads=4, dim_head=64, max_seq_len=64,
                           dtype=torch.bfloat16)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    exe = CapturedExecutable(params, cfg, batch=2, bucket=64, msa_rows=4, mds_iters=20,
                             device=torch.device("cuda", 0), pool=GraphPool())
    rng = np.random.default_rng(0)
    for _ in range(2):
        rows = [rng.integers(0, 20, n).astype(np.int32) for n in (64, 50)]
        tokens, mask, _ = pad_batch(rows, 64, 2)
        msa = rng.integers(0, 21, (2, 4, 64)).astype(np.int32)
        msa_mask = np.broadcast_to(mask[:, None], msa.shape).copy()
        got = exe(tokens, mask, msa, msa_mask)
        got["distogram_logits"] = exe.logits.clone()
        ref = predict_structure(params, cfg, tokens, mask=mask, msa=msa, msa_mask=msa_mask,
                                mds_iters=20, device="cuda")
        for k, v in got.items():
            assert torch.equal(v, ref[k]), k
    assert exe.launches.get("flash_fwd_wgmma") == 12


@pytest.mark.cuda
def test_engine_on_the_card_serves_captured_requests():
    """The engine on the card, sequence-only (msa_rows 0), buckets (32,
    64), the batch ladder: a mixed stream completes through captured
    graph pairs (at most buckets x rungs captures, the flash forwards
    replayed on the wgmma route), and a served result equals eager
    `predict_structure` on its padded batch, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine captures CUDA graphs there")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Alphafold2Config(dim=64, depth=2, heads=4, dim_head=64, max_seq_len=64,
                           dtype=torch.bfloat16)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    eng = ServingEngine(params, cfg, ServingConfig(buckets=(32, 64), max_batch=4,
                                                   batch_ladder=True, mds_iters=20,
                                                   max_wait_s=0.02))
    try:
        lengths = [20, 64, 33, 5, 40, 31, 64, 12]
        reqs = [eng.submit(seq_of(n, offset=i)) for i, n in enumerate(lengths)]
        results = [r.result(timeout=300) for r in reqs]
        solo = eng.submit(seq_of(10, offset=3)).result(timeout=300)
        stats = eng.stats()
    finally:
        eng.shutdown()
    for n, res in zip(lengths, results):
        assert res.coords.shape == (n, 3) and np.isfinite(res.coords).all()
    assert len(stats["captures"]) <= 2 * 3 and stats["requests"]["failed"] == 0
    assert stats["launches"]["flash_fwd"] == stats["launches"]["flash_fwd_wgmma"] > 0
    tokens, mask, _ = pad_batch([aa_to_tokens(seq_of(10, offset=3))], 32, 1)
    ref = predict_structure(params, cfg, tokens, mask=mask, mds_iters=20, device="cuda")
    np.testing.assert_array_equal(solo.coords, ref["coords"][0, :10].cpu().numpy())
    np.testing.assert_array_equal(solo.confidence, ref["confidence"][0, :10].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mds_init, exits", [("classical", ()), ("random", ()),
                                             ("classical", (1, 2, 3))],
                         ids=["classical", "random", "staged"])
def test_enqueued_call_matches_the_synchronous_call_bit_for_bit(mds_init, exits):
    """On the card the pipelined call (`CapturedExecutable.enqueue`: pinned
    copies in and out, an event after them, the host reads waited for by
    polling) returns what the synchronous call returns, bit for bit, with
    two calls in flight at once (staged: every stage replayed); a waited
    call puts its slot back, and its timing events give device seconds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine captures CUDA graphs there")
    from alphafold2_tpu_torch.serving.executable import CapturedExecutable, GraphPool
    from alphafold2_tpu_torch.utils.rng import Streams

    cfg = Alphafold2Config(dim=64, depth=4 if exits else 2, heads=4, dim_head=64,
                           max_seq_len=64, dtype=torch.bfloat16)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    streams = Streams("cuda") if mds_init == "random" else None
    exe = CapturedExecutable(params, cfg, batch=2, bucket=64, msa_rows=4, mds_iters=20,
                             device=torch.device("cuda", 0), pool=GraphPool(),
                             mds_init=mds_init, streams=streams, slots=2,
                             early_exit_depths=exits, early_exit_kl=1e-12 if exits else 0.0)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        rows = [rng.integers(0, 20, n).astype(np.int32) for n in (64, 50)]
        tokens, mask, _ = pad_batch(rows, 64, 2)
        msa = rng.integers(0, 21, (2, 4, 64)).astype(np.int32)
        batches.append((tokens, mask, msa, np.broadcast_to(mask[:, None], msa.shape).copy()))
    pending = [exe.enqueue(*b, seed=7 + i, timing=i == 0) for i, b in enumerate(batches)]
    got = [p.wait() for p in pending]
    assert len(exe._slots) == 2 and pending[0].device_s > 0 and pending[1].device_s is None
    for i, b in enumerate(batches):
        ref = {k: v.cpu().numpy() for k, v in exe(*b, seed=7 + i).items()}
        for k in ref:
            assert np.array_equal(got[i][k], ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("kl", [1e-12, 1e9], ids=["none", "all"])
def test_captured_staged_request_matches_eager_bit_for_bit(kl):
    """On the card: the staged request captured one graph a stage replays
    to the eager staged `predict_structure` bit for bit, and a skipped
    stage's graph is not replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine captures CUDA graphs there")
    from alphafold2_tpu_torch.serving.executable import CapturedExecutable, GraphPool

    cfg = Alphafold2Config(dim=64, depth=4, heads=4, dim_head=64, max_seq_len=64,
                           dtype=torch.bfloat16)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    exe = CapturedExecutable(params, cfg, batch=2, bucket=64, msa_rows=4, mds_iters=20,
                             device=torch.device("cuda", 0), pool=GraphPool(),
                             early_exit_depths=(1, 2, 3), early_exit_kl=kl)
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 20, n).astype(np.int32) for n in (64, 50)]
    tokens, mask, _ = pad_batch(rows, 64, 2)
    msa = rng.integers(0, 21, (2, 4, 64)).astype(np.int32)
    msa_mask = np.broadcast_to(mask[:, None], msa.shape).copy()
    got = exe(tokens, mask, msa, msa_mask)
    got["distogram_logits"] = exe.logits.clone()
    ref = predict_structure(params, cfg, tokens, mask=mask, msa=msa, msa_mask=msa_mask,
                            mds_iters=20, device="cuda", early_exit_depths=(1, 2, 3),
                            early_exit_kl=kl)
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k
    assert exe.stage_replays == ([1, 1, 1, 1] if kl < 1 else [1, 1, 0, 0])
