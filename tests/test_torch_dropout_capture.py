"""Live dropout in the train step and the serving engine's random MDS init,
drawn at fixed positions (alphafold2_tpu_torch/utils/rng.py), so that a
CUDA graph replays them: `training/executable.py CapturedTrainStep` and
`serving/executable.py CapturedExecutable`.

On the CPU, at a small size: the positions (`fold_in`, `Streams`, `Key`)
are a function of the seed and the path only, whatever drew first; each
pass of a position is seeded alike; a capture registers every generator
and refuses a new one. Dropout draws nothing in eval mode. The eager step
with dropout gives the same loss and gradients, bit for bit, for the same
rng, other ones for another; each microbatch and each layer draws its
own masks; remat under each remat_policy and branch_parallel equal the
plain step bit for bit; each layer's realized keep share lies within 4
sigma of 1 - rate, with the kept values scaled by 1 / (1 - rate) (JAX's
inverted dropout: its masks cannot be matched, the two random streams
differ). The engine's random init is a function of (seed, call index),
within [-1, 1], and the captured executable's stages with it compose to
`predict_structure` bit for bit.

On the card (marked `cuda`, skipped here): the captured step against the
eager step from the same params, batches and rngs, bit for bit on loss,
grad_norm and every param over 3 steps, with attention and feed-forward
dropout and an MSA stream (sequential, remat "dots", branch_parallel,
reversible); one batch under two rngs gives two losses. The engine with
mds_init="random" against the eager `predict_structure` on the card with
the same seed, bit for bit; two call indices give two inits. These import
only torch and the port:

    python -m pytest --noconftest -m cuda tests/test_torch_dropout_capture.py -q
"""

import math

import numpy as np
import pytest
import torch

from alphafold2_tpu_torch import Alphafold2Config
from alphafold2_tpu_torch.constants import aa_to_tokens
from alphafold2_tpu_torch.geometry.mds import initial_coords
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_init
from alphafold2_tpu_torch.ops import attention, core, feedforward
from alphafold2_tpu_torch.serving import pipeline
from alphafold2_tpu_torch.serving.bucketing import pad_batch
from alphafold2_tpu_torch.serving.engine import ServingConfig, ServingEngine
from alphafold2_tpu_torch.serving.executable import CapturedExecutable, _init_generator
from alphafold2_tpu_torch.serving.pipeline import predict_structure
from alphafold2_tpu_torch.training import data, harness
from alphafold2_tpu_torch.utils import rng as rng_mod
from alphafold2_tpu_torch.utils.rng import Streams, as_key, fold_in, path_seed

SMALL = dict(dim=16, depth=2, heads=2, dim_head=8, max_seq_len=32)
RATES = dict(attn_dropout=0.2, ff_dropout=0.2)


# --- positions --------------------------------------------------------------


def test_fold_in_is_a_function_of_seed_and_data():
    assert fold_in(7, 3) == fold_in(7, 3)
    assert fold_in(7, "trunk") == fold_in(7, "trunk")
    seeds = {fold_in(s, d) for s in range(4) for d in (0, 1, 2, "trunk", "tower")}
    assert len(seeds) == 20
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert path_seed(5, (1, "trunk", 2)) == fold_in(fold_in(fold_in(5, 1), "trunk"), 2)
    assert path_seed(5, ()) == 5


def test_a_positions_draws_do_not_depend_on_what_drew_first():
    paths = [(0, "trunk", 0), (0, "trunk", 1), (1, "trunk", 0)]
    draws = []
    for order in (paths, paths[::-1]):
        streams = Streams("cpu", seed=11)
        got = {p: torch.rand(64, generator=streams.key().fold_in(*p).generator())
               for p in order}
        draws.append(got)
    for p in paths:
        assert torch.equal(draws[0][p], draws[1][p])
    assert not torch.equal(draws[0][paths[0]], draws[0][paths[1]])


def test_each_pass_of_a_position_starts_at_its_seed():
    """A recompute (remat, the reversible backward) takes the position's
    next pass: another generator, seeded alike; set_seed starts the
    passes again and reseeds every generator."""
    streams = Streams("cpu", seed=3)
    key = streams.key().fold_in(0, "trunk", 1)
    g0, g1 = key.generator(), key.generator()
    assert g0 is not g1
    a, b = torch.rand(32, generator=g0), torch.rand(32, generator=g1)
    assert torch.equal(a, b)
    streams.set_seed(4)
    assert key.generator() is g0 and key.generator() is g1
    c = torch.rand(32, generator=g0)
    assert not torch.equal(a, c)
    assert torch.equal(c, torch.rand(32, generator=torch.Generator().manual_seed(key.seed)))


class _Graph:
    """What `Streams.capturing` asks of a graph."""

    def __init__(self):
        self.registered = []

    def register_generator_state(self, generator):
        self.registered.append(generator)


def test_capturing_registers_every_generator_and_refuses_a_new_one():
    streams = Streams("cpu")
    key = streams.key()
    made = [key.fold_in(i).generator() for i in range(3)]
    graph = _Graph()
    with streams.capturing(graph):
        assert graph.registered == made
        assert key.fold_in(1).generator() is made[1]  # the passes start from 0
        with pytest.raises(RuntimeError, match="not drawn before the capture"):
            key.fold_in(1).generator()  # a second pass the warm-up did not draw
    key.fold_in(7).generator()  # outside a capture a position is made at its first use
    with pytest.raises(RuntimeError, match="register_generator_state"):
        with streams.capturing(object()):
            pass


def test_as_key_takes_a_key_a_generator_or_none():
    assert as_key(None, "cpu") is None
    key = Streams("cpu", seed=9).key()
    assert as_key(key, "cpu") is key
    rng = torch.Generator().manual_seed(2)
    want = int(torch.randint(2 ** 62, (), generator=torch.Generator().manual_seed(2)))
    assert as_key(rng, "cpu").seed == want
    assert as_key(rng, "cpu").seed != want  # one draw a call


def test_dropout_draws_nothing_in_eval_mode():
    x = torch.randn(4, 8)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    assert core.dropout(x, 0.0, gen) is x
    assert core.dropout(x, 0.3, None) is x
    assert torch.equal(gen.get_state(), state)


# --- the eager step ---------------------------------------------------------


def _step(cfg, rngs, msa_rows=3, accum=2, seed=0):
    """make_train_step over two batches with the given rngs (CPU
    generators made from these seeds, or None): per step (loss,
    grad_norm) and the final leaves."""
    tt = harness.TrainConfig(grad_accum=accum, max_grad_norm=1.0)
    state = harness.train_state_init(cfg, tt, torch.Generator().manual_seed(seed), "cpu")
    step = harness.make_train_step(cfg, tt, device="cpu")
    fetch = data.synthetic_microbatch_fn(
        data.DataConfig(max_len=12, msa_rows=msa_rows, seed=1), accum)
    out = []
    for n, r in enumerate(rngs):
        _, m = step(state, fetch(n), None if r is None else torch.Generator().manual_seed(r))
        out.append((m["loss"], m["grad_norm"]))
    return out, [p.detach().clone() for p in state["optimizer"].leaves]


def _equal(a, b):
    (ma, la), (mb, lb) = a, b
    return (all(torch.equal(x, y) for pa, pb in zip(ma, mb) for x, y in zip(pa, pb))
            and all(torch.equal(x, y) for x, y in zip(la, lb)))


def test_the_step_draws_from_its_rng():
    """The same rng: the same loss, grad_norm and params, bit for bit;
    another rng: others; no rng: eval mode, the step of a config without
    dropout."""
    cfg = Alphafold2Config(**SMALL, **RATES)
    a, b = _step(cfg, [5, 6]), _step(cfg, [5, 6])
    assert _equal(a, b)
    c = _step(cfg, [7, 6])
    assert not torch.equal(a[0][0][0], c[0][0][0])
    assert _equal(_step(cfg, [None, None]), _step(Alphafold2Config(**SMALL), [None, None]))


SCHEDULES = {
    "remat": dict(remat=True),
    "remat-dots": dict(remat=True, remat_policy="dots"),
    "remat-dots_no_batch": dict(remat=True, remat_policy="dots_no_batch"),
    "branch_parallel": dict(trunk_schedule="branch_parallel"),
    "branch_parallel-remat-dots": dict(trunk_schedule="branch_parallel", remat=True,
                                       remat_policy="dots"),
}


@pytest.mark.parametrize("fields", list(SCHEDULES.values()), ids=list(SCHEDULES))
def test_recompute_and_schedule_draw_the_plain_masks(fields):
    """A remat recompute takes its layer's second pass and the MSA branch
    draws in the serial order: with live dropout and an MSA stream, two
    microbatches and two steps, the step is the plain one bit for bit."""
    plain = _step(Alphafold2Config(**SMALL, **RATES), [5, 6])
    assert _equal(_step(Alphafold2Config(**SMALL, **RATES, **fields), [5, 6]), plain)


def test_the_reversible_step_draws_from_its_rng():
    """The reversible step (the backward rebuilds each block at its
    position's second pass): the same rng gives the same step bit for bit,
    another rng another; it takes the oracle's masks
    (tests/test_torch_reversible.py holds reverse against plain autograd)."""
    cfg = Alphafold2Config(**dict(SMALL, depth=1), **RATES, reversible=True)
    a, b = _step(cfg, [5, 6]), _step(cfg, [5, 6])
    assert _equal(a, b)
    assert not torch.equal(a[0][0][0], _step(cfg, [8, 6])[0][0][0])


class _Record:
    """Wraps `ops.core.dropout` where the trunk's ops call it: each live
    call's rate, generator, mask (drawn again from a copy of the
    generator's state) and whether the output is the input masked and
    scaled by 1 / (1 - rate)."""

    def __init__(self, monkeypatch):
        self.calls = []
        for module in (attention, feedforward):
            monkeypatch.setattr(module, "dropout", self)

    def __call__(self, x, rate, generator=None):
        if rate == 0.0 or generator is None:
            return core.dropout(x, rate, generator)
        copy = torch.Generator().set_state(generator.get_state())
        keep = torch.rand(x.shape, generator=copy, device=x.device) >= rate
        y = core.dropout(x, rate, generator)
        scaled = torch.equal(y, torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)))
        self.calls.append((rate, generator, keep, scaled))
        return y


def _paths(streams):
    return {id(g): path for path, gens in streams._generators.items() for g in gens}


def test_each_microbatch_and_layer_draws_its_own_masks(monkeypatch):
    """Two microbatches, two layers: four positions (microbatch, "trunk",
    layer), each with its own seed, each drawing a layer's masks (its ops
    in turn); no two positions' first masks agree."""
    made = []
    monkeypatch.setattr(rng_mod, "Streams", lambda *a, **k: made.append(
        Streams(*a, **k)) or made[-1])
    rec = _Record(monkeypatch)
    cfg = Alphafold2Config(**SMALL, **RATES)
    _step(cfg, [5])
    (streams,) = made
    paths = _paths(streams)
    by_path = {}
    for rate, gen, keep, _ in rec.calls:
        by_path.setdefault(paths[id(gen)], []).append(keep)
    assert sorted(by_path) == [(i, "trunk", layer) for i in range(2) for layer in range(2)]
    assert len({path_seed(streams.seed, p) for p in by_path}) == 4
    firsts = [masks[0] for masks in by_path.values()]
    for i, a in enumerate(firsts):
        for b in firsts[i + 1:]:
            assert a.shape != b.shape or not torch.equal(a, b)
    # a layer's ops draw in turn: the two passes of the pair's axial
    # attention and of the MSA's, the two crosses, the two feed-forwards
    assert [len(masks) for masks in by_path.values()] == [8] * 4


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_share_and_scale_per_layer(monkeypatch, rate):
    """Each layer's realized keep share (all its masks) lies within 4 sigma
    of 1 - rate, and each kept value is the input scaled by 1 / (1 -
    rate), dropped ones zero: JAX's inverted dropout in distribution."""
    made = []
    monkeypatch.setattr(rng_mod, "Streams", lambda *a, **k: made.append(
        Streams(*a, **k)) or made[-1])
    rec = _Record(monkeypatch)
    _step(Alphafold2Config(**SMALL, attn_dropout=rate, ff_dropout=rate), [3], accum=1)
    paths = _paths(made[0])
    kept, total = {}, {}
    for r, gen, keep, scaled in rec.calls:
        assert r == rate and scaled
        p = paths[id(gen)]
        kept[p] = kept.get(p, 0) + int(keep.sum())
        total[p] = total.get(p, 0) + keep.numel()
    assert len(total) == SMALL["depth"]
    for p in total:
        q = 1.0 - rate
        sigma = math.sqrt(q * (1.0 - q) / total[p])
        assert abs(kept[p] / total[p] - q) <= 4 * sigma, (p, kept[p] / total[p])


# --- the engine's random init -------------------------------------------------


TINY = Alphafold2Config(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)


@pytest.fixture(scope="module")
def tiny_params():
    return alphafold2_init(TINY, torch.Generator().manual_seed(0), "cpu")


def test_initial_coords_from_a_cpu_generator_keeps_its_bits():
    d = torch.rand(2, 7, 7)
    got = initial_coords(d, "random", torch.Generator().manual_seed(4))
    want = 2.0 * torch.rand((2, 7, 3), generator=torch.Generator().manual_seed(4)) - 1.0
    assert torch.equal(got, want)


def _engine_inits(params, monkeypatch, seed, n):
    """Serve one request n times through a CPU engine with the random init;
    the init of each call."""
    inits = []

    def record(distances, init, generator):
        out = initial_coords(distances, init, generator)
        inits.append(out.clone())
        return out

    monkeypatch.setattr(pipeline, "initial_coords", record)
    eng = ServingEngine(params, TINY, ServingConfig(buckets=(8,), max_batch=1, mds_iters=3,
                                                    mds_init="random", cache_capacity=0,
                                                    seed=seed), device="cpu")
    try:
        for _ in range(n):
            eng.predict("MKTAYIA", timeout=30)
    finally:
        eng.shutdown()
    return eng, inits


def test_engine_random_init_is_a_function_of_seed_and_call_index(tiny_params, monkeypatch):
    eng, a = _engine_inits(tiny_params, monkeypatch, seed=3, n=2)
    _, b = _engine_inits(tiny_params, monkeypatch, seed=3, n=1)
    _, c = _engine_inits(tiny_params, monkeypatch, seed=4, n=1)
    assert torch.equal(a[0], b[0])          # (3, 1) twice
    assert not torch.equal(a[0], a[1])      # (3, 1) vs (3, 2)
    assert not torch.equal(a[0], c[0])      # (3, 1) vs (4, 1)
    assert all(bool((t >= -1).all() and (t <= 1).all()) for t in a + b + c)
    assert eng.init_seed(2) == fold_in(3, 2)
    want = 2.0 * torch.rand((1, 8, 3), generator=torch.Generator().manual_seed(
        fold_in(3, 2))) - 1.0
    assert torch.equal(a[1], want)


def test_random_init_stages_compose_to_predict_structure_on_the_cpu(tiny_params):
    """The captured executable's stages with the random init (graph one
    draws the init from the streams' generator, no eigh, graph two) run
    here outside any graph: `predict_structure` with a generator seeded
    alike, bit for bit."""
    rng = np.random.default_rng(0)
    tokens, mask, _ = pad_batch([rng.integers(0, 20, n) for n in (8, 5)], 8, 2)
    exe = object.__new__(CapturedExecutable)  # the stages without a capture
    exe.params, exe.cfg, exe.device, exe.mds_iters = tiny_params, TINY, torch.device("cpu"), 5
    exe.random, exe.mds_init, exe.streams = True, "random", Streams("cpu")
    seed = fold_in(0, 3)
    with torch.inference_mode():
        exe.tokens, exe.mask = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
        exe.msa = exe.msa_mask = None
        _init_generator(exe.streams, exe.mds_init, seed)
        exe.geo, exe.start = exe._front()
        exe._eigh()  # nothing for the random init
        got = exe._back()
    ref = predict_structure(tiny_params, TINY, tokens, mask=mask, mds_iters=5, mds_init="random",
                            generator=torch.Generator().manual_seed(seed), device="cpu")
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k


def test_random_init_call_needs_its_seed(tiny_params):
    with pytest.raises(ValueError, match="seed"):
        _init_generator(Streams("cpu"), "random", None)
    assert _init_generator(None, "classical", None) is None


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step and the engine are captured as CUDA graphs "
                    "there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


CARD = dict(dim=64, depth=2, heads=4, dim_head=32, max_seq_len=64)
CARD_CASES = {
    "sequential": dict(),
    "remat-dots": dict(remat=True, remat_policy="dots"),
    "branch_parallel": dict(trunk_schedule="branch_parallel"),
    "reversible": dict(reversible=True, depth=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fields", list(CARD_CASES.values()), ids=list(CARD_CASES))
def test_captured_dropout_step_matches_eager_bit_for_bit(cuda_device, fields):
    from alphafold2_tpu_torch.training.executable import CapturedTrainStep

    cfg = Alphafold2Config(**{**CARD, **fields}, **RATES)
    tt = harness.TrainConfig(grad_accum=2, max_grad_norm=0.5)
    fetch = data.synthetic_microbatch_fn(data.DataConfig(max_len=32, msa_rows=4, seed=3), 2)
    states = [harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cuda")
              for _ in range(2)]
    eager = harness.make_train_step(cfg, tt, device="cuda")
    captured = CapturedTrainStep(cfg, tt, states[1], fetch(0))
    for n in range(3):
        _, e = eager(states[0], fetch(n), torch.Generator().manual_seed(10 + n))
        _, c = captured(states[1], fetch(n), torch.Generator().manual_seed(10 + n))
        assert torch.equal(e["loss"], c["loss"]) and torch.equal(e["grad_norm"], c["grad_norm"])
    for a, b in zip(states[0]["optimizer"].leaves, states[1]["optimizer"].leaves):
        assert torch.equal(a, b)
    assert len(captured.captures) == 1
    # the masks are drawn at each replay: one batch under two rngs
    losses = [float(captured(states[1], fetch(0), torch.Generator().manual_seed(s))[1]["loss"])
              for s in (1, 2)]
    assert losses[0] != losses[1]


@pytest.mark.cuda
def test_engine_random_init_captured_matches_eager_bit_for_bit(cuda_device):
    cfg = Alphafold2Config(dim=64, depth=1, heads=4, dim_head=32, max_seq_len=32)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    eng = ServingEngine(params, cfg, ServingConfig(buckets=(16, 32), max_batch=2, mds_iters=8,
                                                   mds_init="random", cache_capacity=0,
                                                   seed=5))
    try:
        tokens, mask, _ = pad_batch([aa_to_tokens("MKTAYIAKQRQ"), aa_to_tokens("MKTAY")], 16, 2)
        got = [eng._call_executable(16, tokens, mask) for _ in range(2)]
    finally:
        eng.shutdown()
    for index, out in enumerate(got, start=1):
        want = predict_structure(params, cfg, tokens, mask=mask, mds_iters=8, mds_init="random",
                                 generator=torch.Generator("cuda").manual_seed(
                                     fold_in(5, index)))
        for k in out:
            assert torch.equal(out[k], want[k]), (index, k)
    assert not torch.equal(got[0]["coords"], got[1]["coords"])


@pytest.mark.cuda
def test_a_cpu_draw_inside_a_capture_is_refused(cuda_device):
    d = torch.rand(1, 6, 6, device=cuda_device)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream), pytest.raises(ValueError, match="CPU generator"):
        with torch.cuda.graph(graph, stream=stream):
            initial_coords(d, "random", torch.Generator().manual_seed(0))
