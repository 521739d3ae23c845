"""The reversible trunk under trunk_schedule="branch_parallel"
(alphafold2_tpu_torch/models/reversible.py: on CUDA each layer's self-block
MSA half runs on the side stream, in the forward and in the backward's
inversion), on the CPU at tests/test_torch_reversible.py's widths (dim 32,
depth 3, 2 heads of 8; B, N, R, C = 2, 6, 3, 6).

- Against JAX's `reversible_trunk_apply` under "branch_parallel" on
  converted params, dense, aligned + tied + compressed, and with a sparse
  layer 0: outputs 1e-5, gradients 1e-4 of each leaf's largest
  (tests/test_torch_reversible.py's tolerances).
- Against the port's serial reversible trunk, bit for bit: outputs, the
  Function's gradients and `reconstruct_input`, on the CPU's own path (the
  serial op order) and on the branch path driven with stand-in streams
  (`StreamLedger`: each op runs "on" the stand-in stream current at it;
  every tensor one stream made and the other reads must have been marked
  for the reader by `_fork` / `_join`, after it was made, and the reader's
  op must come after that fork or join). With live dropout from one seed
  too, and reverse=True against reverse=False at `rebuild_bound`.
- The schedule's data (`COUPLINGS`, `SCHEDULE`): a side block reads only
  what its own branch made or what was there before the fork, neither
  branch reads or writes what the other writes before the join, in the
  forward and in the inversion, and the fork and join lists cover every
  tensor that crosses.
- One e2e step of the smoke preset at depth 3, monolithic and through
  `make_segmented_train_step(trunk_segments=3)`, bit for bit the serial
  preset's.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_reversible import KW, _jax_vs_port, _port_loss, _streams, rebuild_bound

from alphafold2_tpu_torch import Alphafold2Config
from alphafold2_tpu_torch.models import reversible
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_init
from alphafold2_tpu_torch.models.reversible import (
    COUPLING,
    LAYER_IN,
    LAYER_OUT,
    SCHEDULE,
    branch_io,
    param_leaves,
)
from alphafold2_tpu_torch.training import data as tdata
from alphafold2_tpu_torch.training import e2e as te2e
from alphafold2_tpu_torch.training import harness, presets
from alphafold2_tpu_torch.training.segmented import make_segmented_train_step

BP = dict(KW, trunk_schedule="branch_parallel")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small tensors (the suite runs
    several workers on a few cores), restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
CASES = {
    "dense": (BP, True),
    "aligned_tied_compressed": (dict(BP, msa_tie_row_attn=True, cross_attn_mode="aligned",
                                     cross_attn_compress_ratio=2), False),
    "sparse_layer0": (dict(BP, sparse_self_attn=(True, False, False), sparse_block_size=2,
                    sparse_num_random_blocks=1, sparse_num_local_blocks=2), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trunk_matches_jax_under_branch_parallel(case):
    kw, masks = CASES[case]
    _jax_vs_port(kw, masks=masks)


# --- the branch path on stand-in streams -------------------------------------


def _ptr(t):
    return t.untyped_storage().data_ptr()


class StreamLedger(TorchDispatchMode):
    """Runs every op "on" the stand-in stream `current` and checks each
    tensor it reads: one the other stream made must have been marked for
    this stream (`mark`) after it was made, and the op must come after the
    wait that mark belongs to (a fork for the side stream, a join for the
    main one). Tensors made outside the ledger (params, inputs, masks) are
    not checked. `ops` counts each stream's ops."""

    def __init__(self):
        super().__init__()
        self.current, self.clock = "main", 0
        self.made = {}    # storage -> (stream, clock)
        self.marks = {}   # (storage, stream) -> clock of the mark
        self.faults, self.ops = [], {"main": 0, "side": 0}

    def mark(self, stream, tensors):
        self.clock += 1
        for t in tensors:
            self.marks[(_ptr(t), stream)] = self.clock

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor) and t.numel()]
        for t in ins:
            stream, at = self.made.get(_ptr(t), (self.current, 0))
            mark = self.marks.get((_ptr(t), self.current))
            if stream != self.current and (mark is None or mark < at):
                self.faults.append((str(func), self.current, "read before it was marked"))
        out = func(*args, **kwargs)
        self.clock += 1
        self.ops[self.current] += 1
        in_ptrs = {_ptr(t) for t in ins}
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel() and _ptr(t) not in in_ptrs:
                self.made[_ptr(t)] = (self.current, self.clock)
        return out


@pytest.fixture
def ledger(monkeypatch):
    """The branch path of models/reversible.py on the CPU: stand-in
    streams, `torch.cuda.stream` switching the ledger's current stream,
    `_fork` / `_join` marking the tensors they are given."""
    book = StreamLedger()
    main, side = object(), object()
    names = {id(main): "main", id(side): "side"}

    @contextlib.contextmanager
    def stream(s):
        before, book.current = book.current, names[id(s)]
        try:
            yield
        finally:
            book.current = before

    monkeypatch.setattr(reversible, "layer_streams", lambda cfg, t: (
        (main, side) if cfg.trunk_schedule == "branch_parallel" else None))
    monkeypatch.setattr(torch.cuda, "stream", stream)
    monkeypatch.setattr(reversible, "_fork", lambda m, s, *ts: book.mark("side", ts))
    monkeypatch.setattr(reversible, "_join", lambda m, s, *ts: book.mark("main", ts))
    return book


def _layers(cfg, seed=0):
    layers = alphafold2_init(cfg, torch.Generator().manual_seed(seed), "cpu")["trunk"]
    for t in param_leaves(layers):
        t.requires_grad_(True)
    return layers


def _run(layers, cfg, x, m, x_mask, msa_mask, *, rng_seed=None, reverse=True, book=None):
    """(outputs and every gradient, the input rebuilt from the trunk's
    output); `book`: the ledger's op counts in the forward and the
    backward."""
    rng = None if rng_seed is None else torch.Generator().manual_seed(rng_seed)
    tx, tm = x.clone().requires_grad_(True), m.clone().requires_grad_(True)
    with book if book is not None else contextlib.nullcontext():
        loss, (xo, mo) = _port_loss(layers, cfg, tx, tm, x_mask, msa_mask, rng=rng,
                                    reverse=reverse)
        forward_ops = dict(book.ops) if book is not None else None
        grads = torch.autograd.grad(loss, [tx, tm] + param_leaves(layers))
        with torch.no_grad():
            out = reversible.forward_state(layers, cfg, (x, x, m, m), x_mask=x_mask,
                                           msa_mask=msa_mask)
            back = reversible.reconstruct_input(layers, cfg, out, x_mask=x_mask,
                                                msa_mask=msa_mask)
    if book is not None:
        book.forward_ops = forward_ops
    return [loss.detach(), xo.detach(), mo.detach(), *grads], list(back)


def _same_bits(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", list(CASES))
def test_matches_serial_bit_for_bit(case, ledger):
    kw, masks = CASES[case]
    cfg = Alphafold2Config(**kw)
    serial = dataclasses.replace(cfg, trunk_schedule="serial")
    layers = _layers(cfg)
    x, m, x_mask, msa_mask = (torch.from_numpy(a) for a in _streams(seed=2))
    if not masks:
        x_mask = msa_mask = None
    want, want_back = _run(layers, serial, x, m, x_mask, msa_mask)
    got, got_back = _run(layers, cfg, x, m, x_mask, msa_mask, book=ledger)
    assert _same_bits(got, want) and _same_bits(got_back, want_back)
    assert ledger.faults == []
    assert ledger.forward_ops["side"] > 0
    assert ledger.ops["side"] > ledger.forward_ops["side"]  # the inversion's MSA half


def test_side_stream_keeps_off_the_default_priority_pool(monkeypatch):
    # torch.cuda.Stream() cycles through a fixed pool a priority: a stream
    # made later at the default priority could be the side stream itself
    from alphafold2_tpu_torch.models import trunk
    made = []

    class FakeStream:
        def __init__(self, device=None, priority=0):
            made.append((device, priority))

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(trunk, "_SIDE_STREAMS", {})
    first = trunk.side_stream(torch.device("cuda", 0))
    assert trunk.side_stream("cuda:0") is first
    assert made == [(0, trunk.SIDE_PRIORITY)] and trunk.SIDE_PRIORITY < 0


def test_cpu_path_runs_serial_order():
    cfg = Alphafold2Config(**BP)
    assert reversible.layer_streams(cfg, torch.zeros(1)) is None
    assert reversible.layer_streams(dataclasses.replace(cfg, trunk_schedule="serial"),
                                    torch.zeros(1)) is None
    layers = _layers(cfg)
    x, m, x_mask, msa_mask = (torch.from_numpy(a) for a in _streams(seed=2))
    got = _run(layers, cfg, x, m, x_mask, msa_mask)
    want = _run(layers, dataclasses.replace(cfg, trunk_schedule="serial"), x, m, x_mask,
                msa_mask)
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])


def test_dropout_bit_for_bit_serial_and_reverse_against_plain(ledger):
    cfg = Alphafold2Config(**dict(BP, attn_dropout=0.2, ff_dropout=0.2))
    serial = dataclasses.replace(cfg, trunk_schedule="serial")
    layers = _layers(cfg, seed=4)
    x, m, x_mask, msa_mask = (torch.from_numpy(a) for a in _streams(seed=3))
    want, want_back = _run(layers, serial, x, m, x_mask, msa_mask, rng_seed=11)
    got, got_back = _run(layers, cfg, x, m, x_mask, msa_mask, rng_seed=11, book=ledger)
    assert _same_bits(got, want) and _same_bits(got_back, want_back)
    assert ledger.faults == []
    # dropout is live: another seed gives another loss
    other, _ = _run(layers, serial, x, m, x_mask, msa_mask, rng_seed=12)
    assert abs(float(other[0]) - float(want[0])) > 1e-3
    plain, _ = _run(layers, cfg, x, m, x_mask, msa_mask, rng_seed=11, reverse=False)
    assert abs(float(got[0]) - float(plain[0])) <= 1e-5 * abs(float(plain[0]))
    for a, b in zip(got[3:], plain[3:]):
        assert (a - b).abs().max().item() <= rebuild_bound(cfg, b), (a - b).abs().max()


# --- the schedule's data ----------------------------------------------------


def _forward_io(blocks):
    reads, writes = set(), set()
    for name in blocks:
        target, residual, block_reads = COUPLING[name]
        reads |= {residual, *block_reads}
        writes.add(target)
    return reads, writes


def _inversion_io(blocks):
    """(crossing, reads, writes) of inverting `blocks`, values and their
    cotangents ("d" + name); crossing: what it reads before it writes it
    (a read's cotangent is accumulated into, so read too)."""
    crossing, reads, writes = set(), set(), set()
    for name in reversed(blocks):
        target, residual, block_reads = COUPLING[name]
        r = {target, "d" + target, *block_reads, *("d" + k for k in block_reads)}
        crossing |= r - writes
        reads |= r
        writes |= {residual, "d" + residual, *("d" + k for k in block_reads)}
    return crossing, reads, writes


def test_schedule_is_data_both_passes_read():
    order = [name for main, side in SCHEDULE for name in main + side]
    assert sorted(order) == sorted(COUPLING) and len(order) == len(set(order))
    made = set(LAYER_IN)
    for main, side in SCHEDULE:
        # the forward: each block reads what exists before it
        for name in main + side:
            target, residual, reads = COUPLING[name]
            assert {residual, *reads} <= made, name
            made.add(target)
        if not side:
            continue
        m_reads, m_writes = _forward_io(main)
        s_reads, s_writes = _forward_io(side)
        assert not (s_reads & m_writes) and not (m_reads & s_writes)
        assert not (s_writes & m_writes)
        ins, outs = branch_io(side)
        # the forward's fork carries every tensor the side half reads that
        # it did not make; its join every tensor the half made
        assert set(ins) == s_reads - s_writes and set(outs) == s_writes
        # the inversion: neither half reads or writes what the other writes
        _, m_reads, m_writes = _inversion_io(main)
        crossing, s_reads, s_writes = _inversion_io(side)
        assert not (s_reads & m_writes) and not (m_reads & s_writes)
        assert not (s_writes & m_writes)
        # its fork carries the half's outputs and their cotangents; its
        # join the half's inputs and theirs, all the layer's input the
        # half rebuilds
        assert crossing <= set(outs) | {"d" + k for k in outs}
        after = set(LAYER_IN) | {"d" + k for k in LAYER_IN}
        assert s_writes & after == set(ins) | {"d" + k for k in ins}
    assert set(LAYER_OUT) <= made


# --- the e2e step --------------------------------------------------------------


def test_smoke_e2e_step_bit_for_bit_serial_monolithic_and_segmented():
    def run(schedule, segments):
        ecfg, crop, rows = presets.north_star_e2e_config(
            3, tier="smoke", model_overrides={"trunk_schedule": schedule})
        tcfg = harness.TrainConfig(grad_accum=1)
        state = te2e.e2e_train_state_init(ecfg, tcfg, torch.Generator().manual_seed(0), "cpu")
        step = (make_segmented_train_step(ecfg, tcfg, segments, device="cpu") if segments
                else harness.make_train_step(ecfg, tcfg, loss_fn=te2e.e2e_loss_fn,
                                             device="cpu"))
        batch = tdata.synthetic_microbatch_fn(
            tdata.DataConfig(batch_size=1, max_len=crop, msa_rows=rows, seed=4), 1,
            source=tdata.synthetic_structure_batches)(0)
        state, metrics = step(state, batch)
        return [metrics["loss"], metrics["grad_norm"], *state["optimizer"].state_tensors()]

    want = run("serial", None)
    assert np.isfinite(float(want[0]))
    assert _same_bits(run("branch_parallel", None), want)
    assert _same_bits(run("branch_parallel", 3), want)
