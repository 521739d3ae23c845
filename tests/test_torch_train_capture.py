"""The captured train step (`training/executable.py CapturedTrainStep`)
and what it rests on in the eager step.

On the CPU: the captured step refuses the CPU, naming the device; the
eager step keeps each leaf's gradient buffer and AdamW's state in place
across steps (what a graph's addresses need) and makes nothing on the
device a step that a capture would refuse (the distogram boundaries are
made once a device).

On the card (marked `cuda`, skipped without one): the captured step
against the eager step from the same params and batches, bit for bit on
loss, grad_norm and every param after 3 steps (no tolerance: the same
ops on the same buffers), with remat and a remat_policy too; a second
batch shape gets a capture of its own (live dropout:
tests/test_torch_dropout_capture.py); train_pre on the card runs the
captured step; a guarded captured run (a NaN rollback, a crash restored
from a checkpoint into the graph's tensors) ends bit-equal to a
fault-free one without a second capture. These import only torch and the port, so they run on a
GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_train_capture.py -q
"""

import numpy as np
import pytest
import torch

from alphafold2_tpu_torch import Alphafold2Config
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.training import data, harness, losses
from alphafold2_tpu_torch.training.executable import CapturedTrainStep

SMALL = dict(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=64)


def test_captured_step_refuses_the_cpu():
    cfg = Alphafold2Config(**SMALL)
    tt = harness.TrainConfig(grad_accum=2)
    state = harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cpu")
    batch = data.synthetic_microbatch_fn(data.DataConfig(max_len=8), 2)(0)
    with pytest.raises(ValueError, match="lies on cpu"):
        CapturedTrainStep(cfg, tt, state, batch)


def test_eager_step_keeps_its_buffers_in_place():
    """Each leaf's gradient buffer is made with the state and every step
    zeroes and refills that same tensor; AdamW's moments keep their tensors
    after the first step; a leaf the sequence-only forward does not read
    (the MSA stream's) keeps an exactly zero gradient."""
    cfg = Alphafold2Config(**SMALL)
    tt = harness.TrainConfig(grad_accum=2)
    state = harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cpu")
    opt = state["optimizer"]
    grads = [p.grad for p in opt.leaves]
    assert all(g is not None and not g.any() for g in grads)
    step = harness.make_train_step(cfg, tt, device="cpu")
    fetch = data.synthetic_microbatch_fn(data.DataConfig(max_len=12, seed=2), 2)
    step(state, fetch(0))
    moments = {id(p): [v for v in opt.adamw.state[p].values()] for p in opt.leaves}
    step(state, fetch(1))
    assert all(p.grad is g for p, g in zip(opt.leaves, grads))
    assert all(all(a is b for a, b in zip(opt.adamw.state[p].values(), moments[id(p)]))
               for p in opt.leaves)
    unread = state["params"]["trunk"][0]["msa_ff"]["ff"]
    assert all(not leaf.grad.any() for leaf in tree_leaves(unread))
    assert any(g.any() for g in grads)


def test_lr_is_set_before_each_update():
    """On the CPU the schedule's lr is a float in AdamW's group (the JAX
    parity tests' arithmetic); `set_lr` follows the schedule's count."""
    leaves = [torch.zeros(3, requires_grad=True)]
    opt = harness.make_optimizer(
        harness.TrainConfig(learning_rate=1e-3, warmup_steps=4), leaves)
    for count, want in ((0, 0.0), (2, 5e-4), (9, 1e-3)):
        opt.set_lr(count)
        assert opt.adamw.param_groups[0]["lr"] == pytest.approx(want)
    assert not opt.adamw.defaults["capturable"]


def test_boundaries_are_made_once_a_device():
    """A capture refuses a copy from the host: the loss's bin boundaries
    are made once a device and handed out again."""
    a = losses.distogram_boundaries("cpu")
    assert a is losses.distogram_boundaries(torch.device("cpu"))
    assert a is losses.distogram_boundaries()


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step is captured as a CUDA graph there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


CARD = dict(dim=64, depth=2, heads=4, dim_head=64, max_seq_len=64, dtype=torch.bfloat16)


def _eager_and_captured(cfg, tt, batches):
    """Both arms from the same seeded params over `batches`: per step
    (loss, grad_norm) of each and the two states."""
    states = [harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cuda")
              for _ in range(2)]
    eager = harness.make_train_step(cfg, tt, device="cuda")
    captured = CapturedTrainStep(cfg, tt, states[1], batches[0])
    metrics = []
    for batch in batches:
        _, e = eager(states[0], batch)
        _, c = captured(states[1], batch)
        metrics.append((e, c))
    return metrics, states, captured


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [dict(), dict(remat=True, remat_policy="dots")],
                         ids=["plain", "remat-dots"])
def test_captured_step_matches_eager_bit_for_bit(cuda_device, fields):
    cfg = Alphafold2Config(**CARD, **fields)
    tt = harness.TrainConfig(grad_accum=2, warmup_steps=1, decay_steps=4, max_grad_norm=0.5)
    fetch = data.synthetic_microbatch_fn(data.DataConfig(max_len=64, seed=3), 2)
    metrics, states, captured = _eager_and_captured(cfg, tt, [fetch(n) for n in range(3)])
    for e, c in metrics:
        assert torch.equal(e["loss"], c["loss"]) and torch.equal(e["grad_norm"], c["grad_norm"])
    for a, b in zip(states[0]["optimizer"].leaves, states[1]["optimizer"].leaves):
        assert torch.equal(a, b)
    assert states[1]["step"] == 3
    # 2 pair axial attentions a layer, 2 microbatches, on the wgmma routes
    per = 2 * cfg.depth * 2
    want = {"flash_fwd_wgmma": per * (2 if cfg.remat else 1), "flash_bwd_dq_wgmma": per,
            "flash_bwd_dkv_wgmma": per}
    launches = next(iter(captured.captures.values())).launches
    assert {k: launches.get(k) for k in want} == want
    assert captured.replayed_launches()["flash_bwd_dq_wgmma"] == 3 * per


@pytest.mark.cuda
def test_each_batch_shape_gets_its_capture(cuda_device):
    cfg = Alphafold2Config(**CARD)
    tt = harness.TrainConfig(grad_accum=2)
    batches = [data.synthetic_microbatch_fn(data.DataConfig(max_len=L, seed=4), 2)(0)
               for L in (64, 32, 64)]
    metrics, states, captured = _eager_and_captured(cfg, tt, batches)
    assert len(captured.captures) == 2
    assert sorted(c.replays for c in captured.captures.values()) == [1, 2]
    for e, c in metrics:
        assert torch.equal(e["loss"], c["loss"])


@pytest.mark.cuda
def test_train_pre_cli_captures_on_the_card(cuda_device, capsys):
    from alphafold2_tpu_torch import train_pre

    state, metrics = train_pre.main(["--steps", "3", "--dim", "64", "--depth", "1",
                                     "--heads", "4", "--dim-head", "64", "--len", "32",
                                     "--accum", "2", "--bf16"])
    out = capsys.readouterr().out
    assert "captured the step as a CUDA graph" in out and "done" in out
    assert state["step"] == 3 and np.isfinite(float(metrics["loss"]))


@pytest.mark.cuda
def test_recovery_keeps_the_captured_graph(cuda_device, tmp_path):
    """run_resilient over the captured step with a NaN step (rolled back
    from the guard's snapshot) and a crash (restored from the step-2
    checkpoint into the live tensors) ends bit-equal to the fault-free
    captured run, with one capture and the same addresses."""
    from alphafold2_tpu_torch.reliability.faults import Fault, FaultPlan
    from alphafold2_tpu_torch.training.checkpoint import VerifiedCheckpointManager
    from alphafold2_tpu_torch.training.resilience import run_resilient

    cfg, tt = Alphafold2Config(**CARD), harness.TrainConfig(grad_accum=2)
    fetch = data.synthetic_microbatch_fn(data.DataConfig(max_len=64, seed=5), 2)
    runs = []
    for faults in ((), (Fault("nan_grads", at=1), Fault("step_exception", at=3))):
        state = harness.train_state_init(cfg, tt, torch.Generator().manual_seed(0), "cuda")
        captured = CapturedTrainStep(cfg, tt, state, fetch(0))
        ptrs = [t.data_ptr() for t in state["optimizer"].state_tensors()]
        inj = FaultPlan(faults=faults).injector()
        mgr = VerifiedCheckpointManager(str(tmp_path / f"ck{len(runs)}"), save_interval_steps=2)
        run_resilient(harness.with_fault_injection(captured, inj), state, fetch, steps=4,
                      mgr=mgr, max_restarts=1)
        assert inj.exhausted() and state["step"] == 4 and len(captured.captures) == 1
        assert [t.data_ptr() for t in state["optimizer"].state_tensors()] == ptrs
        runs.append(state["optimizer"].state_tensors())
    assert all(torch.equal(a, b) for a, b in zip(*runs))
