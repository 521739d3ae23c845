"""The captured train step: `make_train_step`'s step replayed as a CUDA
graph, the port's counterpart of `jax.jit(make_train_step(...))` with the
state donated (alphafold2_tpu/train_pre.py:323, the step
alphafold2_tpu/training/harness.py:149-195).

One graph holds a whole step (`training/harness.py step_body`): zero the
gradient buffers, the forward, loss and backward of every microbatch
accumulating into them, the division by the count, the global norm, the
clip and the AdamW update. It reads the batch from static buffers, which
a call fills with one copy from the host per leaf, and the lr from the
optimizer's device tensor, which a call fills before the replay. The
params, their gradient buffers and AdamW's moments and step count lie
outside the graph's memory: the graph updates them in place, as the eager
step does. The eager step (`make_train_step`) runs the same ops on the
same buffers, so a replay gives its bits.

Capture, once a batch shape (jit's one compile a shape):
  1. the batch is copied into new static buffers;
  2. a warm-up step on a side stream builds and loads the kernels, the
     sparse block tables and the distogram boundaries on the card, sets
     up cuBLAS and makes AdamW's state, none of which a capture may do;
     then the params and AdamW's state are put back as they were;
  3. the step is captured on that stream.
A capture that fails raises `CaptureError` naming the port's source line;
nothing falls back to eager. The kernel wrappers count launches in
Python, so a replay adds nothing to their `LAUNCHES`: each capture keeps
the launches it recorded and its replays (`replayed_launches`).

End-to-end structure training (`training/e2e.py`) is refused: its step
reads the host (see `CapturedTrainStep`), so it runs eagerly (ROADMAP
A8-e2e-capture).

A reversible config (models/reversible.py) captures as the sequential
one does: its Function's backward, with the nested `torch.autograd.grad`
of each recomputed block, runs inside the one graph and reads nothing
from the host.

Dropout: the step owns a `utils/rng.py Streams` on the card, whose
generators sit at the step's positions (microbatch, "trunk", layer), a
reversible layer's blocks one level deeper, and the template tower's
layers at (microbatch, "tower", layer); a remat or reversible recompute
takes its position's second pass. A step with live dropout (a rate above
0 and an rng) is captured with every generator registered with its graph
(`Streams.capturing`); a call turns its rng into the streams' seed with
one draw on the host (`seed_from`, what the eager step draws) and reseeds
them, and the replay draws fresh masks from the seed: the eager step's
bits for the same rng. A step called without an rng is captured apart,
without dropout (eval mode). A generator the warm-up did not make, or a
PyTorch whose graphs cannot register one, raises: no replay freezes its
masks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch

from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.ops.quant import reject_quant_training
from alphafold2_tpu_torch.training.e2e import E2EConfig
from alphafold2_tpu_torch.training.harness import (
    TrainConfig,
    check_microbatches,
    distogram_loss_fn,
    step_body,
)
from alphafold2_tpu_torch.models.trunk import dropout_live
from alphafold2_tpu_torch.utils.graphs import capture_error, launch_counts, launches_between
from alphafold2_tpu_torch.utils.rng import Streams, seed_from


def _signature(batch) -> tuple:
    """What a capture is specific to: each leaf's name, shape and dtype."""
    return tuple(sorted((k, tuple(t.shape), t.dtype)
                        for k, t in ((k, torch.as_tensor(v)) for k, v in batch.items())))


@dataclasses.dataclass
class _Capture:
    graph: Any
    batch: dict  # the static input buffers
    loss: torch.Tensor
    grad_norm: torch.Tensor
    seconds: float
    launches: dict
    replays: int = 0


class CapturedTrainStep:
    """`train_step(state, batch, rng=None) -> (state, metrics)` on the card,
    as `make_train_step` gives it, for `state` (built on CUDA with
    `train_state` / `train_state_init`). The step for `example_batch`'s
    shape is captured at construction, with dropout when the config has a
    dropout rate (the step then wants an rng: a CPU generator, one draw a
    call); a batch of another shape, or a call with dropout set apart
    (rng None), is captured at its first call. metrics are 0-d device
    tensors cloned out of the graph's memory. The CPU raises ValueError:
    there the eager `make_train_step` is the step."""

    def __init__(self, cfg: Alphafold2Config, tcfg: TrainConfig, state, example_batch,
                 loss_fn: Callable[..., Any] = distogram_loss_fn):
        if isinstance(cfg, E2EConfig):
            raise ValueError(
                "CapturedTrainStep: an E2EConfig's step reads the host inside it (the "
                "classical MDS init's torch.linalg.eigh, kabsch's torch.linalg.svd, the "
                "random init's CPU draw), which a CUDA graph cannot hold; a captured e2e "
                "step is not ported yet (ROADMAP A8-e2e-capture). make_train_step runs it "
                "eagerly on the card")
        device = state["optimizer"].leaves[0].device
        if device.type != "cuda":
            raise ValueError(
                f"CapturedTrainStep: the state lies on {device}; CUDA graphs capture on the "
                f"card only (the CPU runs make_train_step's eager step)")
        reject_quant_training(cfg, "CapturedTrainStep")
        self.cfg, self.tcfg, self.state, self.loss_fn = cfg, tcfg, state, loss_fn
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()  # one pool for every shape's graph
        self.streams = Streams(device)  # dropout's generators, registered with each graph
        self.captures = {}
        self._capture(example_batch, cfg.attn_dropout > 0.0 or cfg.ff_dropout > 0.0)

    def _load(self, static, batch) -> None:
        for k, v in batch.items():
            static[k].copy_(torch.as_tensor(v))

    def _capture(self, batch, live: bool) -> _Capture:
        """Capture the step for `batch`'s shape, with dropout drawn from
        the streams when `live`."""
        check_microbatches(batch, self.tcfg)
        key = self.streams.key() if live else None
        t0 = time.perf_counter()
        opt = self.state["optimizer"]
        static = {k: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                  for k, t in ((k, torch.as_tensor(v)) for k, v in batch.items())}
        self._load(static, batch)
        with torch.no_grad():
            params = [p.detach().clone() for p in opt.leaves]
            moments = {p: {k: v.clone() for k, v in opt.adamw.state[p].items()}
                       for p in opt.leaves if p in opt.adamw.state}
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            opt.set_lr(self.state["step"])
            self.streams.set_seed(self.streams.seed)  # the passes counted from 0
            step_body(self.state, self.cfg, static, self.loss_fn, key, self.device)
            with torch.no_grad():  # the warm-up's update undone
                for p, saved in zip(opt.leaves, params):
                    p.copy_(saved)
                for p in opt.leaves:
                    for k, v in opt.adamw.state[p].items():
                        if p in moments:
                            v.copy_(moments[p][k])
                        else:
                            v.zero_()  # AdamW's fresh state: zero moments, step 0
            torch.cuda.synchronize(self.device)
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with (self.streams.capturing(graph) if live else contextlib.nullcontext()), \
                        torch.cuda.graph(graph, pool=self.pool, stream=stream):
                    loss, grad_norm = step_body(self.state, self.cfg, static, self.loss_fn,
                                                key, self.device)
            except RuntimeError as e:
                shapes = {k: tuple(v.shape) for k, v in static.items()}
                raise capture_error(f"the train step (batch {shapes})", e) from e
            after = launch_counts()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        capture = _Capture(graph, static, loss, grad_norm, time.perf_counter() - t0,
                           launches_between(before, after))
        self.captures[(_signature(batch), live)] = capture
        return capture

    def captured(self, batch, rng=None) -> bool:
        """Whether a call on this batch (and rng) replays a capture it has,
        rather than capturing first (a new batch shape, or the first call
        with live dropout): a trainer's goodput counts the latter as
        compile."""
        return (_signature(batch), dropout_live(self.cfg, rng)) in self.captures

    def __call__(self, state, batch, rng=None):
        if state is not self.state:
            raise ValueError("CapturedTrainStep: called with another state than it captured")
        check_microbatches(batch, self.tcfg)
        live = dropout_live(self.cfg, rng)
        capture = self.captures.get((_signature(batch), live)) or self._capture(batch, live)
        self._load(capture.batch, batch)
        state["optimizer"].set_lr(state["step"])
        if live:
            self.streams.set_seed(seed_from(rng))  # read by the replay's prologue
        capture.graph.replay()
        capture.replays += 1
        state["step"] += 1
        return state, {"loss": capture.loss.clone(), "grad_norm": capture.grad_norm.clone()}

    def replayed_launches(self) -> dict:
        """The kernel launches the replays made: each capture's recorded
        launches times its replays."""
        out = {}
        for c in self.captures.values():
            for name, n in c.launches.items():
                out[name] = out.get(name, 0) + n * c.replays
        return out
