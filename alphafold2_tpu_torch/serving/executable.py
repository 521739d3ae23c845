"""The serving engine's executables: one per (length bucket, batch-shape
rung), the port's counterpart of the JAX engine's AOT executables
(alphafold2_tpu/serving/engine.py `_executable_for` :1213,
`_call_executable` :1294, `_realize` :1318).

On the card a request of a (bucket, rung) is captured once and replayed
(`CapturedExecutable`). It is two `torch.cuda.CUDAGraph`s around one eager
call, on static buffers:

  1. graph one: the trunk forward (`alphafold2_apply`), the distogram
     softmax and centring and the confidence (`serving/pipeline.py
     distogram_geometry`), and the classical init's Gram matrix
     (`geometry/mds.py classical_gram`);
  2. eager: `torch.linalg.eigh` of the Gram matrix, copied into static
     buffers. It checks the solver's status on the host (a device-to-host
     read), which cannot be captured;
  3. graph two: `classical_embed` and the Guttman steps (`guttman`).

With `mds_init="random"` graph one draws the init in place of the Gram
matrix (`geometry/mds.py initial_coords`), from the engine's generator on
the card (a `utils/rng.py Streams`, registered with every graph one), no
`eigh` runs and graph two starts the Guttman steps from the draw. A call
takes the init's seed (the engine's (seed, dispatch index)) and reseeds
the generator under the pool's lock, just before the replays: the draw is
the one the eager `predict_structure` makes from a generator on the card
seeded alike.

Those are the functions `predict_structure` runs, on the same values, so
a replay gives the eager request's outputs bit for bit. A call copies the
inputs into the static buffers, replays, and clones the outputs out of the
graphs' memory before it returns.

Every graph on a card shares one memory pool and one lock (`GraphPool`,
the card's state): a graph's intermediates may lie where another graph's
do, whichever engine of the process captured it. That is safe only
because a call holds the card's lock from its first copy in to its
outputs' clones, so graphs replay one at a time and nothing reads a
graph's outputs after another graph has run; a capture holds the same
lock. One pool a card, not one an engine, because a pool keeps the
memory its captures freed for its later captures: N replicas of one
config reuse one set of blocks where N pools would hold N. Captures run
on one side stream a card, too: the allocator hands a capture only the
pool's blocks of the capture's stream. When the card's last graph is
collected, the next capture starts a fresh pool (the allocator keeps a
pool until its graphs are gone; a pool must not be reused after that).

The lock (`device_lock`) is one re-entrant lock a CUDA device. A graph
captures in CUDA's global capture mode, where no other thread of the
process may make an unsafe CUDA call (a synchronizing copy, the eager
`eigh`'s status read, a `cudaMalloc`): the engine holds the card's lock
across a call's replays, its `eigh` and the copy of its outputs to the
host, and across the device work of its construction, so a capture on
one engine never meets another engine's work on the same card. A drained
engine's graphs are released under the lock (`ServingEngine.
release_graphs`); their blocks return to the card's pool for the next
capture.

With trunk-depth early exit armed (`early_exit_depths`, `early_exit_kl`)
graph one's forward is split into one graph a stage of the staged trunk
(serving/pipeline.py): stage 0 is the front, the first segment, the head
and its log_softmax; stage k is segment k, the head, the per-sample KL
test and the `where` updates of the state (x, m, out_logits, prev_logp,
frozen, exit_depth), whose tensors stage 0's capture made and every later
stage updates in place, so each graph reads where the last one wrote. A
CUDA graph cannot branch on device data without conditional nodes, and
PyTorch reaches those only through `torch.cond` (a prototype), whose
branches must be traceable by torch.compile: the trunk's kernels are
ctypes launches it cannot trace. So after each stage the host reads
whether every sample has frozen (one byte, one sync, under the pool's
lock, as the eager `eigh` already reads the host once a request) and
skips the remaining stage graphs: the JAX pipeline's
`lax.cond(all(frozen))`. Then graph one runs the distogram geometry on
out_logits, and the rest is as above. A replay gives the eager staged
`predict_structure`'s outputs bit for bit, whichever stages ran.

With a forward override (`model_apply_fn`, the SP arm's per-bucket
forward, serving/sp_arm.py `make_sp_apply_fn`) graph one captures that
forward in place of `alphafold2_apply`: for an SP bucket the sharded trunk
over a mesh whose shards all lie on this card (each shard's B1f passes,
the mesh's copies, and under "sp_seq" the ring's P^2 B3 hops a layer with
their `merge_lse`s). Its allocations enter the card's pool like any
other's; a failed capture raises `CaptureError` naming that forward.

With pipelined dispatch (the engine's `pipeline_depth`) a call is split
in two. `enqueue` holds the card's lock for the call's device work only:
it stages the inputs through pinned host buffers (a copy from pageable
memory would block the host until everything the stream queued before
it had run), copies them in without blocking, replays, issues the copies
of the outputs into pinned host buffers (stream-ordered before any later
replay, so no clone is needed) and records an event after them, and
returns a `PendingCall` at once. `PendingCall.wait` polls that event
under the card's capture lock (`GraphPool.capture_lock`: every capture
holds it, inside the card's lock), releasing it between polls, and then
reads the pinned buffers, a plain host copy. A capture on another thread
meets no CUDA call of either half: the pinned buffers are made and
copied to or from, and every event is made and recorded, under the
card's lock; every event is queried, read and destroyed under its
capture lock. Each (bucket, rung) keeps a free list of such buffer sets,
one a call in flight, `slots` of them made at build and more under the
lock as calls need them. The eager `eigh`'s status read and early exit's
frozen reads still wait, inside `enqueue`, for this call's graph one
(and so for whatever the stream queued before it), first on an event
polled between sleeps (`_wait_for_card`): with the blocking read alone,
the settle thread answered the batch before only about when that read
returned. With the random init and no early exit nothing in `enqueue`
waits for the card.

The kernel wrappers count launches in Python, so a replay adds nothing to
their `LAUNCHES`: each executable records the launches its capture
recorded (`launches`, all its graphs), and `replays` how often it ran; a
staged one also the launches of each stage graph (`stage_launches`) and
how often each stage ran (`stage_replays`), so a skipped stage launches
nothing in `replayed_launches()`. On the CPU an `EagerExecutable` runs
`predict_structure` itself, with the same arguments.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref

import numpy as np
import torch

from alphafold2_tpu_torch.geometry.mds import (
    classical_embed,
    classical_gram,
    guttman,
    initial_coords,
)
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_apply
from alphafold2_tpu_torch.serving.pipeline import (
    distogram_geometry,
    exit_checkpoints,
    predict_structure,
    staged_front,
    staged_step,
)
from alphafold2_tpu_torch.utils.graphs import capture_error, launch_counts, launches_between
from alphafold2_tpu_torch.utils.rng import Streams

OUTPUTS = ("coords", "confidence", "stress")  # what a call returns; "exit_depth" too
#                                               with early exit armed


def _outputs(early_exit_depths) -> tuple:
    return OUTPUTS + (("exit_depth",) if early_exit_depths else ())


class GraphPool:
    """A CUDA device's capture state, shared by every engine and executable
    of the process on it: `lock`, under which graphs capture and replay
    one at a time; `capture_lock`, which a capture also holds (inside
    `lock`) and a pipelined settle's event polls take alone; the graph
    memory pool they capture into (`pool_for`); and `stream`, the side
    stream every capture and warm-up runs on (the allocator hands a
    capture only blocks of its own stream, so one stream a card is what
    lets a capture reuse what another freed). `GraphPool(device)` returns
    the card's one instance."""

    _cards = {}
    _cards_guard = threading.Lock()

    def __new__(cls, device=None):
        device = torch.device("cuda") if device is None else torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"graphs capture on a CUDA device, not {device}")
        index = device.index if device.index is not None else torch.cuda.current_device()
        with cls._cards_guard:
            card = cls._cards.get(index)
            if card is None:
                card = cls._cards[index] = super().__new__(cls)
                card.device = torch.device("cuda", index)
                card._stream = None
                card.lock = threading.RLock()
                card.capture_lock = threading.Lock()
                card._guard = threading.RLock()  # re-entrant: a collection may finalize here
                card._handle, card._graphs = None, 0
            return card

    def __init__(self, device=None):
        pass  # the card's state is made once, in __new__

    @property
    def stream(self):
        """The card's capture stream, made at first use (under `lock`)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def pool_for(self, graph) -> tuple:
        """The pool handle `graph` captures into, counted until the graph
        is collected; past the card's last graph the next one starts a
        fresh pool."""
        with self._guard:
            if self._handle is None:
                self._handle = torch.cuda.graph_pool_handle()
            handle = self._handle
            self._graphs += 1
        weakref.finalize(graph, self._collected, handle)
        return handle

    def _collected(self, handle):
        with self._guard:
            if handle == self._handle:
                self._graphs -= 1
                if self._graphs == 0:
                    self._handle = None


def device_lock(device=None):
    """The card's lock (`GraphPool(device).lock`), shared by every engine
    of the process on that card; None for the CPU."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return GraphPool(device).lock if device.type == "cuda" else None


def _init_generator(streams, mds_init: str, seed):
    """The random init's generator, its streams seeded by `seed` (None for
    the classical init)."""
    if mds_init != "random":
        return None
    if seed is None:
        raise ValueError("mds_init='random': a call needs the init's seed")
    streams.set_seed(seed)
    return streams.key().generator()


class EagerExecutable:
    """The CPU's executable: `predict_structure` on the padded batch, with
    the engine's early-exit knobs and the bucket's forward override
    (`model_apply_fn`, which places its own work); with the random init,
    drawn from `streams`' generator seeded by the call's `seed`."""

    def __init__(self, params, cfg, *, mds_iters: int, mds_init: str, device,
                 streams=None, early_exit_depths=(), early_exit_kl: float = 0.0,
                 model_apply_fn=None):
        self.params, self.cfg, self.device = params, cfg, device
        self.model_apply_fn = model_apply_fn
        self.mds_iters, self.mds_init, self.streams = mds_iters, mds_init, streams
        self.early_exit_depths, self.early_exit_kl = tuple(early_exit_depths), early_exit_kl
        self.outputs = _outputs(early_exit_depths)
        self.seconds = 0.0
        self.launches = {}
        self.replays = 0
        self.stage_replays = ()

    def __call__(self, tokens, mask, msa=None, msa_mask=None, *, seed=None):
        # no `events`: off the card the engine times the host window. A
        # call's own streams, seeded as the engine's would be: a pipelined
        # engine's settle thread may call while its worker does
        streams = None if self.streams is None else Streams(self.streams.device)
        out = predict_structure(self.params, self.cfg, tokens, mask=mask, msa=msa,
                                msa_mask=msa_mask, mds_iters=self.mds_iters,
                                mds_init=self.mds_init,
                                generator=_init_generator(streams, self.mds_init, seed),
                                device=None if self.model_apply_fn else self.device,
                                model_apply_fn=self.model_apply_fn,
                                early_exit_depths=self.early_exit_depths,
                                early_exit_kl=self.early_exit_kl)
        self.replays += 1
        return {k: out[k] for k in self.outputs}

    def release(self):
        """Nothing to free: the eager executable keeps no device buffers."""


class CapturedExecutable:
    """One (bucket, rung) on the card: captured at construction, then
    `__call__(tokens, mask, msa, msa_mask)` (host numpy of the padded
    batch) replays it and returns device tensors coords (b, L, 3),
    confidence (b, L) and stress (b,) (and exit_depth (b,) with early exit
    armed), cloned out of the graphs' memory. `logits` holds the last
    call's distogram logits until the next replay of any graph of the pool.
    `model_apply_fn` replaces `alphafold2_apply` in graph one (`apply_name`
    names it in a capture error).
    With mds_init="random" a call takes the init's `seed` and `streams`
    (the engine's, on the card) holds its generator. Capture raises
    `CaptureError` naming the op it could not capture; nothing falls back
    to eager."""

    checkpoints = ()  # the staged trunk's checkpoint depths (): early exit off
    model_apply_fn = None  # graph one's forward override (None: alphafold2_apply)

    def __init__(self, params, cfg, *, batch: int, bucket: int, msa_rows: int,
                 mds_iters: int, device, pool: GraphPool, mds_init: str = "classical",
                 streams=None, early_exit_depths=(), early_exit_kl: float = 0.0,
                 model_apply_fn=None, apply_name: str = "the forward", slots: int = 0):
        self.params, self.cfg, self.device, self.pool = params, cfg, device, pool
        self.model_apply_fn = model_apply_fn
        self.mds_iters, self.mds_init, self.streams = mds_iters, mds_init, streams
        self.random = mds_init == "random"
        self.checkpoints = (exit_checkpoints(cfg, early_exit_depths, early_exit_kl)
                            if early_exit_depths else ())
        self.exit_kl = float(early_exit_kl)
        self.outputs = _outputs(early_exit_depths)
        self.replays = 0
        self.stage_replays = [0] * len(self.checkpoints)
        self.stage_launches = []
        t0 = time.perf_counter()
        with pool.lock, torch.inference_mode():
            # warm-up inputs: finite (eigh raises on a failed solve)
            self.tokens = torch.zeros((batch, bucket), dtype=torch.long, device=device)
            self.mask = torch.ones((batch, bucket), dtype=torch.bool, device=device)
            self.msa = self.msa_mask = None
            if msa_rows:
                self.msa = torch.zeros((batch, msa_rows, bucket), dtype=torch.long,
                                       device=device)
                self.msa_mask = torch.ones_like(self.msa, dtype=torch.bool)
            self.evals = self.evecs = None  # made by the warm-up's eigh
            self.state, self.all_frozen = None, []
            stream = pool.stream
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                # the warm-up builds and loads the kernels, the sparse block
                # tables and the thresholds on the card, and cuBLAS's state,
                # none of which a capture may do
                if self.random:
                    streams.set_seed(streams.seed)  # the passes counted from 0
                for k in range(len(self.checkpoints)):
                    self._stage(k)
                self.geo, self.start = self._front()
                self._eigh()
                self.out = self._back()
                torch.cuda.synchronize(device)
                # the captures also exclude a pipelined settle's polls
                # (`PendingCall.wait`), which take the capture lock only
                with pool.capture_lock:
                    before, at, after = self._capture(pool, stream, bucket, batch, apply_name)
            torch.cuda.current_stream(device).wait_stream(stream)
            # the pipelined window's pinned buffers, made here under the lock
            self._slots = [self._new_slot() for _ in range(slots)]
        self.launches = launches_between(before, after)
        self.tail_launches = launches_between(at, after)  # graphs one and two
        self.seconds = time.perf_counter() - t0

    def _capture(self, pool: GraphPool, stream, bucket: int, batch: int, apply_name: str):
        """The stage graphs, graph one and graph two, captured on `stream`
        (the caller holds the card's lock and its capture lock); returns
        the launch counts before the captures, before graph one, and after
        them."""
        before = launch_counts()
        self.stage_graphs = [torch.cuda.CUDAGraph() for _ in self.checkpoints]
        self.graphs = (torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph())
        self.state, self.all_frozen = None, []
        self.geo = self.start = self.out = None
        for k, graph in enumerate(self.stage_graphs):
            at = launch_counts()
            try:
                with torch.cuda.graph(graph, pool=pool.pool_for(graph), stream=stream):
                    self._stage(k)
            except RuntimeError as e:
                raise capture_error(
                    f"early-exit stage {k} (layers to depth {self.checkpoints[k]}; "
                    f"bucket {bucket}, batch {batch})", e) from e
            self.stage_launches.append(launches_between(at, launch_counts()))
        at = launch_counts()
        try:
            with (self.streams.capturing(self.graphs[0]) if self.random
                  else contextlib.nullcontext()), \
                    torch.cuda.graph(self.graphs[0], pool=pool.pool_for(self.graphs[0]),
                                     stream=stream):
                self.geo, self.start = self._front()
        except RuntimeError as e:
            raise capture_error(
                f"{apply_name} and the distogram geometry (bucket {bucket}, "
                f"batch {batch})", e) from e
        try:
            with torch.cuda.graph(self.graphs[1], pool=pool.pool_for(self.graphs[1]),
                                  stream=stream):
                self.out = self._back()
        except RuntimeError as e:
            raise capture_error(
                f"the MDS init and Guttman steps (bucket {bucket}, batch {batch})",
                e) from e
        after = launch_counts()
        return before, at, after

    def _stage(self, k: int):
        """Stage k of the staged trunk on the state; a later stage also
        leaves whether every sample has frozen (`all_frozen[k]`, a device
        bool the host reads after the replay)."""
        if k == 0:
            self.state = staged_front(self.params, self.cfg, self.tokens, self.msa,
                                      mask=self.mask, msa_mask=self.msa_mask,
                                      upto=self.checkpoints[0])
            self.all_frozen = [None]
            return
        staged_step(self.params, self.cfg, self.state, self.checkpoints[k - 1],
                    self.checkpoints[k], self.exit_kl)
        self.all_frozen.append(self.state["frozen"].all())

    def _front(self):
        """Graph one: the forward (the staged trunk's out_logits when early
        exit is armed), the geometry, and the MDS start's input: the
        classical init's Gram matrix, or the random init itself."""
        if self.checkpoints:
            logits = self.state["out_logits"]
        elif self.model_apply_fn is not None:
            logits = self.model_apply_fn(self.params, self.cfg, self.tokens, self.msa,
                                         mask=self.mask, msa_mask=self.msa_mask)
        else:
            logits = alphafold2_apply(self.params, self.cfg, self.tokens, self.msa,
                                      mask=self.mask, msa_mask=self.msa_mask,
                                      device=self.device)
        geo = distogram_geometry(logits, self.mask)
        if self.random:
            return geo, initial_coords(geo["distances"], "random",
                                       self.streams.key().generator())
        return geo, classical_gram(geo["distances"])

    def _eigh(self):
        if self.random:
            return
        evals, evecs = torch.linalg.eigh(self.start)
        if self.evals is None:
            # static buffers in eigh's own (column-major) layout: the
            # Guttman products' cuBLAS call, and so its bits, follow the
            # layout of the init it starts from
            self.evals, self.evecs = torch.empty_like(evals), torch.empty_like(evecs)
        self.evals.copy_(evals)
        self.evecs.copy_(evecs)

    def _back(self):
        coords = self.start if self.random else classical_embed(self.evals, self.evecs)
        coords, stresses, _ = guttman(self.geo["distances"], self.geo["weights"], coords,
                                      self.mds_iters, tol=float("-inf"))  # as the pipeline
        out = {"coords": coords.transpose(1, 2), "confidence": self.geo["confidence"],
               "stress": stresses[-1]}
        if self.checkpoints:
            out["exit_depth"] = self.state["exit_depth"]
        return out

    @property
    def logits(self):
        return self.geo["distogram_logits"]

    def release(self):
        """Drop the graphs, their static buffers and the free pinned
        buffers (the caller holds the card's lock); the counters stay. A
        later call raises."""
        self.stage_graphs, self.graphs, self._slots = [], (), []
        self.state, self.all_frozen = None, []
        self.geo = self.start = self.out = self.evals = self.evecs = None
        self.tokens = self.mask = self.msa = self.msa_mask = None

    def replayed_launches(self) -> dict:
        """The kernel launches the replays made: each graph's captured
        launches times the replays of that graph (a skipped stage none)."""
        graphs = [(self.tail_launches if self.checkpoints else self.launches, self.replays),
                  *zip(self.stage_launches, self.stage_replays)]
        out = {}
        for launches, n in graphs:
            for name, k in launches.items():
                out[name] = out.get(name, 0) + k * n
        return out

    def _replay_stages(self, poll: bool = False):
        """Stage 0, then each later stage until every sample has frozen;
        `poll`: wait for each read's stage as `_wait_for_card` does."""
        last = len(self.stage_graphs) - 1
        for k, graph in enumerate(self.stage_graphs):
            graph.replay()
            self.stage_replays[k] += 1
            if 0 < k < last:
                if poll:
                    self._wait_for_card()
                if bool(self.all_frozen[k].item()):
                    return

    @staticmethod
    def _wait_for_card():
        """Wait for the work queued on the current stream on an event polled
        between sleeps (the caller holds the card's lock), so the host read
        that follows (the eager `eigh`'s status, an early-exit stage's
        frozen flag) finds its data ready. With the blocking read alone a
        pipelined engine's settle thread answered the batch before only
        about when this batch's graph one was done (chip_smoke phase 21's
        timeline: classical p50 at depth 2 632-686 ms against 464-481 at
        depth 0, 460-479 with this wait); what held it back is not
        isolated (`chip_smoke.gil_probe`: the waits themselves release the
        interpreter lock)."""
        event = torch.cuda.Event()
        event.record()
        while not event.query():
            time.sleep(PendingCall.POLL_S)

    def _check_live(self):
        if not self.graphs:
            raise RuntimeError("the executable's graphs were released "
                               "(ServingEngine.release_graphs)")

    def _replay_all(self, poll: bool = False):
        """The stage graphs, graph one, the eager eigh and graph two;
        `poll`: the host reads wait as `_wait_for_card` does (the pipelined
        call)."""
        self._replay_stages(poll)
        self.graphs[0].replay()
        if poll and not self.random:
            self._wait_for_card()
        self._eigh()
        self.graphs[1].replay()
        self.replays += 1

    def __call__(self, tokens, mask, msa=None, msa_mask=None, *, seed=None, events=None):
        """`events`: a (start, end) pair of timing `torch.cuda.Event`s,
        recorded on the current stream around the copies in, the replays
        and the clones out, under the pool's lock (so outside any capture);
        read them after the outputs are on the host."""
        with self.pool.lock, torch.inference_mode():
            self._check_live()
            if events is not None:
                events[0].record()
            # the reseed and the replays are one step under the lock: a
            # replay's prologue reads the seed
            _init_generator(self.streams, self.mds_init, seed)
            self.tokens.copy_(torch.from_numpy(np.asarray(tokens)))
            self.mask.copy_(torch.from_numpy(np.asarray(mask)))
            if self.msa is not None:
                self.msa.copy_(torch.from_numpy(np.asarray(msa)))
                self.msa_mask.copy_(torch.from_numpy(np.asarray(msa_mask)))
            self._replay_all()
            out = {k: self.out[k].clone() for k in self.outputs}
            if events is not None:
                events[1].record()
            return out

    def _new_slot(self):
        """One call's pinned host buffers (the caller holds the card's
        lock): the inputs in the static buffers' dtypes, the outputs in
        the graphs' output layouts (so each copy is one memcpy), each with
        its numpy view, through which the host reads and writes them."""
        inputs = {"tokens": self.tokens, "mask": self.mask}
        if self.msa is not None:
            inputs.update(msa=self.msa, msa_mask=self.msa_mask)
        buffers = {}
        for name, t in list(inputs.items()) + [(k, self.out[k]) for k in self.outputs]:
            host = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="cpu",
                                       pin_memory=True)
            buffers[name] = (host, host.numpy())
        return buffers

    def enqueue(self, tokens, mask, msa=None, msa_mask=None, *, seed=None, timing=False):
        """The pipelined call (module docstring): under the card's lock,
        the inputs through a free slot's pinned buffers, the replays, the
        outputs' copies into the slot and an event after them; returns a
        `PendingCall` without waiting for the outputs. `timing`: two
        timing events around the call's stream work, read by `wait`."""
        with self.pool.lock, torch.inference_mode():
            self._check_live()
            slot = self._slots.pop() if self._slots else self._new_slot()
            staged = {"tokens": tokens, "mask": mask}
            if self.msa is not None:
                staged.update(msa=msa, msa_mask=msa_mask)
            for name, value in staged.items():
                slot[name][1][...] = value  # a host write: the slot is free
            events = ((torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) if timing else None)
            try:
                if events is not None:
                    events[0].record()
                _init_generator(self.streams, self.mds_init, seed)
                for name in staged:
                    getattr(self, name).copy_(slot[name][0], non_blocking=True)
                self._replay_all(poll=True)
                # stream-ordered before any later replay reuses the graphs' memory
                for k in self.outputs:
                    slot[k][0].copy_(self.out[k], non_blocking=True)
                done = events[1] if events is not None else torch.cuda.Event()
                done.record()
            except BaseException:
                events = done = None  # destroyed under the lock
                raise
            return PendingCall(self, slot, done, events)


class PendingCall:
    """A call `CapturedExecutable.enqueue` issued. `wait()` polls its event
    under the card's capture lock (`GraphPool.capture_lock`, which every
    capture holds; released between polls), then copies the outputs out of
    the slot's pinned buffers as numpy, puts the slot back on its
    executable's free list and destroys the events, still under that lock.
    Not under the card's call lock: an enqueue holds that lock while it
    waits for its own graph one (the eager `eigh`), and a settle behind it
    would wait that long too. `device_s`: the call's device seconds from
    its timing events, once waited (None without them)."""

    POLL_S = 2e-4  # seconds between polls of the event

    def __init__(self, exe: CapturedExecutable, slot: dict, done, events):
        self._exe, self._slot, self._done, self._events = exe, slot, done, events
        self._out = None
        self.device_s = None

    def wait(self) -> dict:
        lock = self._exe.pool.capture_lock
        while self._out is None:
            with lock:
                if self._done.query():
                    self._collect()
                    break
            time.sleep(self.POLL_S)
        return self._out

    def _collect(self):
        """Under the card's capture lock, once the event has completed (the
        worker pops free slots under the call lock: a list's append and
        pop need no common lock)."""
        self._out = {k: self._slot[k][1].copy() for k in self._exe.outputs}
        if self._events is not None:
            self.device_s = self._events[0].elapsed_time(self._events[1]) / 1e3
        self._done = self._events = None  # destroyed under the lock
        if self._exe.graphs:  # a released executable keeps no free slots
            self._exe._slots.append(self._slot)
        self._slot = None
