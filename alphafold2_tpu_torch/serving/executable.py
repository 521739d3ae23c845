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

Those are the functions `predict_structure` runs, on the same values, so
a replay gives the eager request's outputs bit for bit. A call copies the
inputs into the static buffers, replays, and clones the outputs out of the
graphs' memory before it returns.

All of an engine's graphs share one memory pool (`GraphPool`): a graph's
intermediates may lie where another graph's do. That is safe only because
a call holds the pool's lock from its first copy in to its outputs'
clones, so graphs replay one at a time and nothing reads a graph's outputs
after another graph has run; a capture holds the same lock.

The kernel wrappers count launches in Python, so a replay adds nothing to
their `LAUNCHES`: each executable records the launches its capture
recorded (`launches`), and `replays` how often it ran. On the CPU an
`EagerExecutable` runs `predict_structure` itself.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from alphafold2_tpu_torch.geometry.mds import classical_embed, classical_gram, guttman
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_apply
from alphafold2_tpu_torch.serving.pipeline import distogram_geometry, predict_structure
from alphafold2_tpu_torch.utils.graphs import capture_error, launch_counts, launches_between

OUTPUTS = ("coords", "confidence", "stress")  # what a call returns


class GraphPool:
    """One CUDA graph memory pool for an engine's executables, and the lock
    under which they capture and replay one at a time."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()


class EagerExecutable:
    """The CPU's executable: `predict_structure` on the padded batch
    (`generator`: the random MDS init's draws, in call order)."""

    def __init__(self, params, cfg, *, mds_iters: int, mds_init: str, device,
                 generator=None):
        self.params, self.cfg, self.device = params, cfg, device
        self.mds_iters, self.mds_init, self.generator = mds_iters, mds_init, generator
        self.seconds = 0.0
        self.launches = {}
        self.replays = 0

    def __call__(self, tokens, mask, msa=None, msa_mask=None):
        out = predict_structure(self.params, self.cfg, tokens, mask=mask, msa=msa,
                                msa_mask=msa_mask, mds_iters=self.mds_iters,
                                mds_init=self.mds_init, generator=self.generator,
                                device=self.device)
        self.replays += 1
        return {k: out[k] for k in OUTPUTS}


class CapturedExecutable:
    """One (bucket, rung) on the card: captured at construction, then
    `__call__(tokens, mask, msa, msa_mask)` (host numpy of the padded
    batch) replays it and returns device tensors coords (b, L, 3),
    confidence (b, L) and stress (b,), cloned out of the graphs' memory.
    `logits` holds the last call's distogram logits until the next replay
    of any graph of the pool. Capture raises `CaptureError` naming the op
    it could not capture; nothing falls back to eager."""

    def __init__(self, params, cfg, *, batch: int, bucket: int, msa_rows: int,
                 mds_iters: int, device, pool: GraphPool):
        self.params, self.cfg, self.device, self.pool = params, cfg, device, pool
        self.mds_iters = mds_iters
        self.replays = 0
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
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                # the warm-up builds and loads the kernels, the sparse block
                # tables and the thresholds on the card, and cuBLAS's state,
                # none of which a capture may do
                self.geo, self.gram = self._front()
                self._eigh()
                self.out = self._back()
                torch.cuda.synchronize(device)
                before = launch_counts()
                self.graphs = (torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph())
                self.geo = self.gram = self.out = None
                try:
                    with torch.cuda.graph(self.graphs[0], pool=pool.handle, stream=stream):
                        self.geo, self.gram = self._front()
                except RuntimeError as e:
                    raise capture_error(
                        f"the forward and the distogram geometry (bucket {bucket}, "
                        f"batch {batch})", e) from e
                try:
                    with torch.cuda.graph(self.graphs[1], pool=pool.handle, stream=stream):
                        self.out = self._back()
                except RuntimeError as e:
                    raise capture_error(
                        f"the MDS init and Guttman steps (bucket {bucket}, batch {batch})",
                        e) from e
                after = launch_counts()
            torch.cuda.current_stream(device).wait_stream(stream)
        self.launches = launches_between(before, after)
        self.seconds = time.perf_counter() - t0

    def _front(self):
        logits = alphafold2_apply(self.params, self.cfg, self.tokens, self.msa, mask=self.mask,
                                  msa_mask=self.msa_mask, device=self.device)
        geo = distogram_geometry(logits, self.mask)
        return geo, classical_gram(geo["distances"])

    def _eigh(self):
        evals, evecs = torch.linalg.eigh(self.gram)
        if self.evals is None:
            # static buffers in eigh's own (column-major) layout: the
            # Guttman products' cuBLAS call, and so its bits, follow the
            # layout of the init it starts from
            self.evals, self.evecs = torch.empty_like(evals), torch.empty_like(evecs)
        self.evals.copy_(evals)
        self.evecs.copy_(evecs)

    def _back(self):
        coords = classical_embed(self.evals, self.evecs)
        coords, stresses = guttman(self.geo["distances"], self.geo["weights"], coords,
                                   self.mds_iters)
        return {"coords": coords.transpose(1, 2), "confidence": self.geo["confidence"],
                "stress": stresses[-1]}

    @property
    def logits(self):
        return self.geo["distogram_logits"]

    def __call__(self, tokens, mask, msa=None, msa_mask=None):
        with self.pool.lock, torch.inference_mode():
            self.tokens.copy_(torch.from_numpy(np.asarray(tokens)))
            self.mask.copy_(torch.from_numpy(np.asarray(mask)))
            if self.msa is not None:
                self.msa.copy_(torch.from_numpy(np.asarray(msa)))
                self.msa_mask.copy_(torch.from_numpy(np.asarray(msa_mask)))
            self.graphs[0].replay()
            self._eigh()
            self.graphs[1].replay()
            self.replays += 1
            return {k: self.out[k].clone() for k in OUTPUTS}
