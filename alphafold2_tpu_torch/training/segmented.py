"""The segmented end-to-end train step (counterpart of
alphafold2_tpu/training/segmented.py).

JAX splits `make_train_step(ecfg, tcfg, loss_fn=e2e_loss_fn)`'s step on a
reversible config into a chain of executions, one a trunk segment, so that
no single execution outlives a runtime's time limit; the reversible
trunk's backward rebuilds each segment's input, so only the boundary
state (x1, x2, m1, m2) passes between them. CUDA has no such limit, and
the port's eager reversible step already runs the same layers in the same
order (`models/reversible.py _ReversibleCore`: `_layer_forward` forward,
`_layer_backward` in reverse), so the segments are the monolithic step:
`make_segmented_train_step` returns it, with JAX's refusal of a config
that is not reversible. The state is the same tree, so checkpoints cross
between the two steps and JAX's. `plan_segments` keeps JAX's partition
of the depth.
"""

from __future__ import annotations

from alphafold2_tpu_torch.training.e2e import E2EConfig, e2e_loss_fn
from alphafold2_tpu_torch.training.harness import TrainConfig, make_train_step


def plan_segments(layer_sparse, n_segments: int):
    """Split the depth into segments of at most ceil(depth / n_segments)
    layers, never across a change of the per-layer sparse flag (JAX's scan
    body is specialised on it). Returns [(start, end, flag), ...]."""
    depth = len(layer_sparse)
    target = max(1, -(-depth // max(1, n_segments)))
    segments, run_start = [], 0
    for i in range(1, depth + 1):
        if i < depth and layer_sparse[i] == layer_sparse[run_start]:
            continue
        for pos in range(run_start, i, target):
            segments.append((pos, min(pos + target, i), layer_sparse[run_start]))
        run_start = i
    return segments


def make_segmented_train_step(ecfg: E2EConfig, tcfg: TrainConfig, trunk_segments: int,
                              device=None):
    """`train_step(state, batch, rng=None) -> (state, metrics)` for
    `trunk_segments` segments of the reversible trunk: the monolithic
    `make_train_step(ecfg, tcfg, loss_fn=e2e_loss_fn, device=device)`
    (see the module docstring). Refuses a config that is not reversible;
    a microbatch without an MSA stream (msa or embedds) raises, as the
    reversible trunk does."""
    if not ecfg.model.reversible:
        raise ValueError("the segmented step requires cfg.reversible=True (a segment's "
                         "backward is the reversible trunk's reconstruction)")
    return make_train_step(ecfg, tcfg, loss_fn=e2e_loss_fn, device=device)
