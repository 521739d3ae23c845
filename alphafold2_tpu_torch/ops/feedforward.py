"""GEGLU feed-forward block (counterpart of alphafold2_tpu/ops/feedforward.py).

Linear(d -> 2*mult*d) -> value * gelu(gate) with exact (erf) GELU ->
dropout -> Linear(mult*d -> d). `chunk` processes the flattened token axes
in blocks of that many tokens, bounding the 8*dim GEGLU intermediate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from alphafold2_tpu_torch.ops import core
from alphafold2_tpu_torch.ops.core import dropout, linear, linear_init


def feed_forward_init(gen, dim: int, device, mult: int = 4):
    return {
        "proj_in": linear_init(gen, dim, dim * mult * 2, device),
        "proj_out": linear_init(gen, dim * mult, dim, device),
    }


def _ff_core(params, x, dropout_rate, rng, dtype):
    value, gate = linear(params["proj_in"], x, dtype=dtype).chunk(2, dim=-1)
    y = dropout(value * F.gelu(gate), dropout_rate, rng)
    return linear(params["proj_out"], y, dtype=dtype)


def feed_forward_apply(params, x, *, dropout_rate: float = 0.0, rng=None,
                       dtype=None, chunk: int = 0):
    """rng: a generator on x's device for dropout (None: eval mode)."""
    tokens = x.shape[:-1].numel()
    if not chunk or tokens <= chunk:
        return _ff_core(params, x, dropout_rate, rng, dtype)
    if rng is not None and dropout_rate > 0.0 and core.row_span(x.shape[0], rng) != (0, x.shape[0]):
        # a chunk's draw spans the flattened tokens of every row
        raise ValueError("a chunked feed-forward with live dropout takes the whole batch; "
                         "set ff_chunk_size=0 to train it data-parallel")
    xf = x.reshape(tokens, x.shape[-1])
    out = torch.cat([
        _ff_core(params, xf[s:s + chunk], dropout_rate, rng, dtype)
        for s in range(0, tokens, chunk)
    ])
    return out.reshape(*x.shape[:-1], out.shape[-1])
