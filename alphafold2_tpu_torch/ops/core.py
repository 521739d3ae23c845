"""Functional NN primitives on plain parameter dicts.

Counterpart of alphafold2_tpu/ops/core.py. Parameters are nested dicts of
tensors with the JAX package's names and layouts (a dense weight is
(d_in, d_out)), so a JAX parameter tree maps over leaf by leaf
(models/convert.py). Parameters are stored in float32; `dtype` selects
the compute dtype. LayerNorm statistics are always float32.

Initialisation follows the JAX package's (torch defaults): Linear
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), Embedding N(0, 1), LayerNorm ones and
zeros. Random draws come from an explicit `torch.Generator`, on its own
device, and are moved to `device`: a CPU generator gives a seed the same
weights on every device; a CUDA generator draws on the card (a large model
made there without a host copy).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from alphafold2_tpu_torch.utils.rng import rows_of


def uniform(gen: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    t = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device) * (2 * bound) - bound
    return t.to(device)


# --- linear -----------------------------------------------------------------


def linear_init(gen, d_in: int, d_out: int, device, bias: bool = True):
    """Params for a dense layer; weight layout (d_in, d_out)."""
    bound = 1.0 / math.sqrt(d_in)
    params = {"w": uniform(gen, (d_in, d_out), bound, device)}
    if bias:
        params["b"] = uniform(gen, (d_out,), bound, device)
    return params


def linear(params, x, dtype=None):
    """y = x @ w (+ b), computed in `dtype` when given (params are cast).

    A quantized dict ({"qw": int8, "scale": f32}, ops/quant.py
    quantize_tree) goes through the int8 product `quant_matmul` instead:
    every dense layer reaches it with no per-layer wiring."""
    if "qw" in params:
        from alphafold2_tpu_torch.ops.quant import quant_matmul

        y = quant_matmul(x, params["qw"], params["scale"], dtype=dtype)
        if "b" in params:
            y = y + params["b"].to(y.dtype)
        return y
    w = params["w"]
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    y = x @ w
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


# --- layer norm -------------------------------------------------------------


def layer_norm_init(dim: int, device):
    return {
        "scale": torch.ones(dim, device=device),
        "bias": torch.zeros(dim, device=device),
    }


def layer_norm(params, x, eps: float = 1e-5):
    """LayerNorm over the last axis; statistics in float32, output in x.dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


# --- embedding --------------------------------------------------------------


def embedding_init(gen, num_embeddings: int, dim: int, device):
    table = torch.randn((num_embeddings, dim), generator=gen, dtype=torch.float32,
                        device=gen.device)
    return {"table": table.to(device)}


def embedding(params, ids, dtype=None):
    table = params["table"]
    if dtype is not None:
        table = table.to(dtype)
    return table[ids]


# --- dropout ----------------------------------------------------------------


def row_span(lead: int, generator: Optional[torch.Generator]):
    """For a tensor whose leading axis of length `lead` folds the batch
    rows outermost (b, or b x heads, ...): (first, whole), this shard's
    first index along that axis and the axis's length over the whole batch,
    where `generator` carries a data-parallel shard's rows (utils/rng.py
    `rows_of`); (0, lead) otherwise."""
    rows = rows_of(generator)
    if rows is None:
        return 0, lead
    start, count, total = rows
    if lead % count:
        raise ValueError(f"a leading axis of {lead} does not fold the {count} batch rows "
                         f"of this shard outermost")
    per = lead // count
    return start * per, total * per


def rand_rows(shape, generator: torch.Generator, device, dtype=torch.float32):
    """`torch.rand(shape)` from `generator` on `device`, the leading axis
    folding the batch rows: where the generator carries a shard's rows
    (`row_span`), this shard's rows of the whole batch's draw. The draw is
    the whole batch's, so a shard of P pays P times its own share: a
    counter-based draw of its own rows waits (ROADMAP A13-dp-draws)."""
    first, whole = row_span(shape[0], generator)
    if whole == shape[0]:
        return torch.rand(shape, generator=generator, dtype=dtype, device=device)
    draw = torch.rand((whole, *shape[1:]), generator=generator, dtype=dtype, device=device)
    return draw[first:first + shape[0]]


def dropout(x, rate: float, generator: Optional[torch.Generator] = None):
    """Inverted dropout (JAX `dropout(rng, x, rate)`): the identity when the
    rate is 0 or no generator is given (eval mode); otherwise each element
    is kept with probability 1 - rate and scaled by 1 / (1 - rate). The
    mask is drawn from `generator`, which lies on x's device; x's leading
    axis folds the batch rows outermost (`rand_rows`). JAX's random bits and
    torch's differ: the two agree in distribution only."""
    if rate == 0.0 or generator is None:
        return x
    keep = rand_rows(x.shape, generator, x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
