"""Weight residency for the serving tier (counterpart of
alphafold2_tpu/serving/quant_residency.py).

`resident_params(params, model_cfg)` is the tree a server places on the
card for a config: the f32 tree itself for `weight_dtype="f32"`, the
per-channel int8 tree (ops/quant.py `quantize_tree`) for "int8", served
from a small process cache keyed by `residency_tag` so replicas sharing
one master tree quantize it once. The cache holds the source tree and
revalidates by identity: a new tree under the same tag is quantized anew.

`residency_tag` digests `repr((model_cfg, params_tag))` as the JAX package
does. A torch dtype's repr (`torch.bfloat16`) differs from a jnp dtype's,
so the port's tags differ from the JAX package's for the same settings;
they only have to be stable within one process. An executable's priced
residency is `serving/sp_arm.py schedule_residency`'s.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Tuple

from alphafold2_tpu_torch.ops.quant import quantize_tree, tree_weight_bytes

__all__ = ["resident_params", "residency_tag", "clear_residency_cache"]

_CACHE_MAX = 8  # distinct (config, checkpoint) tags held at once

_lock = threading.Lock()
# tag -> {"source": params, "tree": quantized tree, "info": dict}
_cache: "collections.OrderedDict[str, dict]" = collections.OrderedDict()


def residency_tag(model_cfg, params_tag: str = "") -> str:
    """`<weight_dtype>-<12 hex digits of sha256(repr((model_cfg, params_tag)))>`."""
    digest = hashlib.sha256(repr((model_cfg, params_tag)).encode()).hexdigest()[:12]
    return f"{getattr(model_cfg, 'weight_dtype', 'f32')}-{digest}"


def resident_params(params, model_cfg, *, params_tag: str = "") -> Tuple[object, dict]:
    """(the tree to serve, {"tag", "weight_dtype", "weight_bytes" (the
    served tree), "fp32_weight_bytes" (the master), "cached"})."""
    tag = residency_tag(model_cfg, params_tag)
    if getattr(model_cfg, "weight_dtype", "f32") != "int8":
        fp32_bytes = tree_weight_bytes(params)
        return params, {"tag": tag, "weight_dtype": "f32", "weight_bytes": fp32_bytes,
                        "fp32_weight_bytes": fp32_bytes, "cached": False}

    with _lock:
        entry = _cache.get(tag)
        if entry is not None and entry["source"] is params:
            _cache.move_to_end(tag)
            return entry["tree"], {**entry["info"], "cached": True}

    fp32_bytes = tree_weight_bytes(params)
    qtree = quantize_tree(params)
    info = {"tag": tag, "weight_dtype": "int8", "weight_bytes": tree_weight_bytes(qtree),
            "fp32_weight_bytes": fp32_bytes, "cached": False}
    with _lock:
        _cache[tag] = {"source": params, "tree": qtree, "info": info}
        _cache.move_to_end(tag)
        while len(_cache) > _CACHE_MAX:
            _cache.popitem(last=False)
    return qtree, dict(info)


def clear_residency_cache() -> None:
    """Drop every cached quantized tree."""
    with _lock:
        _cache.clear()

