"""Device placement for the port's entry points.

Entry points (`alphafold2_apply`, `predict_structure`, the CLI) run on
CUDA unless the caller asks for the CPU with `device="cpu"`. With no GPU
and no explicit CPU request they raise: they never quietly run on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_device_tensor(x, device, dtype=None):
    """numpy array / tensor / None -> tensor on `device` (None passes)."""
    if x is None:
        return None
    return torch.as_tensor(x, dtype=dtype).to(device)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def check_params_device(params, device: torch.device) -> None:
    """Raise unless every parameter tensor lies on `device`."""
    wrong = {str(t.device) for t in tree_leaves(params) if t.device != device}
    if wrong:
        raise ValueError(
            f"parameters lie on {sorted(wrong)} but the run is on {device}; "
            f"build them there (alphafold2_init / params_from_jax take a device)"
        )
