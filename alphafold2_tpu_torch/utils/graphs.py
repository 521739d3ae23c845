"""What the port's CUDA graph captures share (`serving/executable.py`,
`training/executable.py`): the kernel wrappers' launch counts, which a
replay does not move, and the error a failed capture raises."""

from __future__ import annotations

import traceback
from pathlib import Path

from alphafold2_tpu_torch.ops import flash_kernel, quant_kernel, sparse_kernel

COUNTED = (flash_kernel, quant_kernel, sparse_kernel)  # the modules with launch counts
_PACKAGE = str(Path(__file__).resolve().parents[1])


def launch_counts() -> dict:
    """Every kernel wrapper's launches since its module's reset."""
    return {name: n for module in COUNTED for name, n in module.LAUNCHES.items()}


def launches_between(before: dict, after: dict) -> dict:
    """The launches counted from `before` to `after` (nonzero entries)."""
    return {k: n - before[k] for k, n in after.items() if n != before[k]}


class CaptureError(RuntimeError):
    """A CUDA graph capture failed; the message names the op (the source
    line of the port that issued it) and the CUDA error."""


def capture_error(what: str, exc: BaseException) -> CaptureError:
    """A CaptureError naming the innermost line of the port that raised the
    first error of `exc`'s chain (a failed capture's end may raise again,
    over the op's own error)."""
    chain = []
    while exc is not None and exc not in chain:
        chain.append(exc)
        exc = exc.__context__
    where = "an op outside the port"
    for e in reversed(chain):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.filename.startswith(_PACKAGE) and not f.filename.endswith("executable.py")]
        if frames:
            f = frames[-1]
            where = (f"{Path(f.filename).relative_to(Path(_PACKAGE).parent)}:{f.lineno} "
                     f"({f.name}: `{f.line}`)")
            break
    errors = "; then ".join(f"{type(e).__name__}: {e}" for e in reversed(chain))
    return CaptureError(f"CUDA graph capture of {what} failed at {where}: {errors}")
