"""alphafold2_tpu_torch — the PyTorch/CUDA port of alphafold2_tpu for an
NVIDIA H100.

It mirrors the JAX package's module paths and imports nothing of it: the
JAX package stays the reference that the port's tests hold it against.
Plain tensor code is PyTorch; the Pallas TPU kernels on the ported path
are hand-written CUDA kernels (ops/flash_kernel.py, csrc/). Entry points
run on CUDA unless the caller passes device="cpu".
"""

from alphafold2_tpu_torch.models.alphafold2 import alphafold2_apply, alphafold2_init
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.convert import params_from_jax
from alphafold2_tpu_torch.serving.pipeline import predict_structure

__all__ = [
    "Alphafold2Config",
    "alphafold2_init",
    "alphafold2_apply",
    "params_from_jax",
    "predict_structure",
]
