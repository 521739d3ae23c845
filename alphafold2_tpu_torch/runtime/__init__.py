"""The native host runtime (counterpart of alphafold2_tpu/runtime/): the
C++ prefetch batch loader of `csrc/af2_runtime.cc`, bound with ctypes and
built at first use (`runtime/native.py`)."""

from alphafold2_tpu_torch.runtime.native import NativePrefetchLoader

__all__ = ["NativePrefetchLoader"]
