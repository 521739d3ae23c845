"""Primitives, attention and the CUDA flash-attention kernels."""
