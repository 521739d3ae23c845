"""Model configuration (counterpart of alphafold2_tpu/models/config.py).

The same field names as the JAX `Alphafold2Config`, with a torch compute
dtype. Values whose code paths this port does not have yet raise
NotImplementedError naming the ROADMAP item that brings them.
`weight_dtype="int8"` is the inference-only int8 arm (ops/quant.py; the
training entry points refuse it); `sparse_self_attn` runs the flagged
layers' pair-axial passes block-sparse (ops/sparse.py).
`scan_layers` is the same math as the unrolled trunk and runs as a loop;
`remat` recomputes each trunk layer in the backward pass; `remat_policy`
names the products that recompute keeps instead ("dots": every matrix
product, "dots_no_batch": those without a batch dimension).
`trunk_schedule="branch_parallel"` runs each layer's MSA branch on a side
stream on CUDA (models/trunk.py `branch_parallel_layer_apply`): the same
ops as "serial", in the same order on the CPU.
`reversible` runs the reversible dual-stream trunk (models/reversible.py),
whose backward rebuilds each layer's input from its output; as in JAX it
excludes `remat`, and `remat_policy` is unread under it. With
"branch_parallel" each reversible layer's MSA half runs on the side
stream on CUDA, in the forward and in the backward's inversion.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from alphafold2_tpu_torch.constants import (
    DISTOGRAM_BUCKETS,
    MAX_NUM_MSA,
    NUM_AMINO_ACIDS,
    NUM_EMBEDDS_TR,
)
from alphafold2_tpu_torch.ops.attention import AttentionConfig
from alphafold2_tpu_torch.ops.sparse import SparseConfig


@dataclasses.dataclass(frozen=True)
class Alphafold2Config:
    dim: int
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    max_seq_len: int = 2048
    num_tokens: int = NUM_AMINO_ACIDS
    num_embedds: int = NUM_EMBEDDS_TR
    max_num_msa: int = MAX_NUM_MSA
    num_buckets: int = DISTOGRAM_BUCKETS
    attn_dropout: float = 0.0  # applied only when the apply gets an rng
    ff_dropout: float = 0.0
    reversible: bool = False
    remat: bool = False
    remat_policy: Optional[str] = None
    scan_layers: bool = False
    sparse_self_attn: Union[bool, Tuple[bool, ...]] = False
    sparse_block_size: int = 16
    sparse_num_random_blocks: Optional[int] = None
    sparse_num_local_blocks: int = 4
    sparse_num_global_blocks: int = 1
    sparse_layout_seed: int = 0
    cross_attn_compress_ratio: int = 1
    cross_attn_mode: str = "flat"  # "flat" | "aligned"
    msa_tie_row_attn: bool = False
    attn_flash: Union[bool, str] = "auto"
    attn_batch_chunk: int = 0
    attn_flash_tile_elems: int = 1 << 25
    attn_flash_kv_block: int = 2048
    attn_flash_qb_target: Optional[int] = None  # TPU kernel block target: unread
    attn_flash_compute_dtype_logits: bool = False
    attn_gate: bool = False
    trunk_schedule: str = "serial"
    ff_chunk_size: int = 0
    template_attn_depth: int = 2
    dtype: torch.dtype = torch.float32
    weight_dtype: str = "f32"

    def __post_init__(self):
        if self.remat_policy not in (None, "dots", "dots_no_batch"):
            raise ValueError(
                f"remat_policy must be None, 'dots', or 'dots_no_batch', "
                f"got {self.remat_policy!r}"
            )
        if self.reversible and self.remat:
            raise ValueError(
                "reversible=True and remat=True are mutually exclusive "
                "activation-memory strategies; pick one"
            )
        if self.cross_attn_mode not in ("flat", "aligned"):
            raise ValueError(
                f"cross_attn_mode must be 'flat' or 'aligned', got {self.cross_attn_mode!r}"
            )
        if self.trunk_schedule not in ("serial", "branch_parallel"):
            raise ValueError(
                f"trunk_schedule must be 'serial' or 'branch_parallel', got "
                f"{self.trunk_schedule!r}"
            )
        if self.weight_dtype not in ("f32", "int8"):
            raise ValueError(f"weight_dtype must be 'f32' or 'int8', got {self.weight_dtype!r}")
        if self.attn_gate and any(self.layer_sparse):
            raise ValueError(
                "attn_gate is not supported with sparse self-attention "
                "(the block-sparse path has no gate projection)"
            )
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {self.dtype}")

    @property
    def layer_sparse(self) -> Tuple[bool, ...]:
        v = self.sparse_self_attn
        return v if isinstance(v, tuple) else (bool(v),) * self.depth

    def sparse_config(self) -> SparseConfig:
        return SparseConfig(
            block_size=self.sparse_block_size,
            num_random_blocks=self.sparse_num_random_blocks,
            num_local_blocks=self.sparse_num_local_blocks,
            num_global_blocks=self.sparse_num_global_blocks,
            layout_seed=self.sparse_layout_seed,
            max_seq_len=self.max_seq_len,
        )

    def _attn_config(self, compress_ratio: int) -> AttentionConfig:
        return AttentionConfig(
            dim=self.dim,
            heads=self.heads,
            dim_head=self.dim_head,
            dropout=self.attn_dropout,
            compress_ratio=compress_ratio,
            dtype=self.dtype,
            flash=self.attn_flash,
            batch_chunk=self.attn_batch_chunk,
            flash_tile_elems=self.attn_flash_tile_elems,
            flash_kv_block=self.attn_flash_kv_block,
            flash_compute_dtype_logits=self.attn_flash_compute_dtype_logits,
            gate=self.attn_gate,
        )

    def self_attn_config(self) -> AttentionConfig:
        return self._attn_config(1)

    def cross_attn_config(self) -> AttentionConfig:
        return self._attn_config(self.cross_attn_compress_ratio)
