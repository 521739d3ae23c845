"""CUDA block-sparse attention kernels (B5), their binding and plain versions.

Counterpart of alphafold2_tpu/ops/sparse_kernel.py:

  * `sparse_fwd` (B5f) replaces `block_sparse_attention_tpu`'s forward
    (`_forward` / `_fwd_kernel`);
  * `sparse_bwd` launches the two backward kernels, B5 dq and B5 dkv
    (`_backward_pallas` / `_dq_kernel`, `_dkv_kernel`), after computing
    delta = rowsum(dO * O) here, as JAX does (:297-300;
    `flash_kernel.cotangent_terms`).

All take the folded layout q, k, v (BH, n, dh) in float32 or bfloat16 with
n a multiple of the block size, a key-side additive bias (BH / heads, n)
f32 (0 or -inf; row bh reads bias row bh // heads) and a `BlockTable` (the
layout's active key blocks per query block). The forward returns (out
(BH, n, dh) in the input dtype, lse (BH, n) f32); a row with no unmasked
key gives zeros and lse = +inf. `sparse_fwd` and `sparse_bwd` take CUDA
tensors only and launch csrc/sparse_attn.cu (built at first use) or raise.
Their plain versions (`sparse_fwd_plain`, `sparse_bwd_dq_plain`,
`sparse_bwd_dkv_plain`) are the one block-gather formulation of the port,
in f32 and tiled over BH: `sparse_fwd_plain` is differentiable, and
ops/sparse.py's `block_sparse_attention` (the CPU route) runs it.
`SparseKernelAttention` is the autograd.Function the CUDA route runs.

Every one of them takes attention dropout (JAX's `dropout` on the
probabilities, alphafold2_tpu/ops/sparse.py:156): a rate and a seed, two
int64 drawn at the layer's rng position and read on the device. The
probabilities that feed P.V are multiplied by Z = keep / (1 - rate), the
row sums and lse keep the undropped ones, and the backward redraws Z: dV =
(P Z)^T dO, dS = P (dP Z - delta). The keep bit of element (bh, query i,
key j) is `philox_keep`'s: Philox4x32-10 of its sequence coordinates, the
same bits in every kernel (csrc/philox.cuh) and plain version, on either
device. The plain versions also take an explicit dense (BH, n, n) keep mask
in place of the seed (JAX's own draw, in the parity tests).

The bf16 forward takes one of two kernels by the shape of the call
(`route`): "wgmma" at dh 64 and block size 16 (every served and trained
shape), "mma_sync" for the other bfloat16 calls; float32 takes "f32". A
route is chosen, never fallen back to. The wgmma route is the flash
forward's wgmma pipeline over the 128-key stages a 128- or 192-row query
tile attends anywhere (the table's `union_list`), the (query block, key
block) pairs it does not attend masked. The backward kernels take their
routes by the same rule (`bwd_route`): B5 dkv's wgmma route is the flash
backward's dkv pipeline over the 64-query stages that attend a 128-key tile
(the table's `key_unions`), B5 dq's a dq pipeline of its own over the
forward's 128-row stage lists. `LAUNCHES` counts kernel launches per kernel
and each launch again under `sparse_fwd_<route>`, `sparse_bwd_dq_<route>`
or `sparse_bwd_dkv_<route>`, and a launch with dropout again under
`<kernel>_dropout`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from alphafold2_tpu_torch.ops import cuda_build, dispatch, flash_kernel
from alphafold2_tpu_torch.ops.flash import aligned

ROUTES = ("wgmma", "mma_sync", "f32")  # each kernel's
KERNELS = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
LAUNCHES = {**{kernel: 0 for kernel in KERNELS},
            **{f"{kernel}_{r}": 0 for kernel in KERNELS for r in ROUTES + ("dropout",)}}

SUPPORTED_BLOCK_SIZES = (16, 32, 64, 128)
SUPPORTED_DH = (16, 32, 64)
WGMMA_DH, WGMMA_BLOCK = 64, 16  # the wgmma route's shape (csrc kWDH, kLBs)
UNION_STAGE = 128  # keys a stage of the forward's and dq's wgmma routes (csrc kWN)
KEY_TILE, QUERY_STAGE = 128, 64  # the dkv wgmma route's key tile and query stage (kWKeys, kWQ)

# gathered (bh, query block, slot, row, dh) elements the plain versions hold at once
PLAIN_TILE_ELEMS = 1 << 26


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class BlockTable:
    """A block layout as the kernels read it: idx (B, A) int32, the active
    key blocks of each query block with the valid slots first and -1 in
    the padding; counts (B,) int32, the valid slots of each row. The layout
    is symmetric, so row c also lists the query blocks attending key block
    c (the dkv kernel's view). At block size 16 the wgmma routes read
    `unions`, the stage lists of `union_list` at 128- and 192-row tiles
    (offsets, entries, offsets, entries: the forward's, and dq's at 128),
    and `key_unions`, the dkv route's at KEY_TILE-key tiles and
    QUERY_STAGE-query stages (offsets, entries); other tables have
    neither."""

    idx: torch.Tensor
    counts: torch.Tensor
    block_size: int
    unions: tuple = ()
    key_unions: tuple = ()

    @property
    def n_blocks(self) -> int:
        return self.idx.shape[0]

    @property
    def nnz(self) -> int:
        """Active (query block, key block) pairs."""
        return int(self.counts.sum())


def union_list(layout: np.ndarray, tile_rows: int, stage: int = UNION_STAGE):
    """A wgmma route's stage list at block size 16: for each tile of
    `tile_rows` rows of `layout` (64 a warpgroup), the stages of `stage`
    columns holding a column block that some row block of the tile
    attends, with one mask for each warpgroup (4 row blocks by sb = stage /
    16 column blocks: bit sb r + c set where the warpgroup's row block r
    attends the stage's column block c); a tile with none lists stage 0
    with empty masks. The forward's and dq's lists are the query tiles' over
    128-key stages (32-bit masks), the dkv route's the key tiles' of the
    transposed layout over 64-query stages (16 bits).
    Returns (offsets (tiles + 1,) int32, entries (E, 4) int32: stage, three
    masks)."""
    B = layout.shape[0]
    tb, sb = tile_rows // WGMMA_BLOCK, stage // WGMMA_BLOCK
    n_qt, n_st = -(-B // tb), -(-B // sb)
    padded = np.zeros((n_qt * tb, n_st * sb), bool)
    padded[:B, :B] = layout
    bits = padded.reshape(n_qt, tb // 4, 4, n_st, sb).transpose(0, 3, 1, 2, 4)
    weights = np.uint64(1) << np.arange(4 * sb, dtype=np.uint64)
    masks = (bits.reshape(n_qt, n_st, tb // 4, 4 * sb).astype(np.uint64) * weights).sum(-1)
    offsets, entries = [0], []
    for qt in range(n_qt):
        live = [st for st in range(n_st) if masks[qt, st].any()] or [0]
        for st in live:
            row = [int(m) for m in masks[qt, st]] + [0] * (3 - tb // 4)
            entries.append([st] + row)
        offsets.append(len(entries))
    entries = np.asarray(entries, np.uint32).view(np.int32).reshape(-1, 4)
    return np.asarray(offsets, np.int32), entries


def block_table(idx: np.ndarray, valid: np.ndarray, block_size: int, device) -> BlockTable:
    """The kernels' table from `layout_block_indices`' (idx, valid), with the
    wgmma routes' stage lists at block size 16."""
    counts = valid.sum(axis=1).astype(np.int32)
    if not (valid == (np.arange(valid.shape[1])[None, :] < counts[:, None])).all():
        raise ValueError("block table: the valid slots must come first in each row")
    layout = np.zeros((idx.shape[0], idx.shape[0]), bool)
    rows = np.repeat(np.arange(idx.shape[0]), valid.sum(axis=1))
    layout[rows, idx[valid]] = True
    if not (layout == layout.T).all():
        raise ValueError("block table: the layout must be symmetric (the dkv kernel reads "
                         "a key block's own row)")
    table = np.where(valid, idx, -1).astype(np.int32)
    unions = key_unions = ()
    if block_size == WGMMA_BLOCK:  # the wgmma routes' block size
        unions = tuple(torch.from_numpy(a).to(device) for rows in (128, 192)
                       for a in union_list(layout, rows))
        key_unions = tuple(torch.from_numpy(a).to(device)
                           for a in union_list(layout.T, KEY_TILE, QUERY_STAGE))
    return BlockTable(torch.from_numpy(table).to(device), torch.from_numpy(counts).to(device),
                      block_size, unions, key_unions)


# --- attention dropout's bits ----------------------------------------------------

_U32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # Philox4x32's multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # its key bumps


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m, for int64 tensors a holding uint32
    values and a uint32 constant m, in products that stay below 2^49."""
    top = (a >> 16) * m            # a's high half times m, < 2^48
    low = (a & 0xFFFF) * m + ((top & 0xFFFF) << 16)  # < 2^49
    return (top >> 16) + (low >> 32), low & _U32


def philox4x32(counter, key):
    """Philox4x32-10 (Salmon et al., SC 2011; csrc/philox.cuh) on int64
    tensors holding uint32 values: counter (c0, c1, c2, c3), key (k0, k1),
    each broadcast against the others. Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & _U32, (k1 + PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """An element is kept iff its 32 bits are at least round(rate 2^32)."""
    return min(_U32, int(round(rate * 2.0 ** 32)))


def philox_keep(seed, bh, rows, cols, rate: float):
    """The keep mask of attention dropout at (bh, query rows, key cols)
    (int64 tensors, broadcast), bool: seed (2,) int64, the key seed[0] and
    the counter's fourth word seed[1] (low 32 bits). Elements come in groups
    {i, i + 8} x {j, j + 8}, bit 3 of i and j clear, one Philox call a
    group at counter (j, i, bh, salt); element (i + 8a, j + 8b) takes word
    2a + b. The CUDA kernels draw the same bits (csrc/philox.cuh)."""
    seed = seed.to(torch.int64)
    key = (seed[0] & _U32, (seed[0] >> 32) & _U32)
    counter = (cols & ~8, rows & ~8, bh, seed[1] & _U32)
    words = torch.stack(torch.broadcast_tensors(*philox4x32(counter, key)))
    word = ((rows >> 3) & 1) * 2 + ((cols >> 3) & 1)
    shape = words.shape[1:]
    bits = words.gather(0, word.expand(shape).unsqueeze(0))[0]
    return bits >= dropout_threshold(rate)


def _keep_factor(r0, r1, queries, keys, dropout_rate, seed, keep, bh_base=0):
    """The factors Z (0 or 1 / (1 - rate), f32) of rows r0:r1 at the
    query and key coordinates `queries`, `keys` (int64, broadcast after a
    leading row axis), from the seed (row bh drawing at bh_base + bh) or
    from a dense (BH, n, n) keep mask; None without dropout."""
    if not dropout_rate or (seed is None and keep is None):
        return None
    bh = torch.arange(r0, r1, device=queries.device).reshape(-1, *[1] * queries.dim())
    if keep is None:
        kept = philox_keep(seed.to(queries.device), bh + bh_base, queries[None], keys[None],
                           dropout_rate)
    else:
        kept = keep.to(queries.device)[bh, queries[None], keys[None]]
    return torch.where(kept, 1.0 / (1.0 - dropout_rate), 0.0)


def _fwd_coords(table: BlockTable):
    """(queries, keys) of the gathered (B, bs, A, bs) layout: query block
    r's row i, slot a's key j (block 0 in the padding)."""
    B, bs = table.n_blocks, table.block_size
    ar = torch.arange(bs, device=table.idx.device)
    queries = (torch.arange(B, device=ar.device)[:, None] * bs + ar)[:, :, None, None]
    keys = (table.idx.long().clamp(min=0)[:, :, None] * bs + ar)[:, None]
    return queries, keys


# --- plain versions ------------------------------------------------------------


def _tiles(q, table: BlockTable):
    """Yield (r0, r1) over BH so no gathered tile exceeds PLAIN_TILE_ELEMS."""
    BH, n, dh = q.shape
    B, A = table.idx.shape
    bs = table.block_size
    rows = max(1, PLAIN_TILE_ELEMS // (B * A * bs * max(dh, bs)))
    for r0 in range(0, BH, rows):
        yield r0, min(BH, r0 + rows)


def _gather_blocks(t, table: BlockTable):
    """(c, B, ...) gathered along the block axis by the table: (c, B, A,
    ...), slot a of row r holding block idx[r, a] (block 0 in the padding)."""
    return t[:, table.idx.long().clamp(min=0)]


def _gather(t, r0, r1, table: BlockTable):
    """(BH, n, d) rows r0:r1 in f32, gathered by block: (c, B, A, bs, d)."""
    return _gather_blocks(t[r0:r1].float().reshape(r1 - r0, table.n_blocks,
                                                   table.block_size, -1), table)


def _key_bias(bias, heads, r0, r1, table: BlockTable):
    """The key bias of rows r0:r1, gathered by block, -inf in padded slots:
    (c, B, A, bs)."""
    rows = torch.arange(r0, r1, device=bias.device) // heads
    b = bias[rows].reshape(r1 - r0, table.n_blocks, table.block_size)
    slot_ok = (table.idx >= 0)[None, :, :, None]
    return torch.where(slot_ok, _gather_blocks(b, table), float("-inf"))


def _scores(q, k, bias, heads, r0, r1, table: BlockTable, scale):
    """s (c, B, bs, A * bs) f32 of rows r0:r1: scale q.k + bias over each
    query block's slots, -inf for masked keys and padded slots."""
    c, B, bs = r1 - r0, table.n_blocks, table.block_size
    qb = q[r0:r1].float().reshape(c, B, bs, -1)
    s = torch.einsum("cbid,cbajd->cbiaj", qb, _gather(k, r0, r1, table)) * scale
    s = s + _key_bias(bias, heads, r0, r1, table)[:, :, None]
    return s.reshape(c, B, bs, -1)


def sparse_fwd_plain(q, k, v, bias, table: BlockTable, heads: int, scale: float, *,
                     dropout_rate: float = 0.0, seed=None, keep=None, bh_base: int = 0):
    """The forward kernel's function in plain PyTorch (f32 whatever the
    input dtype), differentiable by autograd. With dropout_rate > 0 and a
    seed (or a dense (BH, n, n) bool `keep`), inverted dropout on the
    probabilities that feed P.V, row bh drawing its bits as row bh_base +
    bh (a data-parallel shard's place in the whole batch); lse is the
    undropped one's. Returns (out in q.dtype, lse f32)."""
    BH, n, dh = q.shape
    outs, lses = [], []
    queries, keys = _fwd_coords(table)
    for r0, r1 in _tiles(q, table):
        c = r1 - r0
        s = _scores(q, k, bias, heads, r0, r1, table, scale)
        m = s.amax(dim=-1)
        live = m > float("-inf")
        m = torch.where(live, m, 0.0)
        p = torch.exp(s - m[..., None])  # 0 over a row with no unmasked key
        l = p.sum(dim=-1)
        attn = p / torch.where(live, l, 1.0)[..., None]
        z = _keep_factor(r0, r1, queries, keys, dropout_rate, seed, keep, bh_base)
        if z is not None:
            attn = attn * z.reshape(attn.shape)
        vg = _gather(v, r0, r1, table).reshape(c, table.n_blocks, -1, dh)
        outs.append(torch.einsum("cbij,cbjd->cbid", attn, vg).reshape(c, n, dh))
        lses.append(torch.where(live, m + torch.log(l), float("inf")).reshape(c, n))
    return torch.cat(outs).to(q.dtype), torch.cat(lses)


def sparse_bwd_dq_plain(q, k, v, bias, table: BlockTable, heads: int, lse, g, delta,
                        scale: float, *, dropout_rate: float = 0.0, seed=None, keep=None,
                        bh_base: int = 0):
    """The dq kernel's function in plain PyTorch (f32): p = exp(s - lse), ds
    = p (g.v Z - delta), dq = scale ds k over each query block's slots (Z
    the forward's keep factors, with dropout). Returns dq in q.dtype."""
    BH, n, dh = q.shape
    dq = torch.empty_like(q)
    queries, keys = _fwd_coords(table)
    for r0, r1 in _tiles(q, table):
        c, B = r1 - r0, table.n_blocks
        s = _scores(q, k, bias, heads, r0, r1, table, scale)
        p = torch.exp(s - lse[r0:r1].reshape(c, B, -1, 1))
        vg = _gather(v, r0, r1, table).reshape(c, B, -1, dh)
        kg = _gather(k, r0, r1, table).reshape(c, B, -1, dh)
        dp = torch.einsum("cbid,cbjd->cbij", g[r0:r1].float().reshape(c, B, -1, dh), vg)
        z = _keep_factor(r0, r1, queries, keys, dropout_rate, seed, keep, bh_base)
        if z is not None:
            dp = dp * z.reshape(dp.shape)
        ds = p * (dp - delta[r0:r1].reshape(c, B, -1, 1))
        dq[r0:r1] = (torch.einsum("cbij,cbjd->cbid", ds, kg) * scale).reshape(c, n, dh).to(q.dtype)
    return dq


def sparse_bwd_dkv_plain(q, k, v, bias, table: BlockTable, heads: int, lse, g, delta,
                         scale: float, *, dropout_rate: float = 0.0, seed=None, keep=None,
                         bh_base: int = 0):
    """The dkv kernel's function in plain PyTorch (f32), as the kernel reads
    the table: key block c gathers the query blocks of its own row (the
    layout is symmetric); dk = scale ds^T q, dv = (p Z)^T g with ds = p (dp
    Z - delta) (Z the forward's keep factors, with dropout, drawn here at
    the transposed layout's coordinates). Returns (dk, dv) in the input
    dtype."""
    BH, n, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # the transposed layout (B, bs keys, A, bs queries): a block's own rows
    # are its keys, its slots' rows the queries
    keys, queries = _fwd_coords(table)
    for r0, r1 in _tiles(q, table):
        c, B, bs = r1 - r0, table.n_blocks, table.block_size
        qg, gg = _gather(q, r0, r1, table), _gather(g, r0, r1, table)  # (c, B, A, bs, dh)
        slot_ok = (table.idx >= 0)[None, :, :, None]
        lse_g = torch.where(slot_ok, _gather_blocks(lse[r0:r1].reshape(c, B, bs), table),
                            float("inf"))
        delta_g = _gather_blocks(delta[r0:r1].reshape(c, B, bs), table)
        kb = k[r0:r1].float().reshape(c, B, bs, dh)
        vb = v[r0:r1].float().reshape(c, B, bs, dh)
        rows = torch.arange(r0, r1, device=bias.device) // heads
        key_bias = bias[rows].reshape(c, B, bs)
        s = torch.einsum("cbjd,cbaid->cbjai", kb, qg) * scale + key_bias[..., None, None]
        p = torch.exp(s - lse_g[:, :, None])
        dp = torch.einsum("cbjd,cbaid->cbjai", vb, gg)
        z = _keep_factor(r0, r1, queries, keys, dropout_rate, seed, keep, bh_base)
        pz = p if z is None else p * z
        dp = dp if z is None else dp * z
        ds = p * (dp - delta_g[:, :, None])
        dv[r0:r1] = torch.einsum("cbjai,cbaid->cbjd", pz, gg).reshape(c, n, dh).to(v.dtype)
        dk[r0:r1] = (torch.einsum("cbjai,cbaid->cbjd", ds, qg) * scale).reshape(c, n, dh) \
            .to(k.dtype)
    return dk, dv


def sparse_bwd_plain(q, k, v, bias, table: BlockTable, heads: int, out, lse, g,
                     scale: float, **dropout):
    """Both backward kernels' function in plain PyTorch, with the
    forward's dropout (`dropout_rate` and `seed` or `keep`). Returns (dq,
    dk, dv)."""
    delta = flash_kernel.cotangent_terms(out, g)[1]  # rowsum(g * out) in f32
    args = (q, k, v, bias, table, heads, lse, g, delta, scale)
    return (sparse_bwd_dq_plain(*args, **dropout),) + sparse_bwd_dkv_plain(*args, **dropout)


# --- the CUDA binding ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("sparse_attn")
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    # the seed, the threshold, 1 / (1 - rate), the first row's bh for the bits
    drop = [p, ctypes.c_uint32, f32, ctypes.c_uint32]
    shape = [i64, i64, i64, i64, i32, i32, f32, i32, p] + drop
    lib.af2_sparse_fwd.argtypes = [p] * 8 + shape
    lib.af2_sparse_bwd_dq.argtypes = [p] * 10 + shape
    lib.af2_sparse_bwd_dkv.argtypes = [p] * 11 + shape
    lib.af2_sparse_fwd_wgmma.argtypes = [p] * 10 + [i64] * 3 + [f32, p] + drop
    lib.af2_sparse_bwd_dq_wgmma.argtypes = [p] * 10 + [i64] * 3 + [f32, p] + drop
    lib.af2_sparse_bwd_dkv_wgmma.argtypes = [p] * 11 + [i64] * 3 + [f32, p] + drop
    for fn in (lib.af2_sparse_fwd, lib.af2_sparse_bwd_dq, lib.af2_sparse_bwd_dkv,
               lib.af2_sparse_fwd_wgmma, lib.af2_sparse_bwd_dq_wgmma,
               lib.af2_sparse_bwd_dkv_wgmma):
        fn.restype = i32
    return lib


def route(q, table: BlockTable) -> str:
    """Which forward kernel a call on these arguments runs: "f32" for
    float32; for bfloat16 "wgmma" at dh 64 and block size 16 (any n
    `unsupported` accepts), "mma_sync" otherwise."""
    if q.dtype == torch.float32:
        return "f32"
    if q.shape[-1] == WGMMA_DH and table.block_size == WGMMA_BLOCK:
        return "wgmma"
    return "mma_sync"


def bwd_route(q, table: BlockTable) -> str:
    """Which backward kernels (B5 dq and B5 dkv) a call on these arguments
    runs, by the forward's rule (`route`): "wgmma" for bfloat16 at dh 64 and
    block size 16, "mma_sync" for the other bfloat16 calls, "f32" for
    float32."""
    return route(q, table)


def unsupported(BH: int, n: int, dh: int, dtype, block_size: int):
    """What the CUDA kernels do not take, or None."""
    if dtype not in (torch.float32, torch.bfloat16):
        return f"dtype {dtype} (float32 or bfloat16)"
    if block_size not in SUPPORTED_BLOCK_SIZES:
        return f"block_size={block_size} (built for {SUPPORTED_BLOCK_SIZES})"
    if dh not in SUPPORTED_DH:
        return f"dim_head={dh} (built for {SUPPORTED_DH})"
    if n % block_size or n == 0 or BH == 0:
        return f"n={n}, BH={BH} (a positive multiple of the block size {block_size})"
    if BH * (n // block_size) > 2 ** 31 - 1:
        return f"BH={BH}, n={n} (past the kernel grid)"
    return None


def _check(q, k, v, bias, table: BlockTable, heads: int, *more):
    if dispatch.on_cpu("sparse attention", q, k, v, bias, table.idx, *(t for _, t in more)):
        raise ValueError("the sparse kernels take CUDA tensors; the plain versions "
                         "(sparse_fwd_plain, sparse_bwd_plain) take CPU ones")
    BH, n, dh = q.shape
    reason = unsupported(BH, n, dh, q.dtype, table.block_size)
    if reason is not None:
        raise ValueError(f"the H100 sparse kernels do not support {reason}")
    for name, t in (("k", k), ("v", v)) + more:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q {tuple(q.shape)} {q.dtype}")
    if BH % heads or bias.dtype != torch.float32 or tuple(bias.shape) != (BH // heads, n):
        raise ValueError(f"bias must be float32 ({BH // heads}, {n}), got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if table.idx.dtype != torch.int32 or table.counts.dtype != torch.int32 \
            or table.n_blocks * table.block_size != n:
        raise ValueError(f"block table of {table.n_blocks} blocks of {table.block_size} "
                         f"does not cover n={n}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias), ("idx", table.idx),
                    ("counts", table.counts)) + more:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start 16-byte aligned")


def check_dropout(dropout_rate: float, seed, device) -> bool:
    """Whether a call drops: a rate in (0, 1) with a seed, two int64 on
    `device` (a rate of 0 or no seed: no dropout)."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout rate {dropout_rate} outside [0, 1)")
    if not dropout_rate or seed is None:
        return False
    if seed.dtype != torch.int64 or tuple(seed.shape) != (2,) or seed.device != device \
            or not seed.is_contiguous():
        raise ValueError(f"the dropout seed must be a contiguous int64 (2,) on {device}, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    return True


def _drop_args(dropout_rate: float, seed, device, bh_base: int = 0):
    """The entry points' last four arguments: the seed's pointer (None:
    no dropout), the threshold, 1 / (1 - rate) and the bh at which row 0
    draws its bits."""
    if not check_dropout(dropout_rate, seed, device):
        return (None, 0, 1.0, 0)
    if not 0 <= bh_base < 2 ** 32:
        raise ValueError(f"bh_base {bh_base} outside [0, 2^32)")
    return (seed.data_ptr(), dropout_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate),
            int(bh_base))


def _shape_args(q, table: BlockTable, heads, scale, drop):
    BH, n, dh = q.shape
    return (BH, heads, table.n_blocks, table.idx.shape[1], table.block_size, dh,
            float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream) + drop


def _wgmma_tail(q, table: BlockTable, heads, scale, drop):
    return (q.shape[0], heads, table.n_blocks, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream) + drop


def _count(kernel: str, which: str, drop) -> None:
    LAUNCHES[kernel] += 1
    LAUNCHES[f"{kernel}_{which}"] += 1
    if drop[0] is not None:
        LAUNCHES[f"{kernel}_dropout"] += 1


def _pick(kind: str, best: str, which, q, table: BlockTable, lists: tuple) -> str:
    """The route a `kind` kernel runs: `best`, or the route `which` names
    (measurements compare two routes on one call), refused where the call
    cannot take it: the other dtype's, wgmma off its shape, or wgmma on a
    table without its stage lists `lists`."""
    which = which or best
    if which not in ROUTES or (which == "f32") != (best == "f32") or (
            which == "wgmma" and best != which):
        raise ValueError(f"no {which!r} sparse {kind} route for {q.dtype}, dh {q.shape[-1]}, "
                         f"block size {table.block_size} (routes {ROUTES})")
    if which == "wgmma" and not lists:
        raise ValueError(f"the {kind} wgmma route reads the stage lists of a table from "
                         "block_table")
    return which


def sparse_fwd(q, k, v, bias, table: BlockTable, heads: int, scale: float, which=None, *,
               dropout_rate: float = 0.0, seed=None, bh_base: int = 0):
    """B5f on the kernel `route` picks, or on the route `which` names
    (measurements compare two routes on one call; a route the call cannot
    take is refused), counted under LAUNCHES["sparse_fwd"] and
    LAUNCHES["sparse_fwd_<route>"]; with dropout_rate > 0 and a seed (two
    int64 on q's device) the route's dropout kernel, counted again under
    LAUNCHES["sparse_fwd_dropout"]; row bh draws its bits as bh_base + bh.
    Returns (out, lse)."""
    which = _pick("forward", route(q, table), which, q, table, table.unions)
    _check(q, k, v, bias, table, heads)
    drop = _drop_args(dropout_rate, seed, q.device, bh_base)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if which == "wgmma":
        rc = _lib().af2_sparse_fwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            *(t.data_ptr() for t in table.unions), out.data_ptr(), lse.data_ptr(),
            *_wgmma_tail(q, table, heads, scale, drop))
    else:
        rc = _lib().af2_sparse_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), table.idx.data_ptr(),
            table.counts.data_ptr(), out.data_ptr(), lse.data_ptr(),
            *_shape_args(q, table, heads, scale, drop))
    cuda_build.check_launch(rc, f"sparse_fwd ({which} route)")
    _count("sparse_fwd", which, drop)
    return out, lse


def _bwd_ins(q, k, v, bias, table, g, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), table.idx.data_ptr(), table.counts.data_ptr())


def launch_dq(q, k, v, bias, table: BlockTable, heads: int, lse, g, delta, scale, which=None,
              *, dropout_rate: float = 0.0, seed=None, bh_base: int = 0):
    """One launch of the dq kernel on inputs `sparse_bwd` checked: on the
    route `bwd_route` picks, or the route `which` names (refused where the
    call cannot take it), with the forward's dropout (its rate and seed),
    counted under LAUNCHES["sparse_bwd_dq"], LAUNCHES["sparse_bwd_dq_<route>"]
    and, dropping, LAUNCHES["sparse_bwd_dq_dropout"]."""
    which = _pick("dq", bwd_route(q, table), which, q, table, table.unions)
    drop = _drop_args(dropout_rate, seed, q.device, bh_base)
    dq = torch.empty_like(q)
    ins = _bwd_ins(q, k, v, bias, table, g, lse, delta)
    if which == "wgmma":  # B5f's 128-row stage lists
        rc = _lib().af2_sparse_bwd_dq_wgmma(*ins[:7], *(t.data_ptr() for t in table.unions[:2]),
                                            dq.data_ptr(),
                                            *_wgmma_tail(q, table, heads, scale, drop))
    else:
        rc = _lib().af2_sparse_bwd_dq(*ins, dq.data_ptr(),
                                      *_shape_args(q, table, heads, scale, drop))
    cuda_build.check_launch(rc, f"sparse_bwd_dq ({which} route)")
    _count("sparse_bwd_dq", which, drop)
    return dq


def launch_dkv(q, k, v, bias, table: BlockTable, heads: int, lse, g, delta, scale, which=None,
               *, dropout_rate: float = 0.0, seed=None, bh_base: int = 0):
    """One launch of the dkv kernel, as `launch_dq`, counted under
    LAUNCHES["sparse_bwd_dkv"], LAUNCHES["sparse_bwd_dkv_<route>"] and,
    dropping, LAUNCHES["sparse_bwd_dkv_dropout"]. Returns (dk, dv)."""
    which = _pick("dkv", bwd_route(q, table), which, q, table, table.key_unions)
    drop = _drop_args(dropout_rate, seed, q.device, bh_base)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ins, outs = _bwd_ins(q, k, v, bias, table, g, lse, delta), (dk.data_ptr(), dv.data_ptr())
    if which == "wgmma":
        rc = _lib().af2_sparse_bwd_dkv_wgmma(*ins[:7], *(t.data_ptr() for t in table.key_unions),
                                             *outs, *_wgmma_tail(q, table, heads, scale, drop))
    else:
        rc = _lib().af2_sparse_bwd_dkv(*ins, *outs, *_shape_args(q, table, heads, scale, drop))
    cuda_build.check_launch(rc, f"sparse_bwd_dkv ({which} route)")
    _count("sparse_bwd_dkv", which, drop)
    return dk, dv


def sparse_bwd(q, k, v, bias, table: BlockTable, heads: int, out, lse, g, scale: float, *,
               dropout_rate: float = 0.0, seed=None, bh_base: int = 0):
    """B5 dq and B5 dkv: the backward of `sparse_fwd` from its saved out and
    lse, the cotangent g and the forward's dropout (its rate and seed: the
    kernels redraw its mask). Returns (dq, dk, dv) in the input dtype."""
    _check(q, k, v, bias, table, heads, ("out", out), ("g", g))
    if lse.dtype != torch.float32 or lse.shape != q.shape[:2] or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous float32 {tuple(q.shape[:2])} on {q.device}")
    delta = flash_kernel.cotangent_terms(out, g)[1]
    args = (q, k, v, bias, table, heads, lse, g, delta, scale)
    dropout = dict(dropout_rate=dropout_rate, seed=seed, bh_base=bh_base)
    return (launch_dq(*args, **dropout),) + launch_dkv(*args, **dropout)


class SparseKernelAttention(torch.autograd.Function):
    """B5 in the folded layout: forward `sparse_fwd`, backward `sparse_bwd`
    from the saved out and lse; with dropout_rate > 0 and a seed tensor,
    attention dropout, the backward reading the forward's seed (it draws
    nothing) and its bh_base. The bias is a mask: no cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, bias, table, heads, scale, dropout_rate=0.0, seed=None,
                bh_base=0):
        out, lse = sparse_fwd(q, k, v, bias, table, heads, scale, dropout_rate=dropout_rate,
                              seed=seed, bh_base=bh_base)
        ctx.save_for_backward(q, k, v, bias, out, lse, seed)
        ctx.table, ctx.heads, ctx.scale, ctx.rate = table, heads, scale, dropout_rate
        ctx.bh_base = bh_base
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse, seed = ctx.saved_tensors
        dq, dk, dv = sparse_bwd(q, k, v, bias, ctx.table, ctx.heads, out, lse, aligned(g),
                                ctx.scale, dropout_rate=ctx.rate, seed=seed,
                                bh_base=ctx.bh_base)
        return dq, dk, dv, None, None, None, None, None, None, None
