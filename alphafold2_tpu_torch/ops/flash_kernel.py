"""CUDA flash-attention kernels, their binding and plain versions.

Counterpart of alphafold2_tpu/ops/flash_kernel.py:

  * `flash_fwd` (B1f) replaces `flash_attention_tpu`'s forward: dense
    attention with a key-side additive bias (BH, j);
  * `flash_fwd_fused` (B2f) replaces `flash_attention_fused`'s forward:
    the same plus a 2-D (BH, i, j) bias tile and/or a sigmoid output gate;
  * `flash_bwd` (B1b) and `flash_bwd_fused` (B2b) replace their backwards
    (`_bwd_impl`, `_fused_bwd`): a dq kernel and a dkv kernel each;
  * `flash_fwd_lse` and `flash_bwd_lse` (B3) replace `flash_attention_lse`
    (`_flash_core_lse` and its backward `_bwd_lse`): B1's kernels, whose
    lse is an output differentiated through, so the backward launches the
    B1b pair with delta - g_lse (JAX `_bwd_impl` :372-379).

All take the folded layout q (BH, i, dh), k/v (BH, j, dh) in float32 or
bfloat16. The forwards return (out (BH, i, dh) in the input dtype, lse
(BH, i) f32); a row with no unmasked key gives zeros and lse = +inf, which
the backwards read as "every p of this row is 0". On CPU tensors each
wrapper runs its plain version (`flash_fwd_plain`, `flash_bwd_plain`), on
CUDA tensors it launches its kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu,
built at first use) or raises: bfloat16 runs on the tensor cores (f32
accumulate), float32 on the CUDA cores in f32.

The forwards, the dq kernel and the dkv kernel each take one of three
kernels by the shape of the call (`route`, `dq_route`, `dkv_route`):
"wgmma" (TMA ring, wgmma, persistent blocks) for bfloat16 at dh = 64
wherever TMA can address the operands, "mma_sync" for the other bfloat16
calls, "f32" for float32. A route is chosen, never fallen back to: a failed
build or launch on any route raises. `LAUNCHES` counts kernel launches per
wrapper (B3's under their own keys, though they are B1's kernels) and each
forward, dq and dkv launch again under its route's key,
`flash_fwd_<route>`, `flash_bwd_dq_<route>` and `flash_bwd_dkv_<route>`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from alphafold2_tpu_torch.ops import cuda_build, dispatch

# the TPU kernel's finite running-max sentinel: a -inf bias underflows to
# an exact 0 with no nan guards
_M0 = -1e30

ROUTES = ("wgmma", "mma_sync", "f32")  # the forward, dq and dkv kernels
# kernel launches since the last reset_launches(): one entry per kernel
# (each backward wrapper launches a dq and a dkv kernel), and each forward,
# dq and dkv launch again under its route's entry
LAUNCHES = {
    "flash_fwd": 0, "flash_fwd_fused": 0,
    "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "flash_bwd_fused_dq": 0, "flash_bwd_fused_dkv": 0,
    "flash_fwd_lse": 0, "flash_bwd_lse_dq": 0, "flash_bwd_lse_dkv": 0,
    **{f"flash_fwd_{r}": 0 for r in ROUTES},
    **{f"flash_bwd_dq_{r}": 0 for r in ROUTES},
    **{f"flash_bwd_dkv_{r}": 0 for r in ROUTES},
}

SUPPORTED_DH = (16, 32, 64)
WGMMA_DH = 64   # the head width of the wgmma routes (csrc/flash_*_wgmma.cuh kWDH)
_BLOCK_Q = 128  # query rows per CUDA block off the wgmma route (kBlockQ)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supported(i: int, j: int, dh: int) -> bool:
    """Shapes the H100 kernels take: a head width the kernels are
    instantiated for (16, 32 or 64: the query fragments and the f32
    accumulator live in registers) and non-empty axes. Any length is
    fine: K/V stream through shared memory in key tiles."""
    return dh in SUPPORTED_DH and i >= 1 and j >= 1


def route(q, k, v, bias, gate=None) -> str:
    """Which forward kernel a call on these arguments runs. "f32" for
    float32. For bfloat16, "wgmma" at dh = 64 where TMA can address every
    operand it loads: q, k, v (and a gate) start 16-byte aligned, which
    `_check` requires of every bfloat16 call, with 128-byte rows; a 2-D f32
    bias also needs a 16-byte aligned base and 16-byte rows (j % 4 == 0).
    The key-side bias is read by plain loads. "mma_sync" otherwise."""
    if q.dtype == torch.float32:
        return "f32"
    if q.shape[-1] != WGMMA_DH:
        return "mma_sync"
    if bias.dim() == 3 and (k.shape[1] % 4 or bias.data_ptr() % 16):
        return "mma_sync"
    return "wgmma"


def dkv_route(q, k, v, bias) -> str:
    """Which dkv kernel a backward call on these arguments runs, by the
    forward's rule (`route`): the wgmma dkv kernel loads q, k, v, dO and a
    2-D f32 bias by TMA (q, k, v and dO start 16-byte aligned, which
    `_check_bwd` requires of every bfloat16 call; a 2-D bias needs a 16-byte
    base and j % 4 == 0) and reads the key-side bias, lse and delta by plain
    loads. "wgmma" for bfloat16 at dh = 64 where TMA can address them,
    "mma_sync" for the other bfloat16 calls, "f32" for float32."""
    return route(q, k, v, bias)


def dq_route(q, k, v, bias) -> str:
    """Which dq kernel a backward call on these arguments runs, by the
    forward's rule (`route`): the wgmma dq kernel loads q, k, v, dO and a
    2-D f32 bias by TMA and stores dq and d_bias by TMA (q, k, v and dO
    start 16-byte aligned, which `_check_bwd` requires of every bfloat16
    call; a 2-D bias needs a 16-byte base and j % 4 == 0, and d_bias is
    allocated with its shape) and reads the key-side bias, lse and delta by
    plain loads. "wgmma" for bfloat16 at dh = 64 where TMA can address
    them, "mma_sync" for the other bfloat16 calls, "f32" for float32."""
    return route(q, k, v, bias)


# --- plain versions ------------------------------------------------------


def flash_fwd_plain(q, k, v, bias, scale, gate=None, *, kv_block: int = 2048,
                    tile_elems: int = 1 << 26):
    """The kernels' function in plain PyTorch, computed in f32 whatever the
    input dtype (as the kernels do), tiled along i and j so no (i, j) logit
    matrix larger than `tile_elems` elements exists at once.

    bias: (BH, j) key-side or (BH, i, j) 2-D, additive f32. gate: optional
    (BH, i, dh) pre-sigmoid logits. Returns (out in q.dtype, lse f32)."""
    BH, i, dh = q.shape
    j = k.shape[1]
    bias2d = bias.dim() == 3
    out = torch.empty_like(q)
    lse = torch.empty((BH, i), dtype=torch.float32, device=q.device)
    rows = max(1, tile_elems // (BH * min(j, kv_block)))
    for r0 in range(0, i, rows):
        r1 = min(i, r0 + rows)
        qs = q[:, r0:r1].float()
        m = torch.full((BH, r1 - r0), _M0, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((BH, r1 - r0, dh), dtype=torch.float32, device=q.device)
        for c0 in range(0, j, kv_block):
            c1 = min(j, c0 + kv_block)
            s = torch.bmm(qs, k[:, c0:c1].float().transpose(1, 2)) * scale
            s = s + (bias[:, r0:r1, c0:c1] if bias2d else bias[:, None, c0:c1])
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.bmm(p, v[:, c0:c1].float())
            m = m_new
        live = l > 0
        safe = torch.where(live, l, torch.ones_like(l))
        o = torch.where(live[..., None], acc / safe[..., None], 0.0)
        if gate is not None:
            o = o * torch.sigmoid(gate[:, r0:r1].float())
        out[:, r0:r1] = o.to(q.dtype)
        lse[:, r0:r1] = torch.where(live, m + torch.log(safe), float("inf"))
    return out, lse


def cotangent_terms(out, g, gate=None):
    """What the backward kernels take besides the forward's inputs, computed
    outside them as JAX does (`_bwd_impl` :368-380, `_fused_bwd` :718-730):
    delta = rowsum(g * out) in f32 and, with a gate, d_gate = g * out *
    (1 - sigmoid(gate)) and the cotangent of the ungated attention,
    g * sigmoid(gate). delta uses the raw cotangent and the gated output:
    their product equals the ungated pair's. Returns (g_eff in g.dtype,
    delta, d_gate in gate.dtype or None)."""
    g32, out32 = g.float(), out.float()
    delta = (g32 * out32).sum(dim=-1)
    if gate is None:
        return g, delta, None
    sig = torch.sigmoid(gate.float())
    d_gate = (g32 * out32 * (1.0 - sig)).to(gate.dtype)
    return (g32 * sig).to(g.dtype), delta, d_gate


# (i, j) elements of one f32 matrix the backward plain versions hold at once
BWD_TILE_ELEMS = 1 << 26


def bwd_tiles(q, k, v, bias, lse, g, delta, scale):
    """Yield (r0, r1, qs, gs, p, ds) over query-row tiles of at most
    BWD_TILE_ELEMS (i, j) elements, all f32: p = exp(scale q.k + bias - lse)
    (lse = +inf gives an exact 0) and ds = p (g.v - delta)."""
    BH, i, _ = q.shape
    j = k.shape[1]
    bias2d = bias.dim() == 3
    kf, vf = k.float(), v.float()
    rows = max(1, BWD_TILE_ELEMS // (BH * j))
    for r0 in range(0, i, rows):
        r1 = min(i, r0 + rows)
        qs, gs = q[:, r0:r1].float(), g[:, r0:r1].float()
        s = torch.bmm(qs, kf.transpose(1, 2)) * scale
        s = s + (bias[:, r0:r1] if bias2d else bias[:, None, :])
        p = torch.exp(s - lse[:, r0:r1, None])
        ds = p * (torch.bmm(gs, vf.transpose(1, 2)) - delta[:, r0:r1, None])
        yield r0, r1, qs, gs, p, ds


def flash_bwd_dq_plain(q, k, v, bias, lse, g, delta, scale):
    """The dq kernel's function in plain PyTorch (f32): dq = scale ds k and,
    for a 2-D bias, d_bias = ds. g and delta as the kernel takes them
    (`cotangent_terms`). Returns (dq in q.dtype, d_bias f32 or None)."""
    dq = torch.empty_like(q)
    d_bias = (torch.empty(bias.shape, dtype=torch.float32, device=q.device)
              if bias.dim() == 3 else None)
    kf = k.float()
    for r0, r1, _, _, _, ds in bwd_tiles(q, k, v, bias, lse, g, delta, scale):
        if d_bias is not None:
            d_bias[:, r0:r1] = ds
        dq[:, r0:r1] = (torch.bmm(ds, kf) * scale).to(q.dtype)
    return dq, d_bias


def flash_bwd_dkv_plain(q, k, v, bias, lse, g, delta, scale):
    """The dkv kernel's function in plain PyTorch (f32): dk = scale ds^T q,
    dv = p^T g. Returns (dk, dv) in the input dtype."""
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for _, _, qs, gs, p, ds in bwd_tiles(q, k, v, bias, lse, g, delta, scale):
        dk += torch.bmm(ds.transpose(1, 2), qs)
        dv += torch.bmm(p.transpose(1, 2), gs)
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, bias, out, lse, g, scale, gate=None):
    """Both backward kernels' function in plain PyTorch: the explicit
    recompute formula in f32 (not autograd), tiled along i (`bwd_tiles`).
    From the forward's lse: p = exp(scale q.k + bias - lse), dp = g.v, ds =
    p (dp - delta); dq = scale ds k, dk = scale ds^T q, dv = p^T g, d_bias
    = ds.

    bias: (BH, j) key-side (no cotangent: masks are data) or (BH, i, j)
    2-D; gate: optional (BH, i, dh) pre-sigmoid logits. Returns (dq, dk,
    dv in the input dtype, d_bias f32 for a 2-D bias else None, d_gate in
    gate.dtype or None)."""
    g, delta, d_gate = cotangent_terms(out, g, gate)
    args = (q, k, v, bias, lse, g, delta, scale)
    dq, d_bias = flash_bwd_dq_plain(*args)
    dk, dv = flash_bwd_dkv_plain(*args)
    return dq, dk, dv, d_bias, d_gate


# --- the CUDA binding ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never cuts them to 32 bits)."""
    lib = cuda_build.library("flash_fwd")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.af2_flash_fwd.argtypes = [
        p, p, p, p, p, p, p, i64, i64, i64, i32, ctypes.c_float, i32, i32, i32, p,
    ]
    lib.af2_flash_fwd.restype = i32
    lib.af2_flash_fwd_wgmma.argtypes = [
        p, p, p, p, p, p, p, i64, i64, i64, i32, ctypes.c_float, i32, i32, p,
    ]
    lib.af2_flash_fwd_wgmma.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    """The backward library (csrc/flash_bwd.cu), signatures declared."""
    lib = cuda_build.library("flash_bwd")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for fn in (lib.af2_flash_bwd_dq, lib.af2_flash_bwd_dkv):
        fn.argtypes = [
            p, p, p, p, p, p, p, p, p, i64, i64, i64, i32, ctypes.c_float,
            i32, i32, p,
        ]
        fn.restype = i32
    for fn in (lib.af2_flash_bwd_dq_wgmma, lib.af2_flash_bwd_dkv_wgmma):
        fn.argtypes = [
            p, p, p, p, p, p, p, p, p, i64, i64, i64, i32, ctypes.c_float, i32, p,
        ]
        fn.restype = i32
    return lib


def _check(q, k, v, bias, gate, bias2d):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (BH, n, dh)")
    BH, i, dh = q.shape
    j = k.shape[1]
    if k.shape != (BH, j, dh) or v.shape != (BH, j, dh):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype")
    want = (BH, i, j) if bias2d else (BH, j)
    if bias.dtype != torch.float32 or tuple(bias.shape) != want:
        raise ValueError(f"bias must be float32 {want}, got {bias.dtype} {tuple(bias.shape)}")
    if gate is not None and (gate.shape != q.shape or gate.dtype != q.dtype):
        raise ValueError("gate must match q in shape and dtype")
    if not supported(i, j, dh):
        raise ValueError(
            f"the H100 flash kernel does not support i={i}, j={j}, dh={dh} "
            f"(head widths {SUPPORTED_DH})"
        )
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias), ("gate", gate)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        # the bf16 kernels move q, k, v and the gate in 16-byte vectors or TMA
        # boxes; the f32 bias is read in floats or (`route`) by TMA
        if (t is not None and t is not bias and q.dtype == torch.bfloat16
                and t.data_ptr() % 16):
            raise ValueError(f"{name} must start 16-byte aligned for the bf16 kernel")


def _check_grid(BH, rows):
    """The grid of a kernel with a block per (bh, 128-row tile) of its owned
    rows (queries, or keys for the dkv kernel): every kernel but the wgmma
    routes', whose blocks are persistent."""
    if BH * -(-rows // _BLOCK_Q) > 2 ** 31 - 1:
        raise ValueError(f"BH={BH}, {rows} owned rows exceed the kernel grid")


def launch_fwd(q, k, v, bias, scale, gate, name, which=None):
    """One launch of a forward kernel on the current stream, counted under
    LAUNCHES[name] and LAUNCHES["flash_fwd_<route>"]: the kernel `route`
    picks, or the route `which` names (measurements compare two routes on
    one call; the C entry refuses a call its route cannot take). Returns
    (out, lse)."""
    bias2d = bias.dim() == 3
    _check(q, k, v, bias, gate, bias2d)
    which = _which(which or route(q, k, v, bias, gate), q, "")
    BH, i, dh = q.shape
    if which != "wgmma":
        _check_grid(BH, i)
    out = torch.empty_like(q)
    lse = torch.empty((BH, i), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            gate.data_ptr() if gate is not None else None, out.data_ptr(), lse.data_ptr(),
            BH, i, k.shape[1], dh, float(scale))
    flags = (int(bias2d), int(gate is not None),
             torch.cuda.current_stream(q.device).cuda_stream)
    if which == "wgmma":
        rc = _lib().af2_flash_fwd_wgmma(*args, *flags)
    else:
        rc = _lib().af2_flash_fwd(*args, int(which == "mma_sync"), *flags)
    cuda_build.check_launch(rc, f"{name} ({which} route)")
    LAUNCHES[name] += 1
    LAUNCHES[f"flash_fwd_{which}"] += 1
    return out, lse


def flash_fwd(q, k, v, bias, scale):
    """B1f: softmax(scale * q k^T + bias) v with a key-side (BH, j) bias.
    Returns (out, lse)."""
    if dispatch.on_cpu("flash attention", q, k, v, bias):
        return flash_fwd_plain(q, k, v, bias, scale)
    return launch_fwd(q, k, v, bias, scale, None, "flash_fwd")


def flash_fwd_lse(q, k, v, bias, scale):
    """B3 forward: B1f whose lse (BH, i) f32 is an output of the attention
    (+inf for a row with no unmasked key), one ring hop's partial softmax.
    The same kernel as `flash_fwd`, counted under its own key. Returns
    (out, lse)."""
    if dispatch.on_cpu("flash attention", q, k, v, bias):
        return flash_fwd_plain(q, k, v, bias, scale)
    return launch_fwd(q, k, v, bias, scale, None, "flash_fwd_lse")


def flash_fwd_fused(q, k, v, bias, scale, gate: Optional[torch.Tensor] = None):
    """B2f: B1f with a 2-D (BH, i, j) bias (masks folded in as -inf) and/or
    a (BH, i, dh) pre-sigmoid output gate applied to the f32 result before
    the one cast. At least one of the two: the plain case is `flash_fwd`.
    Returns (out, lse)."""
    if bias.dim() != 3 and gate is None:
        raise ValueError("flash_fwd_fused needs a 2-D bias or a gate; use flash_fwd")
    if dispatch.on_cpu("flash attention", q, k, v, bias, gate):
        return flash_fwd_plain(q, k, v, bias, scale, gate)
    return launch_fwd(q, k, v, bias, scale, gate, "flash_fwd_fused")


def _check_bwd(q, k, v, bias, gate, bias2d, out, lse, g):
    _check(q, k, v, bias, gate, bias2d)
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor of q's shape and dtype")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned for the bf16 kernel")
    if lse.dtype != torch.float32 or tuple(lse.shape) != tuple(q.shape[:2]) \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {tuple(q.shape[:2])}")


def _bwd_args(q, k, v, bias, lse, g, delta, scale):
    """A backward C entry's inputs, its shape and scale, and its last two
    arguments (bias2d, the stream)."""
    BH, i, dh = q.shape
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    tail = (int(bias.dim() == 3), torch.cuda.current_stream(q.device).cuda_stream)
    return ins, (BH, i, k.shape[1], dh, float(scale)), tail


def _which(which, q, kernel):
    """A route named by a measurement, checked against the dtype (the C
    entries would read float32 data as bfloat16)."""
    if which not in ROUTES or (which == "f32") != (q.dtype == torch.float32):
        raise ValueError(f"no {which!r} {kernel}route for {q.dtype} (routes {ROUTES})")
    return which


def launch_dq(q, k, v, bias, lse, g, delta, scale, name, which=None):
    """One launch of the dq kernel on the current stream, on inputs
    `flash_bwd` / `flash_bwd_fused` have checked (g and delta as
    `cotangent_terms` gives them), counted under LAUNCHES[name] and
    LAUNCHES["flash_bwd_dq_<route>"]: the kernel `dq_route` picks, or the
    route `which` names (measurements compare two routes on one call; the C
    entry refuses a call its route cannot take). Returns (dq, d_bias f32
    for a 2-D bias else None)."""
    which = _which(which or dq_route(q, k, v, bias), q, "dq ")
    if which != "wgmma":  # a block per (bh, query tile)
        _check_grid(q.shape[0], q.shape[1])
    bias2d = bias.dim() == 3
    dq = torch.empty_like(q)
    d_bias = (torch.empty(bias.shape, dtype=torch.float32, device=q.device)
              if bias2d else None)
    ins, shape, tail = _bwd_args(q, k, v, bias, lse, g, delta, scale)
    outs = (dq.data_ptr(), d_bias.data_ptr() if bias2d else None)
    if which == "wgmma":
        rc = _bwd_lib().af2_flash_bwd_dq_wgmma(*ins, *outs, *shape, *tail)
    else:
        rc = _bwd_lib().af2_flash_bwd_dq(*ins, *outs, *shape, int(which == "mma_sync"), *tail)
    cuda_build.check_launch(rc, f"{name} ({which} route)")
    LAUNCHES[name] += 1
    LAUNCHES[f"flash_bwd_dq_{which}"] += 1
    return dq, d_bias


def launch_dkv(q, k, v, bias, lse, g, delta, scale, name, which=None):
    """One launch of the dkv kernel, as `launch_dq`, counted under
    LAUNCHES[name] and LAUNCHES["flash_bwd_dkv_<route>"]: the kernel
    `dkv_route` picks, or the route `which` names (measurements compare two
    routes on one call; the C entry refuses a call its route cannot take).
    Returns (dk, dv)."""
    which = _which(which or dkv_route(q, k, v, bias), q, "dkv ")
    if which != "wgmma":  # a block per (bh, key tile)
        _check_grid(k.shape[0], k.shape[1])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ins, shape, tail = _bwd_args(q, k, v, bias, lse, g, delta, scale)
    outs = (dk.data_ptr(), dv.data_ptr())
    if which == "wgmma":
        rc = _bwd_lib().af2_flash_bwd_dkv_wgmma(*ins, *outs, *shape, *tail)
    else:
        rc = _bwd_lib().af2_flash_bwd_dkv(*ins, *outs, *shape,
                                          int(q.dtype == torch.bfloat16), *tail)
    cuda_build.check_launch(rc, f"{name} ({which} route)")
    LAUNCHES[name] += 1
    LAUNCHES[f"flash_bwd_dkv_{which}"] += 1
    return dk, dv


def flash_bwd(q, k, v, bias, out, lse, g, scale):
    """B1b: the backward of `flash_fwd` from its saved out and lse and the
    cotangent g (BH, i, dh). The key-side bias gets no cotangent (masks are
    data). Returns (dq, dk, dv) in the input dtype."""
    if dispatch.on_cpu("flash attention", q, k, v, bias, out, lse, g):
        return flash_bwd_plain(q, k, v, bias, out, lse, g, scale)[:3]
    _check_bwd(q, k, v, bias, None, False, out, lse, g)
    args = (q, k, v, bias, lse) + cotangent_terms(out, g)[:2] + (scale,)
    dq, _ = launch_dq(*args, "flash_bwd_dq")
    dk, dv = launch_dkv(*args, "flash_bwd_dkv")
    return dq, dk, dv


def flash_bwd_fused(q, k, v, bias, gate, out, lse, g, scale):
    """B2b: the backward of `flash_fwd_fused` from its saved (gated) out and
    lse. Returns (dq, dk, dv, d_bias f32 for a 2-D bias else None, d_gate
    for a gate else None)."""
    bias2d = bias.dim() == 3
    if not bias2d and gate is None:
        raise ValueError("flash_bwd_fused needs a 2-D bias or a gate; use flash_bwd")
    if dispatch.on_cpu("flash attention", q, k, v, bias, gate, out, lse, g):
        return flash_bwd_plain(q, k, v, bias, out, lse, g, scale, gate)
    _check_bwd(q, k, v, bias, gate, bias2d, out, lse, g)
    g, delta, d_gate = cotangent_terms(out, g, gate)
    args = (q, k, v, bias, lse, g, delta, scale)
    dq, d_bias = launch_dq(*args, "flash_bwd_fused_dq")
    dk, dv = launch_dkv(*args, "flash_bwd_fused_dkv")
    return dq, dk, dv, d_bias, d_gate


def lse_delta(out, g, g_lse):
    """B3's diagonal term: delta = rowsum(g * out) - g_lse in f32. The lse
    cotangent folds in here because d lse_i / d s_ij = p_ij (JAX
    `_bwd_impl` :372-379); g_lse None counts as 0."""
    delta = cotangent_terms(out, g)[1]
    return delta if g_lse is None else delta - g_lse.float()


def flash_bwd_lse_plain(q, k, v, bias, out, lse, g, g_lse, scale):
    """B3's backward in plain PyTorch: the B1b plain versions with delta -
    g_lse. Returns (dq, dk, dv) in the input dtype."""
    args = (q, k, v, bias, lse, g, lse_delta(out, g, g_lse), scale)
    return (flash_bwd_dq_plain(*args)[0],) + flash_bwd_dkv_plain(*args)


def flash_bwd_lse(q, k, v, bias, out, lse, g, g_lse, scale):
    """B3 backward: the backward of `flash_fwd_lse` through both outputs,
    from its saved out and lse, the out cotangent g (BH, i, dh) and the lse
    cotangent g_lse (BH, i) (None: 0). The B1b kernels with delta - g_lse.
    A row with lse = +inf gets exact zeros whatever g_lse holds there.
    Returns (dq, dk, dv) in the input dtype."""
    if dispatch.on_cpu("flash attention", q, k, v, bias, out, lse, g, g_lse):
        return flash_bwd_lse_plain(q, k, v, bias, out, lse, g, g_lse, scale)
    _check_bwd(q, k, v, bias, None, False, out, lse, g)
    if g_lse is not None and tuple(g_lse.shape) != tuple(lse.shape):
        raise ValueError(f"g_lse must have lse's shape {tuple(lse.shape)}")
    args = (q, k, v, bias, lse, g, lse_delta(out, g, g_lse).contiguous(), scale)
    dq, _ = launch_dq(*args, "flash_bwd_lse_dq")
    dk, dv = launch_dkv(*args, "flash_bwd_lse_dkv")
    return dq, dk, dv
