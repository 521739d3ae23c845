// Block-sparse attention kernels for Hopper (sm_90a), plain C interface.
//
// Replace the three Pallas TPU kernels of B5,
// alphafold2_tpu/ops/sparse_kernel.py:
//   * B5f  `block_sparse_attention_tpu` -> `_forward` -> `_fwd_kernel`;
//   * B5dq `_backward_pallas` -> `_dq_kernel`;
//   * B5dkv `_backward_pallas` -> `_dkv_kernel`.
//
// What they compute (the TPU kernels' contract). q, k, v (BH, n, dh) with n
// = n_blocks * bs; a key-side additive bias (b, n) f32 (0 or -inf), row bh
// reading bias row bh / heads; the block table idx (n_blocks, width) int32
// and counts (n_blocks,) int32: query block r attends the key blocks
// idx[r][0 .. counts[r]) (the valid slots come first in each row, so a row
// walks its own count and never the padded width: with a global block the
// width is n_blocks, a dense kernel's loop). The forward is a streaming
// softmax over those blocks (f32 running max with the finite sentinel
// -1e30, f32 sum and accumulator) that writes out in the input type and lse
// = m + log(l) per row (+inf, with zeros out, for a row with no unmasked
// key). The backward recomputes p = exp(scale q.k + bias - lse) (exactly 0
// where lse = +inf: no fast-math), dp = dO.v, ds = p (dp - delta) with
// delta = rowsum(dO * O) an input, and writes dq = scale sum ds k (dq
// kernel, over the query block's active key blocks) and dk = scale sum ds
// q, dv = sum p dO (dkv kernel, over the query blocks that attend the key
// block, read from the key block's own table row: the layout is symmetric
// by construction, alphafold2_tpu/ops/sparse.py:81). One writer per output
// element, no atomics. The bias is a mask: no cotangent.
//
// Attention dropout (every route; JAX's gather version at
// alphafold2_tpu/ops/sparse.py:156, which its TPU kernel leaves it to): with
// a seed, each kernel runs its `af2::Dropout<true>` instantiation
// (philox.cuh), without one the kernel as it was. The forward's P.V takes
// P Z, Z = keep / (1 - rate) from the seed and the element's (bh, query,
// key), while l and lse keep the undropped P; the backward redraws Z from
// the same coordinates: dV = (P Z)^T dO, dS = P (dP Z - delta) with delta =
// rowsum(dO * O) of the dropped output.
//
// What bounds them on an H100: 4 * BH * nnz * bs^2 * dh operations forward
// and 10 * ... backward (nnz = active (query block, key block) pairs)
// against q, k, v (and dO, dq, dk, dv) moved once. At the pair-axial shapes
// (n = 384, bs = 16, dh = 64, 56% active) that is ~0.6 operations a byte
// read: the floor is bytes. The layout makes the rows uneven: the global
// query block walks every key block (256 at n = 4096 against a mean row of
// 65), so a kernel that walks each row from start to end takes as long as
// row 0.
//
// bf16, two routes for each kernel (ops/sparse_kernel.py `route` and
// `bwd_route` pick one; no fallback):
//   * wgmma (dh 64, bs 16), the sections below: TMA-fed wgmma pipelines over
//     the stages in which some block of a tile attends, the (query block,
//     key block) pairs it does not attend masked with -inf. B5f is the
//     flash forward's (flash_fwd_wgmma.cuh, 128-key stages of 128- or
//     192-row query tiles), B5 dkv the flash backward's dkv pipeline
//     (flash_bwd_dkv_wgmma.cuh, 64-query stages of 128-key tiles), B5 dq
//     its own (flash_bwd_dq_wgmma.cuh, 128-key stages of 128-row tiles);
//   * mma_sync (the other block sizes and head widths), below.
//
// mma_sync: each product runs on the tensor cores with `mma.sync.m16n8k16`
// (bf16 in, f32 accumulate; helpers in mma_bf16.cuh). A block of 4 warps owns 64 rows of one block index: the bs
// rows of 64 / bs heads when bs <= 64 (so bs = 16 fills a 4-warp block with
// four heads that walk the same table row), or one half of a 128-row block.
// Each warp owns 16 rows and keeps its A operands and f32 accumulators in
// registers; the block streams sub-tiles (up to 64 keys, or 32 queries in
// the dkv kernel, of each of its heads, with their bias or lse and delta)
// through two shared-memory buffers with cp.async, the next step's copies in
// flight while the current step computes. Each active key block is read
// once per query block that attends it (the TPU kernel's pattern), mostly
// from L2; a row's steps run in one chain, so the longest row sets the
// time. P and dS are rounded to bf16 before their products, as the TPU
// kernels round them (sparse_kernel.py:123, :220, :259, :266), and stay in
// registers.
//
// f32: one thread per owned row on the CUDA cores in f32 FMAs (the tensor
// cores would round to TF32), 32 rows a block, 16 streamed rows of each
// head per step; it carries the f32 parity path only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_bwd_dkv_wgmma.cuh"
#include "flash_bwd_dq_wgmma.cuh"
#include "flash_fwd_wgmma.cuh"
#include "mma_bf16.cuh"
#include "philox.cuh"

namespace {

using af2::copy_async4;
using af2::cp_async_commit;
using af2::Dropout;
using af2::DropKey;
using af2::keep_factor;
using af2::cp_async_wait;
using af2::kPad;
using af2::load_a;
using af2::mma_ab;
using af2::mma_abt;
using af2::pack_bf16;
using af2::stage_async;
using af2::store_rows;

constexpr float kM0 = -1e30f;  // running-max sentinel (TPU kernel's _M0)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Where a CTA's `rows` owned rows lie: `span` = min(bs, rows) consecutive
// rows (from `first` within block `blk`) of each of `heads_per` = rows /
// span consecutive heads from bh0; a block of more than `rows` rows is
// split over bs / span CTAs.
struct Geometry {
  int64_t bh0;
  int64_t blk;
  int span;
  int heads_per;
  int first;
  __device__ Geometry(int rows, int bs, int64_t n_blocks) {
    span = bs < rows ? bs : rows;
    heads_per = rows / span;
    const int halves = bs / span;
    int64_t x = blockIdx.x;
    first = (int)(x % halves) * span;
    x /= halves;
    blk = x % n_blocks;
    bh0 = (x / n_blocks) * heads_per;
  }
};

int64_t grid_size(int64_t bh, int64_t n_blocks, int rows, int bs) {
  const int span = bs < rows ? bs : rows;
  const int heads_per = rows / span;
  return (bh + heads_per - 1) / heads_per * n_blocks * (bs / span);
}

// --- bf16: tensor cores ----------------------------------------------------

constexpr int kRows = 64;            // rows a block owns
constexpr int kWarps = kRows / 16;   // one m16 row slab per warp

// Issue the asynchronous copies of SUB rows from row `row0` of every head
// of the CTA (zeros for heads past bh_total) into tile rows hg * SUB.
template <int SUB, int DH>
__device__ __forceinline__ void stage_heads(__nv_bfloat16 (*dst)[DH + kPad],
                                            const __nv_bfloat16* src,
                                            const Geometry& geo,
                                            int64_t bh_total, int64_t n,
                                            int64_t row0) {
  for (int hg = 0; hg < geo.heads_per; ++hg) {
    const int64_t bhs = geo.bh0 + hg;
    const bool ok = bhs < bh_total;
    stage_async<SUB, DH>(dst + hg * SUB, src + ((ok ? bhs : 0) * n + row0) * DH,
                         ok ? SUB : 0);
  }
}

// Issue the copies of one f32 row vector entry a head: vec[bhs * n + row0 +
// i % SUB] (or, by_batch, vec[bhs / heads * n + ...], the key bias) into
// dst[i] for i < heads_per * SUB; zeros for heads past bh_total, which only
// their own (idle) warps read.
template <int SUB>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* vec,
                                               const Geometry& geo,
                                               int64_t bh_total, int64_t heads,
                                               bool by_batch, int64_t n,
                                               int64_t row0) {
  for (int i = threadIdx.x; i < geo.heads_per * SUB; i += blockDim.x) {
    const int64_t bhs = geo.bh0 + i / SUB;
    const bool ok = bhs < bh_total;
    const int64_t row = ok ? (by_batch ? bhs / heads : bhs) : 0;
    copy_async4(dst + i, vec + row * n + row0 + i % SUB, ok);
  }
}

template <int DH, int SUB, bool DROP>
__global__ void __launch_bounds__(kWarps * 32)
    sparse_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias,
                           const int* __restrict__ idx,
                           const int* __restrict__ counts,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int64_t bh_total,
                           int64_t heads, int64_t n_blocks, int64_t width,
                           int bs, float scale, const Dropout<DROP> drop) {
  constexpr int kSTiles = SUB / 8;
  constexpr int kOTiles = DH / 8;
  const DropKey dkey = af2::drop_key(drop);
  __shared__ __align__(16) __nv_bfloat16 ks[2][kRows][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kRows][DH + kPad];
  __shared__ __align__(16) float bsm[2][kRows];

  const Geometry geo(kRows, bs, n_blocks);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int gi = warp * 16 / geo.span;  // the warp's head in the CTA
  const int64_t bh = geo.bh0 + gi;
  const bool live = bh < bh_total;
  const int64_t n = n_blocks * bs;
  const int64_t row0 = geo.blk * bs + geo.first + warp * 16 % geo.span;
  const int64_t rows[2] = {row0 + g, row0 + g + 8};
  const bool valid[2] = {live, live};

  uint32_t qa[DH / 16][4];
  load_a<DH>(qa, q + (live ? bh : 0) * n * DH, rows, valid, t);
  float o[kOTiles][4];
#pragma unroll
  for (int c = 0; c < kOTiles; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  float m[2] = {kM0, kM0};  // running max, log2 domain
  float l[2] = {0.f, 0.f};  // this thread's share of the running sum

  // the steps: SUB-key sub-tiles of the row's active key blocks, in order;
  // step s + 1's copies fly while step s computes (two buffers)
  const int count = counts[geo.blk];
  const int* slots = idx + geo.blk * width;
  const int per_block = bs / SUB;
  const int steps = count * per_block;
  auto issue = [&](int step) {
    const int buf = step & 1;
    const int64_t key0 = (int64_t)slots[step / per_block] * bs + step % per_block * SUB;
    stage_heads<SUB, DH>(ks[buf], k, geo, bh_total, n, key0);
    stage_heads<SUB, DH>(vs[buf], v, geo, bh_total, n, key0);
    stage_rows_f32<SUB>(bsm[buf], bias, geo, bh_total, heads, true, n, key0);
    cp_async_commit();
  };
  if (steps > 0) issue(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      issue(step + 1);
    } else {
      cp_async_commit();  // an empty group: the wait below counts the same
    }
    cp_async_wait<1>();
    __syncthreads();  // step's tiles are in shared memory
    const int buf = step & 1;
    if (live) {
      float s[kSTiles][4];
      mma_abt<DH, kSTiles>(s, qa, ks[buf] + gi * SUB, g, t);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < kSTiles; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float b = bsm[buf][gi * SUB + c * 8 + 2 * t + (e & 1)];
          s[c][e] = (s[c][e] * scale + b) * kLog2e;
          mx[h] = fmaxf(mx[h], s[c][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int c = 0; c < kOTiles; ++c) {
        o[c][0] *= alpha[0];
        o[c][1] *= alpha[0];
        o[c][2] *= alpha[1];
        o[c][3] *= alpha[1];
      }
#pragma unroll
      for (int c = 0; c < kSTiles; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[c][e] = exp2f(s[c][e] - m[e >> 1]);
          l[e >> 1] += s[c][e];
        }
      }
      if (DROP) {  // P.V takes P times its keep factors; l keeps the undropped sum
        const int64_t key0 = (int64_t)slots[step / per_block] * bs + step % per_block * SUB;
        const uint64_t keep = af2::keep_bits<kSTiles, false>(dkey, bh, rows[0], key0 + 2 * t);
#pragma unroll
        for (int c = 0; c < kSTiles; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][e] *= keep_factor(dkey, keep, 4 * c + e);
        }
      }
      mma_ab<DH, SUB>(o, s, vs[buf] + gi * SUB, g, t);  // O += P V, P rounded to bf16
    }
    __syncthreads();  // every warp is done with buffer buf before its reissue
  }
  if (!live) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t qrow = bh * n + rows[h];
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int c = 0; c < kOTiles; ++c) {
      *reinterpret_cast<uint32_t*>(out + qrow * DH + c * 8 + 2 * t) =
          pack_bf16(o[c][2 * h] * inv, o[c][2 * h + 1] * inv);
    }
    if (t == 0) lse[qrow] = l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : INFINITY;
  }
}

template <int DH, int SUB, bool DROP>
__global__ void __launch_bounds__(kWarps * 32)
    sparse_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ bias,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ idx,
                          const int* __restrict__ counts,
                          __nv_bfloat16* __restrict__ dq, int64_t bh_total,
                          int64_t heads, int64_t n_blocks, int64_t width,
                          int bs, float scale, const Dropout<DROP> drop) {
  constexpr int kSTiles = SUB / 8;
  const DropKey dkey = af2::drop_key(drop);
  __shared__ __align__(16) __nv_bfloat16 ks[2][kRows][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kRows][DH + kPad];
  __shared__ __align__(16) float bsm[2][kRows];

  const Geometry geo(kRows, bs, n_blocks);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int gi = warp * 16 / geo.span;
  const int64_t bh = geo.bh0 + gi;
  const bool live = bh < bh_total;
  const int64_t n = n_blocks * bs;
  const int64_t row0 = geo.blk * bs + geo.first + warp * 16 % geo.span;
  const int64_t rows[2] = {row0 + g, row0 + g + 8};
  const bool valid[2] = {live, live};
  const int64_t bhq = live ? bh : 0;

  uint32_t qa[DH / 16][4];
  uint32_t ga[DH / 16][4];
  load_a<DH>(qa, q + bhq * n * DH, rows, valid, t);
  load_a<DH>(ga, dout + bhq * n * DH, rows, valid, t);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_lse[h] = live ? lse[bhq * n + rows[h]] : INFINITY;
    row_delta[h] = live ? delta[bhq * n + rows[h]] : 0.f;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  const int count = counts[geo.blk];
  const int* slots = idx + geo.blk * width;
  const int per_block = bs / SUB;
  const int steps = count * per_block;
  auto issue = [&](int step) {
    const int buf = step & 1;
    const int64_t key0 = (int64_t)slots[step / per_block] * bs + step % per_block * SUB;
    stage_heads<SUB, DH>(ks[buf], k, geo, bh_total, n, key0);
    stage_heads<SUB, DH>(vs[buf], v, geo, bh_total, n, key0);
    stage_rows_f32<SUB>(bsm[buf], bias, geo, bh_total, heads, true, n, key0);
    cp_async_commit();
  };
  if (steps > 0) issue(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      issue(step + 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    const int buf = step & 1;
    if (live) {
      float s[kSTiles][4];
      float ds[kSTiles][4];
      mma_abt<DH, kSTiles>(s, qa, ks[buf] + gi * SUB, g, t);
      mma_abt<DH, kSTiles>(ds, ga, vs[buf] + gi * SUB, g, t);  // dP = dO V^T
      uint64_t keep = 0;
      if (DROP) {
        const int64_t key0 = (int64_t)slots[step / per_block] * bs + step % per_block * SUB;
        keep = af2::keep_bits<kSTiles, false>(dkey, bh, rows[0], key0 + 2 * t);
      }
#pragma unroll
      for (int c = 0; c < kSTiles; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float b = bsm[buf][gi * SUB + c * 8 + 2 * t + (e & 1)];
          const float p = expf(s[c][e] * scale + b - row_lse[h]);
          const float dp = DROP ? ds[c][e] * keep_factor(dkey, keep, 4 * c + e) : ds[c][e];
          ds[c][e] = p * (dp - row_delta[h]);
        }
      }
      mma_ab<DH, SUB>(acc, ds, ks[buf] + gi * SUB, g, t);  // dQ += dS K
    }
    __syncthreads();
  }
  if (!live) return;
  store_rows<DH>(dq + bh * n * DH, acc, rows, valid, t, scale);
}

template <int DH, int SUB, bool DROP>
__global__ void __launch_bounds__(kWarps * 32)
    sparse_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ idx,
                           const int* __restrict__ counts,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int64_t bh_total,
                           int64_t heads, int64_t n_blocks, int64_t width,
                           int bs, float scale, const Dropout<DROP> drop) {
  constexpr int kSTiles = SUB / 8;
  const DropKey dkey = af2::drop_key(drop);
  __shared__ __align__(16) __nv_bfloat16 qs[2][kRows][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 gs[2][kRows][DH + kPad];
  __shared__ __align__(16) float ls[2][kRows];
  __shared__ __align__(16) float dls[2][kRows];

  // the CTA owns KEY rows of block geo.blk; by the layout's symmetry its
  // table row lists exactly the query blocks that attend it
  const Geometry geo(kRows, bs, n_blocks);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int gi = warp * 16 / geo.span;
  const int64_t bh = geo.bh0 + gi;
  const bool live = bh < bh_total;
  const int64_t n = n_blocks * bs;
  const int64_t key0 = geo.blk * bs + geo.first + warp * 16 % geo.span;
  const int64_t keys[2] = {key0 + g, key0 + g + 8};
  const bool valid[2] = {live, live};
  const int64_t bhk = live ? bh : 0;

  uint32_t ka[DH / 16][4];
  uint32_t va[DH / 16][4];
  load_a<DH>(ka, k + bhk * n * DH, keys, valid, t);
  load_a<DH>(va, v + bhk * n * DH, keys, valid, t);
  float key_bias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key_bias[h] = live ? bias[bhk / heads * n + keys[h]] : -INFINITY;
  }
  float dk_acc[DH / 8][4];
  float dv_acc[DH / 8][4];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;
  }

  const int count = counts[geo.blk];
  const int* slots = idx + geo.blk * width;
  const int per_block = bs / SUB;
  const int steps = count * per_block;
  auto issue = [&](int step) {
    const int buf = step & 1;
    const int64_t q0 = (int64_t)slots[step / per_block] * bs + step % per_block * SUB;
    stage_heads<SUB, DH>(qs[buf], q, geo, bh_total, n, q0);
    stage_heads<SUB, DH>(gs[buf], dout, geo, bh_total, n, q0);
    stage_rows_f32<SUB>(ls[buf], lse, geo, bh_total, heads, false, n, q0);
    stage_rows_f32<SUB>(dls[buf], delta, geo, bh_total, heads, false, n, q0);
    cp_async_commit();
  };
  if (steps > 0) issue(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      issue(step + 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    const int buf = step & 1;
    if (live) {
      // transposed tiles: rows are this warp's keys, columns the queries
      float p[kSTiles][4];
      float ds[kSTiles][4];
      mma_abt<DH, kSTiles>(p, ka, qs[buf] + gi * SUB, g, t);   // S^T = K Q^T
      mma_abt<DH, kSTiles>(ds, va, gs[buf] + gi * SUB, g, t);  // dP^T = V dO^T
      uint64_t keep = 0;
      if (DROP) {
        const int64_t q0 = (int64_t)slots[step / per_block] * bs + step % per_block * SUB;
        keep = af2::keep_bits<kSTiles, true>(dkey, bh, keys[0], q0 + 2 * t);
      }
#pragma unroll
      for (int c = 0; c < kSTiles; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int col = gi * SUB + c * 8 + 2 * t + (e & 1);
          const float pe = expf(p[c][e] * scale + key_bias[h] - ls[buf][col]);
          const float z = DROP ? keep_factor(dkey, keep, 4 * c + e) : 1.f;
          ds[c][e] = pe * ((DROP ? ds[c][e] * z : ds[c][e]) - dls[buf][col]);
          p[c][e] = DROP ? pe * z : pe;  // dV takes P^T times the keep factors
        }
      }
      mma_ab<DH, SUB>(dv_acc, p, gs[buf] + gi * SUB, g, t);   // dV += P^T dO
      mma_ab<DH, SUB>(dk_acc, ds, qs[buf] + gi * SUB, g, t);  // dK += dS^T Q
    }
    __syncthreads();
  }
  if (!live) return;
  store_rows<DH>(dk + bh * n * DH, dk_acc, keys, valid, t, scale);
  store_rows<DH>(dv + bh * n * DH, dv_acc, keys, valid, t, 1.f);
}

// --- bf16, dh 64, bs 16: the wgmma route -------------------------------------
//
// flash_fwd_wgmma.cuh's pipeline with a stage list: persistent blocks walk
// (bh, query tile) tiles of 64 rows a consumer warpgroup; the producer warp
// streams, by TMA, only the 128-key stages the table's `union` list names
// for the tile (those in which some query block of the tile has an active
// key block), and each warpgroup masks the (query block, key block) pairs
// its 4 query blocks do not attend with -inf in the key bias, from its
// 32-bit mask of the list entry. It computes the whole tile x stage
// product: 1.78x the layout's exact work at the served layout (L = 384),
// 1.52x at the trained one (crop 256), 3.95x at n = 4096 and 7.62x at
// n = 8192.

constexpr int kLBs = 16;  // the route's block size
using af2::StageList;
using af2::fwd::WgmmaTile;

template <int CONSUMERS, bool DROP>
__global__ void __launch_bounds__(WgmmaTile<false, CONSUMERS>::kThreads, 1)
    sparse_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_bias,  // unread
                            const float* __restrict__ key_bias, const __nv_bfloat16* gate,
                            const StageList list, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int len_i, int len_j, int n_qtiles,
                            int64_t tiles, float scale_log2, const Dropout<DROP> drop) {
  af2::fwd::wgmma_fwd<false, false, CONSUMERS, true>(tm_q, tm_k, tm_v, tm_bias, key_bias, gate,
                                                     list, out, lse, len_i, len_j, n_qtiles,
                                                     tiles, scale_log2, drop);
}

// --- bf16, dh 64, bs 16: the backward's wgmma routes -------------------------
//
// Each walks the union of its tile's stages, as B5f's route does, the
// unattended (query block, key block) pairs masked with -inf before the exp2
// (so their p and dS are exact zeros):
//  - dkv: flash_bwd_dkv_wgmma.cuh's pipeline (shared with flash_bwd.cu's
//    dense dkv kernel) over the 64-query stages in which some key block of a
//    128-key tile is attended (the table's `key_unions`: `union_list` of the
//    symmetric layout at 128-key tiles and 64-query stages, a 16-bit mask a
//    warpgroup);
//  - dq: flash_bwd_dq_wgmma.cuh's pipeline over B5f's stage lists at
//    128-row tiles (128-key stages, a 32-bit mask a warpgroup), each stage
//    taken as two 64-key halves.
// At every path shape each tile attends every stage, so both do the dense
// product under a mask: 1.78x the layout's exact work at the served layout
// (L = 384), 1.52x at the trained one (crop 256), 3.95x at n = 4096.

using af2::dkv::DkvTile;
using af2::dq::DqTile;

template <bool DROP>
__global__ void __launch_bounds__(DkvTile<false>::kThreads, 1)
    sparse_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_g,
                            const __grid_constant__ CUtensorMap tm_bias,  // unread
                            const __grid_constant__ CUtensorMap tm_dk,
                            const __grid_constant__ CUtensorMap tm_dv,
                            const float* __restrict__ key_bias, const float* __restrict__ lse,
                            const float* __restrict__ delta, const StageList list, int len_i,
                            int len_j, int n_ktiles, int64_t tiles, float scale,
                            float scale_log2, const Dropout<DROP> drop) {
  af2::dkv::wgmma_dkv<false, true>(tm_q, tm_k, tm_v, tm_g, tm_bias, tm_dk, tm_dv, key_bias, lse,
                                   delta, list, len_i, len_j, n_ktiles, tiles, scale, scale_log2,
                                   drop);
}

template <bool DROP>
__global__ void __launch_bounds__(DqTile<false>::kThreads, 1)
    sparse_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_g,
                           const __grid_constant__ CUtensorMap tm_bias,   // unread
                           const __grid_constant__ CUtensorMap tm_dbias,  // unread
                           const __grid_constant__ CUtensorMap tm_dq,
                           const float* __restrict__ key_bias, const float* __restrict__ lse,
                           const float* __restrict__ delta, const StageList list, int len_i,
                           int len_j, int n_qtiles, int64_t tiles, float scale,
                           float scale_log2, const Dropout<DROP> drop) {
  af2::dq::wgmma_dq<false, true>(tm_q, tm_k, tm_v, tm_g, tm_bias, tm_dbias, tm_dq, key_bias, lse,
                                 delta, list, len_i, len_j, n_qtiles, tiles, scale, scale_log2,
                                 drop);
}

// --- f32: CUDA cores -------------------------------------------------------

constexpr int kRowsF32 = 32;  // threads = owned rows per block
constexpr int kSubF32 = 16;   // streamed rows of each head per step

// Stage kSubF32 rows from row `row0` of every head of the CTA into rows
// hg * kSubF32 of dst (zeros for heads past bh_total).
template <int DH, int S>
__device__ __forceinline__ void stage_heads_f32(float (*dst)[S], const float* src,
                                                const Geometry& geo,
                                                int64_t bh_total, int64_t n,
                                                int64_t row0) {
  for (int i = threadIdx.x; i < geo.heads_per * kSubF32 * DH; i += blockDim.x) {
    const int hg = i / (kSubF32 * DH);
    const int rem = i % (kSubF32 * DH);
    const int64_t bhs = geo.bh0 + hg;
    dst[hg * kSubF32 + rem / DH][rem % DH] =
        bhs < bh_total ? src[(bhs * n + row0) * DH + rem] : 0.f;
  }
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kRowsF32)
    sparse_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const int* __restrict__ idx, const int* __restrict__ counts,
                          float* __restrict__ out, float* __restrict__ lse,
                          int64_t bh_total, int64_t heads, int64_t n_blocks,
                          int64_t width, int bs, float scale, const Dropout<DROP> drop) {
  const DropKey dkey = af2::drop_key(drop);
  __shared__ float ks[kRowsF32][DH];
  __shared__ float vs[kRowsF32][DH];
  __shared__ float bsm[kRowsF32];

  const Geometry geo(kRowsF32, bs, n_blocks);
  const int tid = threadIdx.x;
  const int gi = tid / geo.span;
  const int64_t bh = geo.bh0 + gi;
  const bool live = bh < bh_total;
  const int64_t n = n_blocks * bs;
  const int64_t qi = geo.blk * bs + geo.first + tid % geo.span;  // the query
  const int64_t qrow = bh * n + qi;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = live ? q[qrow * DH + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kM0;
  float l = 0.f;

  const int count = counts[geo.blk];
  const int* slots = idx + geo.blk * width;
  for (int a = 0; a < count; ++a) {
    const int64_t kb = slots[a];
    for (int c0 = 0; c0 < bs; c0 += kSubF32) {
      __syncthreads();
      const int64_t key0 = kb * bs + c0;
      stage_heads_f32<DH, DH>(ks, k, geo, bh_total, n, key0);
      stage_heads_f32<DH, DH>(vs, v, geo, bh_total, n, key0);
      for (int i = tid; i < geo.heads_per * kSubF32; i += blockDim.x) {
        const int64_t bhs = geo.bh0 + i / kSubF32;
        bsm[i] = bhs < bh_total ? bias[bhs / heads * n + key0 + i % kSubF32] : -INFINITY;
      }
      __syncthreads();
      if (!live) continue;

      const int r0 = gi * kSubF32;
      float s[kSubF32];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kSubF32; ++c) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], ks[r0 + c][d], dot);
        s[c] = dot * scale + bsm[r0 + c];
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
      const uint32_t keep = DROP ? af2::keep_bits16<false>(dkey, bh, qi, key0) : 0u;
#pragma unroll
      for (int c = 0; c < kSubF32; ++c) {
        const float p = expf(s[c] - m_new);
        l += p;  // the undropped sum; P.V takes P times its keep factor
        const float pv = DROP ? p * keep_factor(dkey, keep, c) : p;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(pv, vs[r0 + c][d], acc[d]);
      }
      m = m_new;
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) out[qrow * DH + d] = l > 0.f ? acc[d] / l : 0.f;
  lse[qrow] = l > 0.f ? m + logf(l) : INFINITY;
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kRowsF32)
    sparse_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ idx,
                         const int* __restrict__ counts, float* __restrict__ dq,
                         int64_t bh_total, int64_t heads, int64_t n_blocks,
                         int64_t width, int bs, float scale, const Dropout<DROP> drop) {
  const DropKey dkey = af2::drop_key(drop);
  __shared__ float qo[kRowsF32][DH + 1];  // owned rows, one per thread
  __shared__ float go[kRowsF32][DH + 1];
  __shared__ float ks[kRowsF32][DH];
  __shared__ float vs[kRowsF32][DH];
  __shared__ float bsm[kRowsF32];

  const Geometry geo(kRowsF32, bs, n_blocks);
  const int tid = threadIdx.x;
  const int gi = tid / geo.span;
  const int64_t bh = geo.bh0 + gi;
  const bool live = bh < bh_total;
  const int64_t n = n_blocks * bs;
  const int64_t qi = geo.blk * bs + geo.first + tid % geo.span;  // the query
  const int64_t qrow = bh * n + qi;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qo[tid][d] = live ? q[qrow * DH + d] : 0.f;
    go[tid][d] = live ? dout[qrow * DH + d] : 0.f;
  }
  const float row_lse = live ? lse[qrow] : INFINITY;
  const float row_delta = live ? delta[qrow] : 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  const int count = counts[geo.blk];
  const int* slots = idx + geo.blk * width;
  for (int a = 0; a < count; ++a) {
    const int64_t kb = slots[a];
    for (int c0 = 0; c0 < bs; c0 += kSubF32) {
      __syncthreads();
      const int64_t key0 = kb * bs + c0;
      stage_heads_f32<DH, DH>(ks, k, geo, bh_total, n, key0);
      stage_heads_f32<DH, DH>(vs, v, geo, bh_total, n, key0);
      for (int i = tid; i < geo.heads_per * kSubF32; i += blockDim.x) {
        const int64_t bhs = geo.bh0 + i / kSubF32;
        bsm[i] = bhs < bh_total ? bias[bhs / heads * n + key0 + i % kSubF32] : -INFINITY;
      }
      __syncthreads();
      if (!live) continue;
      const int r0 = gi * kSubF32;
      const uint32_t keep = DROP ? af2::keep_bits16<false>(dkey, bh, qi, key0) : 0u;
      for (int c = 0; c < kSubF32; ++c) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          s = fmaf(qo[tid][d], ks[r0 + c][d], s);
          dp = fmaf(go[tid][d], vs[r0 + c][d], dp);
        }
        const float p = expf(s * scale + bsm[r0 + c] - row_lse);
        if (DROP) dp *= keep_factor(dkey, keep, c);
        const float ds = p * (dp - row_delta);
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, ks[r0 + c][d], acc[d]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) dq[qrow * DH + d] = acc[d] * scale;
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kRowsF32)
    sparse_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, const int* __restrict__ idx,
                          const int* __restrict__ counts, float* __restrict__ dk,
                          float* __restrict__ dv, int64_t bh_total, int64_t heads,
                          int64_t n_blocks, int64_t width, int bs, float scale,
                          const Dropout<DROP> drop) {
  const DropKey dkey = af2::drop_key(drop);
  __shared__ float ko[kRowsF32][DH + 1];  // owned key rows, one per thread
  __shared__ float vo[kRowsF32][DH + 1];
  __shared__ float qs[kRowsF32][DH];
  __shared__ float gs[kRowsF32][DH];
  __shared__ float ls[kRowsF32];
  __shared__ float dls[kRowsF32];

  const Geometry geo(kRowsF32, bs, n_blocks);
  const int tid = threadIdx.x;
  const int gi = tid / geo.span;
  const int64_t bh = geo.bh0 + gi;
  const bool live = bh < bh_total;
  const int64_t n = n_blocks * bs;
  const int64_t key = geo.blk * bs + geo.first + tid % geo.span;
  const int64_t krow = bh * n + key;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    ko[tid][d] = live ? k[krow * DH + d] : 0.f;
    vo[tid][d] = live ? v[krow * DH + d] : 0.f;
  }
  const float key_bias = live ? bias[bh / heads * n + key] : -INFINITY;
  float dk_acc[DH];
  float dv_acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) dk_acc[d] = dv_acc[d] = 0.f;

  const int count = counts[geo.blk];
  const int* slots = idx + geo.blk * width;
  for (int a = 0; a < count; ++a) {
    const int64_t qb = slots[a];
    for (int c0 = 0; c0 < bs; c0 += kSubF32) {
      __syncthreads();
      const int64_t q0 = qb * bs + c0;
      stage_heads_f32<DH, DH>(qs, q, geo, bh_total, n, q0);
      stage_heads_f32<DH, DH>(gs, dout, geo, bh_total, n, q0);
      for (int i = tid; i < geo.heads_per * kSubF32; i += blockDim.x) {
        const int64_t bhs = geo.bh0 + i / kSubF32;
        const bool ok = bhs < bh_total;
        ls[i] = ok ? lse[bhs * n + q0 + i % kSubF32] : INFINITY;
        dls[i] = ok ? delta[bhs * n + q0 + i % kSubF32] : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      const int r0 = gi * kSubF32;
      const uint32_t keep = DROP ? af2::keep_bits16<true>(dkey, bh, key, q0) : 0u;
      for (int c = 0; c < kSubF32; ++c) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          s = fmaf(ko[tid][d], qs[r0 + c][d], s);
          dp = fmaf(vo[tid][d], gs[r0 + c][d], dp);
        }
        const float p = expf(s * scale + key_bias - ls[r0 + c]);
        const float z = DROP ? keep_factor(dkey, keep, c) : 1.f;
        const float ds = p * ((DROP ? dp * z : dp) - dls[r0 + c]);
        const float pz = DROP ? p * z : p;  // dV takes P^T times the keep factors
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          dv_acc[d] = fmaf(pz, gs[r0 + c][d], dv_acc[d]);
          dk_acc[d] = fmaf(ds, qs[r0 + c][d], dk_acc[d]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk[krow * DH + d] = dk_acc[d] * scale;
    dv[krow * DH + d] = dv_acc[d];
  }
}

// --- launch ----------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  const void* dout;
  const void* lse;
  const void* delta;
  const void* idx;
  const void* counts;
  void* o0;  // out, dq or dk
  void* o1;  // lse (forward) or dv
  int64_t bh, heads, n_blocks, width;
  int bs, dh;
  float scale;
  cudaStream_t stream;
  const int64_t* seed;  // attention dropout's seed on the device, or null (no dropout)
  uint32_t threshold;   // round(rate 2^32)
  float keep_scale;     // 1 / (1 - rate)
  uint32_t bh_base;     // the bh at which row 0 draws its dropout bits
};

bool check(const Args& a, int rows, dim3* grid) {
  if (a.bs != 16 && a.bs != 32 && a.bs != 64 && a.bs != 128) return false;
  if (a.dh != 16 && a.dh != 32 && a.dh != 64) return false;
  if (a.bh <= 0 || a.heads <= 0 || a.n_blocks <= 0 || a.width <= 0) return false;
  const int64_t blocks = grid_size(a.bh, a.n_blocks, rows, a.bs);
  if (blocks > 2147483647LL) return false;
  *grid = dim3((unsigned)blocks);
  return true;
}

#define AF2_BF16 const __nv_bfloat16*
#define AF2_F32 const float*
#define AF2_TAB (const int*)a.idx, (const int*)a.counts
#define AF2_SHAPE a.bh, a.heads, a.n_blocks, a.width, a.bs, a.scale, \
                  Dropout<DROP>{a.seed, a.threshold, a.keep_scale, a.bh_base}

template <int DH, bool DROP>
void fwd(const Args& a, dim3 grid, bool bf16) {
  if (!bf16) {
    sparse_fwd_f32_kernel<DH, DROP><<<grid, kRowsF32, 0, a.stream>>>(
        (AF2_F32)a.q, (AF2_F32)a.k, (AF2_F32)a.v, (AF2_F32)a.bias, AF2_TAB,
        (float*)a.o0, (float*)a.o1, AF2_SHAPE);
    return;
  }
#define AF2_FWD(SUB)                                                         \
  sparse_fwd_bf16_kernel<DH, SUB, DROP><<<grid, kWarps * 32, 0, a.stream>>>( \
      (AF2_BF16)a.q, (AF2_BF16)a.k, (AF2_BF16)a.v, (AF2_F32)a.bias, AF2_TAB,  \
      (__nv_bfloat16*)a.o0, (float*)a.o1, AF2_SHAPE)
  if (a.bs == 16) AF2_FWD(16);
  else if (a.bs == 32) AF2_FWD(32);
  else AF2_FWD(64);
#undef AF2_FWD
}

template <int DH, bool DROP>
void dq(const Args& a, dim3 grid, bool bf16) {
  if (!bf16) {
    sparse_dq_f32_kernel<DH, DROP><<<grid, kRowsF32, 0, a.stream>>>(
        (AF2_F32)a.q, (AF2_F32)a.k, (AF2_F32)a.v, (AF2_F32)a.bias, (AF2_F32)a.dout,
        (AF2_F32)a.lse, (AF2_F32)a.delta, AF2_TAB, (float*)a.o0, AF2_SHAPE);
    return;
  }
#define AF2_DQ(SUB)                                                             \
  sparse_dq_bf16_kernel<DH, SUB, DROP><<<grid, kWarps * 32, 0, a.stream>>>(     \
      (AF2_BF16)a.q, (AF2_BF16)a.k, (AF2_BF16)a.v, (AF2_F32)a.bias,             \
      (AF2_BF16)a.dout, (AF2_F32)a.lse, (AF2_F32)a.delta, AF2_TAB,              \
      (__nv_bfloat16*)a.o0, AF2_SHAPE)
  if (a.bs == 16) AF2_DQ(16);
  else if (a.bs == 32) AF2_DQ(32);
  else AF2_DQ(64);
#undef AF2_DQ
}

template <int DH, bool DROP>
void dkv(const Args& a, dim3 grid, bool bf16) {
  if (!bf16) {
    sparse_dkv_f32_kernel<DH, DROP><<<grid, kRowsF32, 0, a.stream>>>(
        (AF2_F32)a.q, (AF2_F32)a.k, (AF2_F32)a.v, (AF2_F32)a.bias, (AF2_F32)a.dout,
        (AF2_F32)a.lse, (AF2_F32)a.delta, AF2_TAB, (float*)a.o0, (float*)a.o1,
        AF2_SHAPE);
    return;
  }
  // 32 streamed queries a head at most: the p and dS tiles and both
  // accumulators stay in registers
#define AF2_DKV(SUB)                                                            \
  sparse_dkv_bf16_kernel<DH, SUB, DROP><<<grid, kWarps * 32, 0, a.stream>>>(    \
      (AF2_BF16)a.q, (AF2_BF16)a.k, (AF2_BF16)a.v, (AF2_F32)a.bias,             \
      (AF2_BF16)a.dout, (AF2_F32)a.lse, (AF2_F32)a.delta, AF2_TAB,              \
      (__nv_bfloat16*)a.o0, (__nv_bfloat16*)a.o1, AF2_SHAPE)
  if (a.bs == 16) AF2_DKV(16);
  else AF2_DKV(32);
#undef AF2_DKV
}

enum Kind { kFwd, kDq, kDkv };

template <int DH, bool DROP>
void run(Kind kind, const Args& a, dim3 grid, bool bf16) {
  if (kind == kFwd) fwd<DH, DROP>(a, grid, bf16);
  else if (kind == kDq) dq<DH, DROP>(a, grid, bf16);
  else dkv<DH, DROP>(a, grid, bf16);
}

int launch(Kind kind, const Args& a, int is_bf16) {
  dim3 grid;
  if (!check(a, is_bf16 ? kRows : kRowsF32, &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool bf16 = is_bf16 != 0;
#define AF2_KIND(DH_)                                   \
  if (a.seed != nullptr) run<DH_, true>(kind, a, grid, bf16); \
  else run<DH_, false>(kind, a, grid, bf16)
  switch (a.dh) {
    case 16: AF2_KIND(16); break;
    case 32: AF2_KIND(32); break;
    default: AF2_KIND(64); break;
  }
#undef AF2_KIND
  return (int)cudaGetLastError();
}

// One B5f launch on the wgmma route, with or without dropout
template <bool DROP>
int launch_wgmma_fwd_route(const Args& a, const StageList& list, int64_t n, int sms, bool three) {
#define AF2_ARGS a.q, a.k, a.v, a.bias, nullptr, list, a.o0, a.o1, a.bh, n, n, a.scale, sms, \
                 a.stream, Dropout<DROP>{a.seed, a.threshold, a.keep_scale, a.bh_base}
  if (three) {
    return af2::fwd::launch_wgmma_fwd<false, 3>(sparse_fwd_wgmma_kernel<3, DROP>, AF2_ARGS);
  }
  return af2::fwd::launch_wgmma_fwd<false, 2>(sparse_fwd_wgmma_kernel<2, DROP>, AF2_ARGS);
#undef AF2_ARGS
}

// The wgmma route (bf16, dh 64, bs 16): `unions` holds the table's stage
// lists at 128- and 192-row tiles (offsets, entries, offsets, entries); the
// tile size is the flash forward's rule (`wgmma_consumers`).
int launch_wgmma_route(const Args& a, const int* const (&unions)[4]) {
  const int64_t n = a.n_blocks * kLBs;
  if (a.bs != kLBs || a.dh != af2::fwd::kWDH || a.bh <= 0 || a.heads <= 0 || a.n_blocks <= 0 ||
      n > 2147483647LL || a.bh > 2147483647LL || unions[0] == nullptr ||
      unions[1] == nullptr || unions[2] == nullptr || unions[3] == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e;
  const int sms = af2::fwd::sm_count(&e);
  if (e != cudaSuccess) return (int)e;
  const bool three = af2::fwd::wgmma_consumers(a.bh, n, sms, false) == 3;
  const StageList list{unions[three ? 2 : 0], (const int4*)unions[three ? 3 : 1], a.heads};
  return a.seed != nullptr ? launch_wgmma_fwd_route<true>(a, list, n, sms, three)
                           : launch_wgmma_fwd_route<false>(a, list, n, sms, three);
}

// Whether the backward's wgmma routes take a call: bs 16, dh 64, n and BH
// in int range, the tensors TMA reads and writes 16-byte aligned, a stage list.
bool wgmma_bwd_ok(const Args& a, const void* const (&tensors)[6], const void* offsets,
                  const void* entries) {
  uintptr_t bits = 0;
  for (const void* t : tensors) bits |= (uintptr_t)t;
  return a.bs == kLBs && a.dh == af2::dq::kWDH && a.bh > 0 && a.heads > 0 && a.n_blocks > 0 &&
         a.n_blocks * kLBs <= 2147483647LL && a.bh <= 2147483647LL && bits % 16 == 0 &&
         offsets != nullptr && entries != nullptr;
}

}  // namespace

extern "C" {

// Every entry point ends with attention dropout's arguments: seed, two
// int64 on the device (null: no dropout, the kernels as they were),
// threshold = round(rate 2^32), keep_scale = 1 / (1 - rate) and bh_base,
// the bh at which row 0 draws its bits (0, or a data-parallel shard's first
// row in the whole batch).
#define AF2_DROP_ARGS const void* seed, unsigned threshold, float keep_scale, unsigned bh_base
#define AF2_DROP (const int64_t*)seed, threshold, keep_scale, bh_base

// B5f. q, k, v (BH, n, dh) in f32 or bf16, n = n_blocks * bs; bias (BH /
// heads, n) f32; idx (n_blocks, width) int32 (valid slots first); counts
// (n_blocks,) int32; out (BH, n, dh) in the input type; lse (BH, n) f32.
// bf16 pointers are 16-byte aligned. Returns the CUDA error code of the
// launch (0 = launched; cudaErrorInvalidValue for a block size or head
// width the kernels are not built for).
int af2_sparse_fwd(const void* q, const void* k, const void* v, const void* bias,
                   const void* idx, const void* counts, void* out, void* lse,
                   int64_t bh, int64_t heads, int64_t n_blocks, int64_t width,
                   int bs, int dh, float scale, int is_bf16, void* stream, AF2_DROP_ARGS) {
  const Args a{q, k, v, bias, nullptr, nullptr, nullptr, idx, counts, out, lse,
               bh, heads, n_blocks, width, bs, dh, scale, (cudaStream_t)stream, AF2_DROP};
  return launch(kFwd, a, is_bf16);
}

// B5f's wgmma route: bf16 q, k, v, out at dh 64 and bs 16, as
// af2_sparse_fwd, q, k, v 16-byte aligned; union128_off (tiles + 1) and
// union128 (entries, 4) int32 are the table's stage lists at 128-row tiles
// (ops/sparse_kernel.py `union_list`), union192_off and union192 at 192-row
// tiles. Returns the CUDA error code of the launch (cudaErrorInvalidValue
// for a call the route does not take).
int af2_sparse_fwd_wgmma(const void* q, const void* k, const void* v, const void* bias,
                         const void* union128_off, const void* union128,
                         const void* union192_off, const void* union192, void* out, void* lse,
                         int64_t bh, int64_t heads, int64_t n_blocks, float scale,
                         void* stream, AF2_DROP_ARGS) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, bias, nullptr, nullptr, nullptr, nullptr, nullptr, out, lse,
               bh, heads, n_blocks, 1, kLBs, af2::fwd::kWDH, scale, (cudaStream_t)stream,
               AF2_DROP};
  const int* const unions[4] = {(const int*)union128_off, (const int*)union128,
                                (const int*)union192_off, (const int*)union192};
  return launch_wgmma_route(a, unions);
}

// B5 dq. As B5f, plus dout (BH, n, dh) in the input type and lse, delta
// (BH, n) f32; dq (BH, n, dh) in the input type.
int af2_sparse_bwd_dq(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const void* lse,
                      const void* delta, const void* idx, const void* counts,
                      void* dq, int64_t bh, int64_t heads, int64_t n_blocks,
                      int64_t width, int bs, int dh, float scale, int is_bf16,
                      void* stream, AF2_DROP_ARGS) {
  const Args a{q, k, v, bias, dout, lse, delta, idx, counts, dq, nullptr,
               bh, heads, n_blocks, width, bs, dh, scale, (cudaStream_t)stream, AF2_DROP};
  return launch(kDq, a, is_bf16);
}

// B5 dq's wgmma route: bf16 at dh 64 and bs 16, as af2_sparse_bwd_dq, with
// q, k, v, dout, dq 16-byte aligned; union128_off (tiles + 1) and union128
// (entries, 4) int32 are B5f's stage lists at 128-row tiles. Returns the
// CUDA error code of the launch (cudaErrorInvalidValue for a call the route
// does not take).
int af2_sparse_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* bias,
                            const void* dout, const void* lse, const void* delta,
                            const void* union128_off, const void* union128, void* dq, int64_t bh,
                            int64_t heads, int64_t n_blocks, float scale, void* stream,
                            AF2_DROP_ARGS) {
  const Args a{q, k, v, bias, dout, lse, delta, nullptr, nullptr, dq, nullptr,
               bh, heads, n_blocks, 1, kLBs, af2::dq::kWDH, scale, (cudaStream_t)stream,
               AF2_DROP};
  if (!wgmma_bwd_ok(a, {q, k, v, dout, dq, dq}, union128_off, union128)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n = n_blocks * kLBs;
  const StageList list{(const int*)union128_off, (const int4*)union128, heads};
#define AF2_ARGS q, k, v, bias, dout, lse, delta, list, dq, nullptr, bh, n, n, scale, a.stream
  if (seed != nullptr) {
    return af2::dq::launch_wgmma_dq<false>(sparse_dq_wgmma_kernel<true>, AF2_ARGS,
                                           Dropout<true>{AF2_DROP});
  }
  return af2::dq::launch_wgmma_dq<false>(sparse_dq_wgmma_kernel<false>, AF2_ARGS,
                                         Dropout<false>{nullptr, 0u, 1.f, 0u});
#undef AF2_ARGS
}

// B5 dkv's wgmma route: bf16 at dh 64 and bs 16, as af2_sparse_bwd_dkv, with
// q, k, v, dout, dk, dv 16-byte aligned; keys_off (key tiles + 1) and keys
// (entries, 4) int32 are the table's stage lists at 128-key tiles and
// 64-query stages (`key_unions`). Returns as af2_sparse_bwd_dq_wgmma.
int af2_sparse_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const void* bias,
                             const void* dout, const void* lse, const void* delta,
                             const void* keys_off, const void* keys, void* dk, void* dv,
                             int64_t bh, int64_t heads, int64_t n_blocks, float scale,
                             void* stream, AF2_DROP_ARGS) {
  const Args a{q, k, v, bias, dout, lse, delta, nullptr, nullptr, dk, dv,
               bh, heads, n_blocks, 1, kLBs, af2::dkv::kWDH, scale, (cudaStream_t)stream,
               AF2_DROP};
  if (!wgmma_bwd_ok(a, {q, k, v, dout, dk, dv}, keys_off, keys)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n = n_blocks * kLBs;
  const StageList list{(const int*)keys_off, (const int4*)keys, heads};
#define AF2_ARGS q, k, v, bias, dout, lse, delta, list, dk, dv, bh, n, n, scale, a.stream
  if (seed != nullptr) {
    return af2::dkv::launch_wgmma_dkv<false>(sparse_dkv_wgmma_kernel<true>, AF2_ARGS,
                                             Dropout<true>{AF2_DROP});
  }
  return af2::dkv::launch_wgmma_dkv<false>(sparse_dkv_wgmma_kernel<false>, AF2_ARGS,
                                           Dropout<false>{nullptr, 0u, 1.f, 0u});
#undef AF2_ARGS
}

// B5 dkv. As the dq kernel; dk, dv (BH, n, dh) in the input type. The
// table must be symmetric (query block r attends key block c iff c
// attends r): the kernel reads key block c's own row.
int af2_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, const void* lse,
                       const void* delta, const void* idx, const void* counts,
                       void* dk, void* dv, int64_t bh, int64_t heads,
                       int64_t n_blocks, int64_t width, int bs, int dh,
                       float scale, int is_bf16, void* stream, AF2_DROP_ARGS) {
  const Args a{q, k, v, bias, dout, lse, delta, idx, counts, dk, dv,
               bh, heads, n_blocks, width, bs, dh, scale, (cudaStream_t)stream, AF2_DROP};
  return launch(kDkv, a, is_bf16);
}

#undef AF2_DROP_ARGS
#undef AF2_DROP

}  // extern "C"
