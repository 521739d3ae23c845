// Flash-attention backward kernels for Hopper (sm_90a), plain C interface.
//
// Replace the four backward Pallas TPU kernels of
// alphafold2_tpu/ops/flash_kernel.py:
//   * B1b  `_bwd_impl` -> `_dq_kernel` and `_dkv_kernel`: the backward of
//     dense attention with a key-side additive bias (BH, j);
//   * B2b  `_fused_bwd` -> `_make_fused_dq_kernel` and
//     `_make_fused_dkv_kernel`: the same, with an optional 2-D (BH, i, j)
//     bias whose cotangent d_bias is the unscaled dS tile.
// Each kernel is a template on <BIAS2D> (and on the head width off the
// wgmma route); the BIAS2D=false instantiations serve B1b, the gated-only
// B2b and B3's backward (delta - g_lse). The sigmoid gate needs
// no kernel: the wrapper (ops/flash_kernel.py) folds it into the cotangent
// before the launch and computes d_gate elementwise, as `_fused_bwd` does.
//
// What they compute (the TPU kernels' contract). Inputs: q (BH, i, dh),
// k/v (BH, j, dh), the bias, dO (BH, i, dh), and per query row the
// forward's lse and delta = rowsum(dO * O), both f32, both computed
// outside. Delta is an input so that the lse cotangent of B3
// (delta - g_lse, flash_kernel.py:375-379) needs no kernel change. Then
// per (query, key): s = scale * q.k + bias, p = exp(s - lse),
// dp = dO.v, ds = p * (dp - delta), and
//   dq = scale * sum_k ds k,  dk = scale * sum_q ds q,  dv = sum_q p dO,
//   d_bias = ds (BIAS2D, f32, unscaled).
// A row with no unmasked key has lse = +inf from the forward, so every p
// of it is exp(-inf) = an exact 0 (no fast-math: expf, and ex2.approx of
// -inf, keep that) and its gradients are 0, never NaN.
//
// The dq kernel owns a tile of query rows and streams every key tile; the
// dkv kernel owns a tile of key rows and streams every query tile. The
// TPU's sequential grid axis becomes that loop inside the block; each
// output element is written by exactly one block, so there are no atomics
// and the result is deterministic. Both recompute S and dP, so the pair
// does 14 * BH * i * j * dh operations against the 10 of the work's floor
// (S, dP, dQ, dK, dV once each).
//
// What bounds them on an H100: at the training shapes (pair axial,
// i = j = 128 or 256, dh = 64) the floor is bytes (q, k, v, dO read once,
// dq, dk, dv written once: ~0.5 B per operation at i = 128); at long i, j
// it is operations.
//
// Each kernel has two bf16 routes (`ops/flash_kernel.py dq_route`,
// `dkv_route`):
//
// wgmma (dh = 64, every operand TMA loads addressable: every trained and
// served shape). The dkv kernel is the TMA-fed wgmma pipeline of
// flash_bwd_dkv_wgmma.cuh (persistent blocks over (bh, 128-key tile)
// tiles, a producer warp streaming 64-query stages, two consumer
// warpgroups computing the tiles transposed, dk and dv leaving by TMA
// stores), over every stage of len_i. The dq kernel is the pipeline of
// flash_bwd_dq_wgmma.cuh (persistent blocks over (bh, 128-query tile)
// tiles, a producer warp streaming 128-key K/V stages, two consumer
// warpgroups taking a stage as two 64-key halves, dq leaving by a TMA
// store), over every stage of len_j. The block-sparse dq and dkv kernels
// run the same two pipelines over listed stages.
//
// mma_sync (either kernel at dh 16 or 32, or with a 2-D bias TMA cannot
// address): every product runs on the tensor cores with
// `mma.sync.m16n8k16` (bf16 in, f32 accumulate; helpers in mma_bf16.cuh).
// A block of 8 warps owns 128 rows, 16 per warp; the warp keeps its two A
// operands (q and dO in the dq kernel, k and v in the dkv kernel) and its
// f32 accumulators in registers, and the block stages the streamed tile's
// two operands in shared memory (rows padded by 8 elements, so fragment
// loads hit 32 distinct banks). The C fragments of S and dP are reused in
// registers as the A fragments of the next products, so P and dS never
// touch shared or device memory (but d_bias, which is an output). The tile
// helpers (load_a, stage, mma_abt, mma_ab, store_rows) live in
// mma_bf16.cuh, shared with the block-sparse kernels (sparse_attn.cu).
//
// Both bf16 routes round dS to bf16 before the dS.K and dS^T.Q products and
// P before P^T.dO, as the TPU kernels round them (flash_kernel.py:256-261,
// :291-294).
//
// f32: one thread per owned row on the CUDA cores in f32 FMAs (the tensor
// cores would round to TF32). The owned rows' two operands sit in shared
// memory with a one-float row pad (bank-conflict free per-thread rows),
// the streamed tile beside them, the accumulators in registers.
//
// mma_sync and f32: the flattened (bh, row tile) index rides gridDim.x.
// Every route: offsets are 64-bit, and the ragged last tiles of i and j are
// masked here (or zero-filled by TMA inside their own head), with no padded
// copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_bwd_dkv_wgmma.cuh"
#include "flash_bwd_dq_wgmma.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using af2::kPad;
using af2::load_a;
using af2::mma_ab;
using af2::mma_abt;
using af2::stage;
using af2::store_rows;

// --- bf16: tensor cores ----------------------------------------------------

constexpr int kRows = 128;           // rows a block owns (queries or keys)
constexpr int kWarps = kRows / 16;   // one m16 row slab per warp
constexpr int kTileK = 64;           // dq kernel: keys staged per step
constexpr int kTileQ = 32;           // dkv kernel: queries staged per step

template <int DH, bool BIAS2D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ bias,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq,
                             float* __restrict__ dbias, int64_t len_i,
                             int64_t len_j, int64_t n_tiles, float scale) {
  constexpr int kSTiles = kTileK / 8;  // n-tiles of the (16 x keys) tiles
  __shared__ __align__(16) __nv_bfloat16 ks[kTileK][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kTileK][DH + kPad];
  __shared__ float bs[kTileK];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t bh = blockIdx.x / n_tiles;
  const int64_t row0 = (blockIdx.x % n_tiles) * kRows + warp * 16;
  const bool warp_live = row0 < len_i;
  const int64_t rows[2] = {row0 + g, row0 + g + 8};
  const bool valid[2] = {rows[0] < len_i, rows[1] < len_i};

  uint32_t qa[DH / 16][4];
  uint32_t ga[DH / 16][4];
  load_a<DH>(qa, q + bh * len_i * DH, rows, valid, t);
  load_a<DH>(ga, dout + bh * len_i * DH, rows, valid, t);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_lse[h] = valid[h] ? lse[bh * len_i + rows[h]] : INFINITY;
    row_delta[h] = valid[h] ? delta[bh * len_i + rows[h]] : 0.f;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int64_t k0 = 0; k0 < len_j; k0 += kTileK) {
    const int kn = (int)(len_j - k0 < kTileK ? len_j - k0 : kTileK);
    __syncthreads();  // every warp is done with the previous tile
    stage<kTileK, DH>(ks, k + (bh * len_j + k0) * DH, kn);
    stage<kTileK, DH>(vs, v + (bh * len_j + k0) * DH, kn);
    if (!BIAS2D) {
      for (int idx = threadIdx.x; idx < kTileK; idx += blockDim.x) {
        bs[idx] = idx < kn ? bias[bh * len_j + k0 + idx] : -INFINITY;
      }
    }
    __syncthreads();
    if (!warp_live) continue;

    float s[kSTiles][4];
    float ds[kSTiles][4];
    mma_abt<DH, kSTiles>(s, qa, ks, g, t);
    mma_abt<DH, kSTiles>(ds, ga, vs, g, t);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = n * 8 + 2 * t + (e & 1);
        float b;
        if (BIAS2D) {
          b = (col < kn && valid[h])
                  ? bias[(bh * len_i + rows[h]) * len_j + k0 + col]
                  : -INFINITY;
        } else {
          b = bs[col];
        }
        const float p = expf(s[n][e] * scale + b - row_lse[h]);
        ds[n][e] = p * (ds[n][e] - row_delta[h]);
      }
    }
    if (BIAS2D) {
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int col = n * 8 + 2 * t + (e & 1);
          if (valid[h] && col < kn) {
            dbias[(bh * len_i + rows[h]) * len_j + k0 + col] = ds[n][e];
          }
        }
      }
    }
    mma_ab<DH, kTileK>(acc, ds, ks, g, t);  // dQ += dS K
  }
  if (!warp_live) return;
  store_rows<DH>(dq + bh * len_i * DH, acc, rows, valid, t, scale);
}

template <int DH, bool BIAS2D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int64_t len_i,
                              int64_t len_j, int64_t n_tiles, float scale) {
  constexpr int kSTiles = kTileQ / 8;  // n-tiles of the (16 x queries) tiles
  __shared__ __align__(16) __nv_bfloat16 qs[kTileQ][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 gs[kTileQ][DH + kPad];
  __shared__ float ls[kTileQ];
  __shared__ float dls[kTileQ];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t bh = blockIdx.x / n_tiles;
  const int64_t key0 = (blockIdx.x % n_tiles) * kRows + warp * 16;
  const bool warp_live = key0 < len_j;
  const int64_t keys[2] = {key0 + g, key0 + g + 8};
  const bool valid[2] = {keys[0] < len_j, keys[1] < len_j};

  uint32_t ka[DH / 16][4];
  uint32_t va[DH / 16][4];
  load_a<DH>(ka, k + bh * len_j * DH, keys, valid, t);
  load_a<DH>(va, v + bh * len_j * DH, keys, valid, t);
  float key_bias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key_bias[h] = (!BIAS2D && valid[h]) ? bias[bh * len_j + keys[h]] : -INFINITY;
  }
  float dk_acc[DH / 8][4];
  float dv_acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int64_t q0 = 0; q0 < len_i; q0 += kTileQ) {
    const int qn = (int)(len_i - q0 < kTileQ ? len_i - q0 : kTileQ);
    __syncthreads();  // every warp is done with the previous tile
    stage<kTileQ, DH>(qs, q + (bh * len_i + q0) * DH, qn);
    stage<kTileQ, DH>(gs, dout + (bh * len_i + q0) * DH, qn);
    for (int idx = threadIdx.x; idx < kTileQ; idx += blockDim.x) {
      // queries past the end: lse = +inf makes their p an exact 0
      ls[idx] = idx < qn ? lse[bh * len_i + q0 + idx] : INFINITY;
      dls[idx] = idx < qn ? delta[bh * len_i + q0 + idx] : 0.f;
    }
    __syncthreads();
    if (!warp_live) continue;

    // transposed tiles: rows are this warp's keys, columns the queries
    float p[kSTiles][4];
    float ds[kSTiles][4];
    mma_abt<DH, kSTiles>(p, ka, qs, g, t);   // S^T = K Q^T
    mma_abt<DH, kSTiles>(ds, va, gs, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = n * 8 + 2 * t + (e & 1);
        float b = key_bias[h];
        if (BIAS2D) {
          b = (valid[h] && col < qn)
                  ? bias[(bh * len_i + q0 + col) * len_j + keys[h]]
                  : -INFINITY;
        }
        p[n][e] = expf(p[n][e] * scale + b - ls[col]);
        ds[n][e] = p[n][e] * (ds[n][e] - dls[col]);
      }
    }
    mma_ab<DH, kTileQ>(dv_acc, p, gs, g, t);   // dV += P^T dO
    mma_ab<DH, kTileQ>(dk_acc, ds, qs, g, t);  // dK += dS^T Q
  }
  if (!warp_live) return;
  store_rows<DH>(dk + bh * len_j * DH, dk_acc, keys, valid, t, scale);
  store_rows<DH>(dv + bh * len_j * DH, dv_acc, keys, valid, t, 1.f);
}

// --- f32: CUDA cores -------------------------------------------------------

constexpr int kRowsF32 = 64;  // threads = owned rows per block
constexpr int kTileF32 = 16;  // streamed rows per step

// Copy `n` rows of a row-major (., DH) f32 operand into shared rows of
// stride S; rows past n are zero.
template <int ROWS, int DH, int S>
__device__ __forceinline__ void stage_f32(float (*dst)[S], const float* src,
                                          int n) {
  for (int idx = threadIdx.x; idx < ROWS * DH; idx += blockDim.x) {
    const int row = idx / DH;
    dst[row][idx % DH] = row < n ? src[(int64_t)row * DH + idx % DH] : 0.f;
  }
}

template <int DH, bool BIAS2D>
__global__ void __launch_bounds__(kRowsF32)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq,
                            float* __restrict__ dbias, int64_t len_i,
                            int64_t len_j, int64_t n_tiles, float scale) {
  __shared__ float qs[kRowsF32][DH + 1];
  __shared__ float gs[kRowsF32][DH + 1];
  __shared__ float ks[kTileF32][DH];
  __shared__ float vs[kTileF32][DH];
  __shared__ float bs[kTileF32];

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x / n_tiles;
  const int64_t first = (blockIdx.x % n_tiles) * kRowsF32;
  const int own = (int)(len_i - first < kRowsF32 ? len_i - first : kRowsF32);
  const bool active = tid < own;
  const int64_t qrow = bh * len_i + first + tid;
  stage_f32<kRowsF32, DH, DH + 1>(qs, q + (bh * len_i + first) * DH, own);
  stage_f32<kRowsF32, DH, DH + 1>(gs, dout + (bh * len_i + first) * DH, own);
  const float row_lse = active ? lse[qrow] : INFINITY;
  const float row_delta = active ? delta[qrow] : 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  for (int64_t k0 = 0; k0 < len_j; k0 += kTileF32) {
    const int kn = (int)(len_j - k0 < kTileF32 ? len_j - k0 : kTileF32);
    __syncthreads();  // own rows staged; every thread done with the tile
    stage_f32<kTileF32, DH, DH>(ks, k + (bh * len_j + k0) * DH, kn);
    stage_f32<kTileF32, DH, DH>(vs, v + (bh * len_j + k0) * DH, kn);
    if (!BIAS2D && tid < kn) bs[tid] = bias[bh * len_j + k0 + tid];
    __syncthreads();
    if (!active) continue;
    for (int kk = 0; kk < kn; ++kk) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qs[tid][d], ks[kk][d], s);
        dp = fmaf(gs[tid][d], vs[kk][d], dp);
      }
      const float b = BIAS2D ? bias[qrow * len_j + k0 + kk] : bs[kk];
      const float p = expf(s * scale + b - row_lse);
      const float ds = p * (dp - row_delta);
      if (BIAS2D) dbias[qrow * len_j + k0 + kk] = ds;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, ks[kk][d], acc[d]);
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) dq[qrow * DH + d] = acc[d] * scale;
}

template <int DH, bool BIAS2D>
__global__ void __launch_bounds__(kRowsF32)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ bias,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int64_t len_i, int64_t len_j, int64_t n_tiles,
                             float scale) {
  __shared__ float ks[kRowsF32][DH + 1];
  __shared__ float vs[kRowsF32][DH + 1];
  __shared__ float qs[kTileF32][DH];
  __shared__ float gs[kTileF32][DH];
  __shared__ float ls[kTileF32];
  __shared__ float dls[kTileF32];

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x / n_tiles;
  const int64_t first = (blockIdx.x % n_tiles) * kRowsF32;
  const int own = (int)(len_j - first < kRowsF32 ? len_j - first : kRowsF32);
  const bool active = tid < own;
  const int64_t krow = bh * len_j + first + tid;
  stage_f32<kRowsF32, DH, DH + 1>(ks, k + (bh * len_j + first) * DH, own);
  stage_f32<kRowsF32, DH, DH + 1>(vs, v + (bh * len_j + first) * DH, own);
  const float key_bias = (!BIAS2D && active) ? bias[krow] : 0.f;
  float dk_acc[DH];
  float dv_acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) dk_acc[d] = dv_acc[d] = 0.f;

  for (int64_t q0 = 0; q0 < len_i; q0 += kTileF32) {
    const int qn = (int)(len_i - q0 < kTileF32 ? len_i - q0 : kTileF32);
    __syncthreads();  // own rows staged; every thread done with the tile
    stage_f32<kTileF32, DH, DH>(qs, q + (bh * len_i + q0) * DH, qn);
    stage_f32<kTileF32, DH, DH>(gs, dout + (bh * len_i + q0) * DH, qn);
    if (tid < qn) {
      ls[tid] = lse[bh * len_i + q0 + tid];
      dls[tid] = delta[bh * len_i + q0 + tid];
    }
    __syncthreads();
    if (!active) continue;
    for (int qq = 0; qq < qn; ++qq) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(ks[tid][d], qs[qq][d], s);
        dp = fmaf(vs[tid][d], gs[qq][d], dp);
      }
      const float b = BIAS2D
                          ? bias[(bh * len_i + q0 + qq) * len_j + first + tid]
                          : key_bias;
      const float p = expf(s * scale + b - ls[qq]);
      const float ds = p * (dp - dls[qq]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dv_acc[d] = fmaf(p, gs[qq][d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, qs[qq][d], dk_acc[d]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk[krow * DH + d] = dk_acc[d] * scale;
    dv[krow * DH + d] = dv_acc[d];
  }
}

// --- bf16, the dkv kernel's wgmma route: TMA ring, wgmma, persistent blocks --
//
// flash_bwd_dkv_wgmma.cuh's pipeline over every 64-query stage of len_i.

using af2::StageList;
using af2::dkv::DkvTile;

template <bool BIAS2D>
__global__ void __launch_bounds__(DkvTile<BIAS2D>::kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_g,
                               const __grid_constant__ CUtensorMap tm_bias,  // BIAS2D only
                               const __grid_constant__ CUtensorMap tm_dk,
                               const __grid_constant__ CUtensorMap tm_dv,
                               const float* __restrict__ key_bias,          // (BH, j), !BIAS2D
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, const StageList list, int len_i,
                               int len_j, int n_ktiles, int64_t tiles, float scale,
                               float scale_log2) {
  af2::dkv::wgmma_dkv<BIAS2D, false>(tm_q, tm_k, tm_v, tm_g, tm_bias, tm_dk, tm_dv, key_bias, lse,
                                     delta, list, len_i, len_j, n_ktiles, tiles, scale,
                                     scale_log2);
}

// --- bf16, the dq kernel's wgmma route: TMA ring, wgmma, persistent blocks ---
//
// flash_bwd_dq_wgmma.cuh's pipeline, unlisted: every 128-key stage of len_j.

using af2::dq::DqTile;

template <bool BIAS2D>
__global__ void __launch_bounds__(DqTile<BIAS2D>::kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_g,
                              const __grid_constant__ CUtensorMap tm_bias,   // BIAS2D only
                              const __grid_constant__ CUtensorMap tm_dbias,  // BIAS2D only
                              const __grid_constant__ CUtensorMap tm_dq,
                              const float* __restrict__ key_bias,  // (BH, j), !BIAS2D
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const StageList list, int len_i, int len_j, int n_qtiles,
                              int64_t tiles, float scale, float scale_log2) {
  af2::dq::wgmma_dq<BIAS2D, false>(tm_q, tm_k, tm_v, tm_g, tm_bias, tm_dbias, tm_dq, key_bias, lse,
                                   delta, list, len_i, len_j, n_qtiles, tiles, scale, scale_log2);
}

// --- launch: the mma_sync and f32 routes ------------------------------------

// grid: one block per (bh, tile of `rows_per_block` owned rows) on x
bool make_grid(int64_t bh, int64_t owned, int rows_per_block,
               int64_t* n_tiles, dim3* grid) {
  *n_tiles = (owned + rows_per_block - 1) / rows_per_block;
  const int64_t blocks = bh * *n_tiles;
  if (blocks <= 0 || blocks > 2147483647LL) return false;
  *grid = dim3((unsigned)blocks);
  return true;
}

template <bool BIAS2D>
int launch_dq(int is_bf16, const void* q, const void* k, const void* v,
              const void* bias, const void* dout, const void* lse,
              const void* delta, void* dq, void* dbias, int64_t bh,
              int64_t len_i, int64_t len_j, int dh, float scale,
              void* stream_ptr) {
  int64_t n_tiles;
  dim3 grid;
  if (len_j <= 0 ||
      !make_grid(bh, len_i, is_bf16 ? kRows : kRowsF32, &n_tiles, &grid)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
#define AF2_LAUNCH(DH_)                                                       \
  if (is_bf16) {                                                              \
    flash_bwd_dq_bf16_kernel<DH_, BIAS2D><<<grid, kWarps * 32, 0, stream>>>( \
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,                     \
        (const __nv_bfloat16*)v, (const float*)bias,                          \
        (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,   \
        (__nv_bfloat16*)dq, (float*)dbias, len_i, len_j, n_tiles, scale);     \
  } else {                                                                    \
    flash_bwd_dq_f32_kernel<DH_, BIAS2D><<<grid, kRowsF32, 0, stream>>>(      \
        (const float*)q, (const float*)k, (const float*)v,                    \
        (const float*)bias, (const float*)dout, (const float*)lse,            \
        (const float*)delta, (float*)dq, (float*)dbias, len_i, len_j,         \
        n_tiles, scale);                                                      \
  }
  switch (dh) {
    case 16: AF2_LAUNCH(16); break;
    case 32: AF2_LAUNCH(32); break;
    case 64: AF2_LAUNCH(64); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef AF2_LAUNCH
  return (int)cudaGetLastError();
}

template <bool BIAS2D>
int launch_dkv(int is_bf16, const void* q, const void* k, const void* v,
               const void* bias, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int64_t bh,
               int64_t len_i, int64_t len_j, int dh, float scale,
               void* stream_ptr) {
  int64_t n_tiles;
  dim3 grid;
  if (len_i <= 0 ||
      !make_grid(bh, len_j, is_bf16 ? kRows : kRowsF32, &n_tiles, &grid)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
#define AF2_LAUNCH(DH_)                                                        \
  if (is_bf16) {                                                               \
    flash_bwd_dkv_bf16_kernel<DH_, BIAS2D><<<grid, kWarps * 32, 0, stream>>>( \
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,                      \
        (const __nv_bfloat16*)v, (const float*)bias,                           \
        (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,    \
        (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, len_i, len_j, n_tiles, scale); \
  } else {                                                                     \
    flash_bwd_dkv_f32_kernel<DH_, BIAS2D><<<grid, kRowsF32, 0, stream>>>(      \
        (const float*)q, (const float*)k, (const float*)v,                     \
        (const float*)bias, (const float*)dout, (const float*)lse,             \
        (const float*)delta, (float*)dk, (float*)dv, len_i, len_j, n_tiles,   \
        scale);                                                                \
  }
  switch (dh) {
    case 16: AF2_LAUNCH(16); break;
    case 32: AF2_LAUNCH(32); break;
    case 64: AF2_LAUNCH(64); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef AF2_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dq kernel (B1b `_dq_kernel`; B2b `_make_fused_dq_kernel`) on its
// mma_sync (bf16) and f32 routes. q, dout
// (BH, i, dh); k, v (BH, j, dh) in f32 or bf16; bias (BH, j) f32, or
// (BH, i, j) f32 when bias2d; lse, delta (BH, i) f32; dq (BH, i, dh) in
// the input type; dbias (BH, i, j) f32 when bias2d, else null. bf16
// pointers are 16-byte aligned. Returns the CUDA error code of the launch
// (0 = launched).
int af2_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* bias, const void* dout, const void* lse,
                     const void* delta, void* dq, void* dbias, int64_t bh,
                     int64_t len_i, int64_t len_j, int dh, float scale,
                     int is_bf16, int bias2d, void* stream) {
  if (bias2d) {
    return launch_dq<true>(is_bf16, q, k, v, bias, dout, lse, delta, dq,
                           dbias, bh, len_i, len_j, dh, scale, stream);
  }
  return launch_dq<false>(is_bf16, q, k, v, bias, dout, lse, delta, dq,
                          nullptr, bh, len_i, len_j, dh, scale, stream);
}

// The dq kernel on its wgmma route: bf16, dh = 64, as af2_flash_bwd_dq, with
// q, k, v, dout and dq 16-byte aligned (TMA's 16-byte bases; dh 64 gives
// 128-byte rows) and a 2-D bias and its dbias 16-byte aligned with j % 4 ==
// 0 (16-byte rows). Returns the CUDA error code of the launch (0 =
// launched); refuses a call the route cannot take (never by running another
// kernel).
int af2_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* bias,
                           const void* dout, const void* lse, const void* delta, void* dq,
                           void* dbias, int64_t bh, int64_t len_i, int64_t len_j, int dh,
                           float scale, int bias2d, void* stream_ptr) {
  if (bh <= 0 || len_i <= 0 || len_j <= 0 || dh != af2::dq::kWDH || len_i > 2147483647LL ||
      len_j > 2147483647LL || bh > 2147483647LL ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dq) % 16 != 0 ||
      (bias2d && (len_j % 4 != 0 || dbias == nullptr ||
                  ((uintptr_t)bias | (uintptr_t)dbias) % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const StageList every{nullptr, nullptr, 1};
#define AF2_ARGS q, k, v, bias, dout, lse, delta, every, dq, dbias, bh, len_i, len_j, scale, \
                 (cudaStream_t)stream_ptr
  if (bias2d) {
    return af2::dq::launch_wgmma_dq<true>(flash_bwd_dq_wgmma_kernel<true>, AF2_ARGS);
  }
  return af2::dq::launch_wgmma_dq<false>(flash_bwd_dq_wgmma_kernel<false>, AF2_ARGS);
#undef AF2_ARGS
}

// The dkv kernel (B1b `_dkv_kernel`; B2b `_make_fused_dkv_kernel`) on its
// mma_sync (bf16) and f32 routes. As the dq kernel; dk, dv (BH, j, dh) in the
// input type.
int af2_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, int64_t bh,
                      int64_t len_i, int64_t len_j, int dh, float scale,
                      int is_bf16, int bias2d, void* stream) {
  if (bias2d) {
    return launch_dkv<true>(is_bf16, q, k, v, bias, dout, lse, delta, dk, dv,
                            bh, len_i, len_j, dh, scale, stream);
  }
  return launch_dkv<false>(is_bf16, q, k, v, bias, dout, lse, delta, dk, dv,
                           bh, len_i, len_j, dh, scale, stream);
}

// The dkv kernel on its wgmma route: bf16, dh = 64, as af2_flash_bwd_dkv,
// with q, k, v, dout, dk, dv 16-byte aligned and a 2-D bias 16-byte aligned with
// j % 4 == 0 (TMA's 16-byte bases and row strides). Returns the CUDA error
// code of the launch (0 = launched); refuses a call the route cannot take.
int af2_flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const void* bias,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, int64_t bh, int64_t len_i, int64_t len_j, int dh,
                            float scale, int bias2d, void* stream_ptr) {
  if (bh <= 0 || len_i <= 0 || len_j <= 0 || dh != af2::dkv::kWDH || len_i > 2147483647LL ||
      len_j > 2147483647LL || bh > 2147483647LL ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dk |
       (uintptr_t)dv) % 16 != 0 ||
      (bias2d && (len_j % 4 != 0 || (uintptr_t)bias % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const StageList every{nullptr, nullptr, 1};
#define AF2_ARGS q, k, v, bias, dout, lse, delta, every, dk, dv, bh, len_i, len_j, scale, \
                 (cudaStream_t)stream_ptr
  if (bias2d) {
    return af2::dkv::launch_wgmma_dkv<true>(flash_bwd_dkv_wgmma_kernel<true>, AF2_ARGS);
  }
  return af2::dkv::launch_wgmma_dkv<false>(flash_bwd_dkv_wgmma_kernel<false>, AF2_ARGS);
#undef AF2_ARGS
}

}  // extern "C"
