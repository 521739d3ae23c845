// Flash-attention forward kernels for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels of alphafold2_tpu/ops/flash_kernel.py:
//   * B1f  `flash_attention_tpu` -> `_forward` -> `_fwd_kernel`: dense
//     attention with a key-side additive bias (BH, j);
//   * B2f  `flash_attention_fused` -> `_forward_fused` ->
//     `_make_fused_fwd_kernel`: the same plus an optional 2-D (BH, i, j)
//     bias tile and an optional sigmoid output gate (BH, i, dh).
// B3's forward (`flash_attention_lse`) is B1f with lse an output. Each kernel
// is one template <.., GATED, BIAS2D>; the (false, false) instantiations are
// B1f.
//
// What they compute (the TPU kernels' contract): s = scale * q.k + bias, an
// online softmax whose running max and sum stay in f32 (finite sentinel
// -1e30, so a -inf bias underflows to an exact 0), an f32 accumulator, the
// output written in the input type and lse = m + log(l) per row. A row with
// no unmasked key gets a zero output and lse = +inf.
//
// What bounds them on an H100: 4 * BH * i * j * dh operations against the
// inputs read once and the outputs written once. The crosses and B3's hops
// are bound by operations; the pair passes (i = j = 384) by bytes, above all
// with a 2-D f32 bias, which is three quarters of what such a call moves.
//
// Three kernels, one per route (`ops/flash_kernel.py route`):
//
// wgmma (bf16, dh = 64, every operand TMA loads addressable: every served
// shape): the TMA-fed wgmma pipeline of flash_fwd_wgmma.cuh (persistent
// blocks, a producer warp streaming 128-key K/V stages through an mbarrier
// ring, consumer warpgroups of 64 query rows taking turns at the softmax,
// stage c + 1's Q.K^T overlapped with stage c's P.V), which the block-sparse
// forward shares; this kernel walks every key stage of j. A tile is 192 rows
// (three consumer warpgroups) where that pads i no more than 128 rows does
// and still fills the card, else 128.
// Where its time goes (telemetry/flash_ablation.py, PERF.md): the softmax.
// A warpgroup's softmax of a 64 x 128 stage (~450 instructions a thread, 64
// of them ex2) is latency-bound; a third warpgroup keeps the ex2 unit and
// the tensor cores busier.
//
// mma_sync (bf16 shapes the wgmma route does not take: dh 16 or 32, a 2-D
// bias with j % 4 != 0 or off a 16-byte boundary): `mma.sync.m16n8k16`. A
// block of 8 warps owns 128 query rows, 16 per warp; the warp keeps its q
// fragments, its score tile and its f32 output accumulator in registers,
// and the block stages 64-key K and V tiles in shared memory (rows padded by
// 8 elements, so the fragment loads hit 32 distinct banks). The flattened
// (bh, query tile) index rides gridDim.x.
//
// f32: one thread per query row on the CUDA cores in f32 FMAs (the tensor
// cores would round to TF32), K/V tiles staged as f32 in shared memory.
//
// Unlike the TPU kernel, no query tile waits on another (each block owns its
// rows and its lse entries), and nothing is padded in device memory: the
// ragged last query and key tiles are masked here. Offsets are 64-bit: a
// served batch of 32 at L = 384 has more than 2^31 query elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_fwd_wgmma.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using af2::fwd::kWDH;
using af2::mma_bf16;
using af2::pack_bf16;

constexpr int kBlockQ = 128;   // query rows per block (both kernels)
constexpr int kBlockK = 64;    // keys staged in shared memory per step
constexpr float kM0 = -1e30f;  // running-max sentinel (TPU kernel's _M0)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// --- bf16, the mma_sync route: tensor cores ---------------------------------

constexpr int kWarps = kBlockQ / 16;  // one m16 row slab per warp
constexpr int kPad = 8;               // smem row padding, in elements

// Fragment layouts: mma_bf16.cuh.
template <int DH, bool GATED, bool BIAS2D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ gate,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ lse, int64_t len_i,
                              int64_t len_j, int64_t n_qtiles, float scale) {
  constexpr int kSteps = DH / 16;      // k-steps of Q.K^T over dh
  constexpr int kSTiles = kBlockK / 8; // n-tiles of the score tile
  constexpr int kOTiles = DH / 8;      // n-tiles of the output
  constexpr int kVec = 8;              // bf16 per 16-byte load
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK][DH + kPad];
  __shared__ float bs[kBlockK];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t bh = blockIdx.x / n_qtiles;
  const int64_t row0 = (blockIdx.x % n_qtiles) * kBlockQ + warp * 16;
  const bool warp_live = row0 < len_i;
  const int64_t rows[2] = {row0 + g, row0 + g + 8};
  const bool valid[2] = {rows[0] < len_i, rows[1] < len_i};
  const __nv_bfloat16* kb = k + bh * len_j * DH;
  const __nv_bfloat16* vb = v + bh * len_j * DH;

  uint32_t qa[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r & 1;  // a0, a2: row g; a1, a3: row g + 8
      const int col = s * 16 + (r >> 1) * 8 + 2 * t;
      qa[s][r] = valid[h] ? *reinterpret_cast<const uint32_t*>(
                                q + (bh * len_i + rows[h]) * DH + col)
                          : 0u;
    }
  }
  float o[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  }
  float m[2] = {kM0, kM0};  // running max, log2 domain
  float l[2] = {0.f, 0.f};  // this thread's share of the running sum

  for (int64_t k0 = 0; k0 < len_j; k0 += kBlockK) {
    const int kn = (int)(len_j - k0 < kBlockK ? len_j - k0 : kBlockK);
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockK * DH / kVec; idx += blockDim.x) {
      const int key = idx / (DH / kVec);
      const int col = (idx % (DH / kVec)) * kVec;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;  // keys past the end stay zero: 0 * garbage is no NaN
      if (key < kn) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + key) * DH + col);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + key) * DH + col);
      }
      *reinterpret_cast<uint4*>(&ks[key][col]) = kv;
      *reinterpret_cast<uint4*>(&vs[key][col]) = vv;
    }
    if (!BIAS2D) {
      for (int idx = threadIdx.x; idx < kBlockK; idx += blockDim.x) {
        bs[idx] = idx < kn ? bias[bh * len_j + k0 + idx] : -INFINITY;
      }
    }
    __syncthreads();
    if (!warp_live) continue;

    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const __nv_bfloat16* krow = &ks[n * 8 + g][st * 16 + 2 * t];
        mma_bf16(s[n], qa[st], *reinterpret_cast<const uint32_t*>(krow),
                 *reinterpret_cast<const uint32_t*>(krow + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
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
        s[n][e] = (s[n][e] * scale + b) * kLog2e;
        mx[h] = fmaxf(mx[h], s[n][e]);
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
    for (int n = 0; n < kOTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[n][e] = exp2f(s[n][e] - m[h]);
        l[h] += s[n][e];
      }
    }

#pragma unroll
    for (int c = 0; c < kBlockK / 16; ++c) {
      // the score tile's C fragments of n-tiles 2c, 2c + 1 are the A
      // fragment of keys 16c .. 16c + 15
      const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                              pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
      const int key = c * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        const int col = n * 8 + g;
        mma_bf16(o[n], pa, pack_bf16(vs[key][col], vs[key + 1][col]),
                 pack_bf16(vs[key + 8][col], vs[key + 9][col]));
      }
    }
  }
  if (!warp_live) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!valid[h]) continue;
    const int64_t qrow = bh * len_i + rows[h];
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      const int col = n * 8 + 2 * t;
      float x0 = o[n][2 * h] * inv;
      float x1 = o[n][2 * h + 1] * inv;
      if (GATED) {
        const __nv_bfloat162 gv =
            *reinterpret_cast<const __nv_bfloat162*>(gate + qrow * DH + col);
        x0 *= 1.f / (1.f + expf(-__bfloat162float(gv.x)));
        x1 *= 1.f / (1.f + expf(-__bfloat162float(gv.y)));
      }
      *reinterpret_cast<uint32_t*>(out + qrow * DH + col) = pack_bf16(x0, x1);
    }
    if (t == 0) lse[qrow] = l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : INFINITY;
  }
}

// --- f32: CUDA cores -------------------------------------------------------

constexpr int kChunk = 16;  // keys scored per accumulator rescale

template <int DH, bool GATED, bool BIAS2D>
__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         const float* __restrict__ gate,
                         float* __restrict__ out, float* __restrict__ lse,
                         int64_t len_i, int64_t len_j, int64_t n_qtiles,
                         float scale) {
  __shared__ __align__(16) float ks[kBlockK][DH];
  __shared__ __align__(16) float vs[kBlockK][DH];
  __shared__ float bs[kBlockK];

  const int64_t bh = blockIdx.x / n_qtiles;
  const int64_t row = (blockIdx.x % n_qtiles) * kBlockQ + threadIdx.x;
  const bool active = row < len_i;
  const int64_t qrow = bh * len_i + row;  // row of the (BH * i) flattening
  const float* kb = k + bh * len_j * DH;
  const float* vb = v + bh * len_j * DH;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? q[qrow * DH + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kM0;
  float l = 0.f;

  for (int64_t k0 = 0; k0 < len_j; k0 += kBlockK) {
    const int kn = (int)(len_j - k0 < kBlockK ? len_j - k0 : kBlockK);
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kn * DH; idx += kBlockQ) {
      ks[idx / DH][idx % DH] = kb[k0 * DH + idx];
      vs[idx / DH][idx % DH] = vb[k0 * DH + idx];
    }
    if (!BIAS2D) {
      for (int idx = threadIdx.x; idx < kn; idx += kBlockQ) {
        bs[idx] = bias[bh * len_j + k0 + idx];
      }
    }
    __syncthreads();
    if (!active) continue;

    const float* brow = BIAS2D ? bias + qrow * len_j + k0 : bs;
    for (int c0 = 0; c0 < kn; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int kk = c0 + c;
        float sc = -INFINITY;
        if (kk < kn) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], ks[kk][d], dot);
          sc = dot * scale + brow[kk];
        }
        s[c] = sc;
        cmax = fmaxf(cmax, sc);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int kk = c0 + c;
        if (kk < kn) {
          const float p = expf(s[c] - m_new);
          l += p;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[kk][d], acc[d]);
        }
      }
      m = m_new;
    }
  }
  if (!active) return;

  float* orow = out + qrow * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    float o = l > 0.f ? acc[d] / l : 0.f;
    if (GATED) o *= 1.f / (1.f + expf(-gate[qrow * DH + d]));
    orow[d] = o;
  }
  lse[qrow] = l > 0.f ? m + logf(l) : INFINITY;
}

// --- bf16, the wgmma route: TMA ring, wgmma, persistent blocks ---------------

using af2::StageList;
using af2::fwd::WgmmaTile;

template <bool GATED, bool BIAS2D, int CONSUMERS>
__global__ void __launch_bounds__(WgmmaTile<BIAS2D, CONSUMERS>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_bias,  // BIAS2D only
                           const float* __restrict__ key_bias,          // (BH, j), !BIAS2D
                           const __nv_bfloat16* __restrict__ gate, const StageList list,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                           int len_i, int len_j, int n_qtiles, int64_t tiles,
                           float scale_log2) {
  af2::fwd::wgmma_fwd<GATED, BIAS2D, CONSUMERS, false>(tm_q, tm_k, tm_v, tm_bias, key_bias, gate,
                                                       list, out, lse, len_i, len_j, n_qtiles,
                                                       tiles, scale_log2);
}

template <bool GATED, bool BIAS2D>
int launch_wgmma_tiles(const void* q, const void* k, const void* v, const void* bias,
                       const void* gate, void* out, void* lse, int64_t bh, int64_t len_i,
                       int64_t len_j, float scale, cudaStream_t stream) {
  cudaError_t e;
  const int sms = af2::fwd::sm_count(&e);
  if (e != cudaSuccess) return (int)e;
  const StageList every{nullptr, nullptr, 1};
#define AF2_ARGS q, k, v, bias, (const __nv_bfloat16*)gate, every, out, lse, bh, len_i, len_j, \
                 scale, sms, stream
  if (af2::fwd::wgmma_consumers(bh, len_i, sms, BIAS2D) == 3) {  // never with a 2-D bias
    constexpr int kThree = BIAS2D ? 2 : 3;
    return af2::fwd::launch_wgmma_fwd<BIAS2D, kThree>(
        flash_fwd_wgmma_kernel<GATED, BIAS2D, kThree>, AF2_ARGS);
  }
  return af2::fwd::launch_wgmma_fwd<BIAS2D, 2>(flash_fwd_wgmma_kernel<GATED, BIAS2D, 2>,
                                               AF2_ARGS);
#undef AF2_ARGS
}

// --- launch: the mma_sync and f32 routes -------------------------------------

template <bool GATED, bool BIAS2D>
int launch(int is_bf16, const void* q, const void* k, const void* v,
           const void* bias, const void* gate, void* out, void* lse,
           int64_t bh, int64_t len_i, int64_t len_j, int dh, float scale,
           cudaStream_t stream) {
  const int64_t n_qtiles = (len_i + kBlockQ - 1) / kBlockQ;
  const int64_t blocks = bh * n_qtiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
#define AF2_LAUNCH(DH_)                                                      \
  if (is_bf16) {                                                             \
    flash_fwd_bf16_mma_kernel<DH_, GATED, BIAS2D>                            \
        <<<grid, kWarps * 32, 0, stream>>>(                                  \
            (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,                \
            (const __nv_bfloat16*)v, (const float*)bias,                     \
            (const __nv_bfloat16*)gate, (__nv_bfloat16*)out, (float*)lse,    \
            len_i, len_j, n_qtiles, scale);                                  \
  } else {                                                                   \
    flash_fwd_f32_kernel<DH_, GATED, BIAS2D><<<grid, kBlockQ, 0, stream>>>(  \
        (const float*)q, (const float*)k, (const float*)v,                   \
        (const float*)bias, (const float*)gate, (float*)out, (float*)lse,    \
        len_i, len_j, n_qtiles, scale);                                      \
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

// B1f and B2f on the mma_sync (bf16) and f32 routes. q (BH, i, dh); k, v
// (BH, j, dh) in f32 or bf16; bias (BH, i, j) f32 when bias2d, else (BH, j)
// f32; gate (BH, i, dh) pre-sigmoid logits in the input type when gated
// (else null); out (BH, i, dh) in the input type; lse (BH, i) f32. bf16 q,
// k, v and gate are 16-byte aligned. Returns the CUDA error code of the
// launch (0 = launched).
int af2_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                  const void* gate, void* out, void* lse, int64_t bh, int64_t len_i,
                  int64_t len_j, int dh, float scale, int is_bf16, int bias2d, int gated,
                  void* stream_ptr) {
  if (bh <= 0 || len_i <= 0 || len_j <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
#define AF2_ARGS is_bf16, q, k, v, bias, gate, out, lse, bh, len_i, len_j, dh, scale, stream
  if (gated && bias2d) return launch<true, true>(AF2_ARGS);
  if (gated) return launch<true, false>(AF2_ARGS);
  if (bias2d) return launch<false, true>(AF2_ARGS);
  return launch<false, false>(AF2_ARGS);
#undef AF2_ARGS
}

// B1f and B2f on the wgmma route: bf16, dh = 64, as af2_flash_fwd, with q,
// k, v 16-byte aligned and a 2-D bias 16-byte aligned with j % 4 == 0 (TMA's
// 16-byte bases and row strides). Returns the CUDA error code of the launch
// (0 = launched).
int af2_flash_fwd_wgmma(const void* q, const void* k, const void* v, const void* bias,
                        const void* gate, void* out, void* lse, int64_t bh, int64_t len_i,
                        int64_t len_j, int dh, float scale, int bias2d, int gated,
                        void* stream_ptr) {
  if (bh <= 0 || len_i <= 0 || len_j <= 0 || dh != kWDH || len_i > 2147483647LL ||
      len_j > 2147483647LL || bh > 2147483647LL ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0 ||
      (bias2d && (len_j % 4 != 0 || (uintptr_t)bias % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
#define AF2_ARGS q, k, v, bias, gate, out, lse, bh, len_i, len_j, scale, stream
  if (gated && bias2d) return launch_wgmma_tiles<true, true>(AF2_ARGS);
  if (gated) return launch_wgmma_tiles<true, false>(AF2_ARGS);
  if (bias2d) return launch_wgmma_tiles<false, true>(AF2_ARGS);
  return launch_wgmma_tiles<false, false>(AF2_ARGS);
#undef AF2_ARGS
}

}  // extern "C"
