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
// shape): persistent blocks, one per SM, each walking (bh, query tile)
// tiles in turn; a tile is 192 rows (three consumer warpgroups) where that
// pads i no more than 128 rows does and still fills the card, else 128.
//  - Warp 0 is the producer. For each tile it loads the Q tile by TMA into
//    one of two buffers (the next tile's Q lands while this tile's epilogue
//    runs), then streams 128-key stages through a ring of full and empty
//    mbarriers: K and V tiles (3-D tensor maps (dh, n, BH), so a ragged last
//    tile reads zeros, never the next head's rows), with BIAS2D the f32 bias
//    tile (128 rows x 128 keys, four 128-byte swizzled boxes of 32 keys), and
//    the key-side bias in log2 units with -inf past len_j, written by the
//    warp's 32 lanes.
//  - Each consumer warpgroup owns 64 query rows. S = Q.K^T is one
//    wgmma.m64n128k16 per 16 of dh with both operands in shared memory
//    (K-major). The online softmax runs on S in f32 registers (exp2 with
//    scale * log2(e) folded into one FMA); P, rounded to bf16 as
//    FlashAttention does, stays in registers as the A operand of O += P.V,
//    wgmma.m64n64k16 with V as the MN-major (transposed) B operand.
//  - Stage c + 1's Q.K^T is issued with stage c's P.V, and stage c + 1's
//    softmax runs in place in S while that P.V does; O is rescaled and P
//    packed once it has retired. The warpgroups take turns at the softmax
//    (a named barrier each, round robin), so the one in its softmax has the
//    ex2 unit to itself while the others' products run.
//  - The epilogue normalizes, applies the gate's sigmoid (the gate fetched
//    into L2 at the tile's start) to the f32 result and writes out and lse
//    from registers.
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

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using af2::EncodeTiledFn;
using af2::encode_3d;
using af2::encode_tiled;
using af2::ex2;
using af2::fence_regs;
using af2::gmma_desc;
using af2::mbar_arrive;
using af2::mbar_expect_tx;
using af2::mbar_init;
using af2::mbar_wait;
using af2::mma_bf16;
using af2::pack_bf16;
using af2::smem_u32;
using af2::tma_load_3d;
using af2::wgmma_commit;
using af2::wgmma_fence;
using af2::wgmma_m64n128k16_ss;
using af2::wgmma_m64n64k16_rs_mn;
using af2::wgmma_wait;

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

constexpr int kWN = 128;            // keys a stage: the N of Q.K^T, the K of P.V
constexpr int kWDH = 64;            // the head width of the route: one 128-byte row
constexpr int kKVTile = kWN * kWDH * 2;           // 16 KB, K or V
constexpr int kBiasRows = 128;                    // query rows of a 2-D bias tile
constexpr int kBiasBox = 32;                      // keys of a 2-D bias box: 128-byte rows
constexpr int kBiasBoxBytes = kBiasRows * kBiasBox * 4;  // 16 KB
constexpr int kVLbo = 8192;  // V's descriptor: the stride of 64-column chunks (one here)

// a block: warpgroup 0 holds the producer warp; each of CONSUMERS consumer
// warpgroups owns 64 query rows of the tile (`launch_wgmma` picks 3 or 2;
// with BIAS2D the 2-D bias tile takes the shared memory of a third). Its
// shared memory: two Q buffers, the ring's stages (K, V, and with BIAS2D
// the 2-D bias tile), the stages' key-side bias, the barriers
template <bool BIAS2D, int CONSUMERS>
struct WgmmaTile {
  static constexpr int kConsumers = CONSUMERS;
  static constexpr int kRows = 64 * kConsumers;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerWarps = 4 * kConsumers;
  // setmaxnreg: warpgroup 0 gives registers to the consumers' S, O and P
  static constexpr int kLightRegs = kConsumers == 2 ? 56 : 24;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 224 : 160;
  static_assert(128 * kLightRegs + 128 * kConsumers * kConsumerRegs <= 65536, "registers");
  static_assert(!BIAS2D || kRows == kBiasRows, "a 2-D bias tile covers the tile's rows");
  static constexpr int kQTile = kRows * kWDH * 2;
  static constexpr int kStages = BIAS2D ? 2 : 4;
  static constexpr int kStage = 2 * kKVTile + (BIAS2D ? (kWN / kBiasBox) * kBiasBoxBytes : 0);
  static constexpr int kRing = 2 * kQTile;
  static constexpr int kKeyBias = kRing + kStages * kStage;
  static constexpr int kBars = kKeyBias + kStages * kWN * 4;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 4) + 1024;  // + alignment
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

template <bool GATED, bool BIAS2D, int CONSUMERS>
__global__ void __launch_bounds__(WgmmaTile<BIAS2D, CONSUMERS>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_bias,  // BIAS2D only
                           const float* __restrict__ key_bias,          // (BH, j), !BIAS2D
                           const __nv_bfloat16* __restrict__ gate,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                           int len_i, int len_j, int n_qtiles, int64_t tiles,
                           float scale_log2) {
  using L = WgmmaTile<BIAS2D, CONSUMERS>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  uint8_t* const smem = smem_raw + (base - raw);
  float* const kbias = reinterpret_cast<float*>(smem + L::kKeyBias);
  const uint32_t bars = base + L::kBars;
  auto full = [&](int c) { return bars + 8 * (c % S); };             // stage c landed
  auto empty = [&](int c) { return bars + 8 * (S + c % S); };        // stage c read
  auto qfull = [&](int n) { return bars + 8 * (2 * S + (n & 1)); };  // tile n's Q landed
  auto qempty = [&](int n) { return bars + 8 * (2 * S + 2 + (n & 1)); };  // and read
  // the phase parity a wait expects (empty slots: the previous round's,
  // which a fresh barrier counts as completed)
  auto ring = [](int c) { return (uint32_t)((c / S) & 1); };
  auto qring = [](int n) { return (uint32_t)((n >> 1) & 1); };
  auto stage = [&](int c) { return (uint32_t)(L::kRing + (c % S) * L::kStage); };  // offset

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nk = (len_j + kWN - 1) / kWN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes, and the TMA bytes
      mbar_init(empty(s), L::kConsumerWarps);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(qfull(b), 1);
      mbar_init(qempty(b), L::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kLightRegs));
    if (warp == 0) {
      // the producer: chunk c is key stage c of the block's tile sequence
      int c = 0, n = 0;
      for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        const int bh = (int)(tile / n_qtiles);
        const int row0 = (int)(tile % n_qtiles) * L::kRows;
        if (lane == 0) {
          mbar_wait(qempty(n), qring(n) ^ 1);
          mbar_expect_tx(qfull(n), L::kQTile);
          tma_load_3d(base + (n & 1) * L::kQTile, &tm_q, qfull(n), 0, row0, bh);
        }
        for (int kk = 0; kk < nk; ++kk, ++c) {
          const int k0 = kk * kWN;
          mbar_wait(empty(c), ring(c) ^ 1);
          float* kb = kbias + (c % S) * kWN;
#pragma unroll
          for (int e = 0; e < kWN / 32; ++e) {
            const int key = k0 + 32 * e + lane;
            float b = -INFINITY;
            if (key < len_j) b = BIAS2D ? 0.f : key_bias[(int64_t)bh * len_j + key] * kLog2e;
            kb[32 * e + lane] = b;
          }
          const uint32_t st = base + stage(c);
          if (lane == 0) {
            mbar_expect_tx(full(c), L::kStage);
            tma_load_3d(st, &tm_k, full(c), 0, k0, bh);
            tma_load_3d(st + kKVTile, &tm_v, full(c), 0, k0, bh);
            if (BIAS2D) {
#pragma unroll
              for (int b = 0; b < kWN / kBiasBox; ++b) {
                tma_load_3d(st + 2 * kKVTile + b * kBiasBoxBytes, &tm_bias, full(c),
                            k0 + b * kBiasBox, row0, bh);
              }
            }
          } else {
            mbar_arrive(full(c));
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kConsumerRegs));
    // warpgroup wg owns the tile's rows 64 wg .. 64 wg + 63; a thread holds
    // rows r and r + 8 (wgmma's accumulator layout: per 8 columns j, s[4j],
    // s[4j + 1] are row r, columns 8j + 2t, 8j + 2t + 1; s[4j + 2], s[4j + 3]
    // row r + 8)
    const int wg = warp / 4 - 1;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r = 64 * wg + 16 * (warp % 4) + g;
    float s[64], o[32], m[2], l[2];
    uint32_t p[32];
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S = Q.K^T of stage c, issued
    auto qk = [&](uint32_t qa, int c) {
      const uint32_t ka = base + stage(c);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWDH / 16; ++ks) {
        wgmma_m64n128k16_ss(s, gmma_desc(qa + 32 * ks, 16, 1024), gmma_desc(ka + 32 * ks, 16, 1024),
                            ks);
      }
      wgmma_commit();
    };
    // the online softmax on stage c's S, in place: s = 2^(s' - m) with s' =
    // s scale log2(e) + bias, l rescaled and summed; O's factor in alpha.
    // Max and sum are trees over the thread's 32 columns a row (short
    // dependency chains: the warp's ex2 stream is the floor)
    float alpha[2];
    auto softmax = [&](int c) {
      const float* kb = kbias + (c % S) * kWN;
      const uint8_t* b2 = smem + stage(c) + 2 * kKVTile;
      float mx[2][4];  // four partial maxima a row: short chains, few registers
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(kb + 8 * j + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float b0 = kv.x, b1 = kv.y;
          if (BIAS2D) {
            // row r + 8h, columns 8j + 2t (+1) of the swizzled box j / 4
            const float2 bb = *reinterpret_cast<const float2*>(
                b2 + (j / 4) * kBiasBoxBytes + (r + 8 * h) * 128 +
                (((2 * (j % 4) + t / 2) ^ g) << 4) + (t % 2) * 8);
            b0 = fmaf(bb.x, kLog2e, b0);
            b1 = fmaf(bb.y, kLog2e, b1);
          }
          s[4 * j + 2 * h] = fmaf(s[4 * j + 2 * h], scale_log2, b0);
          s[4 * j + 2 * h + 1] = fmaf(s[4 * j + 2 * h + 1], scale_log2, b1);
          const float pair = fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
          mx[h][j % 4] = j < 4 ? pair : fmaxf(mx[h][j % 4], pair);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h][0] = fmaxf(fmaxf(mx[h][0], mx[h][2]), fmaxf(mx[h][1], mx[h][3]));
        float x = fmaxf(mx[h][0], __shfl_xor_sync(0xffffffffu, mx[h][0], 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[h], x);
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
      }
      float sum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[4 * j + 2 * h] = ex2(s[4 * j + 2 * h] - m[h]);
          s[4 * j + 2 * h + 1] = ex2(s[4 * j + 2 * h + 1] - m[h]);
          sum[h][j % 4] += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = l[h] * alpha[h] + ((sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]));
      }
    };
    // once the previous P.V has retired: O rescaled, P = S rounded to bf16
    auto rescale_pack = [&]() {
#pragma unroll
      for (int j = 0; j < kWDH / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
        p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
        p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
    };
    // O += P.V of stage c, issued. Keys 16 ks .. 16 ks + 15: the S fragments
    // of columns 16 ks .. + 15, rounded to bf16, are the A fragment p[4 ks ..
    // 4 ks + 3]
    auto pv = [&](int c) {
      const uint32_t va = base + stage(c) + kKVTile;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWN / 16; ++ks) {
        wgmma_m64n64k16_rs_mn(o, &p[4 * ks], gmma_desc(va + 2048 * ks, kVLbo, 1024));
      }
      wgmma_commit();
    };

    // the consumer warpgroups take turns at the softmax, round robin (named
    // barrier 1 + wg is this warpgroup's turn), so one has the ex2 unit to
    // itself while the others' wgmma run
    auto turn_wait = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
    auto turn_pass = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % L::kConsumers) : "memory");
    };
    if (wg == L::kConsumers - 1) turn_pass();  // warpgroup 0 goes first

    int c = 0, n = 0;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
      const int bh = (int)(tile / n_qtiles);
      const int row0 = (int)(tile % n_qtiles) * L::kRows;
      // the gate's rows (128 bytes each) are fetched into L2 now and read
      // into registers once S is dead, before the last P.V retires
      const __nv_bfloat16* grow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r + 8 * h;
        grow[h] = gate + ((int64_t)bh * len_i + (row < len_i ? row : 0)) * kWDH + 2 * t;
        if (GATED && t == 0) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(grow[h]));
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      m[0] = m[1] = kM0;  // running max, log2 domain
      l[0] = l[1] = 0.f;  // this thread's share of the running sum
      const uint32_t qa = base + (n & 1) * L::kQTile + wg * (64 * kWDH * 2);
      mbar_wait(qfull(n), qring(n));
      mbar_wait(full(c), ring(c));
      qk(qa, c);
      wgmma_wait<0>();
      fence_regs(s);
      turn_wait();
      softmax(c);
      turn_pass();
      rescale_pack();
      // stage c + 1's Q.K^T and stage c's P.V are issued together, and
      // stage c + 1's softmax runs while the P.V does. The loop body has no
      // branch, and the epilogue sits after it (accumulator reads in a
      // branch around the wgmma make ptxas serialize them)
      for (int kk = 1; kk < nk; ++kk, ++c) {
        mbar_wait(full(c + 1), ring(c + 1));
        qk(qa, c + 1);
        pv(c);
        wgmma_wait<1>();  // the Q.K^T (groups retire in order)
        fence_regs(s);
        turn_wait();
        softmax(c + 1);
        turn_pass();
        wgmma_wait<0>();  // the P.V
        fence_regs(o);
        fence_regs(p);
        rescale_pack();
        release(empty(c));
      }
      pv(c);
      uint32_t gv[2][kWDH / 8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < kWDH / 8; ++j) {
          gv[h][j] = GATED ? *reinterpret_cast<const uint32_t*>(grow[h] + 8 * j) : 0u;
        }
      }
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(empty(c));
      ++c;
      release(qempty(n));

      // epilogue: rows r, r + 8 of the tile, columns 8j + 2t (+1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r + 8 * h;
        if (row < len_i) {
          const int64_t qrow = (int64_t)bh * len_i + row;
          const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
          for (int j = 0; j < kWDH / 8; ++j) {
            const int col = 8 * j + 2 * t;
            float x0 = o[4 * j + 2 * h] * inv;
            float x1 = o[4 * j + 2 * h + 1] * inv;
            if (GATED) {  // sigmoid(g) = 1 / (1 + 2^(-g log2(e)))
              const __nv_bfloat162 g2 = *reinterpret_cast<const __nv_bfloat162*>(&gv[h][j]);
              x0 *= __frcp_rn(1.f + ex2(-kLog2e * __bfloat162float(g2.x)));
              x1 *= __frcp_rn(1.f + ex2(-kLog2e * __bfloat162float(g2.y)));
            }
            *reinterpret_cast<uint32_t*>(out + qrow * kWDH + col) = pack_bf16(x0, x1);
          }
          if (t == 0) lse[qrow] = l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : INFINITY;
        }
      }
    }
  }
}

template <bool GATED, bool BIAS2D, int CONSUMERS>
int launch_wgmma(const void* q, const void* k, const void* v, const void* bias,
                 const void* gate, void* out, void* lse, int64_t bh, int64_t len_i,
                 int64_t len_j, float scale, int sms, cudaStream_t stream) {
  using L = WgmmaTile<BIAS2D, CONSUMERS>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_bias;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_3d(encode, &tm_q, bf16, q, kWDH, len_i, bh, 2, kWDH, L::kRows) ||
      !encode_3d(encode, &tm_k, bf16, k, kWDH, len_j, bh, 2, kWDH, kWN) ||
      !encode_3d(encode, &tm_v, bf16, v, kWDH, len_j, bh, 2, kWDH, kWN)) {
    return (int)cudaErrorInvalidValue;
  }
  tm_bias = tm_k;  // unread without a 2-D bias
  if (BIAS2D && !encode_3d(encode, &tm_bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, bias, len_j,
                           len_i, bh, 4, kBiasBox, kBiasRows)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<GATED, BIAS2D, CONSUMERS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_qtiles = (len_i + L::kRows - 1) / L::kRows;
  const int64_t tiles = bh * n_qtiles;
  const int grid = (int)(tiles < sms ? tiles : sms);
  flash_fwd_wgmma_kernel<GATED, BIAS2D, CONSUMERS><<<grid, L::kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_bias, (const float*)bias, (const __nv_bfloat16*)gate,
      (__nv_bfloat16*)out, (float*)lse, (int)len_i, (int)len_j, (int)n_qtiles, tiles,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// three consumer warpgroups (192-row tiles) where their tiles pad i no more
// than 128-row ones do and still give every SM one (the crosses, the pair
// passes at L = 384); two otherwise (i = 128 or 256, a B3 hop's 80 tiles),
// and always with a 2-D bias
template <bool GATED, bool BIAS2D>
int launch_wgmma_tiles(const void* q, const void* k, const void* v, const void* bias,
                       const void* gate, void* out, void* lse, int64_t bh, int64_t len_i,
                       int64_t len_j, float scale, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles3 = (len_i + 191) / 192;
  const int64_t tiles2 = (len_i + 127) / 128;
  if (!BIAS2D && tiles3 * 192 <= tiles2 * 128 && bh * tiles3 >= sms) {
    return launch_wgmma<GATED, BIAS2D, BIAS2D ? 2 : 3>(q, k, v, bias, gate, out, lse, bh, len_i,
                                                        len_j, scale, sms, stream);
  }
  return launch_wgmma<GATED, BIAS2D, 2>(q, k, v, bias, gate, out, lse, bh, len_i, len_j, scale,
                                        sms, stream);
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
