// The bf16 attention forward's wgmma pipeline for Hopper (sm_90a, dh = 64),
// shared by two kernels:
//   * flash_fwd.cu's wgmma route (B1f, B2f, B3's forward): every 128-key
//     stage of len_j, a key-side bias or a 2-D bias tile, an optional gate;
//   * sparse_attn.cu's wgmma route (B5f at block size 16): only the stages a
//     query tile's list names, each with a 32-bit mask a warpgroup of the
//     (query block, key block) pairs it attends (`StageList`).
// Each defines its own __global__ kernel (so a profile names the kernel it
// ran) around `wgmma_fwd`, and launches it through `launch_wgmma_fwd`.
//
// Persistent blocks, one per SM, each walking (bh, query tile) tiles in
// turn; a tile is 64 rows a consumer warpgroup (`wgmma_consumers` picks 3
// or 2).
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
//    scale * log2(e) folded into one FMA; a listed stage's unattended key
//    blocks at -inf); P, rounded to bf16 as FlashAttention does, stays in
//    registers as the A operand of O += P.V, wgmma.m64n64k16 with V as the
//    MN-major (transposed) B operand.
//  - Stage c + 1's Q.K^T is issued with stage c's P.V, and stage c + 1's
//    softmax runs in place in S while that P.V does; O is rescaled and P
//    packed once it has retired. The warpgroups take turns at the softmax
//    (a named barrier each, round robin), so the one in its softmax has the
//    ex2 unit to itself while the others' products run.
//  - The epilogue normalizes, applies the gate's sigmoid (the gate fetched
//    into L2 at the tile's start) to the f32 result and writes out and lse
//    from registers.
//  - With attention dropout (B5f's, `Dropout<true>`, philox.cuh) P is
//    multiplied by its keep factors (0 or 1 / (1 - rate)) once it has
//    retired, outside the softmax's turn, before its bf16 rounding; the
//    running sum and lse keep the undropped P.
// What it computes: s = scale * q.k + bias, the running max and sum in f32
// (finite sentinel -1e30, so a -inf bias underflows to an exact 0), lse = m
// + log(l) per row; a row with no unmasked key gets a zero output and lse =
// +inf.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "philox.cuh"

namespace af2::fwd {

constexpr int kWN = 128;            // keys a stage: the N of Q.K^T, the K of P.V
constexpr int kWDH = 64;            // the head width of the route: one 128-byte row
constexpr int kKVTile = kWN * kWDH * 2;           // 16 KB, K or V
constexpr int kBiasRows = 128;                    // query rows of a 2-D bias tile
constexpr int kBiasBox = 32;                      // keys of a 2-D bias box: 128-byte rows
constexpr int kBiasBoxBytes = kBiasRows * kBiasBox * 4;  // 16 KB
constexpr int kVLbo = 8192;  // V's descriptor: the stride of 64-column chunks (one here)
constexpr float kM0 = -1e30f;  // running-max sentinel (TPU kernel's _M0)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a block: warpgroup 0 holds the producer warp; each of CONSUMERS consumer
// warpgroups owns 64 query rows of the tile (with BIAS2D the 2-D bias tile
// takes the shared memory of a third). Its shared memory: two Q buffers,
// the ring's stages (K, V, and with BIAS2D the 2-D bias tile), the stages'
// key-side bias, the barriers
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

template <bool GATED, bool BIAS2D, int CONSUMERS, bool LISTED, class Drop = Dropout<false>>
__device__ __forceinline__ void wgmma_fwd(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                          const CUtensorMap& tm_v,
                                          const CUtensorMap& tm_bias,  // BIAS2D only
                                          const float* __restrict__ key_bias,  // !BIAS2D
                                          const __nv_bfloat16* __restrict__ gate,
                                          const StageList list, __nv_bfloat16* __restrict__ out,
                                          float* __restrict__ lse, int len_i, int len_j,
                                          int n_qtiles, int64_t tiles, float scale_log2,
                                          const Drop drop = Drop{}) {
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
  // the entries of query tile qt's stages: [first, end)
  const int nk = (len_j + kWN - 1) / kWN;
  auto first_of = [&](int qt) { return LISTED ? list.offsets[qt] : 0; };
  auto end_of = [&](int qt) { return LISTED ? list.offsets[qt + 1] : nk; };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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
      // the producer: chunk c is the c-th stage of the block's tile sequence
      int c = 0, n = 0;
      for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        const int bh = (int)(tile / n_qtiles);
        const int qt = (int)(tile % n_qtiles);
        const int row0 = qt * L::kRows;
        const float* const bias_row = key_bias + (LISTED ? bh / list.bias_heads : bh) * len_j;
        if (lane == 0) {
          mbar_wait(qempty(n), qring(n) ^ 1);
          mbar_expect_tx(qfull(n), L::kQTile);
          tma_load_3d(base + (n & 1) * L::kQTile, &tm_q, qfull(n), 0, row0, bh);
        }
        const int e1 = end_of(qt);
        for (int e = first_of(qt); e < e1; ++e, ++c) {
          const int k0 = (LISTED ? list.entries[e].x : e) * kWN;
          mbar_wait(empty(c), ring(c) ^ 1);
          float* kb = kbias + (c % S) * kWN;
#pragma unroll
          for (int x = 0; x < kWN / 32; ++x) {
            const int key = k0 + 32 * x + lane;
            float b = -INFINITY;
            if (key < len_j) b = BIAS2D ? 0.f : bias_row[key] * kLog2e;
            kb[32 * x + lane] = b;
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
    // row r + 8), both in query block 4 wg + warp % 4 of 16 rows, whose byte
    // of a listed stage's mask is at bit 8 (warp % 4)
    const int wg = warp / 4 - 1;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r = 64 * wg + 16 * (warp % 4) + g;
    float s[64], o[32], m[2], l[2];
    uint32_t p[32];
    // attention dropout: the key, the tile's head and first row, the shift
    // from a chunk c of the tile to its entry (c + shift), the chunk the
    // softmax last ran on
    const DropKey dkey = drop_key(drop);
    int drop_bh = 0, drop_row0 = 0, shift = 0, soft_c = 0;
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
    // Listed, key block j / 2 of the stage is at -inf unless bit j / 2 of
    // `on` is set. Max and sum are trees over the thread's 32 columns a row
    // (short dependency chains: the warp's ex2 stream is the floor)
    float alpha[2];
    auto softmax = [&](int c, uint32_t on) {
      if (Drop::kOn) soft_c = c;
      const float* kb = kbias + (c % S) * kWN;
      const uint8_t* b2 = smem + stage(c) + 2 * kKVTile;
      float mx[2][4];  // four partial maxima a row: short chains, few registers
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
        float2 kv = *reinterpret_cast<const float2*>(kb + 8 * j + 2 * t);
        const bool live = !LISTED || ((on >> (j / 2)) & 1u);
        if (!live) kv = make_float2(-INFINITY, -INFINITY);
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
    // once the previous P.V has retired: O rescaled, P = S (with dropout
    // times its keep factors) rounded to bf16
    auto rescale_pack = [&]() {
      if (Drop::kOn) {
        const int e = soft_c + shift;
        const uint64_t keep = keep_bits<kWN / 8, false>(
            dkey, drop_bh, drop_row0 + r, (LISTED ? list.entries[e].x : e) * kWN + 2 * t);
#pragma unroll
        for (int x = 0; x < 64; ++x) s[x] *= keep_factor(dkey, keep, x);
      }
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
    // this thread's byte of entry e's mask (every key block, unlisted)
    auto mask_of = [&](int e) {
      return LISTED ? ((uint32_t)(&list.entries[e].y)[wg] >> (8 * (warp % 4))) & 0xffu : 0xffu;
    };

    // the consumer warpgroups take turns at the softmax, round robin (named
    // barrier 1 + wg is this warpgroup's turn), so one has the ex2 unit to
    // itself while the others' wgmma run
    auto turn_wait = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
    auto turn_pass = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % L::kConsumers) : "memory");
    };
    if (wg == L::kConsumers - 1) turn_pass();  // warpgroup 0 goes first

    // a tile's stages (its first entry, its count, the first mask) are read
    // a tile ahead, so a list's load latency hides under the tile before
    int e0 = 0, stages = nk;
    uint32_t on = 0xffu;
    auto list_of = [&](int64_t tile) {
      if (LISTED && tile < tiles) {
        const int qt = (int)(tile % n_qtiles);
        e0 = first_of(qt);
        stages = end_of(qt) - e0;
        on = mask_of(e0);
      }
    };
    list_of(blockIdx.x);
    int c = 0, n = 0;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
      const int bh = (int)(tile / n_qtiles);
      const int row0 = (int)(tile % n_qtiles) * L::kRows;
      const int first = e0, count = stages;
      if (Drop::kOn) {
        drop_bh = bh;
        drop_row0 = row0;
        shift = first - c;
      }
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
      softmax(c, on);
      turn_pass();
      rescale_pack();
      // stage c + 1's Q.K^T and stage c's P.V are issued together, and
      // stage c + 1's softmax runs while the P.V does. The loop body has no
      // branch, and the epilogue sits after it (accumulator reads in a
      // branch around the wgmma make ptxas serialize them)
      for (int kk = 1; kk < count; ++kk, ++c) {
        on = mask_of(first + kk);
        mbar_wait(full(c + 1), ring(c + 1));
        qk(qa, c + 1);
        pv(c);
        wgmma_wait<1>();  // the Q.K^T (groups retire in order)
        fence_regs(s);
        turn_wait();
        softmax(c + 1, on);
        turn_pass();
        wgmma_wait<0>();  // the P.V
        fence_regs(o);
        fence_regs(p);
        rescale_pack();
        release(empty(c));
      }
      pv(c);
      list_of(tile + gridDim.x);
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

// three consumer warpgroups (192-row tiles) where their tiles pad len_i no
// more than 128-row ones do and still give every SM one (the crosses, the
// pair passes at L = 384); two otherwise (len_i = 128 or 256, a B3 hop's 80
// tiles), and always with a 2-D bias
inline int wgmma_consumers(int64_t bh, int64_t len_i, int sms, bool bias2d) {
  const int64_t tiles3 = (len_i + 191) / 192;
  const int64_t tiles2 = (len_i + 127) / 128;
  return !bias2d && tiles3 * 192 <= tiles2 * 128 && bh * tiles3 >= sms ? 3 : 2;
}

// the card's SMs (0 on an error, returned in *err)
inline int sm_count(cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// One launch of `kernel` (a __global__ around wgmma_fwd<.., BIAS2D,
// CONSUMERS, ..>) on bf16 q (bh, len_i, 64), k and v (bh, len_j, 64), and
// with BIAS2D an f32 (bh, len_i, len_j) bias: the tensor maps, the shared
// memory, one block an SM; `extra` follows the kernel's own arguments (B5f's
// dropout). Returns the CUDA error code.
template <bool BIAS2D, int CONSUMERS, typename Kernel, typename... Extra>
int launch_wgmma_fwd(Kernel kernel, const void* q, const void* k, const void* v,
                     const void* bias, const __nv_bfloat16* gate, const StageList& list,
                     void* out, void* lse, int64_t bh, int64_t len_i, int64_t len_j,
                     float scale, int sms, cudaStream_t stream, Extra... extra) {
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
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_qtiles = (len_i + L::kRows - 1) / L::kRows;
  const int64_t tiles = bh * n_qtiles;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_bias, (const float*)bias, gate, list, (__nv_bfloat16*)out,
      (float*)lse, (int)len_i, (int)len_j, (int)n_qtiles, tiles, scale * kLog2e, extra...);
  return (int)cudaGetLastError();
}

}  // namespace af2::fwd
