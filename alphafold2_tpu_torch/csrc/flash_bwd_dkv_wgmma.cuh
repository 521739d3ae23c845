// The bf16 attention backward's dk/dv wgmma pipeline for Hopper (sm_90a,
// dh = 64), shared by two kernels:
//   * flash_bwd.cu's wgmma dkv route (B1b, B2b, B3's backward): every
//     64-query stage of len_i, a key-side bias or a 2-D bias box;
//   * sparse_attn.cu's wgmma dkv route (B5 dkv at block size 16): only the
//     query stages a key tile's list names, each with a 16-bit mask a
//     warpgroup of the (key block, query block) pairs it attends
//     (`StageList`, bit 4 kb + qb).
// Each defines its own __global__ kernel (so a profile names the kernel it
// ran) around `wgmma_dkv`, and launches it through `launch_wgmma_dkv`.
//
// Persistent blocks, one per SM, each walking (bh, 128-key tile) tiles
// bh-major, so the key tiles of one head run at once on neighbouring blocks
// and read its Q and dO from L2.
//  - Warp 0 is the producer. For each tile it loads K and V by TMA into one
//    of two buffers (the next tile's land while this tile's dk and dv are
//    stored), then streams 64-query stages through a ring of full and empty
//    mbarriers: Q and dO (3-D tensor maps (dh, n, BH), so a ragged last
//    stage reads zeros inside its own head), with BIAS2D the f32 bias box
//    (64 queries x 128 keys, four 128-byte swizzled boxes of 32 keys), and
//    per query lse (in log2 units, +inf past len_i) and delta (0 past it),
//    written by the warp's 32 lanes.
//  - Each of two consumer warpgroups owns 64 keys and computes the tiles
//    transposed, keys as rows: S^T = K.Q^T and dP^T = V.dO^T are
//    wgmma.m64n64k16 with both operands K-major in shared memory; P^T =
//    2^(s scale log2(e) + bias log2(e) - lse log2(e)) and dS^T = P^T (dP^T -
//    delta) are computed in place in f32 registers (a listed stage's
//    unattended pairs at -inf before the exp2, so their p is an exact 0),
//    rounded to bf16 and repacked from the C fragments into A fragments, the
//    register A operand of dV += P^T.dO and dK += dS^T.Q (wgmma.m64n64k16, dO
//    and Q the MN-major B operand). A 2-D bias element (key, query) is read
//    transposed from the swizzled box; the swizzle spreads a quad's four
//    query rows over distinct banks. The key-side bias is a per-row
//    constant, read once a tile.
//  - Stage c + 1's S^T and dP^T are issued with stage c's dV and dK
//    products, and stage c + 1's elementwise pass runs while those do.
//  - dk (times scale) and dv, cast to bf16, are staged in the warpgroup's
//    half of the tile's K and V buffers (128-byte swizzled, as TMA loaded
//    them) and written by two TMA stores, clipped at len_j; the buffers go
//    back to the producer once the stores have read them. (Written from
//    registers, four bytes of each of eight rows a store instruction, the
//    stores held every warp's next barrier poll behind them.)
// With attention dropout (B5 dkv's, `Dropout<true>`, philox.cuh) the
// elementwise pass draws the forward's keep factors Z (the same bits, from
// the sequence coordinates of each element): P^T Z feeds dV and dS^T = P^T
// (dP^T Z - delta).
// Where its time goes (telemetry/dkv_ablation.py, PERF.md): at L = 256 a
// 64-query stage takes each warpgroup ~1,700 cycles, issue and elementwise
// pass about equal, with the tensor cores ~60% busy; a tile adds ~3,200
// cycles outside its stage loop (its first stage alone, its last products,
// the epilogue). Without a third warpgroup (S^T, dP^T, dK, dV and the
// packed P^T, dS^T take 160 registers a thread) nothing hides them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "philox.cuh"

namespace af2::dkv {

constexpr int kWKeys = 128;                       // keys a tile: two warpgroups of 64
constexpr int kWQ = 64;                           // queries a stage
constexpr int kWDH = 64;                          // the head width of the route: 128-byte rows
constexpr int kKVTile = kWKeys * kWDH * 2;        // 16 KB, K or V of a tile
constexpr int kQStage = kWQ * kWDH * 2;           // 8 KB, Q or dO of a stage
constexpr int kBiasBox = 32;                      // keys of a 2-D bias box: 128-byte rows
constexpr int kBiasBoxBytes = kWQ * kBiasBox * 4;  // 8 KB
constexpr int kMNLbo = 8192;  // an MN-major B's descriptor: the stride of 64-column chunks (one)
constexpr float kLog2e = 1.4426950408889634f;

// a block: warpgroup 0 holds the producer warp, two consumer warpgroups own
// 64 keys each. Its shared memory: two K/V buffers, the ring's stages (Q,
// dO, and with BIAS2D the 2-D bias box), the stages' lse and delta, the
// barriers
template <bool BIAS2D>
struct DkvTile {
  static constexpr int kConsumers = kWKeys / 64;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerWarps = 4 * kConsumers;
  // setmaxnreg: warpgroup 0 gives registers to the consumers' S^T, dP^T,
  // dK, dV and the packed P^T and dS^T
  static constexpr int kLightRegs = 56;
  static constexpr int kConsumerRegs = 224;
  static_assert(128 * kLightRegs + 128 * kConsumers * kConsumerRegs <= 65536, "registers");
  static constexpr int kKV = 2 * kKVTile;
  static constexpr int kStages = BIAS2D ? 3 : 4;
  static constexpr int kStage = 2 * kQStage + (BIAS2D ? (kWKeys / kBiasBox) * kBiasBoxBytes : 0);
  static constexpr int kRing = 2 * kKV;
  static constexpr int kScalars = kRing + kStages * kStage;
  static constexpr int kBars = kScalars + kStages * 2 * kWQ * 4;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 4) + 1024;  // + alignment
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

template <bool BIAS2D, bool LISTED, class Drop = Dropout<false>>
__device__ __forceinline__ void wgmma_dkv(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                          const CUtensorMap& tm_v, const CUtensorMap& tm_g,
                                          const CUtensorMap& tm_bias,  // BIAS2D only
                                          const CUtensorMap& tm_dk, const CUtensorMap& tm_dv,
                                          const float* __restrict__ key_bias,  // !BIAS2D
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, const StageList list,
                                          int len_i, int len_j, int n_ktiles, int64_t tiles,
                                          float scale, float scale_log2,
                                          const Drop drop = Drop{}) {
  static_assert(!(LISTED && BIAS2D), "a listed tile reads the key-side bias");
  using L = DkvTile<BIAS2D>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  uint8_t* const smem = smem_raw + (base - raw);
  float* const scalars = reinterpret_cast<float*>(smem + L::kScalars);
  const uint32_t bars = base + L::kBars;
  auto full = [&](int c) { return bars + 8 * (c % S); };               // stage c landed
  auto empty = [&](int c) { return bars + 8 * (S + c % S); };          // stage c read
  auto kvfull = [&](int n) { return bars + 8 * (2 * S + (n & 1)); };   // tile n's K/V landed
  auto kvempty = [&](int n) { return bars + 8 * (2 * S + 2 + (n & 1)); };  // and read
  // the phase parity a wait expects (empty slots: the previous round's,
  // which a fresh barrier counts as completed)
  auto ring = [](int c) { return (uint32_t)((c / S) & 1); };
  auto kvring = [](int n) { return (uint32_t)((n >> 1) & 1); };
  auto stage = [&](int c) { return (uint32_t)(L::kRing + (c % S) * L::kStage); };  // offset
  // the entries of key tile kt's query stages: [first, end)
  const int nq = (len_i + kWQ - 1) / kWQ;
  auto first_of = [&](int kt) { return LISTED ? list.offsets[kt] : 0; };
  auto end_of = [&](int kt) { return LISTED ? list.offsets[kt + 1] : nq; };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes, and the TMA bytes
      mbar_init(empty(s), L::kConsumerWarps);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(kvfull(b), 1);
      mbar_init(kvempty(b), L::kConsumers);  // each warpgroup's storing thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kLightRegs));
    if (warp == 0) {
      // the producer: chunk c is the c-th query stage of the block's tile
      // sequence
      int c = 0, n = 0;
      for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        const int bh = (int)(tile / n_ktiles);
        const int kt = (int)(tile % n_ktiles);
        const int k0 = kt * kWKeys;
        if (lane == 0) {
          const uint32_t kv = base + (n & 1) * L::kKV;
          mbar_wait(kvempty(n), kvring(n) ^ 1);
          mbar_expect_tx(kvfull(n), L::kKV);
          tma_load_3d(kv, &tm_k, kvfull(n), 0, k0, bh);
          tma_load_3d(kv + kKVTile, &tm_v, kvfull(n), 0, k0, bh);
        }
        const int e1 = end_of(kt);
        for (int e = first_of(kt); e < e1; ++e, ++c) {
          const int q0 = (LISTED ? list.entries[e].x : e) * kWQ;
          mbar_wait(empty(c), ring(c) ^ 1);
          float* sc = scalars + (c % S) * 2 * kWQ;
#pragma unroll
          for (int x = 0; x < kWQ / 32; ++x) {
            // queries past the end: lse = +inf makes their p an exact 0
            const int row = q0 + 32 * x + lane;
            const int64_t at = (int64_t)bh * len_i + row;
            sc[32 * x + lane] = row < len_i ? lse[at] * kLog2e : INFINITY;
            sc[kWQ + 32 * x + lane] = row < len_i ? delta[at] : 0.f;
          }
          const uint32_t st = base + stage(c);
          if (lane == 0) {
            mbar_expect_tx(full(c), L::kStage);
            tma_load_3d(st, &tm_q, full(c), 0, q0, bh);
            tma_load_3d(st + kQStage, &tm_g, full(c), 0, q0, bh);
            if (BIAS2D) {
#pragma unroll
              for (int b = 0; b < kWKeys / kBiasBox; ++b) {
                tma_load_3d(st + 2 * kQStage + b * kBiasBoxBytes, &tm_bias, full(c),
                            k0 + b * kBiasBox, q0, bh);
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
    // warpgroup wg owns the tile's keys 64 wg .. 64 wg + 63; a thread holds
    // keys r and r + 8 (wgmma's accumulator layout: per 8 query columns j,
    // s[4j], s[4j + 1] are key r, queries 8j + 2t, 8j + 2t + 1; s[4j + 2],
    // s[4j + 3] key r + 8), both in key block 4 wg + warp % 4 of 16 keys,
    // whose nibble of a listed stage's mask is at bit 4 (warp % 4)
    const int wg = warp / 4 - 1;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r = 64 * wg + 16 * (warp % 4) + g;
    float s[32], dp[32], dk_acc[32], dv_acc[32];
    uint32_t pa[16], da[16];
    // attention dropout: the key, the tile's head and first key, the shift
    // from a chunk c of the tile to its entry (c + shift)
    const DropKey dkey = drop_key(drop);
    int drop_bh = 0, drop_k0 = 0, shift = 0;
    // with BIAS2D: the byte offset in a stage's bias boxes of (key r + 8h,
    // query 2t + e); query 8j + 2t + e lies 1024 j bytes further. Box r / 32,
    // row = the query, 16-byte chunk (key % 32) / 4 swizzled with row % 8
    int boff[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = r + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 2 * t + e;
        boff[h][e] = (key / kBiasBox) * kBiasBoxBytes + row * 128 +
                     ((((key % kBiasBox) / 4) ^ row) << 4) + (key % 4) * 4;
      }
    }
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S^T = K.Q^T and dP^T = V.dO^T of stage c, issued as one group
    auto sdp = [&](uint32_t kv, int c) {
      const uint32_t ka = kv + wg * (64 * kWDH * 2);
      const uint32_t qa = base + stage(c);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWDH / 16; ++ks) {
        wgmma_m64n64k16_ss(s, gmma_desc(ka + 32 * ks, 16, 1024), gmma_desc(qa + 32 * ks, 16, 1024),
                           ks);
      }
#pragma unroll
      for (int ks = 0; ks < kWDH / 16; ++ks) {
        wgmma_m64n64k16_ss(dp, gmma_desc(ka + kKVTile + 32 * ks, 16, 1024),
                           gmma_desc(qa + kQStage + 32 * ks, 16, 1024), ks);
      }
      wgmma_commit();
    };
    // stage c's elementwise pass, in place: s <- P^T, dp <- dS^T (f32), with
    // dropout s <- P^T Z and dp <- P^T (dP^T Z - delta). Listed, query block
    // j / 2 of the stage is at -inf unless bit j / 2 of `on` is set
    float kb[2];  // the tile's key bias of keys r, r + 8, log2 units
    auto elementwise = [&](int c, uint32_t on) {
      const float* sc = scalars + (c % S) * 2 * kWQ;
      const uint8_t* b2 = smem + stage(c) + 2 * kQStage;
      uint64_t keep = 0;
      if (Drop::kOn) {
        const int e = c + shift;
        keep = keep_bits<kWQ / 8, true>(dkey, drop_bh, drop_k0 + r,
                                        (LISTED ? list.entries[e].x : e) * kWQ + 2 * t);
      }
#pragma unroll
      for (int j = 0; j < kWQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(sc + kWQ + 8 * j + 2 * t);
        const bool live = !LISTED || ((on >> (j / 2)) & 1u);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * h + e;
            float b = live ? kb[h] : -INFINITY;
            if (BIAS2D) {
              b = fmaf(*reinterpret_cast<const float*>(b2 + boff[h][e] + 1024 * j), kLog2e, b);
            }
            const float p = ex2(fmaf(s[x], scale_log2, b) - (e ? l2.y : l2.x));
            const float z = Drop::kOn ? keep_factor(dkey, keep, x) : 1.f;
            s[x] = Drop::kOn ? p * z : p;
            dp[x] = p * ((Drop::kOn ? dp[x] * z : dp[x]) - (e ? dl.y : dl.x));
          }
        }
      }
    };
    // P^T and dS^T rounded to bf16: per 16 queries ks, the A fragments
    // pa[4 ks .. 4 ks + 3], da[...] (the C fragments of columns 16 ks ..
    // 16 ks + 15)
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < kWQ / 8; ++j) {
        pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
        da[2 * j] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
        da[2 * j + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
      }
    };
    // dV += P^T.dO and dK += dS^T.Q of stage c, issued as one group
    auto dkv = [&](int c) {
      const uint32_t qa = base + stage(c);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWQ / 16; ++ks) {
        wgmma_m64n64k16_rs_mn(dv_acc, &pa[4 * ks], gmma_desc(qa + kQStage + 2048 * ks, kMNLbo, 1024));
      }
#pragma unroll
      for (int ks = 0; ks < kWQ / 16; ++ks) {
        wgmma_m64n64k16_rs_mn(dk_acc, &da[4 * ks], gmma_desc(qa + 2048 * ks, kMNLbo, 1024));
      }
      wgmma_commit();
    };
    // this thread's nibble of entry e's mask (every query block, unlisted)
    auto mask_of = [&](int e) {
      return LISTED ? ((uint32_t)(&list.entries[e].y)[wg] >> (4 * (warp % 4))) & 0xfu : 0xfu;
    };

    // a tile's stages (its first entry, its count, the first mask) are read
    // a tile ahead, so a list's load latency hides under the tile before
    int e0 = 0, stages = nq;
    uint32_t on = 0xfu;
    auto list_of = [&](int64_t tile) {
      if (LISTED && tile < tiles) {
        const int kt = (int)(tile % n_ktiles);
        e0 = first_of(kt);
        stages = end_of(kt) - e0;
        on = mask_of(e0);
      }
    };
    list_of(blockIdx.x);
    int c = 0, n = 0;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
      const int bh = (int)(tile / n_ktiles);
      const int k0 = (int)(tile % n_ktiles) * kWKeys;
      const int first = e0, count = stages;
      if (Drop::kOn) {
        drop_bh = bh;
        drop_k0 = k0;
        shift = first - c;
      }
      const float* const bias_row = key_bias + (int64_t)(LISTED ? bh / list.bias_heads : bh) * len_j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + r + 8 * h;
        kb[h] = -INFINITY;
        if (key < len_j) kb[h] = BIAS2D ? 0.f : bias_row[key] * kLog2e;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      const uint32_t kv = base + (n & 1) * L::kKV;
      mbar_wait(kvfull(n), kvring(n));
      mbar_wait(full(c), ring(c));
      sdp(kv, c);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      elementwise(c, on);
      pack();
      // stage c + 1's S^T and dP^T are issued with stage c's dV and dK, and
      // stage c + 1's elementwise pass runs while those do. The loop body
      // has no branch, and the epilogue sits after it (accumulator reads in
      // a branch around the wgmma make ptxas serialize them)
      for (int qq = 1; qq < count; ++qq, ++c) {
        on = mask_of(first + qq);
        mbar_wait(full(c + 1), ring(c + 1));
        sdp(kv, c + 1);
        dkv(c);
        wgmma_wait<1>();  // the S^T and dP^T (groups retire in order)
        fence_regs(s);
        fence_regs(dp);
        elementwise(c + 1, on);
        wgmma_wait<0>();  // the dV and dK
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        fence_regs(pa);
        fence_regs(da);
        pack();
        release(empty(c));
      }
      dkv(c);
      list_of(tile + gridDim.x);
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(da);
      release(empty(c));
      ++c;

      // epilogue: keys r, r + 8 of the tile, columns 8j + 2t (+1), staged in
      // the warpgroup's rows of the K and V buffers (its own; their last
      // reader, this tile's last S^T and dP^T, has retired): row w of 128
      // bytes, 16-byte chunk j swizzled with w % 8 = g
      uint8_t* const kst = smem + (n & 1) * L::kKV + wg * (64 * kWDH * 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * (warp % 4) + g + 8 * h;
#pragma unroll
        for (int j = 0; j < kWDH / 8; ++j) {
          const int at = row * 128 + ((j ^ g) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(kst + at) =
              pack_bf16(dk_acc[4 * j + 2 * h] * scale, dk_acc[4 * j + 2 * h + 1] * scale);
          *reinterpret_cast<uint32_t*>(kst + kKVTile + at) =
              pack_bf16(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
        }
      }
      fence_async_smem();
      warpgroup_sync(1 + wg);
      if (threadIdx.x % 128 == 0) {
        const uint32_t st = smem_u32(kst);
        if (k0 + 64 * wg < len_j) {
          tma_store_3d(&tm_dk, st, 0, k0 + 64 * wg, bh);
          tma_store_3d(&tm_dv, st + kKVTile, 0, k0 + 64 * wg, bh);
        }
        // the stores have read the buffers: the producer may refill them
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(kvempty(n));
      }
    }
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// One launch of `kernel` (a __global__ around wgmma_dkv<BIAS2D, ..>) on bf16
// q, dout (bh, len_i, 64), k, v, dk, dv (bh, len_j, 64), f32 lse and delta
// (bh, len_i), and the key-side bias (rows of len_j) or with BIAS2D an f32
// (bh, len_i, len_j) bias: the tensor maps, the shared memory, one block an
// SM; `extra` follows the kernel's own arguments (B5 dkv's dropout). Returns
// the CUDA error code.
template <bool BIAS2D, typename Kernel, typename... Extra>
int launch_wgmma_dkv(Kernel kernel, const void* q, const void* k, const void* v, const void* bias,
                     const void* dout, const void* lse, const void* delta, const StageList& list,
                     void* dk, void* dv, int64_t bh, int64_t len_i, int64_t len_j, float scale,
                     cudaStream_t stream, Extra... extra) {
  using L = DkvTile<BIAS2D>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_g, tm_bias, tm_dk, tm_dv;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_3d(encode, &tm_q, bf16, q, kWDH, len_i, bh, 2, kWDH, kWQ) ||
      !encode_3d(encode, &tm_g, bf16, dout, kWDH, len_i, bh, 2, kWDH, kWQ) ||
      !encode_3d(encode, &tm_k, bf16, k, kWDH, len_j, bh, 2, kWDH, kWKeys) ||
      !encode_3d(encode, &tm_v, bf16, v, kWDH, len_j, bh, 2, kWDH, kWKeys) ||
      !encode_3d(encode, &tm_dk, bf16, dk, kWDH, len_j, bh, 2, kWDH, 64) ||
      !encode_3d(encode, &tm_dv, bf16, dv, kWDH, len_j, bh, 2, kWDH, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  tm_bias = tm_k;  // unread without a 2-D bias
  if (BIAS2D && !encode_3d(encode, &tm_bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, bias, len_j,
                           len_i, bh, 4, kBiasBox, kWQ)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  }
  if (e != cudaSuccess) return (int)e;
  const int64_t n_ktiles = (len_j + kWKeys - 1) / kWKeys;
  const int64_t tiles = bh * n_ktiles;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_g, tm_bias, tm_dk, tm_dv, (const float*)bias, (const float*)lse,
      (const float*)delta, list, (int)len_i, (int)len_j, (int)n_ktiles, tiles, scale,
      scale * kLog2e, extra...);
  return (int)cudaGetLastError();
}

}  // namespace af2::dkv
