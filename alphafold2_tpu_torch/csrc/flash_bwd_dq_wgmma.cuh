// The bf16 attention backward's dq wgmma pipeline for Hopper (sm_90a, dh =
// 64). sparse_attn.cu's wgmma dq route (B5 dq at block size 16) walks the
// 128-key stages a query tile's list names (`StageList`, the block-sparse
// forward's lists: a 32-bit mask a warpgroup, bit 8 qb + kb); unlisted, it
// walks every stage of len_j (flash_bwd.cu's dense dq kernel: B1b, B2b and
// B3's dq). A kernel defines its own __global__ (so a profile names the
// kernel it ran) around `wgmma_dq`, and launches it through
// `launch_wgmma_dq`.
//
// What it computes (the dq kernels' contract): per (query, key) p =
// 2^(s scale log2(e) + bias log2(e) - lse log2(e)), dp = dO.v, dS = p (dp -
// delta) rounded to bf16, and dq = scale sum_keys dS k; a row whose lse is
// +inf (no unmasked key) gets p = 0 and dq = 0. With a 2-D (BH, i, j) bias
// (BIAS2D, unlisted only) also d_bias = dS in f32, unrounded.
//
// Persistent blocks, one per SM, each walking (bh, 128-query tile) tiles.
//  - Warp 0 is the producer. For each tile it loads the Q and dO tiles by
//    TMA into one of two buffers (the next tile's land while this tile's dq
//    is stored), then streams 128-key stages of K and V through a ring of
//    full and empty mbarriers (3-D tensor maps (dh, n, BH), so a ragged last
//    stage reads zeros inside its own head), and the stage's key bias in
//    log2 units, -inf past len_j, written by the warp's 32 lanes. With
//    BIAS2D (0 for every key below len_j then) the stage also carries the
//    tile's 128 x 128 f32 bias as four 32-key boxes of 128-byte rows,
//    swizzled (element (row, key) at 16-byte chunk ((key % 32) / 4) ^ (row
//    % 8) of its row: a quad's rows land on distinct banks).
//  - Each of two consumer warpgroups owns 64 query rows and takes a stage as
//    two 64-key halves: S = Q.K^T and dP = dO.V^T are wgmma.m64n64k16 with
//    both operands K-major in shared memory; P and dS are computed in place
//    in f32 registers (a listed stage's unattended key blocks at -inf before
//    the exp2, so their p is an exact 0), dS is rounded to bf16 and repacked
//    from the C fragments into A fragments, the register A operand of dQ +=
//    dS.K (wgmma.m64n64k16, K the MN-major B operand, as V is in the
//    forward's P.V).
//  - Half x + 1's S and dP are issued with half x's dS.K, and half x + 1's
//    elementwise pass runs while that product does.
//  - With BIAS2D the elementwise pass writes dS (f32) in place over the
//    bias it read, and after a stage's second half the warpgroup's rows of
//    the four boxes leave as d_bias by TMA stores (clipped at len_i and
//    len_j); the storing thread releases the slot only once they have read
//    it (scattered 4-byte stores from registers stall the warps' next
//    barrier polls).
//  - dq (times scale), cast to bf16, is staged in the warpgroup's rows of the
//    tile's Q buffer (128-byte swizzled, as TMA loaded it) and written by a
//    TMA store, clipped at len_i; the buffer goes back to the producer once
//    the store has read it. No atomics: a tile's rows have one writer.
// Shared memory (`DqTile`): two Q/dO buffers (64 KB) and four K/V stages
// (128 KB); with BIAS2D a 64 KB bias a stage leaves room for one Q/dO buffer
// (32 KB) and two stages of 96 KB, and the producer loads a tile's Q/dO
// after its first stage, so the next tile's first stage streams in while
// this tile's dq is stored.
// With attention dropout (B5 dq's, `Dropout<true>`, philox.cuh) dP is
// multiplied by the forward's keep factors before dS = P (dP - delta): the
// same bits, drawn from the sequence coordinates of each element.
// Registers: S, dP, dQ (32 f32 each) and the packed dS (16) a thread; a
// whole 128-key stage in registers (S and dP 64 each) would not leave the
// overlap room under the 224 a consumer thread gets.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "philox.cuh"

namespace af2::dq {

constexpr int kWN = 128;                     // keys a stage
constexpr int kWHalf = 64;                   // keys a half: the N of S and dP, the K of dS.K
constexpr int kWRows = 128;                  // query rows a tile: two warpgroups of 64
constexpr int kWDH = 64;                     // the head width of the route: 128-byte rows
constexpr int kKVStage = kWN * kWDH * 2;     // 16 KB, K or V of a stage
constexpr int kQTile = kWRows * kWDH * 2;    // 16 KB, Q or dO of a tile
constexpr int kHalfBytes = kWHalf * kWDH * 2;  // 8 KB: 64 rows of K, V, Q or dO
constexpr int kMNLbo = 8192;  // an MN-major B's descriptor: the stride of 64-column chunks (one)
constexpr int kBiasBox = 32;                         // keys of a 2-D bias box: 128-byte rows
constexpr int kBiasBoxBytes = kWRows * kBiasBox * 4;  // 16 KB: the tile's rows
constexpr float kLog2e = 1.4426950408889634f;

// a block: warpgroup 0 holds the producer warp, two consumer warpgroups own
// 64 query rows each. Its shared memory: the Q/dO buffers, the ring's
// stages (K, V, and with BIAS2D the bias boxes), the stages' key bias, the
// barriers
template <bool BIAS2D>
struct DqTile {
  static constexpr int kConsumers = kWRows / 64;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerWarps = 4 * kConsumers;
  // setmaxnreg: warpgroup 0 gives registers to the consumers' S, dP, dQ and
  // the packed dS
  static constexpr int kLightRegs = 56;
  static constexpr int kConsumerRegs = 224;
  static_assert(128 * kLightRegs + 128 * kConsumers * kConsumerRegs <= 65536, "registers");
  static constexpr int kQG = 2 * kQTile;  // Q and dO of a tile
  static constexpr int kQBufs = BIAS2D ? 1 : 2;
  static constexpr int kStages = BIAS2D ? 2 : 4;
  static constexpr int kStage = 2 * kKVStage + (BIAS2D ? (kWN / kBiasBox) * kBiasBoxBytes : 0);
  static constexpr int kRing = kQBufs * kQG;
  static constexpr int kKeyBias = kRing + kStages * kStage;
  static constexpr int kBars = kKeyBias + kStages * kWN * 4;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 4) + 1024;  // + alignment
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

template <bool BIAS2D, bool LISTED, class Drop = Dropout<false>>
__device__ __forceinline__ void wgmma_dq(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                         const CUtensorMap& tm_v, const CUtensorMap& tm_g,
                                         const CUtensorMap& tm_bias,   // BIAS2D only
                                         const CUtensorMap& tm_dbias,  // BIAS2D only
                                         const CUtensorMap& tm_dq,
                                         const float* __restrict__ key_bias,  // !BIAS2D
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, const StageList list,
                                         int len_i, int len_j, int n_qtiles, int64_t tiles,
                                         float scale, float scale_log2,
                                         const Drop drop = Drop{}) {
  static_assert(!(LISTED && BIAS2D), "a listed tile reads the key-side bias");
  using L = DqTile<BIAS2D>;
  constexpr int S = L::kStages;
  constexpr int QB = L::kQBufs;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  uint8_t* const smem = smem_raw + (base - raw);
  float* const kbias = reinterpret_cast<float*>(smem + L::kKeyBias);
  const uint32_t bars = base + L::kBars;
  auto full = [&](int c) { return bars + 8 * (c % S); };             // stage c landed
  auto empty = [&](int c) { return bars + 8 * (S + c % S); };        // stage c read
  auto qfull = [&](int n) { return bars + 8 * (2 * S + n % QB); };  // tile n's Q, dO landed
  auto qempty = [&](int n) { return bars + 8 * (2 * S + 2 + n % QB); };  // and stored from
  // the phase parity a wait expects (empty slots: the previous round's,
  // which a fresh barrier counts as completed)
  auto ring = [](int c) { return (uint32_t)((c / S) & 1); };
  auto qring = [](int n) { return (uint32_t)((n / QB) & 1); };
  auto stage = [&](int c) { return (uint32_t)(L::kRing + (c % S) * L::kStage); };  // offset
  // the entries of query tile qt's key stages: [first, end)
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
    for (int b = 0; b < QB; ++b) {
      mbar_init(qfull(b), 1);
      mbar_init(qempty(b), L::kConsumers);  // each warpgroup's storing thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kLightRegs));
    if (warp == 0) {
      // the producer: chunk c is the c-th key stage of the block's tile
      // sequence
      int c = 0, n = 0;
      for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        const int bh = (int)(tile / n_qtiles);
        const int qt = (int)(tile % n_qtiles);
        const int row0 = qt * kWRows;
        const float* const bias_row =
            key_bias + (int64_t)(LISTED ? bh / list.bias_heads : bh) * len_j;
        auto load_q = [&]() {
          if (lane == 0) {
            const uint32_t qg = base + (n % QB) * L::kQG;
            mbar_wait(qempty(n), qring(n) ^ 1);
            mbar_expect_tx(qfull(n), L::kQG);
            tma_load_3d(qg, &tm_q, qfull(n), 0, row0, bh);
            tma_load_3d(qg + kQTile, &tm_g, qfull(n), 0, row0, bh);
          }
        };
        if (!BIAS2D) load_q();
        const int e0 = first_of(qt), e1 = end_of(qt);
        for (int e = e0; e < e1; ++e, ++c) {
          const int k0 = (LISTED ? list.entries[e].x : e) * kWN;
          mbar_wait(empty(c), ring(c) ^ 1);
          float* kb = kbias + (c % S) * kWN;
#pragma unroll
          for (int x = 0; x < kWN / 32; ++x) {
            const int key = k0 + 32 * x + lane;
            kb[32 * x + lane] = key < len_j ? (BIAS2D ? 0.f : bias_row[key] * kLog2e) : -INFINITY;
          }
          const uint32_t st = base + stage(c);
          if (lane == 0) {
            mbar_expect_tx(full(c), L::kStage);
            tma_load_3d(st, &tm_k, full(c), 0, k0, bh);
            tma_load_3d(st + kKVStage, &tm_v, full(c), 0, k0, bh);
            if (BIAS2D) {
#pragma unroll
              for (int b = 0; b < kWN / kBiasBox; ++b) {
                tma_load_3d(st + 2 * kKVStage + b * kBiasBoxBytes, &tm_bias, full(c),
                            k0 + b * kBiasBox, row0, bh);
              }
            }
          } else {
            mbar_arrive(full(c));
          }
          if (BIAS2D && e == e0) load_q();  // after the first stage: see the header
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kConsumerRegs));
    // warpgroup wg owns the tile's rows 64 wg .. 64 wg + 63; a thread holds
    // rows r and r + 8 (wgmma's accumulator layout: per 8 key columns j,
    // s[4j], s[4j + 1] are row r, keys 8j + 2t, 8j + 2t + 1 of the half;
    // s[4j + 2], s[4j + 3] row r + 8), both in query block 4 wg + warp % 4
    // of 16 rows, whose byte of a listed stage's mask is at bit 8 (warp % 4)
    const int wg = warp / 4 - 1;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r = 64 * wg + 16 * (warp % 4) + g;
    float s[32], dp[32], dq_acc[32];
    uint32_t da[16];
    float l2[2], dl[2];  // the rows' lse in log2 units (+inf past len_i) and delta
    // attention dropout: the key, the tile's head and first row, the shift
    // from a chunk c of the tile to its entry (c + shift)
    const DropKey dkey = drop_key(drop);
    int drop_bh = 0, drop_row0 = 0, shift = 0;
    // a warp is done with a stage or a Q buffer; with BIAS2D the storing
    // thread of a warpgroup first waits until its d_bias stores have read
    // the stage's boxes
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) {
        if (BIAS2D && warp % 4 == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(bar);
      }
    };
    // S = Q.K^T and dP = dO.V^T of half h of stage c, issued as one group
    auto sdp = [&](uint32_t qa, int c, int h) {
      const uint32_t ka = base + stage(c) + h * kHalfBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWDH / 16; ++ks) {
        wgmma_m64n64k16_ss(s, gmma_desc(qa + 32 * ks, 16, 1024), gmma_desc(ka + 32 * ks, 16, 1024),
                           ks);
      }
#pragma unroll
      for (int ks = 0; ks < kWDH / 16; ++ks) {
        wgmma_m64n64k16_ss(dp, gmma_desc(qa + kQTile + 32 * ks, 16, 1024),
                           gmma_desc(ka + kKVStage + 32 * ks, 16, 1024), ks);
      }
      wgmma_commit();
    };
    // half h of stage c's elementwise pass, in place: dp <- dS (f32), with
    // dropout dp times its keep factors first. Listed, key block 4h + j / 2
    // of the stage is at -inf unless its bit of `on` is set. With BIAS2D the 2-D bias of keys 8j + 2t (+1) of the half,
    // rows r and r + 8, is read from box 2h + j / 4, 16-byte chunk (2 (j %
    // 4) + t / 2) ^ g (row % 8 = g), and dS goes back in its place
    uint8_t* const brows = smem + r * 128 + (t % 2) * 8;
    auto elementwise = [&](int c, int h, uint32_t on) {
      const float* kb = kbias + (c % S) * kWN + h * kWHalf;
      uint8_t* const bb = brows + stage(c) + 2 * kKVStage + 2 * h * kBiasBoxBytes;
      uint64_t keep = 0;
      if (Drop::kOn) {
        const int e = c + shift;
        keep = keep_bits<kWHalf / 8, false>(
            dkey, drop_bh, drop_row0 + r, (LISTED ? list.entries[e].x : e) * kWN + h * kWHalf + 2 * t);
      }
#pragma unroll
      for (int j = 0; j < kWHalf / 8; ++j) {
        float2 kv = *reinterpret_cast<const float2*>(kb + 8 * j + 2 * t);
        const bool live = !LISTED || ((on >> (4 * h + j / 2)) & 1u);
        if (!live) kv = make_float2(-INFINITY, -INFINITY);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2* const at = reinterpret_cast<float2*>(
              bb + (j / 4) * kBiasBoxBytes + hh * 8 * 128 + (((2 * (j % 4) + t / 2) ^ g) << 4));
          float2 b = kv;
          if (BIAS2D) {
            const float2 pair = *at;
            b = make_float2(fmaf(pair.x, kLog2e, kv.x), fmaf(pair.y, kLog2e, kv.y));
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hh + e;
            const float p = ex2(fmaf(s[x], scale_log2, e ? b.y : b.x) - l2[hh]);
            const float dpx = Drop::kOn ? dp[x] * keep_factor(dkey, keep, x) : dp[x];
            dp[x] = p * (dpx - dl[hh]);
          }
          if (BIAS2D) *at = make_float2(dp[4 * j + 2 * hh], dp[4 * j + 2 * hh + 1]);
        }
      }
    };
    // dS rounded to bf16: per 16 keys ks, the A fragment da[4 ks .. 4 ks +
    // 3] (the C fragments of columns 16 ks .. 16 ks + 15)
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < kWHalf / 8; ++j) {
        da[2 * j] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
        da[2 * j + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
      }
    };
    // dQ += dS.K of half h of stage c, issued as one group: keys 16 ks ..
    // 16 ks + 15 of the half are 2048 bytes of K rows
    auto dsk = [&](int c, int h) {
      const uint32_t ka = base + stage(c) + h * kHalfBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWHalf / 16; ++ks) {
        wgmma_m64n64k16_rs_mn(dq_acc, &da[4 * ks], gmma_desc(ka + 2048 * ks, kMNLbo, 1024));
      }
      wgmma_commit();
    };
    // this thread's byte of entry e's mask (every key block, unlisted)
    auto mask_of = [&](int e) {
      return LISTED ? ((uint32_t)(&list.entries[e].y)[wg] >> (8 * (warp % 4))) & 0xffu : 0xffu;
    };

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
      const int row0 = (int)(tile % n_qtiles) * kWRows;
      const int first = e0, count = stages;
      if (Drop::kOn) {
        drop_bh = bh;
        drop_row0 = row0;
        shift = first - c;
      }
      // with BIAS2D, d_bias of stage c (the tile's kk-th, unlisted): after
      // every thread's elementwise writes, the warpgroup's rows of its four
      // boxes by TMA stores, one bulk group each of its first thread
      auto store_bias = [&](int c, int kk) {
        if (BIAS2D) {
          fence_async_smem();
          warpgroup_sync(1 + wg);
          if (threadIdx.x % 128 == 0 && row0 + 64 * wg < len_i) {
            const uint32_t bb = base + stage(c) + 2 * kKVStage + wg * (kBiasBoxBytes / 2);
#pragma unroll
            for (int b = 0; b < kWN / kBiasBox; ++b) {
              tma_store_3d(&tm_dbias, bb + b * kBiasBoxBytes, (first + kk) * kWN + b * kBiasBox,
                           row0 + 64 * wg, bh);
            }
          }
        }
      };
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + r + 8 * hh;
        const int64_t at = (int64_t)bh * len_i + row;
        l2[hh] = row < len_i ? lse[at] * kLog2e : INFINITY;  // rows past the end: p = 0
        dl[hh] = row < len_i ? delta[at] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
      const uint32_t qa = base + (n % QB) * L::kQG + wg * kHalfBytes;
      mbar_wait(qfull(n), qring(n));
      mbar_wait(full(c), ring(c));
      sdp(qa, c, 0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      elementwise(c, 0, on);
      pack();
      sdp(qa, c, 1);
      dsk(c, 0);
      wgmma_wait<1>();  // the S and dP (groups retire in order)
      fence_regs(s);
      fence_regs(dp);
      elementwise(c, 1, on);
      store_bias(c, 0);
      wgmma_wait<0>();  // the dS.K
      fence_regs(dq_acc);
      fence_regs(da);
      pack();
      // half x + 1's S and dP are issued with half x's dS.K, and half x +
      // 1's elementwise pass runs while that product does. The loop body
      // has no branch, and the epilogue sits after it (accumulator reads in
      // a branch around the wgmma make ptxas serialize them)
      for (int kk = 1; kk < count; ++kk, ++c) {
        on = mask_of(first + kk);
        mbar_wait(full(c + 1), ring(c + 1));
        sdp(qa, c + 1, 0);
        dsk(c, 1);
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        elementwise(c + 1, 0, on);
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_regs(da);
        pack();
        release(empty(c));
        sdp(qa, c + 1, 1);
        dsk(c + 1, 0);
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        elementwise(c + 1, 1, on);
        store_bias(c + 1, kk);
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_regs(da);
        pack();
      }
      dsk(c, 1);
      list_of(tile + gridDim.x);
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(da);
      release(empty(c));
      ++c;

      // epilogue: rows r, r + 8 of the tile, columns 8j + 2t (+1), staged in
      // the warpgroup's rows of the Q buffer (its own; their last reader,
      // this tile's last S, has retired): row w of 128 bytes, 16-byte chunk j
      // swizzled with w % 8 = g
      uint8_t* const qst = smem + (n % QB) * L::kQG + wg * kHalfBytes;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * (warp % 4) + g + 8 * hh;
#pragma unroll
        for (int j = 0; j < kWDH / 8; ++j) {
          *reinterpret_cast<uint32_t*>(qst + row * 128 + ((j ^ g) << 4) + 4 * t) =
              pack_bf16(dq_acc[4 * j + 2 * hh] * scale, dq_acc[4 * j + 2 * hh + 1] * scale);
        }
      }
      fence_async_smem();
      warpgroup_sync(1 + wg);
      if (threadIdx.x % 128 == 0) {
        if (row0 + 64 * wg < len_i) tma_store_3d(&tm_dq, smem_u32(qst), 0, row0 + 64 * wg, bh);
        // the store has read the buffer: the producer may refill it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(qempty(n));
      }
    }
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// One launch of `kernel` (a __global__ around wgmma_dq<BIAS2D, ..>) on bf16
// q, dout, dq (bh, len_i, 64), k, v (bh, len_j, 64), f32 lse and delta (bh,
// len_i), and the key-side bias (rows of len_j) or with BIAS2D an f32 (bh,
// len_i, len_j) bias and its d_bias: the tensor maps, the shared memory, one
// block an SM; `extra` follows the kernel's own arguments (B5 dq's dropout).
// Returns the CUDA error code.
template <bool BIAS2D, typename Kernel, typename... Extra>
int launch_wgmma_dq(Kernel kernel, const void* q, const void* k, const void* v, const void* bias,
                    const void* dout, const void* lse, const void* delta, const StageList& list,
                    void* dq, void* dbias, int64_t bh, int64_t len_i, int64_t len_j, float scale,
                    cudaStream_t stream, Extra... extra) {
  using L = DqTile<BIAS2D>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_g, tm_bias, tm_dbias, tm_dq;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!encode_3d(encode, &tm_q, bf16, q, kWDH, len_i, bh, 2, kWDH, kWRows) ||
      !encode_3d(encode, &tm_g, bf16, dout, kWDH, len_i, bh, 2, kWDH, kWRows) ||
      !encode_3d(encode, &tm_k, bf16, k, kWDH, len_j, bh, 2, kWDH, kWN) ||
      !encode_3d(encode, &tm_v, bf16, v, kWDH, len_j, bh, 2, kWDH, kWN) ||
      !encode_3d(encode, &tm_dq, bf16, dq, kWDH, len_i, bh, 2, kWDH, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  tm_bias = tm_dbias = tm_k;  // unread without a 2-D bias
  if (BIAS2D &&
      (!encode_3d(encode, &tm_bias, f32, bias, len_j, len_i, bh, 4, kBiasBox, kWRows) ||
       !encode_3d(encode, &tm_dbias, f32, dbias, len_j, len_i, bh, 4, kBiasBox, 64))) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  }
  if (e != cudaSuccess) return (int)e;
  const int64_t n_qtiles = (len_i + kWRows - 1) / kWRows;
  const int64_t tiles = bh * n_qtiles;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_g, tm_bias, tm_dbias, tm_dq, (const float*)bias, (const float*)lse,
      (const float*)delta, list, (int)len_i, (int)len_j, (int)n_qtiles, tiles, scale,
      scale * kLog2e, extra...);
  return (int)cudaGetLastError();
}

}  // namespace af2::dq
