// Attention dropout inside the block-sparse kernels (B5f, B5 dq, B5 dkv):
// Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers:
// as easy as 1, 2, 3", SC 2011) written out, and the keep bits of a
// thread's share of an attention tile.
//
// The bits of element (bh, query i, key j) are a function of the seed and
// those sequence coordinates only, never of a tile, stage or thread, so
// the forward (query tiles over the table's `unions`) and the backward
// (dq over the same lists, dkv over the key tiles' `key_unions`) draw the
// same mask. Elements come in groups of four, {i, i + 8} x {j, j + 8} with
// bit 3 of i and j clear: one Philox call a group, counter (j, i, bh,
// salt) and key (seed[0] low, seed[0] high), salt = seed[1] low, bh
// counted in the whole batch (the launch's bh_base plus its own row: a
// data-parallel shard draws its rows of the whole batch's mask). Element
// (i + 8a, j + 8b) takes word 2a + b and is kept iff that word is at least
// round(rate 2^32), an integer test the plain version
// (ops/sparse_kernel.py `philox_keep`) repeats bit for bit. The group lies
// in one thread of every route's layout: the rows r, r + 8 and columns c,
// c + 8 of an m64nNk16 (wgmma) or m16n8k16 (mma.sync) accumulator tile,
// and 8 of the 16 streamed columns of the f32 kernels' rows.

#pragma once

#include <stdint.h>

namespace af2 {

// Philox4x32-10 of the 128-bit counter c under the key (k0, k1)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// A kernel's attention dropout, a compile-time switch: with ON false the
// kernel is the one without dropout. seed: two int64 on the device (drawn
// there at the layer's rng position, read at the launch, so a CUDA graph
// replays each draw); an element is kept iff its 32 bits are at least
// `threshold` = round(rate 2^32), then scaled by `scale` = 1 / (1 - rate);
// the launch's row bh draws as bh_base + bh.
template <bool ON>
struct Dropout {
  static constexpr bool kOn = ON;
  const int64_t* seed;
  uint32_t threshold;
  float scale;
  uint32_t bh_base;
};

// What a thread draws with: the Philox key, the counter's fourth word
// and the keep test
struct DropKey {
  uint32_t k0, k1, salt, threshold;
  float scale;
  uint32_t bh_base;
};

template <bool ON>
__device__ __forceinline__ DropKey drop_key(const Dropout<ON>& d) {
  if (!ON) return DropKey{0u, 0u, 0u, 0u, 1.f, 0u};
  const uint64_t s0 = (uint64_t)d.seed[0];
  return DropKey{(uint32_t)s0, (uint32_t)(s0 >> 32), (uint32_t)d.seed[1], d.threshold, d.scale,
                 d.bh_base};
}

// The four words of the group at query i, key j (bit 3 of both clear):
// word 2a + b is element (i + 8a, j + 8b)
__device__ __forceinline__ uint4 group_bits(const DropKey& d, uint32_t bh, uint32_t i, uint32_t j) {
  return philox4x32_10(make_uint4(j, i, d.bh_base + bh, d.salt), d.k0, d.k1);
}

// The keep bits of a thread's C fragments of an accumulator tile of 8 C
// columns (C even), the layout of wgmma and mma.sync alike: fragment 4c +
// 2h + e is row row0 + 8h, column col0 + 8c + e (col0 = the tile's first
// column, a multiple of 16, plus 2t; row0's bit 3 clear). Rows are queries
// and columns keys, or with KEY_ROWS keys and queries (dkv's transposed
// tiles). Bit 4c + 2h + e of the result is that fragment's.
template <int C, bool KEY_ROWS>
__device__ __forceinline__ uint64_t keep_bits(const DropKey& d, uint32_t bh, uint32_t row0,
                                              uint32_t col0) {
  uint64_t bits = 0;
#pragma unroll
  for (int m = 0; m < C / 2; ++m) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t col = col0 + 16 * m + e;
      const uint4 z = KEY_ROWS ? group_bits(d, bh, col, row0) : group_bits(d, bh, row0, col);
      const uint32_t w[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {  // row half h, column chunk 2m + b
          const uint32_t word = w[KEY_ROWS ? 2 * b + h : 2 * h + b];
          bits |= (uint64_t)(word >= d.threshold) << (4 * (2 * m + b) + 2 * h + e);
        }
      }
    }
  }
  return bits;
}

// The keep bits of one row's 16 consecutive columns col0 .. col0 + 15 (col0
// a multiple of 16): bit c is column col0 + c. The row is a query and the
// columns keys, or with KEY_ROWS a key and queries.
template <bool KEY_ROWS>
__device__ __forceinline__ uint32_t keep_bits16(const DropKey& d, uint32_t bh, uint32_t row,
                                                uint32_t col0) {
  uint32_t bits = 0;
  const uint32_t half = (row >> 3) & 1u;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint4 z = KEY_ROWS ? group_bits(d, bh, col0 + c, row & ~8u)
                             : group_bits(d, bh, row & ~8u, col0 + c);
    const uint32_t w[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const uint32_t word = w[KEY_ROWS ? 2 * b + half : 2 * half + b];
      bits |= (uint32_t)(word >= d.threshold) << (c + 8 * b);
    }
  }
  return bits;
}

// A kept element's factor: `scale` where bit `at` of `bits` is set, else 0
__device__ __forceinline__ float keep_factor(const DropKey& d, uint64_t bits, int at) {
  return ((bits >> at) & 1u) ? d.scale : 0.f;
}

}  // namespace af2
