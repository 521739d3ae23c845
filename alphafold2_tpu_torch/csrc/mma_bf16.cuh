// bf16 tensor-core helpers shared by the port's kernels (flash_fwd.cu,
// flash_bwd.cu, sparse_attn.cu, quant_matmul.cu): one `mma.sync.m16n8k16`
// (bf16 in, f32 accumulate), the packing of two values into one 32-bit
// operand, and the warp-tile helpers of the attention kernels: A fragments
// of 16 rows from device memory, a tile staged in shared memory, and the
// two products of a 16-row slab with a staged tile.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): A holds
// rows g and g + 8, columns 2t, 2t + 1 (+ 8); B holds k rows 2t, 2t + 1
// (+ 8) of column g; C holds rows g and g + 8, columns 2t, 2t + 1. So the
// C fragments of two neighbouring n-tiles are, packed to bf16, the A
// fragment of the next product over those 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace af2 {

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kPad = 8;  // shared-memory row padding of staged tiles, in elements

// The A fragments of a warp's 16 rows (rows[h], h = 0: g, 1: g + 8) of a
// row-major (n, DH) operand; rows past the end are zero.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4],
                                       const __nv_bfloat16* base,
                                       const int64_t (&rows)[2],
                                       const bool (&valid)[2], int t) {
#pragma unroll
  for (int s = 0; s < DH / 16; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r & 1;  // a0, a2: row g; a1, a3: row g + 8
      const int col = s * 16 + (r >> 1) * 8 + 2 * t;
      a[s][r] = valid[h] ? *reinterpret_cast<const uint32_t*>(
                               base + rows[h] * DH + col)
                         : 0u;
    }
  }
}

// Copy `n` rows of a row-major (., DH) bf16 operand into a TILE-row shared
// tile in 16-byte vectors; rows past n are zero (0 * anything is no NaN).
template <int TILE, int DH>
__device__ __forceinline__ void stage(__nv_bfloat16 (*dst)[DH + kPad],
                                      const __nv_bfloat16* src, int n) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  for (int idx = threadIdx.x; idx < TILE * DH / kVec; idx += blockDim.x) {
    const int row = idx / (DH / kVec);
    const int col = (idx % (DH / kVec)) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)row * DH + col);
    }
    *reinterpret_cast<uint4*>(&dst[row][col]) = val;
  }
}

// acc (16 x NT*8) = A (16 x DH) . tile^T: column c of the result is tile
// row c (the S = Q K^T form).
template <int DH, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const uint32_t (&a)[DH / 16][4],
                                        __nv_bfloat16 (*tile)[DH + kPad],
                                        int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < DH / 16; ++st) {
      const __nv_bfloat16* row = &tile[n * 8 + g][st * 16 + 2 * t];
      mma_bf16(acc[n], a[st], *reinterpret_cast<const uint32_t*>(row),
               *reinterpret_cast<const uint32_t*>(row + 8));
    }
  }
}

// acc (16 x DH) += P (16 x TILE, C fragments in f32, rounded to bf16 here)
// . tile (TILE x DH) (the P V form).
template <int DH, int TILE>
__device__ __forceinline__ void mma_ab(float (&acc)[DH / 8][4],
                                       const float (&p)[TILE / 8][4],
                                       __nv_bfloat16 (*tile)[DH + kPad],
                                       int g, int t) {
#pragma unroll
  for (int c = 0; c < TILE / 16; ++c) {
    const uint32_t pa[4] = {pack_bf16(p[2 * c][0], p[2 * c][1]),
                            pack_bf16(p[2 * c][2], p[2 * c][3]),
                            pack_bf16(p[2 * c + 1][0], p[2 * c + 1][1]),
                            pack_bf16(p[2 * c + 1][2], p[2 * c + 1][3])};
    const int r = c * 16 + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = n * 8 + g;
      mma_bf16(acc[n], pa, pack_bf16(tile[r][col], tile[r + 1][col]),
               pack_bf16(tile[r + 8][col], tile[r + 9][col]));
    }
  }
}

// Write a warp's 16 x DH f32 accumulator, times `mul`, as bf16 rows.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           const float (&acc)[DH / 8][4],
                                           const int64_t (&rows)[2],
                                           const bool (&valid)[2], int t,
                                           float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!valid[h]) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<uint32_t*>(base + rows[h] * DH + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
  }
}

// The same copy as `stage`, asynchronous: cp.async moves each 16-byte
// vector from device to shared memory without passing through registers
// (rows past n are zero-filled: a source size of 0 reads nothing). Issue
// the copies of the next tile, `cp_async_commit()` them as one group, and
// `cp_async_wait<1>()` + __syncthreads() before reading the current one.
template <int TILE, int DH>
__device__ __forceinline__ void stage_async(__nv_bfloat16 (*dst)[DH + kPad],
                                            const __nv_bfloat16* src, int n) {
  constexpr int kVec = 8;  // bf16 per 16-byte copy
  for (int idx = threadIdx.x; idx < TILE * DH / kVec; idx += blockDim.x) {
    const int row = idx / (DH / kVec);
    const int col = (idx % (DH / kVec)) * kVec;
    const __nv_bfloat16* from = src + (int64_t)(row < n ? row : 0) * DH + col;
    const unsigned to = (unsigned)__cvta_generic_to_shared(&dst[row][col]);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(from), "r"(row < n ? 16 : 0) : "memory");
  }
}

// One 4-byte asynchronous copy (zero-filled when !ok).
__device__ __forceinline__ void copy_async4(void* dst, const void* src, bool ok) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(to), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace af2
