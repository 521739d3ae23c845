// int8-weight matrix product for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel B4 of alphafold2_tpu/ops/quant_kernel.py,
// `quant_matmul_tpu` -> `_qmm_kernel`: y = (x @ q) * scale, with x (m, k) in
// f32 or bf16, q (k, n) int8 (per-channel symmetric, |q| <= 127), scale (n,)
// f32 per output channel, y (m, n) in x's type. The contract is the TPU
// kernel's: the int8 tile is cast to the activation type on chip (exact,
// |q| <= 127), the products accumulate in f32, the scale multiplies the f32
// accumulator once in the epilogue, and the result is cast once. No
// dequantized weight ever exists in device memory.
//
// What bounds it on an H100: 2 * m * k * n operations against m * k * el +
// k * n + 4 * n + m * n * el bytes. At the trunk's dense layers (m = the
// pair grid's 147,456 tokens, k and n 256 to 2,048) the work is bound by
// operations for the wide layers and by the activations' bytes for the
// narrow ones; the int8 weight is a small share either way.
//
// bf16: a block of 8 warps computes a 128 x 128 output tile, each warp a
// 64 x 32 slab of `mma.sync.m16n8k16` tiles (bf16 in, f32 accumulate,
// mma_bf16.cuh). 32-deep steps stream the x tile (bf16) and the weight
// tile (int8, as stored) through two shared-memory buffers with cp.async,
// the next step's copies in flight while the current one computes; each
// thread casts its B fragments from int8 to bf16 in registers. The ragged
// edges of m, k and n are masked in the kernel (zero-filled copies), never
// padded in device memory as `quant_matmul_tpu` pads; rows that are not
// 16-byte aligned are copied element by element. wgmma and TMA are the
// next step.
//
// f32: a 64 x 64 tile a block on the CUDA cores, 4 x 4 outputs a thread,
// f32 FMAs (the tensor cores would round to TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using af2::mma_bf16;
using af2::pack_bf16;

// --- bf16: tensor cores ----------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kPad = 8;    // bf16 row padding: fragment loads hit distinct banks
constexpr int kWPad = 16;  // int8 row padding (144-byte rows: 16-byte aligned,
                           // and the fragment's byte loads hit distinct banks)
constexpr int kThreads = 256;  // 8 warps: 2 along m x 4 along n

// int8 -> bf16, exact for |q| <= 127
__device__ __forceinline__ __nv_bfloat16 bf16_of(int8_t q) {
  return __float2bfloat16((float)q);
}

__global__ void __launch_bounds__(kThreads)
    quant_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             const int8_t* __restrict__ qw,
                             const float* __restrict__ scale,
                             __nv_bfloat16* __restrict__ y, int64_t m,
                             int64_t k, int64_t n) {
  // two buffers each: step s + 1's copies fly while step s computes
  __shared__ __align__(16) __nv_bfloat16 xs[2][kBM][kBK + kPad];
  __shared__ __align__(16) int8_t ws[2][kBK][kBN + kWPad];  // int8, [k][n]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / 4) * 64;  // the warp's rows in the tile
  const int wn = (warp % 4) * 32;  // and its columns
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int64_t n0 = (int64_t)blockIdx.y * kBN;
  // 16-byte copies need 16-byte aligned rows; otherwise element by element
  const bool x_vec = (k % 8 == 0) && ((uintptr_t)x % 16 == 0);
  const bool w_vec = (n % 16 == 0) && ((uintptr_t)qw % 16 == 0);

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  auto issue = [&](int step) {
    const int buf = step & 1;
    const int64_t k0 = (int64_t)step * kBK;
    // x tile: 128 rows x 32 columns, 8 bf16 per vector, 2 vectors a thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int v = tid + it * kThreads;
      const int row = v / 4;
      const int col = (v % 4) * 8;
      const int64_t gr = m0 + row;
      const int64_t gc = k0 + col;
      if (x_vec) {
        const bool in = gr < m && gc < k;
        const int bytes = in ? (int)(k - gc < 8 ? (k - gc) * 2 : 16) : 0;
        const unsigned to = (unsigned)__cvta_generic_to_shared(&xs[buf][row][col]);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(to), "l"(in ? x + gr * k + gc : x), "r"(bytes) : "memory");
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          xs[buf][row][col + c] = (gr < m && gc + c < k) ? x[gr * k + gc + c]
                                                          : __float2bfloat16(0.f);
        }
      }
    }
    // weight tile: 32 rows (k) x 128 columns (n) of int8, 16 a thread, one
    // 128-byte row per 8 threads
    {
      const int kk = tid / 8;
      const int nn = (tid % 8) * 16;
      const int64_t gk = k0 + kk;
      const int64_t gn = n0 + nn;
      if (w_vec) {
        const bool in = gk < k && gn < n;
        const unsigned to = (unsigned)__cvta_generic_to_shared(&ws[buf][kk][nn]);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(to), "l"(in ? qw + gk * n + gn : qw), "r"(in ? 16 : 0)
                     : "memory");
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          ws[buf][kk][nn + c] = (gk < k && gn + c < n) ? qw[gk * n + gn + c] : (int8_t)0;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int steps = (int)((k + kBK - 1) / kBK);
  issue(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      issue(step + 1);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // step's tiles are in shared memory
    const int buf = step & 1;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = wm + mt * 16 + g + (r & 1) * 8;
          const int col = ks * 16 + (r >> 1) * 8 + 2 * t;
          a[mt][r] = *reinterpret_cast<const uint32_t*>(&xs[buf][row][col]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // the B fragment (k rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column
        // g), cast from int8 in registers: the only dequantization
        const int col = wn + nt * 8 + g;
        const int kr = ks * 16 + 2 * t;
        const uint32_t b0 = pack_bf16(bf16_of(ws[buf][kr][col]), bf16_of(ws[buf][kr + 1][col]));
        const uint32_t b1 =
            pack_bf16(bf16_of(ws[buf][kr + 8][col]), bf16_of(ws[buf][kr + 9][col]));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before its reissue
  }

  // epilogue: the per-channel scale on the f32 accumulator, one cast
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int64_t col = n0 + wn + nt * 8 + 2 * t;
    const float s0 = col < n ? scale[col] : 0.f;
    const float s1 = col + 1 < n ? scale[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm + mt * 16 + g + h * 8;
        if (row >= m || col >= n) continue;
        const float v0 = acc[mt][nt][2 * h] * s0;
        const float v1 = acc[mt][nt][2 * h + 1] * s1;
        __nv_bfloat16* dst = y + row * n + col;
        if (col + 1 < n && n % 2 == 0) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (col + 1 < n) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// --- f32: CUDA cores -------------------------------------------------------

constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;

__global__ void __launch_bounds__(256)
    quant_matmul_f32_kernel(const float* __restrict__ x,
                            const int8_t* __restrict__ qw,
                            const float* __restrict__ scale,
                            float* __restrict__ y, int64_t m, int64_t k,
                            int64_t n) {
  __shared__ float xs[kFK][kFM + 4];  // [k][m]
  __shared__ float ws[kFK][kFN];      // [k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 columns each
  const int ty = tid / 16;  // 4 rows each
  const int64_t m0 = (int64_t)blockIdx.x * kFM;
  const int64_t n0 = (int64_t)blockIdx.y * kFN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < k; k0 += kFK) {
    __syncthreads();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int v = tid + it * 256;
      const int r = v / kFK;
      const int c = v % kFK;
      const int64_t gr = m0 + r;
      const int64_t gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? x[gr * k + gc] : 0.f;
      const int kk = v / kFN;
      const int nn = v % kFN;
      const int64_t gk = k0 + kk;
      const int64_t gn = n0 + nn;
      ws[kk][nn] = (gk < k && gn < n) ? (float)qw[gk * n + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float xr[4], wr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xr[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wr[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t col = n0 + tx * 4 + j;
    if (col >= n) continue;
    const float s = scale[col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = m0 + ty * 4 + i;
      if (row < m) y[row * n + col] = acc[i][j] * s;
    }
  }
}

}  // namespace

extern "C" {

// B4. x (m, k) f32 or bf16, row-major; qw (k, n) int8, row-major; scale
// (n,) f32; y (m, n) in x's type. Returns the CUDA error code of the launch
// (0 = launched).
int af2_quant_matmul(const void* x, const void* qw, const void* scale,
                     void* y, int64_t m, int64_t k, int64_t n, int is_bf16,
                     void* stream_ptr) {
  if (m <= 0 || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int64_t bm = is_bf16 ? kBM : kFM;
  const int64_t bn = is_bf16 ? kBN : kFN;
  const int64_t gx = (m + bm - 1) / bm;
  const int64_t gy = (n + bn - 1) / bn;
  if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (is_bf16) {
    quant_matmul_bf16_kernel<<<grid, kThreads, 0, stream>>>(
        (const __nv_bfloat16*)x, (const int8_t*)qw, (const float*)scale,
        (__nv_bfloat16*)y, m, k, n);
  } else {
    quant_matmul_f32_kernel<<<grid, 256, 0, stream>>>(
        (const float*)x, (const int8_t*)qw, (const float*)scale, (float*)y, m,
        k, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
