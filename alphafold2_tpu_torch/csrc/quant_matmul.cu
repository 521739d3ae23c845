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
// What bounds it on an H100: 2 * m * k * n operations at 989 TFLOP/s against
// m * k * 2 + k * n + 4 * n + m * n * 2 bytes at 3.35 TB/s. At every shape the
// served int8 request gives it (m = the pair grid's 147,456 tokens or the
// MSA's 7,680, k and n 256 to 2,048) the bytes bound it: x and y are nearly
// all of them, the int8 weight (at most 512 KB) a small share. So the design
// is about moving x and y once, at full width, while the tensor cores keep up.
//
// Three kernels, one per route (`ops/quant_kernel.py route`):
//
// wgmma (bf16; k % 8 == 0, n % 16 == 0, 16-byte aligned x, q and y, which is
// every served shape): persistent blocks, at most one per SM, each walking a
// run of 256 x 128 output tiles along n within an m tile, so x crosses
// device memory once and the weight (at most 512 KB) stays in L2.
//  - Warp 0 keeps TMA loads of the x chunk (256 x 64 bf16) and the int8
//    weight chunk (64 x 128), both 128-byte swizzled, in flight in a
//    4-stage ring with full and empty mbarriers. Where k <= 256 a tile's x
//    chunks fill the ring exactly, and the next tile of the same m tile
//    finds them there: only the weight chunk is loaded again.
//  - The products run transposed, y^T = W^T x^T, CUTLASS's mixed-input
//    scheme: the x chunk, as TMA left it, is wgmma's B operand (K-major),
//    and the weight is its A operand in registers. Each consumer warp reads
//    its 16 columns of the int8 chunk with ldmatrix.trans (k pairs of a
//    column, conflict-free on the swizzled rows) and converts them exactly
//    in registers (a byte permute into the mantissa of 2^23, one
//    subtraction, the f32's upper half is the bf16), chunk c + 1 while
//    chunk c's wgmma run on the other set of fragments. A warp's A rows g,
//    g + 8 are its columns 2 g, 2 g + 1, so a thread's accumulators hold
//    pairs along n of y.
//  - Two consumer warpgroups each run wgmma.mma_async m64n256k16 (A from
//    registers, bf16 in, f32 accumulate, 128 registers a thread; setmaxnreg
//    moves registers from warpgroup 0) over their 64 columns and the
//    tile's 256 rows.
//  - The epilogue scales the f32 sums by the thread's two scales, casts
//    once, stages 64 x 64 boxes in swizzled shared memory and writes each
//    with a TMA store that drains while the next box is staged. TMA
//    zero-fills the ragged m, k and n edges on load and clips them on
//    store: nothing is padded in device memory. The descriptors are
//    encoded on the host at each call (cuTensorMapEncodeTiled, reached
//    through cudaGetDriverEntryPoint, so nothing links libcuda).
// Why this design (measured on an H100, PERF.md): the first version
// converted the weight into a bf16 B operand in shared memory, as the TPU
// kernel does on its VMEM tile. It was bound by shared-memory bandwidth:
// ~768 KB a 128 x 256 tile (wgmma reads, TMA writes, the bf16 weight
// written and read again, the epilogue's staging) against 128 bytes a
// cycle. The weight in registers drops its bf16 trip through shared memory
// and converts each element once per 256 rows instead of 128. The
// epilogue still does not overlap the products, and n = 256 layers re-read
// each x chunk for their two n tiles.
//
// cp_async (bf16 shapes the TMA rules refuse, e.g. k or n not a multiple of
// 8 or 16, or a misaligned base): a block of 8 warps computes a 128 x 128
// output tile, each warp a 64 x 32 slab of `mma.sync.m16n8k16` tiles
// (mma_bf16.cuh). 32-deep steps stream the x tile and the int8 weight tile
// through two shared-memory buffers with cp.async; each thread casts its B
// fragments from int8 to bf16 in registers. Ragged edges are zero-filled
// copies masked in the kernel; rows that are not 16-byte aligned are copied
// element by element.
//
// f32: a 64 x 64 tile a block on the CUDA cores, 4 x 4 outputs a thread,
// f32 FMAs (the tensor cores would round to TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using af2::EncodeTiledFn;
using af2::encode_tiled;
using af2::fence_async_smem;
using af2::gmma_desc;
using af2::mbar_arrive;
using af2::mbar_expect_tx;
using af2::mbar_init;
using af2::mbar_wait;
using af2::mma_bf16;
using af2::pack_bf16;
using af2::smem_u32;
using af2::tma_load_2d;
using af2::tma_store_2d;
using af2::warpgroup_sync;
using af2::wgmma_commit;
using af2::wgmma_fence;
using af2::wgmma_wait;

// --- bf16, the cp_async route: mma.sync ------------------------------------

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

// --- bf16, the wgmma route: TMA, wgmma, persistent blocks ---------------------

constexpr int kTM = 256;     // output tile rows (m): the N of every wgmma
constexpr int kTN = 128;     // output tile columns (n): two consumer warpgroups of 64
constexpr int kWK = 64;      // k a stage: one 128-byte swizzle row of bf16 x
constexpr int kStages = 4;   // TMA ring: an x chunk and an int8 weight chunk a stage
constexpr int kConsumerWarps = 8;  // warpgroups 1 and 2
constexpr int kWThreads = 384;     // warp 0 issues the TMA loads; 1-3 give registers
constexpr int kLightRegs = 56;     // setmaxnreg: warpgroup 0 gives registers to
constexpr int kConsumerRegs = 224;  // the consumers' accumulators and weight fragments
constexpr int kXBytes = kTM * kWK * 2;  // 32 KB
constexpr int kQBytes = kWK * kTN;      // 8 KB of int8: 64 rows of 128 B, 128-byte swizzle
constexpr int kYBox = 64;               // epilogue store box: 64 x 64 bf16
constexpr int kYBytes = kYBox * kYBox * 2;
constexpr int kSmemQ = kStages * kXBytes;
constexpr int kSmemY = kSmemQ + kStages * kQBytes;  // 2 buffers a consumer warpgroup
constexpr int kSmemBar = kSmemY + 4 * kYBytes;
constexpr int kWSmemBytes = kSmemBar + 16 * kStages + 1024;  // + alignment
static_assert(kWSmemBytes <= 232448, "over the 227 KB a block may use");

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// a 2 x 2 block of int8 in one word, w = [q(k, n), q(k, n + 1), q(k + 1, n),
// q(k + 1, n + 1)] (as ldmatrix.trans hands it) -> two bf16 pairs along k,
// (q(k, n), q(k + 1, n)) and (q(k, n + 1), q(k + 1, n + 1)), exactly: each
// byte, offset by 128, becomes the low mantissa byte of 2^23; less 2^23 +
// 128 that is q in f32, and |q| <= 128 has at most 8 significant bits, so
// the f32's upper half is q in bf16
__device__ __forceinline__ uint2 bf16_pairs_of_int8x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632),
                    __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// a wgmma reads its register operand asynchronously: keeping the fragments
// live across the wait keeps the compiler from reusing their registers
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define AF2_D8(i)                                                                \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256 f32, 128 a thread) += A (64 x 16 bf16, from registers: a
// warp's 16 rows, mma.m16n8k16's A layout) . B (16 x 256 bf16, K-major, in
// shared memory); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n256k16_rs(float* d, const uint32_t* a, uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : AF2_D8(0), AF2_D8(8), AF2_D8(16), AF2_D8(24), AF2_D8(32), AF2_D8(40), AF2_D8(48),
        AF2_D8(56), AF2_D8(64), AF2_D8(72), AF2_D8(80), AF2_D8(88), AF2_D8(96), AF2_D8(104),
        AF2_D8(112), AF2_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#undef AF2_D8

__global__ void __launch_bounds__(kWThreads, 1)
    quant_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                              const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_y,
                              const float* __restrict__ scale, int m, int n, int tiles_n,
                              int tiles, int tiles_per_block, int kchunks) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const uint32_t bars = base + kSmemBar;
  auto full = [&](int c) { return bars + 8 * (c % kStages); };  // x, q landed
  auto empty = [&](int c) { return bars + 8 * (kStages + c % kStages); };  // x, q read
  // the phase parity a wait on chunk c's slot expects (empty slots: the
  // previous round's, which a fresh barrier counts as completed)
  auto ring = [](int c) { return (uint32_t)((c / kStages) & 1); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the block's tiles are a run from first_tile on, along n within an m
  // tile; chunk c is k chunk c % kchunks of tile first_tile + c / kchunks
  const int first_tile = (int)blockIdx.x * tiles_per_block;
  const int chunks = max(0, min(tiles_per_block, tiles - first_tile)) * kchunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLightRegs));
    if (warp == 0 && lane == 0) {
      // the producer: keeps the ring's TMA loads in flight
      for (int c = 0; c < chunks; ++c) {
        const int tile = first_tile + c / kchunks;
        const int kc = c % kchunks;
        // the slot still holds this x chunk when it held the same k chunk
        // of the same m tile kStages chunks ago (k <= 256: every n tile
        // after an m tile's first): then only the weight chunk is loaded
        const bool x_held = c >= kStages && kStages % kchunks == 0 &&
                            (first_tile + (c - kStages) / kchunks) / tiles_n == tile / tiles_n;
        mbar_wait(empty(c), ring(c) ^ 1);
        mbar_expect_tx(full(c), (x_held ? 0 : kXBytes) + kQBytes);
        if (!x_held) {
          tma_load_2d(base + (c % kStages) * kXBytes, &tm_x, full(c), kc * kWK,
                      tile / tiles_n * kTM);
        }
        tma_load_2d(base + kSmemQ + (c % kStages) * kQBytes, &tm_q, full(c),
                    tile % tiles_n * kTN, kc * kWK);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // the consumers compute y^T: warpgroup wg takes the tile's columns
    // 64 wg .. 64 wg + 63 as the M of its wgmma and the tile's 256 rows as
    // the N. Its A operand, the weight, comes in registers: ldmatrix.trans
    // reads the int8 chunk, the conversion to bf16 happens in registers,
    // and a warp's A rows g, g + 8 are its columns 2 g, 2 g + 1. B is the x
    // chunk as TMA left it.
    const int wg = warp / 4 - 1;
    const int wq = warp % 4;
    const int tid = threadIdx.x % 128;
    const int g = lane / 4;
    const int t = lane % 4;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t a0[4][4], a1[4][4];  // the fragments of two chunks: one read, one written
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a0[i][j] = a1[i][j] = 0u;
    auto release = [&](int c) {  // chunk c's products are done
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(c));
    };
    auto convert = [&](int c, uint32_t (&a)[4][4]) {
      mbar_wait(full(c), ring(c));
      const uint32_t q = base + kSmemQ + (c % kStages) * kQBytes;
      const int unit = 4 * wg + wq;  // the warp's 16 columns: one 16-byte unit of a row
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        const int mi = lane / 8;  // matrices: k rows 0-7 and 8-15 of steps 2 pair, 2 pair + 1
        const int krow = 32 * pair + 16 * (mi / 2) + 8 * (mi % 2) + lane % 8;
        uint32_t r[4];
        ldmatrix_x4_trans(q + krow * 128 + ((unit ^ (krow & 7)) << 4), r);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 lo = bf16_pairs_of_int8x4(r[2 * h]);
          const uint2 hi = bf16_pairs_of_int8x4(r[2 * h + 1]);
          a[2 * pair + h][0] = lo.x;
          a[2 * pair + h][1] = lo.y;
          a[2 * pair + h][2] = hi.x;
          a[2 * pair + h][3] = hi.y;
        }
      }
    };
    auto mma = [&](int c, int kc, uint32_t (&a)[4][4]) {
      const uint32_t xa = base + (c % kStages) * kXBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWK / 16; ++ks) {
        wgmma_m64n256k16_rs(acc, a[ks], gmma_desc(xa + 32 * ks, 16, 1024), (kc | ks) != 0);
      }
      wgmma_commit();
    };
    int stores = 0;
    if (chunks > 0) convert(0, a0);
    // the epilogue sits after the k loop, outside it: accumulator reads in
    // a branch of the loop that issues the wgmma serialize them (ptxas)
    for (int c = 0; c < chunks;) {
      const int tile = first_tile + c / kchunks;
      const int m0 = tile / tiles_n * kTM;
      const int n0 = tile % tiles_n * kTN;
      for (int kc = 0; kc < kchunks; ++kc, ++c) {
        // chunk c's products read one set of fragments while chunk c + 1 is
        // converted into the other, once chunk c - 1's products are done
        if ((c & 1) == 0) {
          mma(c, kc, a0);
          if (kc > 0) {
            wgmma_wait<1>();
            fence_frag(a1);
            release(c - 1);
          }
          if (c + 1 < chunks) convert(c + 1, a1);
        } else {
          mma(c, kc, a1);
          if (kc > 0) {
            wgmma_wait<1>();
            fence_frag(a0);
            release(c - 1);
          }
          if (c + 1 < chunks) convert(c + 1, a0);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(a0);
      fence_frag(a1);
      release(c - 1);

      // epilogue: the thread holds y[m][n], y[m][n + 1] for its columns n =
      // n0 + 64 wg + 16 wq + 2 g and rows m = m0 + 8 j + 2 t (+ 1): scale the
      // f32 sums, cast once, stage 64 x 64 boxes in swizzled shared memory,
      // store each with TMA (clipped at m and n)
      const int ncol = n0 + 64 * wg + 16 * wq + 2 * g;
      const float s0 = ncol < n ? __ldg(scale + ncol) : 0.f;  // n is even
      const float s1 = ncol < n ? __ldg(scale + ncol + 1) : 0.f;
      if (n0 + 64 * wg < n) {
        const uint32_t ybuf = base + kSmemY + wg * 2 * kYBytes;
        const uint32_t col = ((2 * wq + g / 4) << 4) + (g % 4) * 4;  // before the swizzle
#pragma unroll
        for (int bx = 0; bx < kTM / kYBox; ++bx) {
          if (m0 + bx * kYBox < m) {
            const uint32_t yb = ybuf + (stores & 1) * kYBytes;
            if (tid == 0 && stores >= 2) {
              // the store that last read this buffer is done reading it
              asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
            }
            warpgroup_sync(1 + wg);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int j = bx * 8 + jj;
              const int r = 8 * jj + 2 * t;  // the box's rows r, r + 1
              const uint32_t at0 = yb + r * 128 + (col ^ ((r & 7) << 4));
              const uint32_t at1 = yb + (r + 1) * 128 + (col ^ (((r + 1) & 7) << 4));
              st_shared_u32(at0, pack_bf16(acc[4 * j] * s0, acc[4 * j + 2] * s1));
              st_shared_u32(at1, pack_bf16(acc[4 * j + 1] * s0, acc[4 * j + 3] * s1));
            }
            fence_async_smem();
            warpgroup_sync(1 + wg);
            if (tid == 0) tma_store_2d(&tm_y, yb, n0 + 64 * wg, m0 + bx * kYBox);
            ++stores;
          }
        }
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// a row-major (rows, cols) matrix of `el`-byte elements, cut in (box_rows,
// box_cols) boxes
bool encode_2d(EncodeTiledFn encode, CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               int64_t rows, int64_t cols, int el, int box_rows, int box_cols,
               CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * el)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// B4, the cp_async (bf16) and f32 routes. x (m, k) f32 or bf16, row-major;
// qw (k, n) int8, row-major; scale (n,) f32; y (m, n) in x's type. Returns
// the CUDA error code of the launch (0 = launched).
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

// B4, the wgmma route. x (m, k) bf16, row-major; qw (k, n) int8, row-major;
// scale (n,) f32; y (m, n) bf16. Takes k % 8 == 0, n % 16 == 0 and x, qw, y
// 16-byte aligned (TMA's 16-byte strides and bases). Returns the CUDA error
// code of the launch (0 = launched).
int af2_quant_matmul_wgmma(const void* x, const void* qw, const void* scale, void* y, int64_t m,
                           int64_t k, int64_t n, void* stream_ptr) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 8 != 0 || n % 16 != 0 || m > 2147483647LL ||
      k > 2147483647LL || n > 2147483647LL ||
      ((uintptr_t)x | (uintptr_t)qw | (uintptr_t)y) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_x, tm_q, tm_y;
  if (!encode_2d(encode, &tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, m, k, 2, kTM, kWK,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(encode, &tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, qw, k, n, 1, kWK, kTN,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(encode, &tm_y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, m, n, 2, kYBox, kYBox,
                 CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(quant_matmul_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmemBytes);
  }
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles_n = (n + kTN - 1) / kTN;
  const int64_t tiles = (m + kTM - 1) / kTM * tiles_n;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const int64_t per_block = (tiles + sms - 1) / sms;  // a run of tiles a block
  const int grid = (int)((tiles + per_block - 1) / per_block);
  quant_matmul_wgmma_kernel<<<grid, kWThreads, kWSmemBytes, (cudaStream_t)stream_ptr>>>(
      tm_x, tm_q, tm_y, (const float*)scale, (int)m, (int)n, (int)tiles_n, (int)tiles,
      (int)per_block, (int)((k + kWK - 1) / kWK));
  return (int)cudaGetLastError();
}

}  // extern "C"
