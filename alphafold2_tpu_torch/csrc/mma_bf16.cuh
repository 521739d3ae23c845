// bf16 tensor-core helpers shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): one `mma.sync.m16n8k16` (bf16 in, f32
// accumulate) and the packing of two values into one 32-bit operand.
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

}  // namespace af2
