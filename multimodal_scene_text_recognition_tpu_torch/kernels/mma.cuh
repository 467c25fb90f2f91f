// Tensor-core helpers shared by the kernels that run mma.sync (gemm_probe.cu,
// fused_decode_cluster.cu): the int8 and bf16 warp-level products and the
// 32-bit fragment-word load.
//
// Fragment layout of m16n8k16 (bf16) for lane l, g = l / 4, q = l % 4: A
// (16 x 16, row-major) a0 = rows g, k 2q..2q+1; a1 = row g + 8; a2 = row g,
// k 2q+8..2q+9; a3 = row g + 8, k 2q+8..2q+9.  B (16 x 8, k-major per
// column) b0 = k 2q..2q+1 of column g, b1 = k 2q+8..2q+9.  C (16 x 8) c0, c1
// = row g, columns 2q, 2q+1; c2, c3 = row g + 8.  The lower half of a word
// holds the lower k.  m16n8k32 (int8) has the same shape with four k-values
// a word.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// d += a * b, int8 x int8 -> int32 (m16n8k32)
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b, bf16 x bf16 -> float32 (m16n8k16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the 32-bit fragment word at p (two bf16 or four int8 values)
template <typename T>
__device__ __forceinline__ uint32_t word(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace
