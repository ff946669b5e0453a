// bf16 matrix products on Hopper's tensor cores (sm_90a) through mma.sync,
// with the shared-memory fragment loads and the fp32 -> bf16 pack that
// feed them.
//
// The tensor cores multiply bf16 operands exactly and add into fp32. A
// kernel whose operands are bf16 values (or are rounded to bf16 where its
// reference rounds them) therefore computes its reference's products with
// one mma.sync each, at the card's bf16 rate (989 TFLOP/s dense on an H100
// SXM, twice the TF32 rate) and at twice a TF32 product's k depth.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for
// lane = 4 g + t (g = lane >> 2, t = lane & 3), as (row, column); each
// 32-bit register holds two bf16 values, the lower column in its lower
// half:
//   A (16 x 16, row-major):  a0 (g, 2t..2t+1)  a1 (g + 8, 2t..2t+1)
//                            a2 (g, 2t+8..2t+9)  a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, k by n):      b0 (k = 2t..2t+1, n = g)
//                            b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8, fp32):        c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                            c3 (g + 8, 2t + 1)
// (CUTLASS: SM80_16x8x16_F32BF16BF16F32_TN in cute/atom/mma_traits_sm80.hpp.)
// So the C fragments of two m16n8 tiles side by side, packed into bf16
// pairs, are the A fragment of a product over their 16 columns: c0, c1 of
// the left tile give a0, c2, c3 give a1, and the right tile's give a2, a3.
#pragma once

#include <stdint.h>

namespace bf16mma {

// c += a b on one m16n8k16 tile: bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The shared-memory address (32 bits) of a pointer into shared memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 matrices of bf16 from shared memory: lane i gives the address
// a (a shared-memory address) of row i % 8 of matrix i / 8 (16 bytes),
// and lane 4 g + t receives elements 2t, 2t + 1 of row g of each matrix:
// an A fragment from a row-major tile, or B fragments from a tile stored
// n by k.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, transposed: lane 4 g + t receives elements g of rows 2t and
// 2t + 1 of each matrix: B fragments from a tile stored k by n (rows k).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// lo and hi rounded to bf16 (to nearest even) and packed, lo in the lower
// half: two neighbouring columns of a fragment.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

}  // namespace bf16mma
