// fp32 matrix products on Hopper's tensor cores in 3xTF32 (split TF32).
//
// The tensor cores multiply TF32 operands (fp32 with a 10-bit mantissa)
// exactly and add into fp32. One TF32 product keeps about three decimal
// digits, too few for the port's fp32 kernels. Split each fp32 operand as
// x = hi + lo, both TF32, and sum three products per fp32 product:
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi (the dropped a_lo b_lo is below
// fp32 rounding). The result agrees with an fp32 product to about 2^-21
// relative. This is CUTLASS's OpMultiplyAddFastF32 and the route PyTorch's
// fp32 memory-efficient attention takes on sm_80 and later.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, for
// lane = 4 g + t (g = lane >> 2, t = lane & 3), as (row, column):
//   A (16 x 8, row-major):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)
//                           a3 (g + 8, t + 4)
//   B (8 x 8, k by n):      b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8):             c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                           c3 (g + 8, 2t + 1)
// (CUTLASS: SM80_16x8x8_F32TF32TF32F32_TN in cute/atom/mma_traits_sm80.hpp.)
#pragma once

#include <stdint.h>

namespace tf32x3 {

// x = hi + lo to about 2^-22 |x|, hi and lo as TF32 bits in fp32 words.
// Each is rounded as cvt.rna.tf32.f32 rounds a finite number, to nearest
// with ties away from zero: add half a unit of the 13 dropped mantissa bits
// to the magnitude (sign and magnitude are separate in IEEE 754). hi then
// has those bits cleared, so x - hi is exact in fp32; lo keeps them, since
// the tensor cores read only the upper 19 bits of a TF32 operand (ptxas
// feeds cvt.rna's result to mma.sync unmasked as well). Four integer and
// fp32 operations: cvt.rna compiles to four for hi alone on sm_90a, where it
// also tests for inf and NaN. A NaN or inf x still gives a NaN or inf
// product through lo = x - hi.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a b on one m16n8k8 tile, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] += a b[i], i < N, at fp32 accuracy, for N tiles that share A: the
// N products a_lo b_hi[i], then the N a_hi b_lo[i], then the N
// a_hi b_hi[i]. Each accumulator takes its two small cross terms first and
// hi x hi last (small terms first, as CUTLASS does), and consecutive
// mma.sync are independent, so the tensor cores pipeline them instead of
// each waiting for the one before.
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4],
                                     const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4],
                                     const uint32_t (&b_hi)[N][2],
                                     const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a_lo, b_hi[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a_hi, b_lo[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a_hi, b_hi[i]);
}

}  // namespace tf32x3
