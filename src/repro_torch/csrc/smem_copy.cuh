// Moving fp32 tiles into shared memory and fragments out of it, on Hopper
// (sm_90a): the asynchronous copies and ldmatrix that the tensor-core
// kernels (flash_attention.cu, paged_prefill_attention.cu) share.
#pragma once

#include <stdint.h>

namespace tilecopy {

// Asynchronous copies of 16 or 4 bytes into shared memory; where `in` is
// false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

// Four 8x8 matrices of 16-bit elements from shared memory: lane i gives
// the address of row i % 8 of matrix i / 8. On fp32 data a row is 4 floats
// and lane 4 g + t receives float t of row g of each matrix: the TF32
// fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

}  // namespace tilecopy
