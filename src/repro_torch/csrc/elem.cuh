// The element types of the attention kernels' tensors: fp32 or bf16, read
// into fp32 registers and written back once. A bf16 value widens to fp32
// exactly (its 16 bits are the fp32 value's upper half), so every product
// and every sum of a kernel runs in fp32 whatever it reads; a bf16 output
// is rounded once, to nearest even, where it is stored.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace elem {

using bf16 = __nv_bfloat16;

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return sizeof(T) == 2;
}

__device__ __forceinline__ float widen(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (is_bf16<T>())
    return __float2bfloat16_rn(x);
  else
    return x;
}

template <typename T>
__device__ __forceinline__ float to_float(T x) {
  if constexpr (is_bf16<T>())
    return __bfloat162float(x);
  else
    return x;
}

// one element through the read-only cache, widened
template <typename T>
__device__ __forceinline__ float ldg(const T* p) {
  return to_float(__ldg(p));
}

// x rounded to bf16 and widened back: what the TPU kernels do to P before
// the P V product at bf16 (p.astype(v.dtype)). Exact in TF32 as well.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool CG, typename V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (CG)
    return __ldcg(p);
  else
    return __ldg(p);
}

// N neighbouring elements of T at p, N * sizeof(T) bytes, read in 16-byte
// accesses where that is a multiple of 16 and else in one access of 8, 4
// or 2 bytes (p aligned to the access), widened into x[0, N); zeros and no
// read where !in. CG reads through L2 only (data other blocks wrote during
// the launch).
template <int N, bool CG = false, typename T>
__device__ __forceinline__ void load(float* x, const T* p, bool in) {
  constexpr int B = N * (int)sizeof(T);
  if constexpr (B == 2) {
    const unsigned short u =
        in ? ld<CG>(reinterpret_cast<const unsigned short*>(p))
           : (unsigned short)0;
    x[0] = widen(u);
  } else {
    constexpr int NW = B / 4;   // 32-bit words
    uint32_t w[NW];
    if constexpr (B % 16 == 0) {
#pragma unroll
      for (int i = 0; i < B / 16; ++i) {
        const uint4 v = in ? ld<CG>(reinterpret_cast<const uint4*>(p) + i)
                           : make_uint4(0u, 0u, 0u, 0u);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else if constexpr (B == 8) {
      const uint2 v = in ? ld<CG>(reinterpret_cast<const uint2*>(p))
                         : make_uint2(0u, 0u);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      static_assert(B == 4, "accesses of 2, 4, 8 or 16n bytes");
      w[0] = in ? ld<CG>(reinterpret_cast<const unsigned*>(p)) : 0u;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (is_bf16<T>()) {
        x[2 * i] = widen(w[i] & 0xffffu);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        x[i] = __uint_as_float(w[i]);
      }
    }
  }
}

// x[0, N) times scale, stored as N neighbouring elements of T at p in the
// accesses `load` reads them with.
template <int N, typename T>
__device__ __forceinline__ void store(T* p, const float* x, float scale) {
  constexpr int B = N * (int)sizeof(T);
  if constexpr (B == 2) {
    *p = from_float<T>(x[0] * scale);
  } else {
    constexpr int NW = B / 4;
    uint32_t w[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (is_bf16<T>()) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(x[2 * i] * scale, x[2 * i + 1] * scale);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      } else {
        w[i] = __float_as_uint(x[i] * scale);
      }
    }
    if constexpr (B % 16 == 0) {
#pragma unroll
      for (int i = 0; i < B / 16; ++i)
        reinterpret_cast<uint4*>(p)[i] =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    } else if constexpr (B == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      static_assert(B == 4, "accesses of 2, 4, 8 or 16n bytes");
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

}  // namespace elem
