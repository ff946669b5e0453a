// What the two decode kernels (paged_decode_attention.cu and
// decode_attention.cu) share: a lane's columns of a key, value, query or
// output row, read and written in 16-, 8- or 4-byte accesses, and the
// online-softmax merge of two (m, l, accumulator) states.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// columns of a row a lane holds: head_dim rounded up to 32, 64, 128 or 256
__host__ __device__ inline int lane_cols(int D) {
  return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8;
}
// query rows of a block: G rounded up to 1, 2, 4 or 8; at most 4 at
// head_dim > 128, for registers
__host__ __device__ inline int block_rows(int G, int D) {
  const int r = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  return D > 128 && r > 4 ? 4 : r;
}
__host__ __device__ inline int row_blocks(int G, int D) {
  const int R = block_rows(G, D);
  return (G + R - 1) / R;
}
// floats of shared memory for one (warp, row) state: m, l, accumulator
__host__ __device__ constexpr int state_floats(int NC) { return 2 + 32 * NC; }

// A lane's NC columns of a row, in groups of W neighbours (16- or 8-byte
// accesses where VEC), groups 32 W columns apart: group i starts at column
// 32 W i + W lane. Columns past D read 0 and are not stored; nothing is
// read where !ok. CG reads through L2 only (data other blocks wrote during
// the launch).
template <int NC, bool VEC>
__host__ __device__ constexpr int group_width() {
  return VEC ? (NC < 4 ? NC : 4) : 1;
}

template <int NC, bool VEC, bool CG = false>
__device__ __forceinline__ void load_row(float (&x)[NC],
                                         const float* __restrict__ row,
                                         int lane, int D, bool ok) {
  constexpr int W = group_width<NC, VEC>();
#pragma unroll
  for (int i = 0; i < NC / W; ++i) {
    const int c = 32 * W * i + W * lane;
    const bool in = ok && c < D;
    if constexpr (W == 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) {
        const float4* p = reinterpret_cast<const float4*>(row + c);
        v = CG ? __ldcg(p) : __ldg(p);
      }
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    } else if constexpr (W == 2) {
      float2 v = make_float2(0.f, 0.f);
      if (in) {
        const float2* p = reinterpret_cast<const float2*>(row + c);
        v = CG ? __ldcg(p) : __ldg(p);
      }
      x[2 * i] = v.x;
      x[2 * i + 1] = v.y;
    } else {
      x[i] = in ? (CG ? __ldcg(row + c) : __ldg(row + c)) : 0.f;
    }
  }
}

template <int NC, bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ row,
                                          const float (&x)[NC], float scale,
                                          int lane, int D) {
  constexpr int W = group_width<NC, VEC>();
#pragma unroll
  for (int i = 0; i < NC / W; ++i) {
    const int c = 32 * W * i + W * lane;
    if (c >= D) continue;
    if constexpr (W == 4) {
      *reinterpret_cast<float4*>(row + c) =
          make_float4(x[4 * i] * scale, x[4 * i + 1] * scale,
                      x[4 * i + 2] * scale, x[4 * i + 3] * scale);
    } else if constexpr (W == 2) {
      *reinterpret_cast<float2*>(row + c) =
          make_float2(x[2 * i] * scale, x[2 * i + 1] * scale);
    } else {
      row[c] = x[i] * scale;
    }
  }
}

__device__ __forceinline__ float inverse(float l) {
  return 1.f / (l == 0.f ? 1.f : l);
}

// (M, L, A) absorbs the state (mi, li, x): both rescaled to their larger
// max. An empty state (m = -1e30, l = 0, acc = 0) adds exactly nothing.
template <int NC>
__device__ __forceinline__ void absorb(float& M, float& L, float (&A)[NC],
                                       float mi, float li,
                                       const float (&x)[NC]) {
  const float m_new = fmaxf(M, mi);
  const float a = expf(M - m_new), c = expf(mi - m_new);
  L = a * L + c * li;
#pragma unroll
  for (int j = 0; j < NC; ++j) A[j] = a * A[j] + c * x[j];
  M = m_new;
}

}  // namespace
