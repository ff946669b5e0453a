// What the two decode kernels (paged_decode_attention.cu and
// decode_attention.cu) share: a lane's columns of a key, value, query or
// output row of fp32 or bf16, read and written in accesses of up to 16
// bytes, and the online-softmax merge of two (m, l, accumulator) states.
#pragma once
#include <cuda_runtime.h>

#include "elem.cuh"

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

// A lane's NC columns of a row of T (fp32 or bf16), in groups of W
// neighbours, groups 32 W columns apart: group i starts at column
// 32 W i + W lane. Where VEC a group is read and written whole (up to 16
// bytes: 4 floats or 8 bf16 values; at most NC), else one element at a
// time. A fp32 workspace row of a bf16 kernel takes its rows' groups.
// Columns past D read 0 and are not stored; nothing is read where !ok. CG
// reads through L2 only (data other blocks wrote during the launch).
template <int NC, bool VEC, typename T>
__host__ __device__ constexpr int group_width() {
  constexpr int most = 16 / (int)sizeof(T);
  return VEC ? (NC < most ? NC : most) : 1;
}

template <int NC, int W, bool CG = false, typename T>
__device__ __forceinline__ void load_row(float (&x)[NC],
                                         const T* __restrict__ row,
                                         int lane, int D, bool ok) {
#pragma unroll
  for (int i = 0; i < NC / W; ++i) {
    const int c = 32 * W * i + W * lane;
    elem::load<W, CG>(x + W * i, row + c, ok && c < D);
  }
}

template <int NC, int W, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ row,
                                          const float (&x)[NC], float scale,
                                          int lane, int D) {
#pragma unroll
  for (int i = 0; i < NC / W; ++i) {
    const int c = 32 * W * i + W * lane;
    if (c < D) elem::store<W>(row + c, x + W * i, scale);
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
