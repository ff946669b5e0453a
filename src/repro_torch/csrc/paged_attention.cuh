// Shared page walk of the two paged-attention kernels (decode and chunked
// prefill), fp32 in, fp32 accumulation, fp32 out.
//
// One thread block owns one (slot b, kv head h) pair and a block of at most
// kRowBlock query rows that all read that head. It loops over the slot's
// pages in [pages_start, pages_end) itself, skipping those that hold no key
// its rows can see, reads each physical page id from the device page
// table, and keeps the online-softmax statistics (m, l) and
// the rows x D accumulator in shared memory for the whole walk. This takes
// the place of the TPU kernels' sequential page grid axis with m/l/acc in
// VMEM scratch: on Hopper blocks run in parallel and in no order, so the
// sequential dimension becomes a loop inside the block.
//
// Masking is by global position, exactly as the TPU kernels mask: query row
// r sits at position qpos = qstart + (row0 + r) / group, and key position
// kpos is valid iff kpos <= qpos, kpos < total and, for a sliding window,
// qpos - kpos < window. Decode is the special case qstart = len - 1,
// total = len (every row of a head's group shares one position). Masked
// probabilities are zeroed after the max (a fully masked page would
// otherwise count exp(NEG_INF - NEG_INF) = 1), and a row with l == 0 (idle
// slot, padded chunk row) writes 0.
//
// Layouts: q and out are rows x D contiguous for this block; k_pages and
// v_pages are the (P, ps, K, D) pool of one layer; pt_row is the slot's row
// of the (B, MP) int32 page table.
#pragma once

#include <cuda_runtime.h>

namespace paged {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBlock = 16;   // query rows per block

// Dynamic shared memory one block needs, in floats.
__host__ __device__ inline size_t smem_floats(int rows, int D, int ps) {
  return 2 * (size_t)rows * D     // q rows, accumulator
       + 2 * (size_t)ps * D       // one page of K and of V
       + (size_t)rows * ps        // scores, then probabilities
       + 3 * (size_t)rows;        // m, l, alpha
}

__device__ __forceinline__ bool key_valid(int kpos, int qpos, int total,
                                          int window) {
  return kpos <= qpos && kpos < total && (window == 0 || qpos - kpos < window);
}

__device__ inline void walk_pages(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ pt_row,
    float* __restrict__ out, int rows, int row0, int group, int qstart,
    int total, int h, int K, int D, int ps, int pages_start, int pages_end,
    int window) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sacc = sq + rows * D;
  float* sk = sacc + rows * D;
  float* sv = sk + ps * D;
  float* ss = sv + ps * D;
  float* sm = ss + rows * ps;
  float* sl = sm + rows;
  float* salpha = sl + rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < rows * D; i += kThreads) {
    sq[i] = q[i];
    sacc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }

  // Pages past the block's last visible key, or wholly before its rows'
  // windows, hold only masked keys. A fully masked page leaves m, l and the
  // accumulator exactly as they were (max unchanged, alpha = 1, p = 0), so
  // the walk skips them: it reads what this slot's data needs, not the
  // dispatch-wide bound.
  const int q_lo = qstart + row0 / group;
  const int q_hi = qstart + (row0 + rows - 1) / group;
  const int key_end = min(total, q_hi + 1);          // keys < key_end
  const int p_end = min(pages_end, key_end > 0 ? (key_end + ps - 1) / ps : 0);
  int p_begin = pages_start;
  if (window > 0 && q_lo - window + 1 > 0)
    p_begin = max(p_begin, (q_lo - window + 1) / ps);

  for (int p = p_begin; p < p_end; ++p) {
    // token 0 of the physical page, kv head h; tokens are K * D apart
    const size_t base = ((size_t)pt_row[p] * ps * K + h) * D;
    __syncthreads();   // the previous page's tiles are no longer read
    for (int i = tid; i < ps * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      const size_t off = base + (size_t)t * K * D + d;
      sk[i] = k_pages[off];
      sv[i] = v_pages[off];
    }
    __syncthreads();
    // scores: one warp per (row, token) dot product over D
    for (int e = warp; e < rows * ps; e += kWarps) {
      const int r = e / ps, t = e - r * ps;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += sq[r * D + d] * sk[t * D + d];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        const int qpos = qstart + (row0 + r) / group;
        ss[e] = key_valid(p * ps + t, qpos, total, window) ? s : kNegInf;
      }
    }
    __syncthreads();
    // online-softmax statistics: one warp per row
    for (int r = warp; r < rows; r += kWarps) {
      const int qpos = qstart + (row0 + r) / group;
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, ss[r * ps + t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        // explicit re-mask: on a fully masked page m_new may be kNegInf
        const float pe = key_valid(p * ps + t, qpos, total, window)
                             ? expf(ss[r * ps + t] - m_new) : 0.f;
        ss[r * ps + t] = pe;
        sum += pe;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        salpha[r] = alpha;
        sl[r] = alpha * sl[r] + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();
    // accumulator: one thread per (row, d)
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float a = sacc[i] * salpha[r];
      for (int t = 0; t < ps; ++t) a += ss[r * ps + t] * sv[t * D + d];
      sacc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const float l = sl[i / D];
    out[i] = sacc[i] / (l == 0.f ? 1.f : l);
  }
}

}  // namespace paged
