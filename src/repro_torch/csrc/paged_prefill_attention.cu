// Paged GQA chunked-prefill attention for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill_attention/kernel.py
// :: paged_prefill_attention_gqa (body _paged_prefill_kernel): a chunk of C
// query rows per serving slot, flattened c-major to C * G rows per kv head
// (row = c * G + g), attends causally by global position to the slot's
// resident pages plus the chunk's own keys, which the caller has already
// written into the pool. A pure reader, like the TPU kernel. Same live walk
// [pages_start, pages_end), sliding window, re-mask and l == 0 guard.
//
// What bounds it: bytes. A block reads each of the slot's total * D K and V
// floats once and uses them for all of its rows, so at the main path's
// chunk of C = 16 rows and G = 1 it does about 8 flops per byte, below the
// H100's fp32 ridge of about 20 (67 TFLOP/s / 3.35 TB/s). The least time is
// the K/V bytes over 3.35 TB/s.
//
// Design: one block per (slot b, kv head h, block of <= 16 chunk rows),
// launched as a (B, K, ceil(C * G / 16)) grid of 128 threads; the page walk,
// masks and online softmax are the shared paged_attention.cuh body, with
// the row's position start[b] + row / G and the key limit total[b] read
// from device memory. Padded chunk rows (c >= n_new) attend to the keys
// below total[b] and give values the caller drops; a row with no valid key
// (an idle slot, total = 0) writes exactly 0. No wgmma or TMA yet.
#include "paged_attention.cuh"

namespace {

__global__ void __launch_bounds__(paged::kThreads)
paged_prefill_kernel(const float* __restrict__ q,
                     const float* __restrict__ k_pages,
                     const float* __restrict__ v_pages,
                     const int* __restrict__ page_table,
                     const int* __restrict__ start,
                     const int* __restrict__ total, float* __restrict__ out,
                     int K, int CG, int G, int D, int ps, int MP,
                     int pages_start, int pages_end, int window) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.z * paged::kRowBlock;
  const int rows = min(paged::kRowBlock, CG - row0);
  const size_t off = (((size_t)b * K + h) * CG + row0) * D;
  paged::walk_pages(q + off, k_pages, v_pages, page_table + (size_t)b * MP,
                    out + off, rows, row0, G, start[b], total[b], h, K, D,
                    ps, pages_start, pages_end, window);
}

}  // namespace

// q, out: (B, K, C, G, D); k_pages, v_pages: (P, ps, K, D); page_table:
// (B, MP) int32; start, total: (B,) int32. All contiguous, on the device of
// `stream`. Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_prefill_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* page_table, const int* start, const int* total, float* out,
    int B, int K, int C, int G, int D, int ps, int MP, int pages_start,
    int pages_end, int window, void* stream) {
  const int CG = C * G;
  const int rows = CG < paged::kRowBlock ? CG : paged::kRowBlock;
  const size_t smem = paged::smem_floats(rows, D, ps) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, K, (CG + paged::kRowBlock - 1) / paged::kRowBlock);
  paged_prefill_kernel<<<grid, paged::kThreads, smem, (cudaStream_t)stream>>>(
      q, k_pages, v_pages, page_table, start, total, out, K, CG, G, D, ps, MP,
      pages_start, pages_end, window);
  return (int)cudaGetLastError();
}
