// Paged GQA decode attention for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention/kernel.py
// :: paged_decode_attention_gqa (body _paged_kernel): one decode query per
// serving slot and query head attends to that slot's K/V pages through the
// page table, with the live walk [pages_start, pages_end), an optional
// sliding window, the explicit re-mask after the max and the l == 0 -> 0
// guard.
//
// What bounds it: bytes. Each (slot, kv head) reads len * D floats of K and
// of V once and does 4 * G * D flops per key, so at the main path's shapes
// (G = 1, fp32) it does about 0.5 flop per byte, far below the H100's fp32
// ridge of about 20 (67 TFLOP/s / 3.35 TB/s). The least time is the K/V
// bytes over 3.35 TB/s.
//
// Design: one block per (slot b, kv head h, block of <= 16 query rows of the
// head's group), launched as a (B, K, ceil(G / 16)) grid of 128 threads. The
// block walks the pages itself (paged_attention.cuh): page ids come from the
// device page table, each page's K and V tiles are read with consecutive
// threads on consecutive d (coalesced), and m, l and the accumulator stay in
// shared memory for the whole walk, so nothing but q, the pages read and the
// output touches device memory. No wgmma or TMA yet: each (row, key) score
// is a warp-wide dot product, which is enough at G = 1, where a tensor-core
// tile would sit mostly empty.
#include "paged_attention.cuh"

namespace {

__global__ void __launch_bounds__(paged::kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, float* __restrict__ out,
                    int K, int G, int D, int ps, int MP, int pages_start,
                    int pages_end, int window) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.z * paged::kRowBlock;
  const int rows = min(paged::kRowBlock, G - row0);
  const int len = seq_lens[b];
  const size_t off = (((size_t)b * K + h) * G + row0) * D;
  // the decode query sits at position len - 1 and sees keys < len
  paged::walk_pages(q + off, k_pages, v_pages, page_table + (size_t)b * MP,
                    out + off, rows, row0, G, len - 1, len, h, K, D, ps,
                    pages_start, pages_end, window);
}

}  // namespace

// q, out: (B, K, G, D); k_pages, v_pages: (P, ps, K, D); page_table: (B, MP)
// int32; seq_lens: (B,) int32. All contiguous, on the device of `stream`.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_decode_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* page_table, const int* seq_lens, float* out, int B, int K,
    int G, int D, int ps, int MP, int pages_start, int pages_end, int window,
    void* stream) {
  const int rows = G < paged::kRowBlock ? G : paged::kRowBlock;
  const size_t smem = paged::smem_floats(rows, D, ps) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, K, (G + paged::kRowBlock - 1) / paged::kRowBlock);
  paged_decode_kernel<<<grid, paged::kThreads, smem, (cudaStream_t)stream>>>(
      q, k_pages, v_pages, page_table, seq_lens, out, K, G, D, ps, MP,
      pages_start, pages_end, window);
  return (int)cudaGetLastError();
}
