// Paged GQA chunked-prefill attention for Hopper (sm_90a): fp32 through
// 3xTF32 on the tensor cores, bf16 through native bf16 products. Two
// designs, one for each dtype, behind the entries
// paged_prefill_attention_f32 and _bf16.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill_attention/kernel.py
// :109 (paged_prefill_attention_gqa, body _paged_prefill_kernel): a chunk
// of C query rows per serving slot, flattened c-major to C * G rows per kv
// head (row = c * G + g, at position start[b] + row / G), attends causally
// by global position to the slot's resident pages plus the chunk's own
// keys, which the caller has already written into the pool. A pure reader,
// like the TPU kernel. Same live walk [pages_start, pages_end), sliding
// window (qpos - kpos < window), explicit re-mask after the max and l == 0
// guard: a row with no visible key (an idle slot, total = 0) writes 0.
//
// What bounds it: bytes. Every row of a (slot, kv head) reads the same
// keys, so the K and V floats are read once per block of rows: at the main
// path's chunk of 16 rows and G = 1 that is about 8 flops per byte, below
// the H100's fp32 ridge of about 20 (67 TFLOP/s / 3.35 TB/s). The least
// time is the K/V bytes over 3.35 TB/s, which needs many copies in flight
// on every SM; and the products, 0.53 GFLOP at the main shape, must cost
// less than the copies, so they run as 3xTF32 mma.sync (mma_tf32x3.cuh),
// which keeps fp32 accuracy.
//
// fp32 design:
// - The page walk is split across blocks, flash-decoding style. A block
//   owns one (slot b, kv head h, block of 16, 32 or 64 rows) and one split
//   of the slot's pages: kSplitKeys keys (8 pages at ps = 16), splits
//   aligned at multiples of that size from page 0. Each block works out
//   from the slot's own start/total (and the window) which pages its rows
//   can see (visible_pages, from each row's global position), and
//   exits at once if its split holds none of them. So what a block computes
//   depends on the slot's data alone, not on pages_end, B or the grid: the
//   same slot gives the same bits under any live bound and in any packing.
// - A (slot, row block) whose visible pages lie in one split normalises and
//   writes its output itself. Otherwise each split writes its partial
//   (m, l, unnormalised accumulator) to a workspace and counts itself done
//   on a per-row-block counter; the block that finishes last merges the
//   partials in split order (so the result does not depend on which one it
//   is). The entry zeroes the counters on the launch's stream before every
//   launch that uses them. The counter is the only atomic: no atomics touch
//   the data. A row block with no visible key at all is written with zeros
//   by the grid's first split. On the qwen pool's own calls, 59% of the
//   slot chunks span more than one split, and the splits take 19% less
//   device time than one block walking the whole slot: 7% less at the full
//   tier's 40 kv heads, 38% at the half tier's 20 (tools/replay_prefill.py
//   on an NVIDIA H100 80GB HBM3 at 700 W).
// - Inside a block, 4 warps. A warp owns 16 rows and a slice of each key
//   tile: at 16 rows (G = 1) each warp takes 8 of the tile's 32 keys and
//   keeps its own (m, l, accumulator); the four are merged in warp order at
//   the end of the split. At 32 rows, 2 warps per 16 rows take 16 keys each;
//   at 64 rows (GQA) every warp takes the whole tile. Each K and V element
//   a block copies is then split into TF32 halves by each warp of its key
//   slice's row groups: once at G = 1.
// - Key tiles of 32 keys (16 at D = 256 and 64 rows, to fit shared memory)
//   are copied with 16-byte cp.async (4-byte where D % 4 != 0) into
//   kStages = 2 stages, so the next tile's copy runs under this tile's
//   products. The split's page ids are read into shared memory in the same
//   round trip as start and total; a thread's copy addresses are a page
//   lookup per row, shifts within a row. Q's loads are in flight with them.
// - Q is split once per block into TF32 hi and lo planes in shared memory
//   and read by ldmatrix; K's B fragments by ldmatrix from the raw tile,
//   split in registers. P stays in registers: the score product's C
//   fragment is P V's A fragment with its k index permuted (k = t -> key
//   2t, k = t + 4 -> key 2t + 1), and V's B fragment is read from the raw
//   (key, d) tile under the same permutation, two conflict-free scalar
//   loads (the row stride is 4 mod 32 floats).
// - Shared memory at D = 128 and 16 rows is 84.5 KB, so 2 blocks (8
//   warps) an SM. Where the time goes at the main shape on an NVIDIA H100
//   80GB HBM3 at 700 W (an instrumented copy, tools/prefill_variants.py "phases"): a
//   block's products take 40% of its clocks, waiting for tiles 21%, the
//   merges 26% and the setup 12%; without any products the kernel still
//   takes 70% of its time, so round trips to memory, not the tensor
//   cores, bound it.
// - D is zero-padded to a multiple of 16 (zero columns add 0 to Q K^T;
//   the padded output columns are never stored). Rows past C * G in the
//   last row block are padding that repeats the last row's position.
//
// bf16 design (paged_prefill_attention_bf16, bf16_prefill::
// paged_prefill_kernel_bf16; the TPU kernel takes either dtype): q, the
// pages and out bf16; the scores, the softmax, the accumulator and the
// workspace fp32. It is the TPU body at bf16: the scores summed in fp32
// from bf16 products, the mask by global position and the re-mask after
// the max, P rounded to bf16 for P V (pexp.astype(v.dtype)) while l sums
// the unrounded P, the l == 0 guard, the output rounded to bf16 once.
// Every operand of both products is then a bf16 value, so each product is
// one native bf16 mma.sync m16n8k16 (mma_bf16.cuh) with fp32
// accumulation: exact, at twice TF32's rate and k depth. The bytes halve
// against fp32, and it stays bytes-bound.
// - The walk is the fp32 design's: the same 128-key splits from page 0,
//   visible_pages, the zero write of a row block with no visible key, the
//   warps merged in warp order and the splits in split order by the last
//   block through the per-row-block count; so packed equals per-slot and
//   the live walk the static walk, bit for bit, at bf16 as at fp32.
// - A warp's slice of a key tile is whole k16 steps (16 keys: two m16n8
//   score tiles, one P V step): at 16 rows (G = 1) the 4 warps take 16
//   keys each of a 64-key tile, so a 128-key split is two tiles; at 32
//   rows 2 warps a 16-row group take 32 keys each; at 64 rows every warp
//   takes the whole tile. At D = 256, 32-key tiles from 32 rows up (64 at
//   16 rows, the least that gives 4 warps 16 keys each).
// - Tiles stay bf16 in shared memory and nothing is widened: a Q tile (16
//   RW x DT, DT the instance's width: D zero-padded to 32, 64, 128 or 256)
//   and a ring of kStages = 2 K/V stages (TK x DT each) fed by 16-byte
//   cp.async, one page lookup a key row (from spage); at D = 128 and 16
//   rows the ring holds a whole split, so tile 2's copy is in flight while
//   tile 1 is multiplied. Each row's 16-byte chunks are swizzled (chunk c
//   of row r at c ^ (r % 8), or c ^ ((r / 2) % 4) at DT = 32), so that
//   the 8 rows of an ldmatrix matrix and the 8 chunks of a quarter-warp's
//   cp.async hit 8 distinct bank groups, with no padding.
// - Q's A fragments are read by ldmatrix once per block and kept in
//   registers at DT <= 128 (32 registers at D = 128); at DT = 256 they are
//   read from the Q tile at every k step. K's B fragments come from the
//   (key, d) tile by ldmatrix x4 (two n-tiles of a k step), V's by
//   ldmatrix.trans from the same layout.
// - P never leaves registers: the C fragments of score tiles 2j and 2j +
//   1, packed to bf16 pairs (cvt.rn.bf16x2.f32), are the A fragment of
//   P V's k step j.
// - exp(x - m) is 2^(x log2 e - m log2 e) on the special-function unit
//   (ex2.approx), one FFMA and one ex2; m stays in natural units, the
//   workspace's that merge_splits_if_last reads, and alpha is exactly 1
//   where m does not move, so a slice that adds nothing leaves the bits.
// - The warps of each 16 rows merge in warp order through the ring, each
//   warp for its own quarter (half) of the output tiles: every warp runs
//   the same (m, l) sequence and applies its weights to its tiles, so no
//   warp waits on one that merges alone.
// - Occupancy: at 16 rows and DT <= 128 the registers are capped for
//   three blocks an SM (12 warps; shared memory holds three), and the
//   last block's split merge loads one split's partials at a time (four
//   in flight needed registers past the cap); 4 at 32 and 64 rows, 2 at
//   DT = 256, where registers hold two blocks.
// - Rows whose D is not a multiple of 8, or a pool or q not 16-byte
//   aligned (head_dim 18), take the same design with 2-byte loads and
//   shared stores in place of cp.async: slower, the same results.
// - Shared memory a block (dynamic and static): 68.5 KB at D = 128 and 16
//   rows, 72.5 at 32, 80.5 at 64; 136.5, 82.5 and 98.5 KB at D = 256;
//   34.5-40.5 at D = 64, 17.5-20.5 at D = 32. ptxas (CUDA 12.8; 16-byte
//   path, 2-byte path in parentheses): 168 (168) registers at D = 128 and
//   16 rows, 195 (205) at 32, 215 (223) at 64; 215 (227), 213 (222) and
//   237 (246) at D = 256; 101-161 (113-165) at D <= 64; no spills.
// - Measured by tools/compare_kernel.py on an NVIDIA H100 80GB HBM3 at
//   700 W, in turns with the fp32 design widened to bf16 that this
//   replaces (device ms): 0.0251 against 0.0478 at the main shape (16
//   rows, G = 1), 0.0178 against 0.0381 at Jamba's (64 rows), 0.0397
//   against 0.0680 at gemma3's (32 rows, D = 256, window 1024); the qwen
//   pool's own 214 calls 2.38 against 4.42 device ms in all
//   (tools/replay_prefill.py --bf16). tools/prefill_variants.py: four
//   splits in flight with no register cap (two blocks an SM) 18% slower
//   at the main shape; three blocks with two in flight spill; 128-key
//   tiles at D <= 128 and 64-key tiles at D = 256 slower. Where a main
//   block's clocks go ("phases"): the split merge 27% (the count's
//   atomic included), the warp merge and stores 20%, the products 18%,
//   the first tile's copies 17%, waiting for tiles 16%.
//
// Layouts: q, out (B, K, C, G, D) contiguous; k_pages, v_pages the
// (P, ps, K, D) pool of one layer; page_table (B, MP) int32; start, total
// (B,) int32; the workspace, where the walk spans more than one split,
// (B, K, NS, C * G, D) and (B, K, NS, C * G, 2) fp32, NS the number of
// splits the grid spans, then one int32 count per row block. The entries
// at the end tell the wrapper the shared memory and workspace a launch
// needs, so that the geometry lives in this file alone.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "smem_copy.cuh"

// Knobs and hooks that tools/prefill_variants.py sets with -D to build the
// designs it times; the defaults are the shipped kernel.
#ifndef PREFILL_SPLIT_KEYS
#define PREFILL_SPLIT_KEYS 128   // keys of one split (whole pages)
#endif
#ifndef PREFILL_STAGES
#define PREFILL_STAGES 2         // key tiles in flight or in use
#endif
#ifndef PREFILL_KEY_TILE
#define PREFILL_KEY_TILE 32      // keys of a tile at D <= 128
#endif
#ifndef PREFILL_MIN_BLOCKS
#define PREFILL_MIN_BLOCKS 1     // blocks an SM (__launch_bounds__)
#endif
#ifndef PREFILL_SKIP
#define PREFILL_SKIP 0           // ablations, wrong outputs: 1 no Q K^T,
#endif                           // 2 no P V, 4 no products at all
#ifdef PREFILL_PHASES            // clocks by phase: tools/prefill_phases.cuh
#include "prefill_phases.cuh"
#else
#define PHASE_BEGIN()
#define PHASE_MARK(i)
#define PHASE_TILE_BEGIN()
#define PHASE_TILE_WAITED()
#define PHASE_TILE_USED()
#define PHASE_RECORD(tiles, single)
#endif

namespace {

using tilecopy::cp_async16;
using tilecopy::cp_async4;
using tilecopy::ldsm_x4;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSplitKeys = PREFILL_SPLIT_KEYS;
constexpr int kNG = 2;            // m16n8 output tiles per P V group
constexpr int kStages = PREFILL_STAGES;
constexpr int kSkip = PREFILL_SKIP;
constexpr int kMaxDevices = 64;

// pages of one split: kSplitKeys keys, at least one page
__host__ __device__ inline int split_pages(int ps) {
  return ps >= kSplitKeys ? 1 : kSplitKeys / ps;
}
__host__ __device__ inline int padded(int D) { return (D + 15) & ~15; }
// Q and K rows: 4 x an odd number of floats, so the 8 rows of an ldmatrix
// start in 8 distinct 16-byte bank groups, and V's loads at rows 2t, 2t + 1
// and column g hit 32 distinct banks
__host__ __device__ inline int row_stride(int D) { return padded(D) + 4; }
// 16-row warp groups of a block: enough for C * G rows, at most 4
__host__ __device__ inline int row_warps(int CG) {
  return CG <= 16 ? 1 : CG <= 32 ? 2 : 4;
}
__host__ __device__ constexpr int key_tile(int DT, int RW) {
  return DT > 128 ? (RW == 4 ? 16 : 32) : PREFILL_KEY_TILE;
}
// head_dim rounded up to the kernel instance that takes it
__host__ __device__ inline int dim_tile(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}
__host__ __device__ inline int row_blocks(int CG) {
  return (CG + 16 * row_warps(CG) - 1) / (16 * row_warps(CG));
}
// splits the grid spans: those of pages [pages_start, pages_end)
__host__ __device__ inline int n_splits(int ps, int pages_start,
                                        int pages_end) {
  const int SP = split_pages(ps);
  return (pages_end + SP - 1) / SP - pages_start / SP;
}

// floats a lane keeps for the merge of a block's warps (m, l and its
// output tiles inside padded(D)), in the stage buffers after the walk
__host__ __device__ inline int merge_floats(int D) { return padded(D) / 2 + 4; }

// Dynamic shared memory of one block, in bytes: Q's hi and lo planes, and
// kStages stages of raw K and V tiles, which the merge of the warps then
// reuses.
__host__ __device__ inline size_t smem_bytes(int D, int DT, int RW) {
  const int KW = kWarps / RW;
  const size_t stages = sizeof(float) * (size_t)2 * kStages *
                        key_tile(DT, RW) * row_stride(D);
  const size_t merge = sizeof(float) * (size_t)RW * (KW - 1) *
                       merge_floats(D) * 32;
  return sizeof(float) * (size_t)2 * 16 * RW * row_stride(D) +
         (stages > merge ? stages : merge);
}

// The pages [p_begin, p_end) that rows [row0, row0 + rows) of a slot can
// see: none past the last row's own key or past total, none wholly before
// the first row's window. From the slot's start and total alone (and
// pages_end, which the caller guarantees covers total).
__device__ __forceinline__ void visible_pages(int qstart, int total, int row0,
                                              int rows, int G, int ps,
                                              int pages_start, int pages_end,
                                              int window, int& p_begin,
                                              int& p_end) {
  const int q_lo = qstart + row0 / G;
  const int q_hi = qstart + (row0 + rows - 1) / G;
  const int key_end = min(total, q_hi + 1);
  p_end = min(pages_end, key_end > 0 ? (key_end + ps - 1) / ps : 0);
  p_begin = pages_start;
  if (window > 0 && q_lo - window + 1 > 0)
    p_begin = max(p_begin, (q_lo - window + 1) / ps);
}

// Copy four floats at column c of a key row (`row` = its first float) to
// dst; zero past D, and all four where the key is not `in` the split.
// VEC: one 16-byte copy; else four copies of 4 bytes.
template <bool VEC>
__device__ __forceinline__ void copy4(float* dst, const float* row, bool in,
                                      int c, int D, const float* any) {
  if constexpr (VEC) {
    const bool ok = in && c < D;
    cp_async16(dst, ok ? row + c : any, ok);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = in && c + i < D;
      cp_async4(dst + i, ok ? row + c + i : any, ok);
    }
  }
}

// The row block's split partials merged, by the block whose split finished
// last (the count of finished splits is kept per row block in `count`,
// which the entry zeroes before the launch). The same arithmetic whichever block is
// last, in split order: a running M = max m_i, L = sum exp(m_i - M) l_i
// and acc = sum exp(m_i - M) acc_i (both rescaled when M grows between
// chunks of SC splits), then out = acc / L. A split with no visible key
// (m = -1e30, l = 0, acc = 0) adds exactly 0, and a row with no visible
// key in any split writes 0. `first`: the partial index of the first
// split; `head`: the (slot, kv head) index. Each warp takes up to 4 rows,
// and all the loads of SC splits of them are issued before any is used:
// one round trip to L2 for up to SC splits.
template <typename T, int DT, int ROWS, int SC = (DT > 128 ? 2 : 4)>
__device__ void merge_splits_if_last(T* __restrict__ out,
                                     const float* __restrict__ ws_acc,
                                     const float* __restrict__ ws_ml,
                                     int* count, size_t first, int n,
                                     size_t head, int row0, int rows, int CG,
                                     int D) {
  constexpr int RC = ROWS / kWarps < 4 ? ROWS / kWarps : 4;
  constexpr int NC = DT / 32;
  __shared__ bool last;
  __syncthreads();   // every warp's part of the partial is stored
  if (threadIdx.x == 0) {
    // release: the block's partial, ordered before by the barrier, is
    // visible to whoever sees the count; acquire: so are the others'
    unsigned done;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(done) : "l"(count) : "memory");
    last = done == (unsigned)n - 1;
  }
  __syncthreads();
  if (!last) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rb = warp; rb < rows; rb += kWarps * RC) {
    float M[RC], L[RC], a[RC][NC];
#pragma unroll
    for (int rr = 0; rr < RC; ++rr) {
      M[rr] = kNegInf;
      L[rr] = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) a[rr][j] = 0.f;
    }
    for (int i0 = 0; i0 < n; i0 += SC) {
      float mi[SC][RC], li[SC][RC], x[SC][RC][NC];
#pragma unroll
      for (int i = 0; i < SC; ++i)
#pragma unroll
        for (int rr = 0; rr < RC; ++rr) {
          const bool in = i0 + i < n && rb + kWarps * rr < rows;
          const size_t at = (first + i0 + i) * CG + row0 + rb + kWarps * rr;
          mi[i][rr] = in ? __ldcg(ws_ml + 2 * at) : kNegInf;
          li[i][rr] = in ? __ldcg(ws_ml + 2 * at + 1) : 0.f;
#pragma unroll
          for (int j = 0; j < NC; ++j)
            x[i][rr][j] = in && lane + 32 * j < D
                              ? __ldcg(ws_acc + at * D + lane + 32 * j) : 0.f;
        }
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        float m_new = M[rr];
#pragma unroll
        for (int i = 0; i < SC; ++i) m_new = fmaxf(m_new, mi[i][rr]);
        const float scale = expf(M[rr] - m_new);
        L[rr] *= scale;
#pragma unroll
        for (int j = 0; j < NC; ++j) a[rr][j] *= scale;
#pragma unroll
        for (int i = 0; i < SC; ++i) {
          const float w = expf(mi[i][rr] - m_new);
          L[rr] += w * li[i][rr];
#pragma unroll
          for (int j = 0; j < NC; ++j) a[rr][j] += w * x[i][rr][j];
        }
        M[rr] = m_new;
      }
    }
#pragma unroll
    for (int rr = 0; rr < RC; ++rr) {
      if (rb + kWarps * rr >= rows) continue;
      const float inv = 1.f / (L[rr] == 0.f ? 1.f : L[rr]);
      T* orow = out + (head * CG + row0 + rb + kWarps * rr) * D;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (lane + 32 * j < D)
          orow[lane + 32 * j] = elem::from_float<T>(a[rr][j] * inv);
    }
  }
}

template <int DT, bool VEC, int RW>
__global__ void __launch_bounds__(kThreads, PREFILL_MIN_BLOCKS)
paged_prefill_kernel(const float* __restrict__ q,
                     const float* __restrict__ k_pages,
                     const float* __restrict__ v_pages,
                     const int* __restrict__ page_table,
                     const int* __restrict__ start,
                     const int* __restrict__ total, float* __restrict__ out,
                     float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                     int* __restrict__ counters, int K, int CG, int G, int D,
                     int ps, int MP, int pages_start, int pages_end,
                     int window, int NS) {
  constexpr int KW = kWarps / RW;        // warps per 16 rows
  constexpr int ROWS = 16 * RW;
  constexpr int TK = key_tile(DT, RW);   // keys per tile
  constexpr int NT = TK / 8 / KW;        // m16n8 score tiles per warp
  constexpr int kDT = DT / 8;            // k steps of Q K^T, n tiles of P V
  constexpr int NACC = NT == 1 ? 4 : 2;  // score accumulator sets
  constexpr int CPR = DT / 4;            // Q's 4-float chunks of a row
  constexpr int CPC = DT / 4;            // copied chunks of a key row
  constexpr int NK = TK * CPC / kThreads;  // chunks a thread copies
  static_assert(NT >= 1 && NK * kThreads == TK * CPC && kThreads % CPC == 0,
                "tiles must split evenly over warps and threads");
  extern __shared__ __align__(16) float smem[];
  __shared__ int spage[kSplitKeys];      // the split's physical page ids

  const int Dp = padded(D), RS = row_stride(D);
  float* qh = smem;                      // ROWS x RS, TF32 hi of Q
  float* ql = qh + ROWS * RS;            // and lo
  float* kbuf = qh + 2 * ROWS * RS;      // stages of (K, V), TK x RS each

  const int SP = split_pages(ps);
  const int s0 = pages_start / SP;
  const int s = s0 + blockIdx.x;
  const int n_rb = (CG + ROWS - 1) / ROWS;
  const int h = blockIdx.y / n_rb;
  const int row0 = (blockIdx.y - h * n_rb) * ROWS;
  const int b = blockIdx.z;
  const int rows = min(ROWS, CG - row0);
  const int kr = threadIdx.x / CPR, kc = 4 * (threadIdx.x % CPR);
  const int cr = threadIdx.x / CPC, cc = 4 * (threadIdx.x % CPC);
  // Q's rows, zero past C * G and past D, read 4 chunks (16 floats) a
  // thread at a time and split into planes
  const float* qb = q + ((size_t)b * K + h) * CG * D + (size_t)row0 * D;
  constexpr int QN = ROWS / (kThreads / CPR);   // Q chunks of a thread
  static_assert(QN * (kThreads / CPR) == ROWS, "Q chunks tile the rows");
  auto load_q = [&](int i0, float (&x)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = kr + (i0 + i) * (kThreads / CPR);
        x[i][e] = i0 + i < QN && kc < Dp && r < rows && kc + e < D
                      ? __ldg(qb + (size_t)r * D + kc + e) : 0.f;
      }
  };
  auto split_q = [&](int i0, const float (&x)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = kr + (i0 + i) * (kThreads / CPR);
      if (i0 + i >= QN || kc >= Dp) continue;
      uint4 hi, lo;
      tf32x3::split(x[i][0], hi.x, lo.x);
      tf32x3::split(x[i][1], hi.y, lo.y);
      tf32x3::split(x[i][2], hi.z, lo.z);
      tf32x3::split(x[i][3], hi.w, lo.w);
      *reinterpret_cast<uint4*>(qh + r * RS + kc) = hi;
      *reinterpret_cast<uint4*>(ql + r * RS + kc) = lo;
    }
  };
  // the split's page ids, read in the same round trip as start and total
  // (those past the slot's visible pages are read and never used)
  const int* pt_row = page_table + (size_t)b * MP;
  for (int i = threadIdx.x; i < SP && s * SP + i < MP; i += kThreads)
    spage[i] = pt_row[s * SP + i];
  const int qstart = start[b], tot = total[b];
  int p_begin, p_end;
  visible_pages(qstart, tot, row0, rows, G, ps, pages_start, pages_end,
                window, p_begin, p_end);
  if (p_end <= p_begin) {   // no visible key: the grid's first split
    if (blockIdx.x == 0)     // writes the rows' zeros
      for (int i = threadIdx.x; i < rows * D; i += kThreads)
        out[(((size_t)b * K + h) * CG + row0) * D + i] = 0.f;
    return;
  }
  const int s_begin = p_begin / SP, s_end = (p_end + SP - 1) / SP;
  if (s < s_begin || s >= s_end) return;
  PHASE_BEGIN();

  // this split's pages [pa, pb) and keys [k_lo, k_hi); tiles of TK keys
  // from the split's first key
  const int pa = max(s * SP, p_begin), pb = min((s + 1) * SP, p_end);
  const int ksplit = s * SP * ps;
  const int k_lo = pa * ps, k_hi = pb * ps;
  const int j_begin = (k_lo - ksplit) / TK;
  const int j_end = (k_hi - ksplit + TK - 1) / TK;

  // start copying tile j into its stage (nothing past the split's last
  // tile: the group stays empty)
  auto copy_tile = [&](int j) {
    float* ks = kbuf + (j - j_begin) % kStages * 2 * TK * RS;
    float* vs = ks + TK * RS;
    if (cc < Dp && j < j_end) {
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int r = cr + i * (kThreads / CPC);
        const int key = ksplit + j * TK + r;
        const bool in = key >= k_lo && key < k_hi;
        const int rel = key - ksplit;
        const int pl = in ? rel / ps : 0;
        const size_t row =
            (((size_t)spage[pl] * ps + (rel - pl * ps)) * K + h) * D;
        copy4<VEC>(ks + r * RS + cc, k_pages + (in ? row : 0), in, cc, D,
                   k_pages);
        copy4<VEC>(vs + r * RS + cc, v_pages + (in ? row : 0), in, cc, D,
                   v_pages);
      }
    }
    asm volatile("cp.async.commit_group;");
  };
  // the first Q chunks in flight with the page ids; then the first tiles'
  // copies, and Q split into planes while they are in flight
  float xq[4][4];
  load_q(0, xq);
  __syncthreads();   // the page ids are in
  PHASE_MARK(1);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) copy_tile(j_begin + i);
  split_q(0, xq);
  for (int i0 = 4; i0 < QN; i0 += 4) {
    load_q(i0, xq);
    split_q(i0, xq);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / KW, kg = warp - rg * KW;
  const int wr0 = row0 + 16 * rg;        // this warp's first row
  // positions of rows g and g + 8, and of the warp's first and last rows;
  // padding rows repeat the last row's position
  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qp[r] = qstart + min(wr0 + g + 8 * r, CG - 1) / G;
  const int wq_lo = qstart + min(wr0, CG - 1) / G;
  const int wq_hi = qstart + min(wr0 + 15, CG - 1) / G;
  const int mi = lane >> 3, mr = lane & 7;
  // Q's A fragment: matrices (rows 0-7 | 8-15) x (cols 0-3 | 4-7)
  const float* qa = qh + (16 * rg + mr + 8 * (mi & 1)) * RS + 4 * (mi >> 1);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kDT / kNG][kNG][4];   // output tile n is o[n / kNG][n % kNG]
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n / kNG][n % kNG][i] = 0.f;

  PHASE_MARK(2);
  for (int j = j_begin; j < j_end; ++j) {
    PHASE_TILE_BEGIN();
    copy_tile(j + kStages - 1);   // in flight while this tile is used
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncthreads();   // tile j landed (and Q's planes are in)
    PHASE_TILE_WAITED();
    const float* ks = kbuf + (j - j_begin) % kStages * 2 * TK * RS;
    const float* vs = ks + TK * RS;
    // this warp's keys [kw0, kw0 + 8 NT)
    const int kw0 = ksplit + j * TK + 8 * NT * kg;
    const int kw1 = kw0 + 8 * NT - 1;
    const bool any = kw0 < k_hi && kw1 >= k_lo && kw0 <= wq_hi &&
                     kw0 < tot && (window == 0 || wq_lo - kw1 < window);
    if (any && !(kSkip & 4)) {
      // scores: s[jn] is the m16n8 tile of keys kw0 + 8 jn ..; k steps go
      // round NACC accumulator sets, so that independent chains of
      // mma.sync hide the tensor cores' latency
      float sa[NACC][NT][4];
#pragma unroll
      for (int a = 0; a < NACC; ++a)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int i = 0; i < 4; ++i) sa[a][jn][i] = 0.f;
      // K's B fragments for two k steps of one n tile: cols 0-3, 4-7,
      // 8-11, 12-15 of keys g (lane 4 g + t: column t of each)
      const float* kf = ks + (8 * NT * kg + mr) * RS + 4 * mi;
#pragma unroll
      for (int kk = 0; kk < kDT; kk += 2) {
        if (8 * kk >= Dp) break;
        uint32_t x[NT][4];
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
          ldsm_x4(x[jn], kf + 8 * jn * RS + 8 * kk);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
          ldsm_x4(ah, qa + 8 * (kk + hf));
          ldsm_x4(al, qa + ROWS * RS + 8 * (kk + hf));
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            tf32x3::split(__uint_as_float(x[jn][2 * hf]), bh[jn][0],
                          bl[jn][0]);
            tf32x3::split(__uint_as_float(x[jn][2 * hf + 1]), bh[jn][1],
                          bl[jn][1]);
          }
          if constexpr (!(kSkip & 1))
            tf32x3::mma3(sa[(kk + hf) % NACC], ah, al, bh, bl);
        }
      }
      float sc[NT][4];
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = sa[0][jn][i];
#pragma unroll
          for (int a = 1; a < NACC; ++a) v += sa[a][jn][i];
          sc[jn][i] = v;
        }

      // mask only where some key of the slice is not visible to some row;
      // `ok` keeps which are, for the re-mask after the max
      uint32_t ok = 0xffffffffu;
      if (!(kw0 >= k_lo && kw1 < k_hi && kw1 <= wq_lo && kw1 < tot &&
            (window == 0 || wq_hi - kw0 < window))) {
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qpos = qp[i >> 1];
            const int kpos = kw0 + 8 * jn + 2 * t + (i & 1);
            const bool v = kpos >= k_lo && kpos < k_hi && kpos <= qpos &&
                           kpos < tot &&
                           (window == 0 || qpos - kpos < window);
            if (!v) {
              sc[jn][i] = kNegInf;
              ok &= ~(1u << (4 * jn + i));
            }
          }
      }

      // online softmax of rows g (r = 0: elements 0, 1) and g + 8 (r = 1:
      // elements 2, 3), with the re-mask: a masked key adds exactly 0 even
      // where m is still -1e30
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
          mx = fmaxf(mx, fmaxf(sc[jn][2 * r], sc[jn][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            sc[jn][e] = (ok >> (4 * jn + e)) & 1u ? expf(sc[jn][e] - m_new)
                                                  : 0.f;
            sum += sc[jn][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = alpha * l[r] + sum;
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          o[n / kNG][n % kNG][2 * r] *= alpha;
          o[n / kNG][n % kNG][2 * r + 1] *= alpha;
        }
      }

      // o += P V: k step jn takes score tile jn as its A fragment, k = t
      // as key 8 jn + 2 t and k = t + 4 as key 8 jn + 2 t + 1
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        uint32_t ah[4], al[4];
        tf32x3::split(sc[jn][0], ah[0], al[0]);
        tf32x3::split(sc[jn][2], ah[1], al[1]);
        tf32x3::split(sc[jn][1], ah[2], al[2]);
        tf32x3::split(sc[jn][3], ah[3], al[3]);
        const float* vf = vs + (8 * NT * kg + 8 * jn + 2 * t) * RS + g;
#pragma unroll
        for (int ng = 0; ng < kDT / kNG; ++ng) {
          if (8 * kNG * ng >= Dp) break;
          uint32_t bh[kNG][2], bl[kNG][2];
#pragma unroll
          for (int i = 0; i < kNG; ++i) {
            const int c = 8 * (kNG * ng + i);
            tf32x3::split(vf[c], bh[i][0], bl[i][0]);
            tf32x3::split(vf[RS + c], bh[i][1], bl[i][1]);
          }
          if constexpr (!(kSkip & 2)) tf32x3::mma3(o[ng], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
    PHASE_TILE_USED();
  }

  PHASE_MARK(3);
  // merge the KW warps of each 16 rows in warp order, through the stage
  // buffers: lane-major, so each lane reads back only what it wrote (m, l,
  // then the output tiles inside padded(D))
  if constexpr (KW > 1) {
    float* mbuf = reinterpret_cast<float*>(kbuf);
    const int W = merge_floats(D);   // floats a lane keeps
    if (kg > 0) {
      float* mb = mbuf + (rg * (KW - 1) + kg - 1) * W * 32 + lane;
      mb[0] = m[0];
      mb[32] = m[1];
      mb[64] = l[0];
      mb[96] = l[1];
#pragma unroll
      for (int n = 0; n < kDT; ++n)
        if (8 * n < Dp)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mb[(4 + 4 * n + i) * 32] = o[n / kNG][n % kNG][i];
    }
    __syncthreads();
    if (kg == 0) {
      for (int w = 1; w < KW; ++w) {
        const float* mb = mbuf + (rg * (KW - 1) + w - 1) * W * 32 + lane;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mi = mb[r * 32];
          const float m_new = fmaxf(m[r], mi);
          const float x = expf(m[r] - m_new), y = expf(mi - m_new);
          l[r] = x * l[r] + y * mb[(2 + r) * 32];
          m[r] = m_new;
#pragma unroll
          for (int n = 0; n < kDT; ++n)
            if (8 * n < Dp)
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e)
                o[n / kNG][n % kNG][e] = x * o[n / kNG][n % kNG][e] +
                                         y * mb[(4 + 4 * n + e) * 32];
        }
      }
    }
  }

  // one split: normalise and write; else this split's partial, and the
  // last of the row block's splits to finish merges them all
  const bool single = s_end - s_begin == 1;
  const size_t part = (((size_t)b * K + h) * NS + (s - s0)) * CG;
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr0 + g + 8 * r;
      if (row >= CG) continue;
      if (single) {
        const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
        float* orow = out + (((size_t)b * K + h) * CG + row) * D;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          const int c = 8 * n + 2 * t;
          if (c < D) orow[c] = o[n / kNG][n % kNG][2 * r] * inv;
          if (c + 1 < D) orow[c + 1] = o[n / kNG][n % kNG][2 * r + 1] * inv;
        }
      } else {
        float* orow = ws_acc + (part + row) * D;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          const int c = 8 * n + 2 * t;
          if (c < D) orow[c] = o[n / kNG][n % kNG][2 * r];
          if (c + 1 < D) orow[c + 1] = o[n / kNG][n % kNG][2 * r + 1];
        }
      }
      if (!single && t == 0) {
        ws_ml[2 * (part + row)] = m[r];
        ws_ml[2 * (part + row) + 1] = l[r];
      }
    }
  }
  PHASE_MARK(4);
  if (!single)
    merge_splits_if_last<float, DT, ROWS>(
        out, ws_acc, ws_ml, counters + (size_t)b * gridDim.y + blockIdx.y,
        ((size_t)b * K + h) * NS + s_begin - s0, s_end - s_begin,
        (size_t)b * K + h, row0, rows, CG, D);
  PHASE_RECORD(j_end - j_begin, single);
}

template <int DT, bool VEC, int RW>
int walk_as(const float* q, const float* k_pages, const float* v_pages,
            const int* page_table, const int* start, const int* total,
            float* out, float* ws_acc, float* ws_ml, int* counters, int B,
            int K, int CG, int G, int D, int ps, int MP, int pages_start,
            int pages_end, int window, int NS, cudaStream_t stream) {
  // the attribute is set once per instance, device and size, not on every
  // launch (it holds for the current device only)
  static size_t configured[kMaxDevices] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const size_t smem = smem_bytes(D, DT, RW);
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(paged_prefill_kernel<DT, VEC, RW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = smem;
  }
  const dim3 grid(NS, K * row_blocks(CG), B);
  paged_prefill_kernel<DT, VEC, RW><<<grid, kThreads, smem, stream>>>(
      q, k_pages, v_pages, page_table, start, total, out, ws_acc, ws_ml,
      counters, K, CG, G, D, ps, MP, pages_start, pages_end, window, NS);
  return (int)cudaGetLastError();
}

template <int DT, bool VEC>
int walk_rows(int RW, const float* q, const float* k_pages,
              const float* v_pages, const int* page_table, const int* start,
              const int* total, float* out, float* ws_acc, float* ws_ml,
              int* counters, int B, int K, int CG, int G, int D, int ps,
              int MP, int pages_start, int pages_end, int window, int NS,
              cudaStream_t st) {
  auto as = RW == 1 ? walk_as<DT, VEC, 1>
          : RW == 2 ? walk_as<DT, VEC, 2> : walk_as<DT, VEC, 4>;
  return as(q, k_pages, v_pages, page_table, start, total, out, ws_acc, ws_ml,
            counters, B, K, CG, G, D, ps, MP, pages_start, pages_end, window,
            NS, st);
}

// Bytes of the workspace a launch takes: each split's partial (m, l,
// accumulator) and one count of finished splits per row block, where the
// walk spans more than one split; else none.
size_t workspace_bytes(int B, int K, int CG, int D, int NS) {
  if (NS <= 1) return 0;
  return sizeof(float) * (size_t)B * K * NS * CG * (D + 2) +
         sizeof(int) * (size_t)B * K * row_blocks(CG);
}

// The workspace's partials and counts, the counts zeroed on `stream` where
// the launch uses them (0, or the cudaError_t of the memset).
int carve_workspace(void* workspace, int B, int K, int CG, int D, int NS,
                    cudaStream_t stream, float*& ws_acc, float*& ws_ml,
                    int*& counters) {
  ws_acc = static_cast<float*>(workspace);
  ws_ml = ws_acc + (size_t)B * K * NS * CG * D;
  counters = reinterpret_cast<int*>(ws_ml + (size_t)B * K * NS * CG * 2);
  if (workspace_bytes(B, K, CG, D, NS) == 0) return 0;
  return (int)cudaMemsetAsync(counters, 0,
                              sizeof(int) * (size_t)B * K * row_blocks(CG),
                              stream);
}

// One launch of the fp32 design (paged_prefill_attention_f32's arguments).
int run(const float* q, const float* k_pages, const float* v_pages,
        const int* page_table, const int* start, const int* total,
        float* out, void* workspace, int B, int K, int C, int G, int D,
        int ps, int MP, int pages_start, int pages_end, int window,
        cudaStream_t stream) {
  const int CG = C * G, RW = row_warps(CG);
  const int NS = n_splits(ps, pages_start, pages_end);
  float *ws_acc, *ws_ml;
  int* counters;
  const int err = carve_workspace(workspace, B, K, CG, D, NS, stream, ws_acc,
                                  ws_ml, counters);
  if (err != 0) return err;
  // 16-byte copies need D a multiple of 4 and every key row 16-byte
  // aligned
  const bool vec = D % 4 == 0 &&
      ((uintptr_t)k_pages | (uintptr_t)v_pages) % 16 == 0;
  auto walk =
      D <= 32 ? (vec ? walk_rows<32, true> : walk_rows<32, false>)
      : D <= 64 ? (vec ? walk_rows<64, true> : walk_rows<64, false>)
      : D <= 128 ? (vec ? walk_rows<128, true> : walk_rows<128, false>)
      : (vec ? walk_rows<256, true> : walk_rows<256, false>);
  return walk(RW, q, k_pages, v_pages, page_table, start, total, out, ws_acc,
              ws_ml, counters, B, K, CG, G, D, ps, MP, pages_start, pages_end,
              window, NS, stream);
}

// ------------------------------------------------------------------ bf16
namespace bf16_prefill {

using elem::bf16;

// Keys of a tile at DT <= 128 and at DT = 256 (each at least 16 keys for
// each warp that shares a 16-row group); -D flags set them for
// tools/prefill_variants.py
#ifndef PREFILL_BF16_KEYS
#define PREFILL_BF16_KEYS 64
#endif
#ifndef PREFILL_BF16_KEYS_256
#define PREFILL_BF16_KEYS_256 32
#endif
// At 16 rows and DT <= 128: the blocks an SM that ptxas must leave
// registers for (__launch_bounds__; shared memory holds three), and the
// splits whose partials the last block loads before using any (one keeps
// the merge within three blocks' registers; 4 at 32 and 64 rows, 2 at
// DT = 256)
#ifndef PREFILL_BF16_MIN_BLOCKS
#define PREFILL_BF16_MIN_BLOCKS 3
#endif
#ifndef PREFILL_BF16_MERGE_SPLITS
#define PREFILL_BF16_MERGE_SPLITS 1
#endif

constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int key_tile(int DT, int RW) {
  const int want = DT > 128 ? PREFILL_BF16_KEYS_256 : PREFILL_BF16_KEYS;
  const int least = 16 * (kWarps / RW);
  return want > least ? want : least;
}
// Q's A fragments held in registers for the whole walk (DT / 4 of them)
__host__ __device__ constexpr bool q_in_regs(int DT) { return DT <= 128; }
__host__ __device__ constexpr int min_blocks(int DT, int RW) {
  return DT <= 128 && RW == 1 ? PREFILL_BF16_MIN_BLOCKS : 1;
}
__host__ __device__ constexpr int merge_splits(int DT, int RW) {
  return DT > 128 ? 2 : RW == 1 ? PREFILL_BF16_MERGE_SPLITS : 4;
}
// Dynamic shared memory of one block, in bytes: the ring of kStages K/V
// stages (TK x DT bf16 each), which the merge of the warps then reuses
// (every warp's m, l and accumulator), then the Q tile (16 RW x DT
// bf16).
__host__ __device__ constexpr size_t ring_bytes(int DT, int RW) {
  const size_t ring = sizeof(bf16) * (size_t)2 * kStages * key_tile(DT, RW) *
                      DT;
  const size_t merge = sizeof(float) * (size_t)kWarps * (DT / 2 + 4) * 32;
  return ring > merge ? ring : merge;
}
__host__ __device__ constexpr size_t smem_bytes(int DT, int RW) {
  return ring_bytes(DT, RW) + sizeof(bf16) * (size_t)16 * RW * DT;
}

// 2^x on the special-function unit (ex2.approx.ftz, about 2^-22 relative)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The swizzle's key: chunk c of row r is stored at chunk c ^ key(r). A row
// of DT >= 64 holds 8 or more chunks; at DT = 32 two rows share 128 bytes.
template <int DT>
__device__ __forceinline__ int swizzle_key(int r) {
  return DT >= 64 ? r & 7 : (r >> 1) & 3;
}

// Copy the 16-byte chunk (eight values) at column c of a row (`row` = its
// first value) to dst; zero past D, and the whole chunk where the row is
// not `in`. VEC: one cp.async (D a multiple of 8, so the chunk lies wholly
// inside or past D); else plain 2-byte loads and stores.
template <bool VEC>
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* row,
                                           bool in, int c, int D,
                                           const bf16* any) {
  if constexpr (VEC) {
    const bool ok = in && c < D;
    cp_async16(dst, ok ? row + c : any, ok);
  } else {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      d[e] = in && c + e < D ? p[c + e] : (unsigned short)0;
  }
}

template <int DT, bool VEC, int RW>
__global__ void __launch_bounds__(kThreads, min_blocks(DT, RW))
paged_prefill_kernel_bf16(const bf16* __restrict__ q,
                          const bf16* __restrict__ k_pages,
                          const bf16* __restrict__ v_pages,
                          const int* __restrict__ page_table,
                          const int* __restrict__ start,
                          const int* __restrict__ total,
                          bf16* __restrict__ out, float* __restrict__ ws_acc,
                          float* __restrict__ ws_ml,
                          int* __restrict__ counters, int K, int CG, int G,
                          int D, int ps, int MP, int pages_start,
                          int pages_end, int window, int NS) {
  constexpr int KW = kWarps / RW;        // warps per 16 rows
  constexpr int ROWS = 16 * RW;
  constexpr int TK = key_tile(DT, RW);   // keys of a tile
  constexpr int SK = TK / KW;            // keys of a warp's slice
  constexpr int NT = SK / 8;             // m16n8 score tiles of a slice
  constexpr int KS = DT / 16;            // k steps of Q K^T
  constexpr int NO = DT / 8;             // m16n8 output tiles
  constexpr int CPR = DT / 8;            // 16-byte chunks of a row
  constexpr int NK = TK * CPR / kThreads;  // K (and V) chunks a thread copies
  constexpr int NQ = (ROWS * CPR + kThreads - 1) / kThreads;  // Q chunks
  constexpr int RB = 2 * DT;             // bytes of a tile row
  constexpr bool QR = q_in_regs(DT);
  static_assert(SK % 16 == 0 && NK * kThreads == TK * CPR &&
                    kThreads % CPR == 0,
                "whole k16 steps a warp; tiles split evenly over threads");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int spage[kSplitKeys];      // the split's physical page ids
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + ring_bytes(DT, RW));

  const int SP = split_pages(ps);
  const int s0 = pages_start / SP;
  const int s = s0 + blockIdx.x;
  const int n_rb = (CG + ROWS - 1) / ROWS;
  const int h = blockIdx.y / n_rb;
  const int row0 = (blockIdx.y - h * n_rb) * ROWS;
  const int b = blockIdx.z;
  const int rows = min(ROWS, CG - row0);
  // a thread copies chunk cc of rows cr, cr + kThreads / CPR, ...
  const int cr = threadIdx.x / CPR, cc = threadIdx.x % CPR;

  // the split's page ids, read in the same round trip as start and total
  const int* pt_row = page_table + (size_t)b * MP;
  for (int i = threadIdx.x; i < SP && s * SP + i < MP; i += kThreads)
    spage[i] = pt_row[s * SP + i];
  const int qstart = start[b], tot = total[b];
  int p_begin, p_end;
  visible_pages(qstart, tot, row0, rows, G, ps, pages_start, pages_end,
                window, p_begin, p_end);
  if (p_end <= p_begin) {   // no visible key: the grid's first split
    if (blockIdx.x == 0)     // writes the rows' zeros
      for (int i = threadIdx.x; i < rows * D; i += kThreads)
        out[(((size_t)b * K + h) * CG + row0) * D + i] =
            elem::from_float<bf16>(0.f);
    return;
  }
  const int s_begin = p_begin / SP, s_end = (p_end + SP - 1) / SP;
  if (s < s_begin || s >= s_end) return;
  PHASE_BEGIN();

  // this split's pages [pa, pb) and keys [k_lo, k_hi); tiles of TK keys
  // from the split's first key
  const int pa = max(s * SP, p_begin), pb = min((s + 1) * SP, p_end);
  const int ksplit = s * SP * ps;
  const int k_lo = pa * ps, k_hi = pb * ps;
  const int j_begin = (k_lo - ksplit) / TK;
  const int j_end = (k_hi - ksplit + TK - 1) / TK;

  // Q's rows into the swizzled Q tile, zero past the block's rows and past
  // D; in flight with the page ids, and waited for with the first tile
  const bf16* qb = q + (((size_t)b * K + h) * CG + row0) * D;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / CPR, c = idx % CPR;
    if (idx < ROWS * CPR)
      copy_chunk<VEC>(qs + r * DT + 8 * (c ^ swizzle_key<DT>(r)),
                      qb + (r < rows ? (size_t)r * D : 0), r < rows, 8 * c,
                      D, qb);
  }
  // start copying tile j into its stage, K rows then V rows, one page
  // lookup a row, a shift where ps is a power of two (nothing past the
  // split's last tile: the group stays empty)
  const int psh = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  auto copy_tile = [&](int j) {
    if (j < j_end) {
      bf16* ks = ring + (j - j_begin) % kStages * 2 * TK * DT;
      bf16* vs = ks + TK * DT;
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int r = cr + i * (kThreads / CPR);
        const int key = ksplit + j * TK + r;
        const bool in = key >= k_lo && key < k_hi;
        const int rel = key - ksplit;
        const int pl = !in ? 0 : psh >= 0 ? rel >> psh : rel / ps;
        const size_t row =
            (((size_t)spage[pl] * ps + (rel - pl * ps)) * K + h) * D;
        const int at = r * DT + 8 * (cc ^ swizzle_key<DT>(r));
        copy_chunk<VEC>(ks + at, k_pages + (in ? row : 0), in, 8 * cc, D,
                        k_pages);
        copy_chunk<VEC>(vs + at, v_pages + (in ? row : 0), in, 8 * cc, D,
                        v_pages);
      }
    }
    asm volatile("cp.async.commit_group;");
  };
  __syncthreads();   // the page ids are in
  PHASE_MARK(1);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) copy_tile(j_begin + i);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / KW, kg = warp - rg * KW;
  const int wr0 = row0 + 16 * rg;        // this warp's first row
  // positions of rows g and g + 8, and of the warp's first and last rows;
  // padding rows repeat the last row's position
  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qp[r] = qstart + min(wr0 + g + 8 * r, CG - 1) / G;
  const int wq_lo = qstart + min(wr0, CG - 1) / G;
  const int wq_hi = qstart + min(wr0 + 15, CG - 1) / G;
  // ldmatrix addresses of this lane (shared-memory bytes): row mr of
  // matrix mi. Every row a lane names is mr modulo 8, so the swizzle's key
  // is the lane's own, and chunk 2 kk + c0 lies at 8 (kk / 4) + col[kk % 4]
  // (kk unrolled: each address a register plus an immediate).
  const int mi = lane >> 3, mr = lane & 7;
  const int key = swizzle_key<DT>(mr);
  auto cols = [&](uint32_t (&col)[4], int c0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) col[u] = 16 * ((2 * u + c0) ^ key);
  };
  auto at = [](const uint32_t (&col)[4], int kk) {
    return col[kk % 4] + 128 * (kk / 4);
  };
  // Q's A fragment: matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15) of
  // the warp's 16 rows; V's chunks are Q's (qcol)
  uint32_t qcol[4], kcol[4];
  cols(qcol, mi >> 1);
  const uint32_t qa =
      bf16mma::smem_addr(qs) + (16 * rg + mr + 8 * (mi & 1)) * RB;
  // K's B fragments of two n-tiles of the warp's slice: (keys 0-7 | 8-15)
  // x (d 0-7 | 8-15)
  cols(kcol, mi & 1);
  const int krow = (SK * kg + mr + 8 * (mi >> 1)) * RB;
  // V's B fragments of two n-tiles, transposed: (keys 0-7 | 8-15) x (d 0-7
  // | 8-15)
  const int vrow = (SK * kg + mr + 8 * (mi & 1)) * RB;

  uint32_t qf[QR ? KS : 1][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  PHASE_MARK(2);
  for (int j = j_begin; j < j_end; ++j) {
    PHASE_TILE_BEGIN();
    copy_tile(j + kStages - 1);   // in flight while this tile is used
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncthreads();   // tile j landed (and, with the first, Q's tile)
    PHASE_TILE_WAITED();
    if constexpr (QR) {
      if (j == j_begin) {   // Q's fragments, once
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          bf16mma::ldsm_x4(qf[kk], qa + at(qcol, kk));
      }
    }
    const uint32_t stage = bf16mma::smem_addr(
        ring + (j - j_begin) % kStages * 2 * TK * DT);
    const uint32_t ka = stage + krow, va = stage + TK * RB + vrow;
    // this warp's keys [kw0, kw0 + SK)
    const int kw0 = ksplit + j * TK + SK * kg;
    const int kw1 = kw0 + SK - 1;
    const bool any = kw0 < k_hi && kw1 >= k_lo && kw0 <= wq_hi &&
                     kw0 < tot && (window == 0 || wq_lo - kw1 < window);
    if (any && !(kSkip & 4)) {
      // scores: sc[jn] is the m16n8 tile of keys kw0 + 8 jn ..
      float sc[NT][4];
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[jn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        if constexpr (QR) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          bf16mma::ldsm_x4(a, qa + at(qcol, kk));
        }
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t x[4];
          bf16mma::ldsm_x4(x, ka + 16 * jp * RB + at(kcol, kk));
          if constexpr (!(kSkip & 1)) {
            bf16mma::mma(sc[2 * jp], a, x[0], x[1]);
            bf16mma::mma(sc[2 * jp + 1], a, x[2], x[3]);
          }
        }
      }

      // mask only where some key of the slice is not visible to some row;
      // `ok` keeps which are, for the re-mask after the max
      uint32_t ok = 0xffffffffu;
      if (!(kw0 >= k_lo && kw1 < k_hi && kw1 <= wq_lo && kw1 < tot &&
            (window == 0 || wq_hi - kw0 < window))) {
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qpos = qp[i >> 1];
            const int kpos = kw0 + 8 * jn + 2 * t + (i & 1);
            const bool v = kpos >= k_lo && kpos < k_hi && kpos <= qpos &&
                           kpos < tot &&
                           (window == 0 || qpos - kpos < window);
            if (!v) {
              sc[jn][i] = kNegInf;
              ok &= ~(1u << (4 * jn + i));
            }
          }
      }

      // online softmax of rows g (r = 0: elements 0, 1) and g + 8 (r = 1:
      // elements 2, 3), with the re-mask: a masked key adds exactly 0 even
      // where m is still -1e30. exp(x - m) is 2^(x log2 e - m log2 e), one
      // FFMA and one ex2; m stays in natural units (the workspace's), and
      // alpha is exactly 1 where m does not move, so that a tile that adds
      // nothing leaves the state's bits as they were
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
          mx = fmaxf(mx, fmaxf(sc[jn][2 * r], sc[jn][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float ms = m_new * kLog2e;
        const float alpha = m_new == m[r]
                                ? 1.f
                                : exp2_approx(fmaf(m[r], kLog2e, -ms));
        float sum = 0.f;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            sc[jn][e] = (ok >> (4 * jn + e)) & 1u
                            ? exp2_approx(fmaf(sc[jn][e], kLog2e, -ms))
                            : 0.f;
            sum += sc[jn][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = alpha * l[r] + sum;   // the unrounded P
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }

      // o += P V: k step jp takes score tiles 2 jp, 2 jp + 1 rounded to
      // bf16 as its A fragment (keys 16 jp .. 16 jp + 15 of the slice)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const uint32_t a[4] = {
            bf16mma::pack(sc[2 * jp][0], sc[2 * jp][1]),
            bf16mma::pack(sc[2 * jp][2], sc[2 * jp][3]),
            bf16mma::pack(sc[2 * jp + 1][0], sc[2 * jp + 1][1]),
            bf16mma::pack(sc[2 * jp + 1][2], sc[2 * jp + 1][3])};
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t x[4];
          bf16mma::ldsm_x4_trans(x, va + 16 * jp * RB + at(qcol, np));
          if constexpr (!(kSkip & 2)) {
            bf16mma::mma(o[2 * np], a, x[0], x[1]);
            bf16mma::mma(o[2 * np + 1], a, x[2], x[3]);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
    PHASE_TILE_USED();
  }

  PHASE_MARK(3);
  // one split: normalise and write, rounded to bf16 once; else this
  // split's partial in fp32, and the last of the row block's splits to
  // finish merges them all. emit stores columns c, c + 1 of row
  // wr0 + g + 8 r: two neighbouring columns a store where D is even
  // (every pair then aligned)
  const bool single = s_end - s_begin == 1;
  const size_t part = (((size_t)b * K + h) * NS + (s - s0)) * CG;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  auto emit = [&](int r, int c, float x0, float x1) {
    const int row = wr0 + g + 8 * r;
    if (row >= CG || c >= D) return;
    if (single) {
      bf16* orow = out + (((size_t)b * K + h) * CG + row) * D;
      x0 *= inv[r];
      x1 *= inv[r];
      if (D % 2 == 0) {
        *reinterpret_cast<uint32_t*>(orow + c) = bf16mma::pack(x0, x1);
      } else {
        orow[c] = __float2bfloat16_rn(x0);
        if (c + 1 < D) orow[c + 1] = __float2bfloat16_rn(x1);
      }
    } else {
      float* orow = ws_acc + (part + row) * D;
      if (D % 2 == 0) {
        *reinterpret_cast<float2*>(orow + c) = make_float2(x0, x1);
      } else {
        orow[c] = x0;
        if (c + 1 < D) orow[c + 1] = x1;
      }
    }
  };
  if constexpr (KW == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < NO; ++n)
        emit(r, 8 * n + 2 * t, o[n][2 * r], o[n][2 * r + 1]);
  } else {
    // merge the KW warps of each 16 rows in warp order, through the ring,
    // each warp for its own KW-th of the output tiles: every warp stores
    // its m, l and output tiles inside padded(D) lane-major, then runs
    // the merge's (m, l) sequence over all KW warps (the same arithmetic
    // in every warp) and applies its weights to its tiles
    const int Dp = padded(D);
    const int W = merge_floats(D);   // floats a lane keeps
    float* mbuf = reinterpret_cast<float*>(ring) + rg * KW * W * 32 + lane;
    float* mb = mbuf + kg * W * 32;
    mb[0] = m[0];
    mb[32] = m[1];
    mb[64] = l[0];
    mb[96] = l[1];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (8 * n < Dp)
#pragma unroll
        for (int i = 0; i < 4; ++i) mb[(4 + 4 * n + i) * 32] = o[n][i];
    __syncthreads();
    float x[2][KW], y[2][KW];   // weights of the running and of warp w
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = mbuf[r * 32];
      l[r] = mbuf[(2 + r) * 32];
#pragma unroll
      for (int w = 1; w < KW; ++w) {
        const float* mw = mbuf + w * W * 32;
        const float m_new = fmaxf(m[r], mw[r * 32]);
        x[r][w] = expf(m[r] - m_new);
        y[r][w] = expf(mw[r * 32] - m_new);
        l[r] = x[r][w] * l[r] + y[r][w] * mw[(2 + r) * 32];
        m[r] = m_new;
      }
      inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    }
#pragma unroll
    for (int i = 0; i < NO / KW; ++i) {
      const int n = kg * (NO / KW) + i;
      if (8 * n >= Dp) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float a0 = mbuf[(4 + 4 * n + 2 * r) * 32];
        float a1 = mbuf[(4 + 4 * n + 2 * r + 1) * 32];
#pragma unroll
        for (int w = 1; w < KW; ++w) {
          const float* mw = mbuf + w * W * 32;
          a0 = x[r][w] * a0 + y[r][w] * mw[(4 + 4 * n + 2 * r) * 32];
          a1 = x[r][w] * a1 + y[r][w] * mw[(4 + 4 * n + 2 * r + 1) * 32];
        }
        emit(r, 8 * n + 2 * t, a0, a1);
      }
    }
  }
  if (!single && kg == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr0 + g + 8 * r;
      if (row < CG) {
        ws_ml[2 * (part + row)] = m[r];
        ws_ml[2 * (part + row) + 1] = l[r];
      }
    }
  }
  PHASE_MARK(4);
  if (!single)
    merge_splits_if_last<bf16, DT, ROWS, merge_splits(DT, RW)>(
        out, ws_acc, ws_ml, counters + (size_t)b * gridDim.y + blockIdx.y,
        ((size_t)b * K + h) * NS + s_begin - s0, s_end - s_begin,
        (size_t)b * K + h, row0, rows, CG, D);
  PHASE_RECORD(j_end - j_begin, single);
}

template <int DT, bool VEC, int RW>
int walk_as(const bf16* q, const bf16* k_pages, const bf16* v_pages,
            const int* page_table, const int* start, const int* total,
            bf16* out, float* ws_acc, float* ws_ml, int* counters, int B,
            int K, int CG, int G, int D, int ps, int MP, int pages_start,
            int pages_end, int window, int NS, cudaStream_t stream) {
  // the attribute is set once per instance and device (it holds for the
  // current device only)
  static bool configured[kMaxDevices] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  constexpr size_t smem = smem_bytes(DT, RW);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(paged_prefill_kernel_bf16<DT, VEC, RW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const dim3 grid(NS, K * row_blocks(CG), B);
  paged_prefill_kernel_bf16<DT, VEC, RW><<<grid, kThreads, smem, stream>>>(
      q, k_pages, v_pages, page_table, start, total, out, ws_acc, ws_ml,
      counters, K, CG, G, D, ps, MP, pages_start, pages_end, window, NS);
  return (int)cudaGetLastError();
}

template <int DT, bool VEC>
int walk_rows(int RW, const bf16* q, const bf16* k_pages,
              const bf16* v_pages, const int* page_table, const int* start,
              const int* total, bf16* out, float* ws_acc, float* ws_ml,
              int* counters, int B, int K, int CG, int G, int D, int ps,
              int MP, int pages_start, int pages_end, int window, int NS,
              cudaStream_t st) {
  auto as = RW == 1 ? walk_as<DT, VEC, 1>
          : RW == 2 ? walk_as<DT, VEC, 2> : walk_as<DT, VEC, 4>;
  return as(q, k_pages, v_pages, page_table, start, total, out, ws_acc, ws_ml,
            counters, B, K, CG, G, D, ps, MP, pages_start, pages_end, window,
            NS, st);
}

// One launch of the bf16 design (paged_prefill_attention_bf16's
// arguments).
int run(const bf16* q, const bf16* k_pages, const bf16* v_pages,
        const int* page_table, const int* start, const int* total, bf16* out,
        void* workspace, int B, int K, int C, int G, int D, int ps, int MP,
        int pages_start, int pages_end, int window, cudaStream_t stream) {
  const int CG = C * G, RW = row_warps(CG);
  const int NS = n_splits(ps, pages_start, pages_end);
  float *ws_acc, *ws_ml;
  int* counters;
  const int err = carve_workspace(workspace, B, K, CG, D, NS, stream, ws_acc,
                                  ws_ml, counters);
  if (err != 0) return err;
  // 16-byte copies need D a multiple of 8 and every row of q and the pool
  // 16-byte aligned
  const bool vec = D % 8 == 0 &&
      ((uintptr_t)q | (uintptr_t)k_pages | (uintptr_t)v_pages) % 16 == 0;
  auto walk =
      D <= 32 ? (vec ? walk_rows<32, true> : walk_rows<32, false>)
      : D <= 64 ? (vec ? walk_rows<64, true> : walk_rows<64, false>)
      : D <= 128 ? (vec ? walk_rows<128, true> : walk_rows<128, false>)
      : (vec ? walk_rows<256, true> : walk_rows<256, false>);
  return walk(RW, q, k_pages, v_pages, page_table, start, total, out, ws_acc,
              ws_ml, counters, B, K, CG, G, D, ps, MP, pages_start, pages_end,
              window, NS, stream);
}

}  // namespace bf16_prefill
}  // namespace

// Shared memory of one block (bytes), dynamic and static, for C query rows
// of G heads at head_dim D, of elements of `elem_bytes` bytes (4: fp32, 2:
// bf16).
extern "C" long long paged_prefill_smem_bytes(int C, int G, int D,
                                              int elem_bytes) {
  const int DT = dim_tile(D), RW = row_warps(C * G);
  return (elem_bytes == 2 ? bf16_prefill::smem_bytes(DT, RW)
                          : smem_bytes(D, DT, RW)) +
         sizeof(int) * kSplitKeys;
}

// The workspace of a launch (bytes), for paged_prefill_attention_f32's
// arguments of the same names (fp32 partials at either element type).
extern "C" long long paged_prefill_workspace_bytes(int B, int K, int C,
                                                   int G, int D, int ps,
                                                   int pages_start,
                                                   int pages_end) {
  return workspace_bytes(B, K, C * G, D, n_splits(ps, pages_start,
                                                  pages_end));
}

// q, out: (B, K, C, G, D); k_pages, v_pages: (P, ps, K, D); page_table:
// (B, MP) int32; start, total: (B,) int32; workspace:
// paged_prefill_workspace_bytes(...) bytes (may be any pointer where that
// is 0), whose counts the launch zeroes first on `stream`. 1 <= D <= 256.
// All contiguous, on the device of `stream`. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int paged_prefill_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* page_table, const int* start, const int* total, float* out,
    void* workspace, int B, int K, int C, int G, int D, int ps, int MP,
    int pages_start, int pages_end, int window, void* stream) {
  return run(q, k_pages, v_pages, page_table, start, total, out, workspace,
             B, K, C, G, D, ps, MP, pages_start, pages_end, window,
             (cudaStream_t)stream);
}

// The same with q, k_pages, v_pages and out in bf16: the bf16 design.
extern "C" int paged_prefill_attention_bf16(
    const elem::bf16* q, const elem::bf16* k_pages,
    const elem::bf16* v_pages, const int* page_table, const int* start,
    const int* total, elem::bf16* out, void* workspace, int B, int K, int C,
    int G, int D, int ps, int MP, int pages_start, int pages_end, int window,
    void* stream) {
  return bf16_prefill::run(q, k_pages, v_pages, page_table, start, total,
                           out, workspace, B, K, C, G, D, ps, MP,
                           pages_start, pages_end, window,
                           (cudaStream_t)stream);
}
