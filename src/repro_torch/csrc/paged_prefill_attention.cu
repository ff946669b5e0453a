// Paged GQA chunked-prefill attention for Hopper (sm_90a), fp32 through
// 3xTF32 on the tensor cores, or bf16 through one TF32 product.
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
// Design:
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
// - bf16 (the entries *_bf16; the TPU kernel takes either dtype): q, the
//   pages and out are bf16, everything between stays fp32, the workspace
//   too. A bf16 value is exact in TF32 (7 stored mantissa bits against
//   10), and so is P rounded to bf16, as the TPU body's p.astype(v.dtype)
//   rounds it before P V (l sums the unrounded P): each product is one
//   TF32 mma.sync on the same fragments, exact. Q is widened into one
//   plane; the K and V tiles are copied as bf16 (16-byte cp.async of 8
//   values, rows padded(D) + 8 values apart, so that the fragments' 2-byte
//   loads fall in distinct banks) and widened as their fragments are read.
//   The output is rounded to bf16 once. At bf16 the bytes halve.
// - D is zero-padded to a multiple of 16 (zero columns add 0 to Q K^T;
//   the padded output columns are never stored). Rows past C * G in the
//   last row block are padding that repeats the last row's position.
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

// TF32 planes Q is held in: hi and lo in fp32, the value alone in bf16
// (exact in TF32)
template <typename T>
__host__ __device__ constexpr int planes() {
  return elem::is_bf16<T>() ? 1 : 2;
}
// raw K and V rows, in elements: Q's stride in fp32; padded(D) + 8 in bf16
// (16-byte rows; rows 4 words apart mod 32 banks)
template <typename T>
__host__ __device__ inline int raw_stride(int D) {
  return elem::is_bf16<T>() ? padded(D) + 8 : row_stride(D);
}
// floats a lane keeps for the merge of a block's warps (m, l and its
// output tiles inside padded(D)), in the stage buffers after the walk
__host__ __device__ inline int merge_floats(int D) { return padded(D) / 2 + 4; }

// Dynamic shared memory of one block, in bytes: Q's planes, and kStages
// stages of raw K and V tiles, which the merge of the warps then reuses.
template <typename T>
__host__ __device__ inline size_t smem_bytes(int D, int DT, int RW) {
  const int KW = kWarps / RW;
  const size_t stages = sizeof(T) * (size_t)2 * kStages * key_tile(DT, RW) *
                        raw_stride<T>(D);
  const size_t merge = sizeof(float) * (size_t)RW * (KW - 1) *
                       merge_floats(D) * 32;
  return sizeof(float) * (size_t)planes<T>() * 16 * RW * row_stride(D) +
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

// Copy a 16-byte chunk (four floats or eight bf16 values) at column c of
// a key row (`row` = its first element) to dst; zero past D, and the whole
// chunk where the key is not `in` the split. VEC: one 16-byte copy; else
// fp32 by four copies of 4 bytes, bf16 by plain loads and stores of 2
// bytes.
template <bool VEC, typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* row, bool in,
                                           int c, int D, const T* any) {
  constexpr int CW = 16 / (int)sizeof(T);
  if constexpr (VEC) {
    const bool ok = in && c < D;
    cp_async16(dst, ok ? row + c : any, ok);
  } else if constexpr (elem::is_bf16<T>()) {
#pragma unroll
    for (int i = 0; i < CW; ++i)
      dst[i] = in && c + i < D ? row[c + i] : elem::from_float<T>(0.f);
  } else {
#pragma unroll
    for (int i = 0; i < CW; ++i) {
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
template <typename T, int DT, int ROWS>
__device__ void merge_splits_if_last(T* __restrict__ out,
                                     const float* __restrict__ ws_acc,
                                     const float* __restrict__ ws_ml,
                                     int* count, size_t first, int n,
                                     size_t head, int row0, int rows, int CG,
                                     int D) {
  constexpr int RC = ROWS / kWarps < 4 ? ROWS / kWarps : 4;
  constexpr int NC = DT / 32;
  constexpr int SC = DT > 128 ? 2 : 4;
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

template <typename T, int DT, bool VEC, int RW>
__global__ void __launch_bounds__(kThreads, PREFILL_MIN_BLOCKS)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ page_table,
                     const int* __restrict__ start,
                     const int* __restrict__ total, T* __restrict__ out,
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
  constexpr int CPR = DT / 4;            // Q's 4-value chunks of a row
  constexpr int CW = 16 / (int)sizeof(T);  // values of a copied chunk
  constexpr int CPC = DT / CW;           // copied chunks of a key row
  constexpr int NK = TK * CPC / kThreads;  // chunks a thread copies
  constexpr bool kExact = elem::is_bf16<T>();   // one TF32 product
  static_assert(NT >= 1 && NK * kThreads == TK * CPC && kThreads % CPC == 0,
                "tiles must split evenly over warps and threads");
  extern __shared__ __align__(16) float smem[];
  __shared__ int spage[kSplitKeys];      // the split's physical page ids

  const int Dp = padded(D), RS = row_stride(D), RR = raw_stride<T>(D);
  float* qh = smem;                      // ROWS x RS, TF32 hi of Q
  float* ql = qh + ROWS * RS;            // and lo (fp32 only)
  // stages of (K, V), TK x RR each
  T* kbuf = reinterpret_cast<T*>(qh + planes<T>() * ROWS * RS);

  const int SP = split_pages(ps);
  const int s0 = pages_start / SP;
  const int s = s0 + blockIdx.x;
  const int n_rb = (CG + ROWS - 1) / ROWS;
  const int h = blockIdx.y / n_rb;
  const int row0 = (blockIdx.y - h * n_rb) * ROWS;
  const int b = blockIdx.z;
  const int rows = min(ROWS, CG - row0);
  const int kr = threadIdx.x / CPR, kc = 4 * (threadIdx.x % CPR);
  const int cr = threadIdx.x / CPC, cc = CW * (threadIdx.x % CPC);
  // Q's rows, zero past C * G and past D, read 4 chunks (16 values) a
  // thread at a time and split into planes (at bf16 widened into one)
  const T* qb = q + ((size_t)b * K + h) * CG * D + (size_t)row0 * D;
  constexpr int QN = ROWS / (kThreads / CPR);   // Q chunks of a thread
  static_assert(QN * (kThreads / CPR) == ROWS, "Q chunks tile the rows");
  auto load_q = [&](int i0, float (&x)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = kr + (i0 + i) * (kThreads / CPR);
        x[i][e] = i0 + i < QN && kc < Dp && r < rows && kc + e < D
                      ? elem::ldg(qb + (size_t)r * D + kc + e) : 0.f;
      }
  };
  auto split_q = [&](int i0, const float (&x)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = kr + (i0 + i) * (kThreads / CPR);
      if (i0 + i >= QN || kc >= Dp) continue;
      if constexpr (kExact) {
        *reinterpret_cast<float4*>(qh + r * RS + kc) =
            make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
        continue;
      }
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
        out[(((size_t)b * K + h) * CG + row0) * D + i] =
            elem::from_float<T>(0.f);
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
    T* ks = kbuf + (j - j_begin) % kStages * 2 * TK * RR;
    T* vs = ks + TK * RR;
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
        copy_chunk<VEC>(ks + r * RR + cc, k_pages + (in ? row : 0), in, cc,
                        D, k_pages);
        copy_chunk<VEC>(vs + r * RR + cc, v_pages + (in ? row : 0), in, cc,
                        D, v_pages);
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
    const T* ks = kbuf + (j - j_begin) % kStages * 2 * TK * RR;
    const T* vs = ks + TK * RR;
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
      const float* kf = reinterpret_cast<const float*>(ks) +
                        (8 * NT * kg + mr) * RS + 4 * mi;
      const T* kg16 = ks + (8 * NT * kg + g) * RR + t;
#pragma unroll
      for (int kk = 0; kk < kDT; kk += 2) {
        if (8 * kk >= Dp) break;
        uint32_t x[NT][4];
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          if constexpr (kExact) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              x[jn][i] = __float_as_uint(elem::to_float(
                  kg16[8 * jn * RR + 8 * kk + 4 * i]));
          } else {
            ldsm_x4(x[jn], kf + 8 * jn * RS + 8 * kk);
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t ah[4];
          ldsm_x4(ah, qa + 8 * (kk + hf));
          if constexpr (kExact) {   // Q and K exact in TF32: one product
            if constexpr (!(kSkip & 1)) {
#pragma unroll
              for (int jn = 0; jn < NT; ++jn) {
                const uint32_t b2[2] = {x[jn][2 * hf], x[jn][2 * hf + 1]};
                tf32x3::mma(sa[(kk + hf) % NACC][jn], ah, b2);
              }
            }
            continue;
          }
          uint32_t al[4], bh[NT][2], bl[NT][2];
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
        if constexpr (kExact) {   // P rounded to bf16 and V: exact in TF32
          const uint32_t a[4] = {
              __float_as_uint(elem::round_bf16(sc[jn][0])),
              __float_as_uint(elem::round_bf16(sc[jn][2])),
              __float_as_uint(elem::round_bf16(sc[jn][1])),
              __float_as_uint(elem::round_bf16(sc[jn][3]))};
          const T* vf = vs + (8 * NT * kg + 8 * jn + 2 * t) * RR + g;
#pragma unroll
          for (int n = 0; n < kDT; ++n) {
            if (8 * n >= Dp) break;
            const uint32_t bv[2] = {
                __float_as_uint(elem::to_float(vf[8 * n])),
                __float_as_uint(elem::to_float(vf[RR + 8 * n]))};
            if constexpr (!(kSkip & 2))
              tf32x3::mma(o[n / kNG][n % kNG], a, bv);
          }
          continue;
        }
        uint32_t ah[4], al[4];
        tf32x3::split(sc[jn][0], ah[0], al[0]);
        tf32x3::split(sc[jn][2], ah[1], al[1]);
        tf32x3::split(sc[jn][1], ah[2], al[2]);
        tf32x3::split(sc[jn][3], ah[3], al[3]);
        const float* vf = reinterpret_cast<const float*>(vs) +
                          (8 * NT * kg + 8 * jn + 2 * t) * RS + g;
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
        T* orow = out + (((size_t)b * K + h) * CG + row) * D;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          const int c = 8 * n + 2 * t;
          if (c < D)
            orow[c] = elem::from_float<T>(o[n / kNG][n % kNG][2 * r] * inv);
          if (c + 1 < D)
            orow[c + 1] =
                elem::from_float<T>(o[n / kNG][n % kNG][2 * r + 1] * inv);
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
    merge_splits_if_last<T, DT, ROWS>(
        out, ws_acc, ws_ml, counters + (size_t)b * gridDim.y + blockIdx.y,
        ((size_t)b * K + h) * NS + s_begin - s0, s_end - s_begin,
        (size_t)b * K + h, row0, rows, CG, D);
  PHASE_RECORD(j_end - j_begin, single);
}

template <typename T, int DT, bool VEC, int RW>
int walk_as(const T* q, const T* k_pages, const T* v_pages,
            const int* page_table, const int* start, const int* total,
            T* out, float* ws_acc, float* ws_ml, int* counters, int B, int K,
            int CG, int G, int D, int ps, int MP, int pages_start,
            int pages_end, int window, int NS, cudaStream_t stream) {
  // the attribute is set once per instance, device and size, not on every
  // launch (it holds for the current device only)
  static size_t configured[kMaxDevices] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const size_t smem = smem_bytes<T>(D, DT, RW);
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(paged_prefill_kernel<T, DT, VEC, RW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = smem;
  }
  const dim3 grid(NS, K * row_blocks(CG), B);
  paged_prefill_kernel<T, DT, VEC, RW><<<grid, kThreads, smem, stream>>>(
      q, k_pages, v_pages, page_table, start, total, out, ws_acc, ws_ml,
      counters, K, CG, G, D, ps, MP, pages_start, pages_end, window, NS);
  return (int)cudaGetLastError();
}

template <typename T, int DT, bool VEC>
int walk_rows(int RW, const T* q, const T* k_pages, const T* v_pages,
              const int* page_table, const int* start, const int* total,
              T* out, float* ws_acc, float* ws_ml, int* counters, int B,
              int K, int CG, int G, int D, int ps, int MP, int pages_start,
              int pages_end, int window, int NS, cudaStream_t st) {
  auto as = RW == 1 ? walk_as<T, DT, VEC, 1>
          : RW == 2 ? walk_as<T, DT, VEC, 2> : walk_as<T, DT, VEC, 4>;
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

// One launch of the kernel's T instance (paged_prefill_attention_f32's
// arguments).
template <typename T>
int run(const T* q, const T* k_pages, const T* v_pages,
        const int* page_table, const int* start, const int* total, T* out,
        void* workspace, int B, int K, int C, int G, int D, int ps, int MP,
        int pages_start, int pages_end, int window, cudaStream_t stream) {
  const int CG = C * G, RW = row_warps(CG);
  const int NS = n_splits(ps, pages_start, pages_end);
  float* ws_acc = static_cast<float*>(workspace);
  float* ws_ml = ws_acc + (size_t)B * K * NS * CG * D;
  int* counters = reinterpret_cast<int*>(ws_ml + (size_t)B * K * NS * CG * 2);
  if (workspace_bytes(B, K, CG, D, NS) > 0) {
    const cudaError_t err = cudaMemsetAsync(
        counters, 0, sizeof(int) * (size_t)B * K * row_blocks(CG), stream);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte copies need D a multiple of a 16-byte chunk and every key row
  // 16-byte aligned
  const bool vec = D % (16 / (int)sizeof(T)) == 0 &&
      ((uintptr_t)k_pages | (uintptr_t)v_pages) % 16 == 0;
  auto walk =
      D <= 32 ? (vec ? walk_rows<T, 32, true> : walk_rows<T, 32, false>)
      : D <= 64 ? (vec ? walk_rows<T, 64, true> : walk_rows<T, 64, false>)
      : D <= 128 ? (vec ? walk_rows<T, 128, true> : walk_rows<T, 128, false>)
      : (vec ? walk_rows<T, 256, true> : walk_rows<T, 256, false>);
  return walk(RW, q, k_pages, v_pages, page_table, start, total, out, ws_acc,
              ws_ml, counters, B, K, CG, G, D, ps, MP, pages_start, pages_end,
              window, NS, stream);
}

}  // namespace

// Shared memory of one block (bytes), dynamic and static, for C query rows
// of G heads at head_dim D, of elements of `elem_bytes` bytes (4: fp32, 2:
// bf16).
extern "C" long long paged_prefill_smem_bytes(int C, int G, int D,
                                              int elem_bytes) {
  const int DT = dim_tile(D), RW = row_warps(C * G);
  return (elem_bytes == 2 ? smem_bytes<elem::bf16>(D, DT, RW)
                          : smem_bytes<float>(D, DT, RW)) +
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

// The same with q, k_pages, v_pages and out in bf16.
extern "C" int paged_prefill_attention_bf16(
    const elem::bf16* q, const elem::bf16* k_pages,
    const elem::bf16* v_pages, const int* page_table, const int* start,
    const int* total, elem::bf16* out, void* workspace, int B, int K, int C,
    int G, int D, int ps, int MP, int pages_start, int pages_end, int window,
    void* stream) {
  return run(q, k_pages, v_pages, page_table, start, total, out, workspace,
             B, K, C, G, D, ps, MP, pages_start, pages_end, window,
             (cudaStream_t)stream);
}
