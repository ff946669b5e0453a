// Paged GQA decode attention for Hopper (sm_90a), fp32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention/kernel.py
// :106 (paged_decode_attention_gqa, body _paged_kernel): one decode query
// per serving slot and query head attends to that slot's K/V pages through
// the page table, with the live walk [pages_start, pages_end), an optional
// sliding window, the explicit re-mask after the max and the l == 0 -> 0
// guard. Every row of a kv head's group sits at the slot's position
// len - 1, so a key at kpos is valid for all of them iff kpos < len,
// kpos >= pages_start * ps (the walk starts there) and, under a window,
// kpos >= len - window: the keys [k_lo, k_hi) below, masked by global
// position exactly as the TPU kernel masks.
//
// What bounds it: bytes. Each (slot, kv head) reads its keys' K and V rows
// once and does 4 * G * D flops per key, so at the main path's G = 1 it
// does about 0.5 flop per byte, far below the H100's fp32 ridge of about 20
// (67 TFLOP/s / 3.35 TB/s): a GEMV, for which SIMT FMAs on registers are
// enough. The least time is the K/V bytes over 3.35 TB/s, which needs many
// key rows in flight on every SM.
//
// Design:
// - The page walk is split across blocks, flash-decoding style, as in
//   paged_prefill_attention.cu. A block owns one (slot b, kv head h, block
//   of up to 8 rows of the head's group) and one split of kSplitKeys keys
//   (8 pages at ps = 16), splits aligned at multiples of that size from
//   page 0. Each block works out from the slot's own len (and the window)
//   which keys of its split are visible, and exits at once if none are. So
//   what a block computes depends on the slot's data alone, not on
//   pages_end, B or the grid: the same slot gives the same bits under any
//   live bound and in any packing.
// - One round trip starts a block: the slot's len, the split's page ids
//   (lane i holds page i of the split: a split has at most 32 pages) and
//   q's rows are loaded together.
// - Each warp takes a contiguous slice of the split's keys. A lane holds
//   D / 32 columns of every row: four neighbouring floats at D = 128, read
//   with one 16-byte load, so a warp reads a 512-byte key row in one
//   instruction (8-byte loads at D <= 64; 4-byte loads where D % 4 != 0).
//   q's rows, the warp's online-softmax (m, l) and its accumulator stay in
//   registers. The warp issues the K and V loads of several keys before it
//   uses the first (stage_keys), a key's page id comes by a shuffle from
//   the lane that holds it, and a score is a dot product over the lanes'
//   columns reduced by xor shuffles, so every lane holds every score. No
//   barrier inside the key loop.
// - The warps are merged in warp order through shared memory at the end of
//   the split. A row block whose visible keys lie in one split (at decode,
//   every slot under 128 keys) normalises and writes its output itself.
//   Otherwise each split writes its partial (m, l, unnormalised
//   accumulator) to a workspace and counts itself done on a per-row-block
//   count with one atom.acq_rel; the block that finishes last merges the
//   partials in split order, so the result does not depend on which block
//   it is. The entry zeroes the counts on the launch's stream before every
//   launch that uses them. The count is the only atomic: no atomics touch
//   the data. A row block with no visible key at all (an idle slot) is
//   written with zeros by the grid's first split.
// - Rows of a block: G rounded up to 1, 2, 4 or 8 (at most 4 at
//   D > 128, for registers); past 8 rows the grid's y axis takes more row
//   blocks. Padding rows are zero queries that are never stored.
// - The element type of q, the pages and out is a template parameter,
//   fp32 or bf16 (entries *_f32 and *_bf16), as the TPU kernel takes
//   either. A bf16 row is read in the same lane groups, a group in one
//   access of up to 16 bytes (8 values at D = 256, 4 at D = 128), and
//   widened exactly to fp32 in registers; scores, (m, l), the accumulator
//   and the workspace stay fp32; P is rounded to bf16 before P V and l sums
//   it unrounded, as the TPU body's p.astype(v.dtype); the output is
//   rounded once. At bf16 the bytes, and so the bound, halve.
//
// Layouts: q, out (B, K, G, D) contiguous; k_pages, v_pages the
// (P, ps, K, D) pool of one layer; page_table (B, MP) int32; seq_lens (B,)
// int32; the workspace, where the walk spans more than one split,
// (B, K, NS, G, D) and (B, K, NS, G, 2) fp32, NS the number of splits the
// grid spans, then one int32 count per row block. An entry at the end
// tells the wrapper the workspace a launch needs, so that the geometry
// lives in this file alone.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_rows.cuh"

// Knobs that tools/decode_variants.py sets with -D to build the designs it
// times; the defaults are the shipped kernel.
#ifndef DECODE_SPLIT_KEYS
#define DECODE_SPLIT_KEYS 128   // keys of one split (whole pages)
#endif
#ifndef DECODE_WARPS
#define DECODE_WARPS 4          // warps of a block
#endif
#ifndef DECODE_KEYS
#define DECODE_KEYS 4           // keys of a stage at D = 128 and one row
#endif
#ifndef DECODE_STAGES
#define DECODE_STAGES 1         // stages of keys in flight or in use
#endif
#ifndef DECODE_MIN_BLOCKS
#define DECODE_MIN_BLOCKS 1     // blocks an SM (__launch_bounds__)
#endif

namespace {

constexpr int kWarps = DECODE_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kSplitKeys = DECODE_SPLIT_KEYS;
constexpr int kStages = DECODE_STAGES;

// pages of one split: kSplitKeys keys, at least one page and at most 32
// (one page id a lane)
__host__ __device__ inline int split_pages(int ps) {
  const int sp = kSplitKeys / ps;
  return sp < 1 ? 1 : sp > 32 ? 32 : sp;
}
// splits the grid spans: those of pages [pages_start, pages_end)
__host__ __device__ inline int n_splits(int ps, int pages_start,
                                        int pages_end) {
  const int SP = split_pages(ps);
  return (pages_end + SP - 1) / SP - pages_start / SP;
}
// keys a warp has in flight in a stage: DECODE_KEYS at D = 128, more at
// narrower rows and fewer at wider ones (the same registers), and at most
// as many as keep the R x U scores within 16 registers
__host__ __device__ constexpr int stage_keys(int NC, int R) {
  const int u = DECODE_KEYS * 4 / NC, most = 16 / R;
  return u > most ? most : u < 1 ? 1 : u;
}
// the warps' states fit the 48 KB a launch may take without an attribute
static_assert(sizeof(float) * kWarps * 8 * state_floats(4) <= 48 * 1024 &&
                  sizeof(float) * kWarps * 4 * state_floats(8) <= 48 * 1024,
              "too many warps for the states' shared memory");

template <typename T, int NC, bool VEC, int R>
__global__ void __launch_bounds__(kThreads, DECODE_MIN_BLOCKS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int* __restrict__ counters, int K, int G, int D, int ps,
                    int MP, int pages_start, int pages_end, int window,
                    int NS) {
  constexpr int U = stage_keys(NC, R);
  constexpr int SW = state_floats(NC);
  constexpr int W = group_width<NC, VEC, T>();
  extern __shared__ float smem[];   // kWarps x R (warp, row) states
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int SP = split_pages(ps), SK = SP * ps;
  const int s0 = pages_start / SP, s = s0 + blockIdx.x;
  const int n_rb = (G + R - 1) / R;
  const int h = blockIdx.y / n_rb;
  const int row0 = (blockIdx.y - h * n_rb) * R;
  const int b = blockIdx.z;
  const int rows = min(R, G - row0);
  const size_t head = (size_t)b * K + h;

  // one round trip: the split's page ids (lane i: page s * SP + i), the
  // slot's len and q's rows
  const int pg = s * SP + lane;
  const int pid = lane < SP && pg < MP
                      ? __ldg(page_table + (size_t)b * MP + pg) : 0;
  const int len = __ldg(seq_lens + b);
  float qr[R][NC];
  const T* qb = q + (head * G + row0) * D;
#pragma unroll
  for (int r = 0; r < R; ++r)
    load_row<NC, W>(qr[r], qb + (size_t)r * D, lane, D, r < rows);

  // the slot's visible keys [k_lo, k_hi), and the splits that hold them
  int k_lo = pages_start * ps;
  if (window > 0) k_lo = max(k_lo, len - window);
  const int k_hi = min(len, pages_end * ps);
  T* ob = out + (head * G + row0) * D;
  if (k_hi <= k_lo) {     // no visible key: the grid's first split writes
    if (blockIdx.x == 0)  // the rows' zeros
      for (int i = threadIdx.x; i < rows * D; i += kThreads)
        ob[i] = elem::from_float<T>(0.f);
    return;
  }
  const int s_begin = k_lo / SK, s_end = (k_hi + SK - 1) / SK;
  if (s < s_begin || s >= s_end) return;

  // this warp's keys [a, e): its slice of the split, clipped to the
  // visible keys (may be empty)
  const int ks = s * SK, kpw = (SK + kWarps - 1) / kWarps;
  const int a = max(ks + warp * kpw, k_lo);
  const int e = min(ks + min((warp + 1) * kpw, SK), k_hi);

  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  }
  float kx[kStages][U][NC], vx[kStages][U][NC];
  // start the loads of keys [k0, k0 + U) into stage st (none from e on)
  auto issue = [&](int k0, int st) {
    const int rel = k0 - ks;
    int pl = rel / ps, t = rel - pl * ps;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = k0 + u < e;
      const int p = __shfl_sync(kFull, pid, pl & 31);
      const size_t row = (((size_t)p * ps + t) * K + h) * D;
      load_row<NC, W>(kx[st][u], k_pages + row, lane, D, ok);
      load_row<NC, W>(vx[st][u], v_pages + row, lane, D, ok);
      if (++t == ps) {
        t = 0;
        ++pl;
      }
    }
  };
  // keys [k0, k0 + U) of stage st through each row's online softmax, with
  // the re-mask: a key from e on adds exactly 0
  auto use = [&](int k0, int st) {
    float sc[R][U];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) x = fmaf(qr[r][j], kx[st][u][j], x);
        sc[r][u] = x;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r)
          sc[r][u] += __shfl_xor_sync(kFull, sc[r][u], o);
    const int n = e - k0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < n) mx = fmaxf(mx, sc[r][u]);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[r][u] = u < n ? expf(sc[r][u] - m_new) : 0.f;
        sum += sc[r][u];
      }
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
      // at bf16, P V takes P rounded to bf16 and l the unrounded sum, as
      // the TPU kernel's p.astype(v.dtype)
      if constexpr (elem::is_bf16<T>())
#pragma unroll
        for (int u = 0; u < U; ++u) sc[r][u] = elem::round_bf16(sc[r][u]);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float x = acc[r][j] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) x = fmaf(sc[r][u], vx[st][u][j], x);
        acc[r][j] = x;
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(a + st * U, st);
  for (int k0 = a; k0 < e; k0 += kStages * U) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      const int kc = k0 + st * U;
      if (kc >= e) break;
      issue(kc + (kStages - 1) * U, (st + kStages - 1) % kStages);
      use(kc, st);
    }
  }

  // the warps' states, merged in warp order through shared memory; warp w
  // merges rows w, w + kWarps, ... (lane-major accumulators: conflict-free)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* st = smem + (warp * R + r) * SW;
    if (lane == 0) {
      st[0] = m[r];
      st[1] = l[r];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) st[2 + 32 * j + lane] = acc[r][j];
  }
  __syncthreads();
  const bool single = s_end - s_begin == 1;
  const size_t part = (head * NS + (s - s0)) * G + row0;
  for (int r = warp; r < rows; r += kWarps) {
    float M = kNegInf, L = 0.f, A[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) A[j] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* st = smem + (w * R + r) * SW;
      float x[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) x[j] = st[2 + 32 * j + lane];
      absorb(M, L, A, st[0], st[1], x);
    }
    // one split: normalise and write; else this split's partial
    if (single) {
      store_row<NC, W>(ob + (size_t)r * D, A, inverse(L), lane, D);
    } else {
      store_row<NC, W>(ws_acc + (part + r) * D, A, 1.f, lane, D);
      if (lane == 0) {
        ws_ml[2 * (part + r)] = M;
        ws_ml[2 * (part + r) + 1] = L;
      }
    }
  }
  if (single) return;

  // the last of the row block's splits to finish merges them all, in split
  // order: a running (M, L, acc), rescaled when M grows between chunks of
  // SC splits whose loads are all issued before any is used
  __syncthreads();   // every warp's part of the partial is stored
  const int n = s_end - s_begin;
  if (threadIdx.x == 0) {
    // release: the block's partial, ordered before by the barrier, is
    // visible to whoever sees the count; acquire: so are the others'
    unsigned done;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(done)
                 : "l"(counters + (size_t)b * gridDim.y + blockIdx.y)
                 : "memory");
    last = done == (unsigned)n - 1;
  }
  __syncthreads();
  if (!last) return;
  constexpr int SC = NC > 4 ? 4 : 8;
  const size_t first = (head * NS + (s_begin - s0)) * G + row0;
  for (int r = warp; r < rows; r += kWarps) {
    float M = kNegInf, L = 0.f, A[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) A[j] = 0.f;
    for (int i0 = 0; i0 < n; i0 += SC) {
      float mi[SC], li[SC], x[SC][NC];
#pragma unroll
      for (int i = 0; i < SC; ++i) {
        const bool in = i0 + i < n;
        const size_t at = first + (size_t)(i0 + i) * G + r;
        mi[i] = in ? __ldcg(ws_ml + 2 * at) : kNegInf;
        li[i] = in ? __ldcg(ws_ml + 2 * at + 1) : 0.f;
        load_row<NC, W, true>(x[i], ws_acc + at * D, lane, D, in);
      }
      float m_new = M;
#pragma unroll
      for (int i = 0; i < SC; ++i) m_new = fmaxf(m_new, mi[i]);
      const float scale = expf(M - m_new);
      L *= scale;
#pragma unroll
      for (int j = 0; j < NC; ++j) A[j] *= scale;
#pragma unroll
      for (int i = 0; i < SC; ++i) {
        const float w = expf(mi[i] - m_new);
        L += w * li[i];
#pragma unroll
        for (int j = 0; j < NC; ++j) A[j] += w * x[i][j];
      }
      M = m_new;
    }
    store_row<NC, W>(ob + (size_t)r * D, A, inverse(L), lane, D);
  }
}

// Bytes of the workspace a launch takes: each split's partial (m, l,
// accumulator) and one count of finished splits per row block, where the
// walk spans more than one split; else none.
size_t workspace_bytes(int B, int K, int G, int D, int NS) {
  if (NS <= 1) return 0;
  return sizeof(float) * (size_t)B * K * NS * G * (D + 2) +
         sizeof(int) * (size_t)B * K * row_blocks(G, D);
}

template <typename T, int NC, bool VEC, int R>
int launch_as(const T* q, const T* k_pages, const T* v_pages,
              const int* page_table, const int* seq_lens, T* out,
              float* ws_acc, float* ws_ml, int* counters, int B, int K, int G,
              int D, int ps, int MP, int pages_start, int pages_end,
              int window, int NS, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * R * state_floats(NC);
  const dim3 grid(NS, K * row_blocks(G, D), B);
  paged_decode_kernel<T, NC, VEC, R><<<grid, kThreads, smem, stream>>>(
      q, k_pages, v_pages, page_table, seq_lens, out, ws_acc, ws_ml, counters,
      K, G, D, ps, MP, pages_start, pages_end, window, NS);
  return (int)cudaGetLastError();
}

template <typename T>
using Launch = int (*)(const T*, const T*, const T*, const int*, const int*,
                       T*, float*, float*, int*, int, int, int, int, int, int,
                       int, int, int, int, cudaStream_t);

template <typename T, int NC, bool VEC>
Launch<T> rows_as(int R) {
  if constexpr (NC > 4)   // at most 4 rows at D > 128
    return R == 1 ? launch_as<T, NC, VEC, 1>
         : R == 2 ? launch_as<T, NC, VEC, 2> : launch_as<T, NC, VEC, 4>;
  else
    return R == 1 ? launch_as<T, NC, VEC, 1>
         : R == 2 ? launch_as<T, NC, VEC, 2>
         : R == 4 ? launch_as<T, NC, VEC, 4> : launch_as<T, NC, VEC, 8>;
}

// One launch of the kernel's T instance (paged_decode_attention_f32's
// arguments).
template <typename T>
int run(const T* q, const T* k_pages, const T* v_pages,
        const int* page_table, const int* seq_lens, T* out, void* workspace,
        int B, int K, int G, int D, int ps, int MP, int pages_start,
        int pages_end, int window, cudaStream_t stream) {
  const int NS = n_splits(ps, pages_start, pages_end);
  float* ws_acc = static_cast<float*>(workspace);
  float* ws_ml = ws_acc + (size_t)B * K * NS * G * D;
  int* counters = reinterpret_cast<int*>(ws_ml + (size_t)B * K * NS * G * 2);
  if (workspace_bytes(B, K, G, D, NS) > 0) {
    const cudaError_t err = cudaMemsetAsync(
        counters, 0, sizeof(int) * (size_t)B * K * row_blocks(G, D), stream);
    if (err != cudaSuccess) return (int)err;
  }
  // grouped accesses (up to 16 bytes) need D a multiple of a 16-byte
  // group and every row aligned to 16 bytes
  const bool vec = D % (16 / (int)sizeof(T)) == 0 &&
      ((uintptr_t)q | (uintptr_t)k_pages | (uintptr_t)v_pages |
       (uintptr_t)out | (uintptr_t)workspace) % 16 == 0;
  const int R = block_rows(G, D);
  const Launch<T> as =
      D <= 32 ? rows_as<T, 1, false>(R)
      : D <= 64 ? (vec ? rows_as<T, 2, true>(R) : rows_as<T, 2, false>(R))
      : D <= 128 ? (vec ? rows_as<T, 4, true>(R) : rows_as<T, 4, false>(R))
      : (vec ? rows_as<T, 8, true>(R) : rows_as<T, 8, false>(R));
  return as(q, k_pages, v_pages, page_table, seq_lens, out, ws_acc, ws_ml,
            counters, B, K, G, D, ps, MP, pages_start, pages_end, window, NS,
            stream);
}

}  // namespace

// The workspace of a launch (bytes), for paged_decode_attention_f32's
// arguments of the same names.
extern "C" long long paged_decode_workspace_bytes(int B, int K, int G, int D,
                                                  int ps, int pages_start,
                                                  int pages_end) {
  return workspace_bytes(B, K, G, D, n_splits(ps, pages_start, pages_end));
}

// q, out: (B, K, G, D); k_pages, v_pages: (P, ps, K, D); page_table:
// (B, MP) int32; seq_lens: (B,) int32; workspace:
// paged_decode_workspace_bytes(...) bytes (may be any pointer where that is
// 0), whose counts the launch zeroes first on `stream`. 1 <= D <= 256. All
// contiguous, on the device of `stream`. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int paged_decode_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* page_table, const int* seq_lens, float* out, void* workspace,
    int B, int K, int G, int D, int ps, int MP, int pages_start,
    int pages_end, int window, void* stream) {
  return run(q, k_pages, v_pages, page_table, seq_lens, out, workspace, B, K,
             G, D, ps, MP, pages_start, pages_end, window,
             (cudaStream_t)stream);
}

// The same with q, k_pages, v_pages and out in bf16 (the workspace stays
// fp32: partials are rounded once, in the merge's output).
extern "C" int paged_decode_attention_bf16(
    const elem::bf16* q, const elem::bf16* k_pages,
    const elem::bf16* v_pages, const int* page_table, const int* seq_lens,
    elem::bf16* out, void* workspace, int B, int K, int G, int D, int ps,
    int MP, int pages_start, int pages_end, int window, void* stream) {
  return run(q, k_pages, v_pages, page_table, seq_lens, out, workspace, B, K,
             G, D, ps, MP, pages_start, pages_end, window,
             (cudaStream_t)stream);
}
