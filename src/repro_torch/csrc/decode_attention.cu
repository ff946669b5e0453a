// One-token GQA decode attention over a dense KV cache, for Hopper
// (sm_90a), fp32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py ::
// decode_attention_gqa (body _dec_kernel): the G query rows of one kv head
// attend to the keys s of that head's cache with valid[b, s] > 0, with an
// online softmax and the l == 0 -> 1 divisor guard.
//
// What bounds it: bytes. Each (row b, kv head) reads the K and V rows of
// its valid keys once and does 4 * G * D flops per key, so at G <= 8 it does
// about 0.5 G flop per byte, far below the H100's fp32 ridge of about 20
// (67 TFLOP/s / 3.35 TB/s): a GEMV, for which SIMT FMAs on registers are
// enough. The least time is the valid keys' K/V bytes over 3.35 TB/s, which
// needs many key rows in flight on every SM and no bytes read for keys that
// `valid` masks (on a sliding-window layer, half the slab or more).
//
// Design (the split walk of paged_decode_attention.cu, over a dense slab):
// - The key walk is split across blocks, flash-decoding style. A block owns
//   one (row b, kv head h, block of up to 8 rows of the head's group) and
//   one split of kSplitKeys keys, splits aligned at multiples of that size
//   from key 0. What a block computes depends on its split's own keys and
//   validity bytes alone, not on S beyond the split, B or the grid: the
//   same row gives the same bits alone or in a batch, and with invalid
//   keys appended after its last valid split.
// - Each warp takes a contiguous slice of the split's keys (at most 32).
//   One round trip starts it: lane i loads the validity byte of the
//   slice's key i, a ballot makes the slice's mask, and q's rows load
//   beside it. The warp walks from its first valid key to its last, a
//   stage of several keys at a time: it issues the K and V loads of a
//   stage's valid keys before it uses the first (stage_keys), reads
//   nothing for an invalid key and skips a stage with no valid key. A lane
//   holds D / 32 columns of every row: two neighbouring groups of four
//   floats at D = 256, each read with one 16-byte load (8-byte loads at
//   D <= 64; 4-byte loads where D or a stride is not a multiple of 4). q's
//   rows, the warp's (m, l) and its accumulator stay in registers; a score
//   is a dot product over the lanes' columns reduced by xor shuffles.
//   Invalid keys are re-masked (p = 0, out of the max), so each adds
//   exactly 0. No barrier inside the key walk.
// - The warps are merged in warp order through shared memory. A split
//   that `valid` masks entirely (every warp's mask 0) has read no K or V;
//   it only records (m, l) = (-1e30, 0) for its rows. Where the row fits
//   one split the block normalises and writes its output itself. Else each
//   split writes its partial (m, l, unnormalised accumulator) to a
//   workspace and counts itself done on a per-row-block count with one
//   atom.acq_rel; the block that finishes last merges the partials in
//   split order (an empty partial's accumulator is never read), so the
//   result does not depend on which block it is. The entry zeroes the
//   counts on the launch's stream before every launch that uses them.
// - A row with no valid key at all (never on the decode path, where the
//   current position is valid) gets what the TPU body and ref.py give: the
//   mean of V over its S keys, written by the one-split block or the
//   merging block, which walk V for it.
// - Rows of a block: G rounded up to 1, 2, 4 or 8 (at most 4 at
//   D > 128); past 8 rows the grid's y axis takes more row blocks.
//   Padding rows are zero queries that are never stored.
// - The element type of q, k, v and out is a template parameter of this
//   design; the fp32 entry decode_attention_f32 instantiates it at float.
//
// bf16 design (decode_attention_bf16, bf16_dense::decode_kernel_bf16; the
// TPU kernel takes either dtype): q, k, v and out bf16; the scores, (m, l),
// the accumulator and the workspace fp32. It is the TPU body at bf16: the
// scores summed in fp32 from bf16 products, invalid keys out of the max and
// the sums, P rounded to bf16 for P V (p.astype(v.dtype)) while l sums the
// unrounded P, the l == 0 guard, the output rounded once. Every operand of
// both products is a bf16 value, so each product is one native bf16
// mma.sync m16n8k16 (mma_bf16.cuh) with fp32 accumulation: exact. It stays
// bytes-bound (the m16 tile does 16 flops a K/V byte whatever G; the bf16
// ridge is near 295), so the design is about bytes in flight, not products.
// - The walk is the fp32 design's: 128-key splits aligned from key 0, one
//   block per (row b, kv head h, block of up to 16 rows, split), a split
//   that `valid` masks entirely reading no K or V and recording (m, l) =
//   (-1e30, 0), the partials merged in split order by the last block
//   through the per-row-block count, the mean of V for a row with no valid
//   key. So a row alone equals the row in a batch, and invalid keys
//   appended after the last valid split change no bit, as at fp32.
// - The G query rows of a kv head are one m16 tile (rows past G zero): the
//   A operand of S = Q K^T, its fragments read once by ldmatrix from a
//   swizzled Q tile in shared memory and kept in registers at D <= 128 (32
//   registers at D = 128), read again at each k step at D = 256. Every G
//   of the configs (1, 2, 4, 6, 12) is one row block that reads the K/V
//   bytes once; a second row block comes only at G > 16.
// - Each of the 4 warps owns a contiguous 32-key slice of the split: lane i
//   loads the validity byte of key i, a ballot makes the slice's mask, and
//   the warp copies the slice's valid K rows, then its V rows, as two
//   cp.async groups (16-byte copies, smem_copy.cuh) into its own region of
//   shared memory, all issued before any is used: a block has its whole
//   split in flight (64 KB at D = 128, three blocks an SM; at D = 256 the
//   V rows are copied into the K rows' memory after the scores, 72 KB a
//   block, two blocks an SM as registers allow). An invalid key's
//   row is zero-filled by cp.async with src-size 0, so no byte of it is
//   read from global memory; a slice whose mask is 0 copies nothing. Each
//   row's 16-byte chunks are swizzled (chunk c of row r at c ^ (r % 8), or
//   c ^ ((r / 2) % 4) at D <= 32), so that the 8 rows of an ldmatrix matrix
//   and a quarter-warp's copies hit 8 distinct bank groups.
// - Scores: the slice's 4 m16n8 score tiles over D / 16 k steps, K's B
//   fragments by ldmatrix from the (key, d) tile. The slice's softmax in
//   one step: each row's max and sum over its 32 keys take 2 shuffle rounds
//   in a quad (not 5 a key a row); an invalid key is out of the max and
//   its p is 0, so with its zero V row it adds exactly 0, even where its
//   global bytes are not finite. exp(x - m) is ex2.approx of x log2 e -
//   m log2 e; m stays in natural units, the workspace's.
// - P V: the C fragments of score tiles 2j and 2j + 1, packed to bf16
//   pairs (cvt.rn.bf16x2.f32), are the A fragment of P V's k step j (16
//   keys); V's B fragments by ldmatrix.trans from the same layout; the
//   accumulator (16 x D fp32) stays in registers.
// - The warps' states (m, l and the accumulator's rows < G, fp32) are
//   written into each warp's own region and merged in warp order by the
//   block's threads, one output element each: M the warps' max, each
//   non-empty warp weighted by exp(m_w - M). One split: normalise and
//   write bf16; else the split's partial to the workspace, and the last
//   split's block merges the partials in split order, a thread 4
//   neighbouring columns (16-byte loads) or one, with every load of 8 or
//   16 partials issued before any is used and a running (M, l, acc)
//   rescaled once a chunk: a merge of one element a thread in two passes
//   of loads, element after element, took half of Jamba's device time
//   (PERF.md).
// - Rows whose D or strides are not a multiple of 8 values, or whose
//   tensors are not 16-byte aligned, take the same design with 2-byte
//   loads and shared stores in place of cp.async (zeros, no read, for an
//   invalid key): slower, the same results. D is zero-padded to 32, 64,
//   128 or 256 (zero columns add 0; padded columns are never stored).
// Layouts: q and out (B, K, G, D) contiguous (the model's (B, H, D)); k, v
// (B, S, K, D) read through element strides (sb, ss, sh; unit stride on D),
// so the model's cache slab is read in place; valid (B, S) int8
// contiguous; the workspace, where S spans more than one split,
// (B, K, NS, G, D) and (B, K, NS, G, 2) fp32 for NS = ceil(S / kSplitKeys),
// then one int32 count per row block. The kernel contract (BK, G, D),
// (BK, S, D), (BK, S) of the TPU kernel is the case K = 1. An entry at the
// end tells the wrapper the workspace a launch needs, so that the geometry
// lives in this file alone.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_rows.cuh"
#include "mma_bf16.cuh"
#include "smem_copy.cuh"

// Knobs that tools/dense_decode_variants.py sets with -D to build the
// designs it times; the defaults are the shipped kernel.
#ifndef DENSE_SPLIT_KEYS
#define DENSE_SPLIT_KEYS 128   // keys of one split
#endif
#ifndef DENSE_WARPS
#define DENSE_WARPS 4          // warps of a block
#endif
#ifndef DENSE_KEYS
#define DENSE_KEYS 8           // keys of a stage at D = 128 and one row
#endif
#ifndef DENSE_MIN_BLOCKS
#define DENSE_MIN_BLOCKS 1     // blocks an SM (__launch_bounds__)
#endif

namespace {

constexpr int kWarps = DENSE_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kSplitKeys = DENSE_SPLIT_KEYS;
// keys of a warp's slice of a split: one validity byte a lane
constexpr int kSliceKeys = (kSplitKeys + kWarps - 1) / kWarps;
static_assert(kSliceKeys <= 32, "a warp's slice is at most 32 keys");

__host__ __device__ inline int n_splits(int S) {
  return (S + kSplitKeys - 1) / kSplitKeys;
}
// keys a warp has in flight in a stage: DENSE_KEYS at D = 128, more at
// narrower rows and fewer at wider ones (the same registers), and at most
// as many as keep the R x U scores within 16 registers
__host__ __device__ constexpr int stage_keys(int NC, int R) {
  const int u = DENSE_KEYS * 4 / NC, most = 16 / R;
  return u > most ? most : u < 1 ? 1 : u;
}
// the warps' states fit the 48 KB a launch may take without an attribute
static_assert(sizeof(float) * kWarps * 8 * state_floats(4) <= 48 * 1024 &&
                  sizeof(float) * kWarps * 4 * state_floats(8) <= 48 * 1024,
              "too many warps for the states' shared memory");

// The rows' output for a row with no valid key: the mean of V over its S
// keys (vb: key 0's V row of the head), summed by each warp over keys w,
// w + kWarps, ... and over the warps in warp order. Called by every thread
// of the block.
template <int NC, int W, typename T>
__device__ void store_mean_of_v(const T* __restrict__ vb, int ss, int S,
                                T* __restrict__ ob, int rows, int D,
                                float* smem, int lane, int warp) {
  float x[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) x[j] = 0.f;
  for (int s = warp; s < S; s += kWarps) {
    float y[NC];
    load_row<NC, W>(y, vb + (size_t)s * ss, lane, D, true);
#pragma unroll
    for (int j = 0; j < NC; ++j) x[j] += y[j];
  }
  __syncthreads();   // the shared memory's earlier readers are done
#pragma unroll
  for (int j = 0; j < NC; ++j) smem[(warp * NC + j) * 32 + lane] = x[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    x[j] = 0.f;
    for (int w = 0; w < kWarps; ++w) x[j] += smem[(w * NC + j) * 32 + lane];
  }
  for (int r = warp; r < rows; r += kWarps)
    store_row<NC, W>(ob + (size_t)r * D, x, 1.f / S, lane, D);
}

template <typename T, int NC, bool VEC, int R>
__global__ void __launch_bounds__(kThreads, DENSE_MIN_BLOCKS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int8_t* __restrict__ valid,
              T* __restrict__ out, float* __restrict__ ws_acc,
              float* __restrict__ ws_ml, int* __restrict__ counters, int S,
              int K, int G, int D, int sb, int ss, int sh) {
  constexpr int U = stage_keys(NC, R);
  constexpr int SW = state_floats(NC);
  constexpr int W = group_width<NC, VEC, T>();
  extern __shared__ float smem[];   // kWarps x R (warp, row) states
  __shared__ bool last, none;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int NS = gridDim.x, s = blockIdx.x;
  const int n_rb = (G + R - 1) / R;
  const int h = blockIdx.y / n_rb;
  const int row0 = (blockIdx.y - h * n_rb) * R;
  const int b = blockIdx.z;
  const int rows = min(R, G - row0);
  const size_t head = (size_t)b * K + h;

  // one round trip: the validity bytes of this warp's slice [sl, se) of
  // the split (lane i: key sl + i) and q's rows
  const int sl = s * kSplitKeys + warp * kSliceKeys;
  const int se = min(min(sl + kSliceKeys, (s + 1) * kSplitKeys), S);
  const bool mine = sl + lane < se;
  const unsigned mask = __ballot_sync(
      kFull, mine && __ldg(valid + (size_t)b * S + sl + lane) > 0);
  float qr[R][NC];
  const T* qb = q + (head * G + row0) * D;
#pragma unroll
  for (int r = 0; r < R; ++r)
    load_row<NC, W>(qr[r], qb + (size_t)r * D, lane, D, r < rows);

  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  }
  const T* kb = k + (size_t)b * sb + (size_t)h * sh;
  const T* vb = v + (size_t)b * sb + (size_t)h * sh;
  // the slice's keys from its first valid one to its last, U at a time:
  // bit u of `bits` says key k0 + u is valid (no walk where mask is 0)
  const int a = mask ? sl + __ffs(mask) - 1 : sl;
  const int e = mask ? sl + 32 - __clz(mask) : sl;
  for (int k0 = a; k0 < e; k0 += U) {
    const unsigned bits = (mask >> (k0 - sl)) & ((1u << U) - 1u);
    if (bits == 0u) continue;
    float kx[U][NC], vx[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = (bits >> u) & 1u;
      const size_t row = (size_t)(k0 + u) * ss;
      load_row<NC, W>(kx[u], kb + row, lane, D, ok);
      load_row<NC, W>(vx[u], vb + row, lane, D, ok);
    }
    float sc[R][U];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) x = fmaf(qr[r][j], kx[u][j], x);
        sc[r][u] = x;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r)
          sc[r][u] += __shfl_xor_sync(kFull, sc[r][u], o);
    // each row's online softmax over the stage, with the re-mask: an
    // invalid key is out of the max and adds exactly 0
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if ((bits >> u) & 1u) mx = fmaxf(mx, sc[r][u]);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[r][u] = (bits >> u) & 1u ? expf(sc[r][u] - m_new) : 0.f;
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
        for (int u = 0; u < U; ++u) x = fmaf(sc[r][u], vx[u][j], x);
        acc[r][j] = x;
      }
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
  const bool any = __syncthreads_or(mask != 0u);
  const bool single = NS == 1;
  T* ob = out + (head * G + row0) * D;
  const size_t part = (head * NS + s) * G + row0;
  if (!any) {
    // no valid key in the split: in a one-split row, none in the row
    if (single) {
      store_mean_of_v<NC, W>(vb, ss, S, ob, rows, D, smem, lane, warp);
      return;
    }
    if ((int)threadIdx.x < rows) {
      ws_ml[2 * (part + threadIdx.x)] = kNegInf;
      ws_ml[2 * (part + threadIdx.x) + 1] = 0.f;
    }
  } else {
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
  }

  // the last of the row block's splits to finish merges them all, in split
  // order: a running (M, L, acc), rescaled when M grows between chunks of
  // SC splits whose loads are all issued before any is used
  __syncthreads();   // every warp's part of the partial is stored
  if (threadIdx.x == 0) {
    // release: the block's partial, ordered before by the barrier, is
    // visible to whoever sees the count; acquire: so are the others'
    unsigned done;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(done)
                 : "l"(counters + (size_t)b * gridDim.y + blockIdx.y)
                 : "memory");
    last = done == (unsigned)NS - 1;
    none = false;
  }
  __syncthreads();
  if (!last) return;
  constexpr int SC = NC > 4 ? 4 : 8;
  const size_t first = head * NS * G + row0;
  for (int r = warp; r < rows; r += kWarps) {
    float M = kNegInf, L = 0.f, A[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) A[j] = 0.f;
    for (int i0 = 0; i0 < NS; i0 += SC) {
      float mi[SC], li[SC], x[SC][NC];
#pragma unroll
      for (int i = 0; i < SC; ++i) {
        const bool in = i0 + i < NS;
        const size_t at = first + (size_t)(i0 + i) * G + r;
        mi[i] = in ? __ldcg(ws_ml + 2 * at) : kNegInf;
        li[i] = in ? __ldcg(ws_ml + 2 * at + 1) : 0.f;
        // an empty split stored no accumulator
        load_row<NC, W, true>(x[i], ws_acc + at * D, lane, D,
                              in && li[i] > 0.f);
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
    if (L > 0.f)
      store_row<NC, W>(ob + (size_t)r * D, A, inverse(L), lane, D);
    else if (lane == 0)
      none = true;   // every split empty: no valid key in the row
  }
  __syncthreads();
  if (none) store_mean_of_v<NC, W>(vb, ss, S, ob, rows, D, smem, lane, warp);
}

// Bytes of the workspace a launch takes: each split's partial (m, l,
// accumulator) and one count of finished splits per row block, where S
// spans more than one split; else none.
size_t workspace_bytes(int B, int S, int K, int G, int D) {
  const int NS = n_splits(S);
  if (NS <= 1) return 0;
  return sizeof(float) * (size_t)B * K * NS * G * (D + 2) +
         sizeof(int) * (size_t)B * K * row_blocks(G, D);
}

template <typename T, int NC, bool VEC, int R>
int launch_as(const T* q, const T* k, const T* v,
              const int8_t* valid, T* out, float* ws_acc, float* ws_ml,
              int* counters, int B, int S, int K, int G, int D, int sb,
              int ss, int sh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * R * state_floats(NC);
  const dim3 grid(n_splits(S), K * row_blocks(G, D), B);
  decode_kernel<T, NC, VEC, R><<<grid, kThreads, smem, stream>>>(
      q, k, v, valid, out, ws_acc, ws_ml, counters, S, K, G, D, sb, ss, sh);
  return (int)cudaGetLastError();
}

template <typename T>
using Launch = int (*)(const T*, const T*, const T*, const int8_t*, T*,
                       float*, float*, int*, int, int, int, int, int, int,
                       int, int, cudaStream_t);

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

// One launch of the kernel's T instance (decode_attention_f32's
// arguments).
template <typename T>
int run(const T* q, const T* k, const T* v, const int8_t* valid, T* out,
        void* workspace, int B, int S, int K, int G, int D, int sb, int ss,
        int sh, cudaStream_t st) {
  if (S == 0)   // no key: softmax over nothing sums to 0
    return (int)cudaMemsetAsync(out, 0, sizeof(T) * (size_t)B * K * G * D,
                                st);
  const int NS = n_splits(S);
  float* ws_acc = static_cast<float*>(workspace);
  float* ws_ml = ws_acc + (size_t)B * K * NS * G * D;
  int* counters = reinterpret_cast<int*>(ws_ml + (size_t)B * K * NS * G * 2);
  if (workspace_bytes(B, S, K, G, D) > 0) {
    const cudaError_t err = cudaMemsetAsync(
        counters, 0, sizeof(int) * (size_t)B * K * row_blocks(G, D), st);
    if (err != cudaSuccess) return (int)err;
  }
  // grouped accesses (up to 16 bytes) need D and every stride a multiple
  // of a 16-byte group and every row aligned to 16 bytes
  const int vw = 16 / (int)sizeof(T);
  const bool vec = D % vw == 0 && (sb | ss | sh) % vw == 0 &&
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
       (uintptr_t)workspace) % 16 == 0;
  const int R = block_rows(G, D);
  const Launch<T> as =
      D <= 32 ? rows_as<T, 1, false>(R)
      : D <= 64 ? (vec ? rows_as<T, 2, true>(R) : rows_as<T, 2, false>(R))
      : D <= 128 ? (vec ? rows_as<T, 4, true>(R) : rows_as<T, 4, false>(R))
      : (vec ? rows_as<T, 8, true>(R) : rows_as<T, 8, false>(R));
  return as(q, k, v, valid, out, ws_acc, ws_ml, counters, B, S, K, G, D, sb,
            ss, sh, st);
}


// ------------------------------------------------------------------ bf16
namespace bf16_dense {

using elem::bf16;

// Knobs of the bf16 design that tools/dense_decode_variants.py sets with
// -D; DENSE_SPLIT_KEYS holds for both designs.
#ifndef DENSE_BF16_WARPS
#define DENSE_BF16_WARPS 4        // warps of a block: 32-key slices (8: 16)
#endif
#ifndef DENSE_BF16_MIN_BLOCKS
#define DENSE_BF16_MIN_BLOCKS 3   // blocks an SM at D <= 128 (registers)
#endif
#ifndef DENSE_BF16_SHARE_256
#define DENSE_BF16_SHARE_256 1    // 1: at D = 256 a warp's V rows reuse its
#endif                            // K rows' shared memory, after the scores
#ifndef DENSE_BF16_SKIP
#define DENSE_BF16_SKIP 0         // ablations, wrong outputs: 1 no Q K^T,
#endif                            // 2 no P V, 4 no split merge, 8 no
                                  // partials

constexpr int kW = DENSE_BF16_WARPS;
constexpr int kT = 32 * kW;
constexpr int kSK = kSplitKeys / kW;   // keys of a warp's slice
constexpr int kRows = 16;              // query rows of a block: one m16 tile
constexpr int kSkip = DENSE_BF16_SKIP;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSK * kW == kSplitKeys && kSK % 16 == 0 && kSK <= 32,
              "a warp's slice is whole 16-key steps, one validity byte a "
              "lane");

__host__ __device__ inline int row_blocks16(int G) {
  return (G + kRows - 1) / kRows;
}
// V's rows copied into K's after the scores: at D = 256, so that a block
// takes 72 KB of shared memory, not 136 (two blocks an SM, as registers
// allow)
__host__ __device__ constexpr bool kv_share(int DT) {
  return DT > 128 && DENSE_BF16_SHARE_256;
}
// floats between two rows of a warp's accumulator in its merge state (8
// past the row, so a quad's 8-byte stores of rows g hit distinct banks)
__host__ __device__ constexpr int state_stride(int DT) { return DT + 8; }
// Bytes of a warp's region of shared memory: its slice's K and V rows (kSK
// x DT bf16 each; one set where kv_share), which its merge state (m and l
// of 16 rows, then the accumulator's rows) then reuses.
__host__ __device__ constexpr size_t warp_bytes(int DT) {
  const size_t slice =
      sizeof(bf16) * (size_t)(kv_share(DT) ? 1 : 2) * kSK * DT;
  const size_t state = sizeof(float) * (size_t)(2 + state_stride(DT)) * kRows;
  return slice > state ? slice : state;
}
// Dynamic shared memory of one block: the Q tile (16 x DT bf16), then the
// warps' regions.
__host__ __device__ constexpr size_t smem_bytes(int DT) {
  return sizeof(bf16) * (size_t)kRows * DT + kW * warp_bytes(DT);
}
__host__ __device__ constexpr int min_blocks(int DT) {
  return DT <= 128 ? DENSE_BF16_MIN_BLOCKS : 1;
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
// first value) to dst; zero past D, and the whole chunk, with nothing read,
// where the row is not `in`. VEC: one cp.async (D a multiple of 8, so the
// chunk lies wholly inside or past D); else 2-byte loads and shared stores.
template <bool VEC>
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* row,
                                           bool in, int c, int D,
                                           const bf16* any) {
  if constexpr (VEC) {
    const bool ok = in && c < D;
    tilecopy::cp_async16(dst, ok ? row + c : any, ok);
  } else {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      d[e] = in && c + e < D ? p[c + e] : (unsigned short)0;
  }
}

// The rows' output for a row with no valid key: the mean of V over its S
// keys (vb: key 0's V row of the head), a column a thread, summed in key
// order. Called by every thread of the block.
__device__ void store_mean_of_v(const bf16* __restrict__ vb, int ss, int S,
                                bf16* __restrict__ ob, int rows, int D) {
  for (int c = threadIdx.x; c < D; c += kT) {
    float x = 0.f;
    for (int s = 0; s < S; ++s)
      x += __bfloat162float(vb[(size_t)s * ss + c]);
    x *= 1.f / S;
    for (int r = 0; r < rows; ++r)
      ob[(size_t)r * D + c] = __float2bfloat16_rn(x);
  }
}

// The last block's merge of a row block's NS partials (first: row 0's
// partial of split 0), in split order: each thread takes V neighbouring
// columns of a row (one 16-byte load of a partial's where V = 4) and runs
// (M, L, A) over the splits CH at a time, every load of a chunk issued
// before any is used, rescaled once a chunk to the chunk's largest m. An
// empty split (l = 0) adds nothing, and its accumulator (never written) is
// loaded but not used. A row with L = 0 (no valid key) sets `none`. Called
// by every thread of the block.
template <int V, int CH>
__device__ void merge_splits(const float* __restrict__ ws_acc,
                             const float* __restrict__ ws_ml, size_t first,
                             int NS, int G, int rows, int D,
                             bf16* __restrict__ ob, bool& none) {
  const int CV = D / V;   // column groups of a row
  for (int i = threadIdx.x; i < rows * CV; i += kT) {
    const int r = i / CV, c = (i - r * CV) * V;
    float M = kNegInf, L = 0.f, A[V];
#pragma unroll
    for (int e = 0; e < V; ++e) A[e] = 0.f;
    for (int j0 = 0; j0 < NS; j0 += CH) {
      float mj[CH], lj[CH], xj[CH][V];
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const bool in = j0 + u < NS;
        const size_t at = first + (size_t)(j0 + u) * G + r;
        mj[u] = in ? __ldcg(ws_ml + 2 * at) : kNegInf;
        lj[u] = in ? __ldcg(ws_ml + 2 * at + 1) : 0.f;
        if constexpr (V == 4) {
          const float4 x = in ? __ldcg(reinterpret_cast<const float4*>(
                                    ws_acc + at * D + c))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          xj[u][0] = x.x;
          xj[u][1] = x.y;
          xj[u][2] = x.z;
          xj[u][3] = x.w;
        } else {
          xj[u][0] = in ? __ldcg(ws_acc + at * D + c) : 0.f;
        }
      }
      float m_new = M;
#pragma unroll
      for (int u = 0; u < CH; ++u) m_new = fmaxf(m_new, mj[u]);
      const float scale = expf(M - m_new);
      L *= scale;
#pragma unroll
      for (int e = 0; e < V; ++e) A[e] *= scale;
#pragma unroll
      for (int u = 0; u < CH; ++u)
        if (lj[u] > 0.f) {
          const float w = expf(mj[u] - m_new);
          L += w * lj[u];
#pragma unroll
          for (int e = 0; e < V; ++e) A[e] += w * xj[u][e];
        }
      M = m_new;
    }
    if (!(L > 0.f)) {
      none = true;   // every split empty: no valid key in the row
      continue;
    }
    const float inv = inverse(L);
#pragma unroll
    for (int e = 0; e < V; ++e)
      ob[(size_t)r * D + c + e] = __float2bfloat16_rn(A[e] * inv);
  }
}

template <int DT, bool VEC>
__global__ void __launch_bounds__(kT, min_blocks(DT))
decode_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const int8_t* __restrict__ valid, bf16* __restrict__ out,
                   float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                   int* __restrict__ counters, int S, int K, int G, int D,
                   int sb, int ss, int sh) {
  constexpr int KS = DT / 16;        // k steps of Q K^T
  constexpr int NO = DT / 8;         // m16n8 output tiles
  constexpr int NT = kSK / 8;        // m16n8 score tiles of a slice
  constexpr int CPR = DT / 8;        // 16-byte chunks of a row
  constexpr int RB = 2 * DT;         // bytes of a tile row
  constexpr int SW = state_stride(DT);
  constexpr bool QR = DT <= 128;     // Q's fragments held in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ bool last, none;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* const regions = smem_raw + sizeof(bf16) * kRows * DT;
  bf16* ks = reinterpret_cast<bf16*>(regions + warp * warp_bytes(DT));
  bf16* vs = kv_share(DT) ? ks : ks + kSK * DT;
  auto state = [&](int w) {
    return reinterpret_cast<const float*>(regions + w * warp_bytes(DT));
  };
  const int NS = gridDim.x, s = blockIdx.x;
  const int n_rb = row_blocks16(G);
  const int h = blockIdx.y / n_rb;
  const int row0 = (blockIdx.y - h * n_rb) * kRows;
  const int b = blockIdx.z;
  const int rows = min(kRows, G - row0);
  const size_t head = (size_t)b * K + h;

  // Q's rows into the swizzled Q tile, zero past the block's rows and past
  // D: one cp.async group, in flight with the validity bytes
  const bf16* qb = q + (head * G + row0) * D;
#pragma unroll
  for (int j = 0; j < (kRows * CPR + kT - 1) / kT; ++j) {
    const int i = threadIdx.x + j * kT, r = i / CPR, c = i % CPR;
    if (i < kRows * CPR)
      copy_chunk<VEC>(qs + r * DT + 8 * (c ^ swizzle_key<DT>(r)),
                      qb + (r < rows ? (size_t)r * D : 0), r < rows, 8 * c,
                      D, qb);
  }
  asm volatile("cp.async.commit_group;");

  // this warp's slice [sl, sl + kSK) of the split: lane i reads key sl +
  // i's validity byte, and a ballot makes the slice's mask
  const int sl = s * kSplitKeys + warp * kSK;
  const bool in_slice = lane < kSK && sl + lane < S;
  const unsigned mask = __ballot_sync(
      kFull, in_slice && __ldg(valid + (size_t)b * S + sl + lane) > 0);
  const bf16* kb = k + (size_t)b * sb + (size_t)h * sh;
  const bf16* vb = v + (size_t)b * sb + (size_t)h * sh;
  // the slice's K rows, then its V rows, one cp.async group each (an empty
  // group where the mask is 0); an invalid key's row is zero-filled and
  // nothing of it is read
  auto copy_rows = [&](bf16* dst, const bf16* src) {
    if (mask) {
#pragma unroll
      for (int j = 0; j < kSK * CPR / 32; ++j) {
        const int i = lane + 32 * j, r = i / CPR, c = i % CPR;
        const bool ok = (mask >> r) & 1u;
        copy_chunk<VEC>(dst + r * DT + 8 * (c ^ swizzle_key<DT>(r)),
                        src + (ok ? (size_t)(sl + r) * ss : 0), ok, 8 * c, D,
                        src);
      }
    }
    asm volatile("cp.async.commit_group;");
  };
  copy_rows(ks, kb);
  if constexpr (kv_share(DT))
    asm volatile("cp.async.commit_group;");   // V's rows come later
  else
    copy_rows(vs, vb);
  asm volatile("cp.async.wait_group 2;" ::: "memory");   // my Q chunks
  const bool any = __syncthreads_or(mask != 0u);        // everyone's

  const bool single = NS == 1;
  bf16* ob = out + (head * G + row0) * D;
  const size_t part = (head * NS + s) * G + row0;
  if (!any) {
    // no valid key in the split: in a one-split row, none in the row
    if (single) {
      store_mean_of_v(vb, ss, S, ob, rows, D);
      return;
    }
    if ((int)threadIdx.x < rows) {
      ws_ml[2 * (part + threadIdx.x)] = kNegInf;
      ws_ml[2 * (part + threadIdx.x) + 1] = 0.f;
    }
  } else {
    float* st = reinterpret_cast<float*>(ks);   // this warp's merge state
    if (mask) {
      const int g = lane >> 2, t = lane & 3;
      // ldmatrix addresses of this lane (shared-memory bytes): row mr of
      // matrix mi. Every row a lane names is mr modulo 8, so the swizzle's
      // key is the lane's own, and chunk 2 kk + c0 lies at 8 (kk / 4) +
      // col[kk % 4] (kk unrolled: each address a register plus an
      // immediate).
      const int mi = lane >> 3, mr = lane & 7;
      const int key = swizzle_key<DT>(mr);
      uint32_t qcol[4], kcol[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qcol[u] = 16 * ((2 * u + (mi >> 1)) ^ key);
        kcol[u] = 16 * ((2 * u + (mi & 1)) ^ key);
      }
      auto at = [](const uint32_t(&col)[4], int kk) {
        return col[kk % 4] + 128 * (kk / 4);
      };
      // Q's A fragment: (rows 0-7 | 8-15) x (columns 0-7 | 8-15); K's B
      // fragments of two n-tiles: (keys 0-7 | 8-15) x (d 0-7 | 8-15); V's,
      // transposed: (keys 0-7 | 8-15) x (d 0-7 | 8-15), V's chunks Q's
      const uint32_t qa = bf16mma::smem_addr(qs) + (mr + 8 * (mi & 1)) * RB;
      const uint32_t ka = bf16mma::smem_addr(ks) + (mr + 8 * (mi >> 1)) * RB;
      const uint32_t va = bf16mma::smem_addr(vs) + (mr + 8 * (mi & 1)) * RB;
      uint32_t qf[QR ? KS : 1][4];
      if constexpr (QR) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          bf16mma::ldsm_x4(qf[kk], qa + at(qcol, kk));
      }
      asm volatile("cp.async.wait_group 1;" ::: "memory");   // K's rows
      __syncwarp();
      // scores: sc[jn] is the m16n8 tile of keys sl + 8 jn ..
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
      // the slice's softmax of rows g (r = 0: elements 0, 1) and g + 8
      // (r = 1: elements 2, 3): element e of tile jn is key 8 jn + 2 t +
      // (e & 1); an invalid key is out of the max and its p is 0
      float m[2], l[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e)
            if ((mask >> (8 * jn + 2 * t + (e & 1))) & 1u)
              mx = fmaxf(mx, sc[jn][e]);
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float ms = mx * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            sc[jn][e] = (mask >> (8 * jn + 2 * t + (e & 1))) & 1u
                            ? exp2_approx(fmaf(sc[jn][e], kLog2e, -ms))
                            : 0.f;
            sum += sc[jn][e];
          }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        m[r] = mx;
        l[r] = sum;   // the unrounded P
      }
      if constexpr (kv_share(DT)) {
        __syncwarp();   // every lane's reads of K's rows are done
        copy_rows(vs, vb);
      }
      asm volatile("cp.async.wait_group 0;" ::: "memory");   // V's rows
      __syncwarp();
      // o = P V: k step jp takes score tiles 2 jp, 2 jp + 1 rounded to bf16
      // as its A fragment (keys 16 jp .. 16 jp + 15 of the slice)
      float o[NO][4];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
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
      // the warp's state over its slice's rows (m, l of 16 rows; the
      // accumulator's rows < rows, columns < D)
      __syncwarp();   // every lane's reads of the slice are done
      if (t == 0) {
        st[g] = m[0];
        st[g + 8] = m[1];
        st[kRows + g] = l[0];
        st[kRows + g + 8] = l[1];
      }
      float* acc = st + 2 * kRows;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (8 * n >= D) break;
        if (g < rows)
          *reinterpret_cast<float2*>(acc + g * SW + 8 * n + 2 * t) =
              make_float2(o[n][0], o[n][1]);
        if (g + 8 < rows)
          *reinterpret_cast<float2*>(acc + (g + 8) * SW + 8 * n + 2 * t) =
              make_float2(o[n][2], o[n][3]);
      }
    } else if (lane < kRows) {   // an empty slice: (m, l) = (-1e30, 0)
      st[lane] = kNegInf;
      st[kRows + lane] = 0.f;
    }
    __syncthreads();
    // the warps merged in warp order, an output element a thread: M their
    // max, each non-empty warp (l > 0) weighted by exp(m_w - M). One split:
    // normalise and write, rounded to bf16 once; else this split's partial
    for (int i = threadIdx.x; i < rows * D; i += kT) {
      const int r = i / D, c = i - r * D;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kW; ++w) M = fmaxf(M, state(w)[r]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const float* sw = state(w);
        const float lw = sw[kRows + r];
        if (lw > 0.f) {
          const float x = expf(sw[r] - M);
          L += x * lw;
          A += x * sw[2 * kRows + r * SW + c];
        }
      }
      if (single) {
        ob[(size_t)r * D + c] = __float2bfloat16_rn(A * inverse(L));
      } else {
        ws_acc[(part + r) * D + c] = A;
        if (c == 0) {
          ws_ml[2 * (part + r)] = M;
          ws_ml[2 * (part + r) + 1] = L;
        }
      }
    }
    if (single || (kSkip & 8)) return;
  }

  // the last of the row block's splits to finish merges them all, in
  // split order (merge_splits)
  __syncthreads();   // every thread's part of the partial is stored
  if (threadIdx.x == 0) {
    // release: the block's partial, ordered before by the barrier, is
    // visible to whoever sees the count; acquire: so are the others'
    unsigned done;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(done)
                 : "l"(counters + (size_t)b * gridDim.y + blockIdx.y)
                 : "memory");
    last = done == (unsigned)NS - 1;
    none = false;
  }
  __syncthreads();
  if (!last || (kSkip & 4)) return;
  // 16-byte loads of the partials where a row block has 4 columns a
  // thread or more (and the workspace allows them); else a column a
  // thread, 16 splits a chunk
  const size_t first = head * NS * G + row0;
  if (D % 4 == 0 && rows * D >= 4 * kT &&
      reinterpret_cast<uintptr_t>(ws_acc) % 16 == 0)
    merge_splits<4, 8>(ws_acc, ws_ml, first, NS, G, rows, D, ob, none);
  else
    merge_splits<1, 16>(ws_acc, ws_ml, first, NS, G, rows, D, ob, none);
  __syncthreads();
  if (none) store_mean_of_v(vb, ss, S, ob, rows, D);
}

template <int DT, bool VEC>
int launch_as(const bf16* q, const bf16* k, const bf16* v,
              const int8_t* valid, bf16* out, float* ws_acc, float* ws_ml,
              int* counters, int B, int S, int K, int G, int D, int sb,
              int ss, int sh, cudaStream_t stream) {
  // the attribute is set once per instance and device (it holds for the
  // current device only)
  static bool configured[kMaxDevices] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  constexpr size_t smem = smem_bytes(DT);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(decode_kernel_bf16<DT, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const dim3 grid(n_splits(S), K * row_blocks16(G), B);
  decode_kernel_bf16<DT, VEC><<<grid, kT, smem, stream>>>(
      q, k, v, valid, out, ws_acc, ws_ml, counters, S, K, G, D, sb, ss, sh);
  return (int)cudaGetLastError();
}

// One launch of the bf16 design (decode_attention_bf16's arguments). Its
// workspace is the fp32 design's (decode_attention_workspace_bytes): the
// same partials, and no more counts (one per 16 rows, not per 8).
int run_bf16(const bf16* q, const bf16* k, const bf16* v,
             const int8_t* valid, bf16* out, void* workspace, int B, int S,
             int K, int G, int D, int sb, int ss, int sh, cudaStream_t st) {
  if (S == 0)   // no key: softmax over nothing sums to 0
    return (int)cudaMemsetAsync(out, 0,
                                sizeof(bf16) * (size_t)B * K * G * D, st);
  const int NS = n_splits(S);
  float* ws_acc = static_cast<float*>(workspace);
  float* ws_ml = ws_acc + (size_t)B * K * NS * G * D;
  int* counters = reinterpret_cast<int*>(ws_ml + (size_t)B * K * NS * G * 2);
  if (NS > 1) {
    const cudaError_t err = cudaMemsetAsync(
        counters, 0, sizeof(int) * (size_t)B * K * row_blocks16(G), st);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte copies need D and every stride a multiple of 8 values and q, k
  // and v 16-byte aligned
  const bool vec = D % 8 == 0 && (sb | ss | sh) % 8 == 0 &&
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  auto as = D <= 32 ? (vec ? launch_as<32, true> : launch_as<32, false>)
          : D <= 64 ? (vec ? launch_as<64, true> : launch_as<64, false>)
          : D <= 128 ? (vec ? launch_as<128, true> : launch_as<128, false>)
          : (vec ? launch_as<256, true> : launch_as<256, false>);
  return as(q, k, v, valid, out, ws_acc, ws_ml, counters, B, S, K, G, D, sb,
            ss, sh, st);
}

}  // namespace bf16_dense

}  // namespace

// The workspace of a launch (bytes), for decode_attention_f32's arguments
// of the same names.
extern "C" long long decode_attention_workspace_bytes(int B, int S, int K,
                                                      int G, int D) {
  return workspace_bytes(B, S, K, G, D);
}

// q, out: (B, K, G, D) contiguous, q pre-scaled; k, v: (B, S, K, D) at
// element strides (sb, ss, sh) with unit stride on D; valid: (B, S) int8
// contiguous; workspace: decode_attention_workspace_bytes(...) bytes (may
// be any pointer where that is 0), whose counts the launch zeroes first on
// `stream`. 1 <= D <= 256, all on the device of `stream`. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int decode_attention_f32(const float* q, const float* k,
                                    const float* v, const int8_t* valid,
                                    float* out, void* workspace, int B, int S,
                                    int K, int G, int D, int sb, int ss,
                                    int sh, void* stream) {
  return run(q, k, v, valid, out, workspace, B, S, K, G, D, sb, ss, sh,
             (cudaStream_t)stream);
}

// The same with q, k, v and out in bf16, through the bf16 design (the
// workspace stays fp32: partials are rounded once, in the merge's output).
extern "C" int decode_attention_bf16(const elem::bf16* q,
                                     const elem::bf16* k,
                                     const elem::bf16* v,
                                     const int8_t* valid, elem::bf16* out,
                                     void* workspace, int B, int S, int K,
                                     int G, int D, int sb, int ss, int sh,
                                     void* stream) {
  return bf16_dense::run_bf16(q, k, v, valid, out, workspace, B, S, K, G, D,
                              sb, ss, sh, (cudaStream_t)stream);
}
