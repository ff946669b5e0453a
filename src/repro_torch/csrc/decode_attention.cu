// One-token GQA decode attention over a dense KV cache, for Hopper
// (sm_90a), fp32.
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
//
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
template <int NC, bool VEC>
__device__ void store_mean_of_v(const float* __restrict__ vb, int ss, int S,
                                float* __restrict__ ob, int rows, int D,
                                float* smem, int lane, int warp) {
  float x[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) x[j] = 0.f;
  for (int s = warp; s < S; s += kWarps) {
    float y[NC];
    load_row<NC, VEC>(y, vb + (size_t)s * ss, lane, D, true);
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
    store_row<NC, VEC>(ob + (size_t)r * D, x, 1.f / S, lane, D);
}

template <int NC, bool VEC, int R>
__global__ void __launch_bounds__(kThreads, DENSE_MIN_BLOCKS)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int8_t* __restrict__ valid,
              float* __restrict__ out, float* __restrict__ ws_acc,
              float* __restrict__ ws_ml, int* __restrict__ counters, int S,
              int K, int G, int D, int sb, int ss, int sh) {
  constexpr int U = stage_keys(NC, R);
  constexpr int SW = state_floats(NC);
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
  const float* qb = q + (head * G + row0) * D;
#pragma unroll
  for (int r = 0; r < R; ++r)
    load_row<NC, VEC>(qr[r], qb + (size_t)r * D, lane, D, r < rows);

  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  }
  const float* kb = k + (size_t)b * sb + (size_t)h * sh;
  const float* vb = v + (size_t)b * sb + (size_t)h * sh;
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
      load_row<NC, VEC>(kx[u], kb + row, lane, D, ok);
      load_row<NC, VEC>(vx[u], vb + row, lane, D, ok);
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
  float* ob = out + (head * G + row0) * D;
  const size_t part = (head * NS + s) * G + row0;
  if (!any) {
    // no valid key in the split: in a one-split row, none in the row
    if (single) {
      store_mean_of_v<NC, VEC>(vb, ss, S, ob, rows, D, smem, lane, warp);
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
        store_row<NC, VEC>(ob + (size_t)r * D, A, inverse(L), lane, D);
      } else {
        store_row<NC, VEC>(ws_acc + (part + r) * D, A, 1.f, lane, D);
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
        load_row<NC, VEC, true>(x[i], ws_acc + at * D, lane, D,
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
      store_row<NC, VEC>(ob + (size_t)r * D, A, inverse(L), lane, D);
    else if (lane == 0)
      none = true;   // every split empty: no valid key in the row
  }
  __syncthreads();
  if (none) store_mean_of_v<NC, VEC>(vb, ss, S, ob, rows, D, smem, lane, warp);
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

template <int NC, bool VEC, int R>
int launch_as(const float* q, const float* k, const float* v,
              const int8_t* valid, float* out, float* ws_acc, float* ws_ml,
              int* counters, int B, int S, int K, int G, int D, int sb,
              int ss, int sh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * R * state_floats(NC);
  const dim3 grid(n_splits(S), K * row_blocks(G, D), B);
  decode_kernel<NC, VEC, R><<<grid, kThreads, smem, stream>>>(
      q, k, v, valid, out, ws_acc, ws_ml, counters, S, K, G, D, sb, ss, sh);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const float*, const float*, const float*,
                       const int8_t*, float*, float*, float*, int*, int, int,
                       int, int, int, int, int, int, cudaStream_t);

template <int NC, bool VEC>
Launch rows_as(int R) {
  if constexpr (NC > 4)   // at most 4 rows at D > 128
    return R == 1 ? launch_as<NC, VEC, 1>
         : R == 2 ? launch_as<NC, VEC, 2> : launch_as<NC, VEC, 4>;
  else
    return R == 1 ? launch_as<NC, VEC, 1>
         : R == 2 ? launch_as<NC, VEC, 2>
         : R == 4 ? launch_as<NC, VEC, 4> : launch_as<NC, VEC, 8>;
}

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
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 0)   // no key: softmax over nothing sums to 0
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * (size_t)B * K * G * D,
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
  // 8- and 16-byte accesses need every row aligned to them
  const bool vec = D % 4 == 0 && (sb | ss | sh) % 4 == 0 &&
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
       (uintptr_t)workspace) % 16 == 0;
  const int R = block_rows(G, D);
  const Launch as =
      D <= 32 ? rows_as<1, false>(R)
      : D <= 64 ? (vec ? rows_as<2, true>(R) : rows_as<2, false>(R))
      : D <= 128 ? (vec ? rows_as<4, true>(R) : rows_as<4, false>(R))
      : (vec ? rows_as<8, true>(R) : rows_as<8, false>(R));
  return as(q, k, v, valid, out, ws_acc, ws_ml, counters, B, S, K, G, D, sb,
            ss, sh, st);
}
