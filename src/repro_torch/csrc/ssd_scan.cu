// Mamba-2 SSD intra-chunk scan for Hopper (sm_90a) on the tensor cores:
// 3xTF32 products at fp32, native bf16 products at bf16.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:53 ::
// ssd_chunk_scan (body _ssd_kernel). For each (batch*chunk bc, head h) of
// a chunk of l positions:
//   y[i]  = sum_{j <= i} (C_i . B_j) * exp(dA_i - dA_j) * dt_j * x_j   (l, P)
//   state = sum_j exp(dA_last - dA_j) * dt_j * B_j (x) x_j              (N, P)
// B and C are shared by every head of a bc. x, B and C are fp32 or bf16 (one
// type for the three: ssd_chunk_scan_f32, ssd_chunk_scan_bf16); dt and dA
// are fp32, and y and the state are written as fp32, in both instances, as
// the TPU kernel widens its inputs and writes fp32 (kernel.py:26-30, 81-84).
// The fp32 instance keeps fp32 accuracy: each product is 3xTF32. The bf16
// instance takes the inputs' exact values and sums in fp32, but carries
// each fp32 gate (G, and B o w) as two bf16 parts, which drops a residual
// of up to 2^-16 of the gate (about 17 bits kept, where 3xTF32 keeps about
// 22): its outputs hold the kernel's tolerance (SSD_TOL, 1e-4 of the
// outputs' scale), not fp32 accuracy.
//
// What bounds it: at the dense path's chunk (l = 256, N = 128, P = 64)
// operations at fp32: the scores (l*l*N/2 flops per bc, once for all
// heads), y (l*l*P per head under the causal mask) and the state (2*l*N*P
// per head) are about 30 flops per byte of a head's own inputs and
// outputs, above the fp32 ridge. The products run on the tensor cores as
// 3xTF32 mma.sync (mma_tf32x3.cuh), which keeps fp32 accuracy (one TF32
// product misses the kernel's tolerance; tests/test_torch_ssd_tf32x3.py).
// At bf16 the same products take two bf16 parts at the bf16 rate, under
// the time of the bytes (bf16 x, B and C; fp32 dt, dA, y and the state):
// bytes bound every shape there. At the pool's chunks (l <= 16) the work
// is bound by bytes at either dtype: the (N, P) state of every head is 80%
// of them.
//
// fp32 design (ssd_kernel<RT, PT>): one launch on a grid of (BC,
// head groups, roles). A block works on one bc and a group of HG heads,
// in one of two roles (state roles first, then y row tiles, longest
// first):
// * a y role owns a row tile of RT rows (RT = 64; 16 at l <= 16, where the
//   whole chunk is one tile). It computes the tile's scores C_i . B_j over
//   the keys j up to its last row once, into a strip in shared memory
//   (SSD_STRIP_KEYS keys at a time; a longer row tile recomputes its strip
//   for each round of heads), then walks its heads: each warp takes a
//   16-row slab of one head of a round, gates the strip into G in registers
//   while building each A fragment (by select: above the diagonal the
//   exponent is taken at 0, since exp(dA_i - dA_j) may be inf there and
//   inf * 0 is NaN; then dt_j), and accumulates y += G x over the key
//   tiles up to its last row;
// * a state role owns NT state rows n; each warp takes a 16-row m-tile of
//   one head of a round: state = (B o w)^T x with w_j = exp(dA_last -
//   dA_j) dt_j (0 past l, by select), gated the same way while building A.
//   A dt = 0 position gives w = 0 and adds exactly 0. Its rounds of heads
//   stream their key tiles as one pipeline.
// Key tiles of x (with dA and dt), of B and the C rows are copied by
// cp.async, two stages at l > 16 (one tile at l <= 16, where a y role
// copies its first x with C and B), into fp32 tiles. Every product is a
// 3xTF32 m16n8k8 mma.sync. Fragments are read from shared memory with
// strides that put the 32 lanes on 32 distinct banks and split into TF32
// halves in registers. y and the state are stored from the accumulator
// fragments: lanes with the same t cover 32 contiguous bytes along the
// state's n in the model layout, so every sector of the state written
// there is whole.
// 16 warps a block at l > 16 and P <= 64 (one block an SM: the strip and
// two stages of x for 4 heads take 142 KB), 8 otherwise.
// Where the time goes (tools/ssd_variants.py, NVIDIA H100 at 700 W, the
// dense shape x (16, 24, 256, 64)): about 0.155 ms of device time, 3x the
// parent's speed but 4.5x the 3xTF32 products' time at mma.sync's
// measured rate. The loop, barriers, copies and stores alone take 0.05
// ms, the copies 0.03 more; splitting x costs 10%, the gates 6%; each
// warp's mma.sync issue waits on shared-memory loads and splits, which 16
// warps at 128 registers cannot prefetch. The knobs move it by 5% at most.
//
// bf16 design (namespace bf16_ssd, ssd_kernel<RT, PT>): the same grid,
// roles, rounds of heads and summation order, on bf16 tiles and bf16
// products.
// * x, B and C stay bf16 in shared memory, copied by 16-byte cp.async
//   (2-byte loads and stores where a width, a stride or a base is not a
//   multiple of 8 values); dA and dt by 4-byte cp.async. Each bf16 row is
//   padded by 16 bytes, an odd number of 16-byte units a row, so that the 8
//   rows of an ldmatrix matrix, and the 8 chunks a quarter-warp copies, hit
//   8 distinct bank groups. The score strip stays fp32 (rows padded by 8
//   floats: the float2 reads of G's fragments are conflict-free).
// * Scores: C B^T on bf16 mma.sync m16n8k16 over N padded to 16 (zero
//   columns add 0): C's A fragments by ldmatrix x4 from the C rows, B's by
//   x2 from the B tile (keys by n, that is n by k). Each product is exact.
// * y = G x and the state (B o w)^T x: G is gated in fp32 from the strip
//   as at fp32; B o w is B's A fragment, read by ldmatrix.trans from the
//   same B tile (keys by n), widened and scaled by w in fp32. Each is split
//   into two bf16 parts, hi = bf16(v) and mid = bf16(v - hi) (v - hi is
//   exact; what is left is at most 2^-16 |v|), and multiplied by x's B
//   fragments, read by ldmatrix.trans from the (key, p) tile: each part
//   times a bf16 x is exact, and two parts keep SSD_TOL where one misses
//   it (tests/test_torch_ssd_bf16_mma.py emulates the arithmetic).
// * y and the state are stored as the fp32 design stores them, but with
//   c0, c1 (c2, c3) as one 8-byte store where p has unit stride: y in
//   either layout, the state in the kernel's (s_sp = 1), where 4-byte
//   stores write half a sector an instruction. In the model's layout (the
//   state (P, N), s_sn = 1) the state's stores stay 4-byte: there 8 lanes
//   g write 32 contiguous bytes along n, whole sectors already.
// * SSD_STAGES (2) stages of 64-key tiles at l > 16, 16 heads a block,
//   SSD_WARPS (16) warps at P <= 64 (one block an SM), 8 at P = 128. At
//   l <= 16 one tile and 8 warps, two blocks an SM (ptxas held to 128
//   registers at P <= 64), and a block takes one round of its state
//   role's heads: 4 heads of two 16-row m-tiles where N > 16, 8 heads of
//   one where N <= 16 (a second would lie past N). Such a launch takes
//   one block's time: at 8 heads a block a state role at N 128 took two
//   rounds one after the other, and the mamba2 pool's own calls were 12%
//   slower than the fp32-widening instance's.
// * ptxas (CUDA 12.8), registers by (rows, P): (64, 16) 94, (64, 32) 114,
//   (64, 64) 128, (64, 128) 231; (16, 16) 84, (16, 32) 104, (16, 64) 128,
//   (16, 128) 231; no spills. Shared memory: 142 KB at (64, 64) with N 128
//   or 16 (the strip 66 KB, the x slots of 4 heads in 2 stages 76 KB), 165
//   KB at (64, 128) with N 256, 29 KB at (16, 64) with N 128.
// Measured (tools/compare_kernel.py and tools/ssd_variants.py against the
// fp32-widening instance it replaced, in turns; NVIDIA H100 80GB HBM3 at
// 700 W, device ms): mamba2's dense chunk x (16, 24, 256, 64) 0.065
// against 0.126 (0.067 against 0.121 in the model's layout), Jamba's x
// (32, 128, 128, 64) at N 16 0.191-0.197 against 0.395-0.399; the pools'
// 16-position chunks x (8, 24, 16, 64) and (8, 128, 16, 64) 0.0054 and
// 0.0064 against 0.0062 and 0.0118-0.0120 in the model's layout (0.0056
// and 0.0062 against 0.0116 and 0.0135 in the kernel's); the mamba2
// pool's own 1,200 calls 5.35 ms against 6.77-6.85. 32-key tiles, 3 or 4
// stages, 8 heads a block at l > 16, 8 warps, or copying a y role's first
// x tiles with its strip's ran slower or the same; streaming a y role's
// rounds of heads as one pipeline took 4.6% off Jamba's and added 4.5% to
// mamba2's.
//
// Summation order, fixed by absolute position: a score sums its k step kk
// (8 wide at fp32, 16 at bf16) over n into accumulator kk % 4, and the
// four are added in order at the end; y and the state each carry one
// accumulator over key steps j (8 keys at fp32, 16 at bf16) in increasing
// order; each step adds lo x hi, hi x lo, hi x hi at fp32, mid x, then
// hi x at bf16 (the smaller terms first).
// No sum is split across warps or blocks and there are no atomics. Tiles
// wholly above a warp's rows are skipped, and a step past a row's
// diagonal or past l adds exact zeros. So neither HG, NT, BC, the row
// tile nor the key tile changes an output's bits: a bc gives the same y
// and state alone and packed, and a chunk padded with dt = 0 to any l
// bucket (l <= 16) the same y rows and state, in either instance.
//
// Layouts, all through element strides: x (bc, h, j, p) at (x_sbc, x_sh,
// x_sl), unit stride on p; dt and dA (bc, h, j) at (d_sbc, d_sh, d_sl); B
// and C (bc, j, n) at (b_sbc, b_sl), unit stride on n; y (bc, h, i, p) at
// (y_sbc, y_sh, y_sl), unit stride on p; state (bc, h, n, p) at (s_sbc,
// s_sh, s_sn, s_sp). The TPU kernel's layout and the model's (b, nc, l, H,
// P) layout are both strides of these; rows are copied 16 bytes at a time
// where widths, strides and pointers allow it, one element otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "smem_copy.cuh"

// Knobs (tools/ssd_variants.py sets them with -D): heads a block takes at
// l <= 16 and above, state rows of a state role at l <= 16 and above, the
// keys of a y role's score strip, stages of copies, warps a block (at
// l > 16 and P <= 64), and positions of a key tile at l > 16. The state
// rows, the strip's keys, the stages and the warps hold for the bf16
// design too; its heads a block and key tiles are its own constants.
#ifndef SSD_HEADS_SMALL
#define SSD_HEADS_SMALL 4
#endif
#ifndef SSD_HEADS_LARGE
#define SSD_HEADS_LARGE 8
#endif
#ifndef SSD_NT_SMALL
#define SSD_NT_SMALL 32
#endif
#ifndef SSD_NT_LARGE
#define SSD_NT_LARGE 64
#endif
#ifndef SSD_STRIP_KEYS
#define SSD_STRIP_KEYS 256
#endif
#ifndef SSD_STAGES
#define SSD_STAGES 2
#endif
#ifndef SSD_WARPS
#define SSD_WARPS 16
#endif
#ifndef SSD_KEY_TILE
#define SSD_KEY_TILE 32
#endif
// Ablations, for timing only (tools/ssd_variants.py): 1 drops the y
// roles, 2 the state roles, 4 every product, 8 the score strips, 16 the
// copies of x rows, 32 the copies of dA and dt, 64 the split of x (its
// fragments pass unsplit), 128 the gates (A is the raw score or B), 256
// the stores (kept in the code behind a test that always fails).
#ifndef SSD_SKIP
#define SSD_SKIP 0
#endif

namespace {

using tilecopy::cp_async16;
using tilecopy::cp_async4;

constexpr int kMaxSmem = 232448;   // a block's shared memory on Hopper

// T: the element type of x, B and C (float, or elem::bf16 in bf16_ssd)
template <typename T>
struct Args {
  const T* x;
  const float *dt, *da;
  const T *B, *C;
  float *y, *st;
  int H, l, P, N, HG, state_tiles, vec_x, vec_b;
  int x_sbc, x_sh, x_sl, d_sbc, d_sh, d_sl, b_sbc, b_sl;
  int y_sbc, y_sh, y_sl, s_sbc, s_sh, s_sn, s_sp;
};

__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }

// exp(x) as 2^(x log2 e) on the special function unit (relative error about
// 2^-21; results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The geometry of the instance with row tiles of RT rows and head width PT
// (P padded to 16, 32, 64 or 128). Sizes in floats.
template <int RT, int PT>
struct Geo {
  // warps of a block: SSD_WARPS with 64-row tiles at P <= 64, else 8
  // (registers at P = 128; at l <= 16 a block has little work)
  static constexpr int kWarps = RT == 64 && PT <= 64 ? SSD_WARPS : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlabs = RT / 16;      // 16-row slabs of a row tile
  static constexpr int kPT = PT;
  // positions of a key tile: the chunk at l <= 16; SSD_KEY_TILE at
  // P <= 64; 32 at P = 128 (shared memory)
  static constexpr int kKT = RT == 16 ? 16 : PT <= 64 ? SSD_KEY_TILE : 32;
  // copies in flight: one tile at l <= 16, SSD_STAGES tiles at P <= 64,
  // two at P = 128 (shared memory)
  static constexpr int kStages = RT == 16 ? 1 : PT <= 64 ? SSD_STAGES : 2;
  static constexpr int kKS = RT == 16 ? 16 : SSD_STRIP_KEYS;  // strip keys
  static constexpr int kNT = PT / 8;          // n-tiles of a head's columns
  static constexpr int kNG = kNT < 4 ? kNT : 4;  // n-tiles an mma3 group
  static constexpr int kHRy = kWarps / kSlabs;  // heads of a y round
  // state rows of a state role and its m-tiles
  static constexpr int kNTS = RT == 16 ? SSD_NT_SMALL : SSD_NT_LARGE;
  static constexpr int kMT = kNTS / 16;
  static constexpr int kHRs = kWarps / kMT;    // heads of a state round
  // x rows: PT + 8 floats, so that b0 (row t, column g) hits bank 8 t + g
  static constexpr int kSX = PT + 8;
  // one head's key tile: x rows, then dA and dt
  static constexpr int kSlot = kKT * kSX + 2 * kKT;
  // strip rows: keys + 4, so that a0 (row g, column t) hits bank 4 g + t
  static constexpr int kSS = kKS + 4;
  // B rows of a state role: NT + 8 (8 t + g, as x)
  static constexpr int kSBN = kNTS + 8;
  static_assert(kStages > 1 || kKS == kKT, "one stage holds one tile");
  static_assert(kKS % kKT == 0, "a strip holds whole key tiles");
  static_assert(kWarps % kSlabs == 0 && kWarps % kMT == 0,
                "warps take whole heads");

  // C and B rows of a y role: padded N + 4 (4 g + t, as the strip)
  static __host__ __device__ int sc(int N) { return pad8(N) + 4; }
  // At l <= 16 the x slots lie apart from the C rows and the B tile, and
  // a y role copies its first round of x with them: one round trip to
  // memory, not two, before the products.
  static constexpr bool kEarly = RT == 16;
  // a y role: the strip, then a region that holds the C rows and the B
  // tiles while the strip is made, the x slots while y is (or beside them)
  static __host__ __device__ size_t y_floats(int N) {
    const size_t b = (size_t)(RT + kStages * kKT) * sc(N);
    const size_t x = (size_t)kStages * kHRy * kSlot;
    return (size_t)RT * kSS + (kEarly ? b + x : b > x ? b : x);
  }
  static constexpr size_t state_floats() {
    return (size_t)kStages * (kKT * kSBN + kHRs * kSlot);
  }
  // heads a block takes
  static __host__ int heads(int) {
    return RT == 16 ? SSD_HEADS_SMALL : SSD_HEADS_LARGE;
  }
  // a block's shared memory in bytes
  static __host__ __device__ size_t smem(int N) {
    const size_t ys = y_floats(N), ss = state_floats();
    return (ys > ss ? ys : ss) * sizeof(float);
  }
};

// 4 fp32 elements at column c of a row (row_ok: the row exists) of width
// W into dst, zero past W or when !row_ok. vec: one 16-byte cp.async (W,
// the strides and the base are multiples of 4, so the unit lies wholly
// inside or past W); else one 4-byte cp.async an element. `any` is a
// valid address for the copies that read nothing.
__device__ __forceinline__ void copy_unit(float* dst, const float* row,
                                          const float* any, bool row_ok,
                                          int c, int W, bool vec) {
  if (vec) {
    const bool in = row_ok && c < W;
    cp_async16(dst, in ? row + c : any, in);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = row_ok && c + i < W;
      cp_async4(dst + i, in ? row + c + i : any, in);
    }
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// body(tile, stage) over tiles [t0, t1) by every thread of the block,
// whose copies load(tile, stage) issues S - 1 tiles ahead (S = 1: each
// tile is copied, then used). Leaves the stage buffers free.
template <int S, class Load, class Body>
__device__ __forceinline__ void pipeline(int t0, int t1, Load&& load,
                                         Body&& body) {
  if constexpr (S == 1) {
    for (int tt = t0; tt < t1; ++tt) {
      load(tt, 0);
      commit();
      wait_pending<0>();
      __syncthreads();
      body(tt, 0);
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (t0 + i < t1) load(t0 + i, i);
      commit();
    }
    for (int tt = t0; tt < t1; ++tt) {
      wait_pending<S - 2>();   // tile tt has landed
      __syncthreads();         // for every thread; stage tt - 1 is free
      const int s = (tt - t0) % S;
      if (tt + S - 1 < t1) load(tt + S - 1, (s + S - 1) % S);
      commit();
      body(tt, s);
    }
    __syncthreads();
  }
}

// Start copying key tile [j0, j0 + KT) of heads hb + r, r < hr, below h_end
// into slots[r]: x rows (zero past l and P), then dA and dt (zero past l).
template <class G>
__device__ __forceinline__ void load_x(const Args<float>& a, float* slots,
                                       int bc, int hb, int hr, int h_end,
                                       int j0) {
  constexpr int U = 4;
  constexpr int CPR = G::kPT / U;   // 16-byte units of a row
  for (int e = threadIdx.x; e < (SSD_SKIP & 16 ? 0 : hr * G::kKT * CPR);
       e += G::kThreads) {
    const int r = e / (G::kKT * CPR), rem = e % (G::kKT * CPR);
    const int j = rem / CPR, c = U * (rem % CPR), h = hb + r;
    if (h >= h_end) continue;
    const float* row = a.x + (size_t)bc * a.x_sbc + (size_t)h * a.x_sh +
                       (size_t)(j0 + j) * a.x_sl;
    copy_unit(slots + r * G::kSlot + j * G::kSX + c, row, a.x, j0 + j < a.l,
              c, a.P, a.vec_x);
  }
  for (int e = threadIdx.x; e < (SSD_SKIP & 32 ? 0 : hr * G::kKT);
       e += G::kThreads) {
    const int r = e / G::kKT, j = e % G::kKT, h = hb + r;
    if (h >= h_end) continue;
    const bool in = j0 + j < a.l;
    const size_t off = (size_t)bc * a.d_sbc + (size_t)h * a.d_sh +
                       (size_t)(j0 + j) * a.d_sl;
    float* d = slots + r * G::kSlot + G::kKT * G::kSX;
    cp_async4(d + j, in ? a.da + off : a.da, in);
    cp_async4(d + G::kKT + j, in ? a.dt + off : a.dt, in);
  }
}

// Rows [j0, j0 + rows) of a (l, W) matrix at row stride sl, columns
// [c0, c0 + cols) (cols a multiple of 4), into dst at row stride ds; zero
// past l and W.
template <class G>
__device__ __forceinline__ void load_rows(float* dst, int ds,
                                          const float* src, int sl, int j0,
                                          int rows, int c0, int cols, int l,
                                          int W, bool vec) {
  constexpr int U = 4;
  const int cpr = cols / U;
  for (int e = threadIdx.x; e < rows * cpr; e += G::kThreads) {
    const int j = e / cpr, c = U * (e % cpr);
    copy_unit(dst + j * ds + c, src + (size_t)(j0 + j) * sl, src,
              j0 + j < l, c0 + c, W, vec);
  }
}

// A warp's accumulator: a 16-row tile of m16n8 tiles over the head's
// columns.
template <class G>
using Acc = float[G::kNT / G::kNG][G::kNG][4];

// acc += A x over every n-tile of the head, A split: x's B fragments at
// k step ks (b0 (k = t, n = g), b1 (k = t + 4, n = g); xl: the slot's x
// rows at row t, column g), split in registers.
template <class G>
__device__ __forceinline__ void times_x(Acc<G>& acc, const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const float* xl, int ks) {
  if (SSD_SKIP & 4) return;
#pragma unroll
  for (int ng = 0; ng < G::kNT / G::kNG; ++ng) {
    uint32_t bh[G::kNG][2], bl[G::kNG][2];
#pragma unroll
    for (int i = 0; i < G::kNG; ++i) {
      const float* p = xl + 8 * ks * G::kSX + 8 * (G::kNG * ng + i);
      if (SSD_SKIP & 64) {
        bh[i][0] = __float_as_uint(p[0]);
        bh[i][1] = __float_as_uint(p[4 * G::kSX]);
        bl[i][0] = bl[i][1] = 0u;
        continue;
      }
      tf32x3::split(p[0], bh[i][0], bl[i][0]);
      tf32x3::split(p[4 * G::kSX], bh[i][1], bl[i][1]);
    }
    tf32x3::mma3(acc[ng], ah, al, bh, bl);
  }
}

template <class G>
__device__ __forceinline__ void zero(Acc<G>& acc) {
#pragma unroll
  for (int n = 0; n < G::kNT / G::kNG; ++n)
#pragma unroll
    for (int i = 0; i < G::kNG; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][i][q] = 0.f;
}

// Stores acc at rows row0 .. row0 + 15 (below rows) of a (rows, P)
// matrix at element strides (sr, sp): c0 (g, 2t), c1 (g, 2t + 1), c2
// (g + 8, 2t), c3 (g + 8, 2t + 1); 8 lanes g write 32 contiguous bytes
// where sr = 1, 4 lanes t where sp = 1.
template <class G>
__device__ __forceinline__ void store(const Acc<G>& acc, float* dst,
                                      int row0, int rows, int P, size_t sr,
                                      size_t sp, int g, int t) {
#pragma unroll
  for (int n = 0; n < G::kNT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row0 + g + 8 * (q >> 1), p = 8 * n + 2 * t + (q & 1);
      if (r < rows && p < P && (!(SSD_SKIP & 256) || rows < 0))
        dst[(size_t)r * sr + (size_t)p * sp] = acc[n / G::kNG][n % G::kNG][q];
    }
}

// The scores of slab rows (cs: 16 C rows at stride sc) against the 8 keys
// of bt (B rows at stride sc) over Np (N padded to 8), as one m16n8 tile:
// k step kk is summed into accumulator kk % 4, and the four are added in
// order at the end (four chains of dependent mma.sync, not one).
__device__ __forceinline__ void scores8(const float* cs, const float* bt,
                                        int sc, int Np, int g, int t,
                                        float (&s)[4]) {
  float sp[4][1][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) sp[e][0][i] = 0.f;
  const int nk = Np / 8;
  for (int k0 = 0; k0 < nk; k0 += 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k0 + e >= nk) break;
      const float* c = cs + g * sc + 8 * (k0 + e) + t;
      const float* b = bt + g * sc + 8 * (k0 + e) + t;
      uint32_t ah[4], al[4], bh[1][2], bl[1][2];
      tf32x3::split(c[0], ah[0], al[0]);
      tf32x3::split(c[8 * sc], ah[1], al[1]);
      tf32x3::split(c[4], ah[2], al[2]);
      tf32x3::split(c[8 * sc + 4], ah[3], al[3]);
      tf32x3::split(b[0], bh[0][0], bl[0][0]);
      tf32x3::split(b[4], bh[0][1], bl[0][1]);
      tf32x3::mma3(sp[e], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s[i] = ((sp[0][0][i] + sp[1][0][i]) + sp[2][0][i]) + sp[3][0][i];
}

// The y role: rows [r0, r0 + RT) of heads [h0, h_end).
template <int RT, int PT>
__device__ __forceinline__ void y_role(const Args<float>& a, float* smem,
                                       int bc, int h0, int h_end, int r0) {
  using G = Geo<RT, PT>;
  const int l = a.l, SC = G::sc(a.N), Np = pad8(a.N);
  float* strip = smem;                 // RT x kSS: scores
  float* region = strip + RT * G::kSS;   // C rows and B tiles, or x slots
  float* cs = region;                  // RT x SC: C rows of the tile
  float* bts = cs + RT * SC;           // kStages x kKT x SC: B tiles
  float* xslots = G::kEarly ? bts + G::kStages * G::kKT * SC : region;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kend = min(r0 + RT, l);
  const float* Bb = a.B + (size_t)bc * a.b_sbc;
  if (G::kEarly)   // committed with the strip's copies
    load_x<G>(a, xslots, bc, h0, G::kHRy, h_end, 0);

  // the strip of keys [p0, min(p0 + kKS, kend)), from the tile's C rows
  // and key tiles of B in the region; unit u of a tile: slab u % kSlabs,
  // keys 8 (u / kSlabs)
  auto make_strip = [&](int p0) {
    if (SSD_SKIP & 8) return;
    load_rows<G>(cs, SC, a.C + (size_t)bc * a.b_sbc, a.b_sl, r0, RT, 0, Np,
                 l, a.N, a.vec_b);   // committed with the first B tile
    pipeline<G::kStages>(
        p0 / G::kKT, (min(p0 + G::kKS, kend) + G::kKT - 1) / G::kKT,
        [&](int tt, int s) {
          load_rows<G>(bts + s * G::kKT * SC, SC, Bb, a.b_sl, tt * G::kKT,
                       G::kKT, 0, Np, l, a.N, a.vec_b);
        },
        [&](int tt, int s) {
          for (int u = warp; u < G::kSlabs * (G::kKT / 8);
               u += G::kWarps) {
            const int sl = u % G::kSlabs, jt = 8 * (u / G::kSlabs);
            const int i0 = r0 + 16 * sl, j = tt * G::kKT + jt;
            if (i0 >= l || j > min(i0 + 15, l - 1)) continue;  // above
            float sv[4];
            scores8(cs + 16 * sl * SC, bts + (s * G::kKT + jt) * SC, SC,
                    Np, g, t, sv);
            float* o = strip + (16 * sl + g) * G::kSS + (j - p0) + 2 * t;
            o[0] = sv[0];
            o[1] = sv[1];
            o[8 * G::kSS] = sv[2];
            o[8 * G::kSS + 1] = sv[3];
          }
        });
  };

  // this warp: slab sl of head hb + hr of each round
  const int sl = warp % G::kSlabs, hr = warp / G::kSlabs;
  const int i0 = r0 + 16 * sl;                // the slab's first row
  const int last = min(i0 + 16, l) - 1;       // and its last
  const int panels = (kend + G::kKS - 1) / G::kKS;
  int cached = -1;
  for (int hb = h0; hb < h_end; hb += G::kHRy) {
    const int h = hb + hr;
    const bool active = h < h_end && i0 < l;
    const float* dab = a.da + (size_t)bc * a.d_sbc + (size_t)h * a.d_sh;
    float dai[2];   // dA of rows i0 + g, i0 + g + 8
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = i0 + g + 8 * e;
      dai[e] = active && i < l ? dab[(size_t)i * a.d_sl] : 0.f;
    }
    Acc<G> acc;
    zero<G>(acc);

    for (int pn = 0; pn < panels; ++pn) {
      const int p0 = pn * G::kKS;
      if (pn != cached) {
        make_strip(p0);
        cached = pn;
      }
      pipeline<G::kStages>(
          p0 / G::kKT, (min(p0 + G::kKS, kend) + G::kKT - 1) / G::kKT,
          [&](int tt, int s) {
            if (!G::kEarly || hb != h0)
              load_x<G>(a, xslots + s * G::kHRy * G::kSlot, bc, hb,
                        G::kHRy, h_end, tt * G::kKT);
          },
          [&](int tt, int s) {
            // tiles wholly above the warp's rows add nothing; in the
            // others the steps past a row's diagonal add exact zeros
            if (!active || tt * G::kKT > last) return;
            const float* xs = xslots + (s * G::kHRy + hr) * G::kSlot;
            const float* daj = xs + G::kKT * G::kSX;
            const float* dtj = daj + G::kKT;
            const float* st = strip + (16 * sl + g) * G::kSS +
                              (tt * G::kKT - p0) + t;
#pragma unroll
            for (int ks = 0; ks < G::kKT / 8; ++ks) {
              // G at a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
              // t + 4), by select: above the diagonal (or past l) the
              // exponent is taken at 0 and the product dropped
              const float dj[2] = {daj[8 * ks + t], daj[8 * ks + t + 4]};
              const float tj[2] = {dtj[8 * ks + t], dtj[8 * ks + t + 4]};
              uint32_t ah[4], al[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int e = q & 1, c = q >> 1, i = i0 + g + 8 * e;
                const bool in =
                    tt * G::kKT + 8 * ks + t + 4 * c <= i && i < l;
                const float sv = st[8 * e * G::kSS + 8 * ks + 4 * c];
                const float ex = fast_exp(in ? dai[e] - dj[c] : 0.f);
                tf32x3::split(SSD_SKIP & 128 ? sv : in ? sv * ex * tj[c]
                                                       : 0.f,
                              ah[q], al[q]);
              }
              times_x<G>(acc, ah, al, xs + t * G::kSX + g, ks);
            }
          });
    }
    if (active)
      store<G>(acc, a.y + (size_t)bc * a.y_sbc + (size_t)h * a.y_sh, i0, l,
               a.P, a.y_sl, 1, g, t);
  }
}

// The state role: state rows [n0, n0 + kNTS) of heads [h0, h_end).
template <int RT, int PT>
__device__ __forceinline__ void state_role(const Args<float>& a, float* smem,
                                           int bc, int h0, int h_end,
                                           int n0) {
  using G = Geo<RT, PT>;
  const int l = a.l;
  float* bts = smem;                                // kStages B tiles
  float* slots = bts + G::kStages * G::kKT * G::kSBN;  // kStages x kHRs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warp: m-tile mt of head hb + hr of each round
  const int mt = warp % G::kMT, hr = warp / G::kMT;
  const int m0 = n0 + 16 * mt;                // the m-tile's first row
  const float* Bb = a.B + (size_t)bc * a.b_sbc;

  // the rounds of heads and their key tiles as one stream of copies, so
  // that a round's first tile is in flight while the last one is used
  const int tiles = (l + G::kKT - 1) / G::kKT;
  const int rounds = (h_end - h0 + G::kHRs - 1) / G::kHRs;
  Acc<G> acc;
  float da_last = 0.f;
  bool active = false;
  int h = 0;
  pipeline<G::kStages>(
      0, rounds * tiles,
      [&](int it, int s) {
        const int tt = it % tiles;
        load_rows<G>(bts + s * G::kKT * G::kSBN, G::kSBN, Bb, a.b_sl,
                     tt * G::kKT, G::kKT, n0, G::kNTS, l, a.N, a.vec_b);
        load_x<G>(a, slots + s * G::kHRs * G::kSlot, bc,
                  h0 + it / tiles * G::kHRs, G::kHRs, h_end, tt * G::kKT);
      },
      [&](int it, int s) {
        const int tt = it % tiles;
        if (tt == 0) {   // a round starts: this warp's head
          h = h0 + it / tiles * G::kHRs + hr;
          active = h < h_end && m0 < a.N;
          da_last = active ? a.da[(size_t)bc * a.d_sbc + (size_t)h * a.d_sh +
                                  (size_t)(l - 1) * a.d_sl] : 0.f;
          zero<G>(acc);
        }
        if (!active) return;
        const float* bt = bts + s * G::kKT * G::kSBN + t * G::kSBN +
                          16 * mt + g;
        const float* xs = slots + (s * G::kHRs + hr) * G::kSlot;
        const float* daj = xs + G::kKT * G::kSX;
        const float* dtj = daj + G::kKT;
        // every step of the tile: past l, B is 0 and w is 0
#pragma unroll
        for (int ks = 0; ks < G::kKT / 8; ++ks) {
          float w[2];   // w_j at j = 8 ks + t, + 4 of the tile
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int jj = 8 * ks + t + 4 * c;
            const bool in = tt * G::kKT + jj < l;
            w[c] = in ? fast_exp(in ? da_last - daj[jj] : 0.f) * dtj[jj]
                      : 0.f;
          }
          // A = (B o w)^T: a0 (n = g, j = t), a1 (g + 8, t), a2 (g,
          // t + 4), a3 (g + 8, t + 4)
          uint32_t ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = q >> 1;
            const float b = bt[(8 * ks + 4 * c) * G::kSBN + 8 * (q & 1)];
            tf32x3::split(SSD_SKIP & 128 ? b : b * w[c], ah[q], al[q]);
          }
          times_x<G>(acc, ah, al, xs + t * G::kSX + g, ks);
        }
        if (tt == tiles - 1)   // the round's last tile: the state is whole
          store<G>(acc, a.st + (size_t)bc * a.s_sbc + (size_t)h * a.s_sh,
                   m0, a.N, a.P, a.s_sn, a.s_sp, g, t);
      });
}

template <int RT, int PT>
__global__ void __launch_bounds__(Geo<RT, PT>::kThreads, 1)
ssd_kernel(Args<float> a) {
  extern __shared__ __align__(16) float smem[];
  const int bc = blockIdx.x, h0 = blockIdx.y * a.HG;
  const int h_end = min(h0 + a.HG, a.H);
  const int role = blockIdx.z;
  if (role < a.state_tiles) {
    if (!(SSD_SKIP & 2))
      state_role<RT, PT>(a, smem, bc, h0, h_end,
                         role * Geo<RT, PT>::kNTS);
  } else if (!(SSD_SKIP & 1)) {
    y_role<RT, PT>(a, smem, bc, h0, h_end, (gridDim.z - 1 - role) * RT);
  }
}

// ------------------------------------------------------------------ bf16
namespace bf16_ssd {

using elem::bf16;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// The geometry of the instance with row tiles of RT rows and head width PT
// (P padded to 16, 32, 64 or 128). Tiles of bf16 rows are padded by 8
// values (16 bytes): a row then starts an odd number of 16-byte units
// after the one before, so the 8 rows of an ldmatrix matrix, and the 8
// chunks a quarter-warp copies, fall in 8 distinct 16-byte bank groups.
template <int RT, int PT>
struct Geo {
  // warps of a block: SSD_WARPS with 64-row tiles at P <= 64, else 8; the
  // blocks an SM that ptxas budgets registers for: two at l <= 16 and
  // P <= 64, else one
  static constexpr int kWarps = RT == 64 && PT <= 64 ? SSD_WARPS : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = RT == 16 && PT <= 64 ? 2 : 1;
  static constexpr int kSlabs = RT / 16;      // 16-row slabs of a row tile
  static constexpr int kPT = PT;
  static constexpr int kKT = RT == 16 ? 16 : 64;   // positions of a key tile
  static constexpr int kStages = RT == 16 ? 1 : SSD_STAGES;
  static constexpr int kKS = RT == 16 ? 16 : SSD_STRIP_KEYS;  // strip keys
  static constexpr int kHRy = kWarps / kSlabs;  // heads of a y round
  static constexpr int kNTS = RT == 16 ? SSD_NT_SMALL : SSD_NT_LARGE;
  static constexpr int kMT = kNTS / 16;       // m-tiles of a state role
  // heads of a state round, at most (x slots are kept for as many)
  static constexpr int kHRs = RT == 16 ? kWarps : kWarps / kMT;
  static constexpr int kSX = PT + 8;           // x rows (bf16)
  static constexpr int kSBN = kNTS + 8;        // B rows of a state role
  // strip rows (fp32): keys + 8, so that the float2 reads of G's
  // fragment by a half-warp hit 32 distinct banks
  static constexpr int kSS = kKS + 8;
  // one head's key tile, in bytes: x rows (bf16), then dA and dt (fp32)
  static constexpr int kSlot = 2 * kKT * kSX + 8 * kKT;
  static_assert(kKT % 16 == 0 && kKS % kKT == 0, "whole k16 steps");
  static_assert(kStages > 1 || kKS == kKT, "one stage holds one tile");
  static_assert(kWarps % kSlabs == 0 && kWarps % kMT == 0,
                "warps take whole heads");

  // m-tiles a state role's warps take: kMT, but one where N <= 16 at
  // l <= 16, so that no warp idles past N (the warps take twice the
  // heads instead)
  static __host__ __device__ int mtiles(int N) {
    return RT == 16 && N <= 16 ? 1 : kMT;
  }
  // heads a block takes: at l <= 16 one round of the state role's (a
  // short launch's time is one block's, and a second round would double
  // it), 16 above
  static __host__ int heads(int N) {
    return RT == 16 ? kWarps / mtiles(N) : 16;
  }

  // C and B rows of a y role: N padded to 16, + 8
  static __host__ __device__ int sc(int N) { return pad16(N) + 8; }
  // At l <= 16 the x slots lie apart from the C rows and the B tile, and
  // a y role copies its first round of x with them, as at fp32.
  static constexpr bool kEarly = RT == 16;
  // a y role: the strip, then the C rows and kStages B tiles, and the x
  // slots over them (or beside them)
  static __host__ __device__ size_t y_bytes(int N) {
    const size_t strip = (size_t)4 * RT * kSS;
    const size_t cb = (size_t)2 * (RT + kStages * kKT) * sc(N);
    const size_t x = (size_t)kStages * kHRy * kSlot;
    return strip + (kEarly ? cb + x : cb > x ? cb : x);
  }
  static constexpr size_t state_bytes() {
    return (size_t)kStages * (2 * kKT * kSBN + kHRs * kSlot);
  }
  // a block's shared memory in bytes
  static __host__ __device__ size_t smem(int N) {
    const size_t ys = y_bytes(N), ss = state_bytes();
    return ys > ss ? ys : ss;
  }
};

// Four or two 8x8 bf16 matrices from shared memory by ldmatrix
// (mma_bf16.cuh's x4 and x4.trans; x2: lanes 0-15 give the addresses).
using bf16mma::ldsm_x4;
using bf16mma::ldsm_x4_trans;
using bf16mma::smem_addr;
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// The two bf16 values of a fragment register, widened (exactly).
__device__ __forceinline__ float lo16(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi16(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// (v0, v1) as two bf16 parts, each packed as a fragment register: hi =
// bf16(v) and mid = bf16(v - hi), both to nearest even. v - hi is exact in
// fp32, and v - hi - mid is at most 2^-16 |v|: each part times a bf16
// value is exact, and two products keep the tolerance that three TF32
// products kept (tests/test_torch_ssd_bf16_mma.py).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid) {
  hi = bf16mma::pack(v0, v1);
  mid = bf16mma::pack(v0 - lo16(hi), v1 - hi16(hi));
}

// 8 bf16 values at column c of a row (row_ok: the row exists) of width W
// into dst, zero past W or when !row_ok. vec: one 16-byte cp.async (W,
// the strides and the base are multiples of 8, so the unit lies wholly
// inside or past W); else 2-byte loads and stores, a path that is rare.
// `any` is a valid address for the copies that read nothing.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* row,
                                      const bf16* any, bool row_ok, int c,
                                      int W, bool vec) {
  if (vec) {
    const bool in = row_ok && c < W;
    cp_async16(dst, in ? row + c : any, in);
  } else {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      d[i] = row_ok && c + i < W ? p[c + i] : (unsigned short)0;
  }
}

// Start copying key tile [j0, j0 + KT) of heads hb + r, r < hr, below h_end
// into slots[r]: x rows (zero past l and P), then dA and dt (zero past l).
template <class G>
__device__ __forceinline__ void load_x(const Args<bf16>& a,
                                       unsigned char* slots, int bc, int hb,
                                       int hr, int h_end, int j0) {
  constexpr int CPR = G::kPT / 8;   // 16-byte units of a row
  for (int e = threadIdx.x; e < (SSD_SKIP & 16 ? 0 : hr * G::kKT * CPR);
       e += G::kThreads) {
    const int r = e / (G::kKT * CPR), rem = e % (G::kKT * CPR);
    const int j = rem / CPR, c = 8 * (rem % CPR), h = hb + r;
    if (h >= h_end) continue;
    const bf16* row = a.x + (size_t)bc * a.x_sbc + (size_t)h * a.x_sh +
                      (size_t)(j0 + j) * a.x_sl;
    copy8(reinterpret_cast<bf16*>(slots + r * G::kSlot) + j * G::kSX + c,
          row, a.x, j0 + j < a.l, c, a.P, a.vec_x);
  }
  for (int e = threadIdx.x; e < (SSD_SKIP & 32 ? 0 : hr * G::kKT);
       e += G::kThreads) {
    const int r = e / G::kKT, j = e % G::kKT, h = hb + r;
    if (h >= h_end) continue;
    const bool in = j0 + j < a.l;
    const size_t off = (size_t)bc * a.d_sbc + (size_t)h * a.d_sh +
                       (size_t)(j0 + j) * a.d_sl;
    float* d = reinterpret_cast<float*>(slots + r * G::kSlot +
                                        2 * G::kKT * G::kSX);
    cp_async4(d + j, in ? a.da + off : a.da, in);
    cp_async4(d + G::kKT + j, in ? a.dt + off : a.dt, in);
  }
}

// Rows [j0, j0 + rows) of an (l, W) bf16 matrix at row stride sl, columns
// [c0, c0 + cols) (cols a multiple of 8), into dst at row stride ds; zero
// past l and W.
template <class G>
__device__ __forceinline__ void load_rows(bf16* dst, int ds, const bf16* src,
                                          int sl, int j0, int rows, int c0,
                                          int cols, int l, int W, bool vec) {
  const int cpr = cols / 8;
  for (int e = threadIdx.x; e < rows * cpr; e += G::kThreads) {
    const int j = e / cpr, c = 8 * (e % cpr);
    copy8(dst + j * ds + c, src + (size_t)(j0 + j) * sl, src, j0 + j < l,
          c0 + c, W, vec);
  }
}

// A warp's accumulator: a 16-row tile of m16n8 tiles over the head's
// columns.
template <int PT>
using Acc = float[PT / 8][4];

template <int PT>
__device__ __forceinline__ void zero(Acc<PT>& acc) {
#pragma unroll
  for (int n = 0; n < PT / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
}

// Stores acc at rows row0 .. row0 + 15 (below rows) of a (rows, P)
// matrix at element strides (sr, sp), as the fp32 design's store, but
// c0, c1 (and c2, c3) as one 8-byte store where they are neighbours in
// memory (sp = 1, the pair inside P and 8-byte aligned): 4 lanes t then
// write 32 contiguous bytes of a row, and each instruction whole sectors.
template <int PT>
__device__ __forceinline__ void store(const Acc<PT>& acc, float* dst,
                                      int row0, int rows, int P, size_t sr,
                                      size_t sp, int g, int t) {
#pragma unroll
  for (int n = 0; n < PT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row0 + g + 8 * e, p = 8 * n + 2 * t;
      if (r >= rows || p >= P || ((SSD_SKIP & 256) && rows >= 0)) continue;
      float* d = dst + (size_t)r * sr + (size_t)p * sp;
      if (sp == 1 && p + 1 < P && ((uintptr_t)d & 7) == 0) {
        *reinterpret_cast<float2*>(d) =
            make_float2(acc[n][2 * e], acc[n][2 * e + 1]);
      } else {
        d[0] = acc[n][2 * e];
        if (p + 1 < P) d[sp] = acc[n][2 * e + 1];
      }
    }
}

// acc += A x over every n-tile of the head, A in two bf16 parts (mid, hi):
// x's B fragments of k step ks from the slot's x rows by ldmatrix.trans
// (xa: this lane's row mr + 8 (mi & 1), columns 8 (mi >> 1)), two n-tiles
// an x4; each accumulator takes mid x, then hi x.
template <int PT, int SX>
__device__ __forceinline__ void times_x(Acc<PT>& acc, const uint32_t (&hi)[4],
                                        const uint32_t (&mid)[4], uint32_t xa,
                                        int ks) {
  if (SSD_SKIP & 4) return;
#pragma unroll
  for (int np = 0; np < PT / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_trans(b, xa + 2 * (16 * ks * SX + 16 * np));
    bf16mma::mma(acc[2 * np], mid, b[0], b[1]);
    bf16mma::mma(acc[2 * np + 1], mid, b[2], b[3]);
    bf16mma::mma(acc[2 * np], hi, b[0], b[1]);
    bf16mma::mma(acc[2 * np + 1], hi, b[2], b[3]);
  }
}

// The scores of a slab (cs: its 16 C rows at stride sc) against 8 keys (bt:
// their B rows at stride sc) over Np (N padded to 16), as one m16n8 tile:
// A by ldmatrix x4 from the C rows, B by x2 from the B rows (stored keys
// by n: n by k); k step kk (16 wide) is summed into accumulator kk % 4, and
// the four are added in order at the end. Each product is exact.
__device__ __forceinline__ void scores8(const bf16* cs, const bf16* bt,
                                        int sc, int Np, int lane,
                                        float (&s)[4]) {
  if (SSD_SKIP & 4) {
    s[0] = s[1] = s[2] = s[3] = 0.f;
    return;
  }
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t ca = smem_addr(cs + (mr + 8 * (mi & 1)) * sc + 8 * (mi >> 1));
  const uint32_t ba = smem_addr(bt + mr * sc + 8 * (mi & 1));
  float sp[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) sp[e][i] = 0.f;
  const int nk = Np / 16;
  for (int k0 = 0; k0 < nk; k0 += 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k0 + e >= nk) break;
      uint32_t af[4], bf[2];
      ldsm_x4(af, ca + 32 * (k0 + e));
      ldsm_x2(bf, ba + 32 * (k0 + e));
      bf16mma::mma(sp[e], af, bf[0], bf[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s[i] = ((sp[0][i] + sp[1][i]) + sp[2][i]) + sp[3][i];
}

// The y role: rows [r0, r0 + RT) of heads [h0, h_end).
template <int RT, int PT>
__device__ __forceinline__ void y_role(const Args<bf16>& a,
                                       unsigned char* smem, int bc, int h0,
                                       int h_end, int r0) {
  using G = Geo<RT, PT>;
  const int l = a.l, SC = G::sc(a.N), Np = pad16(a.N);
  float* strip = reinterpret_cast<float*>(smem);   // RT x kSS: scores
  bf16* cs = reinterpret_cast<bf16*>(strip + RT * G::kSS);  // RT x SC
  bf16* bts = cs + RT * SC;               // kStages x kKT x SC: B tiles
  unsigned char* xslots = G::kEarly
      ? reinterpret_cast<unsigned char*>(bts + G::kStages * G::kKT * SC)
      : reinterpret_cast<unsigned char*>(cs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int kend = min(r0 + RT, l);
  const bf16* Bb = a.B + (size_t)bc * a.b_sbc;
  auto load = [&](int hb, int tt, int s) {
    load_x<G>(a, xslots + s * G::kHRy * G::kSlot, bc, hb, G::kHRy, h_end,
              tt * G::kKT);
  };
  if (G::kEarly) load(h0, 0, 0);   // committed with the strip's copies

  // the strip of keys [p0, min(p0 + kKS, kend)), from the tile's C rows
  // and key tiles of B; unit u of a tile: slab u % kSlabs, keys 8 (u /
  // kSlabs)
  auto make_strip = [&](int p0) {
    if (SSD_SKIP & 8) return;
    load_rows<G>(cs, SC, a.C + (size_t)bc * a.b_sbc, a.b_sl, r0, RT, 0, Np,
                 l, a.N, a.vec_b);   // committed with the first B tile
    pipeline<G::kStages>(
        p0 / G::kKT, (min(p0 + G::kKS, kend) + G::kKT - 1) / G::kKT,
        [&](int tt, int s) {
          load_rows<G>(bts + s * G::kKT * SC, SC, Bb, a.b_sl, tt * G::kKT,
                       G::kKT, 0, Np, l, a.N, a.vec_b);
        },
        [&](int tt, int s) {
          for (int u = warp; u < G::kSlabs * (G::kKT / 8);
               u += G::kWarps) {
            const int sl = u % G::kSlabs, jt = 8 * (u / G::kSlabs);
            const int i0 = r0 + 16 * sl, j = tt * G::kKT + jt;
            if (i0 >= l || j > min(i0 + 15, l - 1)) continue;  // above
            float sv[4];
            scores8(cs + 16 * sl * SC, bts + (s * G::kKT + jt) * SC, SC, Np,
                    lane, sv);
            float* o = strip + (16 * sl + g) * G::kSS + (j - p0) + 2 * t;
            *reinterpret_cast<float2*>(o) = make_float2(sv[0], sv[1]);
            *reinterpret_cast<float2*>(o + 8 * G::kSS) =
                make_float2(sv[2], sv[3]);
          }
        });
  };

  // this warp: slab sl of head hb + hr of each round
  const int sl = warp % G::kSlabs, hr = warp / G::kSlabs;
  const int i0 = r0 + 16 * sl;                // the slab's first row
  const int last = min(i0 + 16, l) - 1;       // and its last
  const int panels = (kend + G::kKS - 1) / G::kKS;
  int cached = -1;
  for (int hb = h0; hb < h_end; hb += G::kHRy) {
    const int h = hb + hr;
    const bool active = h < h_end && i0 < l;
    const float* dab = a.da + (size_t)bc * a.d_sbc + (size_t)h * a.d_sh;
    float dai[2];   // dA of rows i0 + g, i0 + g + 8
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = i0 + g + 8 * e;
      dai[e] = active && i < l ? dab[(size_t)i * a.d_sl] : 0.f;
    }
    Acc<PT> acc;
    zero<PT>(acc);

    for (int pn = 0; pn < panels; ++pn) {
      const int p0 = pn * G::kKS;
      if (pn != cached) {
        make_strip(p0);
        cached = pn;
      }
      pipeline<G::kStages>(
          p0 / G::kKT, (min(p0 + G::kKS, kend) + G::kKT - 1) / G::kKT,
          [&](int tt, int s) {
            if (!G::kEarly || hb != h0) load(hb, tt, s);
          },
          [&](int tt, int s) {
            // tiles wholly above the warp's rows, and k steps past its
            // last row, add nothing; in the others the keys past a row's
            // diagonal add exact zeros
            if (!active || tt * G::kKT > last) return;
            const unsigned char* slot =
                xslots + (s * G::kHRy + hr) * G::kSlot;
            const uint32_t xa =
                smem_addr(slot) +
                2 * ((mr + 8 * (mi & 1)) * G::kSX + 8 * (mi >> 1));
            const float* daj =
                reinterpret_cast<const float*>(slot + 2 * G::kKT * G::kSX);
            const float* dtj = daj + G::kKT;
            const float* st = strip + (16 * sl + g) * G::kSS +
                              (tt * G::kKT - p0) + 2 * t;
#pragma unroll
            for (int ks = 0; ks < G::kKT / 16; ++ks) {
              const int j0 = tt * G::kKT + 16 * ks;
              if (j0 > last) break;
              // G at a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
              // a3 (g + 8, 2t+8..), by select: above the diagonal (or past
              // l) the exponent is taken at 0 and the product dropped
              uint32_t hi[4], mid[4];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int jc = 16 * ks + 2 * t + 8 * c;
                const float2 dj = *reinterpret_cast<const float2*>(daj + jc);
                const float2 tj = *reinterpret_cast<const float2*>(dtj + jc);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int i = i0 + g + 8 * e, j = j0 + 2 * t + 8 * c;
                  const float2 sv = *reinterpret_cast<const float2*>(
                      st + 8 * e * G::kSS + 16 * ks + 8 * c);
                  const bool in0 = j <= i && i < l, in1 = j + 1 <= i && i < l;
                  float v0 = sv.x, v1 = sv.y;
                  if (!(SSD_SKIP & 128)) {
                    const float e0 = fast_exp(in0 ? dai[e] - dj.x : 0.f);
                    const float e1 = fast_exp(in1 ? dai[e] - dj.y : 0.f);
                    v0 = in0 ? sv.x * e0 * tj.x : 0.f;
                    v1 = in1 ? sv.y * e1 * tj.y : 0.f;
                  }
                  split2(v0, v1, hi[e + 2 * c], mid[e + 2 * c]);
                }
              }
              times_x<PT, G::kSX>(acc, hi, mid, xa, ks);
            }
          });
    }
    if (active)
      store<PT>(acc, a.y + (size_t)bc * a.y_sbc + (size_t)h * a.y_sh, i0, l,
                a.P, a.y_sl, 1, g, t);
  }
}

// The state role: state rows [n0, n0 + kNTS) of heads [h0, h_end).
template <int RT, int PT>
__device__ __forceinline__ void state_role(const Args<bf16>& a,
                                           unsigned char* smem, int bc,
                                           int h0, int h_end, int n0) {
  using G = Geo<RT, PT>;
  const int l = a.l;
  bf16* bts = reinterpret_cast<bf16*>(smem);    // kStages B tiles
  unsigned char* slots = smem + 2 * G::kStages * G::kKT * G::kSBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, mr = lane & 7;
  // this warp: m-tile mt of head hb + hr of each round of hrs heads
  const int mts = G::mtiles(a.N), hrs = G::kWarps / mts;
  const int mt = warp % mts, hr = warp / mts;
  const int m0 = n0 + 16 * mt;                // the m-tile's first row
  const bf16* Bb = a.B + (size_t)bc * a.b_sbc;
  // A = (B o w)^T from the B tile (keys by n) by ldmatrix.trans: a0 (n =
  // g, j = 2t..2t+1) from keys 0-7 x n 0-7, a1 (n = g + 8) from keys 0-7 x
  // n 8-15, a2, a3 from keys 8-15
  const int brow = (mr + 8 * (mi >> 1)) * G::kSBN + 16 * mt + 8 * (mi & 1);

  // the rounds of heads and their key tiles as one stream of copies, so
  // that a round's first tile is in flight while the last one is used
  const int tiles = (l + G::kKT - 1) / G::kKT;
  const int rounds = (h_end - h0 + hrs - 1) / hrs;
  Acc<PT> acc;
  float da_last = 0.f;
  bool active = false;
  int h = 0;
  pipeline<G::kStages>(
      0, rounds * tiles,
      [&](int it, int s) {
        const int tt = it % tiles;
        load_rows<G>(bts + s * G::kKT * G::kSBN, G::kSBN, Bb, a.b_sl,
                     tt * G::kKT, G::kKT, n0, G::kNTS, l, a.N, a.vec_b);
        load_x<G>(a, slots + s * G::kHRs * G::kSlot, bc,
                  h0 + it / tiles * hrs, hrs, h_end, tt * G::kKT);
      },
      [&](int it, int s) {
        const int tt = it % tiles;
        if (tt == 0) {   // a round starts: this warp's head
          h = h0 + it / tiles * hrs + hr;
          active = h < h_end && m0 < a.N;
          da_last = active ? a.da[(size_t)bc * a.d_sbc + (size_t)h * a.d_sh +
                                  (size_t)(l - 1) * a.d_sl] : 0.f;
          zero<PT>(acc);
        }
        if (!active) return;
        const uint32_t ba = smem_addr(bts + s * G::kKT * G::kSBN + brow);
        const unsigned char* slot = slots + (s * G::kHRs + hr) * G::kSlot;
        const uint32_t xa = smem_addr(slot) +
                            2 * ((mr + 8 * (mi & 1)) * G::kSX + 8 * (mi >> 1));
        const float* daj =
            reinterpret_cast<const float*>(slot + 2 * G::kKT * G::kSX);
        const float* dtj = daj + G::kKT;
        // every k step up to l: past l, B is 0 and w is 0
#pragma unroll
        for (int ks = 0; ks < G::kKT / 16; ++ks) {
          if (tt * G::kKT + 16 * ks >= l) break;
          float w[4];   // w_j at j = 16 ks + 2t, + 1, + 8, + 9 of the tile
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int jj = 16 * ks + 2 * t + (q & 1) + 8 * (q >> 1);
            const bool in = tt * G::kKT + jj < l;
            w[q] = in ? fast_exp(in ? da_last - daj[jj] : 0.f) * dtj[jj]
                      : 0.f;
          }
          uint32_t b[4], hi[4], mid[4];
          ldsm_x4_trans(b, ba + 2 * 16 * ks * G::kSBN);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = q >> 1;   // a0, a1: keys 2t..; a2, a3: 2t + 8..
            float v0 = lo16(b[q]), v1 = hi16(b[q]);
            if (!(SSD_SKIP & 128)) {
              v0 *= w[2 * c];
              v1 *= w[2 * c + 1];
            }
            split2(v0, v1, hi[q], mid[q]);
          }
          times_x<PT, G::kSX>(acc, hi, mid, xa, ks);
        }
        if (tt == tiles - 1)   // the round's last tile: the state is whole
          store<PT>(acc, a.st + (size_t)bc * a.s_sbc + (size_t)h * a.s_sh,
                    m0, a.N, a.P, a.s_sn, a.s_sp, g, t);
      });
}

template <int RT, int PT>
__global__ void __launch_bounds__(Geo<RT, PT>::kThreads,
                                  Geo<RT, PT>::kMinBlocks)
ssd_kernel(Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int bc = blockIdx.x, h0 = blockIdx.y * a.HG;
  const int h_end = min(h0 + a.HG, a.H);
  const int role = blockIdx.z;
  if (role < a.state_tiles) {
    if (!(SSD_SKIP & 2))
      state_role<RT, PT>(a, smem_b, bc, h0, h_end,
                         role * Geo<RT, PT>::kNTS);
  } else if (!(SSD_SKIP & 1)) {
    y_role<RT, PT>(a, smem_b, bc, h0, h_end, (gridDim.z - 1 - role) * RT);
  }
}

}  // namespace bf16_ssd

// Launches `kernel`, of geometry G and row tiles of RT rows, for a: G
// sets the heads a block takes and the state rows of a state role.
template <int RT, class G, class A>
int start(void (*kernel)(A), A a, int BC, cudaStream_t stream) {
  const size_t smem = G::smem(a.N);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t granted = 48 * 1024;   // the attribute is set once a size
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  const int hg = G::heads(a.N);
  a.HG = a.H < hg ? a.H : hg;
  a.state_tiles = (a.N + G::kNTS - 1) / G::kNTS;
  const dim3 grid(BC, (a.H + a.HG - 1) / a.HG,
                  a.state_tiles + (a.l + RT - 1) / RT);
  kernel<<<grid, G::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instance of x's type for row tiles of RT rows and P padded to PT.
template <int RT, int PT, typename T>
int launch(const Args<T>& a, int BC, cudaStream_t s) {
  if constexpr (elem::is_bf16<T>())
    return start<RT, bf16_ssd::Geo<RT, PT>>(bf16_ssd::ssd_kernel<RT, PT>, a,
                                            BC, s);
  else
    return start<RT, Geo<RT, PT>>(ssd_kernel<RT, PT>, a, BC, s);
}

template <int RT, typename T>
int launch_p(const Args<T>& a, int BC, cudaStream_t s) {
  if (a.P <= 16) return launch<RT, 16>(a, BC, s);
  if (a.P <= 32) return launch<RT, 32>(a, BC, s);
  if (a.P <= 64) return launch<RT, 64>(a, BC, s);
  return launch<RT, 128>(a, BC, s);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int run(const T* x, const float* dt, const float* da, const T* B,
        const T* C, float* y, float* st, int BC, int H, int l, int P, int N,
        int x_sbc, int x_sh, int x_sl, int d_sbc, int d_sh, int d_sl,
        int b_sbc, int b_sl, int y_sbc, int y_sh, int y_sl, int s_sbc,
        int s_sh, int s_sn, int s_sp, void* stream) {
  constexpr int U = 16 / (int)sizeof(T);   // elements of a 16-byte copy
  const int vec_x = (P % U == 0 && x_sbc % U == 0 && x_sh % U == 0 &&
                     x_sl % U == 0 && aligned16(x));
  const int vec_b = (N % U == 0 && b_sbc % U == 0 && b_sl % U == 0 &&
                     aligned16(B) && aligned16(C));
  // HG and state_tiles are set by the instance
  Args<T> a{x, dt, da, B, C, y, st, H, l, P, N, 0, 0,
            vec_x, vec_b, x_sbc, x_sh, x_sl, d_sbc, d_sh, d_sl, b_sbc, b_sl,
            y_sbc, y_sh, y_sl, s_sbc, s_sh, s_sn, s_sp};
  cudaStream_t s = (cudaStream_t)stream;
  return l <= 16 ? launch_p<16>(a, BC, s) : launch_p<64>(a, BC, s);
}

}  // namespace

// Shapes (BC, H, l, P, N) with 1 <= P <= 128, 1 <= N <= 256, l >= 1 and
// H <= 65535; strides as in the header comment. x, dt, dA, B, C are read,
// y and the state written, all fp32 on the device of `stream`. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int ssd_chunk_scan_f32(
    const float* x, const float* dt, const float* da, const float* B,
    const float* C, float* y, float* st, int BC, int H, int l, int P, int N,
    int x_sbc, int x_sh, int x_sl, int d_sbc, int d_sh, int d_sl, int b_sbc,
    int b_sl, int y_sbc, int y_sh, int y_sl, int s_sbc, int s_sh, int s_sn,
    int s_sp, void* stream) {
  return run(x, dt, da, B, C, y, st, BC, H, l, P, N, x_sbc, x_sh, x_sl,
             d_sbc, d_sh, d_sl, b_sbc, b_sl, y_sbc, y_sh, y_sl, s_sbc, s_sh,
             s_sn, s_sp, stream);
}

// The same with x, B and C in bf16; dt and dA fp32, y and the state
// written as fp32.
extern "C" int ssd_chunk_scan_bf16(
    const elem::bf16* x, const float* dt, const float* da,
    const elem::bf16* B, const elem::bf16* C, float* y, float* st, int BC,
    int H, int l, int P, int N, int x_sbc, int x_sh, int x_sl, int d_sbc,
    int d_sh, int d_sl, int b_sbc, int b_sl, int y_sbc, int y_sh, int y_sl,
    int s_sbc, int s_sh, int s_sn, int s_sp, void* stream) {
  return run(x, dt, da, B, C, y, st, BC, H, l, P, N, x_sbc, x_sh, x_sl,
             d_sbc, d_sh, d_sl, b_sbc, b_sl, y_sbc, y_sh, y_sl, s_sbc, s_sh,
             s_sn, s_sp, stream);
}
