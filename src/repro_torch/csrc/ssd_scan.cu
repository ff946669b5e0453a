// Mamba-2 SSD intra-chunk scan for Hopper (sm_90a), fp32 through 3xTF32 on
// the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:53 ::
// ssd_chunk_scan (body _ssd_kernel). For each (batch*chunk bc, head h) of
// a chunk of l positions:
//   y[i]  = sum_{j <= i} (C_i . B_j) * exp(dA_i - dA_j) * dt_j * x_j   (l, P)
//   state = sum_j exp(dA_last - dA_j) * dt_j * B_j (x) x_j              (N, P)
// B and C are shared by every head of a bc; everything is fp32.
//
// What bounds it: at the dense path's chunk (l = 256, N = 128, P = 64)
// operations: the scores (l*l*N/2 flops per bc, once for all heads), y (l*l*P
// per head under the causal mask) and the state (2*l*N*P per head) are
// about 30 flops per byte of a head's own inputs and outputs, above the
// fp32 ridge. The products run on the tensor cores as 3xTF32 mma.sync
// (mma_tf32x3.cuh), which keeps fp32 accuracy (one TF32 product misses the
// kernel's tolerance; tests/test_torch_ssd_tf32x3.py). At the pool's chunks
// (l <= 16) the work is bound by bytes: the (N, P) state of every head is
// 80% of them.
//
// Design: one launch on a grid of (BC, head groups, roles). A block works
// on one bc and a group of HG heads, in one of two roles (state roles
// first, then y row tiles, longest first):
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
// copies its first x with C and B). Every product is a 3xTF32 m16n8k8
// mma.sync; fragments are read from shared memory with strides that put
// the 32 lanes on 32 distinct banks and split into TF32 halves in
// registers. y and the state are stored from the accumulator fragments:
// lanes with the same t cover 32 contiguous bytes along the state's n in
// the model layout, so every sector of the state written there is whole.
// 16 warps a block at l > 16 and P <= 64 (one block an SM: the strip and
// two stages of x for 4 heads take 142 KB), 8 otherwise.
//
// Where the time goes (tools/ssd_variants.py, NVIDIA H100 at 700 W, the
// dense shape x (16, 24, 256, 64)): about 0.155 ms of device time, 3x the
// parent's speed but 4.5x the 3xTF32 products' time at mma.sync's
// measured rate. The loop, barriers, copies and stores alone take 0.05
// ms, the copies 0.03 more; splitting x costs 10%, the gates 6%; each
// warp's mma.sync issue waits on shared-memory loads and splits, which 16
// warps at 128 registers cannot prefetch. The knobs move it by 5% at most.
//
// Summation order, fixed by absolute position: a score sums its 8-wide
// k step kk over n into accumulator kk % 4, and the four are added in
// order at the end; y and the state each carry one accumulator over 8-key
// steps j in increasing order; each step adds lo x hi, hi x lo, hi x hi.
// No sum is split across warps or blocks and there are no atomics. Tiles
// wholly above a warp's rows are skipped, and a step past a row's
// diagonal or past l adds exact zeros. So neither HG, NT, BC, the row
// tile nor the key tile changes an output's bits: a bc gives the same y
// and state alone and packed, and a chunk padded with dt = 0 to any l
// bucket (l <= 16) the same y rows and state.
//
// Layouts, all through element strides: x (bc, h, j, p) at (x_sbc, x_sh,
// x_sl), unit stride on p; dt and dA (bc, h, j) at (d_sbc, d_sh, d_sl); B
// and C (bc, j, n) at (b_sbc, b_sl), unit stride on n; y (bc, h, i, p) at
// (y_sbc, y_sh, y_sl), unit stride on p; state (bc, h, n, p) at (s_sbc,
// s_sh, s_sn, s_sp). The TPU kernel's layout and the model's (b, nc, l, H,
// P) layout are both strides of these; rows are copied 16 bytes at a time
// where widths, strides and pointers allow it, 4 bytes otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"
#include "smem_copy.cuh"

// Knobs (tools/ssd_variants.py sets them with -D): heads a block takes at
// l <= 16 and above, state rows of a state role at l <= 16 and above, the
// keys of a y role's score strip, stages of copies, warps a block (at
// l > 16 and P <= 64), and positions of a key tile at l > 16.
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

struct Args {
  const float *x, *dt, *da, *B, *C;
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
};

// Four floats at column c of a row (row_ok: the row exists) of width W into
// dst, zero past W or when !row_ok. vec: one 16-byte copy (W, the strides
// and the base are multiples of 4 floats, so the chunk lies wholly inside
// or past W); else four of 4 bytes. `any` is a valid address for the
// copies that read nothing.
__device__ __forceinline__ void copy4(float* dst, const float* row,
                                      const float* any, bool row_ok, int c,
                                      int W, bool vec) {
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
__device__ __forceinline__ void load_x(const Args& a, float* slots, int bc,
                                       int hb, int hr, int h_end, int j0) {
  constexpr int CPR = G::kPT / 4;   // 16-byte chunks of a row
  for (int e = threadIdx.x; e < (SSD_SKIP & 16 ? 0 : hr * G::kKT * CPR);
       e += G::kThreads) {
    const int r = e / (G::kKT * CPR), rem = e % (G::kKT * CPR);
    const int j = rem / CPR, c = 4 * (rem % CPR), h = hb + r;
    if (h >= h_end) continue;
    const float* row = a.x + (size_t)bc * a.x_sbc + (size_t)h * a.x_sh +
                       (size_t)(j0 + j) * a.x_sl;
    copy4(slots + r * G::kSlot + j * G::kSX + c, row, a.x, j0 + j < a.l, c,
          a.P, a.vec_x);
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
  const int cpr = cols / 4;
  for (int e = threadIdx.x; e < rows * cpr; e += G::kThreads) {
    const int j = e / cpr, c = 4 * (e % cpr);
    copy4(dst + j * ds + c, src + (size_t)(j0 + j) * sl, src, j0 + j < l,
          c0 + c, W, vec);
  }
}

// A warp's accumulator: a 16-row tile of m16n8 tiles over the head's
// columns.
template <class G>
using Acc = float[G::kNT / G::kNG][G::kNG][4];

// acc += A x over every n-tile of the head, A split: x's B fragments at
// k step ks (b0 (k = t, n = g), b1 (k = t + 4, n = g); xl: the slot's x
// rows at row t, column g).
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
__device__ __forceinline__ void y_role(const Args& a, float* smem, int bc,
                                       int h0, int h_end, int r0) {
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
            scores8(cs + 16 * sl * SC, bts + (s * G::kKT + jt) * SC, SC, Np,
                    g, t, sv);
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
__device__ __forceinline__ void state_role(const Args& a, float* smem,
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
ssd_kernel(Args a) {
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

template <int RT, int PT>
int launch(const Args& a, int BC, cudaStream_t stream) {
  using G = Geo<RT, PT>;
  const size_t ys = G::y_floats(a.N), ss = G::state_floats();
  const size_t smem = (ys > ss ? ys : ss) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t granted = 48 * 1024;   // the attribute is set once a size
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<RT, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  const dim3 grid(BC, (a.H + a.HG - 1) / a.HG,
                  a.state_tiles + (a.l + RT - 1) / RT);
  ssd_kernel<RT, PT><<<grid, G::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int RT>
int launch_p(const Args& a, int BC, cudaStream_t s) {
  if (a.P <= 16) return launch<RT, 16>(a, BC, s);
  if (a.P <= 32) return launch<RT, 32>(a, BC, s);
  if (a.P <= 64) return launch<RT, 64>(a, BC, s);
  return launch<RT, 128>(a, BC, s);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

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
  const bool small = l <= 16;
  const int hg = small ? SSD_HEADS_SMALL : SSD_HEADS_LARGE;
  const int HG = H < hg ? H : hg;
  const int NT = small ? SSD_NT_SMALL : SSD_NT_LARGE;
  const int vec_x = (P % 4 == 0 && x_sbc % 4 == 0 && x_sh % 4 == 0 &&
                     x_sl % 4 == 0 && aligned16(x));
  const int vec_b = (N % 4 == 0 && b_sbc % 4 == 0 && b_sl % 4 == 0 &&
                     aligned16(B) && aligned16(C));
  Args a{x, dt, da, B, C, y, st, H, l, P, N, HG, (N + NT - 1) / NT,
         vec_x, vec_b, x_sbc, x_sh, x_sl, d_sbc, d_sh, d_sl, b_sbc, b_sl,
         y_sbc, y_sh, y_sl, s_sbc, s_sh, s_sn, s_sp};
  cudaStream_t s = (cudaStream_t)stream;
  return small ? launch_p<16>(a, BC, s) : launch_p<64>(a, BC, s);
}
