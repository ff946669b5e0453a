// Flash attention (prefill) for Hopper (sm_90a): fp32 through 3xTF32 on
// the tensor cores, bf16 through native bf16 products. Two designs, one
// for each dtype, behind the entries flash_attention_f32 and _bf16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:70
// (flash_attention_bhsd, body _fa_kernel): causal or windowed
// self-attention with an online softmax, irregular S masked by key position
// (k < S), no re-mask after the max and the l == 0 -> 0 guard.
//
// What bounds it: operations. Each (b, h) does about S * S * D * 2 flops of
// scores and as many of P V under a causal mask (4 * S * S * D without one)
// on S * D * 4 floats of input and output: at the main path's shapes (S =
// 512, D = 128) about 64 flops per byte. Over the fp32 CUDA-core peak that
// is 3.2x the time its bytes take; the tensor cores run TF32 at 7.4x that
// peak, and fp32 accuracy costs three TF32 products per fp32 product
// (mma_tf32x3.cuh), which still leaves the work 1.3x its bytes' time. So
// the scores and P V run as 3xTF32 mma.sync, which keeps the kernel within
// fp32 rounding of the plain version (one TF32 product differs by 1e-3).
// mma.sync reaches about 300 of those 495 TFLOP/s on an H100 SXM at 700 W
// (tools/mma_rate.py). What then costs most besides the products is
// splitting each operand into its TF32 halves and moving fragments from
// shared memory into registers, so the design spends its registers and
// shared memory on doing each split once.
//
// fp32 design: one block of 8 warps per (b, h, tile of kBQ = 128 query
// rows), launched as a (ceil(S / 128), H, B) grid with the tiles nearest
// the end of the sequence (the ones with most keys under a causal mask)
// first. The block loops over key tiles itself, in place of the TPU's
// sequential key grid axis with m/l/acc in VMEM scratch. Each warp owns 16
// query rows: its m, l and (16, D) accumulator stay in registers as m16n8
// C fragments, and a row's max and sum reduce over the 4 lanes that hold
// it.
// - K and V are split once per block, not once per warp: each key tile is
//   copied by cp.async into a raw buffer in shared memory while the tile
//   before it is used, then split into TF32 hi and lo planes in shared
//   memory by the whole block. The warps' inner loops load ready operands
//   and multiply. Eight warps share each split tile, twice as many as four
//   would. (Prefetching the tile into registers instead measured 5%
//   slower.)
// - K's planes are (key, d), read as B fragments of Q K^T by ldmatrix (one
//   x4 gives b0, b1 of hi and of lo for one n-tile). V's planes are stored
//   transposed, (d, key), so that P V's B fragments are one 8-byte load.
// - The query tile stays fp32 in shared memory, read by ldmatrix and split
//   in registers (split once into planes it measured slower with the tile
//   in registers, and does not fit beside the raw buffer at D = 128).
// - Q K^T sums even and odd k steps into two sets of accumulators, so that
//   8 chains of dependent mma.sync, not 4, hide the tensor cores' latency.
// - P never leaves registers: the score product's C fragment (lane holds
//   keys 2t, 2t + 1) is the A fragment of P V with its k index permuted
//   (k = t -> key 2t, k = t + 4 -> key 2t + 1), and V's B fragment is read
//   under the same permutation. P is split as the other operands are.
// - Row strides are padded so that every fragment load hits 32 distinct
//   banks: D (padded to 8) + 4 floats for Q and K, keys + 8 for V^T.
// - Shared memory at D = 128 is 176 KB, one block (8 warps) an SM; the
//   registers (about 180 a thread) would not hold two. At D = 256 the key
//   tile shrinks to 8 keys to fit the query tile, the raw buffer and the
//   planes in 199 KB.
// - A warp skips key tiles that lie wholly above its diagonal or wholly
//   before its rows' windows: every row sees its own key, so such a tile
//   would only add terms that a later exp(-1e30 - m) = 0 rescale wipes out
//   exactly, as the TPU body's would.
//
// bf16 design (flash_attention_bf16; the TPU kernel takes either dtype):
// q, k, v and out bf16, scores, softmax and the accumulator fp32. It is the
// TPU body at bf16: the scores summed in fp32 from bf16 products, P rounded
// to bf16 for P V (p.astype(v.dtype)) while l sums the unrounded P, the
// output rounded to bf16 once. Every operand of both products is then a
// bf16 value, so each product is one native bf16 mma.sync m16n8k16 with
// fp32 accumulation (mma_bf16.cuh), exact, at twice TF32's rate and depth.
// The bytes halve against fp32; the work is still operations-bound (about
// 128 flops per byte at the main path's shapes against the card's 295).
// - One block of 4 warps per (b, h, tile of query rows), in the same
//   longest-first grid order. Each warp owns 16 kMT rows as kMT m16 tiles,
//   with m, l and its (16 kMT, D) accumulator in registers as C fragments.
//   kMT = 2 (128 rows a block) at DT <= 128: each K and V fragment then
//   feeds two products, which halves the ldmatrix traffic per product (at
//   kMT = 1 the shared-memory reads alone would take as long as the
//   products at the tensor cores' peak). kMT = 1 at DT = 256 (one
//   accumulator is 128 registers) and on the 2-byte load path.
// - Tiles stay bf16 in shared memory and nothing is widened: Q (16 kMT
//   kWarps x DT) and a ring of kStages = 2 K/V stages (BK keys x DT each)
//   fed by 16-byte cp.async, so that the next tile is in flight while one
//   is multiplied, with one __syncthreads a tile. DT is the instance's
//   width (32, 64, 128 or 256, D zero-padded to it); BK is 64 keys, 32 at
//   DT = 256. Each row's 16-byte chunks are swizzled (chunk c of row r
//   stored at c ^ (r % 8), or c ^ ((r / 2) % 4) at DT = 32, where two rows
//   share 128 bytes), so that the 8 rows of an ldmatrix matrix and the 8
//   chunks of a quarter-warp's cp.async hit 8 distinct 16-byte bank
//   groups, with no padding. A lane's ldmatrix rows are all its own row
//   modulo 8, so its swizzle reduces to four chunk offsets held in
//   registers; every address is one of them plus an immediate.
// - Q's A fragments are read by ldmatrix once per block and kept in
//   registers across all key tiles where they take at most 32 registers
//   (DT kMT <= 128: D <= 64, or D = 128 at kMT = 1). Elsewhere (D = 128
//   at kMT = 2, D = 256) they are read from Q's tile at every key tile.
// - K's B fragments come from the (key, d) tile by ldmatrix (one x4 gives
//   two n-tiles of one k step), V's by ldmatrix.trans from the same
//   (key, d) layout: no transposed copy, no split pass.
// - P never leaves registers: the C fragments of score tiles 2j and
//   2j + 1, packed to bf16 pairs (cvt.rn.bf16x2.f32), are the A fragment
//   of P V's k step j (keys 16 j .. 16 j + 15).
// - exp(x - m) is 2^(x log2 e - m log2 e) on the special-function unit
//   (ex2.approx, about 2^-22 relative), one FFMA and one ex2 where expf
//   takes about eight instructions.
// - Shared memory: 96 KB at D = 128 (two blocks an SM; 80 KB on the 2-byte
//   path), 96 KB at D = 256, 48 KB at D = 64, 24 KB at D = 32. Registers,
//   not shared memory, bound the blocks an SM at D <= 128.
// - ptxas (CUDA 12.8): 255 registers at D = 128 (182 on the 2-byte path),
//   237 (130) at D = 64, 168 (85) at D = 32, 232 (218) at D = 256, no
//   spills. Measured by tools/flash_variants.py on an H100 SXM at 700 W
//   (device ms): kMT = 1 at D = 128 takes 5-17% longer at the 128-wide
//   causal shapes (and 209 registers); kMT = 2 on the 2-byte path or with
//   32-key tiles at D = 128, and 3 stages, spill or run slower; 32-key
//   tiles at D <= 128 and 16- or 64-key tiles at D = 256 run slower; a
//   cap of 168 registers (three blocks an SM) spills. Against the fp32
//   design's instance widened to bf16 that this replaces: 4.4x faster at
//   the main shape (8, 512, 40, 128), 6.1x at D = 256 with a 1024 window.
// - As at fp32: a warp skips tiles wholly above its diagonal or before its
//   window, and masks only tiles that cross S, the diagonal or a window
//   edge.
// - Rows whose D, strides or base are not 16-byte multiples (head_dim 20
//   on rows 21 values apart) take the same design with 2-byte loads and
//   shared stores in place of cp.async: slower, the same results.
//
// Layouts: q (B, S, H, D) and k, v (B, S, K, D) read through element
// strides (sb, ss, sh; unit stride on D), head h reading kv head h / (H/K);
// out (B, S, H, D) contiguous. Rows are read 16 bytes at a time when D,
// every stride and every base pointer allow it, 4 bytes (fp32) or 2 bytes
// (bf16) otherwise; D is zero-padded (to a multiple of 8 at fp32, to the
// instance's tile width at bf16; zero columns add 0 to Q K^T; the padded
// output columns are never stored). The kernel contract (BH, S, D) of the
// TPU kernel is the case B = BH, H = K = 1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "smem_copy.cuh"

namespace {

using tilecopy::cp_async16;
using tilecopy::cp_async4;
using tilecopy::ldsm_x4;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block, 16 per warp
constexpr int kNG = 4;             // m16n8 output tiles per P V group

// keys per tile: 32; 64 at D <= 32, so that every thread splits one whole
// 8-float run of V; 8 at D = 256, so that shared memory holds the tile
__host__ __device__ constexpr int key_tile(int DT) {
  return DT > 128 ? 8 : DT > 32 ? 32 : 64;
}

__host__ __device__ inline int padded(int D) { return (D + 7) & ~7; }
// Q and K rows: 4 x an odd number of floats, so the 8 rows of an ldmatrix
// start in 8 distinct 16-byte bank groups
__host__ __device__ inline int row_stride(int D) { return padded(D) + 4; }
// V^T rows: BK + 8 floats, so the 8-byte loads of rows g = 0..3 at keys
// 2t land on banks 8 g + 2 t, 32 distinct in each half-warp (at BK = 8,
// D = 256 only, two rows share a bank)
__host__ __device__ constexpr int vt_stride(int BK) { return BK + 8; }
// V^T rows held: padded(D) up to whole P V groups (the group's tiles past
// padded(D) are computed from stale rows and never stored)
__host__ __device__ inline int vt_rows(int D) {
  return (padded(D) + 8 * kNG - 1) / (8 * kNG) * (8 * kNG);
}

// Dynamic shared memory of one block, in floats: the fp32 query tile, the
// hi and lo planes of one K tile and of one V^T tile, and the raw K and V
// tiles being copied.
__host__ __device__ inline size_t smem_floats(int D, int BK) {
  return (size_t)(kBQ + 4 * BK) * row_stride(D) +
         (size_t)2 * vt_rows(D) * vt_stride(BK);
}

// Copy four floats of row `row` at column c of a (S, D) slab at row stride
// ss to dst, zero past S and past D. VEC: one 16-byte copy (D % 4 == 0, so
// the chunk lies wholly inside or past D, and every row start is 16-byte
// aligned); else four of 4 bytes.
template <bool VEC>
__device__ __forceinline__ void copy4(float* dst, const float* src, int row,
                                      int c, int S, int D, int ss) {
  const float* p = src + (size_t)row * ss + c;
  if constexpr (VEC) {
    const bool in = row < S && c < D;
    cp_async16(dst, in ? p : src, in);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = row < S && c + i < D;
      cp_async4(dst + i, in ? p + i : src, in);
    }
  }
}

__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  tf32x3::split(x.x, hi.x, lo.x);
  tf32x3::split(x.y, hi.y, lo.y);
  tf32x3::split(x.z, hi.z, lo.z);
  tf32x3::split(x.w, hi.w, lo.w);
}

// The copy of one key tile into the raw buffers and its split into the
// planes. Thread positions follow the widest D of the instance (DT), so
// every index is a shift of the thread's id; chunks past padded(D) are
// skipped. Both tiles are copied as 4-float chunks of rows (lanes along d);
// V is split as 8-float runs with lanes along keys, so that a warp's
// transposed stores hit 32 consecutive words.
template <int DT, bool VEC>
struct KVTile {
  static constexpr int BK = key_tile(DT);
  static constexpr int CPR = DT / 4;                // K chunks of a row
  static constexpr int NK = BK * CPR / kThreads;    // K chunks a thread
  static constexpr int NV = BK * DT / 8 / kThreads; // V runs a thread
  static_assert(kThreads % CPR == 0 && kThreads % BK == 0 &&
                NK * kThreads == BK * CPR && NV * kThreads * 8 == BK * DT,
                "every thread holds whole chunks and runs of the tile");

  // chunk i of this thread: row kr + i * kThreads / CPR, column kc
  static __device__ __forceinline__ int kr() { return threadIdx.x / CPR; }
  static __device__ __forceinline__ int kc() {
    return 4 * (threadIdx.x % CPR);
  }
  // V run i: row vr, columns vc + 8 i * kThreads / BK .. + 7
  static __device__ __forceinline__ int vr() { return threadIdx.x % BK; }
  static __device__ __forceinline__ int vc() { return 8 * (threadIdx.x / BK); }

  // start copying rows [k0, k0 + BK) of K and V into ks and vs
  static __device__ __forceinline__ void copy(float* ks, float* vs,
                                              const float* kb,
                                              const float* vb, int k0, int S,
                                              int D, int ss) {
    const int RS = row_stride(D);
    if (kc() < padded(D)) {
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int r = kr() + i * (kThreads / CPR);
        copy4<VEC>(ks + r * RS + kc(), kb, k0 + r, kc(), S, D, ss);
        copy4<VEC>(vs + r * RS + kc(), vb, k0 + r, kc(), S, D, ss);
      }
    }
    asm volatile("cp.async.commit_group;");
  }

  // split ks, vs (BK x RS each) into khi/klo (BK x RS each, adjacent) and
  // vthi/vtlo (vt_rows x BK + 8 each, adjacent)
  static __device__ __forceinline__ void split(const float* ks,
                                               const float* vs, float* kp,
                                               float* vp, int D) {
    const int Dp = padded(D), RS = row_stride(D);
    const int kplane = BK * RS, vplane = vt_rows(D) * vt_stride(BK);
    if (kc() < Dp) {
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int at = (kr() + i * (kThreads / CPR)) * RS + kc();
        uint4 hi, lo;
        split4(*reinterpret_cast<const float4*>(ks + at), hi, lo);
        *reinterpret_cast<uint4*>(kp + at) = hi;
        *reinterpret_cast<uint4*>(kp + at + kplane) = lo;
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = vc() + 8 * i * (kThreads / BK);
      if (c >= Dp) continue;
      const float4 a = *reinterpret_cast<const float4*>(vs + vr() * RS + c);
      const float4 b =
          *reinterpret_cast<const float4*>(vs + vr() * RS + c + 4);
      const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      float* dst = vp + c * vt_stride(BK) + vr();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t hi, lo;
        tf32x3::split(x[j], hi, lo);
        dst[j * vt_stride(BK)] = __uint_as_float(hi);
        dst[j * vt_stride(BK) + vplane] = __uint_as_float(lo);
      }
    }
  }
};

template <int DT, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int H, int K, int D, int causal, int window, int q_sb, int q_ss,
             int q_sh, int k_sb, int k_ss, int k_sh) {
  constexpr int kBK = key_tile(DT);
  constexpr int kKT = kBK / 8;    // m16n8 score tiles per key tile
  constexpr int kDT = DT / 8;     // k steps of Q K^T, n tiles of P V
  constexpr int kRV = vt_stride(kBK);
  static_assert(kDT % kNG == 0, "P V groups must tile DT");
  extern __shared__ __align__(16) float smem[];
  const int Dp = padded(D), RS = row_stride(D);
  float* qs = smem;                  // kBQ x RS, fp32
  float* kp = qs + kBQ * RS;         // hi then lo, kBK x RS each
  float* vp = kp + 2 * kBK * RS;     // hi then lo, vt_rows x kRV each
  const int vplane = vt_rows(D) * kRV;
  float* ks = vp + 2 * vplane;       // raw K tile being copied, kBK x RS
  float* vs = ks + kBK * RS;         // raw V tile being copied

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const float* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const float* kb = k + (size_t)b * k_sb + (size_t)kh * k_sh;
  const float* vb = v + (size_t)b * k_sb + (size_t)kh * k_sh;

  // key tiles this block can see: none past its last row's own key under
  // a causal mask, none wholly before its first row's window
  const int q_hi = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_hi + 1 : S;
  const int t_end = (k_end + kBK - 1) / kBK;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  using Tile = KVTile<DT, VEC>;
  if (Tile::kc() < Dp) {
#pragma unroll 4
    for (int r = Tile::kr(); r < kBQ; r += kThreads / Tile::CPR)
      copy4<VEC>(qs + r * RS + Tile::kc(), qb, q0 + r, Tile::kc(), S, D,
                 q_ss);
  }
  Tile::copy(ks, vs, kb, vb, t_begin * kBK, S, D, k_ss);   // commits both

  // this warp's rows [w0, w_last]; a warp wholly past S only copies and
  // splits
  const int w0 = q0 + 16 * warp;
  const int w_last = min(w0 + 15, S - 1);
  // ldmatrix row addresses of this lane: matrix i = lane / 8, row lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  // Q's A fragment: matrices (rows 0-7 | 8-15) x (cols 0-3 | 4-7)
  const float* qa = qs + (16 * warp + mr + 8 * (mi & 1)) * RS + 4 * (mi >> 1);
  // K's B fragments of one n-tile: (hi | lo) x (cols 0-3 | 4-7)
  const float* kf = kp + (mi >> 1) * kBK * RS + mr * RS + 4 * (mi & 1);
  // V^T's B fragment: row g (n), keys 2t, 2t + 1 (k = t, t + 4)
  const float* vf = vp + g * kRV + 2 * t;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kDT / kNG][kNG][4];   // output tile n is o[n / kNG][n % kNG]
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n / kNG][n % kNG][i] = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();   // the raw tile landed, and every warp is done with
                       // the planes (and Q is in)
    Tile::split(ks, vs, kp, vp, D);
    __syncthreads();   // the planes are ready, the raw buffers free
    if (tile + 1 < t_end)   // in flight while this tile is used
      Tile::copy(ks, vs, kb, vb, (tile + 1) * kBK, S, D, k_ss);
    const int k0 = tile * kBK;
    if (w0 >= S || (causal && k0 > w_last) ||
        (window > 0 && w0 - (k0 + kBK - 1) >= window))
      continue;   // no key of this tile is visible to this warp's rows

    // scores: s[j] is the m16n8 tile of keys k0 + 8 j .. k0 + 8 j + 7,
    // summed over even and odd k steps apart (sp[0], sp[1]), so that 8
    // chains of dependent mma.sync, not 4, hide the tensor cores' latency
    float s[kKT][4], sp[2][kKT][4];
#pragma unroll
    for (int j = 0; j < kKT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sp[0][j][i] = sp[1][j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk) {
      if (8 * kk >= Dp) break;
      uint32_t a[4], ah[4], al[4], bh[kKT][2], bl[kKT][2];
      ldsm_x4(a, qa + 8 * kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tf32x3::split(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        uint32_t x[4];
        ldsm_x4(x, kf + 8 * j * RS + 8 * kk);
        bh[j][0] = x[0];
        bh[j][1] = x[1];
        bl[j][0] = x[2];
        bl[j][1] = x[3];
      }
      tf32x3::mma3(sp[kk & 1], ah, al, bh, bl);
    }
#pragma unroll
    for (int j = 0; j < kKT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = sp[0][j][i] + sp[1][j][i];

    // mask only a tile that crosses S, the diagonal or a window's edge
    if (k0 + kBK > S || (causal && k0 + kBK - 1 > w0) ||
        (window > 0 && w_last - k0 >= window)) {
#pragma unroll
      for (int j = 0; j < kKT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = w0 + g + 8 * (i >> 1);
          const int kpos = k0 + 8 * j + 2 * t + (i & 1);
          bool ok = kpos < S;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) s[j][i] = kNegInf;
        }
    }

    // online softmax of rows g (r = 0: elements 0, 1) and g + 8 (r = 1:
    // elements 2, 3). As the TPU body: no re-mask after the max; a row
    // whose keys in this tile are all masked and whose m is still -1e30
    // adds garbage that the first tile with a visible key rescales by
    // exactly 0.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        s[j][2 * r] = expf(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
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

    // o += P V: k step j takes score tile j as its A fragment, k = t as
    // key 8 j + 2 t and k = t + 4 as key 8 j + 2 t + 1
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      uint32_t ah[4], al[4];
      tf32x3::split(s[j][0], ah[0], al[0]);
      tf32x3::split(s[j][2], ah[1], al[1]);
      tf32x3::split(s[j][1], ah[2], al[2]);
      tf32x3::split(s[j][3], ah[3], al[3]);
#pragma unroll
      for (int ng = 0; ng < kDT / kNG; ++ng) {
        if (8 * kNG * ng >= Dp) break;
        uint32_t bh[kNG][2], bl[kNG][2];
#pragma unroll
        for (int i = 0; i < kNG; ++i) {
          const float* p = vf + 8 * (kNG * ng + i) * kRV + 8 * j;
          const uint2 hi = *reinterpret_cast<const uint2*>(p);
          const uint2 lo = *reinterpret_cast<const uint2*>(p + vplane);
          bh[i][0] = hi.x;
          bh[i][1] = hi.y;
          bl[i][0] = lo.x;
          bl[i][1] = lo.y;
        }
        tf32x3::mma3(o[ng], ah, al, bh, bl);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    float* orow = out + (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < D) orow[c] = o[n / kNG][n % kNG][2 * r] * inv;
      if (c + 1 < D) orow[c + 1] = o[n / kNG][n % kNG][2 * r + 1] * inv;
    }
  }
}

template <int DT, bool VEC>
int launch_as(const float* q, const float* k, const float* v, float* out,
              int B, int S, int H, int K, int D, int causal, int window,
              int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
              cudaStream_t stream) {
  const size_t smem = smem_floats(D, key_tile(DT)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<DT, VEC><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, H, K, D, causal, window, q_sb, q_ss, q_sh, k_sb, k_ss,
      k_sh);
  return (int)cudaGetLastError();
}

template <int DT>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int S, int H, int K, int D, int causal, int window, int q_sb,
           int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, bool vec,
           cudaStream_t stream) {
  return vec ? launch_as<DT, true>(q, k, v, out, B, S, H, K, D, causal,
                                   window, q_sb, q_ss, q_sh, k_sb, k_ss,
                                   k_sh, stream)
             : launch_as<DT, false>(q, k, v, out, B, S, H, K, D, causal,
                                    window, q_sb, q_ss, q_sh, k_sb, k_ss,
                                    k_sh, stream);
}


// ------------------------------------------------------------------ bf16
namespace bf16_flash {

using elem::bf16;

// m16 tiles of query rows a warp owns at DT <= 64 and at DT = 128 (2:
// each K and V fragment feeds two products), K/V stages in flight (the
// ring) and keys per tile at DT <= 128 and at DT = 256; -D flags set them
// for tools/flash_variants.py
#ifndef FLASH_BF16_MT
#define FLASH_BF16_MT 2
#endif
#ifndef FLASH_BF16_MT_128
#define FLASH_BF16_MT_128 2
#endif
#ifndef FLASH_BF16_STAGES
#define FLASH_BF16_STAGES 2
#endif
#ifndef FLASH_BF16_KEYS
#define FLASH_BF16_KEYS 64
#endif
#ifndef FLASH_BF16_KEYS_256
#define FLASH_BF16_KEYS_256 32
#endif
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = FLASH_BF16_STAGES;
static_assert(kStages >= 2, "the ring needs two stages");

__host__ __device__ constexpr int key_tile(int DT) {
  return DT > 128 ? FLASH_BF16_KEYS_256 : FLASH_BF16_KEYS;
}
// m16 tiles of a warp: one at DT = 256, where one accumulator takes 128
// registers, and on the 2-byte load path (VEC false), whose few registers
// more would spill at two; else FLASH_BF16_MT(_128). Query rows of a
// block follow.
__host__ __device__ constexpr int m_tiles(int DT, bool VEC) {
  return DT > 128 || !VEC ? 1 : DT > 64 ? FLASH_BF16_MT_128 : FLASH_BF16_MT;
}
__host__ __device__ constexpr int block_rows(int DT, bool VEC) {
  return 16 * kWarps * m_tiles(DT, VEC);
}
// Q's A fragments held in registers for the whole block (at most 32 a
// thread)
__host__ __device__ constexpr bool q_in_regs(int DT, bool VEC) {
  return DT * m_tiles(DT, VEC) <= 128;
}
// Dynamic shared memory of one block, in bytes: the ring's K and V tiles
// and the query tile, all bf16 and DT wide.
__host__ __device__ constexpr size_t smem_bytes(int DT, bool VEC) {
  return sizeof(bf16) * (size_t)DT *
         (2 * kStages * key_tile(DT) + block_rows(DT, VEC));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx.ftz, about 2^-22 relative):
// exp(x) as exp2(x log2 e), two instructions where expf takes about eight
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

// Start copying rows [row0, row0 + ROWS) of a (S, D) slab at row stride ss
// into the swizzled tile dst (ROWS x DT), zero past S and past D, as
// 16-byte chunks with consecutive threads along a row. VEC: one cp.async
// a chunk (D a multiple of 8, so a chunk lies wholly inside or past D,
// and every row start 16-byte aligned); else 2-byte loads and stores.
// (The slab's rows lie within one batch's stride, an int, so row * ss is
// an int too.)
template <int DT, int ROWS, bool VEC>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int S, int D, int ss) {
  constexpr int CPR = DT / 8;   // chunks of a row
  static_assert(ROWS * CPR % kThreads == 0, "whole chunks a thread");
  const int c = threadIdx.x % CPR;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < ROWS * CPR / kThreads; ++i) {
      const int r = threadIdx.x / CPR + i * (kThreads / CPR), row = row0 + r;
      const bool in = row < S && 8 * c < D;
      cp_async16(dst + r * DT + 8 * (c ^ swizzle_key<DT>(r)),
                 in ? src + row * ss + 8 * c : src, in);
    }
  } else {   // one chunk at a time: few registers on a path that is rare
#pragma unroll 1
    for (int i = 0; i < ROWS * CPR / kThreads; ++i) {
      const int r = threadIdx.x / CPR + i * (kThreads / CPR), row = row0 + r;
      const unsigned short* p =
          reinterpret_cast<const unsigned short*>(src + row * ss + 8 * c);
      unsigned short* d = reinterpret_cast<unsigned short*>(
          dst + r * DT + 8 * (c ^ swizzle_key<DT>(r)));
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = row < S && 8 * c + e < D ? p[e] : (unsigned short)0;
    }
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int DT, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                  int H, int K, int D, int causal, int window, int q_sb,
                  int q_ss, int q_sh, int k_sb, int k_ss, int k_sh) {
  constexpr int BK = key_tile(DT);
  constexpr int KT = BK / 8;     // m16n8 score tiles of a key tile
  constexpr int KS = DT / 16;    // k steps of Q K^T
  constexpr int NT = DT / 8;     // m16n8 output tiles
  constexpr int kMT = m_tiles(DT, VEC);
  constexpr int kBQ = block_rows(DT, VEC);
  constexpr int WR = 16 * kMT;   // query rows of a warp
  constexpr bool QR = q_in_regs(DT, VEC);
  static_assert(BK % 16 == 0 && DT % 16 == 0, "whole m16n8k16 steps");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // kStages x (K, V), BK x DT each, then Q, kBQ x DT
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = ring + kStages * 2 * BK * DT;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const bf16* kb = k + (size_t)b * k_sb + (size_t)kh * k_sh;
  const bf16* vb = v + (size_t)b * k_sb + (size_t)kh * k_sh;

  // key tiles this block can see: none past its last row's own key under
  // a causal mask, none wholly before its first row's window
  const int q_hi = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_hi + 1 : S;
  const int t_end = (k_end + BK - 1) / BK;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  // tile j's K and V live in stage (j - t_begin) % kStages; fetch starts
  // copying tile j (if there is one) and commits a group either way, so
  // that group i always holds the i-th tile
  auto stage = [&](int j) {
    return ring + (j - t_begin) % kStages * 2 * BK * DT;
  };
  auto fetch = [&](int j) {
    if (j < t_end) {
      bf16* dst = stage(j);
      load_rows<DT, BK, VEC>(dst, kb, j * BK, S, D, k_ss);
      load_rows<DT, BK, VEC>(dst + BK * DT, vb, j * BK, S, D, k_ss);
    }
    asm volatile("cp.async.commit_group;");
  };
  load_rows<DT, kBQ, VEC>(qs, qb, q0, S, D, q_ss);   // in the first group
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(t_begin + i);

  // this warp's rows [w0, w_last], m-tile i of them from w0 + 16 i; a warp
  // wholly past S only copies
  const int w0 = q0 + WR * warp;
  const int w_last = min(w0 + WR - 1, S - 1);
  // ldmatrix addresses of this lane (shared-memory bytes): row mr of
  // matrix mi. Every row a lane names is mr modulo 8, so the swizzle's key
  // is the lane's own, and the chunk pairs 2 u + c0, u = 0..3, are all the
  // XORs it needs: chunk 2 kk + c0 lies at 8 (kk / 4) + col[kk % 4], so
  // that with kk unrolled each address is a register plus an immediate.
  const int mi = lane >> 3, mr = lane & 7;
  const int key = swizzle_key<DT>(mr);
  constexpr int RB = 2 * DT;   // bytes of a tile row
  auto cols = [&](uint32_t (&col)[4], int c0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) col[u] = 16 * ((2 * u + c0) ^ key);
  };
  auto at = [](const uint32_t (&col)[4], int kk) {
    return col[kk % 4] + 128 * (kk / 4);
  };
  // Q's A fragment of m-tile i: matrices (rows 0-7 | 8-15) x (columns 0-7
  // | 8-15) from row WR warp + 16 i; V's chunks are Q's (qcol)
  uint32_t qcol[4], kcol[4];
  cols(qcol, mi >> 1);
  const uint32_t qa = bf16mma::smem_addr(qs) + (WR * warp + mr +
                                                8 * (mi & 1)) * RB;
  // K's B fragments of two n-tiles: (keys 0-7 | 8-15) x (d 0-7 | 8-15)
  cols(kcol, mi & 1);
  const int krow = (mr + 8 * (mi >> 1)) * RB;
  // V's B fragments of two n-tiles, transposed: (keys 0-7 | 8-15) x
  // (d 0-7 | 8-15)
  const int vrow = (mr + 8 * (mi & 1)) * RB;

  uint32_t qf[QR ? kMT : 1][QR ? KS : 1][4];
  if constexpr (QR) {
    cp_async_wait<kStages - 2>();   // Q is in the first group
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        bf16mma::ldsm_x4(qf[i][kk], qa + 16 * i * RB + at(qcol, kk));
  }

  float m[kMT][2], l[kMT][2], o[kMT][NT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    m[i][0] = m[i][1] = kNegInf;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // this tile landed, and every warp is done with the
                       // stage that the next fetch overwrites
    fetch(tile + kStages - 1);
    const uint32_t ka = bf16mma::smem_addr(stage(tile)) + krow;
    const uint32_t va = bf16mma::smem_addr(stage(tile)) + BK * RB + vrow;
    const int k0 = tile * BK;
    if (w0 >= S || (causal && k0 > w_last) ||
        (window > 0 && w0 - (k0 + BK - 1) >= window))
      continue;   // no key of this tile is visible to this warp's rows

    // scores: s[i][j] is the m16n8 tile of m-tile i's rows and keys
    // k0 + 8 j .. k0 + 8 j + 7
    float s[kMT][KT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if constexpr (QR) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[i][e] = qf[i][kk][e];
        } else {
          bf16mma::ldsm_x4(a[i], qa + 16 * i * RB + at(qcol, kk));
        }
      }
#pragma unroll
      for (int jp = 0; jp < KT / 2; ++jp) {
        uint32_t x[4];
        bf16mma::ldsm_x4(x, ka + 16 * jp * RB + at(kcol, kk));
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          bf16mma::mma(s[i][2 * jp], a[i], x[0], x[1]);
          bf16mma::mma(s[i][2 * jp + 1], a[i], x[2], x[3]);
        }
      }
    }

    // mask only a tile that crosses S, the diagonal or a window's edge
    if (k0 + BK > S || (causal && k0 + BK - 1 > w0) ||
        (window > 0 && w_last - k0 >= window)) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = w0 + 16 * i + g + 8 * (e >> 1);
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            bool ok = kpos < S;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && qpos - kpos < window;
            if (!ok) s[i][j][e] = kNegInf;
          }
    }

    // online softmax of rows g (r = 0: elements 0, 1) and g + 8 (r = 1:
    // elements 2, 3) of each m-tile, as the fp32 design's: no re-mask
    // after the max
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < KT; ++j)
          mx = fmaxf(mx, fmaxf(s[i][j][2 * r], s[i][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i][r], mx);
        // exp(x - m) as 2^(x log2 e - m log2 e), one FFMA and one ex2. A
        // row that has seen no key yet (m_new = -1e30) takes m log2 e = 0,
        // so that its masked scores give 2^-1.4e30 = 0 (the TPU body's
        // exp(0) = 1 there is wiped by the exact 0 of a later alpha, so
        // the output is the same) and never 2^(rounding error of
        // -1e30 log2 e), which could be inf
        const float ms = m_new == kNegInf ? 0.f : m_new * kLog2e;
        const float alpha = exp2_approx(fmaf(m[i][r], kLog2e, -ms));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[i][j][e] = exp2_approx(fmaf(s[i][j][e], kLog2e, -ms));
            sum += s[i][j][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[i][r] = alpha * l[i][r] + sum;   // the unrounded P
        m[i][r] = m_new;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[i][n][2 * r] *= alpha;
          o[i][n][2 * r + 1] *= alpha;
        }
      }

    // o += P V: k step j takes score tiles 2 j, 2 j + 1 rounded to bf16
#pragma unroll
    for (int j = 0; j < KT / 2; ++j) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        a[i][0] = bf16mma::pack(s[i][2 * j][0], s[i][2 * j][1]);
        a[i][1] = bf16mma::pack(s[i][2 * j][2], s[i][2 * j][3]);
        a[i][2] = bf16mma::pack(s[i][2 * j + 1][0], s[i][2 * j + 1][1]);
        a[i][3] = bf16mma::pack(s[i][2 * j + 1][2], s[i][2 * j + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t x[4];
        bf16mma::ldsm_x4_trans(x, va + 16 * j * RB + at(qcol, np));
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          bf16mma::mma(o[i][2 * np], a[i], x[0], x[1]);
          bf16mma::mma(o[i][2 * np + 1], a[i], x[2], x[3]);
        }
      }
    }
  }

  // out rows of this lane, rounded to bf16 once: two neighbouring columns
  // as one 4-byte store where D is even (every pair then aligned)
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + 16 * i + g + 8 * r;
      if (row >= S) continue;
      const float inv = 1.f / (l[i][r] == 0.f ? 1.f : l[i][r]);
      bf16* orow = out + (((size_t)b * S + row) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = 8 * n + 2 * t;
        const float x0 = o[i][n][2 * r] * inv, x1 = o[i][n][2 * r + 1] * inv;
        if (D % 2 == 0) {
          if (c < D)
            *reinterpret_cast<uint32_t*>(orow + c) = bf16mma::pack(x0, x1);
        } else {
          if (c < D) orow[c] = __float2bfloat16_rn(x0);
          if (c + 1 < D) orow[c + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
}

template <int DT, bool VEC>
int launch_as(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
              int S, int H, int K, int D, int causal, int window, int q_sb,
              int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(DT, VEC);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_bf16<DT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int rows = block_rows(DT, VEC);
  const dim3 grid((S + rows - 1) / rows, H, B);
  flash_kernel_bf16<DT, VEC><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, H, K, D, causal, window, q_sb, q_ss, q_sh, k_sb, k_ss,
      k_sh);
  return (int)cudaGetLastError();
}

template <int DT>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
           int S, int H, int K, int D, int causal, int window, int q_sb,
           int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, bool vec,
           cudaStream_t stream) {
  return vec ? launch_as<DT, true>(q, k, v, out, B, S, H, K, D, causal,
                                   window, q_sb, q_ss, q_sh, k_sb, k_ss,
                                   k_sh, stream)
             : launch_as<DT, false>(q, k, v, out, B, S, H, K, D, causal,
                                    window, q_sb, q_ss, q_sh, k_sb, k_ss,
                                    k_sh, stream);
}

}  // namespace bf16_flash
}  // namespace

// q: (B, S, H, D) at element strides (q_sb, q_ss, q_sh), pre-scaled; k, v:
// (B, S, K, D) at strides (k_sb, k_ss, k_sh), both with unit stride on D;
// out: (B, S, H, D) contiguous. H % K == 0, 1 <= D <= 256, all on the
// device of `stream`. Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int B, int S,
                                   int H, int K, int D, int causal,
                                   int window, int q_sb, int q_ss, int q_sh,
                                   int k_sb, int k_ss, int k_sh,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // 16-byte loads need every row start 16-byte aligned
  const bool vec = D % 4 == 0 &&
      (q_sb | q_ss | q_sh | k_sb | k_ss | k_sh) % 4 == 0 &&
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (D <= 32)
    return launch<32>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                      q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
  if (D <= 64)
    return launch<64>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                      q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
  if (D <= 128)
    return launch<128>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                       q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
  return launch<256>(q, k, v, out, B, S, H, K, D, causal, window, q_sb, q_ss,
                     q_sh, k_sb, k_ss, k_sh, vec, st);
}

// The same with q, k, v and out in bf16.
extern "C" int flash_attention_bf16(const elem::bf16* q,
                                    const elem::bf16* k,
                                    const elem::bf16* v, elem::bf16* out,
                                    int B, int S, int H, int K, int D,
                                    int causal, int window, int q_sb,
                                    int q_ss, int q_sh, int k_sb, int k_ss,
                                    int k_sh, void* stream) {
  namespace fb = bf16_flash;
  cudaStream_t st = (cudaStream_t)stream;
  // 16-byte copies need D and every stride a multiple of 8 values and
  // every row start 16-byte aligned
  const bool vec = D % 8 == 0 &&
      (q_sb | q_ss | q_sh | k_sb | k_ss | k_sh) % 8 == 0 &&
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (D <= 32)
    return fb::launch<32>(q, k, v, out, B, S, H, K, D, causal, window,
                          q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
  if (D <= 64)
    return fb::launch<64>(q, k, v, out, B, S, H, K, D, causal, window,
                          q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
  if (D <= 128)
    return fb::launch<128>(q, k, v, out, B, S, H, K, D, causal, window,
                           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
  return fb::launch<256>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                         q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
}
