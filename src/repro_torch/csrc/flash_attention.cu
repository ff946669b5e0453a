// Flash attention (prefill) for Hopper (sm_90a), fp32 through 3xTF32 on
// the tensor cores, or bf16 through one TF32 product.
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
// Design: one block of 8 warps per (b, h, tile of kBQ = 128 query rows),
// launched as a (ceil(S / 128), H, B) grid with the tiles nearest the end
// of the sequence (the ones with most keys under a causal mask) first. The
// block loops over key tiles itself, in place of the TPU's sequential key
// grid axis with m/l/acc in VMEM scratch. Each warp owns 16 query rows: its
// m, l and (16, D) accumulator stay in registers as m16n8 C fragments, and
// a row's max and sum reduce over the 4 lanes that hold it.
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
// bf16 (the entries *_bf16; the TPU kernel takes either dtype): q, k, v
// and out are bf16, everything between stays fp32. A bf16 value is exact
// in TF32 (7 stored mantissa bits against 10), and so is P rounded to
// bf16, as the TPU body's p.astype(v.dtype) rounds it before P V (l sums
// the unrounded P): so each product is one TF32 mma.sync, exact, on the
// same fragments, with no lo planes. The raw K and V tiles are copied as
// bf16 (16-byte cp.async of 8 values) and widened into the fp32 planes
// where the fp32 kernel splits them; Q is widened as it is loaded. The
// output is rounded to bf16 once. At bf16 the bytes halve and the
// products cost a third.
//
// Layouts: q (B, S, H, D) and k, v (B, S, K, D) read through element
// strides (sb, ss, sh; unit stride on D), head h reading kv head h / (H/K);
// out (B, S, H, D) contiguous. Rows are read 16 bytes at a time when D,
// every stride and every base pointer allow it, 4 bytes otherwise; D is
// zero-padded to a multiple of 8 (zero columns add 0 to Q K^T; the padded
// output columns are never stored). The kernel contract (BH, S, D) of the
// TPU kernel is the case B = BH, H = K = 1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "mma_tf32x3.cuh"
#include "smem_copy.cuh"

namespace {

using tilecopy::cp_async16;
using tilecopy::cp_async4;
using tilecopy::ldsm_x2;
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

// TF32 planes a K or V^T tile is held in: hi and lo in fp32, the value
// alone in bf16 (exact in TF32)
template <typename T>
__host__ __device__ constexpr int planes() {
  return elem::is_bf16<T>() ? 1 : 2;
}
// raw K and V rows being copied, in elements: Q's and K's stride in fp32,
// padded(D) in bf16 (16-byte rows of whole 8-value chunks)
template <typename T>
__host__ __device__ inline int raw_stride(int D) {
  return elem::is_bf16<T>() ? padded(D) : row_stride(D);
}

// Dynamic shared memory of one block, in bytes: the fp32 query tile, the
// planes of one K tile and of one V^T tile, and the raw K and V tiles
// being copied.
template <typename T>
__host__ __device__ inline size_t smem_bytes(int D, int BK) {
  return sizeof(float) * ((size_t)(kBQ + planes<T>() * BK) * row_stride(D) +
                          (size_t)planes<T>() * vt_rows(D) * vt_stride(BK)) +
         sizeof(T) * (size_t)2 * BK * raw_stride<T>(D);
}

// Copy a 16-byte chunk (four floats or eight bf16 values) of row `row` at
// column c of a (S, D) slab at row stride ss to dst, zero past S and past
// D. VEC: one 16-byte copy (D a multiple of the chunk, so it lies wholly
// inside or past D, and every row start is 16-byte aligned); else fp32 by
// four copies of 4 bytes, bf16 by plain loads and stores of 2 bytes.
template <bool VEC, typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int row,
                                           int c, int S, int D, int ss) {
  constexpr int CW = 16 / (int)sizeof(T);
  const T* p = src + (size_t)row * ss + c;
  if constexpr (VEC) {
    const bool in = row < S && c < D;
    cp_async16(dst, in ? p : src, in);
  } else if constexpr (elem::is_bf16<T>()) {
#pragma unroll
    for (int i = 0; i < CW; ++i)
      dst[i] = row < S && c + i < D ? p[i] : elem::from_float<T>(0.f);
  } else {
#pragma unroll
    for (int i = 0; i < CW; ++i) {
      const bool in = row < S && c + i < D;
      cp_async4(dst + i, in ? p + i : src, in);
    }
  }
}

// Q's chunk of row `row` at column c, widened into fp32 dst (bf16 only; an
// fp32 Q is copied as it is, by copy_chunk): zero past S and past D.
template <bool VEC>
__device__ __forceinline__ void widen_chunk(float* dst, const elem::bf16* src,
                                            int row, int c, int S, int D,
                                            int ss) {
  const elem::bf16* p = src + (size_t)row * ss + c;
  float x[8];
  if constexpr (VEC) {
    elem::load<8>(x, p, row < S && c < D);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = row < S && c + i < D ? elem::to_float(p[i]) : 0.f;
  }
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
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
// skipped. Both tiles are copied as 16-byte chunks of rows (4 floats or 8
// bf16 values; lanes along d); V is split as 8-value runs with lanes along
// keys, so that a warp's transposed stores hit 32 consecutive words. At
// bf16 the split only widens (one plane).
template <int DT, bool VEC, typename T>
struct KVTile {
  static constexpr int BK = key_tile(DT);
  static constexpr int CW = 16 / (int)sizeof(T);    // values of a chunk
  static constexpr int CPR = DT / CW;               // K chunks of a row
  static constexpr int NK = BK * CPR / kThreads;    // K chunks a thread
  static constexpr int NV = BK * DT / 8 / kThreads; // V runs a thread
  static_assert(kThreads % CPR == 0 && kThreads % BK == 0 &&
                NK * kThreads == BK * CPR && NV * kThreads * 8 == BK * DT,
                "every thread holds whole chunks and runs of the tile");

  // chunk i of this thread: row kr + i * kThreads / CPR, column kc
  static __device__ __forceinline__ int kr() { return threadIdx.x / CPR; }
  static __device__ __forceinline__ int kc() {
    return CW * (threadIdx.x % CPR);
  }
  // V run i: row vr, columns vc + 8 i * kThreads / BK .. + 7
  static __device__ __forceinline__ int vr() { return threadIdx.x % BK; }
  static __device__ __forceinline__ int vc() { return 8 * (threadIdx.x / BK); }

  // start copying rows [k0, k0 + BK) of K and V into ks and vs
  static __device__ __forceinline__ void copy(T* ks, T* vs, const T* kb,
                                              const T* vb, int k0, int S,
                                              int D, int ss) {
    const int RR = raw_stride<T>(D);
    if (kc() < padded(D)) {
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int r = kr() + i * (kThreads / CPR);
        copy_chunk<VEC>(ks + r * RR + kc(), kb, k0 + r, kc(), S, D, ss);
        copy_chunk<VEC>(vs + r * RR + kc(), vb, k0 + r, kc(), S, D, ss);
      }
    }
    asm volatile("cp.async.commit_group;");
  }

  // split ks, vs (BK x raw_stride each) into khi/klo (BK x RS each,
  // adjacent) and vthi/vtlo (vt_rows x BK + 8 each, adjacent); at bf16
  // widen them into khi and vthi alone
  static __device__ __forceinline__ void split(const T* ks, const T* vs,
                                               float* kp, float* vp, int D) {
    const int Dp = padded(D), RS = row_stride(D), RR = raw_stride<T>(D);
    const int kplane = BK * RS, vplane = vt_rows(D) * vt_stride(BK);
    if (kc() < Dp) {
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int r = kr() + i * (kThreads / CPR);
        const int at = r * RS + kc();
        if constexpr (elem::is_bf16<T>()) {
          float x[8];
          elem::widen8(x,
                       *reinterpret_cast<const uint4*>(ks + r * RR + kc()));
          *reinterpret_cast<float4*>(kp + at) =
              make_float4(x[0], x[1], x[2], x[3]);
          *reinterpret_cast<float4*>(kp + at + 4) =
              make_float4(x[4], x[5], x[6], x[7]);
        } else {
          uint4 hi, lo;
          split4(*reinterpret_cast<const float4*>(ks + at), hi, lo);
          *reinterpret_cast<uint4*>(kp + at) = hi;
          *reinterpret_cast<uint4*>(kp + at + kplane) = lo;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = vc() + 8 * i * (kThreads / BK);
      if (c >= Dp) continue;
      float x[8];
      if constexpr (elem::is_bf16<T>()) {
        elem::widen8(x, *reinterpret_cast<const uint4*>(vs + vr() * RR +
                                                        c));
      } else {
        const float4 a = *reinterpret_cast<const float4*>(vs + vr() * RR + c);
        const float4 b =
            *reinterpret_cast<const float4*>(vs + vr() * RR + c + 4);
        x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
        x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
      }
      float* dst = vp + c * vt_stride(BK) + vr();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (elem::is_bf16<T>()) {
          dst[j * vt_stride(BK)] = x[j];
        } else {
          uint32_t hi, lo;
          tf32x3::split(x[j], hi, lo);
          dst[j * vt_stride(BK)] = __uint_as_float(hi);
          dst[j * vt_stride(BK) + vplane] = __uint_as_float(lo);
        }
      }
    }
  }
};

template <typename T, int DT, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S,
             int H, int K, int D, int causal, int window, int q_sb, int q_ss,
             int q_sh, int k_sb, int k_ss, int k_sh) {
  constexpr int kBK = key_tile(DT);
  constexpr int kKT = kBK / 8;    // m16n8 score tiles per key tile
  constexpr int kDT = DT / 8;     // k steps of Q K^T, n tiles of P V
  constexpr int kRV = vt_stride(kBK);
  constexpr bool kExact = elem::is_bf16<T>();   // one TF32 product
  static_assert(kDT % kNG == 0, "P V groups must tile DT");
  extern __shared__ __align__(16) float smem[];
  const int Dp = padded(D), RS = row_stride(D);
  float* qs = smem;                  // kBQ x RS, fp32
  float* kp = qs + kBQ * RS;         // hi then lo, kBK x RS each
  float* vp = kp + planes<T>() * kBK * RS;   // hi then lo, vt_rows x kRV
  const int vplane = vt_rows(D) * kRV;
  // raw K and V tiles being copied, kBK x raw_stride each
  T* ks = reinterpret_cast<T*>(vp + planes<T>() * vplane);
  T* vs = ks + kBK * raw_stride<T>(D);

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const T* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const T* kb = k + (size_t)b * k_sb + (size_t)kh * k_sh;
  const T* vb = v + (size_t)b * k_sb + (size_t)kh * k_sh;

  // key tiles this block can see: none past its last row's own key under
  // a causal mask, none wholly before its first row's window
  const int q_hi = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_hi + 1 : S;
  const int t_end = (k_end + kBK - 1) / kBK;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  using Tile = KVTile<DT, VEC, T>;
  if (Tile::kc() < Dp) {
#pragma unroll 4
    for (int r = Tile::kr(); r < kBQ; r += kThreads / Tile::CPR) {
      if constexpr (kExact)
        widen_chunk<VEC>(qs + r * RS + Tile::kc(), qb, q0 + r, Tile::kc(),
                         S, D, q_ss);
      else
        copy_chunk<VEC>(qs + r * RS + Tile::kc(), qb, q0 + r, Tile::kc(),
                        S, D, q_ss);
    }
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
      uint32_t a[4];
      ldsm_x4(a, qa + 8 * kk);
      if constexpr (kExact) {   // Q and K exact in TF32: one product
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
          uint32_t x[2];
          ldsm_x2(x, kf + 8 * j * RS + 8 * kk);
          tf32x3::mma(sp[kk & 1][j], a, x);
        }
        continue;
      }
      uint32_t ah[4], al[4], bh[kKT][2], bl[kKT][2];
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
      if constexpr (kExact) {   // P rounded to bf16 and V: exact in TF32
        const uint32_t a[4] = {
            __float_as_uint(elem::round_bf16(s[j][0])),
            __float_as_uint(elem::round_bf16(s[j][2])),
            __float_as_uint(elem::round_bf16(s[j][1])),
            __float_as_uint(elem::round_bf16(s[j][3]))};
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          if (8 * n >= Dp) break;
          const uint2 hi =
              *reinterpret_cast<const uint2*>(vf + 8 * n * kRV + 8 * j);
          const uint32_t bv[2] = {hi.x, hi.y};
          tf32x3::mma(o[n / kNG][n % kNG], a, bv);
        }
        continue;
      }
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
    T* orow = out + (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < D)
        orow[c] = elem::from_float<T>(o[n / kNG][n % kNG][2 * r] * inv);
      if (c + 1 < D)
        orow[c + 1] =
            elem::from_float<T>(o[n / kNG][n % kNG][2 * r + 1] * inv);
    }
  }
}

template <typename T, int DT, bool VEC>
int launch_as(const T* q, const T* k, const T* v, T* out, int B, int S,
              int H, int K, int D, int causal, int window, int q_sb,
              int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
              cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D, key_tile(DT));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, DT, VEC><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, H, K, D, causal, window, q_sb, q_ss, q_sh, k_sb, k_ss,
      k_sh);
  return (int)cudaGetLastError();
}

template <typename T, int DT>
int launch(const T* q, const T* k, const T* v, T* out, int B, int S, int H,
           int K, int D, int causal, int window, int q_sb, int q_ss,
           int q_sh, int k_sb, int k_ss, int k_sh, bool vec,
           cudaStream_t stream) {
  return vec ? launch_as<T, DT, true>(q, k, v, out, B, S, H, K, D, causal,
                                      window, q_sb, q_ss, q_sh, k_sb, k_ss,
                                      k_sh, stream)
             : launch_as<T, DT, false>(q, k, v, out, B, S, H, K, D, causal,
                                       window, q_sb, q_ss, q_sh, k_sb, k_ss,
                                       k_sh, stream);
}

// One launch of the kernel's T instance (flash_attention_f32's arguments).
template <typename T>
int run(const T* q, const T* k, const T* v, T* out, int B, int S, int H,
        int K, int D, int causal, int window, int q_sb, int q_ss, int q_sh,
        int k_sb, int k_ss, int k_sh, cudaStream_t st) {
  // 16-byte copies need D and every stride a multiple of a 16-byte chunk
  // and every row start 16-byte aligned
  const int cw = 16 / (int)sizeof(T);
  const bool vec = D % cw == 0 &&
      (q_sb | q_ss | q_sh | k_sb | k_ss | k_sh) % cw == 0 &&
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (D <= 32)
    return launch<T, 32>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                         q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                         q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                          q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
  return launch<T, 256>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                        q_ss, q_sh, k_sb, k_ss, k_sh, vec, st);
}

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
  return run(q, k, v, out, B, S, H, K, D, causal, window, q_sb, q_ss, q_sh,
             k_sb, k_ss, k_sh, (cudaStream_t)stream);
}

// The same with q, k, v and out in bf16.
extern "C" int flash_attention_bf16(const elem::bf16* q,
                                    const elem::bf16* k,
                                    const elem::bf16* v, elem::bf16* out,
                                    int B, int S, int H, int K, int D,
                                    int causal, int window, int q_sb,
                                    int q_ss, int q_sh, int k_sb, int k_ss,
                                    int k_sh, void* stream) {
  return run(q, k, v, out, B, S, H, K, D, causal, window, q_sb, q_ss, q_sh,
             k_sb, k_ss, k_sh, (cudaStream_t)stream);
}
