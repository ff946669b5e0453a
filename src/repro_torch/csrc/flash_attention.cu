// Flash attention (prefill) for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// flash_attention_bhsd (body _fa_kernel): causal or windowed self-attention
// with an online softmax, irregular S masked by key position (k < S), no
// re-mask after the max and the l == 0 -> 0 guard.
//
// What bounds it: operations. Each (b, h) does about S * S * D * 2 flops of
// scores and as many of P V under a causal mask (4 * S * S * D without one)
// on S * D * 4 floats of input and output, so at the main path's shapes
// (S = 512, D = 128) it does about 64 flops per byte, above the H100's fp32
// ridge of about 20 (67 TFLOP/s / 3.35 TB/s). The least time is the
// unmasked flops over the fp32 CUDA-core peak.
//
// Design: one block of 256 threads per (b, h, tile of kBQ = 64 query rows),
// launched as a (ceil(S / 64), H, B) grid with the tiles nearest the end of
// the sequence (the ones with most keys under a causal mask) first. The
// block loops over key tiles of kBK = 32 itself; this takes the place of
// the TPU's sequential key grid axis with m/l/acc in VMEM scratch. The
// query tile and one K tile (transposed) and V tile sit in shared memory;
// thread (ty, tx) of a 16 x 16 grid owns query rows 4 ty .. 4 ty + 3, score
// columns tx and tx + 16, and output columns tx + 16 j, so m, l and the
// accumulator stay in registers, and a row's max and sum are reduced with
// shuffles over the 16 threads of its half-warp. Key tiles wholly above the
// diagonal or wholly before every row's window are skipped: they hold only
// masked keys, and since every row sees its own key they would only have
// added terms that a later exp(-1e30 - m) = 0 rescale wipes out exactly.
// Scores and P V are fp32 FMAs on the CUDA cores: no TF32, no wgmma, so the
// kernel agrees with the plain version to fp32 rounding.
//
// Layouts: q (B, S, H, D) and k, v (B, S, K, D) read through element
// strides (sb, ss, sh; unit stride on D), head h reading kv head h / (H/K);
// out (B, S, H, D) contiguous. The kernel contract (BH, S, D) of the TPU
// kernel is the case B = BH, H = K = 1.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per block (16 thread rows x 4)
constexpr int kBK = 32;        // keys per tile (16 thread columns x 2)
constexpr int kKsStride = kBK + 1;   // transposed K tile: conflict-free
constexpr int kPsStride = kBK + 4;   // probabilities: rows 4 apart on
                                     // banks 16 apart

__host__ __device__ inline int qs_stride(int D) { return D + 4; }

// Dynamic shared memory of one block, in floats, for head_dim D padded to
// the template width DT.
__host__ __device__ inline size_t smem_floats(int D, int DT) {
  return (size_t)kBQ * qs_stride(D)   // query tile
       + (size_t)D * kKsStride         // K tile, transposed
       + (size_t)kBK * DT              // V tile, zero past D
       + (size_t)kBQ * kPsStride;      // probabilities
}

__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int H, int K, int D, int causal, int window, int q_sb, int q_ss,
             int q_sh, int k_sb, int k_ss, int k_sh) {
  constexpr int kCols = DT / 16;   // output columns per thread
  extern __shared__ float smem[];
  const int QS = qs_stride(D);
  float* qs = smem;
  float* ks = qs + kBQ * QS;
  float* vs = ks + D * kKsStride;
  float* ps = vs + kBK * DT;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const float* kb = k + (size_t)b * k_sb + (size_t)kh * k_sh;
  const float* vb = v + (size_t)b * k_sb + (size_t)kh * k_sh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[r * QS + d] = q0 + r < S ? qb[(size_t)(q0 + r) * q_ss + d] : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // key tiles this block can see: none past its last row's own key under
  // a causal mask, none wholly before its first row's window
  const int q_hi = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_hi + 1 : S;
  const int t_end = (k_end + kBK - 1) / kBK;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile is no longer read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e - c * D;
      const bool in = k0 + c < S;
      const size_t off = (size_t)(k0 + c) * k_ss + d;
      ks[d * kKsStride + c] = in ? kb[off] : 0.f;
      vs[c * DT + d] = in ? vb[off] : 0.f;
    }
    if (DT != D)
      for (int e = tid; e < kBK * (DT - D); e += kThreads) {
        const int c = e / (DT - D);
        vs[c * DT + D + e - c * (DT - D)] = 0.f;
      }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0v = ks[d * kKsStride + tx];
      const float k1v = ks[d * kKsStride + tx + 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = qs[(ty * 4 + i) * QS + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        if (!ok) s[i][j] = kNegInf;
      }
      // as the TPU body: no re-mask after the max; a row whose keys in
      // this tile are all masked and whose m is still -1e30 adds garbage
      // that the first tile with a visible key rescales by exactly 0
      const float m_new = fmaxf(m[i], half_warp_max(fmaxf(s[i][0], s[i][1])));
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + half_warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
      ps[(ty * 4 + i) * kPsStride + tx] = p0;
      ps[(ty * 4 + i) * kPsStride + tx + 16] = p1;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPsStride + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[c * DT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    float* o = out + (((size_t)b * S + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < D) o[d] = acc[i][j] * inv;
    }
  }
}

template <int DT>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int S, int H, int K, int D, int causal, int window, int q_sb,
           int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
           cudaStream_t stream) {
  const size_t smem = smem_floats(D, DT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<DT><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, H, K, D, causal, window, q_sb, q_ss, q_sh, k_sb, k_ss,
      k_sh);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32)
    return launch<32>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                      q_ss, q_sh, k_sb, k_ss, k_sh, st);
  if (D <= 64)
    return launch<64>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                      q_ss, q_sh, k_sb, k_ss, k_sh, st);
  if (D <= 128)
    return launch<128>(q, k, v, out, B, S, H, K, D, causal, window, q_sb,
                       q_ss, q_sh, k_sb, k_ss, k_sh, st);
  return launch<256>(q, k, v, out, B, S, H, K, D, causal, window, q_sb, q_ss,
                     q_sh, k_sb, k_ss, k_sh, st);
}
