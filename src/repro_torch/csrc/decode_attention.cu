// One-token GQA decode attention over a dense KV cache, for Hopper
// (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py ::
// decode_attention_gqa (body _dec_kernel): the G query rows of one kv head
// attend to that head's cache under an int8 validity vector (valid > 0),
// with an online softmax, no re-mask after the max and the l == 0 -> 0
// guard.
//
// What bounds it: bytes. Each (b, kv head) reads S * D floats of K and of V
// once and does 4 * G * D flops per key, so at the main path's shapes
// (G = 1, fp32) it does about 0.5 flop per byte, far below the H100's fp32
// ridge of about 20 (67 TFLOP/s / 3.35 TB/s). The least time is the K/V
// bytes over 3.35 TB/s.
//
// Design: one block of 8 warps per (b, kv head h, up to R query rows of
// the head's group), launched as a (B, K, ceil(G / R)) grid. Warp w takes
// keys w, w + 8, w + 16, ...; its 32 lanes split D, so each key's K and V
// rows are read as coalesced 128-byte segments, every cache byte once. A
// score is a lane-partial dot product reduced with shuffles; each warp
// keeps its own m, l and accumulator in registers over its keys, and the
// eight partial results are combined through shared memory at the end
// (M = max m_w, out = sum acc_w e^(m_w - M) / sum l_w e^(m_w - M)). This
// takes the place of the TPU's sequential key-block grid axis. As in the
// TPU body, invalid keys are not re-masked after the max: a warp whose m
// is still -1e30 counts them with p = 1, and the first visible key (in the
// warp, or at the combine) rescales that by exactly exp(-1e30 - m) = 0. A
// row with no valid key at all never occurs on the decode path.
//
// Layouts: q and out (B, K, G, D) contiguous (the model's (B, H, D)); k, v
// (B, S, K, D) read through element strides (sb, ss, sh; unit stride on D),
// so the model's cache slab is read in place; valid (B, S) int8
// contiguous. The kernel contract (BK, G, D), (BK, S, D), (BK, S) of the
// TPU kernel is the case K = 1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__host__ __device__ inline size_t smem_floats(int R, int D) {
  return (size_t)kWarps * R * (D + 2);   // per warp and row: acc, m, l
}

template <int R, int DPL>   // query rows per block, D elements per lane
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int8_t* __restrict__ valid,
              float* __restrict__ out, int S, int K, int G, int D, int sb,
              int ss, int sh) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, g0 = blockIdx.z * R;
  const int rows = min(R, G - g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t qoff = (((size_t)b * K + h) * G + g0) * D;

  float qr[R][DPL], acc[R][DPL], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      qr[r][j] = (r < rows && d < D) ? q[qoff + (size_t)r * D + d] : 0.f;
      acc[r][j] = 0.f;
    }
  }

  const float* kb = k + (size_t)b * sb + (size_t)h * sh;
  const float* vb = v + (size_t)b * sb + (size_t)h * sh;
  const int8_t* vrow = valid + (size_t)b * S;
#pragma unroll 2
  for (int s = warp; s < S; s += kWarps) {
    float kr[DPL], vr[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      kr[j] = d < D ? kb[(size_t)s * ss + d] : 0.f;
      vr[j] = d < D ? vb[(size_t)s * ss + d] : 0.f;
    }
    const bool ok = vrow[s] > 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) dot = fmaf(qr[r][j], kr[j], dot);
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float sc = ok ? dot : kNegInf;
      const float m_new = fmaxf(m[r], sc);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sc - m_new);
      l[r] = alpha * l[r] + p;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] = fmaf(p, vr[j], acc[r][j] * alpha);
    }
  }

  // combine the warps' partial softmaxes
  float* sacc = smem;                              // [warp][r][D]
  float* sm = sacc + (size_t)kWarps * R * D;       // [warp][r]
  float* sl = sm + kWarps * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) sacc[((size_t)warp * R + r) * D + d] = acc[r][j];
    }
    if (lane == 0) {
      sm[warp * R + r] = m[r];
      sl[warp * R + r] = l[r];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm[w * R + r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm[w * R + r] - M);
      L = fmaf(sl[w * R + r], c, L);
      A = fmaf(sacc[((size_t)w * R + r) * D + d], c, A);
    }
    out[qoff + (size_t)r * D + d] = A / (L == 0.f ? 1.f : L);
  }
}

template <int R, int DPL>
int launch(const float* q, const float* k, const float* v,
           const int8_t* valid, float* out, int B, int S, int K, int G, int D,
           int sb, int ss, int sh, cudaStream_t stream) {
  const size_t smem = smem_floats(R, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<R, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, K, (G + R - 1) / R);
  decode_kernel<R, DPL><<<grid, kThreads, smem, stream>>>(
      q, k, v, valid, out, S, K, G, D, sb, ss, sh);
  return (int)cudaGetLastError();
}

template <int R>
int launch_d(const float* q, const float* k, const float* v,
             const int8_t* valid, float* out, int B, int S, int K, int G,
             int D, int sb, int ss, int sh, cudaStream_t st) {
  if (D <= 32) return launch<R, 1>(q, k, v, valid, out, B, S, K, G, D, sb, ss, sh, st);
  if (D <= 64) return launch<R, 2>(q, k, v, valid, out, B, S, K, G, D, sb, ss, sh, st);
  if (D <= 128) return launch<R, 4>(q, k, v, valid, out, B, S, K, G, D, sb, ss, sh, st);
  return launch<R, 8>(q, k, v, valid, out, B, S, K, G, D, sb, ss, sh, st);
}

}  // namespace

// q, out: (B, K, G, D) contiguous, q pre-scaled; k, v: (B, S, K, D) at
// element strides (sb, ss, sh) with unit stride on D; valid: (B, S) int8
// contiguous. 1 <= D <= 256, all on the device of `stream`. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int decode_attention_f32(const float* q, const float* k,
                                    const float* v, const int8_t* valid,
                                    float* out, int B, int S, int K, int G,
                                    int D, int sb, int ss, int sh,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 1) return launch_d<1>(q, k, v, valid, out, B, S, K, G, D, sb, ss, sh, st);
  if (G <= 2) return launch_d<2>(q, k, v, valid, out, B, S, K, G, D, sb, ss, sh, st);
  if (G <= 4) return launch_d<4>(q, k, v, valid, out, B, S, K, G, D, sb, ss, sh, st);
  return launch_d<8>(q, k, v, valid, out, B, S, K, G, D, sb, ss, sh, st);
}
