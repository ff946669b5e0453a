// Mamba-2 SSD intra-chunk scan for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py ::
// ssd_chunk_scan (body _ssd_kernel). For each (batch*chunk bc, head h) of
// a chunk of l positions:
//   y[i]  = sum_{j <= i} (C_i . B_j) * exp(dA_i - dA_j) * dt_j * x_j   (l, P)
//   state = sum_j exp(dA_last - dA_j) * dt_j * B_j (x) x_j              (N, P)
// B and C are shared by every head of a bc; everything is fp32.
//
// What bounds it: operations. At the dense path's chunk (l = 256, N = 128,
// P = 64) a (bc, h) does about l*l*N flops of scores, l*l*P of y and
// 2*l*N*P of state on (2*l*P + 2*l*N + 2*l) * 4 bytes of its own, about
// 30 flops per byte, above the H100's fp32 ridge of about 20. At the pool's
// chunks (l <= 16) it is bound by bytes, and in practice by the launch.
//
// Design: one launch, two kinds of blocks of 256 threads, on a grid of
// (row tiles + state tiles, H, BC):
// * a y block owns kRows = 64 query rows of one (bc, h), longest tiles
//   first, and loops over key tiles of kBJ = 32 positions j <= its last
//   row (tiles wholly above the diagonal are skipped: they add exact
//   zeros). This takes the place of the TPU body's whole (l, l) tile,
//   which at l = 256 would be 256 KB, over a block's 227 KB of shared
//   memory. Per key tile it computes the 64 x 32 scores C_i . B_j from
//   shared memory, gates them into G, and accumulates y += G x_tile;
// * a state block owns kRows = 64 state rows n of one (bc, h) and loops
//   over all key tiles, with G[n][j] = B_j[n] * w_j, w_j = exp(dA_last -
//   dA_j) * dt_j, and the same accumulation. Every state element has one
//   owner, which sums its terms in a fixed order: no atomics, so the
//   result is the same on every run.
// Thread (ty, tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3, score
// columns tx and tx + 16 and output columns tx + 16 c, so the accumulator
// stays in registers. Scores and products are fp32 FMAs on the CUDA cores:
// no TF32, no wgmma. B and C are read once per head through their strides;
// the TPU wrapper's per-head broadcast copies are not made.
//
// Numerics kept from the TPU body: exp(dA_i - dA_j) is evaluated only for
// j <= i (dA is a cumulative sum of negative terms, so above the diagonal
// it can overflow to inf, and inf * 0 is NaN); positions past l are
// selected to 0, never multiplied by a 0/1 mask. A padding position with
// dt = 0 adds exactly 0 to the state.
//
// Layouts, all through element strides: x (bc, h, j, p) at (x_sbc, x_sh,
// x_sl), unit stride on p; dt and dA (bc, h, j) at (d_sbc, d_sh, d_sl); B
// and C (bc, j, n) at (b_sbc, b_sl), unit stride on n; y (bc, h, i, p) at
// (y_sbc, y_sh, y_sl), unit stride on p; state (bc, h, n, p) at (s_sbc,
// s_sh, s_sn, s_sp). The TPU kernel's layout and the model's (b, nc, l, H,
// P) layout are both strides of these.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;              // rows per block (16 thread rows x 4)
constexpr int kBJ = 32;                // positions j per tile (16 x 2)
constexpr int kGStride = kBJ + 4;      // G tile: rows 4 apart, banks 16 apart
constexpr int kBtStride = kBJ + 1;     // transposed B tile: conflict-free

struct Args {
  const float *x, *dt, *da, *B, *C;
  float *y, *st;
  int H, l, P, N, row_tiles;
  int x_sbc, x_sh, x_sl, d_sbc, d_sh, d_sl, b_sbc, b_sl;
  int y_sbc, y_sh, y_sl, s_sbc, s_sh, s_sn, s_sp;
};

__host__ __device__ inline int cs_stride(int N) { return N + 4; }

// Dynamic shared memory of one block, in floats, for head width P padded
// to the template width PT.
__host__ __device__ inline size_t smem_floats(int N, int PT) {
  return (size_t)kBJ * PT              // x tile, zero past P and l
       + (size_t)kRows * kGStride      // G tile
       + (size_t)kRows * cs_stride(N)  // C rows of a y block
       + (size_t)N * kBtStride         // B tile, transposed
       + kRows + 2 * kBJ;              // dA of the rows, dA and dt of j
}

template <int PT>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
  constexpr int kCols = PT / 16;       // output columns per thread
  extern __shared__ float smem[];
  const int l = a.l, P = a.P, N = a.N, CS = cs_stride(N);
  float* xs = smem;
  float* gs = xs + kBJ * PT;
  float* cs = gs + kRows * kGStride;
  float* bt = cs + kRows * CS;
  float* dai = bt + N * kBtStride;
  float* daj = dai + kRows;
  float* dtj = daj + kBJ;

  const int h = blockIdx.y, bc = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* xb = a.x + (size_t)bc * a.x_sbc + (size_t)h * a.x_sh;
  const float* dtb = a.dt + (size_t)bc * a.d_sbc + (size_t)h * a.d_sh;
  const float* dab = a.da + (size_t)bc * a.d_sbc + (size_t)h * a.d_sh;
  const float* Bb = a.B + (size_t)bc * a.b_sbc;
  const float* Cb = a.C + (size_t)bc * a.b_sbc;

  const bool y_block = blockIdx.x < a.row_tiles;
  // y block: query rows r0 ..; state block: state rows n = r0 ..
  const int r0 = y_block ? (a.row_tiles - 1 - blockIdx.x) * kRows
                         : (blockIdx.x - a.row_tiles) * kRows;
  // key tiles: up to the y block's last row, or the whole chunk
  const int j_end = y_block ? min(r0 + kRows, l) : l;
  const int t_end = (j_end + kBJ - 1) / kBJ;
  const float da_last = dab[(size_t)(l - 1) * a.d_sl];

  if (y_block) {
    for (int e = tid; e < kRows * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      cs[r * CS + n] = r0 + r < l ? Cb[(size_t)(r0 + r) * a.b_sl + n] : 0.f;
    }
    for (int r = tid; r < kRows; r += kThreads)
      dai[r] = r0 + r < l ? dab[(size_t)(r0 + r) * a.d_sl] : 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < t_end; ++t) {
    const int j0 = t * kBJ;
    __syncthreads();   // the previous tile is no longer read
    for (int e = tid; e < kBJ * PT; e += kThreads) {
      const int c = e / PT, p = e - c * PT;
      xs[e] = (j0 + c < l && p < P) ? xb[(size_t)(j0 + c) * a.x_sl + p] : 0.f;
    }
    for (int c = tid; c < kBJ; c += kThreads) {
      const bool in = j0 + c < l;
      daj[c] = in ? dab[(size_t)(j0 + c) * a.d_sl] : 0.f;
      dtj[c] = in ? dtb[(size_t)(j0 + c) * a.d_sl] : 0.f;
    }
    if (y_block) {
      for (int e = tid; e < kBJ * N; e += kThreads) {
        const int c = e / N, n = e - c * N;
        bt[n * kBtStride + c] =
            j0 + c < l ? Bb[(size_t)(j0 + c) * a.b_sl + n] : 0.f;
      }
    }
    __syncthreads();

    if (y_block) {
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float b0 = bt[n * kBtStride + tx];
        const float b1 = bt[n * kBtStride + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cv = cs[(ty * 4 + i) * CS + n];
          s[i][0] = fmaf(cv, b0, s[i][0]);
          s[i][1] = fmaf(cv, b1, s[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int cj = tx + 16 * jj, col = j0 + cj;
          // select, never multiply: above the diagonal exp() may be inf
          float g = 0.f;
          if (col <= row && row < l)
            g = s[i][jj] * expf(dai[ty * 4 + i] - daj[cj]) * dtj[cj];
          gs[(ty * 4 + i) * kGStride + cj] = g;
        }
      }
    } else {
      for (int e = tid; e < kRows * kBJ; e += kThreads) {
        const int c = e / kRows, r = e - c * kRows;
        float g = 0.f;
        if (j0 + c < l && r0 + r < N)
          g = Bb[(size_t)(j0 + c) * a.b_sl + r0 + r]
              * (expf(da_last - daj[c]) * dtj[c]);
        gs[r * kGStride + c] = g;
      }
    }
    __syncthreads();

    for (int c = 0; c < kBJ; ++c) {
      float g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = gs[(ty * 4 + i) * kGStride + c];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float xv = xs[c * PT + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][k] = fmaf(g[i], xv, acc[i][k]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= (y_block ? l : N)) continue;
    float* o = y_block
        ? a.y + (size_t)bc * a.y_sbc + (size_t)h * a.y_sh + (size_t)r * a.y_sl
        : a.st + (size_t)bc * a.s_sbc + (size_t)h * a.s_sh
              + (size_t)r * a.s_sn;
    const size_t sp = y_block ? 1 : (size_t)a.s_sp;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int p = tx + 16 * k;
      if (p < P) o[p * sp] = acc[i][k];
    }
  }
}

template <int PT>
int launch(const Args& a, int BC, cudaStream_t stream) {
  const size_t smem = smem_floats(a.N, PT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int state_tiles = (a.N + kRows - 1) / kRows;
  const dim3 grid(a.row_tiles + state_tiles, a.H, BC);
  ssd_kernel<PT><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes (BC, H, l, P, N) with 1 <= P <= 128, 1 <= N <= 256, l >= 1 and
// BC, H <= 65535; strides as in the header comment. x, dt, dA, B, C are
// read, y and the state written, all fp32 on the device of `stream`.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ssd_chunk_scan_f32(
    const float* x, const float* dt, const float* da, const float* B,
    const float* C, float* y, float* st, int BC, int H, int l, int P, int N,
    int x_sbc, int x_sh, int x_sl, int d_sbc, int d_sh, int d_sl, int b_sbc,
    int b_sl, int y_sbc, int y_sh, int y_sl, int s_sbc, int s_sh, int s_sn,
    int s_sp, void* stream) {
  Args a{x, dt, da, B, C, y, st, H, l, P, N, (l + kRows - 1) / kRows,
         x_sbc, x_sh, x_sl, d_sbc, d_sh, d_sl, b_sbc, b_sl,
         y_sbc, y_sh, y_sl, s_sbc, s_sh, s_sn, s_sp};
  cudaStream_t s = (cudaStream_t)stream;
  if (P <= 16) return launch<16>(a, BC, s);
  if (P <= 32) return launch<32>(a, BC, s);
  if (P <= 64) return launch<64>(a, BC, s);
  return launch<128>(a, BC, s);
}
