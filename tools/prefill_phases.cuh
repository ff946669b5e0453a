// Clocks by phase of the paged prefill kernel
// (src/repro_torch/csrc/paged_prefill_attention.cu), compiled in by
// tools/prefill_variants.py's "phases" variant (-DPREFILL_PHASES, with this
// directory on the include path). Thread 0 of every working block notes
// clock64() between the phases of its walk, and the global timer at its
// start and end, into g_phase; read_phases() copies the records out and
// clears the count.
#pragma once

constexpr int kFields = 10, kMaxRecords = 16384;
__device__ long long g_phase[kFields * kMaxRecords];
__device__ unsigned g_phase_n;

__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// phase marks: 0 the block's start (past its early exit), 1 the page ids
// in, 2 the key loop's start, 3 the warps' merge, 4 the splits' merge
#define PHASE_BEGIN()                                              \
  long long ph_t[5], ph_wait = 0, ph_comp = 0, ph_tw = 0, ph_tc = 0; \
  const long long ph_g0 = gtimer();                                \
  ph_t[0] = clock64()
#define PHASE_MARK(i) ph_t[i] = clock64()
#define PHASE_TILE_BEGIN() ph_tw = clock64()
#define PHASE_TILE_WAITED() (ph_tc = clock64(), ph_wait += ph_tc - ph_tw)
#define PHASE_TILE_USED() ph_comp += clock64() - ph_tc
// fields: setup to page ids, Q split to loop, copy issue + wait, products
// + barrier, warp merge + stores, split merge, tiles, single split, start
// and end on the global timer
#define PHASE_RECORD(tiles, single)                                  \
  do {                                                               \
    if (threadIdx.x == 0) {                                          \
      const unsigned i_ = atomicAdd(&g_phase_n, 1u);                 \
      if (i_ < kMaxRecords) {                                        \
        long long* r = g_phase + kFields * i_;                       \
        r[0] = ph_t[1] - ph_t[0];                                    \
        r[1] = ph_t[2] - ph_t[1];                                    \
        r[2] = ph_wait;                                              \
        r[3] = ph_comp;                                              \
        r[4] = ph_t[4] - ph_t[3];                                    \
        r[5] = clock64() - ph_t[4];                                  \
        r[6] = (tiles);                                              \
        r[7] = (single);                                             \
        r[8] = ph_g0;                                                \
        r[9] = gtimer();                                             \
      }                                                              \
    }                                                                \
  } while (0)

extern "C" int read_phases(long long* dst, unsigned* n) {
  cudaMemcpyFromSymbol(n, g_phase_n, sizeof(unsigned));
  cudaMemcpyFromSymbol(dst, g_phase, sizeof(g_phase));
  const unsigned z = 0;
  cudaMemcpyToSymbol(g_phase_n, &z, sizeof z);
  return (int)cudaGetLastError();
}
