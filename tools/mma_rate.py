#!/usr/bin/env python3
"""Measure the rate of the tensor-core instruction that
csrc/mma_tf32x3.cuh issues: the TF32 ``mma.sync.aligned.m16n8k8``.

    python3 tools/mma_rate.py

Builds a small CUDA source with nvcc into build/mma_rate/, then times, with
CUDA events, blocks of 4 warps each issuing independent products from
registers, at 1, 2 and 4 blocks an SM (4, 8 and 16 warps). Prints the card's
name and power limit, then one JSON line per occupancy with the TF32 rate in
TFLOP/s (2 m n k flop a product) and the products each SM sub-partition
(a quarter of an SM) completes a microsecond.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mma_rate"
ITERS = 4096
CHAINS = 8   # independent accumulators a warp

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(128) mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x - i));
  float c[%(chains)d][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < %(chains)d; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%%0, %%1, %%2, %%3}, {%%4, %%5, %%6, %%7}, {%%8, %%9}, "
          "{%%0, %%1, %%2, %%3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < %(chains)d; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate(float* out, int blocks, int iters, void* stream) {
  mma_loop<<<blocks, 128, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
""" % dict(chains=CHAINS)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mma_rate: no CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "mma_rate.cu", OUT / "libmma_rate.so"
    src.write_text(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).mma_rate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for per_sm in (1, 2, 4):
        blocks = sms * per_sm
        out = torch.empty(blocks * 128, device="cuda")
        run = lambda: fn(out.data_ptr(), blocks, ITERS, stream)
        assert run() == 0
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            assert run() == 0
        e1.record()
        torch.cuda.synchronize()
        s = e0.elapsed_time(e1) / 5 / 1e3
        products = blocks * 4 * ITERS * CHAINS
        print(json.dumps(dict(
            warps_per_sm=4 * per_sm, seconds=s,
            tf32_tflops=products * 2 * 16 * 8 * 8 / s / 1e12,
            products_per_us_per_subpartition=products / s / 1e6 / (4 * sms),
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
