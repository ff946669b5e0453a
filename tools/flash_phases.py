#!/usr/bin/env python3
"""Where the flash-attention kernel's time goes, phase by phase, on the card.

    python3 tools/flash_phases.py

Copies ``src/repro_torch`` into ``build/flash_phases/`` and adds clock64()
counters to the copy of ``csrc/flash_attention.cu``: each warp sums the
clocks it spends in each phase of its key-tile loop and adds them to a
device array at its end. Then runs chip_smoke.py's "main" flash case (q, k, v
(8, 512, 40, 128), causal) three times on the instrumented build and prints
the card's name and power limit and one JSON line: each phase's share of all
warps' clocks in the loop, and those clocks summed over the warps of a call.
The counters change the code they time, so the shares are a guide to where
the time goes, not a measurement of the shipped kernel's speed.

Phases: waiting for a key tile's copies and the barrier after them, its
split into shared-memory planes, the barrier after that and the issue of
the next tile's copies, Q K^T, the mask and the online softmax, P V, the
rest of the loop, and the tiles a warp skips.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_phases"
PHASES = ("copy_wait_and_barrier", "split", "barrier_and_copy_issue",
          "scores", "mask_and_softmax", "pv", "loop_rest", "skipped_tiles")

# (anchor in flash_attention.cu, text that replaces it)
EDITS = (
    ("namespace {\n",
     "__device__ unsigned long long g_phase[8];\nnamespace {\n"),
    ("  for (int tile = t_begin; tile < t_end; ++tile) {\n",
     "  unsigned long long pc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long tp = clock64(), tn;\n"
     "#define MARK(i) tn = clock64(); pc[i] += tn - tp; tp = tn;\n"
     "  for (int tile = t_begin; tile < t_end; ++tile) {\n    MARK(6)\n"),
    ("    Tile::split(ks, vs, kp, vp, D);\n",
     "    MARK(0)\n    Tile::split(ks, vs, kp, vp, D);\n    MARK(1)\n"),
    ("      Tile::copy(ks, vs, kb, vb, (tile + 1) * kBK, S, D, k_ss);\n",
     "      Tile::copy(ks, vs, kb, vb, (tile + 1) * kBK, S, D, k_ss);\n"
     "    MARK(2)\n"),
    ("      continue;   // no key of this tile is visible to this warp's "
     "rows",
     "      { MARK(7) continue; }"),
    ("    // mask only a tile that crosses S",
     "    MARK(3)\n    // mask only a tile that crosses S"),
    ("    // o += P V: k step j", "    MARK(4)\n    // o += P V: k step j"),
    ("\n#pragma unroll\n  for (int r = 0; r < 2; ++r) {\n"
     "    const int row = w0 + g + 8 * r;",
     "\n  MARK(6)\n  if ((threadIdx.x & 31) == 0)\n"
     "    for (int i = 0; i < 8; ++i) atomicAdd(&g_phase[i], pc[i]);\n"
     "#pragma unroll\n  for (int r = 0; r < 2; ++r) {\n"
     "    const int row = w0 + g + 8 * r;"),
)
READ = '''
extern "C" int flash_phases_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return (int)e;
}
'''


def instrument(src: str) -> str:
    for anchor, text in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"flash_phases: anchor not found once: "
                             f"{anchor[:60]!r}")
        src = src.replace(anchor, text)
    # P V ends where the key-tile loop body closes: the last "    }" line
    # before the epilogue's MARK(6)
    end = src.index("\n  MARK(6)\n  if ((threadIdx.x & 31) == 0)")
    close = src.rindex("\n  }\n", 0, end)
    return src[:close] + "\n    MARK(5)" + src[close:] + READ


def main() -> int:
    if OUT.exists():
        shutil.rmtree(OUT)
    shutil.copytree(ROOT / "src" / "repro_torch", OUT / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = OUT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
    cu.write_text(instrument(cu.read_text()))
    sys.path[:0] = [str(OUT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("flash_phases: no CUDA device")
    assert build.CSRC == cu.parent, build.CSRC   # the instrumented copy
    read = build.load("flash_attention").flash_phases_read
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    case = next(c for c in cs.flash_cases(torch, torch.device("cuda"))
                if c["name"] == "main")
    clocks = (ctypes.c_ulonglong * 8)()
    case["kernel"]()               # warm up, then start the counts at 0
    torch.cuda.synchronize()
    assert read(clocks) == 0
    runs = 3
    for _ in range(runs):
        case["kernel"]()
    torch.cuda.synchronize()
    assert read(clocks) == 0
    total = sum(clocks)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps(dict(
        share={n: c / total for n, c in zip(PHASES, clocks)},
        warp_clocks_per_call=total / runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
