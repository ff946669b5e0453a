#!/usr/bin/env python3
"""Does the flash-attention kernel's fp32 instance compile to the same
machine code in two sources?

    python3 tools/flash_fp32_sass.py OTHER_SOURCE [OTHER_SOURCE ...]

Compiles src/repro_torch/csrc/flash_attention.cu and each OTHER_SOURCE (for
example the parent commit's, unpacked with git archive into build/parent)
with nvcc for sm_90a into cubins under build/sass/, disassembles them with
cuobjdump -sass, and compares the fp32 instances (flash_kernel at each tile
width and load path, whatever the template's other arguments) instruction
by instruction, with addresses, encodings and the anonymous namespace's
name left out. Prints one line per source and instance: identical, or how
many instructions differ. Needs the CUDA toolkit; imports no JAX.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "sass"
# the fp32 instance's device function: flash_kernel<DT, VEC> or, where the
# template also takes the element type, flash_kernel<float, DT, VEC>
FP32 = re.compile(r"flash_kernelI(?:f)?Li(\d+)ELb([01])E")


def sass(src: Path, tag: str) -> dict:
    """{(DT, VEC): [instruction text]} of the fp32 instances in src."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    cubin = OUT / f"{tag}.cubin"
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", str(cubin),
                    str(src)], check=True, capture_output=True, text=True)
    dump = subprocess.run([str(Path(build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, key = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            m = FP32.search(line)
            key = (int(m[1]), int(m[2])) if m and "bf16" not in line \
                else None
            if key is not None:
                out[key] = []
        elif key is not None:
            text = re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "",
                          line).strip()
            if text:
                out[key].append(text)
    return out


def main() -> int:
    mine = sass(SRC, "this")
    for i, other in enumerate(sys.argv[1:]):
        theirs = sass(Path(other), f"other{i}")
        for key in sorted(set(mine) | set(theirs)):
            a, b = mine.get(key), theirs.get(key)
            if a is None or b is None:
                what = f"missing in {'this' if a is None else other}"
            elif a == b:
                what = "identical"
            else:
                n = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
                what = f"{n} of {max(len(a), len(b))} instructions differ"
            print(f"{other}: fp32 flash_kernel DT={key[0]} vec={key[1]}: "
                  f"{len(a or [])} instructions here, {what}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
