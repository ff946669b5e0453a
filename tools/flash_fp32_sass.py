#!/usr/bin/env python3
"""Does a kernel's fp32 instance compile to the same machine code in two
sources?

    python3 tools/flash_fp32_sass.py [--kernel NAME] OTHER_SOURCE [...]

NAME is flash_attention (the default), paged_prefill_attention, ssd_scan
or decode_attention. Compiles src/repro_torch/csrc/<NAME>.cu and each
OTHER_SOURCE (for example the parent commit's, unpacked with git archive
into build/parent) with nvcc for sm_90a into cubins under build/sass/,
disassembles them with cuobjdump -sass, and compares the fp32 instances
(flash_kernel at each tile width and load path, paged_prefill_kernel at
each tile width, load path and row-warp count, with or without the
element type as a template argument, ssd_kernel<RT, PT> at each row
tile and head width, with or without float as a third argument, or
decode_kernel<float, NC, VEC, R> at each lane width, load path and row
count)
instruction by instruction, with addresses, encodings and the anonymous
namespace's name left out. Prints one line per source and instance:
identical, or how many instructions differ. Needs the CUDA toolkit;
imports no JAX.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "sass"
# each kernel's fp32 device function: flash_kernel<DT, VEC> or
# paged_prefill_kernel<DT, VEC, RW>, or, where the template also takes the
# element type, the same with float first; ssd_kernel<RT, PT> (or
# <RT, PT, float>) outside the bf16 design's namespace; decode_kernel<float,
# NC, VEC, R>
FP32 = {"flash_attention": re.compile(r"flash_kernelI(?:f)?Li(\d+)ELb([01])E"),
        "paged_prefill_attention": re.compile(
            r"paged_prefill_kernelI(?:f)?Li(\d+)ELb([01])ELi(\d)E"),
        "ssd_scan": re.compile(r"ssd_kernelILi(\d+)ELi(\d+)Ef?E"),
        "decode_attention": re.compile(
            r"decode_kernelIfLi(\d)ELb([01])ELi(\d)E")}
# what each kernel's key names
KEY = {"flash_attention": "DT, vec",
       "paged_prefill_attention": "DT, vec, row warps",
       "ssd_scan": "rows, PT",
       "decode_attention": "lane columns, vec, rows"}


def sass(src: Path, tag: str, kernel: str = "flash_attention") -> dict:
    """{instance's template arguments: [instruction text]} of the fp32
    instances of ``kernel`` in src."""
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
            m = FP32[kernel].search(line)
            key = tuple(map(int, m.groups())) if m and "bf16" not in line \
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
    args, kernel = sys.argv[1:], "flash_attention"
    if args[:1] == ["--kernel"]:
        kernel, args = args[1], args[2:]
    mine = sass(CSRC / f"{kernel}.cu", "this", kernel)
    for i, other in enumerate(args):
        theirs = sass(Path(other), f"other{i}", kernel)
        for key in sorted(set(mine) | set(theirs)):
            a, b = mine.get(key), theirs.get(key)
            if a is None or b is None:
                what = f"missing in {'this' if a is None else other}"
            elif a == b:
                what = "identical"
            else:
                n = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
                what = f"{n} of {max(len(a), len(b))} instructions differ"
                first = next((i for i, (x, y) in enumerate(zip(a, b))
                              if x != y), None)
                if first is not None:
                    what += (f"; first at {first}: {a[first]!r} here, "
                             f"{b[first]!r} there")
            print(f"{other}: fp32 {kernel} instance {key} ({KEY[kernel]}): "
                  f"{len(a or [])} instructions here, {what}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
