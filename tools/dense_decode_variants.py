#!/usr/bin/env python3
"""Designs of the dense decode kernel (K5) at chip_smoke.py's main and
gemma3 cases, on one CUDA card.

Run from the root of a checkout:  python3 tools/dense_decode_variants.py [NAME ...]

Each variant is csrc/decode_attention.cu compiled with a few -D flags
(``VARIANTS`` below: the kernel's knobs DENSE_SPLIT_KEYS, DENSE_WARPS,
DENSE_KEYS and DENSE_MIN_BLOCKS); no name runs them all, "shipped" is the
source as it is. As in tools/decode_variants.py, whose helpers it shares
through tools/prefill_variants.py: every variant is compiled with nvcc
into build/variants/dense_decode/<name>/ (all at once), its registers and
spills printed by instance, loaded in place of the built kernel (the
wrapper asks the loaded library for its workspace), checked against the
plain version on each case, then timed in turns, twice round: the
CUDA-event time of back-to-back wrapper calls, the host time of a wrapper
call, and the kernel's device time per call from torch.profiler. Prints
the card's name and power limit, then one JSON line per variant, case and
round. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "decode_attention.cu"

# chip_smoke.py's dense decode cases timed: the qwen main path's (G = 1,
# head_dim 128, 5 splits) and gemma3-4b's local layer (G = 2, head_dim 256,
# 17 splits of which 8 are masked)
CASES = ("main", "gemma3")
# name: (-D flags, exact: the output must match the plain version)
VARIANTS = {
    "shipped": ([], True),
    # keys a warp has in flight (at D = 128; half as many at D = 256)
    "keys_2": (["-DDENSE_KEYS=2"], True),
    "keys_4": (["-DDENSE_KEYS=4"], True),
    "keys_16": (["-DDENSE_KEYS=16"], True),
    # warps of a block: 8 warps take 16 keys each of a 128-key split
    "warps_8": (["-DDENSE_WARPS=8"], True),
    "warps_8_keys_4": (["-DDENSE_WARPS=8", "-DDENSE_KEYS=4"], True),
    # keys of a split: 64 (twice the blocks; 16- or 32-key slices) and 256
    # (8 warps of 32 keys)
    "split_64": (["-DDENSE_SPLIT_KEYS=64"], True),
    "split_64_warps_2": (["-DDENSE_SPLIT_KEYS=64", "-DDENSE_WARPS=2"], True),
    "split_256_warps_8": (["-DDENSE_SPLIT_KEYS=256", "-DDENSE_WARPS=8"],
                          True),
    # at least 4 blocks an SM (at most 128 registers a thread)
    "min_blocks_4": (["-DDENSE_MIN_BLOCKS=4"], True),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def instances(report: str) -> str:
    """ptxas's registers and spill stores by kernel instance, as
    "D<=<32 x lane columns> vec=<0|1> rows=<R>: N regs, S B spilled"."""
    out = []
    for m in re.finditer(r"Compiling entry function '\w*?[0-9]decode_kernel"
                         r"ILi(\d)ELb([01])ELi(\d)E\w*'.*?Used (\d+) "
                         r"registers", report, re.S):
        spill = re.search(r"(\d+) bytes spill stores", report[m.start():])
        out.append(f"D<={32 * int(m[1])} vec={m[2]} rows={m[3]}: {m[4]} "
                   f"regs, {spill[1] if spill else '?'} B spilled")
    return "; ".join(sorted(out))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dense_decode_variants: no CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    import prefill_variants as pv
    import profile_ssm
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    out_root = ROOT / "build" / "variants" / "dense_decode"
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    libs = pv.compile_all(names, out_root, SRC, VARIANTS, instances)
    cases = {c["name"]: c for c in cs.dense_decode_cases(
        torch, torch.device("cuda")) if c["name"] in CASES}
    wants = {}
    for cname, case in cases.items():
        wants[cname] = case["plain"]()
        log(f"[{cname}] {case['desc']}; bound "
            f"{cs._bound(case['nbytes'], case['flops'])[0]:.4f} ms")
    for rnd in range(2):
        for name in names:
            for cname, case in cases.items():
                r = pv.measure(torch, cs, ops, build, profile_ssm, name,
                               libs[name], case, wants[cname],
                               kernel="decode_attention",
                               piece="decode_kernel",
                               exact=VARIANTS[name][1])
                log(json.dumps(dict(round=rnd, case=cname, **r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
