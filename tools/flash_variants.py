#!/usr/bin/env python3
"""Designs of the flash-attention kernel's bf16 instance (K4 at bf16) at
chip_smoke.py's bf16 flash cases, on one CUDA card.

Run from the root of a checkout:  python3 tools/flash_variants.py [NAME ...]

Each variant is csrc/flash_attention.cu compiled with a few -D flags
(``VARIANTS`` below: the bf16 design's knobs FLASH_BF16_STAGES,
FLASH_BF16_KEYS, FLASH_BF16_KEYS_256, FLASH_BF16_MT and
FLASH_BF16_MT_128); no name runs them all, "shipped" is the
source as it is, "parent" the source under build/parent (named only). As
in tools/dense_decode_variants.py, whose helpers it shares through
tools/prefill_variants.py: every variant is compiled with nvcc into
build/variants/flash/<name>/ (all at once), its registers and spills
printed by instance, loaded in place of the built kernel, checked against
the plain version at bf16 on every bf16 flash case of chip_smoke.py
(allclose within BF16_TOL), then timed in turns, twice round, on the timed
cases: the CUDA-event time of back-to-back wrapper calls, the host time of
a wrapper call, and the kernel's device time per call from torch.profiler.
Prints the card's name and power limit, then one JSON line per variant,
case and round. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "flash_attention.cu"

# name: (-D flags, exact: the output must be within BF16_TOL)
VARIANTS = {
    "shipped": ([], True),
    # K/V stages of the cp.async ring
    "stages_3": (["-DFLASH_BF16_STAGES=3"], True),
    # keys a tile at D <= 128
    "keys_32": (["-DFLASH_BF16_KEYS=32"], True),
    "keys_32_stages_3": (["-DFLASH_BF16_KEYS=32", "-DFLASH_BF16_STAGES=3"],
                         True),
    "keys_128": (["-DFLASH_BF16_KEYS=128"], True),
    # m16 tiles a warp at DT <= 64 and at DT = 128 (shipped: 2 at both):
    # two let each K and V fragment feed two products
    "mt_1": (["-DFLASH_BF16_MT=1"], True),
    "mt128_1": (["-DFLASH_BF16_MT_128=1"], True),
    # keys a tile at D = 256
    "keys_256_16": (["-DFLASH_BF16_KEYS_256=16"], True),
    "keys_256_64": (["-DFLASH_BF16_KEYS_256=64"], True),
    # the parent commit's source (unpacked with git archive into
    # build/parent), timed in the same turns; run only where named
    "parent": ([], True, ROOT / "build" / "parent" / "src" / "repro_torch" /
               "csrc" / SRC),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def instances(report: str) -> str:
    """ptxas's registers and spill stores by kernel instance, as
    "<bf16|fp32> D<=<DT> vec=<0|1>: N regs, S B spilled"."""
    out = []
    for m in re.finditer(r"Compiling entry function '\w*?(flash_kernel_bf16|"
                         r"flash_kernel)ILi(\d+)ELb([01])E\w*'.*?Used (\d+) "
                         r"registers", report, re.S):
        spill = re.search(r"(\d+) bytes spill stores", report[m.start():])
        dtype = "bf16" if m[1].endswith("bf16") else "fp32"
        out.append(f"{dtype} D<={m[2]} vec={m[3]}: {m[4]} regs, "
                   f"{spill[1] if spill else '?'} B spilled")
    return "; ".join(sorted(out))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    import prefill_variants as pv
    import profile_ssm
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or [n for n in VARIANTS if n != "parent"]
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    out_root = ROOT / "build" / "variants" / "flash"
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    libs = pv.compile_all(names, out_root, SRC, VARIANTS, instances)
    cases = {c["name"]: c for c in cs.flash_cases(
        torch, torch.device("cuda")) if c["bf16"]}
    wants = {name: case["plain"]() for name, case in cases.items()}
    for name in names:   # every bf16 case within BF16_TOL, once
        pv.load_variant(build, "flash_attention", libs[name])
        for cname, case in cases.items():
            got = case["kernel"]()
            torch.cuda.synchronize()
            excess = cs._bf16_excess(got, wants[cname])
            log(f"[check] {name} {cname}: allclose excess {excess:.3g}")
            if VARIANTS[name][1] and not excess <= cs.BF16_TOL:
                raise AssertionError(f"{name} {cname}: excess {excess}")
    timed = {n: c for n, c in cases.items() if c["timed"]}
    for cname, case in timed.items():
        bound_ms, _ = cs._bound(case["nbytes"], case["flops"],
                                cs.PEAK_BF16_FLOP_PER_S)
        log(f"[{cname}] {case['desc']}; bound {bound_ms:.4f} ms; SDPA "
            f"{cs._time_ms(torch, case['library']):.4f} ms")
    for rnd in range(2):
        for name in names:
            for cname, case in timed.items():
                r = pv.measure(torch, cs, ops, build, profile_ssm, name,
                               libs[name], case, wants[cname],
                               kernel="flash_attention",
                               piece="flash_kernel", exact=False)
                log(json.dumps(dict(round=rnd, case=cname, **r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
