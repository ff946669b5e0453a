#!/usr/bin/env python3
"""Designs of the dense decode kernel (K5) at chip_smoke.py's cases, on
one CUDA card.

Run from the root of a checkout:

    python3 tools/dense_decode_variants.py [--case NAME[,NAME...]] [VARIANT ...]

The cases are "main" and "gemma3" by default; "<name>_bf16" cases time the
bf16 design (decode_attention_bf16), each variant first held to BF16_TOL
of the plain version (allclose). Each variant is csrc/decode_attention.cu
compiled with a few -D flags (``VARIANTS`` below: the fp32 design's knobs
DENSE_SPLIT_KEYS, DENSE_WARPS, DENSE_KEYS and DENSE_MIN_BLOCKS; the bf16
design's DENSE_BF16_WARPS, DENSE_BF16_MIN_BLOCKS, DENSE_BF16_SHARE_256
and the ablations of DENSE_BF16_SKIP); no name runs them all but "parent",
"shipped" is the source as it is and "parent" the source under
build/parent (the parent commit unpacked with git archive). As in
tools/decode_variants.py, whose helpers it shares through
tools/prefill_variants.py: every variant is compiled with nvcc into
build/variants/dense_decode/<name>/ (all at once), its registers and
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

# chip_smoke.py's dense decode cases timed by default: the qwen main
# path's (G = 1, head_dim 128, 5 splits) and gemma3-4b's local layer (G = 2,
# head_dim 256, 17 splits of which 8 are masked)
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
    # (8 warps of 32 keys in both designs: half the partials)
    "split_64": (["-DDENSE_SPLIT_KEYS=64"], True),
    "split_64_warps_2": (["-DDENSE_SPLIT_KEYS=64", "-DDENSE_WARPS=2"], True),
    "split_256_warps_8": (["-DDENSE_SPLIT_KEYS=256", "-DDENSE_WARPS=8",
                           "-DDENSE_BF16_WARPS=8"], True),
    # at least 4 blocks an SM (at most 128 registers a thread)
    "min_blocks_4": (["-DDENSE_MIN_BLOCKS=4"], True),
    # the bf16 design: 8 warps of 16-key slices; registers for 1, 2 or 4
    # blocks an SM at D <= 128 (shipped: 3, which shared memory holds at D
    # = 128)
    "bf16_warps_8": (["-DDENSE_BF16_WARPS=8"], True),
    "bf16_min_blocks_1": (["-DDENSE_BF16_MIN_BLOCKS=1"], True),
    "bf16_min_blocks_2": (["-DDENSE_BF16_MIN_BLOCKS=2"], True),
    "bf16_min_blocks_4": (["-DDENSE_BF16_MIN_BLOCKS=4"], True),
    # at D = 256, V's rows in their own shared memory (136 KB a block: one
    # block an SM), not copied into K's after the scores
    "bf16_share_256_0": (["-DDENSE_BF16_SHARE_256=0"], True),
    # ablations, timed only: no Q K^T, no P V
    "bf16_no_qk": (["-DDENSE_BF16_SKIP=1"], False),
    "bf16_no_pv": (["-DDENSE_BF16_SKIP=2"], False),
    # no split merge (the last block stores nothing); no partials (a
    # split's block stops after its warps' merge)
    "bf16_no_merge": (["-DDENSE_BF16_SKIP=4"], False),
    "bf16_no_partials": (["-DDENSE_BF16_SKIP=8"], False),
    # the parent commit's source, timed in the same turns; run only where
    # named
    "parent": ([], True, ROOT / "build" / "parent" / "src" / "repro_torch" /
               "csrc" / SRC),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def instances(report: str) -> str:
    """ptxas's registers and spill stores by kernel instance: the fp32
    design's as "<fp32|bf16> D<=<32 x lane columns> vec=<0|1> rows=<R>",
    the bf16 design's as "bf16 design D=<head tile> vec=<0|1>"; then ": N
    regs, S B spilled"."""
    out = []
    for m in re.finditer(r"Compiling entry function '\w*?decode_kernel"
                         r"(?:I(f|13__nv_bfloat16)Li(\d)ELb([01])ELi(\d)E|"
                         r"_bf16ILi(\d+)ELb([01])E)\w*'.*?Used (\d+) "
                         r"registers", report, re.S):
        spill = re.search(r"(\d+) bytes spill stores", report[m.start():])
        if m[5]:
            what = f"bf16 design D={m[5]} vec={m[6]}"
        else:
            what = (f"{'fp32' if m[1] == 'f' else 'bf16'} "
                    f"D<={32 * int(m[2])} vec={m[3]} rows={m[4]}")
        out.append(f"{what}: {m[7]} regs, {spill[1] if spill else '?'} B "
                   "spilled")
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
    args, case_names = sys.argv[1:], CASES
    if args[:1] == ["--case"]:
        case_names, args = tuple(args[1].split(",")), args[2:]
    names = args or [n for n in VARIANTS if n != "parent"]
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    out_root = ROOT / "build" / "variants" / "dense_decode"
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    libs = pv.compile_all(names, out_root, SRC, VARIANTS, instances)
    cases = {c["name"]: c for c in cs.dense_decode_cases(
        torch, torch.device("cuda")) if c["name"] in case_names}
    wants = {}
    for cname, case in cases.items():
        wants[cname] = case["plain"]()
        peak = cs.PEAK_BF16_FLOP_PER_S if case["bf16"] \
            else cs.PEAK_FP32_FLOP_PER_S
        log(f"[{cname}] {case['desc']}; bound "
            f"{cs._bound(case['nbytes'], case['flops'], peak)[0]:.4f} ms")
        if case["bf16"]:   # each variant within BF16_TOL, checked here
            for name in names:
                pv.load_variant(build, "decode_attention", libs[name])
                got = case["kernel"]()
                torch.cuda.synchronize()
                excess = cs._bf16_excess(got, wants[cname])
                err, _ = cs._max_err(got.float(), wants[cname].float())
                log(f"[check] {cname} {name}: allclose excess {excess:.3g},"
                    f" max abs err {err:.3g}")
                if VARIANTS[name][1] and not excess <= cs.BF16_TOL:
                    raise AssertionError(f"{name}: excess {excess}")
    for rnd in range(2):
        for name in names:
            for cname, case in cases.items():
                r = pv.measure(torch, cs, ops, build, profile_ssm, name,
                               libs[name], case, wants[cname],
                               kernel="decode_attention",
                               piece="decode_kernel",
                               exact=VARIANTS[name][1] and not case["bf16"])
                log(json.dumps(dict(round=rnd, case=cname, **r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
