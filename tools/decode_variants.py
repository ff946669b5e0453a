#!/usr/bin/env python3
"""Designs of the paged decode kernel (K1) at chip_smoke.py's main case
and two beside it, on one CUDA card.

Run from the root of a checkout:  python3 tools/decode_variants.py [NAME ...]

Each variant is csrc/paged_decode_attention.cu compiled with a few -D
flags (``VARIANTS`` below: the kernel's knobs DECODE_SPLIT_KEYS,
DECODE_WARPS, DECODE_KEYS, DECODE_STAGES and DECODE_MIN_BLOCKS); no name
runs them all, "shipped" is the source as it is. As in
tools/prefill_variants.py, whose helpers it shares: every variant is
compiled with nvcc into build/variants/decode/<name>/ (all at once), its
registers and spills printed by instance, loaded in place of the built
kernel (the wrapper asks the loaded library for its shared memory and
workspace), checked against the plain version on each case of
``CASES``, then timed in turns, twice round: the CUDA-event time of
back-to-back wrapper calls (what chip_smoke.py reports), the host time of
a wrapper call, and the kernel's device time per call from
torch.profiler. Also prints what
a copy of the main case's pool runs at and the host microseconds of a
wrapper call by part. Prints the card's name and power limit, then one
JSON line per variant, case and round. It imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "paged_decode_attention.cu"

# chip_smoke.py's decode cases timed: the main path's, GQA (8 rows a
# block) and gemma3-4b's heads (head_dim 256, G = 2)
CASES = ("main", "gqa", "head_dim_256")
# name: (-D flags, exact: the output must match the plain version)
VARIANTS = {
    "shipped": ([], True),
    "split_64": (["-DDECODE_SPLIT_KEYS=64"], True),
    "split_256": (["-DDECODE_SPLIT_KEYS=256"], True),
    "split_512": (["-DDECODE_SPLIT_KEYS=512"], True),
    # warps of a block: 8 warps take 16 keys each of a 128-key split
    "warps_2": (["-DDECODE_WARPS=2"], True),
    "warps_8": (["-DDECODE_WARPS=8"], True),
    # keys a warp has in flight (at D = 128): 2, 8 or 16 in one stage; two
    # stages of 4 or of 8 (the next stage's loads issued before this one is
    # used)
    "keys_2": (["-DDECODE_KEYS=2"], True),
    "keys_8": (["-DDECODE_KEYS=8"], True),
    "keys_16": (["-DDECODE_KEYS=16"], True),
    "stages_2_keys_4": (["-DDECODE_STAGES=2"], True),
    "stages_2_keys_8": (["-DDECODE_STAGES=2", "-DDECODE_KEYS=8"], True),
    # at least 4 blocks an SM (at most 128 registers a thread)
    "min_blocks_4": (["-DDECODE_MIN_BLOCKS=4"], True),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def instances(report: str) -> str:
    """ptxas's registers and spill stores by kernel instance, as
    "D<=<32 x lane columns> vec=<0|1> rows=<R>: N regs, S B spilled"."""
    out = []
    for m in re.finditer(r"Compiling entry function '\w*paged_decode_kernel"
                         r"ILi(\d)ELb([01])ELi(\d)E\w*'.*?Used (\d+) "
                         r"registers", report, re.S):
        spill = re.search(r"(\d+) bytes spill stores", report[m.start():])
        out.append(f"D<={32 * int(m[1])} vec={m[2]} rows={m[3]}: {m[4]} "
                   f"regs, {spill[1] if spill else '?'} B spilled")
    return "; ".join(sorted(out))


def host_breakdown(torch, ops, case_args, kw):
    """Host microseconds per wrapper call, and of its parts: the input
    checks, the workspace query (cached), the two allocations, the C call
    on ready buffers."""
    import prefill_variants as pv
    from repro_torch.kernels import common
    q, kp, vp, pt, lens = case_args
    B, K, G, D = q.shape
    ps, MP, end = kp.shape[1], pt.shape[1], kw["pages_bound"]
    n = common.query(ops.NAME, "paged_decode_workspace_bytes", B, K, G, D,
                     ps, 0, end)
    out = torch.empty_like(q)
    ws = torch.empty(n, dtype=torch.uint8, device=q.device)
    parts = dict(
        wrapper=lambda: ops.paged_decode_attention_gqa(*case_args, **kw),
        checks=lambda: common.check_inputs(
            "p", {"q": q, "k_pages": kp, "v_pages": vp},
            {"page_table": pt, "seq_lens": lens}),
        query=lambda: common.query(ops.NAME, "paged_decode_workspace_bytes",
                                   B, K, G, D, ps, 0, end),
        allocations=lambda: (torch.empty_like(q), torch.empty(
            n, dtype=torch.uint8, device=q.device)),
        c_call=lambda: common.launch(
            ops.NAME, "paged_decode_attention_f32", q, kp, vp, pt, lens, out,
            ws, B, K, G, D, ps, MP, 0, end, 0),
    )
    res = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        res[name] = pv._host_us(fn)
        torch.cuda.synchronize()
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_variants: no CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    import prefill_variants as pv
    import profile_ssm
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_decode_attention import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    out_root = ROOT / "build" / "variants" / "decode"
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    libs = pv.compile_all(names, out_root, SRC, VARIANTS, instances)
    cases = {c["name"]: c for c in cs.decode_cases(torch, torch.device(
        "cuda")) if c["name"] in CASES}
    wants = {}
    for cname, case in cases.items():
        wants[cname] = case["plain"]()
        log(f"[{cname}] {case['desc']}; plain "
            f"{cs._time_ms(torch, case['plain']):.4f} ms; bound "
            f"{cs._bound(case['nbytes'], case['flops'])[0]:.4f} ms")
    main = cases["main"]
    log(json.dumps(dict(read_rates=pv.read_rates(torch, cs, main))))
    log(json.dumps(dict(host_us=host_breakdown(
        torch, ops, main["args"], main["kw"]))))
    for rnd in range(2):
        for name in names:
            for cname, case in cases.items():
                r = pv.measure(torch, cs, ops, build, profile_ssm, name,
                               libs[name], case, wants[cname],
                               kernel="paged_decode_attention",
                               piece="paged_decode_kernel",
                               exact=VARIANTS[name][1])
                log(json.dumps(dict(round=rnd, case=cname, **r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
