#!/usr/bin/env python3
"""Designs of the SSD chunk kernel (K3) at chip_smoke.py's cases and on the
SSM paths' own calls, on one CUDA card.

Run from the root of a checkout:  python3 tools/ssd_variants.py [NAME ...]

Each variant is csrc/ssd_scan.cu compiled with a few -D flags
(``VARIANTS`` below: the kernel's knobs SSD_WARPS, SSD_KEY_TILE,
SSD_STAGES,
SSD_HEADS_LARGE, SSD_HEADS_SMALL, SSD_NT_LARGE, SSD_NT_SMALL and
SSD_STRIP_KEYS, and the ablations of SSD_SKIP, which are timed only), or
"parent": the same
file of a checkout unpacked with ``git archive`` into build/parent (its C
entry takes the same arguments; skipped where that file is missing). No
name runs them all; "shipped" is the source as it is. As in
tools/prefill_variants.py, whose helpers it shares: every variant is
compiled with nvcc into build/variants/ssd/<name>/ (all at once), its
registers and spills printed by instance, loaded in place of the built
kernel, checked against the plain version on each case of ``CASES``
(SSD_TOL relative to the plain outputs' scale), then timed in turns, twice
round: the CUDA-event time of back-to-back wrapper calls (what
chip_smoke.py reports), the host time of a wrapper call, and the kernel's
device time per call from torch.profiler.

Then the SSM paths' own K3 calls: one serve of chip_smoke.py phase 4c's
traffic through the pool and through the dense hybrid path records the
shape and strides of every call (tools/profile_ssm.py::record_k3_calls,
into build/replay/ssd_calls.pt, with the shipped kernel), and each
variant replays them in turns, three rounds, on random inputs of the same
layout (the work depends on the shapes and strides only): the device ms
summed over each path's calls. Prints the card's name and power limit,
then one JSON line per variant, case and round. It imports neither JAX
nor the JAX package.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "ssd_scan.cu"
PARENT = ROOT / "build" / "parent" / "src" / "repro_torch" / "csrc" / SRC

# chip_smoke.py's SSD cases timed: the dense path's chunks in the kernel's
# layout and in the model's (its strided views), and the pool's packed
# prefill
CASES = ("main", "model_layout", "pool")
# name: (-D flags, exact: the output must match the plain version[, source])
VARIANTS = {
    "shipped": ([], True),
    "parent": ([], True, PARENT),
    # 8 warps a block at 64-row tiles (16)
    "warps_8": (["-DSSD_WARPS=8"], True),
    # key tiles of 64 positions at l > 16 (32; 64 needs 266 KB at N = 256)
    "key_tile_64": (["-DSSD_KEY_TILE=64"], True),
    # three stages of copies in flight at 64-row tiles (two)
    "stages_3": (["-DSSD_STAGES=3"], True),
    # heads a block takes at l > 16 (8) and at l <= 16 (4)
    "heads_large_4": (["-DSSD_HEADS_LARGE=4"], True),
    "heads_large_12": (["-DSSD_HEADS_LARGE=12"], True),
    "heads_small_2": (["-DSSD_HEADS_SMALL=2"], True),
    "heads_small_8": (["-DSSD_HEADS_SMALL=8"], True),
    # state rows of a state role at l > 16 (64) and at l <= 16 (32)
    "nt_large_32": (["-DSSD_NT_LARGE=32"], True),
    "nt_large_128": (["-DSSD_NT_LARGE=128"], True),
    "nt_small_16": (["-DSSD_NT_SMALL=16"], True),
    "nt_small_64": (["-DSSD_NT_SMALL=64"], True),
    # a 128-key score strip (rows past 128 recompute their strip for each
    # round of heads)
    "strip_128": (["-DSSD_STRIP_KEYS=128"], True),
    # ablations, timed only: no y roles, no state roles, no products (the
    # copies, barriers and stores), no score strips
    "no_y": (["-DSSD_SKIP=1"], False),
    "no_state": (["-DSSD_SKIP=2"], False),
    "no_products": (["-DSSD_SKIP=4"], False),
    "no_strip": (["-DSSD_SKIP=8"], False),
    # the state roles alone: without products, without the copies of x
    # rows, of dA and dt, of both
    "no_x_split": (["-DSSD_SKIP=64"], False),
    "no_x_split_no_gates": (["-DSSD_SKIP=192"], False),
    "no_copies": (["-DSSD_SKIP=48"], False),
    "copies_only": (["-DSSD_SKIP=12"], False),
    "barriers_only": (["-DSSD_SKIP=60"], False),
    "no_stores": (["-DSSD_SKIP=256"], False),
    "empty": (["-DSSD_SKIP=3"], False),
    "state_no_products": (["-DSSD_SKIP=5"], False),
    "state_no_x_copies": (["-DSSD_SKIP=17"], False),
    "state_no_d_copies": (["-DSSD_SKIP=33"], False),
    "state_no_copies": (["-DSSD_SKIP=49"], False),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def instances(report: str) -> str:
    """ptxas's registers and spill stores by kernel instance, as
    "rows=<RT> P<=<PT>: N regs, S B spilled" (the parent's: "P<=<PT>")."""
    out = []
    for m in re.finditer(r"Compiling entry function '\w*ssd_kernelIL"
                         r"i(\d+)E(?:Li(\d+)E)?\w*'.*?Used (\d+) registers",
                         report, re.S):
        spill = re.search(r"(\d+) bytes spill stores", report[m.start():])
        shape = f"rows={m[1]} P<={m[2]}" if m[2] else f"P<={m[1]}"
        out.append(f"{shape}: {m[3]} regs, "
                   f"{spill[1] if spill else '?'} B spilled")
    return "; ".join(sorted(out))


def replay_inputs(torch, calls):
    """Inputs of each distinct call signature: random storage viewed
    through the recorded shapes and strides (x, B, C normal; dt in
    [0.01, 0.2); dA in (-1, 0])."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    draw = (lambda n: torch.randn(n, generator=g, device=dev),
            lambda n: 0.01 + 0.19 * torch.rand(n, generator=g, device=dev),
            lambda n: -torch.rand(n, generator=g, device=dev),
            lambda n: torch.randn(n, generator=g, device=dev),
            lambda n: torch.randn(n, generator=g, device=dev))
    out = {}
    for sig in dict.fromkeys(calls):
        out[sig] = tuple(
            draw[i](1 + sum((n - 1) * st for n, st in zip(shape, stride)))
            .as_strided(shape, stride)
            for i, (shape, stride) in enumerate(sig))
    return out


def replay(torch, profile_ssm, ops, name, calls, inputs) -> dict:
    """Device ms summed over each path's recorded calls, one replay each
    under the profiler."""
    out = {}
    for tag, seq in calls.items():
        _, by_name = profile_ssm._profiled(
            torch, f"../variants/ssd/{name}_{tag}",
            lambda: [ops.ssd_chunk(*inputs[sig]) for sig in seq])
        k3 = [v for k, v in by_name.items() if "ssd_kernel" in k]
        out[tag] = dict(calls=len(seq), launches=sum(v[0] for v in k3),
                        device_ms=sum(v[1] for v in k3))
    return out


def clocks_under_load(torch, fn, seconds=2.0) -> list:
    """The SM clock (MHz) and power draw (W) that nvidia-smi reads every
    100 ms while ``fn`` runs back to back for about ``seconds``."""
    import time
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate()
    return [[float(v) for v in line.split(",")] for line in
            out.strip().splitlines()[2:]]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ssd_variants: no CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    import prefill_variants as pv
    import profile_ssm
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    names = [n for n in (sys.argv[1:] or list(VARIANTS))
             if n != "parent" or PARENT.exists()]
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    build.build_all()
    calls = profile_ssm.record_k3_calls(torch, cs)
    libs = pv.compile_all(names, ROOT / "build" / "variants" / "ssd", SRC,
                          VARIANTS, instances)
    cases = {c["name"]: c for c in cs.ssd_cases(torch, torch.device("cuda"))
             if c["name"] in CASES}
    wants = {}
    for cname, case in cases.items():
        wants[cname] = case["plain"]()
        log(f"[{cname}] {case['desc']}; plain "
            f"{cs._time_ms(torch, case['plain']):.4f} ms; bound "
            f"{cs._bound(case['nbytes'], case['flops'])[0]:.4f} ms")
    tol = lambda scale: cs.SSD_TOL * max(1.0, scale)
    for rnd in range(2):
        for name in names:
            for cname, case in cases.items():
                r = pv.measure(torch, cs, ops, build, profile_ssm, name,
                               libs[name], case, wants[cname],
                               kernel="ssd_scan", piece="ssd_kernel",
                               exact=VARIANTS[name][1], tol=tol)
                log(json.dumps(dict(round=rnd, case=cname, **r)))
    if "shipped" in names:
        pv.load_variant(build, "ssd_scan", libs["shipped"])
        log(json.dumps(dict(clocks_mhz_watts_main=clocks_under_load(
            torch, cases["main"]["kernel"]))))
    inputs = replay_inputs(torch, [s for seq in calls.values() for s in seq])
    for rnd in range(3):
        for name in names:
            pv.load_variant(build, "ssd_scan", libs[name])
            log(json.dumps(dict(round=rnd, variant=name, replay=replay(
                torch, profile_ssm, ops, name, calls, inputs))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
