#!/usr/bin/env python3
"""Time one kernel's case of chip_smoke.py in several checkouts, in turns,
on one card.

    python3 tools/compare_kernel.py flash_attention PARENT . . PARENT
    python3 tools/compare_kernel.py decode_attention --case gemma3 PARENT . . PARENT

``flash_attention`` names a row of chip_smoke.py's ``KERNELS``; ``--case``
one of its cases ("main" by default), or several joined by commas (timed
one after another in each checkout's process); each further argument is the root of
a checkout (for example the parent commit unpacked with ``git archive``
into a directory that .gitignore lists). Each checkout runs in a process
of its own, in the order given: it builds its own kernels, checks the
kernel against its plain version on the case, and times the kernel, its
plain version and the library call (where the case has one) with
chip_smoke.py's CUDA-event timer, so that a kernel without a library call
still has a yardstick measured beside it; the host time of a wrapper call;
the kernel's device time per call from torch.profiler, with that of any
memset the wrapper call makes (events around back-to-back calls of a
kernel shorter than its wrapper's host time time the host); and, where
the case has a library call, that call's own device time per call (every
kernel, memset and copy it launches, summed: ``library_device_ms``).
Prints the card's name and power limit, then one JSON line per checkout
and case.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


# a piece of each kernel's device name, for its profiler time
DEVICE_NAME = {"paged_decode_attention": "paged_decode_kernel",
               "paged_prefill_attention": "paged_prefill_kernel",
               "flash_attention": "flash_kernel",
               "decode_attention": "decode_kernel",
               "ssd_chunk_scan": "ssd_kernel"}


def run_one(kernel: str, case_name: str, tree: str) -> None:
    root = Path(tree).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernel: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    (make_cases,) = [k[3] for k in cs.KERNELS if k[0] == kernel]
    cases = {c["name"]: c for c in make_cases(torch, torch.device("cuda"))}
    for name in case_name.split(","):
        time_case(torch, cs, kernel, name, cases[name], tree)


def all_device_ms(torch, fn, n=20) -> float:
    """Device time per call of everything ``fn`` launches, summed, from
    torch.profiler over ``n`` calls back to back."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0) or
                getattr(e, "cuda_time_total", 0.0)
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return total / 1e3 / n


def time_case(torch, cs, kernel, case_name, case, tree) -> None:
    got = case["kernel"]()
    torch.cuda.synchronize()
    err, _ = cs._max_err(got, case["plain"]())
    ms = cs._time_ms(torch, case["kernel"])
    plain_ms = cs._time_ms(torch, case["plain"])
    lib = cs._time_ms(torch, case["library"]) if case["library"] else None
    lib_device = all_device_ms(torch, case["library"]) \
        if case["library"] else None
    # host time of a wrapper call, over 200 calls back to back
    t0 = time.perf_counter()
    for _ in range(200):
        case["kernel"]()
    host_us = (time.perf_counter() - t0) * 1e6 / 200
    torch.cuda.synchronize()
    device_ms = cs._device_ms(torch, case["kernel"], DEVICE_NAME[kernel])
    memset_ms = cs._device_ms(torch, case["kernel"], "Memset (Device)")
    print(json.dumps(dict(tree=tree, kernel=kernel, case=case_name, ms=ms,
                          device_ms=device_ms, memset_ms=memset_ms,
                          plain_ms=plain_ms, library_ms=lib,
                          library_device_ms=lib_device, host_us=host_us,
                          max_abs_err=err)), flush=True)


def main() -> int:
    if sys.argv[1] == "--one":
        run_one(*sys.argv[2:5])
        return 0
    kernel, trees, case_name = sys.argv[1], sys.argv[2:], "main"
    if trees[:1] == ["--case"]:
        case_name, trees = trees[1], trees[2:]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--one", kernel,
                        case_name, tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
