#!/usr/bin/env python3
"""Designs of the paged prefill kernel (K2) at chip_smoke.py's main case,
on one CUDA card.

Run from the root of a checkout:  python3 tools/prefill_variants.py [NAME ...]

Each variant is csrc/paged_prefill_attention.cu compiled with a few -D
flags (``VARIANTS`` below: the kernel's knobs PREFILL_SPLIT_KEYS,
PREFILL_STAGES, PREFILL_KEY_TILE, PREFILL_MIN_BLOCKS, the ablations of
PREFILL_SKIP, and the clocks by phase of PREFILL_PHASES with
tools/prefill_phases.cuh); no name runs them all, "shipped" is the source
as it is. Every variant is compiled with nvcc into build/variants/<name>/
(all at once), loaded in place of the built kernel (the wrapper asks the
loaded library for its shared memory and workspace), checked against the
plain version on the main case (a variant that drops work is marked so and
only timed), then timed in turns, twice round: the CUDA-event time of
back-to-back wrapper calls (what chip_smoke.py reports), the host time of
a wrapper call, and the kernel's device time per call from
torch.profiler. Prints the card's name and power limit, then one JSON
line per variant and round. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "paged_prefill_attention.cu"
PHASE_NAMES = ("setup to page ids", "Q split to loop", "copy issue + wait",
               "products + barrier", "warp merge + stores", "split merge")

# name: (-D flags, exact: the output must match the plain version)
VARIANTS = {
    "shipped": ([], True),
    "split_64": (["-DPREFILL_SPLIT_KEYS=64"], True),
    "split_256": (["-DPREFILL_SPLIT_KEYS=256"], True),
    "split_512": (["-DPREFILL_SPLIT_KEYS=512"], True),
    "split_1024": (["-DPREFILL_SPLIT_KEYS=1024"], True),
    # one stage (the next tile is copied after this one is used: 50.7 KB,
    # 3 blocks an SM at D = 128) or three (118 KB, 1 block)
    "stages_1": (["-DPREFILL_STAGES=1"], True),
    "stages_3": (["-DPREFILL_STAGES=3"], True),
    # one stage at 4 blocks an SM (at most 128 registers a thread)
    "stages_1_x4": (["-DPREFILL_STAGES=1", "-DPREFILL_MIN_BLOCKS=4"], True),
    # 64-key tiles (16 keys a warp at 16 rows) at D <= 128, one stage (the
    # same shared memory as two of 32) or two
    "tile64_1stage": (["-DPREFILL_KEY_TILE=64", "-DPREFILL_STAGES=1"], True),
    "tile64_2stage": (["-DPREFILL_KEY_TILE=64"], True),
    # ablations, timed only: no Q K^T, no P V (their loads and splits fall
    # away with them), no products (copies, merges, stores)
    "no_qk": (["-DPREFILL_SKIP=1"], False),
    "no_pv": (["-DPREFILL_SKIP=2"], False),
    "no_products": (["-DPREFILL_SKIP=4"], False),
    "phases": (["-DPREFILL_PHASES", "-I", str(ROOT / "tools")], True),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def instances(report: str) -> str:
    """ptxas's registers and spill stores by kernel instance, as
    "D=<head tile> vec=<0|1> rows=<16 x row warps>: N regs, S B spilled"."""
    out = []
    for m in re.finditer(r"Compiling entry function '\w*paged_prefill_kernel"
                         r"ILi(\d+)ELb([01])ELi(\d)E\w*'.*?Used (\d+) "
                         r"registers", report, re.S):
        spill = re.search(r"(\d+) bytes spill stores", report[m.start():])
        out.append(f"D={m[1]} vec={m[2]} rows={16 * int(m[3])}: {m[4]} regs, "
                   f"{spill[1] if spill else '?'} B spilled")
    return "; ".join(sorted(out))


def compile_all(names, out_root: Path, src=SRC, variants=VARIANTS,
                report_of=instances) -> dict:
    """Each variant of ``variants`` named in ``names``, compiled from
    csrc/``src`` (or the source path a variant's third element names)
    with its -D flags into out_root/<name>/, all at once; logs
    ``report_of(ptxas report)`` for each."""
    from repro_torch.kernels import build
    nvcc, procs = build._nvcc(), {}
    for name in names:
        d = out_root / name
        d.mkdir(parents=True, exist_ok=True)
        lib = d / "libvariant.so"
        path = variants[name][2] if len(variants[name]) > 2 \
            else build.CSRC / src
        procs[name] = (subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, *variants[name][0], "-o", str(lib),
             str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{src}: variant {name} failed:\n{report}")
        log(f"[build] {name}: {report_of(report)}")
        libs[name] = lib
    return libs


def load_variant(build, kernel, lib) -> None:
    """The library ``lib`` loaded in place of the built ``kernel``."""
    from repro_torch.kernels import common
    build._libs[kernel] = ctypes.CDLL(str(lib))
    common._entries.clear()
    common.query.cache_clear()


def measure(torch, cs, ops, build, profile_ssm, name, lib, case, want,
            kernel="paged_prefill_attention", piece="paged_prefill_kernel",
            exact=None, tol=None):
    """One variant's library loaded in place of the built ``kernel``,
    checked (where ``exact``, by default its VARIANTS entry says so) and
    timed; ``piece``: a piece of its device kernels' names. The error is
    the largest over the outputs (``cs._max_err``), held to ``tol(scale
    of the plain outputs)`` (default KERNEL_TOL)."""
    exact = VARIANTS[name][1] if exact is None else exact
    load_variant(build, kernel, lib)
    got = case["kernel"]()
    torch.cuda.synchronize()
    err, scale = cs._max_err(got, want)
    if exact and not err <= (cs.KERNEL_TOL if tol is None else tol(scale)):
        raise AssertionError(f"{name}: max abs err {err}")
    ms = cs._time_ms(torch, case["kernel"])
    n = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        case["kernel"]()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    _, by_name = profile_ssm._profiled(
        torch, f"../variants/{name}", lambda: [case["kernel"]()
                                               for _ in range(n)])
    device = sum(v[1] for k, v in by_name.items() if piece in k) / n
    return dict(variant=name, ms=ms, host_ms=host_ms, device_ms=device,
                max_abs_err=err, exact=exact)


def phase_report(torch, lib, case) -> dict:
    """One launch of the instrumented kernel: each phase's clocks per
    working block (mean, and its share of all phases), and the span of the
    launch on the global timer."""
    import numpy as np
    read = ctypes.CDLL(str(lib)).read_phases
    read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    buf = np.zeros(10 * 16384, np.int64)
    n = ctypes.c_uint(0)
    read(buf.ctypes.data, ctypes.byref(n))   # clear
    case["kernel"]()
    torch.cuda.synchronize()
    read(buf.ctypes.data, ctypes.byref(n))
    rec = buf[:10 * n.value].reshape(-1, 10)
    clocks = rec[:, :6].astype(float)
    total = clocks.sum()
    out = dict(blocks=int(n.value), tiles_mean=float(rec[:, 6].mean()),
               single_share=float(rec[:, 7].mean()),
               span_us=float(rec[:, 9].max() - rec[:, 8].min()) / 1e3,
               block_us_mean=float((rec[:, 9] - rec[:, 8]).mean()) / 1e3)
    for i, name in enumerate(PHASE_NAMES):
        out[name] = dict(clocks_mean=float(clocks[:, i].mean()),
                         share=float(clocks[:, i].sum() / total))
    return out


def read_rates(torch, cs, case) -> dict:
    """What the card's memory gives for the main case's pool: TB/s of a
    copy of every page (contiguous), of half the heads of every key row
    (10 KB runs at K = 40, D = 128) and of every other head (the 512-byte
    runs of one head's key rows that the kernel reads), counting bytes read
    and written."""
    kp = case["args"][1]
    P, ps, K, D = kp.shape
    x = kp.view(P * ps, K, D)
    out = {}
    for name, fn in (("whole_pages", lambda: x.clone()),
                     ("half_heads_runs", lambda: x[:, :K // 2].contiguous()),
                     ("alternate_heads", lambda: x[:, ::2].contiguous())):
        ms = cs._time_ms(torch, fn)
        nbytes = 2 * fn().numel() * 4
        out[name] = dict(ms=ms, tb_per_s=nbytes / ms / 1e9)
    return out


def _host_us(fn, n=200) -> float:
    """Host microseconds a call of ``fn``, over ``n`` calls back to
    back."""
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e6 / n


def host_breakdown(torch, ops, case_args, kw):
    """Host microseconds per wrapper call, and of its parts: the input
    checks, the two geometry queries (cached), the two allocations, the C
    call on ready buffers."""
    from repro_torch.kernels import common
    q, kp, vp, pt, start, total = case_args
    B, K, C, G, D = q.shape
    ps, MP, end = kp.shape[1], pt.shape[1], kw["pages_bound"]
    n = common.query(ops.NAME, "paged_prefill_workspace_bytes", B, K, C, G,
                     D, ps, 0, end)
    out = torch.empty_like(q)
    ws = torch.empty(n, dtype=torch.uint8, device=q.device)
    parts = dict(
        wrapper=lambda: ops.paged_prefill_attention_gqa(*case_args, **kw),
        checks=lambda: common.check_inputs(
            "p", {"q": q, "k_pages": kp, "v_pages": vp},
            {"page_table": pt, "start": start, "total": total}),
        queries=lambda: (
            common.query(ops.NAME, "paged_prefill_smem_bytes", C, G, D),
            common.query(ops.NAME, "paged_prefill_workspace_bytes", B, K, C,
                         G, D, ps, 0, end)),
        allocations=lambda: (torch.empty_like(q), torch.empty(
            n, dtype=torch.uint8, device=q.device)),
        c_call=lambda: common.launch(
            ops.NAME, "paged_prefill_attention_f32", q, kp, vp, pt, start,
            total, out, ws, B, K, C, G, D, ps, MP, 0, end, 0),
        current_stream=lambda: torch.cuda.current_stream().cuda_stream,
    )
    res = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        res[name] = _host_us(fn)
        torch.cuda.synchronize()
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prefill_variants: no CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    import profile_ssm
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_prefill_attention import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    out_root = ROOT / "build" / "variants"
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    libs = compile_all(names, out_root)
    case = next(c for c in cs.prefill_cases(torch, torch.device("cuda"))
                if c["name"] == "main")
    want = case["plain"]()
    log(f"[main] {case['desc']}; plain {cs._time_ms(torch, case['plain']):.4f}"
        " ms")
    log(json.dumps(dict(read_rates=read_rates(torch, cs, case))))
    log(json.dumps(dict(host_us=host_breakdown(
        torch, ops, case["args"], case["kw"]))))
    for rnd in range(2):
        for name in names:
            r = measure(torch, cs, ops, build, profile_ssm, name, libs[name],
                        case, want)
            log(json.dumps(dict(round=rnd, **r)))
            if name == "phases" and rnd == 0:
                log(json.dumps(dict(phases=phase_report(torch, libs[name],
                                                        case))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
