#!/usr/bin/env python3
"""Where the time goes on the port's qwen paths, on one CUDA card.

Run from the root of a checkout:  python3 tools/profile_qwen.py

chip_smoke.py phase 4's and 4b's traffic: two qwen1.5-32b tiers ("full":
every width at 4 layers; "half": scaled_sibling(., 2) at 2 layers) behind
a router at DeBERTa-v3-large's widths, 16 prompts of 32-512 tokens, 32 new
tokens each, through the routed pool (paged K1, K2) and through the dense
hybrid path (K4, K5). For each: a warm-up serve, a timed serve (wall time,
host clock around work that ends in a synchronize), and a serve traced
with torch.profiler, device activity only (tracing host ops too slows the
serve): the device's busy time (the union of kernel intervals), its idle
share against the timed serve's wall, device time by kernel, largest
first, and the paged kernels' shares of the busy time. Then one more
serve of each path traced with host ops and their shapes, to name the
host op that launched each of the largest kernels.

The traces go to build/profile/ (ignored by git); the last line of the
output is one JSON object with every number. It imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the port's kernels, by a piece of their device names
KERNELS = {"K1 paged decode": "paged_decode_kernel",
           "K2 paged prefill": "paged_prefill_kernel",
           "K4 flash prefill": "flash_kernel",
           "K5 dense decode": "decode_kernel"}


def log(msg: str) -> None:
    print(msg, flush=True)


def _kernel_of(name: str):
    for k, piece in KERNELS.items():
        if piece in name and not (piece == "decode_kernel"
                                  and "paged_decode_kernel" in name):
            return k
    return None


def _launching_ops(trace: Path, names) -> dict:
    """{kernel name: sorted [(host op, input shapes, launches)]}: the
    innermost host op around the runtime call that launched each kernel
    of ``names``, from a trace with host ops and shapes."""
    import bisect
    events = json.loads(trace.read_text())["traceEvents"]
    ops, launch_at = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "cpu_op":
            ops.setdefault(e["tid"], []).append(e)
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            launch_at[e["args"]["correlation"]] = e
    starts = {}
    for tid, lst in ops.items():
        lst.sort(key=lambda e: e["ts"])
        starts[tid] = [e["ts"] for e in lst]
    found = {}
    for e in events:
        if e.get("cat") != "kernel" or e.get("name") not in names:
            continue
        rt = launch_at.get(e.get("args", {}).get("correlation"))
        if rt is None or rt["tid"] not in ops:
            continue
        lst = ops[rt["tid"]]
        # host ops nest: the innermost one around the launch is the last
        # to start before it that also ends after it
        i = bisect.bisect_right(starts[rt["tid"]], rt["ts"]) - 1
        while i >= 0 and lst[i]["ts"] + lst[i]["dur"] < rt["ts"] + rt["dur"]:
            i -= 1
        if i < 0:
            continue
        op = lst[i]
        key = (op["name"], str(op.get("args", {}).get("Input Dims", "")))
        per = found.setdefault(e["name"], {})
        per[key] = per.get(key, 0) + 1
    return {k: sorted(((o, s, n) for (o, s), n in v.items()),
                      key=lambda x: -x[2]) for k, v in found.items()}


def build_paths(torch, cs):
    """The pool and the dense hybrid path of phases 4 and 4b: the same
    configs, seeds, router and prompts."""
    import numpy as np
    from repro_torch.configs.qwen15_32b import CONFIG as QWEN
    from repro_torch.core.routing import HybridRouter, ThresholdPolicy
    from repro_torch.launch.serve import scaled_sibling
    from repro_torch.models.encoder import RouterConfig, init_router_encoder
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine, Engine
    from repro_torch.serving.hybrid import HybridEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    dev = torch.device("cuda")
    cfgs = {"half": dataclasses.replace(scaled_sibling(QWEN, 2),
                                        n_layers=2),
            "full": dataclasses.replace(QWEN, n_layers=4)}
    bundles = {n: build_model(c) for n, c in cfgs.items()}
    models = {n: bundles[n].init(torch.Generator(device=dev)
                                 .manual_seed(100 + i), dev)
              for i, n in enumerate(cfgs)}
    rcfg = RouterConfig(vocab_size=QWEN.vocab_size, n_layers=24,
                        d_model=1024, n_heads=16, d_ff=4096, max_seq=512)
    enc = init_router_encoder(rcfg, torch.Generator(device=dev)
                              .manual_seed(7), dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 513, cs.N_PROMPTS)
    tokens = rng.integers(4, QWEN.vocab_size, (cs.N_PROMPTS, 512)
                          ).astype(np.int32)
    mask = (np.arange(512)[None] < lens[:, None]).astype(np.float32)
    tokens[mask == 0] = 0
    router = HybridRouter(enc, rcfg, 0.0)
    router = router.with_threshold(float(np.median(
        router.scores(tokens, mask).cpu().numpy())))
    pool = ContinuousPoolEngine(ThresholdPolicy(router), [
        (n, ContinuousEngine(bundles[n], models[n],
                             max_new_tokens=cs.NEW_TOKENS,
                             n_slots=cs.N_SLOTS, max_seq=cs.MAX_SEQ))
        for n in cfgs])
    hy = HybridEngine(router, *(Engine(bundles[n], models[n],
                                       max_new_tokens=cs.NEW_TOKENS)
                                for n in cfgs))
    return {"pool": lambda: pool.serve(tokens, mask, seed=0),
            "dense": lambda: hy.serve(tokens, mask, seed=0)}


def profile_path(torch, profile_ssm, tag, fn, prefix="qwen"):
    """Warm ``fn`` (a serve), time it, trace it (device activity), and
    trace it once more with host ops to name the host op behind each of
    the five largest kernels; the traces are build/profile/
    ``{prefix}_{tag}*.json``. Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile
    fn()   # warm-up: allocator, cuBLAS handles, kernel loads
    wall, res = profile_ssm._wall_ms(torch, fn)
    busy, by_name = profile_ssm._profiled(torch, f"{prefix}_{tag}", fn)
    # device memsets (not in the busy time or the kernels): the counts the
    # split kernels zero before a launch, and the serve's own
    memsets = [e["dur"] / 1e3 for e in json.loads(
        (profile_ssm.OUT / f"{prefix}_{tag}.json").read_text())["traceEvents"]
        if e.get("ph") == "X" and e.get("cat") == "gpu_memset"]
    n_tok = int(res.lengths.sum())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    shares = {}
    for name, (n, t) in by_name.items():
        k = _kernel_of(name)
        if k is not None:
            a, b = shares.get(k, (0, 0.0))
            shares[k] = (a + n, b + t)
    out = dict(wall_ms=wall, tokens=n_tok, tokens_per_s=n_tok / wall * 1e3,
               busy_ms=busy, idle_share=1.0 - busy / wall,
               n_kernel_launches=sum(v[0] for v in by_name.values()),
               memsets=dict(count=len(memsets), device_ms=sum(memsets)),
               port_kernels={k: dict(launches=n, device_ms=t,
                                     busy_share=t / busy)
                             for k, (n, t) in shares.items()},
               kernels=[dict(name=k[:160], launches=v[0], device_ms=v[1])
                        for k, v in top[:15]])
    log(f"[{tag}] {n_tok} tokens in {wall:.1f} ms = "
        f"{out['tokens_per_s']:.1f} tokens/s; traced serve: device busy "
        f"{busy:.1f} ms, idle share {out['idle_share']:.3f}, "
        f"{out['n_kernel_launches']} kernel launches, {len(memsets)} "
        f"memsets ({sum(memsets):.3f} ms)")
    for k, v in sorted(out["port_kernels"].items()):
        log(f"[{tag}]   {k}: {v['device_ms']:.3f} ms in {v['launches']} "
            f"launches, {v['busy_share']:.3f} of the busy time")
    for k, (n, t) in top[:15]:
        log(f"[{tag}]   {t:9.3f} ms  {n:6d} x  {k[:150]}")

    # the host ops behind the five largest kernels, from a traced serve
    # with host ops and shapes
    trace = profile_ssm.OUT / f"{prefix}_{tag}_ops.json"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    names = [k for k, _ in top[:5]]
    origin = _launching_ops(trace, set(names))
    out["largest_kernels_from"] = {k[:160]: [dict(op=o, shapes=s, launches=n)
                                              for o, s, n in v[:3]]
                                   for k, v in origin.items()}
    for k in names:
        for o, s, n in origin.get(k, [])[:3]:
            log(f"[{tag}]   {k[:60]} <- {o} {s} ({n} launches)")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_qwen: no CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    import profile_ssm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    from repro_torch.kernels import build
    build.build_all()
    paths = build_paths(torch, cs)
    result = dict(card=smi, serve={tag: profile_path(torch, profile_ssm, tag,
                                                     fn)
                                   for tag, fn in paths.items()})
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
