#!/usr/bin/env python3
"""Where the time goes on the port's SSM slice, on one CUDA card.

Run from the root of a checkout:  python3 tools/profile_ssm.py

It builds the kernels, then measures with ``torch.profiler``:

1. K3 (the SSD chunk scan) alone at its two main-path shapes, the pool's
   packed prefill (x 8x24x16x64) and the dense path's chunks (x
   16x24x256x64): the kernel's device time per launch from the trace,
   beside the CUDA-event time of back-to-back calls (what chip_smoke.py
   reports) and the host time per wrapper call.
2. chip_smoke.py phase 4c's traffic (two mamba2-130m tiers behind a router
   at DeBERTa-v3-large's widths, 16 prompts of 32-512 tokens, 32 new
   tokens each), through the pool, then through the dense hybrid path:
   a warm-up serve, a timed serve (wall time, host clock around work that
   ends in a synchronize), and a traced serve: the device's busy time
   (the union of kernel intervals), its idle share against the timed
   serve's wall, and device time by kernel, the largest first. The traced
   serve records device activity only: tracing every host op as well
   slows the host-bound serving loop about 2.5x.

The trace of each serve is written to build/profile/ (ignored by git) and
summarised; the last line of the output is one JSON object with every
number. ``record_k3_calls`` (used by tools/ssd_variants.py) serves the same
traffic once more and records the shape and strides of each K3 call.
It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "profile"
CALLS = ROOT / "build" / "replay" / "ssd_calls.pt"   # record_k3_calls


def log(msg: str) -> None:
    print(msg, flush=True)


def _kernels(trace: Path):
    """(busy ms, {kernel name: (launches, device ms)}) of a chrome trace:
    busy is the union of the device kernels' intervals."""
    events = json.loads(trace.read_text())["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            spans.append((e["ts"], e["ts"] + e["dur"]))
            n, t = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, t + e["dur"] / 1e3)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, by_name


def _wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _profiled(torch, tag, fn):
    """Run ``fn`` once under the profiler, device activity only; returns
    (busy ms, kernels by name) and writes the trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = OUT / f"{tag}.json"
    prof.export_chrome_trace(str(trace))
    return _kernels(trace)


def kernel_timing(torch, cs):
    """K3 at chip_smoke.py's "pool" and "main" shapes."""
    dev = torch.device("cuda")
    cases = {c["name"]: c for c in cs.ssd_cases(torch, dev)}
    out = {}
    for name in ("pool", "main"):
        c = cases[name]
        event_ms = cs._time_ms(torch, c["kernel"])
        n = 50
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            c["kernel"]()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
        _, by_name = _profiled(torch, f"k3_{name}",
                               lambda: [c["kernel"]() for _ in range(n)])
        # every device kernel of a wrapper call (the kernel is one launch)
        k3 = [(k, v) for k, v in by_name.items() if "ssd_kernel" in k]
        launches = sum(v[0] for _, v in k3)
        device_ms = sum(v[1] for _, v in k3) / max(launches, 1)
        out[name] = dict(desc=c["desc"], event_ms=event_ms,
                         device_ms=device_ms, host_ms_per_call=host_ms,
                         launches=launches)
        log(f"[k3] {name} ({c['desc']}): device {device_ms:.4f} ms per "
            f"launch ({launches} launches traced), CUDA events "
            f"{event_ms:.4f} ms per call, host {host_ms:.4f} ms per call")
    return out


def _serving(torch, cs):
    """Phase 4c's traffic and its two paths: {"pool": serve, "dense":
    serve}, each a callable that serves the 16 prompts once."""
    import numpy as np
    from repro_torch.configs.mamba2_130m import CONFIG as MAMBA
    from repro_torch.core.routing import HybridRouter, ThresholdPolicy
    from repro_torch.launch.serve import scaled_sibling
    from repro_torch.models.encoder import RouterConfig, init_router_encoder
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine, Engine
    from repro_torch.serving.hybrid import HybridEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    dev = torch.device("cuda")
    cfgs = {"half": scaled_sibling(MAMBA, 2), "full": MAMBA}
    bundles = {n: build_model(c) for n, c in cfgs.items()}
    models = {n: bundles[n].init(torch.Generator(device=dev)
                                 .manual_seed(200 + i), dev)
              for i, n in enumerate(cfgs)}
    rcfg = RouterConfig(vocab_size=152064, n_layers=24, d_model=1024,
                        n_heads=16, d_ff=4096, max_seq=512)
    enc = init_router_encoder(rcfg, torch.Generator(device=dev)
                              .manual_seed(7), dev)
    rng = np.random.default_rng(10)
    lens = rng.integers(32, 513, cs.N_PROMPTS)
    tokens = rng.integers(4, MAMBA.vocab_size, (cs.N_PROMPTS, 512)
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


def record_k3_calls(torch, cs, path=CALLS):
    """One serve of phase 4c's traffic through each path with the SSD
    wrapper the model calls (``ssd_chunk``) wrapped: the shape and strides
    of each argument of every K3 call, in call order, saved to ``path`` as
    {"pool": [...], "dense": [...]} (each call a tuple of (shape, strides)
    pairs: xs, dts, dA_cum, Bs, Cs). The kernel's work depends on the
    shapes and strides only, so tools/ssd_variants.py replays the calls on
    random inputs of the same layout."""
    from repro_torch.kernels.ssd_scan import ops
    real, calls = ops.ssd_chunk, []

    def recording(*args):
        calls.append(tuple((tuple(t.shape), tuple(t.stride()))
                           for t in args))
        return real(*args)

    out = {}
    ops.ssd_chunk = recording
    try:
        for tag, fn in _serving(torch, cs).items():
            calls = []
            fn()
            out[tag] = calls
    finally:
        ops.ssd_chunk = real
    torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)
    log(f"[record] K3 calls: " + ", ".join(f"{k} {len(v)}"
                                          for k, v in out.items())
        + f" -> {path.relative_to(ROOT)}")
    return out


def serve_profiles(torch, cs):
    """Phase 4c's traffic through the pool and the dense hybrid path."""
    out = {}
    for tag, fn in _serving(torch, cs).items():
        fn()   # warm-up: allocator, cuBLAS handles, kernel loads
        wall, res = _wall_ms(torch, fn)
        busy, by_name = _profiled(torch, f"ssm_{tag}", fn)
        n_tok = int(res.lengths.sum())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        out[tag] = dict(wall_ms=wall, tokens_per_s=n_tok / wall * 1e3,
                        busy_ms=busy, idle_share=1.0 - busy / wall,
                        tokens=n_tok,
                        kernels=[dict(name=k[:120], launches=v[0],
                                      device_ms=v[1]) for k, v in top],
                        n_kernel_launches=sum(v[0] for v in
                                              by_name.values()))
        log(f"[{tag}] {n_tok} tokens in {wall:.1f} ms = "
            f"{n_tok / wall * 1e3:.1f} tokens/s; traced serve: device busy "
            f"{busy:.1f} ms, idle share {1.0 - busy / wall:.3f}, "
            f"{out[tag]['n_kernel_launches']} kernel launches")
        for k, (n, t) in top:
            log(f"[{tag}]   {t:9.3f} ms  {n:6d} x  {k[:150]}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_ssm: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    from repro_torch.kernels import build
    build.build_all()
    result = dict(card=smi, k3=kernel_timing(torch, cs),
                  serve=serve_profiles(torch, cs))
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
