#!/usr/bin/env python3
"""Where the time goes on the port's gemma3-4b paths, on one CUDA card.

Run from the root of a checkout:  python3 tools/profile_gemma.py [pool] [dense]

chip_smoke.py phase 4d's traffic: two gemma3-4b tiers ("full": the
published config, 34 layers, 29 of them local with a 1024-token window;
"half": scaled_sibling(., 2), 17 layers) behind a router at
DeBERTa-v3-large's widths over gemma's vocabulary and 2048 positions, 16
prompts of 1040-1984 tokens, 32 new tokens each, through the routed pool
(paged K1, K2) and through the dense hybrid path (K4, K5), or through the
paths named (both where none is). First the
router's scoring of the 16 prompts alone (wall time), then for each path
what tools/profile_qwen.py measures: a warm-up serve, a timed serve, a
serve traced with device activity only (busy time, idle share, device
time by kernel) and one traced with host ops and shapes (the host op
behind each of the five largest kernels).

The traces go to build/profile/ (ignored by git); the last line of the
output is one JSON object with every number. It imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, flush=True)


def build_paths(torch, cs):
    """The pool and the dense hybrid path of phase 4d on its models,
    router and prompts (``chip_smoke.gemma_setup``). Returns ({tag:
    serve}, the router's scoring of the prompts)."""
    from repro_torch.core.routing import ThresholdPolicy
    from repro_torch.serving.engine import ContinuousEngine, Engine
    from repro_torch.serving.hybrid import HybridEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    g = cs.gemma_setup(torch)
    bundles, models, router = g["bundles"], g["models"], g["router"]
    tokens, mask = g["tokens"], g["mask"]
    pool = ContinuousPoolEngine(ThresholdPolicy(router), [
        (n, ContinuousEngine(bundles[n], models[n],
                             max_new_tokens=cs.NEW_TOKENS,
                             n_slots=cs.N_SLOTS, max_seq=cs.GEMMA_MAX_SEQ))
        for n in g["cfgs"]])
    hy = HybridEngine(router, *(Engine(bundles[n], models[n],
                                       max_new_tokens=cs.NEW_TOKENS)
                                for n in g["cfgs"]))
    return ({"pool": lambda: pool.serve(tokens, mask, seed=0),
             "dense": lambda: hy.serve(tokens, mask, seed=0)},
            lambda: router.scores(tokens, mask))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_gemma: no CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    import profile_qwen
    import profile_ssm
    tags = sys.argv[1:] or ["pool", "dense"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    from repro_torch.kernels import build
    build.build_all()
    paths, score = build_paths(torch, cs)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"[router] scoring 16 x {cs.GEMMA_MAX_SEQ} tokens: "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms")
    result = dict(card=smi, router_ms=walls,
                  serve={tag: profile_qwen.profile_path(
                      torch, profile_ssm, tag, fn, prefix="gemma")
                      for tag, fn in paths.items() if tag in tags})
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
