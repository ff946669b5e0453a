#!/usr/bin/env python3
"""The paged prefill kernel (K2) on the qwen pool's own calls, in several
checkouts, in turns, on one CUDA card.

Run from the root of a checkout:

    python3 tools/replay_prefill.py PARENT . . PARENT

First one serve of chip_smoke.py phase 4's pool (two qwen1.5-32b tiers,
16 prompts of 32-512 tokens, 8 slots) records the arguments of every K2
call (shapes, page table, start, total, live bound) into
build/replay/calls.pt. Then each further argument, the root of a checkout
(for example the parent commit unpacked with ``git archive`` into a
directory that .gitignore lists), runs in a process of its own, in the
order given: it builds its own kernels and replays the recorded calls on
random pools and queries of the same shapes (the work depends on the
shapes and the positions only), each call checked once against the
plain version; and the same for a few shapes beside the pool's
(``SHAPES``: its chunk at the half tier's 20 kv heads, and contexts near
max_seq on a full and a small grid). Times are the kernel's device time
from torch.profiler, summed over a tier's calls (one replay of the
serve's sequence) or over 20 calls of a shape, three rounds each. Also
prints how the recorded calls spread over contexts: the share of slot
chunks whose keys pass 128, 256 and 512. Prints the card's name and power
limit, then one JSON line per checkout and round. It imports neither JAX
nor the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "replay"
CALLS = OUT / "calls.pt"
# name: (B, K, start of each slot as (low, high) multiples of 16, seed);
# chunks of 16 rows at G = 1, D = 128, ps = 16 as on the pool
SHAPES = {
    "main_full": (8, 40, (0, 31), 2),
    "main_half": (8, 20, (0, 31), 2),
    "long_full": (8, 40, (48, 63), 3),
    "long_half_2_slots": (2, 20, (56, 63), 4),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def record() -> None:
    """One serve of phase 4's pool with the K2 wrapper wrapped: its
    arguments, on the host, in call order."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import torch
    import chip_smoke as cs
    import profile_qwen
    from repro_torch.kernels import build
    from repro_torch.models import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    real, calls = attention.paged_prefill_attention_gqa, []

    def wrapped(q, kp, vp, pt, start, total, **kw):
        calls.append(dict(q=tuple(q.shape), pool=tuple(kp.shape),
                          pt=pt.cpu(), start=start.cpu(), total=total.cpu(),
                          kw=kw))
        return real(q, kp, vp, pt, start, total, **kw)

    serve = profile_qwen.build_paths(torch, cs)["pool"]
    attention.paged_prefill_attention_gqa = wrapped
    try:
        serve()
    finally:
        attention.paged_prefill_attention_gqa = real
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(calls, CALLS)
    keys = torch.cat([c["total"] for c in calls])
    keys = keys[keys > 0].float()
    spread = {f"keys>{n}": (keys > n).float().mean().item()
              for n in (128, 256, 512)}
    log(json.dumps(dict(recorded=len(calls), by_kv_heads={
        k: sum(c["q"][1] == k for c in calls)
        for k in sorted({c["q"][1] for c in calls})},
        slot_chunks=len(keys), max_keys=int(keys.max()), **spread)))


def _shape_calls(torch):
    import numpy as np
    C, D, ps, MP = 16, 128, 16, 64
    out = {}
    for name, (B, K, (lo, hi), seed) in SHAPES.items():
        rng = np.random.default_rng(seed)
        start = (16 * rng.integers(lo, hi + 1, B)).astype(np.int32)
        total = start + C
        n = -(-total // ps)
        pt = np.zeros((B, MP), np.int32)
        nxt = 1
        for b in range(B):
            pt[b, :n[b]] = np.arange(nxt, nxt + n[b])
            nxt += n[b]
        bound = min(1 << int(np.ceil(np.log2(n.max()))), MP)
        out[name] = [dict(q=(B, K, C, 1, D), pool=(int(nxt), ps, K, D),
                          pt=torch.tensor(pt), start=torch.tensor(start),
                          total=torch.tensor(total),
                          kw=dict(pages_bound=bound))] * 20
    return out


def run_one(tree: str) -> None:
    root = Path(tree).resolve()
    sys.path[:0] = [str(root / "src"), str(root), str(ROOT / "tools")]
    import torch
    import profile_ssm
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_prefill_attention import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    calls = torch.load(CALLS)
    groups = {f"pool_{'full' if c['q'][1] == 40 else 'half'}": []
              for c in calls}
    for c in calls:
        groups[f"pool_{'full' if c['q'][1] == 40 else 'half'}"].append(c)
    groups.update(_shape_calls(torch))
    pools, worst = {}, 0.0
    runs = {}
    for name, lst in groups.items():
        args = []
        for c in lst:
            if c["pool"] not in pools:
                pools[c["pool"]] = tuple(torch.randn(c["pool"], generator=g,
                                                     device=dev)
                                         for _ in range(2))
            kp, vp = pools[c["pool"]]
            q = torch.randn(c["q"], generator=g, device=dev) * c["q"][-1] ** -.5
            a = (q, kp, vp, c["pt"].to(dev), c["start"].to(dev),
                 c["total"].to(dev))
            args.append((a, c["kw"]))
            err = (ops.paged_prefill_attention_gqa(*a, **c["kw"])
                   - ops.paged_prefill_attention_ref(*a, **c["kw"])
                   ).abs().max().item()
            worst = max(worst, err)
        runs[name] = args
    if not worst <= 1e-4:
        raise AssertionError(f"{tree}: max abs err {worst}")
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    for rnd in range(3):
        res = {}
        for name, args in runs.items():
            def go():
                for a, kw in args:
                    ops.paged_prefill_attention_gqa(*a, **kw)
            go()
            _, by_name = profile_ssm._profiled(
                torch, f"replay_{root.name}_{name}", go)
            ms = sum(t for k, (n, t) in by_name.items() if "paged_prefill" in k)
            res[name] = dict(calls=len(args), device_ms=ms)
        log(json.dumps(dict(tree=tree, round=rnd, max_abs_err=worst, **res)))


def main() -> int:
    if sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return 0
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    subprocess.run([sys.executable, __file__, "--record"], check=True)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--record"]:
        record()
        sys.exit(0)
    sys.exit(main())
