#!/usr/bin/env python3
"""The paged kernels, prefill (K2) and decode (K1), on the qwen pool's own
calls, in several checkouts, in turns, on one CUDA card.

Run from the root of a checkout:

    python3 tools/replay_prefill.py [--bf16] PARENT . . PARENT

First one serve of chip_smoke.py phase 4's pool (two qwen1.5-32b tiers,
16 prompts of 32-512 tokens, 8 slots) records the arguments of every K2
call (shapes, page table, start, total, live bound) and of every K1 call
(shapes, page table, lengths, live bound) into build/replay/calls.pt.
Then each further argument, the root of a checkout (for example the
parent commit unpacked with ``git archive`` into a directory that
.gitignore lists), runs in a process of its own, in the order given: it
builds its own kernels and replays the recorded calls on random pools and
queries of the same shapes (the work depends on the shapes and the
positions only), each call checked once against the plain version; and
for K2 the same for a few shapes beside the pool's (``SHAPES``: its chunk
at the half tier's 20 kv heads, and contexts near max_seq on a full and a
small grid). Times are the kernel's device time from torch.profiler,
summed over a tier's calls of one kernel (one replay of the serve's
sequence: "pool_*" K2, "decode_*" K1) or over 20 calls of a shape, three
rounds each. Also prints how the recorded calls spread over contexts: the
share of slot chunks (K2) and of slot rows (K1, idle slots left out)
whose keys pass 128, 256 and 512. ``--bf16`` replays the same calls with
q and the pools in bf16 (the kernels' bf16 instances, as phase 10's bf16
pool launches them: the same chunks at the same positions), each call
checked against the plain version at bf16 within allclose(rtol = atol =
2e-2). Prints the card's name and power limit, then one JSON line per
checkout and round. It imports neither JAX nor the JAX package.
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


def _spread(keys) -> dict:
    keys = keys[keys > 0].float()
    return dict(slots=len(keys), max_keys=int(keys.max()),
                **{f"keys>{n}": (keys > n).float().mean().item()
                   for n in (128, 256, 512)})


def record() -> None:
    """One serve of phase 4's pool with the K2 and K1 wrappers wrapped:
    their arguments, on the host, in call order."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import torch
    import chip_smoke as cs
    import profile_qwen
    from repro_torch.kernels import build
    from repro_torch.models import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    real = dict(prefill=attention.paged_prefill_attention_gqa,
                decode=attention.paged_decode_attention_gqa)
    calls = dict(prefill=[], decode=[])

    def prefill(q, kp, vp, pt, start, total, **kw):
        calls["prefill"].append(dict(q=tuple(q.shape), pool=tuple(kp.shape),
                                     pt=pt.cpu(), start=start.cpu(),
                                     total=total.cpu(), kw=kw))
        return real["prefill"](q, kp, vp, pt, start, total, **kw)

    def decode(q, kp, vp, pt, lens, **kw):
        calls["decode"].append(dict(q=tuple(q.shape), pool=tuple(kp.shape),
                                    pt=pt.cpu(), lens=lens.cpu(), kw=kw))
        return real["decode"](q, kp, vp, pt, lens, **kw)

    serve = profile_qwen.build_paths(torch, cs)["pool"]
    attention.paged_prefill_attention_gqa = prefill
    attention.paged_decode_attention_gqa = decode
    try:
        serve()
    finally:
        attention.paged_prefill_attention_gqa = real["prefill"]
        attention.paged_decode_attention_gqa = real["decode"]
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(calls, CALLS)
    for kind, key in (("prefill", "total"), ("decode", "lens")):
        lst = calls[kind]
        log(json.dumps(dict(kernel=kind, recorded=len(lst), by_kv_heads={
            k: sum(c["q"][1] == k for c in lst)
            for k in sorted({c["q"][1] for c in lst})},
            **_spread(torch.cat([c[key] for c in lst])))))


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


def run_one(tree: str, dtype_name: str = "float32") -> None:
    root = Path(tree).resolve()
    sys.path[:0] = [str(root / "src"), str(root), str(ROOT / "tools")]
    import torch
    import profile_ssm
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_decode_attention import ops as dec
    from repro_torch.kernels.paged_prefill_attention import ops as pre
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(0)
    calls = torch.load(CALLS)
    tier = lambda c: "full" if c["q"][1] == 40 else "half"
    # group: (wrapper, plain version, a piece of the kernel's device name,
    # calls)
    groups = {}
    for kind, op, ref, piece, prefix in (
            ("prefill", pre.paged_prefill_attention_gqa,
             pre.paged_prefill_attention_ref, "paged_prefill", "pool"),
            ("decode", dec.paged_decode_attention_gqa,
             dec.paged_decode_attention_ref, "paged_decode", "decode")):
        for c in calls[kind]:
            groups.setdefault(f"{prefix}_{tier(c)}", (op, ref, piece, []))[
                3].append(c)
    for name, lst in _shape_calls(torch).items():
        groups[name] = (pre.paged_prefill_attention_gqa,
                        pre.paged_prefill_attention_ref, "paged_prefill", lst)
    pools, worst = {}, 0.0
    runs = {}
    for name, (op, ref, piece, lst) in groups.items():
        args = []
        for c in lst:
            if c["pool"] not in pools:
                pools[c["pool"]] = tuple(torch.randn(c["pool"], generator=g,
                                                     device=dev).to(dtype)
                                         for _ in range(2))
            kp, vp = pools[c["pool"]]
            q = (torch.randn(c["q"], generator=g, device=dev)
                 * c["q"][-1] ** -.5).to(dtype)
            pos = (c["lens"],) if "lens" in c else (c["start"], c["total"])
            a = (q, kp, vp, c["pt"].to(dev), *[t.to(dev) for t in pos])
            args.append((a, c["kw"]))
            got, want = op(*a, **c["kw"]).float(), ref(*a, **c["kw"]).float()
            # fp32: the largest error; bf16: how far outside allclose
            err = ((got - want).abs() - (2e-2 * want.abs() if dtype ==
                                         torch.bfloat16 else 0)).max().item()
            worst = max(worst, err)
        runs[name] = (op, piece, args)
    if not worst <= (2e-2 if dtype == torch.bfloat16 else 1e-4):
        raise AssertionError(f"{tree}: max abs err {worst}")
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    for rnd in range(3):
        res = {}
        for name, (op, piece, args) in runs.items():
            def go():
                for a, kw in args:
                    op(*a, **kw)
            go()
            _, by_name = profile_ssm._profiled(
                torch, f"replay_{root.name}_{name}", go)
            ms = sum(t for k, (n, t) in by_name.items() if piece in k)
            res[name] = dict(calls=len(args), device_ms=ms)
        log(json.dumps(dict(tree=tree, dtype=dtype_name, round=rnd,
                            max_abs_err=worst, **res)))


def main() -> int:
    if sys.argv[1] == "--one":
        run_one(*sys.argv[2:4])
        return 0
    trees, dtype_name = sys.argv[1:], "float32"
    if trees[:1] == ["--bf16"]:
        trees, dtype_name = trees[1:], "bfloat16"
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    subprocess.run([sys.executable, __file__, "--record"], check=True)
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--one", tree, dtype_name],
                       check=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--record"]:
        record()
        sys.exit(0)
    sys.exit(main())
