#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Device: the card's name, count and power limit; TF32 off.
2. Build: the CUDA kernels from src/repro_torch/csrc, with nvcc for sm_90a.
3. Kernels against their plain PyTorch versions on the card, one case per
   launch mode, at the main path's shapes and beside them; the kernel's
   time (CUDA events around back-to-back launches), the plain version's,
   and the least time the card could take for the same work.
4. The main path at full width: a router at DeBERTa-v3-large's widths
   scores 16 prompts, a ThresholdPolicy splits them between two
   qwen1.5-32b tiers ("half": the reference's scaled_sibling(., 2) at 2
   layers; "full": every width, 4 layers), and a ContinuousPoolEngine
   serves them; both kernels must launch on both tiers.
5. The card against the CPU: the full tier at depth 1, one prefill chunk
   and two decode steps on each device, logits compared.

It imports neither JAX nor the JAX package. Weights are random, from
seeded torch.Generators; nothing is downloaded. The last two lines are a
JSON object per kernel and the result line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = 1e-4               # fp32 kernel vs plain: another summation order
DEVICE_TOL = 1e-3               # fp32 card vs CPU logits through a 5120-wide
                                # layer: sums over up to 27392 terms in
                                # another order on each device
N_PROMPTS, NEW_TOKENS, N_SLOTS, MAX_SEQ = 16, 32, 8, 1024


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1
def device_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — the port's kernels "
                         "run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{torch.cuda.device_count()}; nvidia-smi: {smi}")
    return name, smi


# ------------------------------------------------------------------ phase 2
def build_phase():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    reports = build.build_all()
    dt = time.monotonic() - t0
    for src in build.sources():
        rel = src.relative_to(ROOT)
        log(f"[build] {src.stem}: nvcc -gencode arch=compute_90a,"
            f"code=sm_90a from {rel} -> {build.build_dir().relative_to(ROOT)}")
        for line in reports.get(src.stem, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(reports)} sources compiled in {dt:.1f} s")


# ------------------------------------------------------------------ phase 3
def _pool(torch, rng, K, D, ps, MP, totals, dev):
    """Random fp32 pool + a page table giving each slot distinct pages
    covering its ``totals[b]`` tokens (page 0 stays the scratch page)."""
    import numpy as np
    n_pages = 1 + sum(-(-int(t) // ps) for t in totals)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    kp = torch.randn((n_pages, ps, K, D), generator=g, device=dev)
    vp = torch.randn((n_pages, ps, K, D), generator=g, device=dev)
    pt = np.zeros((len(totals), MP), np.int32)
    nxt = 1
    for b, t in enumerate(totals):
        n = -(-int(t) // ps)
        pt[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return kp, vp, torch.tensor(pt, device=dev)


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _time_ms(torch, fn, runs: int = 7, launches: int = 10) -> float:
    """Per-call time of ``fn``: the median over ``runs`` of CUDA-event
    timings of ``launches`` back-to-back calls, after three warm-up calls
    (back to back, so the host's launch overhead hides behind the card)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return sorted(times)[len(times) // 2]


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def decode_cases(torch, dev):
    """(name, args, kwargs, bytes, flops) per decode launch mode. "main" is
    the main path's decode: 8 slots of the full tier, ragged contexts."""
    import numpy as np
    rng = np.random.default_rng(1)
    MP, ps = MAX_SEQ // 16, 16
    spec = {  # name: (K, G, D, lens, pages_start, window)
        "main": (40, 1, 128, rng.integers(33, 545, 8), 0, 0),
        "gqa": (8, 8, 128, rng.integers(33, 545, 8), 0, 0),
        "ragged_idle": (40, 1, 128, np.r_[rng.integers(1, 1000, 7), 0], 0,
                        0),
        "bound_lt_table": (40, 1, 128, rng.integers(1, 129, 8), 0, 0),
        "window_late_start": (8, 4, 128, rng.integers(320, 1025, 8), 4, 256),
    }
    out = []
    for name, (K, G, D, lens, pstart, window) in spec.items():
        lens = np.asarray(lens, np.int32)
        B = len(lens)
        kp, vp, pt = _pool(torch, rng, K, D, ps, MP, lens, dev)
        g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
        q = torch.randn((B, K, G, D), generator=g, device=dev) * D ** -0.5
        bound = min(_bucket(-(-int(lens.max()) // ps)), MP)
        kw = dict(pages_bound=bound, pages_start=pstart, window=window)
        keys = np.minimum(lens, window) if window else lens
        nbytes = 4 * (2 * q.numel() + 2 * int(keys.sum()) * K * D
                      + pt.numel() + B)
        flops = 4 * int(keys.sum()) * K * G * D
        out.append((name, (q, kp, vp, pt, torch.tensor(lens, device=dev)),
                    kw, nbytes, flops))
    return out


def prefill_cases(torch, dev):
    """(name, args, kwargs, bytes, flops) per prefill launch mode. "main" is
    the main path's packed chunk: 8 slots x 16 rows of the full tier at
    ragged resident contexts."""
    import numpy as np
    rng = np.random.default_rng(2)
    MP, ps, C = MAX_SEQ // 16, 16, 16
    full = lambda n: np.full(8, n, np.int32)
    spec = {  # name: (K, G, D, start, n_new, pages_start, window)
        "main": (40, 1, 128, 16 * rng.integers(0, 31, 8), full(16), 0, 0),
        "gqa": (8, 8, 128, 16 * rng.integers(0, 31, 8), full(16), 0, 0),
        "ragged_idle": (40, 1, 128, np.r_[rng.integers(1, 900, 7), 0],
                        np.r_[rng.integers(1, 17, 7), 0], 0, 0),
        "bound_lt_table": (40, 1, 128, rng.integers(0, 100, 8), full(16), 0,
                           0),
        "start_mid_n_new_lt_c": (40, 1, 128, rng.integers(1, 1000, 8),
                                 rng.integers(1, 16, 8), 0, 0),
        "window_late_start": (8, 4, 128, rng.integers(330, 1000, 8),
                              rng.integers(1, 17, 8), 4, 256),
    }
    out = []
    for name, (K, G, D, start, n_new, pstart, window) in spec.items():
        start = np.asarray(start, np.int32)
        n_new = np.asarray(n_new, np.int32)
        total = start + n_new
        B = len(start)
        kp, vp, pt = _pool(torch, rng, K, D, ps, MP, total, dev)
        g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
        q = torch.randn((B, K, C, G, D), generator=g, device=dev) * D ** -0.5
        bound = min(_bucket(max(-(-int(total.max()) // ps), 1)), MP)
        kw = dict(pages_bound=bound, pages_start=pstart, window=window)
        # keys each real row sees, and the keys each slot must read
        vis = [min(s + c + 1, t) - (max(s + c + 1 - window, 0) if window
                                    else 0)
               for s, n, t in zip(start, n_new, total) for c in range(n)]
        keys = total - np.maximum(start - window + 1, 0) if window else total
        nbytes = 4 * (2 * q.numel() + 2 * int(keys.sum()) * K * D
                      + pt.numel() + 2 * B)
        flops = 4 * int(sum(vis)) * K * G * D
        out.append((name, (q, kp, vp, pt, torch.tensor(start, device=dev),
                           torch.tensor(total, device=dev)),
                    kw, nbytes, flops))
    return out


def kernel_phase(torch):
    from repro_torch.kernels.paged_decode_attention import ops as dec
    from repro_torch.kernels.paged_prefill_attention import ops as pre
    dev = torch.device("cuda")
    rows = []
    for kname, op, ref, cases, src, replaces in (
            ("paged_decode_attention", dec.paged_decode_attention_gqa,
             dec.paged_decode_attention_ref, decode_cases(torch, dev),
             "src/repro_torch/csrc/paged_decode_attention.cu",
             "src/repro/kernels/paged_decode_attention/kernel.py:106"),
            ("paged_prefill_attention", pre.paged_prefill_attention_gqa,
             pre.paged_prefill_attention_ref, prefill_cases(torch, dev),
             "src/repro_torch/csrc/paged_prefill_attention.cu",
             "src/repro/kernels/paged_prefill_attention/kernel.py:109")):
        worst = 0.0
        row = dict(name=kname, route="cuda", source=src, replaces=replaces,
                   library_ms=None)
        for name, args, kw, nbytes, flops in cases:
            got = op(*args, **kw)
            torch.cuda.synchronize()
            want = ref(*args, **kw)
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            note = ""
            if name == "ragged_idle":
                if got[-1].abs().max().item() != 0.0:
                    raise AssertionError(f"{kname}: the idle slot's output "
                                         "is not exactly 0")
                note = "; idle slot exactly 0"
            if not err <= KERNEL_TOL:
                raise AssertionError(f"{kname}[{name}]: max abs err {err} > "
                                     f"{KERNEL_TOL}")
            shape = "x".join(map(str, args[0].shape))
            log(f"[kernels] {kname}[{name}] q {shape} {kw}: max abs err "
                f"{err:.3g} <= {KERNEL_TOL}{note}")
            if name == "main":
                ms = _time_ms(torch, lambda: op(*args, **kw))
                plain_ms = _time_ms(torch, lambda: ref(*args, **kw))
                bound_ms, bound_by = _bound(nbytes, flops)
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
                log(f"[kernels] {kname}[main] kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_by}: {nbytes} B, {flops} flop)")
        row["max_abs_err"] = worst
        rows.append(row)
    return rows


# ------------------------------------------------------------------ phase 4
def scaled_sibling(full, factor: int):
    """launch/serve.py:81 ``scaled_sibling`` of the JAX package, for a dense
    config: layers, width, heads and FFN divided together."""
    return dataclasses.replace(
        full, n_layers=max(1, full.n_layers // factor),
        d_model=max(8, full.d_model // factor),
        n_heads=max(1, full.n_heads // factor),
        n_kv_heads=max(1, min(full.n_kv_heads, full.n_heads // factor)),
        d_ff=max(8, full.d_ff // factor), name=full.name + "-s")


def main_path_phase(torch, card: str, smi: str):
    import numpy as np
    from repro_torch.configs.qwen15_32b import CONFIG as QWEN
    from repro_torch.core.routing import HybridRouter, ThresholdPolicy
    from repro_torch.kernels.paged_decode_attention import ops as dec
    from repro_torch.kernels.paged_prefill_attention import ops as pre
    from repro_torch.models.encoder import RouterConfig, init_router_encoder
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    dev = torch.device("cuda")
    full_cfg = dataclasses.replace(QWEN, n_layers=4)
    half_cfg = dataclasses.replace(scaled_sibling(QWEN, 2), n_layers=2)
    rcfg = RouterConfig(vocab_size=QWEN.vocab_size, n_layers=24,
                        d_model=1024, n_heads=16, d_ff=4096, max_seq=512)
    t0 = time.monotonic()
    tiers, models = [], {}
    for i, (name, cfg) in enumerate((("half", half_cfg), ("full", full_cfg))):
        bundle = build_model(cfg)
        g = torch.Generator(device=dev).manual_seed(100 + i)
        models[name] = bundle.init(g, dev)
        tiers.append((name, ContinuousEngine(
            bundle, models[name], max_new_tokens=NEW_TOKENS,
            n_slots=N_SLOTS, max_seq=MAX_SEQ)))
        log(f"[main] tier {name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads of "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} B params")
    router = init_router_encoder(rcfg, torch.Generator(device=dev)
                                 .manual_seed(7), dev)
    torch.cuda.synchronize()
    log(f"[main] random init on the card: {time.monotonic() - t0:.1f} s")

    rng = np.random.default_rng(0)
    lens = rng.integers(32, 513, N_PROMPTS)
    tokens = rng.integers(4, QWEN.vocab_size, (N_PROMPTS, 512)
                          ).astype(np.int32)
    mask = (np.arange(512)[None] < lens[:, None]).astype(np.float32)
    tokens[mask == 0] = 0
    probe = HybridRouter(router, rcfg, 0.0)
    threshold = float(np.median(probe.scores(tokens, mask).cpu().numpy()))
    pool = ContinuousPoolEngine(
        ThresholdPolicy(probe.with_threshold(threshold)), tiers)

    # warm up both tiers (cuBLAS handles, allocator) outside the count
    warm = tokens[:2, :48], mask[:2, :48]
    for _, eng in tiers:
        eng.serve(warm[0], seed=1)
        eng.stats = type(eng.stats)()
    pool.meter.reset()

    per_tier = {name: {"decode": 0, "prefill": 0} for name, _ in tiers}

    def counted(name, step):
        def run():
            d0, p0 = dec.paged_decode_attention_gqa.launches, \
                pre.paged_prefill_attention_gqa.launches
            out = step()
            per_tier[name]["decode"] += \
                dec.paged_decode_attention_gqa.launches - d0
            per_tier[name]["prefill"] += \
                pre.paged_prefill_attention_gqa.launches - p0
            return out
        return run

    for name, eng in tiers:
        eng.step = counted(name, eng.step)
    dec.paged_decode_attention_gqa.launches = 0
    pre.paged_prefill_attention_gqa.launches = 0
    t0 = time.monotonic()
    res = pool.serve(tokens, mask, seed=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"paged_decode_attention": dec.paged_decode_attention_gqa
                .launches,
                "paged_prefill_attention": pre.paged_prefill_attention_gqa
                .launches}

    summary = pool.meter.summary()
    for name, eng in tiers:
        st = eng.stats
        log(f"[main] {name}: calls {summary[name]['calls']}, tokens "
            f"{summary[name]['gen_tokens']}, decode steps "
            f"{st.decode_steps}, prefill dispatches "
            f"{st.prefill_dispatches}, kernel launches {per_tier[name]}, "
            f"free pages {eng.cache.free_pages} of {eng.cache.num_pages}")
        for k, n in per_tier[name].items():
            if n <= 0:
                raise AssertionError(f"tier {name}: the {k} kernel never "
                                     "launched")
        if eng.cache.free_pages != eng.cache.num_pages - 1:
            raise AssertionError(f"tier {name}: pages leaked after the "
                                 "drain")
    if sum(v["calls"] for v in summary.values()) != N_PROMPTS:
        raise AssertionError(f"calls {summary} do not sum to {N_PROMPTS}")
    if not np.array_equal(res.tier_idx, (res.scores < threshold)):
        raise AssertionError("tier_idx disagrees with score < threshold")
    if not (res.lengths >= 1).all() or res.responses.max() >= \
            QWEN.vocab_size or res.responses.min() < 0:
        raise AssertionError("responses out of range")
    n_tok = int(res.lengths.sum())
    log(f"[main] {N_PROMPTS} requests retired ({np.bincount(res.tier_idx, minlength=2).tolist()}"
        f" half/full), threshold {threshold:.6f}, {n_tok} tokens in "
        f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s on {card} ({smi})")
    return models["full"], full_cfg, launches


# ------------------------------------------------------------------ phase 5
def device_vs_cpu_phase(torch, full_model, full_cfg):
    """The full tier at depth 1, full width: one prefill chunk and two
    decode steps on the card and on the CPU, same weights, same inputs."""
    import numpy as np
    from repro_torch.models import decoder
    cfg = dataclasses.replace(full_cfg, n_layers=1)
    gpu = decoder.Decoder(cfg, device="meta")
    gpu.embed, gpu.ln_f, gpu.head = (full_model.embed, full_model.ln_f,
                                     full_model.head)
    gpu.layers = torch.nn.ModuleList([full_model.layers[0]])
    cpu = decoder.Decoder(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())

    rng = np.random.default_rng(3)
    C, ps, MP = 16, 16, 4
    n_new = np.array([16, 11], np.int32)
    chunk = rng.integers(4, cfg.vocab_size, (2, C)).astype(np.int64)
    pt = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    outs = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        T = lambda a: torch.tensor(a, device=dev)
        cache = decoder.init_paged_decode_cache(cfg, 5, ps, dev)
        x = decoder.decoder_prefill_paged_chunk(
            model, cache, T(chunk), T(pt), T(np.zeros(2, np.int32)),
            T(n_new), cfg)
        logits = [decoder._unembed(model, x, cfg)[:, 0]]
        lens = n_new.copy()
        for step in range(2):
            # both devices feed the card's greedy tokens
            tok = outs["cuda"][step].argmax(-1).cpu().numpy() \
                if dev == "cpu" else logits[-1].argmax(-1).cpu().numpy()
            logits.append(decoder.decoder_decode_step_paged(
                model, cache, T(tok[:, None]), T(pt), T(lens),
                T(np.ones(2, bool)), cfg))
            lens = lens + 1
        outs[dev] = [t.float().cpu() for t in logits]
    worst = 0.0
    for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        top2 = b.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > DEVICE_TOL
        same = (a.argmax(-1) == b.argmax(-1))[sure]
        log(f"[device-vs-cpu] logits {i} ({'prefill' if i == 0 else 'decode'}"
            f"): max abs err {err:.3g}; greedy tokens agree on "
            f"{int(same.sum())}/{int(sure.sum())} rows with a top-2 margin "
            f"> {DEVICE_TOL}")
        if not torch.isfinite(a).all() or not same.all():
            raise AssertionError("card and CPU disagree on greedy tokens")
    if not worst <= DEVICE_TOL:
        raise AssertionError(f"card vs CPU logits: {worst} > {DEVICE_TOL}")


def main() -> int:
    import torch
    card, smi = device_phase(torch)
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found — run from "
                         "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    build_phase()
    rows = kernel_phase(torch)
    full_model, full_cfg, launches = main_path_phase(torch, card, smi)
    for row in rows:
        row["launches"] = launches[row["name"]]
    device_vs_cpu_phase(torch, full_model, full_cfg)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(smi)
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
