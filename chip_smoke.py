#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Device: the card's name, count and power limit; TF32 off.
2. Build: the CUDA kernels from src/repro_torch/csrc, with nvcc for sm_90a.
3. The five kernels (paged decode and prefill, flash prefill, dense
   decode, SSD chunk scan) against their plain PyTorch versions on the
   card, one case per launch mode, at the main paths' shapes and beside
   them (the paged kernels' main and gemma3 cases also bit for bit under
   two page walk bounds, slot by slot, and from page 0 against the
   engine's late first page under a window); the kernel's time (CUDA events around
   back-to-back launches), the plain version's, one library call's where
   PyTorch has one (SDPA), and the least time the card could take for the
   same work.
4. The routed pool at full width: a router at DeBERTa-v3-large's widths
   scores 16 prompts, a ThresholdPolicy splits them between two
   qwen1.5-32b tiers ("half": the reference's scaled_sibling(., 2) at 2
   layers; "full": every width, 4 layers), and a ContinuousPoolEngine
   serves them; both paged kernels must launch on both tiers.
   4b. The paper's dense-batch hybrid path on the same models and router:
   a HybridEngine over two dense Engines serves the same prompts; it must
   route as the pool did, and the flash and dense decode kernels must
   launch on both tiers, once per layer per prefill and per decode step.
   4c. The SSM slice: two mamba2-130m tiers ("full": the published config,
   24 layers at full width; "half": scaled_sibling(., 2), 12 layers at
   d_model 384) behind the same router serve 16 prompts through the pool
   (the SSD chunk kernel must launch layers x prefill dispatches times on
   each tier, and no page may leak), then through the dense hybrid path
   (it must route as the pool did, launch the SSD kernel once per layer
   per prefill on each tier, and no kernel in decode).
   4d. The sliding-window slice: two gemma3-4b tiers ("full": the
   published config, 34 layers, 29 local with a 1024-token window; "half":
   scaled_sibling(., 2), 17 layers) behind a router at DeBERTa-v3-large's
   widths over gemma's vocabulary serve 16 prompts of 1040-1984 tokens
   through the pool (K1 and K2 on both tiers, some launches windowed with
   a late first page; no page leaked); the half tier serves the stream
   under the live and the static walk (the same greedy tokens); four
   prompts admitted one-shot on the full tier (K4 at window 1024 and
   head_dim 256) agree with chunked admission's first-token logits; the
   dense hybrid path routes as the pool did (K4 once per layer per
   prefill, K5 once per layer per decode step, local layers windowed).
   4e. The pool under load (after 4b, on phase 4's tiers, router and
   prompts, fresh pools): an escalation monitor on "half", observe-only
   (the tokens must be phase 4's), then at a threshold calibrated to
   escalate a quarter of half's streams, then at 0 (all escalate after 4
   tokens); each escalated continuation must equal the full tier's
   greedy output from prompt + emitted prefix, and the meter must bill
   16 calls and split the tokens exactly. Then a fault schedule: a
   priority-5 burst on "full" (it preempts), page pressure on "half", a
   stall of "full", a request with a zero deadline and a 1024-token
   prompt; the harness's invariants must hold and every preempted stream
   emit phase 4's tokens. K1 and K2 must launch on every tier of every
   serve.
5. The card against the CPU: the qwen and mamba2 full tiers at depth 1
   (before phase 4d, which runs on the memory phases 4-4c held), and
   gemma3-4b at depth 6 (one local:global period, after phase 4d) on
   prompts past the window, the paged path (prefill chunks, two decode
   steps) and the dense path (a prefill, two decode steps) on each
   device, logits compared.
6. The paper's pipeline (after phase 5, on the memory phases 4 to 5
   held): (a) train_router for one epoch at DeBERTa-v3-large's widths and
   (b) train_lm for 6 steps on the "half" qwen tier, each timed per step
   with its peak memory and its first step repeated on the CPU (loss and
   grad norm within STEP_RTOL); (c) the label -> train -> calibrate ->
   route pipeline at benchmarks/common.py's "full" scale: build_experiment
   (K4 and K5 in sampling, no kernel in training), the three pairs'
   routers with their drops beside random routing, and a calibrated
   three-tier cascade and quality-target dial serving the 500 test queries
   through a ContinuousPoolEngine (K1 and K2 on every tier that serves).

It imports neither JAX nor the JAX package. Weights are random, from
seeded torch.Generators; nothing is downloaded. The last two lines are a
JSON object listing the kernels and the result line. A kernel's
"launches" there are those of the first main path that runs it (qwen1.5-32b
for K1, K2, K4 and K5, mamba2-130m for K3), and "launches_by_path" holds
each path's own count, read just after that path ran from 0
("qwen1.5-32b-faults": phase 4e's pool serves).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12   # H100 SXM TF32 on the tensor cores, dense
KERNEL_TOL = 1e-4               # fp32 kernel vs plain: another summation order
SSD_TOL = 1e-4                  # SSD scan: sums over N + l terms reach tens,
                                # so 1e-4 relative to max(1, max |plain|)
DEVICE_TOL = 1e-3               # fp32 card vs CPU logits through a 5120-wide
                                # layer: sums over up to 27392 terms in
                                # another order on each device
N_PROMPTS, NEW_TOKENS, N_SLOTS, MAX_SEQ = 16, 32, 8, 1024
GEMMA_MAX_SEQ = 2048    # gemma3-4b's pool: contexts of 1040-2016 tokens
# the router's encoder at DeBERTa-v3-large's widths (the paper's router)
DEBERTA_V3_LARGE = dict(n_layers=24, d_model=1024, n_heads=16, d_ff=4096,
                        max_seq=512)


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
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
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


def _case(name, desc, kernel, plain, nbytes, flops, library=None,
          check=None, timed=False, scaled=False, report=None):
    """One launch mode: callables for the kernel's wrapper, its plain
    version and (main path only) the library yardstick, the bytes and
    flops of the work, and an extra check of the kernel's output.
    "main" cases are timed and fill the kernel's JSON row; ``timed`` times
    another main-path shape too. ``scaled`` holds the error relative to
    max(1, max |plain|) against SSD_TOL instead of KERNEL_TOL. ``report``
    logs more about a timed case: called with (torch, case, kernel ms,
    plain ms, library ms). ``check`` raises if the output is wrong, and may
    return what it checked, for the log."""
    return dict(name=name, desc=desc, kernel=kernel, plain=plain,
                library=library, nbytes=nbytes, flops=flops, check=check,
                timed=timed or name == "main", scaled=scaled, report=report)


def _idle_slot_is_zero(out):
    if out[-1].abs().max().item() != 0.0:
        raise AssertionError("the idle slot's output is not exactly 0")


def _paged_case(name, op, ref, args, kw, nbytes, flops, check=None,
                report=None, ps=16, timed=False):
    shape = "x".join(map(str, args[0].shape))
    if check is None and name == "ragged_idle":
        check = _idle_slot_is_zero
    c = _case(name, f"q {shape}, ps {ps} {kw}", lambda: op(*args, **kw),
              lambda: ref(*args, **kw), nbytes, flops, check=check,
              report=report, timed=timed)
    c.update(args=args, kw=kw)
    return c


def decode_cases(torch, dev):
    """Paged decode, one case per launch mode. "main" is the main path's
    decode: 8 slots of the full tier, ragged contexts. The kernel splits
    each slot's walk into splits of 128 keys and takes up to 8 rows of a
    kv head's group a block (4 at head_dim 256); the modes after the first
    five are what that design makes distinct: ps = 8 with lengths at the
    split edges and an idle slot, a window across split boundaries, G = 12
    in two row blocks of 8, head_dim 256 at G = 2 (gemma3-4b's heads) and
    head_dim 98 (4-byte loads, a padding row). "main" also checks that its
    output is bit-identical under the pages it needs and under the full
    table width, and for each slot launched alone. "gemma3" is the gemma3-4b
    pool's decode on a local layer: 8 slots at contexts of 1040-2016, 4 kv
    heads of 256, G = 2, window 1024, the walk from the engine's first page
    (``window_start_page``). "main" and "gemma3" also check that a window
    walk gives the same bits from page 0 and from the engine's first page
    ("main" under a window of 128)."""
    import numpy as np
    from repro_torch.kernels.paged_decode_attention import ops
    from repro_torch.serving.engine import window_start_page
    rng = np.random.default_rng(1)
    grng = np.random.default_rng(21)    # the gemma3 case's contexts
    spec = {  # name: (K, G, D, ps, lens, pages_start, window)
        "main": (40, 1, 128, 16, rng.integers(33, 545, 8), 0, 0),
        "gqa": (8, 8, 128, 16, rng.integers(33, 545, 8), 0, 0),
        "ragged_idle": (40, 1, 128, 16, np.r_[rng.integers(1, 1000, 7), 0],
                        0, 0),
        "bound_lt_table": (40, 1, 128, 16, rng.integers(1, 129, 8), 0, 0),
        "window_late_start": (8, 4, 128, 16, rng.integers(320, 1025, 8), 4,
                              256),
        "page8_split_edges": (40, 1, 128, 8, np.array([127, 128, 129, 255,
                                                       256, 257, 384, 0]),
                              0, 0),
        "window_splits": (8, 2, 128, 16, rng.integers(300, 1025, 8), 2, 200),
        "rows_past_8": (4, 12, 128, 16, rng.integers(33, 545, 8), 0, 0),
        "head_dim_256": (4, 2, 256, 16, rng.integers(33, 545, 8), 0, 0),
        "head_dim_98": (8, 3, 98, 16, rng.integers(33, 545, 8), 0, 0),
        "gemma3": (4, 2, 256, 16, grng.integers(1040, 2017, 8), None, 1024),
    }
    out = []
    for name, (K, G, D, ps, lens, pstart, window) in spec.items():
        lens = np.asarray(lens, np.int32)
        if pstart is None:   # the engine's: slot b's first key is len - window
            pstart = window_start_page(int(lens.min()) - window, ps)
        B = len(lens)
        MP = (GEMMA_MAX_SEQ if name == "gemma3" else MAX_SEQ) // ps
        kp, vp, pt = _pool(torch, rng, K, D, ps, MP, lens, dev)
        g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
        q = torch.randn((B, K, G, D), generator=g, device=dev) * D ** -0.5
        bound = min(_bucket(max(-(-int(lens.max()) // ps), 1)), MP)
        kw = dict(pages_bound=bound, pages_start=pstart, window=window)
        keys = np.minimum(lens, window) if window else lens
        nbytes = 4 * (2 * q.numel() + 2 * int(keys.sum()) * K * D
                      + pt.numel() + B)
        flops = 4 * int(keys.sum()) * K * G * D
        args = (q, kp, vp, pt, torch.tensor(lens, device=dev))
        op = ops.paged_decode_attention_gqa
        main = name in ("main", "gemma3")
        check = _idle_slot_is_zero if name == "page8_split_edges" else None
        if main:
            check = _all_of(_walk_bitwise(torch, op, args, kw),
                            _start_bitwise(torch, op, args, kw,
                                           window or 128, -window or -128))
        out.append(_paged_case(
            name, op, ops.paged_decode_attention_ref, args, kw, nbytes, flops,
            check=check, report=_paged_standing("paged_decode_attention")
            if main else None, ps=ps, timed=main))
    return out


def prefill_cases(torch, dev):
    """Paged prefill, one case per launch mode. "main" is the main path's
    packed chunk: 8 slots x 16 rows of the full tier at ragged resident
    contexts. The kernel splits each slot's walk into splits of 128 keys
    and takes 16, 32 or 64 rows a block; the modes after the first six are
    what that design makes distinct: ps = 8 with chunks across split
    boundaries, 32-row blocks (G = 2), a 64-row block with 16 rows of
    padding (G = 3), head_dim 256 in 64-row blocks (16-key tiles), and
    head_dim 18 (4-byte copies). "main" also checks that its output is
    bit-identical under the pages it needs and under the full table
    width, and for each slot launched alone. "gemma3" is the gemma3-4b
    pool's packed 16-token chunk on a local layer: 8 slots resident at
    1024-2000 tokens, 4 kv heads of 256, G = 2, window 1024, the walk from
    the engine's first page. "main" and "gemma3" also check that a window
    walk gives the same bits from page 0 and from the engine's first page
    ("main" under a window of 128)."""
    import numpy as np
    from repro_torch.kernels.paged_prefill_attention import ops
    from repro_torch.serving.engine import window_start_page
    rng = np.random.default_rng(2)
    grng = np.random.default_rng(22)    # the gemma3 case's contexts
    C = 16
    full = lambda n: np.full(8, n, np.int32)
    spec = {  # name: (K, G, D, ps, start, n_new, pages_start, window)
        "main": (40, 1, 128, 16, 16 * rng.integers(0, 31, 8), full(16), 0,
                 0),
        "gqa": (8, 8, 128, 16, 16 * rng.integers(0, 31, 8), full(16), 0, 0),
        "ragged_idle": (40, 1, 128, 16, np.r_[rng.integers(1, 900, 7), 0],
                        np.r_[rng.integers(1, 17, 7), 0], 0, 0),
        "bound_lt_table": (40, 1, 128, 16, rng.integers(0, 100, 8),
                           full(16), 0, 0),
        "start_mid_n_new_lt_c": (40, 1, 128, 16, rng.integers(1, 1000, 8),
                                 rng.integers(1, 16, 8), 0, 0),
        "window_late_start": (8, 4, 128, 16, rng.integers(330, 1000, 8),
                              rng.integers(1, 17, 8), 4, 256),
        "page8_split_edge": (40, 1, 128, 8, np.array([113, 120, 127, 128,
                                                      250, 255, 380, 0]),
                             np.r_[full(16)[:7], 0], 0, 0),
        "rows_32": (8, 2, 128, 16, rng.integers(0, 900, 8), full(16), 0, 0),
        "rows_pad_64": (8, 3, 128, 16, rng.integers(0, 900, 8), full(16), 0,
                        0),
        "head_dim_256": (8, 4, 256, 16, rng.integers(0, 900, 8), full(16),
                         0, 0),
        "head_dim_18": (8, 1, 18, 16, rng.integers(0, 900, 8), full(16), 0,
                        0),
        "gemma3": (4, 2, 256, 16, grng.integers(1024, 2001, 8), full(16),
                   None, 1024),
    }
    out = []
    for name, (K, G, D, ps, start, n_new, pstart, window) in spec.items():
        start = np.asarray(start, np.int32)
        n_new = np.asarray(n_new, np.int32)
        total = start + n_new
        if pstart is None:   # the engine's: a chunk's first key is
            pstart = window_start_page(int(start.min()) - window + 1, ps)
        B = len(start)
        MP = (GEMMA_MAX_SEQ if name == "gemma3" else MAX_SEQ) // ps
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
        args = (q, kp, vp, pt, torch.tensor(start, device=dev),
                torch.tensor(total, device=dev))
        op = ops.paged_prefill_attention_gqa
        main = name in ("main", "gemma3")
        check = _idle_slot_is_zero if name == "page8_split_edge" else None
        if main:
            check = _all_of(_walk_bitwise(torch, op, args, kw),
                            _start_bitwise(torch, op, args, kw,
                                           window or 128, 1 - (window or 128)))
        out.append(_paged_case(
            name, op, ops.paged_prefill_attention_ref, args, kw, nbytes,
            flops, check=check,
            report=_paged_standing("paged_prefill_attention") if main
            else None, ps=ps, timed=main))
    return out


def _walk_bitwise(torch, op, args, kw):
    """The check of a paged kernel's main case (``op`` its wrapper, the
    last of ``args`` the slots' totals or lengths): the output is
    bit-identical under pages_bound = the pages the slots need and = the
    table width, and each slot launched alone (at its own live bound)
    gives the bits it gets packed with the others."""
    def check(got):
        q, kp, vp, pt = args[:4]
        ps, MP = kp.shape[1], pt.shape[1]
        need = lambda t: max(1, -(-int(t.max().item()) // ps))
        for bound in (need(args[-1]), MP):
            if not torch.equal(op(*args, **dict(kw, pages_bound=bound)), got):
                raise AssertionError(f"pages_bound={bound} changes the bits "
                                     f"of pages_bound={kw['pages_bound']}")
        for b in range(q.shape[0]):
            one = [t[b:b + 1] for t in args]
            one[1], one[2] = kp, vp
            alone = op(*one, **dict(kw, pages_bound=need(args[-1][b:b + 1])))
            if not torch.equal(alone[0], got[b]):
                raise AssertionError(f"slot {b} alone differs from packed")
        return (f"bit-identical under pages_bound {need(args[-1])} and {MP}, "
                f"and for each of {q.shape[0]} slots alone")
    return check


def _start_bitwise(torch, op, args, kw, window, offset):
    """The check that a window walk (this case's own window, or ``window``
    over its inputs) gives the same bits from page 0 as from the engine's
    first page (``window_start_page``), packed and for each slot launched
    alone from its own first page. A slot's earliest in-window key is
    ``args[4][b] + offset``: len - window in decode, start - window + 1 in
    prefill. ``args[4]`` holds decode's lengths or prefill's starts."""
    from repro_torch.serving.engine import window_start_page

    def check(got):
        q, kp, vp, pt = args[:4]
        ps = kp.shape[1]
        need = lambda t: max(1, -(-int(t.max().item()) // ps))
        first = lambda t: window_start_page(int(t.min().item()) + offset, ps)
        base = dict(kw, window=window)
        zero = op(*args, **dict(base, pages_start=0))
        starts = [first(args[4])]
        if not torch.equal(op(*args, **dict(base, pages_start=starts[0])),
                           zero):
            raise AssertionError(f"pages_start={starts[0]} changes the "
                                 "bits of pages_start=0")
        for b in range(q.shape[0]):
            one = [t[b:b + 1] for t in args]
            one[1], one[2] = kp, vp
            p = first(one[4])
            starts.append(p)
            alone = op(*one, **dict(base, pages_start=p,
                                    pages_bound=max(need(one[-1]), p + 1)))
            if not torch.equal(alone[0], zero[b]):
                raise AssertionError(f"slot {b} alone from page {p} differs "
                                     "from the packed walk from page 0")
        if max(starts) == 0:
            raise AssertionError("no walk started past page 0")
        return (f"window {window}: bit-identical from page 0 and from the "
                f"engine's first page ({starts[0]} packed, "
                f"{starts[1:]} alone)")
    return check


def _all_of(*checks):
    """Several checks of one output, their reports joined."""
    return lambda got: "; ".join(c(got) for c in checks)


def _paged_standing(kname):
    """A paged kernel's standing at the main shape: its time as a share of
    its bytes bound and against its plain version."""
    def report(torch, c, ms, plain_ms, library_ms):
        bound_ms, by = _bound(c["nbytes"], c["flops"])
        log(f"[kernels] {kname}[{c['name']}] {bound_ms / ms:.3f} of the {by} bound "
            f"({bound_ms:.4f} ms), {ms / plain_ms:.3f}x its plain version's "
            f"time ({plain_ms:.4f} ms)")
    return report


def flash_cases(torch, dev):
    """Flash attention, one case per launch mode of the JAX package's
    flash probe and beside it (analysis/pallas_check.py::_probe_flash):
    causal, causal with a window, non-causal with and without one,
    irregular S, G > 1, head_dim 24; head_dim 20 (zero-padded to 8 in the
    kernel) on views of rows 21 floats wide, whose rows are not 16-byte
    aligned, so the kernel copies 4 bytes at a time; head_dim 256
    (gemma3-4b's heads: the largest tiles). "main" is the full tier's
    dense prefill: 8 prompts of 512 tokens, 40 heads of 128, in the
    model's (B, S, H, D) layout; "gemma3" the gemma3-4b dense prefill on a
    local layer: 8 prompts of 2048 tokens, 8 heads of 256 over 4 kv heads,
    window 1024. The plain version expands kv to H heads and runs on
    (B*H, S, D); the library yardstick is one SDPA call (causal, scale 1
    on the pre-scaled q; for "gemma3" a boolean window mask and GQA)."""
    import numpy as np
    from torch.nn import functional as F
    from repro_torch.kernels.flash_attention import ops
    spec = {  # name: (B, S, H, K, D, causal, window)
        "main": (8, 512, 40, 40, 128, True, 0),
        "causal_window": (2, 300, 8, 8, 128, True, 100),
        "non_causal": (2, 200, 8, 8, 64, False, 0),
        "non_causal_window": (1, 150, 4, 2, 32, False, 33),
        "irregular_s": (2, 77, 4, 4, 128, True, 0),
        "gqa": (2, 256, 8, 2, 128, True, 0),
        "head_dim_24": (2, 130, 4, 4, 24, True, 0),
        "head_dim_20": (2, 77, 4, 4, 20, True, 0),
        "head_dim_256": (2, 512, 8, 4, 256, True, 0),
        "gemma3": (8, 2048, 8, 4, 256, True, 1024),
    }
    g = torch.Generator(device=dev).manual_seed(3)
    out = []
    for name, (B, S, H, K, D, causal, window) in spec.items():
        Dr = D + 1 if name == "head_dim_20" else D   # row width in memory
        q = torch.randn((B, S, H, Dr), generator=g, device=dev)[..., :D] \
            * D ** -0.5
        k = torch.randn((B, S, K, Dr), generator=g, device=dev)[..., :D]
        v = torch.randn((B, S, K, Dr), generator=g, device=dev)[..., :D]
        kw = dict(causal=causal, window=window)
        qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
        seen = np.ones((S, S), bool)
        if causal:
            seen &= kp <= qp
        if window:
            seen &= qp - kp < window
        flops = 4 * int(seen.sum()) * B * H * D
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())

        def plain(q=q, k=k, v=v, kw=kw, B=B, S=S, H=H, D=D):
            bhsd = lambda t: t.repeat_interleave(H // t.shape[2], 2) \
                .movedim(2, 1).reshape(B * H, S, D)
            return ops.attention_ref(bhsd(q), bhsd(k), bhsd(v), **kw) \
                .reshape(B, H, S, D).movedim(1, 2)

        library = None
        if name == "main":
            library = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, scale=1.0).transpose(1, 2)
        elif name == "gemma3":
            seen_t = torch.tensor(seen, device=dev)
            library = lambda q=q, k=k, v=v, m=seen_t: \
                F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=m, scale=1.0, enable_gqa=True).transpose(1, 2)
        desc = f"q {B}x{S}x{H}x{D}, kv heads {K} {kw}"
        if Dr != D:
            desc += f", rows {Dr} floats apart"
        out.append(_case(name, desc,
                         lambda q=q, k=k, v=v, kw=kw:
                             ops.flash_attention(q, k, v, **kw),
                         plain, nbytes, flops, library, timed=library
                         is not None, report=_flash_standing
                         if library is not None else None))
    return out


def _flash_standing(torch, c, ms, plain_ms, library_ms):
    """Flash attention's standing at the main shape: its time as a share of
    the fp32 bound, against SDPA's, and the floor of its 3xTF32 route (three
    TF32 products per fp32 product at the tensor cores' peak). Names the
    backend SDPA took, from one call under the profiler: its ATen op and
    its device kernels."""
    from torch.profiler import ProfilerActivity, profile
    bound_ms, _ = _bound(c["nbytes"], c["flops"])
    tc_ms = 1e3 * 3 * c["flops"] / PEAK_TF32_FLOP_PER_S
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        c["library"]()
        torch.cuda.synchronize()
    ops, kernels = [], []
    for e in prof.key_averages():
        if e.key.startswith(("aten::_scaled_dot_product", "aten::_efficient",
                             "aten::_flash", "aten::_cudnn")):
            ops.append(e.key)
        elif getattr(e, "device_type", None) is not None and \
                str(e.device_type).endswith("CUDA"):
            kernels.append(e.key[:100])
    log(f"[kernels] flash_attention[{c['name']}] {bound_ms / ms:.3f} of the fp32 "
        f"bound ({bound_ms:.4f} ms), {ms / library_ms:.3f}x SDPA's time "
        f"({library_ms:.4f} ms); 3xTF32 tensor-core floor {tc_ms:.4f} ms "
        f"(3 x {c['flops']} flop at {PEAK_TF32_FLOP_PER_S / 1e12:g} TFLOP/s)")
    log(f"[kernels] SDPA backend: ops {sorted(set(ops)) or 'none seen'}; "
        f"device kernels {sorted(set(kernels)) or 'none seen'}")


def _dense_plain(torch, ops, q, k, v, valid):
    """The dense decode plain version on the production layout: regrouped
    to (B*K, G, D), returned as (B, H, D)."""
    B, S, K, D = k.shape
    G = q.shape[1] // K
    return ops.decode_attention_ref(
        q.reshape(B * K, G, D), k.movedim(2, 1).reshape(B * K, S, D),
        v.movedim(2, 1).reshape(B * K, S, D),
        valid.repeat_interleave(K, 0)).reshape(B, K * G, D)


def _dense_exact(torch, ops, q, k, v, valid):
    """The check of the dense decode kernel's exact contracts, bit for bit:
    each row launched alone gets the bits it gets in the batch, and the rows
    get the same bits with 256 invalid positions (random K and V) appended
    to the cache, which adds two empty splits and lengthens the last."""
    def check(got):
        for b in range(q.shape[0]):
            alone = ops.decode_attention_kv(q[b:b + 1], k[b:b + 1],
                                            v[b:b + 1], valid[b:b + 1])
            if not torch.equal(alone[0], got[b]):
                raise AssertionError(f"row {b} alone differs from batched")
        B, S, K, D = k.shape
        g = torch.Generator(device=q.device).manual_seed(9)
        tail = lambda t: torch.cat([t, torch.randn(
            (B, 256, K, D), generator=g, device=q.device)], 1)
        longer = torch.cat([valid, torch.zeros(
            (B, 256), dtype=torch.int8, device=q.device)], 1)
        if not torch.equal(ops.decode_attention_kv(q, tail(k), tail(v),
                                                   longer), got):
            raise AssertionError("256 invalid trailing positions change "
                                 "the bits")
        return (f"bit-identical for each of {B} rows alone and with 256 "
                "invalid positions appended")
    return check


def _no_valid_row(torch, ops, q, k, v, valid):
    """The check of a case whose first row has no valid key: that row is
    the mean of V over its S keys (K's heads repeated over their groups),
    over several splits (the merging block writes it) and, on the first 100
    keys, in one split (the split's own block writes it)."""
    def check(got):
        if valid[0].any():
            raise AssertionError("the case's first row has a valid key")
        K = k.shape[2]
        G = q.shape[1] // K
        errs = []
        for n in (k.shape[1], 100):
            out = ops.decode_attention_kv(q, k[:, :n], v[:, :n],
                                          valid[:, :n].contiguous())
            mean = v[0, :n].mean(0).repeat_interleave(G, 0)
            want = _dense_plain(torch, ops, q, k[:, :n], v[:, :n],
                                valid[:, :n])
            errs.append(max((out[0] - mean).abs().max().item(),
                            (out - want).abs().max().item()))
            if not errs[-1] <= KERNEL_TOL:
                raise AssertionError(f"S = {n}: max abs err {errs[-1]}")
        return (f"the no-valid row is the mean of V (max abs err "
                f"{errs[0]:.3g} over {k.shape[1]} keys, {errs[1]:.3g} over "
                "100)")
    return check


def _dense_standing(torch, c, ms, plain_ms, library_ms):
    """The dense decode kernel's standing at a timed shape: its device time
    per call from the profiler (CUDA events around back-to-back calls of a
    kernel this short time the host wrapper), the device time of the
    memset that zeroes its split counts, and its share of the bound."""
    bound_ms, by = _bound(c["nbytes"], c["flops"])
    device_ms = _device_ms(torch, c["kernel"], "decode_kernel")
    memset_ms = _device_ms(torch, c["kernel"], "Memset (Device)")
    log(f"[kernels] decode_attention[{c['name']}] device {device_ms:.4f} ms "
        f"(events {ms:.4f}; the counts' memset {memset_ms:.4f}): "
        f"{bound_ms / device_ms:.3f} of the {by} bound ({bound_ms:.4f} ms)")


def dense_decode_cases(torch, dev):
    """Dense-cache decode, one case per launch mode of the JAX package's
    decode probe and beside it (analysis/pallas_check.py::_probe_decode):
    a valid prefix, irregular S, G > 1 under a random validity, head_dim
    24, and the windowed (attention-sink) layout whose first 512 keys are
    all invalid; a first row with no valid key (``_no_valid_row``). "main"
    is the full tier's decode mid-generation: 8 rows, 40 kv heads of 128
    over the 544-position cache, 528 keys valid, read in place from a
    layer's slice of the (L, B, S, K, D) cache; "gemma3" the gemma3-4b
    dense decode on a local layer mid-generation: 8 rows, 4 kv heads of
    256, G = 2, over the 2080-position cache at position 2064, the 1024-key
    window in ``valid`` (also checked bit for bit, ``_dense_exact``). The
    plain version regroups to (B*K, G, D); the library yardstick is one
    SDPA call with a boolean mask from ``valid`` (and GQA for "gemma3")."""
    import numpy as np
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import ops
    rng = np.random.default_rng(4)
    spec = {  # name: (B, S, K, G, D, validity layout)
        "main": (8, 544, 40, 1, 128, "main"),
        "prefix": (4, 300, 8, 1, 128, "prefix"),
        "irregular_s": (4, 77, 8, 2, 128, "prefix"),
        "gqa": (4, 300, 8, 4, 128, "random"),
        "head_dim_24": (4, 130, 4, 1, 24, "prefix"),
        "windowed_sink": (4, 600, 8, 2, 64, "late_window"),
        "gemma3": (8, 2080, 4, 2, 256, "gemma3"),
        "no_valid_row": (4, 300, 8, 2, 128, "no_valid_row"),
    }
    g = torch.Generator(device=dev).manual_seed(5)
    out = []
    for name, (B, S, K, G, D, layout) in spec.items():
        H = K * G
        cache = torch.randn((2, 2, B, S, K, D), generator=g, device=dev)
        k, v = cache[0, 1], cache[1, 1]       # layer 1 of a 2-layer slab
        q = torch.randn((B, H, D), generator=g, device=dev) * D ** -0.5
        pos = np.arange(S)[None]
        if layout == "main":
            valid = np.repeat(pos <= 527, B, axis=0)
        elif layout in ("prefix", "no_valid_row"):
            valid = pos <= rng.integers(0, S, (B, 1))
            if layout == "no_valid_row":
                valid[0] = False
        elif layout == "random":
            valid = rng.random((B, S)) < 0.6
            valid[:, -1] = True
        elif layout == "gemma3":
            valid = np.repeat((pos <= 2064) & (2064 - pos < 1024), B, axis=0)
        else:
            valid = pos >= rng.integers(512, S, (B, 1))
        n_valid = int(valid.sum())
        valid = torch.tensor(valid.astype(np.int8), device=dev)
        nbytes = 4 * (2 * q.numel() + 2 * n_valid * K * D) + B * S
        flops = 4 * n_valid * K * G * D
        library = None
        if name in ("main", "gemma3"):
            library = lambda q=q, k=k, v=v, valid=valid, gqa=G > 1: \
                F.scaled_dot_product_attention(
                    q[:, :, None], k.movedim(2, 1), v.movedim(2, 1),
                    attn_mask=valid.bool()[:, None, None, :],
                    scale=1.0, enable_gqa=gqa)[:, :, 0]
        check = None
        if name == "gemma3":
            check = _dense_exact(torch, ops, q, k, v, valid)
        elif layout == "no_valid_row":
            check = _no_valid_row(torch, ops, q, k, v, valid)
        out.append(_case(name, f"q {B}x{H}x{D}, cache {B}x{S}x{K}x{D}, "
                         f"{n_valid} valid keys",
                         lambda q=q, k=k, v=v, valid=valid:
                             ops.decode_attention_kv(q, k, v, valid),
                         lambda q=q, k=k, v=v, valid=valid:
                             _dense_plain(torch, ops, q, k, v, valid),
                         nbytes, flops, library, check=check,
                         timed=library is not None,
                         report=_dense_standing if library else None))
    return out


def ssd_cases(torch, dev):
    """SSD chunk scan, one case per launch mode: chunks of 1 and 4
    positions (the pool's ragged tails), "pool" (the pool path's packed
    prefill at mamba2-130m's widths: 8 rows x 16 positions, 24 heads of
    64, state 128), "main" (the dense path: 8 prompts x 2 chunks of 256),
    dt = 0 padding (a ragged row and a whole n_new = 0 row, whose state
    must be exactly 0), steep dA (exp(dA_i - dA_j) overflows above the
    diagonal), the tiny widths (P 16, N 16), the model-layout entry on
    the strided views the dense path hands it, and what the tensor-core
    kernel's tiles make distinct: 17 positions (past its 16-row tiles),
    the widest P and N (128, 256; N 256 at P 64, in 200 KB of shared
    memory), and 300 positions with 3 heads (past its
    256-key score strip, recomputed for the second round of heads). "pool"
    also checks the kernel's exact contracts bit for bit (``_ssd_exact``).
    The plain version holds the whole (l, l) decay matrix; no single
    PyTorch call computes the function."""
    from repro_torch.kernels.ssd_scan import ops
    spec = {  # name: (BC, H, l, P, N, layout)
        "l1": (8, 24, 1, 64, 128, "random"),
        "l4": (8, 24, 4, 64, 128, "random"),
        "pool": (8, 24, 16, 64, 128, "random"),
        "main": (16, 24, 256, 64, 128, "random"),
        "pad_dt0": (8, 24, 16, 64, 128, "pad"),
        "steep_dA": (4, 4, 256, 16, 16, "steep"),
        "tiny_widths": (4, 4, 8, 16, 16, "random"),
        "model_layout": (16, 24, 256, 64, 128, "model"),
        "l17_tile_edge": (8, 24, 17, 64, 128, "random"),
        "p128_n256": (4, 4, 64, 128, 256, "random"),
        "n256_p64": (2, 3, 70, 64, 256, "random"),
        "l300_strip_panels": (2, 3, 300, 64, 128, "random"),
    }
    g = torch.Generator(device=dev).manual_seed(6)
    out = []
    for name, (BC, H, l, P, N, layout) in spec.items():
        u = lambda lo, hi, shape: lo + (hi - lo) * torch.rand(
            shape, generator=g, device=dev)
        x = torch.randn((BC, H, l, P), generator=g, device=dev)
        if layout == "steep":
            dt, A = u(1.0, 5.0, (BC, H, l, 1)), -u(8.0, 16.0, (H,))
        else:
            dt, A = u(0.01, 0.2, (BC, H, l, 1)), -u(1.0, 16.0, (H,))
        if layout == "pad":
            dt[0, :, l // 2:] = 0.0
            dt[-1] = 0.0
        da = torch.cumsum(dt * A[None, :, None, None], dim=2)
        B = torch.randn((BC, l, N), generator=g, device=dev)
        C = torch.randn((BC, l, N), generator=g, device=dev)
        pairs = l * (l + 1) // 2
        # scores once per bc over j <= i; per head the gate (2 flops for
        # exp(dA_i - dA_j), 2 for the products) and P FMAs per pair, and
        # per position w_j (3), B w (N) and the state's N P FMAs
        flops = BC * pairs * 2 * N + BC * H * pairs * (4 + 2 * P) \
            + BC * H * l * (3 + N + 2 * N * P)
        nbytes = 4 * (2 * x.numel() + 2 * dt.numel() + 2 * B.numel()
                      + BC * H * N * P)
        if layout == "model":
            # the dense path's views: x a head-split slice of the conv
            # output (b, S, di + 2N), B and C slices of the same rows
            b, nc, di = BC // 2, 2, H * P
            xbc = torch.randn((b, nc * l, di + 2 * N), generator=g,
                              device=dev)
            xs = xbc[..., :di].reshape(b, nc, l, H, P)
            Bs = xbc[..., di:di + N].reshape(b, nc, l, N)
            Cs = xbc[..., di + N:].reshape(b, nc, l, N)
            dts = dt[..., 0].movedim(1, 2).reshape(b, nc, l, H).contiguous()
            das = da[..., 0].movedim(1, 2).reshape(b, nc, l, H).contiguous()
            args = (xs, dts, das, Bs, Cs)
            kernel = lambda args=args: ops.ssd_chunk(*args)
            plain = lambda args=args: ops.ssd_chunk_reference(*args)
        else:
            args = (x, dt, da, B, C)
            kernel = lambda args=args: ops.ssd_chunk_scan(*args)
            plain = lambda args=args: ops.ssd_chunk_ref(*args)
        check = _state_row_is_zero if layout == "pad" else None
        if name == "pool":
            check = lambda out: _ssd_exact(torch, ops, dev)
        # the products' flops on the tensor cores: the scores once per bc,
        # y and the state per head
        mma_flops = BC * pairs * 2 * N + BC * H * pairs * 2 * P \
            + BC * H * l * 2 * N * P
        c = _case(name, f"x {BC}x{H}x{l}x{P}, B/C {BC}x{l}x{N}, {layout}",
                  kernel, plain, nbytes, flops, check=check,
                  timed=name in ("pool", "model_layout"), scaled=True,
                  report=_ssd_standing)
        c.update(mma_flops=mma_flops)
        out.append(c)
    return out


def _state_row_is_zero(out):
    if out[1][-1].abs().max().item() != 0.0:
        raise AssertionError("the dt = 0 row's state is not exactly 0")


def _device_ms(torch, fn, piece, n=20):
    """Device time per call of ``fn`` from torch.profiler: the kernels
    whose name holds ``piece``, over ``n`` calls back to back."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0) or
                getattr(e, "cuda_time_total", 0.0)
                for e in prof.key_averages() if piece in e.key)
    return total / 1e3 / n


def _ssd_standing(torch, c, ms, plain_ms, library_ms):
    """The SSD kernel's standing at a timed shape: its device time from the
    profiler (at the pool's chunks the CUDA events around back-to-back
    calls time the host wrapper), its share of the bound, and the floor of
    its 3xTF32 route (three TF32 products per fp32 product of the scores,
    y and the state at the tensor cores' peak)."""
    bound_ms, by = _bound(c["nbytes"], c["flops"])
    device_ms = _device_ms(torch, c["kernel"], "ssd_kernel")
    tc_ms = 1e3 * 3 * c["mma_flops"] / PEAK_TF32_FLOP_PER_S
    log(f"[kernels] ssd_chunk_scan[{c['name']}] device {device_ms:.4f} ms "
        f"(events {ms:.4f}): {bound_ms / device_ms:.3f} of the {by} bound "
        f"({bound_ms:.4f} ms); 3xTF32 tensor-core floor {tc_ms:.4f} ms (3 x "
        f"{c['mma_flops']} flop at {PEAK_TF32_FLOP_PER_S / 1e12:g} TFLOP/s)")


def _ssd_padded(torch, dev, n, l, BC=8, H=24, P=64, N=128):
    """A packed pool prefill at mamba2-130m's widths in the model layout:
    xs (BC, 1, l, H, P), dts and dA (BC, 1, l, H), Bs and Cs (BC, 1, l, N).
    Each row's first n positions are the same for every bucket l >= n;
    past n, dt = 0 (dA stays put) and x, B and C are drawn afresh for each
    l, as a packed dispatch pads a chunk."""
    g = torch.Generator(device=dev).manual_seed(1000 + n)
    pad = torch.Generator(device=dev).manual_seed(2000 + 100 * n + l)
    draw = lambda *tail: torch.cat([
        torch.randn((BC, 1, n) + tail, generator=g, device=dev),
        torch.randn((BC, 1, l - n) + tail, generator=pad, device=dev)], 2)
    x, B, C = draw(H, P), draw(N), draw(N)
    dt = 0.01 + 0.19 * torch.rand((BC, 1, n, H), generator=g, device=dev)
    A = -0.5 - 1.5 * torch.rand((H,), generator=g, device=dev)
    dt = torch.cat([dt, torch.zeros((BC, 1, l - n, H), device=dev)], 2)
    return x, dt, torch.cumsum(dt * A, dim=2), B, C


def _ssd_exact(torch, ops, dev):
    """The SSD kernel's exact contracts, bit for bit, through the entry the
    model calls, at the pool's widths: each chunk of a packed launch (BC =
    8) gives the bits it gives alone, at l = 1, 2, 4, 8, 16 and 256; a chunk
    of n real positions padded with dt = 0 to each l bucket from the next
    power of two up to 16 gives the same bits in its n rows of y and in its
    state (n = 1, 2, 3, 5, 7). Raises on the first difference."""
    for l in (1, 2, 4, 8, 16, 256):
        args = _ssd_padded(torch, dev, l, l)
        packed = ops.ssd_chunk(*args)
        for k in range(args[0].shape[0]):
            alone = ops.ssd_chunk(*(t[k:k + 1] for t in args))
            if not all(torch.equal(a[0], p[k]) for a, p in zip(alone,
                                                               packed)):
                raise AssertionError(f"ssd: chunk {k} at l = {l} alone "
                                     "differs from packed")
    for n in (1, 2, 3, 5, 7):
        first = None
        for l in (b for b in (1, 2, 4, 8, 16) if b >= n):
            y, st = ops.ssd_chunk(*_ssd_padded(torch, dev, n, l))
            if first is None:
                first = (l, y[:, :, :n], st)
            elif not (torch.equal(y[:, :, :n], first[1])
                      and torch.equal(st, first[2])):
                raise AssertionError(f"ssd: {n} positions padded to l = {l} "
                                     f"differ from l = {first[0]}")
    torch.cuda.synchronize()
    return ("bit-identical alone and packed (l = 1, 2, 4, 8, 16, 256) and "
            "across l buckets (n = 1, 2, 3, 5, 7)")


KERNELS = (  # name, source, replaces, cases
    ("paged_decode_attention", "src/repro_torch/csrc/paged_decode_attention.cu",
     "src/repro/kernels/paged_decode_attention/kernel.py:106", decode_cases),
    ("paged_prefill_attention",
     "src/repro_torch/csrc/paged_prefill_attention.cu",
     "src/repro/kernels/paged_prefill_attention/kernel.py:109",
     prefill_cases),
    ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:70", flash_cases),
    ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention/kernel.py:63", dense_decode_cases),
    ("ssd_chunk_scan", "src/repro_torch/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan/kernel.py:53", ssd_cases),
)


def _max_err(got, want):
    """Max abs error over every output (a kernel may return a tuple) and
    the largest magnitude of the plain version's outputs."""
    if isinstance(got, tuple):
        pairs = list(zip(got, want))
    else:
        pairs = [(got, want)]
    err = max((a - b).abs().max().item() for a, b in pairs)
    return err, max(b.abs().max().item() for _, b in pairs)


def kernel_phase(torch):
    dev = torch.device("cuda")
    rows = []
    for kname, src, replaces, make_cases in KERNELS:
        worst = 0.0
        row = dict(name=kname, route="cuda", source=src, replaces=replaces,
                   library_ms=None)
        for c in make_cases(torch, dev):
            got = c["kernel"]()
            torch.cuda.synchronize()
            want = c["plain"]()
            err, scale = _max_err(got, want)
            worst = max(worst, err)
            tol = SSD_TOL * max(1.0, scale) if c["scaled"] else KERNEL_TOL
            finite = all(torch.isfinite(t).all().item() for t in
                         (got if isinstance(got, tuple) else (got,)))
            if not (finite and err <= tol):
                raise AssertionError(f"{kname}[{c['name']}]: max abs err "
                                     f"{err} > {tol} (finite: {finite})")
            note = ""
            if c["check"] is not None:
                note = "; " + (c["check"](got) or (
                    "dt = 0 row's state exactly 0" if c["scaled"]
                    else "idle slot exactly 0"))
            log(f"[kernels] {kname}[{c['name']}] {c['desc']}: max abs err "
                f"{err:.3g} <= {tol:.3g}{note}")
            if not c["timed"]:
                continue
            ms = _time_ms(torch, c["kernel"])
            plain_ms = _time_ms(torch, c["plain"])
            bound_ms, bound_by = _bound(c["nbytes"], c["flops"])
            if c["name"] == "main":
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
            lib, lib_ms = "", None
            if c["library"] is not None:
                lib_err = (c["library"]() - want).abs().max().item()
                lib_ms = _time_ms(torch, c["library"])
                if c["name"] == "main":
                    row["library_ms"] = lib_ms
                lib = (f", library {lib_ms:.4f} ms (max abs err "
                       f"{lib_err:.3g})")
            log(f"[kernels] {kname}[{c['name']}] kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms "
                f"({bound_by}: {c['nbytes']} B, {c['flops']} flop)")
            if c["report"] is not None:
                c["report"](torch, c, ms, plain_ms, lib_ms)
        row["max_abs_err"] = worst
        rows.append(row)
    return rows


# ------------------------------------------------------------------ phase 4
def scaled_sibling(full, factor: int):
    """launch/serve.py:81 ``scaled_sibling`` of the JAX package, for a dense
    or SSM config: layers, width, heads and FFN divided together; an
    attention-free stack keeps no KV heads and no FFN."""
    return dataclasses.replace(
        full, n_layers=max(1, full.n_layers // factor),
        d_model=max(8, full.d_model // factor),
        n_heads=max(1, full.n_heads // factor),
        n_kv_heads=max(1, min(full.n_kv_heads, full.n_heads // factor))
        if full.n_kv_heads else 0,
        d_ff=max(8, full.d_ff // factor) if full.d_ff else 0,
        name=full.name + "-s")


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
    rcfg = RouterConfig(vocab_size=QWEN.vocab_size, **DEBERTA_V3_LARGE)
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
    return dict(models=models, cfgs={"half": half_cfg, "full": full_cfg},
                router=probe.with_threshold(threshold), tokens=tokens,
                mask=mask, lens=lens, tier_idx=res.tier_idx,
                responses=res.responses, lengths=res.lengths,
                launches=launches)


# ----------------------------------------------------------------- phase 4b
def dense_hybrid_phase(torch, card: str, smi: str, pool_run: dict):
    """The paper's dense-batch hybrid path on the pool phase's models and
    router: HybridEngine over two dense Engines, the same 16 prompts as
    (16, 512) PAD-padded tokens. One warm-up serve, then one counted and
    timed serve."""
    import numpy as np
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.hybrid import HybridEngine

    engines = {name: Engine(build_model(pool_run["cfgs"][name]),
                            pool_run["models"][name],
                            max_new_tokens=NEW_TOKENS)
               for name in ("half", "full")}
    hy = HybridEngine(pool_run["router"], engines["half"], engines["full"])
    tokens, mask = pool_run["tokens"], pool_run["mask"]
    hy.serve(tokens, mask, seed=1)
    torch.cuda.synchronize()
    hy.meter.tiers.reset()

    per_tier = {name: {"flash": 0, "decode": 0} for name in engines}
    for name, eng in engines.items():
        def counted(q, seed=0, name=name, serve=eng.serve):
            f0, d0 = fa.flash_attention.launches, \
                dec.decode_attention_kv.launches
            out = serve(q, seed)
            per_tier[name]["flash"] += fa.flash_attention.launches - f0
            per_tier[name]["decode"] += dec.decode_attention_kv.launches - d0
            return out
        eng.serve = counted
    fa.flash_attention.launches = 0
    dec.decode_attention_kv.launches = 0
    t0 = time.monotonic()
    res = hy.serve(tokens, mask, seed=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "decode_attention": dec.decode_attention_kv.launches}

    for name, eng in engines.items():
        L = pool_run["cfgs"][name].n_layers
        want = {"flash": L, "decode": L * NEW_TOKENS}
        log(f"[dense] {name}: {eng.stats.requests} requests in "
            f"{eng.stats.batches} batches, kernel launches {per_tier[name]} "
            f"(expected {want}), KV slab "
            f"{eng.stats.kv_high_water_bytes / 1e9:.3f} GB")
        if per_tier[name] != want:
            raise AssertionError(f"tier {name}: launches {per_tier[name]} "
                                 f"!= {want}")
    if not np.array_equal(res.routed_small, pool_run["tier_idx"] == 0):
        raise AssertionError("the dense hybrid path routes differently "
                             "from the pool")
    if hy.meter.tiers.total_calls != N_PROMPTS:
        raise AssertionError(f"meter calls {hy.meter.tiers.summary()} do not "
                             f"sum to {N_PROMPTS}")
    if not (res.lengths >= 1).all() or res.responses.max() >= \
            pool_run["cfgs"]["full"].vocab_size or res.responses.min() < 0:
        raise AssertionError("responses out of range")
    n_tok = int(res.lengths.sum())
    log(f"[dense] {N_PROMPTS} requests ({int(res.routed_small.sum())} half, "
        f"{int((~res.routed_small).sum())} full), {n_tok} tokens in "
        f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s on {card} ({smi})")
    return launches


# ----------------------------------------------------------------- phase 4e
ESC_BUDGET = 0.25     # the calibrated dial's escalation-fraction budget


def _margins_at(torch, bundle, model, context):
    """Top-2 margins of the next-token logits after ``context`` on a
    fresh engine with phase 4's geometry, computed the two ways a stream
    gets them: by prefill of the whole context (a resumed or escalated
    stream) and by one decode step after prefilling all but its last
    token (an uncontended stream)."""
    import numpy as np
    from repro_torch.serving.engine import ContinuousEngine
    margins = []
    for by_decode in (False, True):
        eng = ContinuousEngine(bundle, model, max_new_tokens=2,
                               n_slots=N_SLOTS, max_seq=MAX_SEQ)
        rows = []
        if by_decode:
            def decode(params, cache, tokens, *a, **kw):
                tokens = torch.full_like(tokens, int(context[-1]))
                out = bundle.decode_step_paged(params, cache, tokens,
                                               *a, **kw)
                rows.append(out[0])
                return out
            eng.bundle = dataclasses.replace(bundle,
                                             decode_step_paged=decode)
            eng.submit(np.asarray(context[:-1], np.int32))
        else:
            firsts = _first_logits(eng)
            req = eng.submit(np.asarray(context, np.int32))
        eng.run()
        logits = rows[0] if by_decode else firsts[req.rid]
        top2 = logits.float().topk(2).values
        margins.append(float(top2[0] - top2[1]))
    return margins


def _exact_or_fail(torch, tag, bundle, model, prompt, got, want):
    """``got`` must equal ``want`` token for token. Otherwise print the
    first diverging position and the top-2 margins there, and fail."""
    if got == want:
        return
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    by_prefill, by_decode = _margins_at(
        torch, bundle, model, list(prompt) + list(got[:j]))
    log(f"[faults] {tag}: first divergence at output position {j}: "
        f"{[int(t) for t in got[j:j + 1]]} against "
        f"{[int(t) for t in want[j:j + 1]]}; top-2 logit margin "
        f"there {by_prefill:.3g} by prefill, {by_decode:.3g} by decode")
    raise AssertionError(f"{tag}: tokens differ from position {j}")


def fault_phase(torch, card: str, smi: str, pool_run: dict):
    """Phase 4e, the pool under load, on phase 4's two qwen1.5-32b tiers,
    router and prompts, each pool over fresh engines of phase 4's
    geometry. (a) The escalation dial: an observe-only monitor on "half"
    (the tokens must be phase 4's), a threshold calibrated to escalate at
    most ESC_BUDGET of half's streams, then threshold 0 (every half stream
    escalates at 4 tokens); each escalated continuation must equal the
    full tier's greedy output from prompt + emitted prefix, and the meter
    must bill 16 calls and split the tokens without loss. (b) A fault
    schedule over the pool, each prompt on its phase-4 tier: a
    priority-5 burst of 4 of full's prompts once its shortest prompt
    decodes (so it preempts), page pressure on half leaving about two
    prompts' worth of pages for 20 steps, full stalled for 5 steps, a
    request with deadline_s=0 ("deadline") and a 1024-token prompt
    ("rejected"); the invariants must hold and every preempted stream
    emit phase 4's tokens. (c) K1 and K2 launch on every tier of every
    serve. Returns the launches of the pools' serves."""
    import numpy as np
    from repro_torch.core.routing import ThresholdPolicy
    from repro_torch.core.thresholds import calibrate_abort_threshold
    from repro_torch.data import tokenizer as tok
    from repro_torch.kernels.paged_decode_attention import ops as dec
    from repro_torch.kernels.paged_prefill_attention import ops as pre
    from repro_torch.models.model import build_model
    from repro_torch.serving import faults
    from repro_torch.serving.engine import ContinuousEngine, EscalationMonitor
    from repro_torch.serving.pool import ContinuousPoolEngine

    counters = {"paged_decode_attention": dec.paged_decode_attention_gqa,
                "paged_prefill_attention": pre.paged_prefill_attention_gqa}
    totals = {k: 0 for k in counters}
    bundles = {n: build_model(c) for n, c in pool_run["cfgs"].items()}
    models = pool_run["models"]
    tokens, lens = pool_run["tokens"], pool_run["lens"]
    prompts = [tokens[i, :int(lens[i])] for i in range(N_PROMPTS)]
    phase4 = [list(pool_run["responses"][i, :int(pool_run["lengths"][i])])
              for i in range(N_PROMPTS)]

    def engine(name):
        return ContinuousEngine(bundles[name], models[name],
                                max_new_tokens=NEW_TOKENS, n_slots=N_SLOTS,
                                max_seq=MAX_SEQ)

    def counted_pool(escalation=None):
        """A pool over fresh engines, each tier's K1 and K2 launches
        counted."""
        per_tier = {n: {k: 0 for k in counters} for n in ("half", "full")}
        tiers = []
        for name in ("half", "full"):
            eng = engine(name)
            eng.step = _counting(counters, per_tier, name, eng.step)
            tiers.append((name, eng))
        pool = ContinuousPoolEngine(ThresholdPolicy(pool_run["router"]),
                                    tiers, escalation=escalation)
        return pool, per_tier

    def check_launches(tag, pool, per_tier):
        for t, name in enumerate(pool.names):
            if pool.meter.calls[t] or pool.meter.tokens[t]:
                for k, n in per_tier[name].items():
                    if n <= 0:
                        raise AssertionError(f"{tag}: tier {name}: {k} "
                                             "never launched")
            for k, n in per_tier[name].items():
                totals[k] += n
        log(f"[faults] {tag}: kernel launches {per_tier}")

    def check_meter(tag, pool, reqs):
        m = pool.meter
        if m.total_calls != N_PROMPTS:
            raise AssertionError(f"{tag}: {m.total_calls} calls, not "
                                 f"{N_PROMPTS}")
        if m.tokens.sum() != sum(r.n_generated for r in reqs):
            raise AssertionError(f"{tag}: token split {m.tokens} does not "
                                 "sum to the streams' tokens")
        if m.escalations[0] != len(pool.escalation_log):
            raise AssertionError(f"{tag}: {m.escalations} escalations "
                                 f"against {len(pool.escalation_log)} "
                                 "hand-offs")

    def check_continuations(tag, pool, reqs):
        """Each escalated stream's tokens after its hand-off against the
        full tier's greedy output from prompt + emitted prefix (a fresh
        engine, all continuations submitted together)."""
        ref = engine("full")
        index = {r.rid: i for i, r in enumerate(reqs)}
        runs = []
        for rid, _, _, k in pool.escalation_log:
            i = index[rid]
            cont = np.concatenate([prompts[i],
                                   np.asarray(reqs[i].out[:k], np.int32)])
            runs.append((i, k, cont, ref.submit(
                cont, max_new_tokens=NEW_TOKENS - k)))
        ref.run()
        for i, k, cont, r in runs:
            got = reqs[i].out[k:]
            _exact_or_fail(torch, f"{tag} prompt {i} after {k} tokens",
                           bundles["full"], models["full"], cont, got,
                           r.out[:len(got)])
        return len(runs)

    t0 = time.monotonic()
    # (a) the escalation dial
    pool, per_tier = counted_pool()
    for eng in pool.engines[:1]:
        eng.escalation = EscalationMonitor(abort_threshold=None)
    reqs, tier_idx, _ = pool.submit(tokens, pool_run["mask"])
    pool.run()
    if not np.array_equal(tier_idx, pool_run["tier_idx"]):
        raise AssertionError("the pool routes differently from phase 4")
    for i, r in enumerate(reqs):
        _exact_or_fail(torch, f"observe-only prompt {i}",
                       bundles[pool.names[tier_idx[i]]],
                       models[pool.names[tier_idx[i]]], prompts[i], r.out,
                       phase4[i])
    check_launches("observe-only", pool, per_tier)
    half = [r for r, t in zip(reqs, tier_idx) if t == 0]
    peaks = [r.esc_peak_score for r in half]
    thr = calibrate_abort_threshold(peaks, ESC_BUDGET)
    log(f"[faults] observe-only: {len(half)} half streams, peaks "
        f"{min(peaks):.4f}-{max(peaks):.4f}; threshold at a "
        f"{ESC_BUDGET} budget: {thr:.6f}")
    for tag, mon in (("calibrated", EscalationMonitor(abort_threshold=thr)),
                     ("threshold-0", EscalationMonitor(abort_threshold=0.0,
                                                       min_tokens=4))):
        pool, per_tier = counted_pool(escalation=[mon])
        reqs, _, _ = pool.submit(tokens, pool_run["mask"])
        pool.run()
        check_meter(tag, pool, reqs)
        n = check_continuations(tag, pool, reqs)
        check_launches(tag, pool, per_tier)
        frac = n / len(half)
        log(f"[faults] {tag}: {n} of {len(half)} half streams escalated "
            f"({frac:.3f}; budget {ESC_BUDGET if tag == 'calibrated' else 1.0}), "
            f"continuations greedy-exact on the full tier; meter calls "
            f"{pool.meter.calls.tolist()}, tokens "
            f"{pool.meter.tokens.tolist()}, esc_tokens "
            f"{pool.meter.esc_tokens.tolist()}")
        if tag == "calibrated" and frac > ESC_BUDGET:
            raise AssertionError(f"calibrated dial escalated {frac} > "
                                 f"{ESC_BUDGET}")
        stayed = [i for i, r in enumerate(reqs) if tier_idx[i] == 0
                  and not r.escalations and tok.EOS not in r.out[:4]]
        if tag == "threshold-0" and stayed:
            raise AssertionError(f"threshold 0 left half streams {stayed} "
                                 "on half past 4 tokens")

    # (b) the fault schedule
    pool, per_tier = counted_pool()
    full_idx = [i for i in range(N_PROMPTS) if pool_run["tier_idx"][i]]
    chunk = pool.engine("full").prefill_chunk
    burst_step = -(-int(min(lens[i] for i in full_idx)) // chunk) + 1
    burst = tuple(prompts[i] for i in sorted(
        full_idx, key=lambda i: lens[i])[:4])
    half_cache = pool.engine("half").cache
    two = 2 * half_cache.pages_for(int(np.mean(
        [lens[i] for i in range(N_PROMPTS) if not pool_run["tier_idx"][i]])))
    h = faults.FaultHarness(pool, [
        faults.PagePressure("half", start=0, steps=20,
                            pages=half_cache.free_pages - two),
        faults.AdmissionBurst(step=burst_step, prompts=burst, tier="full",
                              priority=5),
        faults.TierStall("full", start=burst_step + 2, steps=5),
    ])
    base = [h.submit(pool.names[pool_run["tier_idx"][i]], prompts[i])
            for i in range(N_PROMPTS)]
    rng = np.random.default_rng(4)
    late = h.submit("half", prompts[0], deadline_s=0.0)
    huge = h.submit("full", rng.integers(4, pool_run["cfgs"]["full"]
                                         .vocab_size, MAX_SEQ)
                    .astype(np.int32))
    h.run()
    bad = h.check_invariants()
    if bad:
        raise AssertionError(f"fault schedule invariants: {bad}")
    if late.finish_reason != "deadline" or huge.finish_reason != "rejected":
        raise AssertionError(f"deadline request {late.finish_reason!r}, "
                             f"1024-token prompt {huge.finish_reason!r}")
    st = {n: pool.engine(n).stats for n in pool.names}
    if st["full"].preemptions <= 0:
        raise AssertionError("the burst preempted nothing")
    preempted = [(i, r) for i, r in enumerate(base) if r.preemptions]
    for i, r in preempted:
        if r.finish_reason not in ("eos", "length"):
            raise AssertionError(f"preempted prompt {i} finished "
                                 f"{r.finish_reason!r}")
        name = pool.names[pool_run["tier_idx"][i]]
        _exact_or_fail(torch, f"preempted prompt {i}", bundles[name],
                       models[name], prompts[i], r.out, phase4[i])
    check_launches("faults", pool, per_tier)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    log(f"[faults] schedule: {len(h.retired)} retired; preempted streams "
        f"{len(preempted)} (greedy-exact against phase 4); "
        + "; ".join(f"{n}: preemptions {s.preemptions}, reprefill_tokens "
                    f"{s.reprefill_tokens}, stall_steps {s.stall_steps}, "
                    f"admission_stalls {s.admission_stalls}, sheds "
                    f"{s.sheds}, deadline_misses {s.deadline_misses}"
                    for n, s in st.items())
        + f"; meter {pool.meter.summary()}")
    log(f"[faults] phase wall {wall:.3f} s on {card} ({smi}); K1 and K2 "
        f"launches over the pools' serves {totals}")
    return totals


# ----------------------------------------------------------------- phase 4c
def _counting(counters, per_tier, name, fn):
    """``fn`` wrapped to add each counter's launches during the call to
    ``per_tier[name]``. ``counters``: {key: wrapper with .launches}."""
    def run(*args, **kw):
        before = {k: w.launches for k, w in counters.items()}
        out = fn(*args, **kw)
        for k, w in counters.items():
            per_tier[name][k] += w.launches - before[k]
        return out
    return run


def ssm_phase(torch, card: str, smi: str, router):
    """The SSM slice: two mamba2-130m tiers behind the pool phase's router
    encoder (its threshold set to these prompts' median score), first
    through the continuous pool, then through the dense hybrid path. Every
    kernel counter is watched on both tiers: the SSD chunk kernel must
    launch layers x prefill dispatches times on the pool and layers times
    per prefill on the dense path, and no other kernel may launch."""
    import numpy as np
    from repro_torch.configs.mamba2_130m import CONFIG as MAMBA
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_decode_attention import ops as pdec
    from repro_torch.kernels.paged_prefill_attention import ops as ppre
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.core.routing import ThresholdPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine, Engine
    from repro_torch.serving.hybrid import HybridEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    dev = torch.device("cuda")
    counters = {"ssd": ssd.ssd_chunk_scan, "paged_decode":
                pdec.paged_decode_attention_gqa, "paged_prefill":
                ppre.paged_prefill_attention_gqa, "flash":
                fa.flash_attention, "decode": dec.decode_attention_kv}
    cfgs = {"half": scaled_sibling(MAMBA, 2), "full": MAMBA}
    t0 = time.monotonic()
    models, bundles = {}, {}
    for i, (name, cfg) in enumerate(cfgs.items()):
        bundles[name] = build_model(cfg)
        models[name] = bundles[name].init(
            torch.Generator(device=dev).manual_seed(200 + i), dev)
        log(f"[ssm] tier {name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.ssm_nheads} SSD heads of "
            f"{cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
            f"{cfg.ssm_chunk}, vocab {cfg.vocab_size}, "
            f"{cfg.param_count() / 1e6:.1f} M params")
    torch.cuda.synchronize()
    log(f"[ssm] random init on the card: {time.monotonic() - t0:.1f} s")

    rng = np.random.default_rng(10)
    lens = rng.integers(32, 513, N_PROMPTS)
    tokens = rng.integers(4, MAMBA.vocab_size, (N_PROMPTS, 512)
                          ).astype(np.int32)
    mask = (np.arange(512)[None] < lens[:, None]).astype(np.float32)
    tokens[mask == 0] = 0
    threshold = float(np.median(router.scores(tokens, mask).cpu().numpy()))
    router = router.with_threshold(threshold)

    # ---- the continuous pool
    tiers = [(name, ContinuousEngine(bundles[name], models[name],
                                     max_new_tokens=NEW_TOKENS,
                                     n_slots=N_SLOTS, max_seq=MAX_SEQ))
             for name in cfgs]
    for _, eng in tiers:   # warm-up outside the counts
        eng.serve(tokens[:2, :48], seed=1)
        eng.stats = type(eng.stats)()
    pool = ContinuousPoolEngine(ThresholdPolicy(router), tiers)
    per_tier = {name: dict.fromkeys(counters, 0) for name in cfgs}
    for name, eng in tiers:
        eng.step = _counting(counters, per_tier, name, eng.step)
    for w in counters.values():
        w.launches = 0
    t0 = time.monotonic()
    res = pool.serve(tokens, mask, seed=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    pool_launches = ssd.ssd_chunk_scan.launches
    summary = pool.meter.summary()
    for name, eng in tiers:
        want = {**dict.fromkeys(counters, 0),
                "ssd": cfgs[name].n_layers * eng.stats.prefill_dispatches}
        log(f"[ssm] pool {name}: calls {summary[name]['calls']}, tokens "
            f"{summary[name]['gen_tokens']}, decode steps "
            f"{eng.stats.decode_steps}, prefill dispatches "
            f"{eng.stats.prefill_dispatches}, kernel launches "
            f"{per_tier[name]} (expected {want}), state "
            f"{eng.rstate.state_bytes / 1e6:.1f} MB, free pages "
            f"{eng.cache.free_pages} of {eng.cache.num_pages}")
        if per_tier[name] != want or want["ssd"] <= 0:
            raise AssertionError(f"ssm pool tier {name}: launches "
                                 f"{per_tier[name]} != {want}")
        if eng.cache.free_pages != eng.cache.num_pages - 1:
            raise AssertionError(f"ssm pool tier {name}: pages leaked")
    if not np.array_equal(res.tier_idx, (res.scores < threshold)):
        raise AssertionError("ssm pool: tier_idx disagrees with score < "
                             "threshold")
    if sum(v["calls"] for v in summary.values()) != N_PROMPTS \
            or not 0 < res.tier_idx.sum() < N_PROMPTS:
        raise AssertionError(f"ssm pool: calls {summary}")
    if not (res.lengths >= 1).all() or res.responses.max() >= \
            MAMBA.vocab_size or res.responses.min() < 0:
        raise AssertionError("ssm pool: responses out of range")
    n_tok = int(res.lengths.sum())
    log(f"[ssm] pool: {N_PROMPTS} requests retired "
        f"({np.bincount(res.tier_idx, minlength=2).tolist()} half/full), "
        f"threshold {threshold:.6f}, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s on {card} ({smi})")

    # ---- the dense hybrid path on the same models and router
    engines = {name: Engine(bundles[name], models[name],
                            max_new_tokens=NEW_TOKENS) for name in cfgs}
    hy = HybridEngine(router, engines["half"], engines["full"])
    hy.serve(tokens, mask, seed=1)   # warm-up outside the counts
    torch.cuda.synchronize()
    hy.meter.tiers.reset()
    per_tier = {name: dict.fromkeys(counters, 0) for name in cfgs}
    for name, eng in engines.items():
        eng.serve = _counting(counters, per_tier, name, eng.serve)
    for w in counters.values():
        w.launches = 0
    t0 = time.monotonic()
    dres = hy.serve(tokens, mask, seed=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    dense_launches = ssd.ssd_chunk_scan.launches
    for name, eng in engines.items():
        want = {**dict.fromkeys(counters, 0), "ssd": cfgs[name].n_layers}
        log(f"[ssm] dense {name}: {eng.stats.requests} requests in "
            f"{eng.stats.batches} batches, kernel launches {per_tier[name]} "
            f"(expected {want}: one SSD launch per layer per prefill, none "
            "in decode)")
        if per_tier[name] != want:
            raise AssertionError(f"ssm dense tier {name}: launches "
                                 f"{per_tier[name]} != {want}")
    if not np.array_equal(dres.routed_small, res.tier_idx == 0):
        raise AssertionError("ssm: the dense hybrid path routes "
                             "differently from the pool")
    if hy.meter.tiers.total_calls != N_PROMPTS or not (dres.lengths >= 1) \
            .all() or dres.responses.max() >= MAMBA.vocab_size \
            or dres.responses.min() < 0:
        raise AssertionError("ssm dense: calls or responses out of range")
    n_tok = int(dres.lengths.sum())
    log(f"[ssm] dense: {N_PROMPTS} requests ({int(dres.routed_small.sum())} "
        f"half, {int((~dres.routed_small).sum())} full), {n_tok} tokens in "
        f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s on {card} ({smi})")
    return dict(model=models["full"], cfg=MAMBA,
                launches=pool_launches + dense_launches)


# ----------------------------------------------------------------- phase 4d
def _watch_attention(torch, attention, log_to):
    """Wrap the attention kernels' wrappers where the model calls them
    (``repro_torch.models.attention``'s names) to count each call in
    ``log_to`` (a Counter) under (tier, kernel, mode): the paged kernels'
    (window > 0, pages_start > 0), flash attention's (window, head_dim);
    dense decode's validity counts (the most valid keys of a row, a device
    tensor, read after the run) go to ``log_to["valid", tier]``. The
    tier is ``tier[0]``, set by the caller. Returns (tier, restore)."""
    tier = [None]
    names = ("paged_decode_attention_gqa", "paged_prefill_attention_gqa",
             "flash_attention", "decode_attention_kv")
    originals = {n: getattr(attention, n) for n in names}

    def mode(n, args, kw):
        if n == "flash_attention":
            return kw.get("window", 0), args[0].shape[-1]
        return kw.get("window", 0) > 0, kw.get("pages_start", 0) > 0

    def watched(n, fn):
        def run(*args, **kw):
            if n == "decode_attention_kv":
                log_to.setdefault(("valid", tier[0]), []).append(
                    args[3].sum(-1, dtype=torch.int32).max())
            else:
                log_to[(tier[0], n) + mode(n, args, kw)] += 1
            return fn(*args, **kw)
        return run

    for n, fn in originals.items():
        setattr(attention, n, watched(n, fn))

    def restore():
        for n, fn in originals.items():
            setattr(attention, n, fn)
    return tier, restore


def gemma_setup(torch):
    """Phase 4d's models, router and prompts, on the card, from seeds: the
    "half" and "full" gemma3-4b tiers, a router at DeBERTa-v3-large's
    widths over gemma's vocabulary and 2048 positions gating at the
    prompts' median score, and 16 prompts of 1040-1984 tokens as
    (16, 2048) PAD-padded tokens and mask."""
    import numpy as np
    from repro_torch.configs.gemma3_4b import CONFIG as GEMMA
    from repro_torch.core.routing import HybridRouter
    from repro_torch.models.encoder import RouterConfig, init_router_encoder
    from repro_torch.models.model import build_model
    dev = torch.device("cuda")
    cfgs = {"half": scaled_sibling(GEMMA, 2), "full": GEMMA}
    bundles = {n: build_model(c) for n, c in cfgs.items()}
    models = {n: bundles[n].init(torch.Generator(device=dev)
                                 .manual_seed(300 + i), dev)
              for i, n in enumerate(cfgs)}
    rcfg = RouterConfig(vocab_size=GEMMA.vocab_size,
                        **dict(DEBERTA_V3_LARGE, max_seq=GEMMA_MAX_SEQ))
    probe = HybridRouter(init_router_encoder(
        rcfg, torch.Generator(device=dev).manual_seed(307), dev), rcfg, 0.0)
    rng = np.random.default_rng(30)
    lens = rng.integers(1040, 1985, N_PROMPTS)
    tokens = rng.integers(4, GEMMA.vocab_size, (N_PROMPTS, GEMMA_MAX_SEQ)
                          ).astype(np.int32)
    mask = (np.arange(GEMMA_MAX_SEQ)[None] < lens[:, None]).astype(np.float32)
    tokens[mask == 0] = 0
    router = probe.with_threshold(float(np.median(
        probe.scores(tokens, mask).cpu().numpy())))
    return dict(cfgs=cfgs, bundles=bundles, models=models, router=router,
                tokens=tokens, mask=mask, lens=lens)


def gemma_phase(torch, card: str, smi: str):
    """Phase 4d, the sliding-window slice at the published widths and
    depth: two gemma3-4b tiers ("full": the published config, 34 layers,
    29 of them local with a 1024-token window; "half": scaled_sibling(., 2),
    17 layers) behind a router at DeBERTa-v3-large's widths over gemma's
    vocabulary and 2048 positions. 16 prompts of 1040-1984 tokens, so every
    local layer's walk starts past page 0. Runs, in turn: the continuous
    pool (K1 and K2 on both tiers, some launches windowed with a late
    first page; no page leaked); the half tier over the whole stream under
    the live and the static walk (the same greedy tokens); one-shot
    admission of four prompts on the full tier (K4 at window 1024, head_dim
    256; first-token logits against chunked admission's within
    DEVICE_TOL); the dense hybrid path (routes as the pool did; K4 once
    per layer per prefill, windowed on local layers; K5 once per layer per
    decode step, local layers' validity within the window). Returns the
    full model and the main paths' launches."""
    import collections
    import numpy as np
    from repro_torch.core.routing import ThresholdPolicy
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_decode_attention import ops as pdec
    from repro_torch.kernels.paged_prefill_attention import ops as ppre
    from repro_torch.models import attention
    from repro_torch.serving.engine import ContinuousEngine, Engine
    from repro_torch.serving.hybrid import HybridEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    setup = gemma_setup(torch)
    torch.cuda.synchronize()
    cfgs, bundles, models = setup["cfgs"], setup["bundles"], setup["models"]
    router, tokens, mask = setup["router"], setup["tokens"], setup["mask"]
    lens, GEMMA = setup["lens"], cfgs["full"]
    W, Dh = GEMMA.sliding_window, GEMMA.resolved_head_dim
    for name, cfg in cfgs.items():
        n_local = sum(cfg.layer_window(j) > 0 for j in range(cfg.n_layers))
        log(f"[gemma] tier {name}: {cfg.n_layers} layers ({n_local} local, "
            f"window {cfg.sliding_window}), d_model {cfg.d_model}, "
            f"{cfg.n_heads} heads of {cfg.resolved_head_dim} over "
            f"{cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} B params")
    log(f"[gemma] random init and the router's threshold on the card: "
        f"{time.monotonic() - t0:.1f} s")
    prompts = [tokens[i, :n] for i, n in enumerate(lens)]
    threshold = router.threshold
    calls = collections.Counter()
    tier, restore = _watch_attention(torch, attention, calls)
    try:
        # ---- the continuous pool
        kw = dict(max_new_tokens=NEW_TOKENS, n_slots=N_SLOTS,
                  max_seq=GEMMA_MAX_SEQ)
        tiers = [(name, ContinuousEngine(bundles[name], models[name], **kw))
                 for name in cfgs]
        for name, eng in tiers:   # warm-up outside the counts
            tier[0] = "warm-up"
            eng.serve(tokens[:2, :48], seed=1)
            eng.stats = type(eng.stats)()
            eng._decode_bounds.clear()
            eng._chunk_shapes.clear()
            eng.step = _in_tier(tier, name, eng.step)
        pool = ContinuousPoolEngine(ThresholdPolicy(router), tiers)
        calls.clear()
        pdec.paged_decode_attention_gqa.launches = 0
        ppre.paged_prefill_attention_gqa.launches = 0
        t0 = time.monotonic()
        res = pool.serve(tokens, mask, seed=0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {"paged_decode_attention":
                    pdec.paged_decode_attention_gqa.launches,
                    "paged_prefill_attention":
                    ppre.paged_prefill_attention_gqa.launches}
        summary = pool.meter.summary()
        for name, eng in tiers:
            by_mode = {f"{k[1].split('_')[1]} window={int(k[2])} "
                       f"late={int(k[3])}": n for k, n in sorted(calls.items())
                       if k[0] == name}
            log(f"[gemma] pool {name}: calls {summary[name]['calls']}, "
                f"tokens {summary[name]['gen_tokens']}, decode steps "
                f"{eng.stats.decode_steps}, prefill dispatches "
                f"{eng.stats.prefill_dispatches}, calls by mode "
                f"{by_mode}, free pages {eng.cache.free_pages} of "
                f"{eng.cache.num_pages}")
            log(f"[gemma] pool {name}: decode (bound, wstart) "
                f"{sorted(eng._decode_bounds)}; prefill (batch, width, bound,"
                f" wstart) {sorted(eng._chunk_shapes)}")
            for k in ("paged_decode_attention_gqa",
                      "paged_prefill_attention_gqa"):
                if calls[(name, k, True, True)] <= 0 or \
                        calls[(name, k, False, False)] <= 0:
                    raise AssertionError(f"gemma pool tier {name}: {k} ran "
                                         "no windowed late-start launch or "
                                         "no global one")
            if eng.cache.free_pages != eng.cache.num_pages - 1:
                raise AssertionError(f"gemma pool tier {name}: pages leaked")
        # the watch counts calls where the model makes them; the wrappers
        # count their own launches: on the card the two must agree
        watched = {"paged_decode_attention": sum(
                       n for k, n in calls.items()
                       if k[1] == "paged_decode_attention_gqa"),
                   "paged_prefill_attention": sum(
                       n for k, n in calls.items()
                       if k[1] == "paged_prefill_attention_gqa")}
        if watched != launches:
            raise AssertionError(f"gemma pool: calls by mode {watched} != "
                                 f"the wrappers' launches {launches}")
        if not np.array_equal(res.tier_idx, (res.scores < threshold)) \
                or sum(v["calls"] for v in summary.values()) != N_PROMPTS \
                or not 0 < res.tier_idx.sum() < N_PROMPTS:
            raise AssertionError(f"gemma pool: routing or calls {summary}")
        if not (res.lengths >= 1).all() or res.responses.max() >= \
                GEMMA.vocab_size or res.responses.min() < 0:
            raise AssertionError("gemma pool: responses out of range")
        n_tok = int(res.lengths.sum())
        log(f"[gemma] pool: {N_PROMPTS} requests retired "
            f"({np.bincount(res.tier_idx, minlength=2).tolist()} half/full),"
            f" threshold {threshold:.6f}, K1 {launches['paged_decode_attention']}"
            f" and K2 {launches['paged_prefill_attention']} launches, {n_tok} "
            f"tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s on {card} "
            f"({smi})")

        # ---- the half tier over the whole stream, live and static walks
        live = tiers[0][1]
        static = ContinuousEngine(bundles["half"], models["half"],
                                  walk_bound="static", **kw)
        outs = {}
        for walk, eng in (("live", live), ("static", static)):
            tier[0] = walk
            t0 = time.monotonic()
            reqs = [eng.submit(p) for p in prompts]
            eng.run()
            torch.cuda.synchronize()
            outs[walk] = [r.out for r in reqs]
            n_tok = sum(map(len, outs[walk]))
            log(f"[gemma] half tier, {walk} walk: {n_tok} tokens in "
                f"{time.monotonic() - t0:.3f} s, decode (bound, wstart) "
                f"{sorted(eng._decode_bounds)}")
        if outs["live"] != outs["static"]:
            raise AssertionError("gemma half tier: the live and the static "
                                 "walk emit different greedy tokens")
        if static._decode_bounds != {(static.cache.max_pages_per_slot, 0)}:
            raise AssertionError("the static walk started late")
        log(f"[gemma] half tier: live and static walks emit the same greedy "
            f"tokens for all {N_PROMPTS} prompts")
        del static

        # ---- one-shot admission against chunked, on the full tier
        firsts = {}
        chunked = tiers[1][1]
        one_shot = ContinuousEngine(bundles["full"], models["full"],
                                    prefill_chunk=0, **kw)
        for how, eng in (("one-shot", one_shot), ("chunked", chunked)):
            firsts[how] = _first_logits(eng)
            tier[0] = how
            reqs = [eng.submit(p, max_new_tokens=2) for p in prompts[:4]]
            eng.run()
            torch.cuda.synchronize()
            firsts[how] = [firsts[how][r.rid] for r in reqs]
        del one_shot, eng
        n_local = sum(GEMMA.layer_window(j) > 0
                      for j in range(GEMMA.n_layers))
        want = {("one-shot", "flash_attention", W, Dh): 4 * n_local,
                ("one-shot", "flash_attention", 0, Dh):
                    4 * (GEMMA.n_layers - n_local)}
        got = {k: calls[k] for k in want}
        if got != want or any(k[:2] == ("one-shot",
                                        "paged_prefill_attention_gqa")
                              for k in calls):
            raise AssertionError(f"one-shot admission launches {got} != "
                                 f"{want}")
        errs = [(a - b).abs().max().item()
                for a, b in zip(firsts["one-shot"], firsts["chunked"])]
        same = [int(a.argmax()) == int(b.argmax())
                for a, b in zip(firsts["one-shot"], firsts["chunked"])]
        log(f"[gemma] one-shot admission of 4 prompts ({lens[:4].tolist()} "
            f"tokens) on the full tier: K4 launches {got}; first-token "
            f"logits against chunked admission's: max abs err "
            f"{max(errs):.3g} <= DEVICE_TOL {DEVICE_TOL} (each "
            f"{[f'{e:.3g}' for e in errs]}), greedy first tokens agree "
            f"{same}")
        if not max(errs) <= DEVICE_TOL:
            raise AssertionError(f"one-shot vs chunked first-token logits "
                                 f"{max(errs)} > {DEVICE_TOL}")
        del tiers, pool, live, chunked
        gc.collect()     # the engines' wrapped methods hold them in cycles
        torch.cuda.empty_cache()

        # ---- the dense hybrid path on the same models and router
        engines = {name: Engine(bundles[name], models[name],
                                max_new_tokens=NEW_TOKENS) for name in cfgs}
        for name, eng in engines.items():   # warm-up outside the counts
            tier[0] = "warm-up"
            eng.serve(tokens[:2, :48], seed=1)
            eng.stats = type(eng.stats)()
            eng.serve = _in_tier(tier, name, eng.serve)
        hy = HybridEngine(router, engines["half"], engines["full"])
        calls.clear()
        fa.flash_attention.launches = 0
        dec.decode_attention_kv.launches = 0
        t0 = time.monotonic()
        dres = hy.serve(tokens, mask, seed=0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches.update(flash_attention=fa.flash_attention.launches,
                        decode_attention=dec.decode_attention_kv.launches)
        for name, cfg in cfgs.items():
            L = cfg.n_layers
            n_local = sum(cfg.layer_window(j) > 0 for j in range(L))
            valid = torch.stack(calls[("valid", name)]).cpu().numpy()
            got = {"flash local": calls[(name, "flash_attention", W, Dh)],
                   "flash global": calls[(name, "flash_attention", 0, Dh)],
                   "decode in window": int((valid <= W).sum()),
                   "decode past window": int((valid > W).sum())}
            want = {"flash local": n_local, "flash global": L - n_local,
                    "decode in window": n_local * NEW_TOKENS,
                    "decode past window": (L - n_local) * NEW_TOKENS}
            log(f"[gemma] dense {name}: {engines[name].stats.requests} "
                f"requests, calls {got} (expected {want}), KV slab "
                f"{engines[name].stats.kv_high_water_bytes / 1e9:.3f} GB")
            if got != want:
                raise AssertionError(f"gemma dense tier {name}: {got} != "
                                     f"{want}")
        watched = {"flash_attention": sum(
                       n for k, n in calls.items()
                       if k[1:2] == ("flash_attention",)),
                   "decode_attention": sum(
                       len(v) for k, v in calls.items() if k[0] == "valid")}
        if watched != {k: launches[k] for k in watched}:
            raise AssertionError(f"gemma dense: calls {watched} != the "
                                 f"wrappers' launches {launches}")
        if launches["flash_attention"] != sum(c.n_layers for c in
                                              cfgs.values()) \
                or launches["decode_attention"] != NEW_TOKENS * sum(
                    c.n_layers for c in cfgs.values()):
            raise AssertionError(f"gemma dense launches {launches}")
        if not np.array_equal(dres.routed_small, res.tier_idx == 0):
            raise AssertionError("gemma: the dense hybrid path routes "
                                 "differently from the pool")
        if not (dres.lengths >= 1).all() or dres.responses.max() >= \
                GEMMA.vocab_size or dres.responses.min() < 0:
            raise AssertionError("gemma dense: responses out of range")
        n_tok = int(dres.lengths.sum())
        log(f"[gemma] dense: {N_PROMPTS} requests "
            f"({int(dres.routed_small.sum())} half, "
            f"{int((~dres.routed_small).sum())} full), {n_tok} tokens in "
            f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s on {card} ({smi})")
        log(f"[gemma] peak memory in phase 4d: {_peak(torch)}")
    finally:
        restore()
    return dict(model=models["full"], cfg=GEMMA, launches=launches)


def _in_tier(tier, name, fn):
    """``fn`` run with ``tier[0]`` set to ``name`` (the attention watch's
    tier)."""
    def run(*args, **kw):
        tier[0] = name
        return fn(*args, **kw)
    return run


def _first_logits(eng):
    """Record each request's first-token logits on ``eng``: the rows of
    the prefill logits (one-shot admission, ``bundle.prefill``) or of the
    LM head over finished prompts (chunked admission, ``bundle.lm_head``),
    in the order the engine then pushes their first tokens. Returns
    {rid: logits (V,) on the card}, filled as the engine runs."""
    pending, firsts = [], {}
    bundle = eng.bundle

    def prefill(*args, **kw):
        logits, cache = bundle.prefill(*args, **kw)
        pending.extend(logits)
        return logits, cache

    def lm_head(*args, **kw):
        out = bundle.lm_head(*args, **kw)
        pending.extend(out[:, 0])
        return out

    push = eng._push_token

    def push_token(req, token):
        if req.rid not in firsts:
            firsts[req.rid] = pending.pop(0)
        return push(req, token)

    eng.bundle = dataclasses.replace(bundle, prefill=prefill,
                                     lm_head=lm_head)
    eng._push_token = push_token
    return firsts


# ------------------------------------------------------------------ phase 5
def _compare(torch, tag, gpu_logits, cpu_logits):
    """Max abs error of card against CPU logits; greedy tokens must agree
    on every row whose CPU top-2 margin exceeds DEVICE_TOL."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(gpu_logits, cpu_logits)):
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        top2 = b.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > DEVICE_TOL
        same = (a.argmax(-1) == b.argmax(-1))[sure]
        log(f"[device-vs-cpu] {tag} logits {i} "
            f"({'prefill' if i == 0 else 'decode'}): max abs err {err:.3g}; "
            f"greedy tokens agree on {int(same.sum())}/{int(sure.sum())} "
            f"rows with a top-2 margin > {DEVICE_TOL}")
        if not torch.isfinite(a).all() or not same.all():
            raise AssertionError(f"{tag}: card and CPU disagree on greedy "
                                 "tokens")
    if not worst <= DEVICE_TOL:
        raise AssertionError(f"{tag}: card vs CPU logits {worst} > "
                             f"{DEVICE_TOL}")


def device_vs_cpu_phase(torch, full_model, full_cfg, depth=1,
                        lens=(16, 11)):
    """A full tier's first ``depth`` layers at full width, on the card and
    on the CPU, same weights, same inputs: two prompts of ``lens`` tokens
    through the paged path (16-token prefill chunks, two decode steps; an
    SSM stack's state in recurrent-state rows 1 and 2; window layers walk
    from the engine's first page, ``window_start_page``) and through the
    dense path (decoder_prefill over both prompts padded to the longer
    one, two decoder_decode_step calls)."""
    import numpy as np
    from repro_torch.models import decoder
    from repro_torch.serving.engine import window_start_page
    cfg = dataclasses.replace(full_cfg, n_layers=depth)
    gpu = decoder.Decoder(cfg, device="meta")
    for name in ("embed", "ln_f", "head"):
        if hasattr(full_model, name):
            setattr(gpu, name, getattr(full_model, name))
    gpu.layers = torch.nn.ModuleList(full_model.layers[:depth])
    cpu = decoder.Decoder(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())

    rng = np.random.default_rng(3)
    C, ps = 16, 16
    lens = np.asarray(lens, np.int32)
    S = int(lens.max())
    tokens = rng.integers(4, cfg.vocab_size, (2, S)).astype(np.int64)
    # each row's pages: the longer prompt and its two decoded tokens
    n_pg = [-(-(S + 2) // ps)] * 2
    MP = max(4, max(n_pg))
    pt = np.zeros((2, MP), np.int32)
    pt[0, :n_pg[0]] = np.arange(1, 1 + n_pg[0])
    pt[1, :n_pg[1]] = np.arange(1 + n_pg[0], 1 + sum(n_pg))
    w = cfg.sliding_window if cfg.has_window_layers else 0
    paged, dense = {}, {}
    with torch.no_grad():
        for dev, model in (("cuda", gpu), ("cpu", cpu)):
            T = lambda a: torch.tensor(a, device=dev)
            cache = decoder.init_paged_decode_cache(cfg, 1 + sum(n_pg), ps,
                                                    dev)
            if cfg.family == "ssm":
                cache["rec"] = decoder.init_decoder_recurrent_state(cfg, 3,
                                                                    dev)
            last = [None, None]
            for c0 in range(0, S, C):
                n_new = np.clip(lens - c0, 0, C).astype(np.int32)
                start = np.minimum(lens, c0).astype(np.int32)
                live = n_new > 0
                ws = window_start_page(int(start[live].min()) - (w - 1),
                                       ps) if w else 0
                x = decoder.decoder_prefill_paged_chunk(
                    model, cache, T(tokens[:, c0:c0 + C]), T(pt), T(start),
                    T(n_new), cfg, window_start=ws,
                    state_rows=T(np.where(live, [1, 2], 0).astype(np.int32)))
                for b in np.flatnonzero(live & (lens <= c0 + C)):
                    last[b] = x[b]
            logits = [decoder._unembed(model, torch.stack(last), cfg)[:, 0]]
            sl = lens.copy()
            for step in range(2):
                # both devices feed the card's greedy tokens
                tok = (paged["cuda"][step] if dev == "cpu" else logits[-1]) \
                    .argmax(-1).cpu().numpy()
                ws = window_start_page(int(sl.min()) + 1 - w, ps) if w else 0
                logits.append(decoder.decoder_decode_step_paged(
                    model, cache, T(tok[:, None]), T(pt), T(sl),
                    T(np.ones(2, bool)), cfg, window_start=ws))
                sl = sl + 1
            paged[dev] = [t.float().cpu() for t in logits]

            last, cache = decoder.decoder_prefill(
                model, {"tokens": T(tokens)}, cfg, max_seq=S + 2)
            logits = [last]
            for step in range(2):
                tok = (dense["cuda"][step] if dev == "cpu" else logits[-1]) \
                    .argmax(-1).cpu().numpy()
                out, cache = decoder.decoder_decode_step(
                    model, cache, T(tok[:, None]), cfg)
                logits.append(out)
            dense[dev] = [t.float().cpu() for t in logits]
    tag = f"{cfg.name} at depth {depth}, prompts of {lens.tolist()} tokens,"
    _compare(torch, f"{tag} paged", paged["cuda"], paged["cpu"])
    _compare(torch, f"{tag} dense", dense["cuda"], dense["cpu"])


# ------------------------------------------------------------------ phase 6
# benchmarks/common.py's "full" scale (its _SCALES["full"] and
# ROUTER_EPOCHS["full"]), copied: benchmarks/ imports the JAX package
PIPELINE = dict(seed=0, n_train_queries=1000, n_test_queries=500,
                n_samples=10, steps_scale=1.0,
                tiers=("tiny", "small", "medium", "large"))
ROUTER_EPOCHS = 4
POOL_TIERS = ("small", "medium", "large")
STEP_RTOL = 1e-4   # one training step, card vs CPU: loss and grad norm
                   # are sums over ~1e9 products in another order
ROUTER_QUERIES, ROUTER_VAL, ROUTER_BATCH = 256, 64, 16
LM_ROWS, LM_BATCH, LM_SEQ, LM_STEPS = 8, 4, 512, 6


def _timed_steps(torch, module, name, times, metrics):
    """Swap ``module.name`` (a train-step factory) for one whose steps are
    timed between card synchronisations and whose metrics are kept (loss
    and grad norm as floats). Returns the original, to put back."""
    make = getattr(module, name)

    def timed(*args):
        step = make(*args)

        def run(*a):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = step(*a)
            m = {k: float(out[2][k]) for k in ("loss", "grad_norm")}
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            metrics.append(m)
            return out
        return run
    setattr(module, name, timed)
    return make


def _step_on_cpu(torch, tag, make_module, snapshot, run_step, gpu):
    """One training step on the CPU from the card's initial weights
    (``snapshot``, a CPU state dict) and first batch: loss and grad norm
    must agree with the card's first step (``gpu``) within STEP_RTOL."""
    from repro_torch.training.trainer import trainable
    model = make_module()
    model.load_state_dict(snapshot)
    t0 = time.monotonic()
    with trainable(model):
        m = run_step(model)
    cpu = {k: float(m[k]) for k in ("loss", "grad_norm")}
    wall = time.monotonic() - t0
    rel = {k: abs(gpu[k] - cpu[k]) / abs(cpu[k]) for k in cpu}
    log(f"[pipeline] {tag} first step, card vs CPU ({wall:.1f} s on "
        f"{torch.get_num_threads()} CPU threads): loss {gpu['loss']:.7g} vs "
        f"{cpu['loss']:.7g}, grad norm {gpu['grad_norm']:.7g} vs "
        f"{cpu['grad_norm']:.7g}; relative differences "
        f"{rel['loss']:.3g}, {rel['grad_norm']:.3g} <= {STEP_RTOL}")
    if not all(r <= STEP_RTOL for r in rel.values()):
        raise AssertionError(f"{tag}: card and CPU steps disagree: {rel}")


def _train_rate(model, skip, n_tokens, seq, n_layers, attn_width,
                median_s) -> str:
    """The product rate of a full-width training step: 6 flop per matmul
    weight per token (2 forward, 4 backward) and 12 per token per key per
    attention channel of each layer (QK^T and PV over the full S x S
    scores, as the plain masked softmax computes them, forward and
    backward). Gathered tables (``skip``: embeddings, bucketed biases) do
    no products and are left out."""
    n_mm = sum(p.numel() for n, p in model.named_parameters()
               if p.dim() >= 2 and n not in skip)
    flops = 6 * n_mm * n_tokens + 12 * n_layers * n_tokens * seq * attn_width
    rate = flops / median_s
    return (f"{n_mm / 1e9:.4f} B matmul weights, {flops / 1e12:.3f} TFLOP a "
            f"step, {rate / 1e12:.1f} TFLOP/s at the median step, "
            f"{100 * rate / PEAK_FP32_FLOP_PER_S:.0f}% of the fp32 peak "
            f"{PEAK_FP32_FLOP_PER_S / 1e12:g} TFLOP/s")


def _peak(torch) -> str:
    return f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"


def router_training_phase(torch, card: str, smi: str):
    """(a) train_router for one epoch at DeBERTa-v3-large's widths (phase
    4's router config): 256 seeded queries of 32-512 tokens at batch 16,
    trans labels from seeded synthetic qualities, 64 validation queries;
    the first step again on the CPU from the same weights and batch."""
    import numpy as np
    from repro_torch.configs.qwen15_32b import CONFIG as QWEN
    from repro_torch.core import router as router_mod
    from repro_torch.core.labels import trans_labels
    from repro_torch.models.encoder import (RouterConfig, RouterEncoder,
                                            init_router_encoder)
    from repro_torch.training.optim import AdamWConfig, init_opt_state

    dev = torch.device("cuda")
    rcfg = RouterConfig(vocab_size=QWEN.vocab_size, **DEBERTA_V3_LARGE)
    rng = np.random.default_rng(20)

    def queries(n):
        lens = rng.integers(32, 513, n)
        toks = rng.integers(4, QWEN.vocab_size, (n, 512)).astype(np.int32)
        mask = (np.arange(512)[None] < lens[:, None]).astype(np.float32)
        toks[mask == 0] = 0
        # synthetic sampled qualities: the large tier's 10 samples, and the
        # small tier's a per-query gap below them
        ql = rng.normal(-0.3, 0.1, (n, 10))
        qs = ql + rng.normal(-0.2, 0.3, (n, 1)) + rng.normal(0, 0.1, (n, 10))
        return toks, mask, trans_labels(qs, ql)[0]

    toks, mask, y = queries(ROUTER_QUERIES)
    vt, vm, vy = queries(ROUTER_VAL)
    model = init_router_encoder(rcfg, torch.Generator(device=dev)
                                .manual_seed(21), dev)
    snapshot = {k: v.to("cpu", copy=True)
                for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    tcfg = router_mod.RouterTrainConfig(epochs=1, batch_size=ROUTER_BATCH,
                                        seed=0)
    times, metrics = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    make = _timed_steps(torch, router_mod, "make_train_step", times, metrics)
    try:
        t0 = time.monotonic()
        trained, hist = router_mod.train_router(
            rcfg, toks, mask, y, tcfg, val=(vt, vm, vy), params=model)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        router_mod.make_train_step = make
    losses = [m["loss"] for m in metrics] + hist["val_loss"]
    log(f"[pipeline] router train_router: {n_params / 1e9:.3f} B params, "
        f"{len(times)} steps of {ROUTER_BATCH} x 512 tokens in {wall:.2f} s "
        f"(first step {times[0]:.3f} s, then median "
        f"{float(np.median(times[1:])):.4f} s/step), peak memory "
        f"{_peak(torch)}, on {card} ({smi})")
    log(f"[pipeline] router step: " + _train_rate(
        model, {"embed", "rel_bias"}, ROUTER_BATCH * 512, 512,
        rcfg.n_layers, rcfg.d_model, float(np.median(times[1:]))))
    log(f"[pipeline] router losses: train {[round(x, 4) for x in losses[:-1]]}"
        f", val {hist['val_loss']}")
    if len(times) != ROUTER_QUERIES // ROUTER_BATCH \
            or not np.isfinite(losses).all():
        raise AssertionError(f"router training: {len(times)} steps, losses "
                             f"{losses}")
    with torch.no_grad():
        vloss = float(router_mod.bce_loss(
            router_mod._logits(trained, rcfg, vt, vm, 256),
            torch.tensor(vy, device=dev)))
    if trained is not model or abs(vloss - min(hist["val_loss"])) > \
            1e-5 * abs(vloss):
        raise AssertionError(f"the returned router is not the best-val one: "
                             f"val loss {vloss} vs {hist['val_loss']}")
    del trained, model
    torch.cuda.empty_cache()

    idx = np.random.default_rng(tcfg.seed).permutation(ROUTER_QUERIES)[
        :ROUTER_BATCH]
    T = lambda a, dt: torch.tensor(a[idx], dtype=dt)
    ocfg = AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay)
    step = router_mod.make_train_step(rcfg, ocfg)
    _step_on_cpu(torch, "router", lambda: RouterEncoder(rcfg, "cpu"),
                 snapshot, lambda m: step(
                     m, init_opt_state(dict(m.named_parameters()), ocfg),
                     T(toks, torch.long), T(mask, torch.float32),
                     T(y, torch.float32))[2], metrics[0])


def lm_training_phase(torch, card: str, smi: str):
    """(b) train_lm for 6 steps on phase 4's "half" qwen1.5-32b tier (2
    layers at d_model 2560) at batch 4 x 512 over 8 seeded rows; the
    first step again on the CPU from the same weights and batch."""
    import numpy as np
    from repro_torch.configs.qwen15_32b import CONFIG as QWEN
    from repro_torch.models.decoder import Decoder
    from repro_torch.models.model import build_model
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.training.optim import AdamWConfig, init_opt_state

    dev = torch.device("cuda")
    cfg = dataclasses.replace(scaled_sibling(QWEN, 2), n_layers=2)
    bundle = build_model(cfg)
    rng = np.random.default_rng(30)
    tokens = rng.integers(4, cfg.vocab_size, (LM_ROWS, LM_SEQ)).astype(
        np.int32)
    arrays = {"tokens": tokens,
              "labels": np.concatenate([tokens[:, 1:], np.zeros(
                  (LM_ROWS, 1), np.int32)], axis=1),
              "loss_mask": (np.arange(LM_SEQ)[None] < LM_SEQ - 1).repeat(
                  LM_ROWS, 0).astype(np.float32)}
    model = bundle.init(torch.Generator(device=dev).manual_seed(31), dev)
    snapshot = {k: v.to("cpu", copy=True)
                for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    tcfg = trainer_mod.TrainConfig(steps=LM_STEPS, batch_size=LM_BATCH,
                                   log_every=1, seed=0)
    times, metrics = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    make = _timed_steps(torch, trainer_mod, "make_lm_train_step", times,
                        metrics)
    try:
        t0 = time.monotonic()
        trained, hist = trainer_mod.train_lm(bundle, arrays, tcfg,
                                             params=model)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        trainer_mod.make_lm_train_step = make
    losses = [h["loss"] for h in hist]
    log(f"[pipeline] LM train_lm ({cfg.name}, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}): {n_params / 1e9:.3f} B "
        f"params, {len(times)} steps of {LM_BATCH} x {LM_SEQ} tokens in "
        f"{wall:.2f} s (first step {times[0]:.3f} s, then median "
        f"{float(np.median(times[1:])):.4f} s/step), peak memory "
        f"{_peak(torch)}, on {card} ({smi})")
    log(f"[pipeline] LM step: " + _train_rate(
        model, set() if cfg.tie_embeddings else {"embed.table"},
        LM_BATCH * LM_SEQ, LM_SEQ, cfg.n_layers,
        cfg.n_heads * cfg.resolved_head_dim, float(np.median(times[1:]))))
    log(f"[pipeline] LM losses {[round(x, 4) for x in losses]}")
    if len(losses) != LM_STEPS or not np.isfinite(losses).all() \
            or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"LM training did not descend: {losses}")
    del trained, model
    torch.cuda.empty_cache()

    batch = next(trainer_mod.batch_iterator(np.random.default_rng(tcfg.seed),
                                            arrays, LM_BATCH, "cpu"))
    ocfg = AdamWConfig(lr=tcfg.lr)
    step = trainer_mod.make_lm_train_step(bundle, ocfg)
    _step_on_cpu(torch, "LM", lambda: Decoder(cfg, "cpu"), snapshot,
                 lambda m: step(m, init_opt_state(dict(m.named_parameters()),
                                                  ocfg), batch)[2],
                 metrics[0])


def pipeline_phase(torch, card: str, smi: str):
    """(c) The paper's pipeline at benchmarks/common.py's "full" scale on
    the card: build_experiment (the four tiers' LMs trained, 10 responses
    sampled per query on three splits; K4 once per layer per sampling
    batch, K5 once per layer per decode step, no kernel in training),
    the three pairs' r_det / r_prob / r_trans with their drops at fixed
    cost advantages beside random routing, then a per-boundary router for
    (small, medium, large) calibrated into a cascade that serves the 500
    test queries through a three-engine ContinuousPoolEngine (K1 and K2 on
    every tier that receives a query), and the quality-target dial swept
    over three targets on the same engines."""
    import numpy as np
    from repro_torch.core import experiment as E
    from repro_torch.core.metrics import (drop_at_cost_advantages,
                                          random_routing_curve)
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_decode_attention import ops as pdec
    from repro_torch.kernels.paged_prefill_attention import ops as ppre
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    counters = {"K1": pdec.paged_decode_attention_gqa,
                "K2": ppre.paged_prefill_attention_gqa,
                "K4": fa.flash_attention, "K5": dec.decode_attention_kv}
    walls = {}

    def stage(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        walls[name] = time.monotonic() - t0
        log(f"[pipeline] stage {name}: {walls[name]:.2f} s")
        return out

    for w in counters.values():
        w.launches = 0
    train_launches = {"train": dict.fromkeys(counters, 0)}
    train_tier_lms = E.train_tier_lms
    counted = _counting(counters, train_launches, "train", train_tier_lms)
    E.train_tier_lms = lambda *a, **kw: stage("train_tier_lms", counted, *a,
                                              **kw)
    try:
        exp = stage("build_experiment", E.build_experiment, **PIPELINE)
    finally:
        E.train_tier_lms = train_tier_lms
    built = {k: w.launches for k, w in counters.items()}
    n_layers = sum(E.TIERS[t][0].n_layers for t in PIPELINE["tiers"])
    batches = sum(-(-len(ds.query) // 256) for ds in exp.datasets.values())
    gen_calls = PIPELINE["n_samples"] * batches
    want = {"K1": 0, "K2": 0, "K4": n_layers * gen_calls,
            "K5": n_layers * gen_calls * 16}
    lm_steps = sum(max(20, int(E.TIERS[t][1] * PIPELINE["steps_scale"]))
                   for t in PIPELINE["tiers"])
    log(f"[pipeline] build_experiment: LM training {lm_steps} steps in "
        f"{walls['train_tier_lms']:.2f} s "
        f"({walls['train_tier_lms'] / lm_steps * 1e3:.2f} ms/step), "
        f"sampling and scoring {gen_calls * len(PIPELINE['tiers'])} batches "
        f"in {walls['build_experiment'] - walls['train_tier_lms']:.2f} s")
    log(f"[pipeline] build_experiment launches {built} (expected {want}: "
        f"one K4 per layer per sampling batch, one K5 per layer per decode "
        f"step), in LM training {train_launches['train']}")
    if built != want or any(train_launches["train"].values()):
        raise AssertionError(f"build_experiment launches {built} != {want}, "
                             f"training {train_launches['train']}")
    for t in PIPELINE["tiers"]:
        q = exp.qualities[t]
        log(f"[pipeline] tier {t}: mean quality "
            + ", ".join(f"{s} {q[s].mean():+.4f}" for s in q))

    routers = {}
    for pair, (lo, hi) in E.PAIRS.items():
        routers[pair] = stage(f"train_pair_routers {pair}",
                              E.train_pair_routers, exp, lo, hi,
                              epochs=ROUTER_EPOCHS, seed=PIPELINE["seed"])
        qs, ql = exp.qualities[lo]["test"], exp.qualities[hi]["test"]
        rand = random_routing_curve(np.random.default_rng(0), len(qs), qs,
                                    ql)
        cas = (0.1, 0.2, 0.4)
        rand_at = [min(rand, key=lambda p: abs(p.cost_advantage - ca))
                   for ca in cas]
        row = {kind: drop_at_cost_advantages(r["scores"]["test"], qs, ql,
                                             cas)
               for kind, r in routers[pair].items()}
        log(f"[pipeline] {pair} ({lo} vs {hi}) drop % at cost advantage "
            + "; ".join(f"{ca}: " + ", ".join(
                f"{k} {row[k][ca]['drop_pct']:.2f}" for k in row)
                + f", random {p.drop_pct:.2f}" for ca, p in zip(cas, rand_at))
            + f"; t* {routers[pair]['trans']['t_star']:.4f}")
        for kind, r in row.items():
            if not all(np.isfinite(v["drop_pct"]) for v in r.values()):
                raise AssertionError(f"{pair} {kind}: drops {r}")

    out = stage("train_pool_router", E.train_pool_router, exp, POOL_TIERS,
                epochs=ROUTER_EPOCHS, seed=PIPELINE["seed"])
    ds = exp.datasets["test"]
    tokens, mask = ds.query, ds.query_mask
    engines = [(t, ContinuousEngine(exp.lms[t].bundle, exp.lms[t].params,
                                    max_new_tokens=16, n_slots=32,
                                    max_seq=64)) for t in POOL_TIERS]
    per_tier = {t: dict.fromkeys(counters, 0) for t in POOL_TIERS}
    for t, eng in engines:
        eng.step = _counting(counters, per_tier, t, eng.step)

    def serve(policy, tag):
        pool = ContinuousPoolEngine(policy, engines)
        res = stage(tag, pool.serve, tokens, mask, seed=0)
        decided = policy.decide(tokens, mask)[0]
        summary = pool.meter.summary()
        if not np.array_equal(res.tier_idx, decided):
            raise AssertionError(f"{tag}: the pool's tier_idx differs from "
                                 "the policy's decide")
        if pool.meter.total_calls != len(tokens) or not (res.lengths >= 1) \
                .all():
            raise AssertionError(f"{tag}: calls {summary}")
        for t, eng in engines:
            if eng.cache.free_pages != eng.cache.num_pages - 1:
                raise AssertionError(f"{tag}: tier {t} leaked pages")
        n_tok = int(res.lengths.sum())
        log(f"[pipeline] {tag}: calls "
            f"{[summary[t]['calls'] for t in POOL_TIERS]}, tokens "
            f"{[summary[t]['gen_tokens'] for t in POOL_TIERS]}, cost "
            f"advantage {pool.meter.cost_advantage:.4f}, {n_tok} tokens in "
            f"{walls[tag]:.3f} s")
        return res, summary

    cascade = E.pool_policy(exp, out, POOL_TIERS, kind="cascade")
    log(f"[pipeline] cascade gates "
        f"{[round(g.threshold, 6) for g in cascade.boundaries]}")
    for w in counters.values():
        w.launches = 0
    _, summary = serve(cascade, "cascade pool")
    for t in POOL_TIERS:
        log(f"[pipeline] cascade tier {t}: {summary[t]['calls']} calls, "
            f"launches {per_tier[t]}")
        if summary[t]["calls"] and not (per_tier[t]["K1"] > 0
                                        and per_tier[t]["K2"] > 0):
            raise AssertionError(f"tier {t} served queries without K1/K2 "
                                 f"launches: {per_tier[t]}")
    pool_launches = {k: w.launches for k, w in counters.items()}

    qt = E.pool_policy(exp, out, POOL_TIERS, kind="quality_target")
    # three targets across the tiers' predicted qualities on the test split
    targets = np.quantile(qt.predicted_quality(
        out["boundaries"][0]["scores"]["test"]), [0.25, 0.5, 0.75])
    prev = None
    for target in targets:
        qt.set_target(float(target))
        res, _ = serve(qt, f"quality target {target:+.4f}")
        if prev is not None and not (res.tier_idx >= prev).all():
            raise AssertionError("raising the quality target sent a query "
                                 "to a cheaper tier")
        prev = res.tier_idx
    log(f"[pipeline] kernel launches: build_experiment "
        + ", ".join(f"{k} {built[k]}" for k in ("K4", "K5"))
        + "; cascade pool " + ", ".join(f"{k} {pool_launches[k]}"
                                        for k in ("K1", "K2")))
    log(f"[pipeline] stage walls (s) on {card} ({smi}): "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))


def main() -> int:
    import torch
    card, smi = device_phase(torch)
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found — run from "
                         "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    build_phase()
    rows = kernel_phase(torch)
    pool_run = main_path_phase(torch, card, smi)
    launches = {**pool_run["launches"],
                **dense_hybrid_phase(torch, card, smi, pool_run)}
    fault_launches = fault_phase(torch, card, smi, pool_run)
    ssm_run = ssm_phase(torch, card, smi, pool_run["router"])
    launches["ssd_chunk_scan"] = ssm_run["launches"]
    # "launches": the first main path that runs the kernel (qwen1.5-32b's
    # pool and dense path, mamba2-130m's for K3); "launches_by_path": each
    # path's own count, zeroed just before that path ran
    by_path = {n: {"mamba2-130m" if n == "ssd_chunk_scan"
                   else "qwen1.5-32b": k} for n, k in launches.items()}
    for name, n in fault_launches.items():
        by_path[name]["qwen1.5-32b-faults"] = n
    device_vs_cpu_phase(torch, pool_run["models"]["full"],
                        pool_run["cfgs"]["full"])
    device_vs_cpu_phase(torch, ssm_run["model"], ssm_run["cfg"])
    # phase 4d holds 3.88 B + 0.76 B params, their pools and a router over
    # 2048 positions: it runs on the memory phases 4-4c held
    del pool_run, ssm_run
    gc.collect()     # the engines' wrapped methods hold them in cycles
    torch.cuda.empty_cache()
    gemma_run = gemma_phase(torch, card, smi)
    for name, n in gemma_run["launches"].items():
        by_path[name]["gemma3-4b"] = n
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = by_path[row["name"]]
    # one local:global period of gemma3-4b (layers 0-4 local, 5 global),
    # past the window: late walk starts on the card and on the CPU
    device_vs_cpu_phase(torch, gemma_run["model"], gemma_run["cfg"],
                        depth=6, lens=(1096, 1085))
    del gemma_run   # phase 6 needs the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    router_training_phase(torch, card, smi)
    lm_training_phase(torch, card, smi)
    pipeline_phase(torch, card, smi)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    log(smi)
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
