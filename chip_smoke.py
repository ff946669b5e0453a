#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Device: the card's name, count and power limit; TF32 off.
2. Build: the CUDA kernels from src/repro_torch/csrc, with nvcc for sm_90a.
3. The five kernels (paged decode and prefill, flash prefill, dense
   decode, SSD chunk scan) against their plain PyTorch versions on the
   card, one case per launch mode, at the main paths' shapes (Jamba's,
   whisper-large-v3's and internvl2-26b's among them, and the serving
   launcher's gemma3-4b-smoke shape of phase 7: head_dim 32, window 8
   inside a page) and beside them
   (the paged kernels' main and gemma3 cases also bit for bit under two
   page walk bounds, slot by slot, and from page 0 against the engine's
   late first page under a window); the
   kernel's time (CUDA events around back-to-back launches), the plain
   version's, one library call's where PyTorch has one (SDPA), and the
   least time the card could take for the same work. The main, gemma3
   and Jamba cases of K1 and K2, every case of K5, and every launch mode
   of K4 run again at bf16 (their bf16 instances), held to BF16_TOL
   against the plain version at bf16; the main-path shapes among them are
   timed beside it and SDPA at bf16 (K4, K5), bounded by bf16 bytes and
   the bf16 peak (K4 and K5 also by their device time and its share of
   that bound, K5 beside SDPA's own device time, K4 beside the bf16
   tensor-core floor); K5's windowed_sink and gemma3 cases run once more
   at bf16 with NaN in every K and V row of an invalid key (finite, and
   the bits of the launch on finite rows); every launch mode of K2 runs
   again at bf16 too
   (its bf16 design: the main and gemma3 cases bit for bit as at fp32,
   the timed ones by device time); K3's mamba2-130m (dense and pool) and
   Jamba (dense and pool) cases in the kernel's layout and in the
   model's, timed, and its bf16 design's tile edges
   run again with x, B and C at bf16 (its bf16 instance, fp32 outputs held
   to the fp32 instance's SSD_TOL, "pool_bf16" also bit for bit
   alone/packed and across l buckets), bounded by 2-byte x, B, C and the
   bf16 design's products at the bf16 peak.
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
   4f. Shared-prefix reuse and speculation (after 4e, on phase 4's tiers,
   router and prompts): the full tier serves 16 prompts behind one
   256-token system prompt, a fork prompt sharing 264 tokens (a
   copy-on-write split inside a page) and 8 second turns, with
   prefix_cache=0 and 64: the same tokens, prefix hits on the second wave
   and the turns, at least one COW split, fewer K2 launches with the
   tree (K2 from starts past pages mapped from the tree), clean refcounts
   after the drain. Then speculation at gamma 4, greedy: a pool with
   "half" drafting for "full" (it must route as phase 4 did and emit its
   tokens) and "full" drafting on its own module (its full-tier tokens):
   K2 as the verify chunk (gamma + 1 rows a slot) and the draft mirror's
   prefill, K1 as the draft's micro-steps (exactly layers x verify
   chunks and layers x micro-steps), every pool and mirror drained clean.
   4g. The MoE and hybrid slice (after phase 4d and its phase-5 check, on
   the memory they held): two jamba-v0.1-52b tiers cut to one 8-layer
   block ("full": every published width, 13.27 B params; "half":
   scaled_sibling(., 2), 3.45 B), 7 Mamba layers (state 16) and 1
   attention layer a block, MoE (16 experts, top-2) every other layer,
   behind a router at DeBERTa-v3-large's widths over Jamba's vocabulary,
   serve phase 4's traffic through the pool, then through the dense
   hybrid path (it must route as the pool did). Launches counted from 0
   on each tier must be exactly: pool K2 = prefill dispatches, K3 = 7 x
   prefill dispatches, K1 = decode steps; dense K4 = 1 and K3 = 7 a
   prefill, K5 = 1 a decode step. No page leaked, every state row free;
   the MoE assignments dropped by capacity on each path (none on the
   pool) and the peak memory are logged.
   4h. The encoder-decoder and vision-frontend slice (after phase 4g's
   memory is freed), through the bundle and build_generate_fn with each
   family's inputs, 16 requests and 32 greedy tokens: whisper-large-v3
   as published (32 + 32 layers, enc_seq 1500; stub frame embeddings
   and 48-token prompts), K4 exactly 64 a prefill (32 encoder
   non-causal, 32 decoder) and K5 64 a decode step (32 self, 32 cross
   over 1500 keys); then internvl2-26b at every width cut to 8 layers
   (256 stub patch embeddings and 256-token prompts, a cache of 544
   positions), K4 8 a prefill, K5 8 a decode step. Prefill ms, tokens/s
   and the peak memory are logged.
5. The card against the CPU: the qwen and mamba2 full tiers at depth 1
   (before phase 4d, which runs on the memory phases 4-4c held),
   gemma3-4b at depth 6 (one local:global period, after phase 4d) on
   prompts past the window, the Jamba "half" tier (one block, after phase
   4g) and phi3.5-moe-42b-a6.6b at every width and depth 2: the paged
   path (prefill chunks, two decode steps) and the dense path (a prefill,
   two decode steps) on each device, logits compared; after phase 4h,
   whisper-large-v3 at every width with 2 + 2 layers (enc_seq 1500) and
   internvl2-26b at every width and depth 1 on their frontend inputs
   through the dense path.
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
7. The launchers, as a user starts them (after phase 6), in process, at
   their own reduced tier configs: repro_torch.launch.serve.main with
   (a) --arch gemma3-4b --tiers mamba2-130m qwen1.5-32b full --continuous
   --prefix-cache 16 --escalate 0.25 (an SSM, a global-attention and a
   windowed tier), (b) --arch qwen1.5-32b --tiers quarter half full
   --continuous --spec-gamma 2 and (c) --arch gemma3-4b (the dense pair),
   each cut to --steps 60 --requests 64 --samples 2: the calls must sum
   to the requests, every tier must serve with its kernels (K1 and K2 on
   a paged attention tier, windowed on gemma3's, K3 on mamba2's, K4 and
   K5 on a dense tier) and every continuous tier drain clean; then
   repro_torch.launch.train.main --arch mamba2-130m --steps 20 --out
   (the checkpoint loads back the trained weights exactly). Each run's
   wall, its stream's tokens/s and the phase's seconds are logged.
8. The static analysis on the card (after phase 5's qwen and mamba2
   checks, on the models phases 4 and 4c hold): (a) the port's four
   passes (repro_torch.analysis) over this checkout, in process: no
   finding, no allowlist problem; (b) kernel_check's probes on CUDA
   tensors, every call passed through to the real entry and audited,
   every output against its plain version at phase 3's tolerances; (c)
   three short serves of their own with every launch audited (int
   operands copied to the host at each launch): the qwen1.5-32b pool (K1,
   K2; K1's rows held to the walk where the decode step uses them), the
   dense hybrid path on the same models (K4, K5) and a mamba2-130m pool
   engine (K3). Launches audited by entry, findings (none allowed) and
   the phase's seconds are logged.
9. The dry run and its steps (after phase 8, on phase 4's models): (a)
   python -m repro_torch.launch.dryrun on the host, three subprocesses
   started together with no GPU visible (qwen1.5-32b x decode_32k, which
   runs the sequence-sharded flash decode, gemma3-4b x train_4k and
   mamba2-130m x prefill_32k on the (16, 16) mesh of fake ranks): every
   record ok, its peak, roofline terms and dominant term logged; (c) the
   fused K-tier step (build_fused_pool_step) on phase 4's two qwen tiers
   and router, 8 rows after each tier's prefill: every row's logits equal
   its tier's own decode_step exactly, K5 once a layer of each tier; (b)
   the decode (B 8 over 4,096 positions, K5), prefill (B 2, S 4,096, K4)
   and train (B 1, S 1,024, bf16 moments, no kernel) steps of
   qwen1.5-32b at every width cut to 2 layers, and mamba2-130m's prefill
   (B 2, S 4,096, K3), each predicted by the fake run of the same config
   on one device: predicted and measured peak logged, the dispatch
   counter's products equal to FlopCounterMode's on the card run (and
   the fake train step's), decode and prefill logits against the CPU
   (the qwen prefill's first row only).
10. bf16 (after phase 9's card work and while its dry runs finish on the
   host, on phase 4's models, router and prompts, the tiers cast to bf16
   in place): (b) phase 4's routed pool at bf16 (every
   query on phase 4's tier, the bf16 K1 and K2 on both tiers, no page
   leaked; tokens/s beside phase 4's and the peak memory), then the card
   against the CPU on phase 4's 4 shortest prompts through the full
   tier, the tolerance twice the largest gap
   between the CPU's bf16 and fp32 first-token logits (two bf16
   computations, each that close to fp32): the card's bf16 first-token
   logits within it of the CPU's, and greedy tokens equal up to the first
   position where the CPU's top-2 margin is under it; (c) phase 4b's dense
   hybrid path at bf16 (routed as phase 4, the bf16 K4 once a layer a
   prefill and K5 once a layer a decode step); (d) phase 9(b)'s decode and
   prefill steps at the dry run's own bf16 (``dryrun_config``) on the
   card, peaks beside the bf16 fake run's, the decode logits against the
   CPU's bf16 within the same kind of dtype gap. (a) is phase 3's bf16
   cases. The bf16 models are the fp32 ones' twins (``bridge.twin``: each
   weight in its parameter's dtype at the bf16 config).
11. The other families at bf16, each after the fp32 phase it repeats and
   on the memory that phase freed, every launch its kernel's bf16
   instance: (a) (after phase 10, while phase 9's dry runs finish) phase
   4c's mamba2-130m tiers as bf16 twins (A_log, D, dt_bias stay fp32),
   router and prompts through the pool (K3 exactly layers x prefill
   dispatches, no page or state row leaked) and the dense hybrid path (K3
   layers a prefill, nothing in decode), routing as 4c did, tokens/s
   beside 4c's, then the card against the CPU at depth 1 as phase 10's (b);
   (d) phase 9(b)'s mamba2-130m prefill step (B 2, S 4,096) at
   ``dryrun_config``'s bf16 (K3 a layer; peak beside the bf16 fake run's;
   its first row's logits within twice the dtype's gap of the CPU's); (b)
   (after phase 4g's phase-5 check) phase 4g's jamba-v0.1-52b tiers at
   bf16 from 4g's seeds (``bridge.init_twin``), router and prompts through
   the pool and the dense path with 4g's exact launch counts, routing as
   4g did, MoE drops and the peak logged, then the "half" tier against the
   CPU as phase 5 checks it within twice the dtype's gap; (c) (after each
   phase-4h model's phase-5 check) whisper-large-v3 and internvl2-26b as
   their bf16 twins on bf16 stub inputs through build_generate_fn (4h's
   exact launch counts; prefill ms, tokens/s and peak beside 4h's), then
   the card against the CPU at phase 5's depths within twice the dtype's
   gap.

It imports neither JAX nor the JAX package. Weights are random, from
seeded torch.Generators; nothing is downloaded. The last two lines are a
JSON object listing the kernels and the result line. A kernel's
"launches" there are those of the first main path that runs it (qwen1.5-32b
for K1, K2, K4 and K5, mamba2-130m for K3), and "launches_by_path" holds
each path's own count, read just after that path ran from 0
("qwen1.5-32b-faults": phase 4e's pool serves; "qwen1.5-32b-prefix":
phase 4f's serves through the tree; "qwen1.5-32b-spec": its speculative
serves, whose K2 launches as the verify chunk and the draft mirror's
prefill are "qwen1.5-32b-spec-verify" and "-spec-mirror", and whose K1
launches as the draft's micro-steps "qwen1.5-32b-spec-draft";
"jamba-v0.1-52b": phase 4g's pool and dense serves, each kernel's count
summed over both; "whisper-large-v3" and "internvl2-26b": phase 4h's
serves; "launch-serve-mixed", "launch-serve-spec" and
"launch-serve-dense": phase 7's three serving-launcher runs (a) to (c),
each counted over the whole run: training launches nothing, labelling
runs K4, K5 and K3 in sample_responses, serving the path's kernels;
"dryrun-steps": phase 9(b)'s steps, two runs each, and "fused-pool":
phase 9(c)'s fused step). Each attention kernel's row also has "bf16",
its main case at bf16 (max_abs_err, ms, plain_ms, bound_ms, bound_by,
library_ms), and "qwen1.5-32b-bf16", its launches by dtype on phase
10's pool (K1, K2) and dense path (K4, K5); K3's row has "bf16" too (its
dense mamba2 case with x, B and C at bf16). "mamba2-130m-bf16",
"jamba-v0.1-52b-bf16", "whisper-large-v3-bf16" and "internvl2-26b-bf16"
are each kernel's launches by dtype on phase 11's serves of that family
(pool and dense path summed).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12   # H100 SXM TF32 on the tensor cores, dense
PEAK_BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 on the tensor cores, dense
KERNEL_TOL = 1e-4               # fp32 kernel vs plain: another summation order
BF16_TOL = 2e-2                 # bf16 kernel vs plain at bf16, allclose with
                                # rtol = atol: the reference's own bf16
                                # tolerance for its kernels (the plain
                                # version rounds scores to bf16, the kernel
                                # keeps them in fp32)
SSD_TOL = 1e-4                  # SSD scan: sums over N + l terms reach tens,
                                # so 1e-4 relative to max(1, max |plain|)
DEVICE_TOL = 1e-3               # fp32 card vs CPU logits through a 5120-wide
                                # layer: sums over up to 27392 terms in
                                # another order on each device
N_PROMPTS, NEW_TOKENS, N_SLOTS, MAX_SEQ = 16, 32, 8, 1024
GEMMA_MAX_SEQ = 2048    # gemma3-4b's pool: contexts of 1040-2016 tokens
MAX_SEQS = {"gemma3": GEMMA_MAX_SEQ,   # page-table widths of phase 3's
            "launch": 64}              # paged cases (phase 7's pools: 64)
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


def _bound(nbytes: float, flops: float, peak: float = PEAK_FP32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _case(name, desc, kernel, plain, nbytes, flops, library=None,
          check=None, timed=False, scaled=False, report=None, bf16=False):
    """One launch mode: callables for the kernel's wrapper, its plain
    version and (main path only) the library yardstick, the bytes and
    flops of the work, and an extra check of the kernel's output.
    "main" cases are timed and fill the kernel's JSON row; ``timed`` times
    another main-path shape too. ``scaled`` holds the error relative to
    max(1, max |plain|) against SSD_TOL instead of KERNEL_TOL. ``report``
    logs more about a timed case: called with (torch, case, kernel ms,
    plain ms, library ms). ``check`` raises if the output is wrong, and may
    return what it checked, for the log. ``bf16``: a bf16 case, held to
    BF16_TOL and bounded by bf16 bytes and the bf16 peak."""
    return dict(name=name, desc=desc, kernel=kernel, plain=plain,
                library=library, nbytes=nbytes, flops=flops, check=check,
                timed=timed or name == "main", scaled=scaled, report=report,
                bf16=bf16)


def _bf16_args(torch, args):
    """``args`` with every float tensor cast to bf16."""
    return tuple(a.to(torch.bfloat16) if torch.is_tensor(a)
                 and a.is_floating_point() else a for a in args)


def _bf16_bytes(torch, args, keys_bytes):
    """A bf16 case's bytes: every input tensor read once (floats at 2
    bytes), the output (q's size) written once, ``keys_bytes`` the K and V
    rows the case must read at 2 bytes a value; the tensors' other
    elements are the pools' and caches' unread rows."""
    q = args[0]
    ints = sum(a.numel() * a.element_size() for a in args
               if torch.is_tensor(a) and not a.is_floating_point())
    return 2 * 2 * q.numel() + keys_bytes + ints


def _idle_slot_is_zero(out):
    if out[-1].abs().max().item() != 0.0:
        raise AssertionError("the idle slot's output is not exactly 0")


def _paged_case(name, op, ref, args, kw, nbytes, flops, check=None,
                report=None, ps=16, timed=False, bf16=False):
    shape = "x".join(map(str, args[0].shape))
    if check is None and name == "ragged_idle":
        check = _idle_slot_is_zero
    c = _case(name, f"q {shape}, ps {ps} {kw}" + (" bf16" if bf16 else ""),
              lambda: op(*args, **kw), lambda: ref(*args, **kw), nbytes,
              flops, check=check, report=report, timed=timed, bf16=bf16)
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
    ("main" under a window of 128). "jamba" (timed) is the
    jamba-v0.1-52b pool's decode on its attention layer: 8 slots at
    contexts of 33-544, 8 kv heads of 128, G = 4. "launch" (timed) is the
    serving launcher's gemma3-4b-smoke pool decode on a local layer (phase
    7): 8 slots at contexts of 17-28 in a 64-position table, 2 kv heads of
    32, G = 2, a window of 8 inside a 16-token page."""
    import numpy as np
    from repro_torch.kernels.paged_decode_attention import ops
    from repro_torch.serving.engine import window_start_page
    rng = np.random.default_rng(1)
    grng = np.random.default_rng(21)    # the gemma3 case's contexts
    jrng = np.random.default_rng(23)    # the jamba case's contexts
    lrng = np.random.default_rng(25)    # the launcher case's contexts
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
        "jamba": (8, 4, 128, 16, jrng.integers(33, 545, 8), 0, 0),
        "launch": (2, 2, 32, 16, lrng.integers(17, 29, 8), None, 8),
    }
    out = []
    for name, (K, G, D, ps, lens, pstart, window) in spec.items():
        lens = np.asarray(lens, np.int32)
        if pstart is None:   # the engine's: slot b's first key is len - window
            pstart = window_start_page(int(lens.min()) - window, ps)
        B = len(lens)
        MP = MAX_SEQS.get(name, MAX_SEQ) // ps
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
        timed = main or name in ("jamba", "launch")
        out.append(_paged_case(
            name, op, ops.paged_decode_attention_ref, args, kw, nbytes, flops,
            check=check, report=_paged_standing("paged_decode_attention")
            if timed else None, ps=ps, timed=timed))
        if main or name == "jamba":     # the same launch at bf16
            bargs = _bf16_args(torch, args)
            out.append(_paged_case(
                f"{name}_bf16", op, ops.paged_decode_attention_ref, bargs,
                kw, _bf16_bytes(torch, bargs, 2 * 2 * int(keys.sum()) * K * D),
                flops, ps=ps, timed=True, bf16=True))
    return out


def prefill_cases(torch, dev):
    """Paged prefill, one case per launch mode. "main" is the main path's
    packed chunk: 8 slots x 16 rows of the full tier at ragged resident
    contexts. The kernel splits each slot's walk into splits of 128 keys
    and takes 16, 32 or 64 rows a block; the modes after the first six are
    what that design makes distinct: ps = 8 with chunks across split
    boundaries, 32-row blocks (G = 2), a 64-row block with 16 rows of
    padding (G = 3), head_dim 256 in 64-row blocks (16-key tiles), and
    head_dim 18 (4-byte copies; 2-byte copies at bf16). Every case runs
    again at bf16 ("<name>_bf16": the bf16 design, held to BF16_TOL, with
    its twin's checks; the timed ones report their device time). "main"
    also checks that its output is
    bit-identical under the pages it needs and under the full table
    width, and for each slot launched alone. "gemma3" is the gemma3-4b
    pool's packed 16-token chunk on a local layer: 8 slots resident at
    1024-2000 tokens, 4 kv heads of 256, G = 2, window 1024, the walk from
    the engine's first page. "main" and "gemma3" also check that a window
    walk gives the same bits from page 0 and from the engine's first page
    ("main" under a window of 128). "jamba" (timed) is the
    jamba-v0.1-52b pool's packed 16-token chunk on its attention layer: 8
    slots resident at 0-480 tokens, 8 kv heads of 128, G = 4. "launch"
    (timed) is the serving launcher's gemma3-4b-smoke pool admitting 8
    prompts of 5-16 tokens in one chunk on a local layer (phase 7): a
    64-position table, 2 kv heads of 32, G = 2, a window of 8."""
    import numpy as np
    from repro_torch.kernels.paged_prefill_attention import ops
    from repro_torch.serving.engine import window_start_page
    rng = np.random.default_rng(2)
    grng = np.random.default_rng(22)    # the gemma3 case's contexts
    jrng = np.random.default_rng(24)    # the jamba case's contexts
    lrng = np.random.default_rng(26)    # the launcher case's chunks
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
        "jamba": (8, 4, 128, 16, 16 * jrng.integers(0, 31, 8), full(16), 0,
                  0),
        "launch": (2, 2, 32, 16, np.zeros(8, np.int32),
                   lrng.integers(5, 17, 8), None, 8),
    }
    out = []
    for name, (K, G, D, ps, start, n_new, pstart, window) in spec.items():
        start = np.asarray(start, np.int32)
        n_new = np.asarray(n_new, np.int32)
        total = start + n_new
        if pstart is None:   # the engine's: a chunk's first key is
            pstart = window_start_page(int(start.min()) - window + 1, ps)
        B = len(start)
        MP = MAX_SEQS.get(name, MAX_SEQ) // ps
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
        timed = main or name in ("jamba", "launch")
        out.append(_paged_case(
            name, op, ops.paged_prefill_attention_ref, args, kw, nbytes,
            flops, check=check,
            report=_paged_standing("paged_prefill_attention") if timed
            else None, ps=ps, timed=timed))
        # the same launch at bf16 (the bf16 design), with the same checks
        bargs = _bf16_args(torch, args)
        bcheck = _idle_slot_is_zero if name in ("ragged_idle",
                                                "page8_split_edge") else None
        if main:
            bcheck = _all_of(_walk_bitwise(torch, op, bargs, kw),
                             _start_bitwise(torch, op, bargs, kw,
                                            window or 128,
                                            1 - (window or 128)))
        btimed = main or name == "jamba"
        out.append(_paged_case(
            f"{name}_bf16", op, ops.paged_prefill_attention_ref, bargs,
            kw, _bf16_bytes(torch, bargs, 2 * 2 * int(keys.sum()) * K * D),
            flops, check=bcheck,
            report=_paged_bf16_standing("paged_prefill_attention",
                                        "paged_prefill_kernel", op)
            if btimed else None, ps=ps, timed=btimed, bf16=True))
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
        log(f"[kernels] {kname}[{c['name']}] {bound_ms / ms:.3g} of the {by} bound "
            f"({bound_ms:.4g} ms), {ms / plain_ms:.3f}x its plain version's "
            f"time ({plain_ms:.4f} ms)")
    return report


def _paged_bf16_standing(kname, piece, wrapper):
    """A paged kernel's standing at a timed bf16 shape: its device time
    per call from the profiler (``piece`` of its device name; events
    around back-to-back calls of a kernel this short time the host) beside
    the events', its share of the bound at bf16 (bf16 bytes, the bf16
    peak) on each, and the factor against its plain version."""
    def report(torch, c, ms, plain_ms, library_ms):
        bound_ms, by = _bound(c["nbytes"], c["flops"], PEAK_BF16_FLOP_PER_S)
        device_ms = _kernel_device_ms(torch, c["kernel"], piece, wrapper)
        log(f"[kernels] {kname}[{c['name']}] events {ms:.4f} ms; "
            f"{_share(bound_ms, by, device_ms)} at bf16, "
            f"{bound_ms / ms:.3g} on events; {ms / plain_ms:.3f}x its "
            f"plain version's time ({plain_ms:.4f} ms)")
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
    window 1024; "jamba" the jamba-v0.1-52b dense prefill on its attention
    layer: 8 prompts of 512 tokens, 32 heads of 128 over 8 kv heads;
    "whisper_encoder" the whisper-large-v3 encoder's self-attention (16
    prompts of 1500 frames, 20 heads of 64, non-causal), "whisper_decoder"
    its decoder's 48-token causal prefill, "internvl2" the internvl2-26b
    prefill over 256 patch + 256 prompt positions (48 heads over 8 kv
    heads of 128, G = 6); "launch" the serving launcher's gemma3-4b-smoke
    dense prefill on a local layer (phase 7): 32 prompts of 16 tokens, 4
    heads of 32 over 2 kv heads, window 8. The plain version expands kv to
    H heads and runs on (B*H, S, D); the library yardstick is one SDPA call
    (scale 1 on the pre-scaled q, causal where the case is, GQA where
    H > K; for "gemma3" and "launch" a boolean window mask and GQA).
    Every case runs again at bf16 ("<name>_bf16": the bf16 instance, its
    own design), held to BF16_TOL; "head_dim_20_bf16" reads k and v as
    views of bf16 rows 21 values apart, the instance's 2-byte loads. The
    timed bf16 cases are timed beside SDPA at bf16."""
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
        "jamba": (8, 512, 32, 8, 128, True, 0),
        "whisper_encoder": (16, 1500, 20, 20, 64, False, 0),
        "whisper_decoder": (16, 48, 20, 20, 64, True, 0),
        "internvl2": (16, 512, 48, 8, 128, True, 0),
        "launch": (32, 16, 4, 2, 32, True, 8),
    }
    g = torch.Generator(device=dev).manual_seed(3)
    out = []
    for name, (B, S, H, K, D, causal, window) in spec.items():
        Dr = D + 1 if name == "head_dim_20" else D   # row width in memory
        q = torch.randn((B, S, H, Dr), generator=g, device=dev)[..., :D] \
            * D ** -0.5
        kw_rows = torch.randn((B, S, K, Dr), generator=g, device=dev)
        vw_rows = torch.randn((B, S, K, Dr), generator=g, device=dev)
        k, v = kw_rows[..., :D], vw_rows[..., :D]
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
        if name in ("main", "jamba", "whisper_encoder", "whisper_decoder",
                    "internvl2"):
            library = lambda q=q, k=k, v=v, c=causal, gqa=H != K: \
                F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=c, scale=1.0, enable_gqa=gqa).transpose(1, 2)
        elif name in ("gemma3", "launch"):
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
        # the same at bf16; k and v keep their rows' width in memory
        qb = q.to(torch.bfloat16)
        kb, vb = (t.to(torch.bfloat16)[..., :D] for t in (kw_rows, vw_rows))
        mask = torch.tensor(seen, device=dev) if window else None
        timed = name in ("main", "gemma3", "jamba", "whisper_encoder",
                         "whisper_decoder", "internvl2")
        library = None
        if timed:
            library = lambda q=qb, k=kb, v=vb, m=mask, \
                c=causal and not window, gqa=H != K: \
                F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=m, is_causal=c, scale=1.0,
                    enable_gqa=gqa).transpose(1, 2)
        out.append(_case(
            f"{name}_bf16", desc.replace("floats", "values") + " bf16",
            lambda q=qb, k=kb, v=vb, kw=kw:
                ops.flash_attention(q, k, v, **kw),
            lambda q=qb, k=kb, v=vb, f=plain: f(q, k, v),
            nbytes // 2, flops, library, timed=timed,
            report=_flash_standing if timed else None, bf16=True))
    return out


def _flash_standing(torch, c, ms, plain_ms, library_ms):
    """Flash attention's standing at a timed shape: its device time per
    call from the profiler beside the events', its time as a share of
    the bound at its dtype, against SDPA's at that dtype, and the floor of
    its tensor-core route: at fp32 three TF32 products per fp32 product
    at the TF32 peak (3xTF32), at bf16 one bf16 product at the bf16 peak.
    Names the backend SDPA took, from one call under the profiler: its
    ATen op and its device kernels."""
    from torch.profiler import ProfilerActivity, profile
    if c["bf16"]:
        dtype, route, tc_flops, peak = "bf16", "bf16", c["flops"], \
            PEAK_BF16_FLOP_PER_S
    else:
        dtype, route, tc_flops, peak = "fp32", "3xTF32", 3 * c["flops"], \
            PEAK_TF32_FLOP_PER_S
    bound_ms, _ = _bound(c["nbytes"], c["flops"], PEAK_BF16_FLOP_PER_S
                         if c["bf16"] else PEAK_FP32_FLOP_PER_S)
    tc_ms = 1e3 * tc_flops / peak
    device_ms = _device_ms(torch, c["kernel"], "flash_kernel")
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
    log(f"[kernels] flash_attention[{c['name']}] device {device_ms:.4f} ms "
        f"(events {ms:.4f}); {bound_ms / device_ms if device_ms else 0:.3g} "
        f"of the {dtype} bound ({bound_ms:.4g} ms) on device time, "
        f"{bound_ms / ms:.3g} on events; {ms / library_ms:.3f}x SDPA's "
        f"{dtype} time ({library_ms:.4f} ms), device "
        f"{device_ms / library_ms:.3f}x; {route} tensor-core floor "
        f"{tc_ms:.4f} ms ({tc_flops} flop at {peak / 1e12:g} TFLOP/s)")
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
            (B, 256, K, D), generator=g, device=q.device).to(t.dtype)], 1)
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
    keys, in one split (the split's own block writes it). At bf16 each
    output is held to allclose(rtol = atol = BF16_TOL) of its want."""
    def check(got):
        if valid[0].any():
            raise AssertionError("the case's first row has a valid key")
        K = k.shape[2]
        G = q.shape[1] // K
        errs = []
        for n in (k.shape[1], 100):
            out = ops.decode_attention_kv(q, k[:, :n], v[:, :n],
                                          valid[:, :n].contiguous())
            mean = v[0, :n].float().mean(0).repeat_interleave(G, 0)
            want = _dense_plain(torch, ops, q, k[:, :n], v[:, :n],
                                valid[:, :n])
            if q.dtype == torch.bfloat16:
                errs.append(max(_bf16_excess(out[0], mean),
                                _bf16_excess(out, want)))
                tol = BF16_TOL
            else:
                errs.append(max((out[0] - mean).abs().max().item(),
                                (out - want).abs().max().item()))
                tol = KERNEL_TOL
            if not errs[-1] <= tol:
                raise AssertionError(f"S = {n}: max abs err {errs[-1]}")
        what = "allclose excess" if q.dtype == torch.bfloat16 \
            else "max abs err"
        return (f"the no-valid row is the mean of V ({what} "
                f"{errs[0]:.3g} over {k.shape[1]} keys, {errs[1]:.3g} over "
                "100)")
    return check


def _dense_standing(torch, c, ms, plain_ms, library_ms):
    """The dense decode kernel's standing at a timed shape: its device time
    per call from the profiler (CUDA events around back-to-back calls of a
    kernel this short time the host wrapper), the device time of the
    memset that zeroes its split counts, its share of the bound at its
    dtype, and the library call's own device time per call (every kernel
    the SDPA call launches, summed) beside the kernel's."""
    from repro_torch.kernels.decode_attention import ops
    bound_ms, by = _bound(c["nbytes"], c["flops"], PEAK_BF16_FLOP_PER_S
                          if c["bf16"] else PEAK_FP32_FLOP_PER_S)
    device_ms = _kernel_device_ms(torch, c["kernel"], "decode_kernel",
                                  ops.decode_attention_kv)
    memset_ms = _device_ms(torch, c["kernel"], "Memset (Device)")
    lib = ""
    if c["library"] is not None:
        lib_ms = _all_device_ms(torch, c["library"])
        lib = (f"; SDPA device {lib_ms:.4f} ms"
               + (f", kernel/SDPA on device {device_ms / lib_ms:.3f}x"
                  if device_ms and lib_ms else ""))
    log(f"[kernels] decode_attention[{c['name']}] events {ms:.4f} ms, the "
        f"counts' memset {memset_ms:.4f} ms; "
        f"{_share(bound_ms, by, device_ms)}{lib}")


def _dense_nan_rows(torch, finite_out):
    """The check of a case whose invalid keys' K and V rows are NaN: the
    output is finite and bit-identical to the same launch on finite rows
    (the kernel reads no row of an invalid key)."""
    def check(got):
        if not torch.isfinite(got.float()).all():
            raise AssertionError("NaN in invalid rows reached the output")
        if not torch.equal(got, finite_out()):
            raise AssertionError("NaN in invalid rows changed the bits")
        return "finite, bit-identical to the launch on finite rows"
    return check


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
    window in ``valid`` (also checked bit for bit, ``_dense_exact``);
    "jamba" the jamba-v0.1-52b dense decode on its attention layer as
    "main" is, 8 kv heads of 128, G = 4; "whisper_self" the
    whisper-large-v3 decoder's self-attention mid-generation (16 rows, 20
    kv heads of 64 over its 80-position cache, 64 keys valid) and
    "whisper_cross" its cross-attention over all 1500 encoder keys, every
    key valid; "internvl2" the internvl2-26b decode as "main" is (16 rows,
    8 kv heads of 128, G = 6); "launch" the serving launcher's
    gemma3-4b-smoke dense decode on a local layer mid-generation (phase 7):
    32 rows over a 28-position cache at position 20, 2 kv heads of 32,
    G = 2, the 8-key window in ``valid``; "rows_past_16" G = 20 (two
    16-row tiles of the bf16 design). Every case runs again at bf16
    (``<name>_bf16``, the bf16 design; the main paths' shapes timed), and
    "windowed_sink" and "gemma3" once more at bf16 with NaN in every K and
    V row of an invalid key (``<name>_nan_bf16``: finite, and the bits of
    the launch on finite rows). The plain version regroups to (B*K, G, D);
    the library yardstick is one SDPA call with a boolean mask made from
    ``valid`` beforehand (and GQA where G > 1)."""
    import numpy as np
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import ops
    rng = np.random.default_rng(4)

    def sdpa(q, k, v, mask, gqa):
        return F.scaled_dot_product_attention(
            q[:, :, None], k.movedim(2, 1), v.movedim(2, 1),
            attn_mask=mask[:, None, None, :], scale=1.0,
            enable_gqa=gqa)[:, :, 0]
    spec = {  # name: (B, S, K, G, D, validity layout)
        "main": (8, 544, 40, 1, 128, "main"),
        "prefix": (4, 300, 8, 1, 128, "prefix"),
        "irregular_s": (4, 77, 8, 2, 128, "prefix"),
        "gqa": (4, 300, 8, 4, 128, "random"),
        "head_dim_24": (4, 130, 4, 1, 24, "prefix"),
        "windowed_sink": (4, 600, 8, 2, 64, "late_window"),
        "gemma3": (8, 2080, 4, 2, 256, "gemma3"),
        "no_valid_row": (4, 300, 8, 2, 128, "no_valid_row"),
        "jamba": (8, 544, 8, 4, 128, "main"),
        "whisper_self": (16, 80, 20, 1, 64, "main"),
        "whisper_cross": (16, 1500, 20, 1, 64, "all"),
        "internvl2": (16, 544, 8, 6, 128, "main"),
        "launch": (32, 28, 2, 2, 32, "launch"),
        "rows_past_16": (2, 300, 2, 20, 128, "prefix"),
    }
    g = torch.Generator(device=dev).manual_seed(5)
    out = []
    for name, (B, S, K, G, D, layout) in spec.items():
        H = K * G
        cache = torch.randn((2, 2, B, S, K, D), generator=g, device=dev)
        k, v = cache[0, 1], cache[1, 1]       # layer 1 of a 2-layer slab
        q = torch.randn((B, H, D), generator=g, device=dev) * D ** -0.5
        pos = np.arange(S)[None]
        if layout == "main":     # mid-generation: 16 steps to go
            valid = np.repeat(pos <= S - 17, B, axis=0)
        elif layout == "all":
            valid = np.ones((B, S), bool)
        elif layout in ("prefix", "no_valid_row"):
            valid = pos <= rng.integers(0, S, (B, 1))
            if layout == "no_valid_row":
                valid[0] = False
        elif layout == "random":
            valid = rng.random((B, S)) < 0.6
            valid[:, -1] = True
        elif layout == "gemma3":
            valid = np.repeat((pos <= 2064) & (2064 - pos < 1024), B, axis=0)
        elif layout == "launch":
            valid = np.repeat((pos <= 20) & (20 - pos < 8), B, axis=0)
        else:
            valid = pos >= rng.integers(512, S, (B, 1))
        n_valid = int(valid.sum())
        valid = torch.tensor(valid.astype(np.int8), device=dev)
        nbytes = 4 * (2 * q.numel() + 2 * n_valid * K * D) + B * S
        flops = 4 * n_valid * K * G * D
        library = None
        timed = name in ("main", "gemma3", "jamba", "whisper_self",
                         "whisper_cross", "internvl2", "launch")
        if timed:
            # the mask is made once, outside the timed call
            library = lambda q=q, k=k, v=v, mask=valid.bool(), gqa=G > 1: \
                sdpa(q, k, v, mask, gqa)
        check = None
        if name == "gemma3":
            check = _dense_exact(torch, ops, q, k, v, valid)
        elif layout == "no_valid_row":
            check = _no_valid_row(torch, ops, q, k, v, valid)
        desc = f"q {B}x{H}x{D}, cache {B}x{S}x{K}x{D}, {n_valid} valid keys"
        out.append(_case(name, desc,
                         lambda q=q, k=k, v=v, valid=valid:
                             ops.decode_attention_kv(q, k, v, valid),
                         lambda q=q, k=k, v=v, valid=valid:
                             _dense_plain(torch, ops, q, k, v, valid),
                         nbytes, flops, library, check=check,
                         timed=timed,
                         report=_dense_standing if timed else None))
        # the same launch at bf16 (layer 1 of the bf16 slab, read in place),
        # through the bf16 design; the main paths' shapes timed
        qb, cb = _bf16_args(torch, (q, cache))
        kb, vb = cb[0, 1], cb[1, 1]
        timed_bf16 = timed and name != "launch"
        check = None
        if name == "gemma3":
            check = _dense_exact(torch, ops, qb, kb, vb, valid)
        elif layout == "no_valid_row":
            check = _no_valid_row(torch, ops, qb, kb, vb, valid)
        run = lambda q=qb, k=kb, v=vb, valid=valid: \
            ops.decode_attention_kv(q, k, v, valid)
        plain = lambda q=qb, k=kb, v=vb, valid=valid: \
            _dense_plain(torch, ops, q, k, v, valid)
        nbytes = 2 * (2 * q.numel() + 2 * n_valid * K * D) + B * S
        library = None
        if timed_bf16:
            library = lambda q=qb, k=kb, v=vb, mask=valid.bool(), gqa=G > 1: \
                sdpa(q, k, v, mask, gqa)
        out.append(_case(
            f"{name}_bf16", desc + " bf16", run, plain, nbytes, flops,
            library, check=check, timed=timed_bf16, bf16=True,
            report=_dense_standing if timed_bf16 else None))
        if name in ("windowed_sink", "gemma3"):
            # NaN in every K and V row of an invalid key: the output must
            # be finite and equal to the launch on finite rows
            bad = (valid == 0)[..., None, None].expand_as(kb)
            nan = torch.tensor(float("nan"), dtype=torch.bfloat16,
                               device=dev)
            kn, vn = torch.where(bad, nan, kb), torch.where(bad, nan, vb)
            out.append(_case(
                f"{name}_nan_bf16", desc + " bf16, NaN in invalid rows",
                lambda q=qb, k=kn, v=vn, valid=valid:
                    ops.decode_attention_kv(q, k, v, valid),
                plain, nbytes, flops, bf16=True,
                check=_dense_nan_rows(torch, run)))
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
    "jamba_dense" and "jamba_pool" (timed) are jamba-v0.1-52b's Mamba
    layers: 128 heads of 64, state 16, the dense path's 128-position
    chunks (8 prompts x 4) and the pool's 16-position chunks with dt = 0
    padding. "pool_model" and "jamba_pool_model" (timed) are the two pools'
    chunks in the model's layout, as the SSM layers call the kernel (the
    state written (P, N)). ``SSD_BF16_TWINS`` run again with x, B and C
    at bf16 (dt and dA fp32, as the models pass them; the bf16 instance,
    its fp32 outputs held to SSD_TOL as the fp32 instance's: exact bf16
    products summed in fp32, with each gate in two bf16 parts), "pool_bf16"
    with the exact contracts at bf16; the main-path shapes timed (both
    layouts), the others the bf16 design's tile edges;
    bounded by 2-byte x, B and C, 4-byte dt, dA and outputs, and the bf16
    design's products at the bf16 peak (``_ssd_standing`` logs the fp32
    peak's figure beside it).
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
        "jamba_dense": (32, 128, 128, 64, 16, "random"),
        "jamba_pool": (8, 128, 16, 64, 16, "pad"),
        "pool_model": (8, 24, 16, 64, 128, "model"),
        "jamba_pool_model": (8, 128, 16, 64, 16, "model pad"),
    }
    g = torch.Generator(device=dev).manual_seed(6)
    out = []
    for name, (BC, H, l, P, N, layout) in spec.items():
        layout = set(layout.split())
        u = lambda lo, hi, shape: lo + (hi - lo) * torch.rand(
            shape, generator=g, device=dev)
        x = torch.randn((BC, H, l, P), generator=g, device=dev)
        if "steep" in layout:
            dt, A = u(1.0, 5.0, (BC, H, l, 1)), -u(8.0, 16.0, (H,))
        else:
            dt, A = u(0.01, 0.2, (BC, H, l, 1)), -u(1.0, 16.0, (H,))
        if "pad" in layout:
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
        check = _state_row_is_zero if "pad" in layout else None
        if "model" in layout:
            # the dense path's views: x a head-split slice of the conv
            # output (b, S, di + 2N), B and C slices of the same rows
            b, nc, di = BC // 2, 2, H * P
            xbc = torch.randn((b, nc * l, di + 2 * N), generator=g,
                              device=dev)
            dts = dt[..., 0].movedim(1, 2).reshape(b, nc, l, H).contiguous()
            das = da[..., 0].movedim(1, 2).reshape(b, nc, l, H).contiguous()

            def typed(dtype, t=xbc, d=(dts, das), sh=(b, nc, l), di=di,
                      N=N, H=H, P=P):
                """(xs, dts, das, Bs, Cs) with xs, Bs, Cs views of xbc in
                ``dtype``"""
                t = t.to(dtype)
                return (t[..., :di].reshape(*sh, H, P), *d,
                        t[..., di:di + N].reshape(*sh, N),
                        t[..., di + N:].reshape(*sh, N))
            args = typed(torch.float32)
            entry, ref = ops.ssd_chunk, ops.ssd_chunk_reference
            if check is not None:   # the last bc is (b - 1, nc - 1)
                check = lambda out: _state_row_is_zero(
                    (out[0], out[1].flatten(0, 1)))
        else:
            args = (x, dt, da, B, C)
            typed = lambda dtype, a=args: _ssd_typed(torch, a, dtype)
            entry, ref = ops.ssd_chunk_scan, ops.ssd_chunk_ref
        kernel = lambda args=args, f=entry: f(*args)
        plain = lambda args=args, f=ref: f(*args)
        if name == "pool":
            check = lambda out: _ssd_exact(torch, ops, dev)
        # the products' flops on the tensor cores: the scores once per bc,
        # y and the state per head; in 3xTF32 three TF32 products each
        score_flops = BC * pairs * 2 * N
        mma_flops = score_flops + BC * H * pairs * 2 * P \
            + BC * H * l * 2 * N * P
        desc = (f"x {BC}x{H}x{l}x{P}, B/C {BC}x{l}x{N}, "
                f"{spec[name][5].replace(' ', ', ')}")
        c = _case(name, desc, kernel, plain, nbytes, flops, check=check,
                  timed=name in ("pool", "model_layout", "jamba_dense",
                                 "jamba_pool", "pool_model",
                                 "jamba_pool_model"), scaled=True,
                  report=_ssd_standing)
        c.update(tc_flops=3 * mma_flops, tc_route="3xTF32")
        out.append(c)
        if name in SSD_BF16_TWINS:
            # the same launch with x, B and C at bf16 (the bf16 design:
            # one bf16 product for the scores, two bf16 parts of G and of
            # B o w for y and the state); the edge modes untimed
            bargs = typed(torch.bfloat16)
            if name == "pool":
                check = lambda out: _ssd_exact(torch, ops, dev,
                                               torch.bfloat16)
            bf16_flops = score_flops + SSD_BF16_PARTS * (mma_flops
                                                         - score_flops)
            c = _case(f"{name}_bf16", desc + ", x/B/C bf16",
                      lambda a=bargs, f=entry: f(*a),
                      lambda a=bargs, f=ref: f(*a),
                      2 * x.numel() + 4 * x.numel() + 4 * 2 * dt.numel()
                      + 2 * 2 * B.numel() + 4 * BC * H * N * P, bf16_flops,
                      check=check, timed=name in SSD_TIMED_BF16,
                      scaled=True, report=_ssd_standing, bf16=True)
            c.update(tc_flops=bf16_flops, simt_flops=flops,
                     tc_route=f"bf16 (1 product for the scores, "
                     f"{SSD_BF16_PARTS} parts for y and the state)",
                     peak=PEAK_BF16_FLOP_PER_S)
            out.append(c)
    return out


# the SSD cases run again at bf16, and which of them are timed (the
# main paths' shapes); the rest are the bf16 design's tile edges: past
# its 16-row tiles, past a 256-key strip, the widest P and N, steep dA,
# and dt = 0 padding in short chunks
SSD_TIMED_BF16 = ("main", "pool", "jamba_dense", "jamba_pool", "model_layout",
                  "pool_model", "jamba_pool_model")
SSD_BF16_TWINS = SSD_TIMED_BF16 + ("l4", "pad_dt0", "steep_dA",
                                   "l17_tile_edge", "p128_n256", "n256_p64",
                                   "l300_strip_panels")
SSD_BF16_PARTS = 2   # bf16 parts of G and B o w in the bf16 design


def _ssd_typed(torch, args, dtype):
    """K3's arguments (x, dt, dA, B, C) with x, B and C cast to ``dtype``;
    dt and dA stay fp32, as the models pass them."""
    return tuple(t.to(dtype) if i in (0, 3, 4) else t
                 for i, t in enumerate(args))


def _state_row_is_zero(out):
    if out[1][-1].abs().max().item() != 0.0:
        raise AssertionError("the dt = 0 row's state is not exactly 0")


def _device_ms(torch, fn, piece, n=20):
    """Device time per call of ``fn`` from torch.profiler: the kernels
    whose name holds ``piece``, over ``n`` calls back to back (0 when the
    window saw none)."""
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


def _kernel_device_ms(torch, fn, piece, wrapper):
    """The kernel's device time per call from one profiler window
    (``_device_ms``), or None when the window saw no ``piece``. Raises
    unless ``wrapper.launches`` moved over the window: a window that saw
    nothing because the wrapper launched nothing is a fault, not a gap in
    the trace."""
    before = wrapper.launches
    device_ms = _device_ms(torch, fn, piece)
    if wrapper.launches == before:
        raise AssertionError(f"{piece}: the wrapper launched no kernel in "
                             "the profiler window")
    return device_ms if device_ms > 0 else None


def _all_device_ms(torch, fn, n=20):
    """Device time per call of everything ``fn`` launches (kernels,
    memsets and copies), summed, from torch.profiler over ``n`` calls back
    to back: a library call's own device time, whatever kernels its
    backend picks."""
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


def _share(bound_ms, by, device_ms):
    """The bound's share of a device time, or the profiler's gap."""
    if device_ms is None:
        return "no device time (the kernel launched; the profiler saw none)"
    return (f"device {device_ms:.4f} ms: {bound_ms / device_ms:.3g} of the "
            f"{by} bound ({bound_ms:.4g} ms)")


def _ssd_standing(torch, c, ms, plain_ms, library_ms):
    """The SSD kernel's standing at a timed shape: its device time from the
    profiler (at the pool's chunks the CUDA events around back-to-back
    calls time the host wrapper), its share of the bound, and the floor of
    its tensor-core route (``tc_flops``: three TF32 products per fp32
    product of the scores, y and the state at the TF32 peak; at bf16 one
    bf16 product for the scores and two parts for y and the state at the
    bf16 peak, with the bound that the same operations would give at the
    fp32 peak beside it)."""
    from repro_torch.kernels.ssd_scan import ops
    peak = c.get("peak", PEAK_FP32_FLOP_PER_S)
    bound_ms, by = _bound(c["nbytes"], c["flops"], peak)
    device_ms = _kernel_device_ms(torch, c["kernel"], "ssd_kernel",
                                  ops.ssd_chunk_scan)
    tc_peak = PEAK_BF16_FLOP_PER_S if c["bf16"] else PEAK_TF32_FLOP_PER_S
    tc_ms = 1e3 * c["tc_flops"] / tc_peak
    old = ""
    if c["bf16"]:
        old_ms, old_by = _bound(c["nbytes"], c["simt_flops"])
        old = f"; at the fp32 peak {old_ms:.4g} ms ({old_by})"
    log(f"[kernels] ssd_chunk_scan[{c['name']}] events {ms:.4f} ms; "
        f"{_share(bound_ms, by, device_ms)}{old}; {c['tc_route']} "
        f"tensor-core floor {tc_ms:.4f} ms ({c['tc_flops']} flop at "
        f"{tc_peak / 1e12:g} TFLOP/s)")


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


def _ssd_exact(torch, ops, dev, dtype=None):
    """The SSD kernel's exact contracts, bit for bit, through the entry the
    model calls, at the pool's widths: each chunk of a packed launch (BC =
    8) gives the bits it gives alone, at l = 1, 2, 4, 8, 16 and 256; a chunk
    of n real positions padded with dt = 0 to each l bucket from the next
    power of two up to 16 gives the same bits in its n rows of y and in its
    state (n = 1, 2, 3, 5, 7). ``dtype``: x, B and C's (fp32 by default).
    Raises on the first difference."""
    typed = lambda args: _ssd_typed(torch, args, dtype or torch.float32)
    for l in (1, 2, 4, 8, 16, 256):
        args = typed(_ssd_padded(torch, dev, l, l))
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
            y, st = ops.ssd_chunk(*typed(_ssd_padded(torch, dev, n, l)))
            if first is None:
                first = (l, y[:, :, :n], st)
            elif not (torch.equal(y[:, :, :n], first[1])
                      and torch.equal(st, first[2])):
                raise AssertionError(f"ssd: {n} positions padded to l = {l} "
                                     f"differ from l = {first[0]}")
    torch.cuda.synchronize()
    return ("bit-identical alone and packed (l = 1, 2, 4, 8, 16, 256) and "
            "across l buckets (n = 1, 2, 3, 5, 7)"
            + (f", x/B/C {dtype}" if dtype else ""))


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


def _bf16_excess(got, want):
    """How far a bf16 output lies outside allclose(rtol = atol =
    BF16_TOL) of the plain version: max(|got - want| - BF16_TOL |want|),
    which must be at most BF16_TOL."""
    return ((got.float() - want.float()).abs()
            - BF16_TOL * want.float().abs()).max().item()


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
            finite = all(torch.isfinite(t).all().item() for t in
                         (got if isinstance(got, tuple) else (got,)))
            outs = got if isinstance(got, tuple) else (got,)
            if c["bf16"] and not c["scaled"]:
                if got.dtype != torch.bfloat16:
                    raise AssertionError(f"{kname}[{c['name']}]: output "
                                         f"{got.dtype}, not bf16")
                excess = _bf16_excess(got, want)
                ok = excess <= BF16_TOL
                tol_note = (f"allclose(rtol=atol={BF16_TOL:g}) "
                            f"excess {excess:.3g} <= {BF16_TOL:g}")
            else:
                # the SSD scan's bf16 instance writes fp32 and is held to
                # its fp32 instance's tolerance
                if any(t.dtype != torch.float32 for t in outs):
                    raise AssertionError(f"{kname}[{c['name']}]: outputs "
                                         f"{[t.dtype for t in outs]}")
                if not c["bf16"]:
                    worst = max(worst, err)
                tol = SSD_TOL * max(1.0, scale) if c["scaled"] \
                    else KERNEL_TOL
                ok = err <= tol
                tol_note = f"<= {tol:.3g}"
            if not (finite and ok):
                raise AssertionError(f"{kname}[{c['name']}]: max abs err "
                                     f"{err}, {tol_note} fails (finite: "
                                     f"{finite})")
            note = ""
            if c["check"] is not None:
                note = "; " + (c["check"](got) or (
                    "dt = 0 row's state exactly 0" if c["scaled"]
                    else "idle slot exactly 0"))
            log(f"[kernels] {kname}[{c['name']}] {c['desc']}: max abs err "
                f"{err:.3g}, {tol_note}{note}")
            if not c["timed"]:
                continue
            ms = _time_ms(torch, c["kernel"])
            plain_ms = _time_ms(torch, c["plain"])
            bound_ms, bound_by = _bound(c["nbytes"], c["flops"], c.get(
                "peak", PEAK_BF16_FLOP_PER_S if c["bf16"]
                else PEAK_FP32_FLOP_PER_S))
            if c["name"] == "main":
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
            elif c["name"] == "main_bf16":
                row["bf16"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=None)
            lib, lib_ms = "", None
            if c["library"] is not None:
                lib_err = (c["library"]().float() - want.float()).abs() \
                    .max().item()
                lib_ms = _time_ms(torch, c["library"])
                if c["name"] == "main":
                    row["library_ms"] = lib_ms
                elif c["name"] == "main_bf16":
                    row["bf16"]["library_ms"] = lib_ms
                lib = (f", library {lib_ms:.4f} ms (max abs err "
                       f"{lib_err:.3g})")
            log(f"[kernels] {kname}[{c['name']}] kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms{lib}, bound {bound_ms:.4g} ms "
                f"({bound_by}: {c['nbytes']} B, {c['flops']} flop)")
            if c["report"] is not None:
                c["report"](torch, c, ms, plain_ms, lib_ms)
        row["max_abs_err"] = worst
        rows.append(row)
    return rows


# ------------------------------------------------------------------ phase 4
def main_path_phase(torch, card: str, smi: str):
    import numpy as np
    from repro_torch.configs.qwen15_32b import CONFIG as QWEN
    from repro_torch.launch.serve import scaled_sibling
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
        def run(*args, **kw):
            d0, p0 = dec.paged_decode_attention_gqa.launches, \
                pre.paged_prefill_attention_gqa.launches
            out = step(*args, **kw)
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
                launches=launches, wall=wall)


# ----------------------------------------------------------------- phase 4b
def dense_hybrid_phase(torch, card: str, smi: str, pool_run: dict,
                       tag: str = "dense"):
    """The paper's dense-batch hybrid path on the pool phase's models and
    router: HybridEngine over two dense Engines, the same 16 prompts as
    (16, 512) PAD-padded tokens. One warm-up serve, then one counted and
    timed serve. ``tag`` names the log's lines."""
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
        log(f"[{tag}] {name}: {eng.stats.requests} requests in "
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
    log(f"[{tag}] {N_PROMPTS} requests ({int(res.routed_small.sum())} half, "
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


# ----------------------------------------------------------------- phase 4f
SYS_TOKENS = 256      # the shared system prompt: 16 whole pages
SUFFIX_CAP = 256      # each phase-4 prompt cut to at most this after it
FORK_SHARED = 264     # the fork prompt's shared head: half a page past sys
PREFIX_PAGES = 64     # the tree's page budget (prefix_cache)
TURN_TOKENS = 32      # new tokens a second-turn prompt adds
SPEC_GAMMA = 4        # drafted tokens a speculative round


def _counted_bundle(bundle, counters, into, **labels):
    """``bundle`` with each function named in ``labels`` adding the
    kernel launches during its call to ``into[label]``."""
    repl = {}
    for fn_name, label in labels.items():
        fn = getattr(bundle, fn_name)

        def run(*args, fn=fn, label=label, **kw):
            before = {k: w.launches for k, w in counters.items()}
            out = fn(*args, **kw)
            for k, w in counters.items():
                into[label][k] += w.launches - before[k]
            return out
        repl[fn_name] = run
    return dataclasses.replace(bundle, **repl)


def prefix_spec_phase(torch, card: str, smi: str, pool_run: dict):
    """Phase 4f on phase 4's two qwen1.5-32b tiers, router and prompts.

    (a) Shared-prefix reuse on "full": 16 prompts, a seeded 256-token
    system prompt followed by each phase-4 prompt cut to 256 tokens, and a
    fork prompt sharing the longest first-slot stream's first 264 tokens
    (submitted ninth, so it admits while that stream still maps its
    pages, and forks inside a page: a COW split); then a second turn of 8
    streams (prompt + response + 32 new tokens). Served with
    prefix_cache=0 and with PREFIX_PAGES, 8 slots, 16-token chunks: the
    tokens must agree, the tree serve must hit on the second wave and
    turn and launch fewer K2, split at least one page, and drain to clean
    refcounts with only the tree's residents in use.
    (b) Speculation at gamma SPEC_GAMMA, greedy: a pool over phase 4's
    tiers with "half" drafting for "full" must route as phase 4 did and
    emit its tokens; "full" drafting on its own bundle and module
    (self-speculation) must emit phase 4's full-tier tokens. K2 runs as
    the verify chunk (C = gamma + 1) and the draft mirror's prefill, K1
    as the draft's micro-steps; every pool and mirror must drain clean.
    Each serve's launches are read with the counts set to 0 just before
    it. Returns {kernel: {path: launches}}."""
    import numpy as np
    from repro_torch.core.routing import ThresholdPolicy
    from repro_torch.kernels.paged_decode_attention import ops as dec
    from repro_torch.kernels.paged_prefill_attention import ops as pre
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    counters = {"paged_decode_attention": dec.paged_decode_attention_gqa,
                "paged_prefill_attention": pre.paged_prefill_attention_gqa}
    K1, K2 = counters

    def zero():
        for w in counters.values():
            w.launches = 0

    def read():
        return {k: w.launches for k, w in counters.items()}

    cfgs, models = pool_run["cfgs"], pool_run["models"]
    bundles = {n: build_model(c) for n, c in cfgs.items()}
    tokens, lens = pool_run["tokens"], pool_run["lens"]
    prompts = [tokens[i, :int(lens[i])] for i in range(N_PROMPTS)]
    phase4 = [list(pool_run["responses"][i, :int(pool_run["lengths"][i])])
              for i in range(N_PROMPTS)]
    vocab = cfgs["full"].vocab_size
    by_path = {K1: {}, K2: {}}
    t_phase = time.monotonic()

    # (a) shared-prefix reuse on the full tier
    rng = np.random.default_rng(23)
    sys_prompt = rng.integers(4, vocab, SYS_TOKENS).astype(np.int32)
    wave = [np.concatenate([sys_prompt, p[:SUFFIX_CAP]]) for p in prompts]
    parent = max(range(N_SLOTS), key=lambda i: (len(wave[i]), -i))
    fork = np.concatenate([wave[parent][:FORK_SHARED],
                           rng.integers(4, vocab, 40).astype(np.int32)])
    wave.insert(N_SLOTS, fork)
    turn_of = list(range(N_SLOTS + 1, N_SLOTS + 9))
    new_text = rng.integers(4, vocab, (len(turn_of), TURN_TOKENS)
                            ).astype(np.int32)

    def prefix_serve(prefix_cache):
        eng = ContinuousEngine(bundles["full"], models["full"],
                               max_new_tokens=NEW_TOKENS, n_slots=N_SLOTS,
                               max_seq=MAX_SEQ, prefix_cache=prefix_cache)
        out = {}
        zero()
        t0 = time.monotonic()
        first = [eng.submit(p) for p in wave]
        eng.run()
        torch.cuda.synchronize()
        out["wave"] = (read(), time.monotonic() - t0)
        hits_wave = eng.stats.prefix_hits
        turn = [np.concatenate([wave[i], np.asarray(first[i].out, np.int32),
                                t]) for i, t in zip(turn_of, new_text)]
        zero()
        t0 = time.monotonic()
        second = [eng.submit(p) for p in turn]
        eng.run()
        torch.cuda.synchronize()
        out["turn"] = (read(), time.monotonic() - t0)
        c = eng.cache
        resident = c.prefix.resident if c.prefix is not None else 0
        bad = c.check_refcounts() + c.check_pages()
        if bad or c.stats.pages_in_use != resident:
            raise AssertionError(f"prefix_cache={prefix_cache}: after the "
                                 f"drain {c.stats.pages_in_use} pages in use"
                                 f" against {resident} tree residents; "
                                 f"{bad}")
        return eng, first, turn, second, out, hits_wave

    runs = {pc: prefix_serve(pc) for pc in (0, PREFIX_PAGES)}
    (plain, p_first, p_turn, p_second, p_out, _), \
        (shared, s_first, s_turn, s_second, s_out, hits_wave) = \
        runs[0], runs[PREFIX_PAGES]
    for tag, srcs, got, want in (("wave", wave, s_first, p_first),
                                 ("turn", p_turn, s_second, p_second)):
        for i, (src, g, w) in enumerate(zip(srcs, got, want)):
            _exact_or_fail(torch, f"prefix {tag} prompt {i}",
                           bundles["full"], models["full"], src, g.out,
                           w.out)
    st = shared.stats
    k2 = {pc: sum(o[K2] for o, _ in runs[pc][4].values()) for pc in runs}
    log(f"[prefix] full tier, {len(wave)} prompts of "
        f"{min(map(len, wave))}-{max(map(len, wave))} tokens (a "
        f"{SYS_TOKENS}-token system prompt; the fork shares {FORK_SHARED} "
        f"with prompt {parent}), then {len(turn_of)} second turns: tokens "
        f"equal with prefix_cache=0 and {PREFIX_PAGES}; prefix_hits "
        f"{st.prefix_hits} ({hits_wave} in the first serve), misses "
        f"{st.prefix_misses}, hit tokens {st.prefix_hit_tokens}, hit pages "
        f"{st.prefix_hit_pages}, cow_splits {st.cow_splits}, tree evictions "
        f"{shared.cache.prefix.stats.evicted_pages}, residents "
        f"{shared.cache.prefix.resident}")
    for pc, (eng, _, _, _, out, _) in runs.items():
        log(f"[prefix] prefix_cache={pc}: launches and wall by serve "
            + "; ".join(f"{k} {o} {w:.3f} s" for k, (o, w) in out.items())
            + f"; prefill tokens {eng.stats.prefill_tokens}, dispatches "
            f"{eng.stats.prefill_dispatches} on {card} ({smi})")
    if st.cow_splits < 1:
        raise AssertionError("the fork prompt split no page")
    if hits_wave < 1 or st.prefix_hits <= hits_wave:
        raise AssertionError(f"prefix hits {hits_wave} in the first serve, "
                             f"{st.prefix_hits} after the second turn")
    if not k2[PREFIX_PAGES] < k2[0]:
        raise AssertionError(f"K2 launches with the tree {k2[PREFIX_PAGES]}"
                             f" not below {k2[0]} without")
    for k in counters:
        by_path[k]["qwen1.5-32b-prefix"] = sum(
            o[k] for o, _ in s_out.values())

    # (b) speculation
    def labels():
        return {n: {k: 0 for k in counters} for n in
                ("prefill", "decode", "verify", "draft", "mirror")}

    def count_spec(eng, into):
        eng.bundle = _counted_bundle(
            eng.bundle, counters, into, prefill_paged_chunk="prefill",
            decode_step_paged="decode", verify_paged_chunk="verify")
        eng.draft_bundle = _counted_bundle(
            eng.draft_bundle, counters, into, prefill_paged_chunk="mirror",
            decode_step_paged="draft")

    def check_spec(tag, eng, into, draft_layers):
        st = eng.stats
        want = {"verify": (K2, st.verify_steps * eng.bundle.cfg.n_layers),
                "draft": (K1, st.draft_steps * draft_layers)}
        for label, (k, n) in want.items():
            if into[label][k] != n or n <= 0:
                raise AssertionError(f"{tag}: {label} launched {k} "
                                     f"{into[label][k]} times, not {n}")
        for c in (eng.cache, eng.draft_cache):
            if c.free_pages != c.num_pages - 1 or c.check_refcounts():
                raise AssertionError(f"{tag}: a pool or its draft mirror "
                                     "did not drain clean")

    def spec_line(tag, eng, into, wall, n_tok):
        st = eng.stats
        log(f"[spec] {tag}: spec rounds {st.spec_rounds}, acceptance rate "
            f"{st.acceptance_rate:.4f} ({st.accepted_tokens} of "
            f"{st.drafted_tokens} drafted), spec_fallbacks "
            f"{st.spec_fallbacks}, verify chunks {st.verify_steps}, draft "
            f"micro-steps {st.draft_steps}, plain decode steps "
            f"{st.decode_steps}; launches {into}; {n_tok} tokens in "
            f"{wall:.3f} s (phase 4's serve {pool_run['wall']:.3f} s) on "
            f"{card} ({smi})")

    spec_launches = {k: 0 for k in counters}
    engines = [(n, ContinuousEngine(bundles[n], models[n],
                                    max_new_tokens=NEW_TOKENS,
                                    n_slots=N_SLOTS, max_seq=MAX_SEQ))
               for n in ("half", "full")]
    pool = ContinuousPoolEngine(ThresholdPolicy(pool_run["router"]),
                                engines, spec_gamma=SPEC_GAMMA)
    if pool.plan.pairs != ((0, 1),):
        raise AssertionError(f"step plan {pool.plan}")
    into = labels()
    count_spec(pool.engine("full"), into)
    zero()
    t0 = time.monotonic()
    res = pool.serve(tokens, pool_run["mask"], seed=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    got = read()
    if not np.array_equal(res.tier_idx, pool_run["tier_idx"]):
        raise AssertionError("the speculative pool routes differently from "
                             "phase 4")
    for i in range(N_PROMPTS):
        name = pool.names[res.tier_idx[i]]
        _exact_or_fail(torch, f"spec pool prompt {i}", bundles[name],
                       models[name], prompts[i],
                       list(res.responses[i, :int(res.lengths[i])]),
                       phase4[i])
    check_spec("spec pool", pool.engine("full"), into,
               cfgs["half"].n_layers)
    half = pool.engine("half")
    if half.cache.free_pages != half.cache.num_pages - 1:
        raise AssertionError("spec pool: the half tier leaked pages")
    spec_line("pool, half drafts for full", pool.engine("full"), into, wall,
              int(res.lengths.sum()))
    log(f"[spec] pool meter: drafted {pool.meter.drafted.tolist()}, "
        f"accepted {pool.meter.accepted.tolist()}, rejected "
        f"{pool.meter.rejected.tolist()}; all launches {got}")
    for k in counters:
        spec_launches[k] += got[k]
    verify_k2 = into["verify"][K2]
    mirror_k2 = into["mirror"][K2]
    draft_k1 = into["draft"][K1]

    full_idx = [i for i in range(N_PROMPTS) if pool_run["tier_idx"][i]]
    eng = ContinuousEngine(bundles["full"], models["full"],
                           max_new_tokens=NEW_TOKENS, n_slots=N_SLOTS,
                           max_seq=MAX_SEQ)
    eng.attach_draft(eng.bundle, eng.params, gamma=SPEC_GAMMA)
    if eng.draft_params is not eng.params:
        raise AssertionError("self-speculation holds a second module")
    into = labels()
    count_spec(eng, into)
    zero()
    t0 = time.monotonic()
    reqs = [eng.submit(prompts[i]) for i in full_idx]
    eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    got = read()
    for i, r in zip(full_idx, reqs):
        _exact_or_fail(torch, f"self-spec prompt {i}", bundles["full"],
                       models["full"], prompts[i], r.out, phase4[i])
    check_spec("self-spec", eng, into, cfgs["full"].n_layers)
    st = eng.stats
    n_tok = sum(r.n_generated for r in reqs)
    spec_line("self-speculation on full", eng, into, wall, n_tok)
    log(f"[spec] self-speculation: verify chunks a token "
        f"{st.verify_steps / n_tok:.4f}, slot-rounds a decoded token "
        f"{st.drafted_tokens / SPEC_GAMMA / st.decode_tokens:.4f} "
        f"(1/(gamma+1) = {1 / (SPEC_GAMMA + 1):.4f} at full acceptance); "
        f"all launches {got}")
    for k in counters:
        spec_launches[k] += got[k]
    verify_k2 += into["verify"][K2]
    mirror_k2 += into["mirror"][K2]
    draft_k1 += into["draft"][K1]
    by_path[K1]["qwen1.5-32b-spec"] = spec_launches[K1]
    by_path[K1]["qwen1.5-32b-spec-draft"] = draft_k1
    by_path[K2]["qwen1.5-32b-spec"] = spec_launches[K2]
    by_path[K2]["qwen1.5-32b-spec-verify"] = verify_k2
    by_path[K2]["qwen1.5-32b-spec-mirror"] = mirror_k2
    log(f"[spec] phase 4f wall {time.monotonic() - t_phase:.3f} s on {card} "
        f"({smi}); launches by path {by_path}")
    return by_path


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
    through the continuous pool, then through the dense hybrid path
    (``_ssm_serve``). Returns the full tier's model and config (phases 5
    and 8), both tiers, the router, the prompts, the pool's routing and
    each path's wall and tokens (phase 11(a))."""
    import numpy as np
    from repro_torch.configs.mamba2_130m import CONFIG as MAMBA
    from repro_torch.launch.serve import scaled_sibling
    from repro_torch.models.model import build_model

    dev = torch.device("cuda")
    cfgs = {"half": scaled_sibling(MAMBA, 2), "full": MAMBA}
    t0 = time.monotonic()
    models = {}
    for i, (name, cfg) in enumerate(cfgs.items()):
        models[name] = build_model(cfg).init(
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
    run = dict(model=models["full"], cfg=MAMBA, models=models, cfgs=cfgs,
               router=router.with_threshold(threshold), tokens=tokens,
               mask=mask, lens=lens)
    out = _ssm_serve(torch, card, smi, "ssm", run)
    return dict(run, tier_idx=out["tier_idx"], pool=out["pool"],
                dense=out["dense"],
                launches=sum(n for k in ("pool_launches", "dense_launches")
                             for n in out[k].values()))


def _ssm_serve(torch, card: str, smi: str, tag: str, run: dict,
               tier_idx=None):
    """``run``'s two SSM tiers ({"models", "cfgs"}) behind its router
    serve its prompts through the continuous pool, then through the dense
    hybrid path. Every kernel counter is watched on both tiers: the SSD
    chunk kernel must launch layers x prefill dispatches times on the pool
    and layers times per prefill on the dense path, and no other kernel
    may launch; no page may leak and every slot's state row must be free
    after the pool's drain; the dense path must route as the pool did, and
    the pool as ``tier_idx`` where given (an earlier run's). Returns the
    pool's routing, {kernel: launches} on each path (counted from 0, also
    by dtype), and each path's (tokens, wall)."""
    import numpy as np
    from repro_torch.core.routing import ThresholdPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine, Engine
    from repro_torch.serving.hybrid import HybridEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    counters = _all_counters()
    cfgs, models, router = run["cfgs"], run["models"], run["router"]
    tokens, mask = run["tokens"], run["mask"]
    vocab = cfgs["full"].vocab_size
    bundles = {name: build_model(cfg) for name, cfg in cfgs.items()}

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
    _reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    res = pool.serve(tokens, mask, seed=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    pool_launches = {k: w.launches for k, w in counters.items()}
    pool_by_dtype = _by_dtype(counters)
    summary = pool.meter.summary()
    for name, eng in tiers:
        want = {**dict.fromkeys(counters, 0),
                "ssd_chunk_scan": cfgs[name].n_layers
                * eng.stats.prefill_dispatches}
        log(f"[{tag}] pool {name}: calls {summary[name]['calls']}, tokens "
            f"{summary[name]['gen_tokens']}, decode steps "
            f"{eng.stats.decode_steps}, prefill dispatches "
            f"{eng.stats.prefill_dispatches}, kernel launches "
            f"{per_tier[name]} (expected {want}), state "
            f"{eng.rstate.state_bytes / 1e6:.1f} MB, free pages "
            f"{eng.cache.free_pages} of {eng.cache.num_pages}")
        if per_tier[name] != want or want["ssd_chunk_scan"] <= 0:
            raise AssertionError(f"{tag} pool tier {name}: launches "
                                 f"{per_tier[name]} != {want}")
        if eng.cache.free_pages != eng.cache.num_pages - 1:
            raise AssertionError(f"{tag} pool tier {name}: pages leaked")
        _slots_free(tag, name, eng)
    threshold = router.threshold
    if not np.array_equal(res.tier_idx, (res.scores < threshold)):
        raise AssertionError(f"{tag} pool: tier_idx disagrees with score < "
                             "threshold")
    if tier_idx is not None and not np.array_equal(res.tier_idx, tier_idx):
        raise AssertionError(f"{tag} pool: routes differently from phase "
                             "4c")
    if sum(v["calls"] for v in summary.values()) != N_PROMPTS \
            or not 0 < res.tier_idx.sum() < N_PROMPTS:
        raise AssertionError(f"{tag} pool: calls {summary}")
    if not (res.lengths >= 1).all() or res.responses.max() >= vocab \
            or res.responses.min() < 0:
        raise AssertionError(f"{tag} pool: responses out of range")
    n_tok = int(res.lengths.sum())
    log(f"[{tag}] pool: {N_PROMPTS} requests retired "
        f"({np.bincount(res.tier_idx, minlength=2).tolist()} half/full), "
        f"threshold {threshold:.6f}, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s on {card} ({smi}); launches by dtype "
        f"{pool_by_dtype}; peak memory {_peak(torch)}")

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
    _reset_counts(counters)
    t0 = time.monotonic()
    dres = hy.serve(tokens, mask, seed=0)
    torch.cuda.synchronize()
    dwall = time.monotonic() - t0
    dense_launches = {k: w.launches for k, w in counters.items()}
    dense_by_dtype = _by_dtype(counters)
    for name, eng in engines.items():
        want = {**dict.fromkeys(counters, 0),
                "ssd_chunk_scan": cfgs[name].n_layers}
        log(f"[{tag}] dense {name}: {eng.stats.requests} requests in "
            f"{eng.stats.batches} batches, kernel launches {per_tier[name]} "
            f"(expected {want}: one SSD launch per layer per prefill, none "
            "in decode)")
        if per_tier[name] != want:
            raise AssertionError(f"{tag} dense tier {name}: launches "
                                 f"{per_tier[name]} != {want}")
    if not np.array_equal(dres.routed_small, res.tier_idx == 0):
        raise AssertionError(f"{tag}: the dense hybrid path routes "
                             "differently from the pool")
    if hy.meter.tiers.total_calls != N_PROMPTS or not (dres.lengths >= 1) \
            .all() or dres.responses.max() >= vocab \
            or dres.responses.min() < 0:
        raise AssertionError(f"{tag} dense: calls or responses out of range")
    dn_tok = int(dres.lengths.sum())
    log(f"[{tag}] dense: {N_PROMPTS} requests "
        f"({int(dres.routed_small.sum())} half, "
        f"{int((~dres.routed_small).sum())} full), {dn_tok} tokens in "
        f"{dwall:.3f} s = {dn_tok / dwall:.1f} tokens/s on {card} ({smi}); "
        f"launches by dtype {dense_by_dtype}")
    return dict(tier_idx=res.tier_idx, pool_launches=pool_launches,
                dense_launches=dense_launches, pool_by_dtype=pool_by_dtype,
                dense_by_dtype=dense_by_dtype, pool=(n_tok, wall),
                dense=(dn_tok, dwall))


def _slots_free(tag, name, eng):
    """Raise unless every slot of ``eng``, and with it its state row, is
    free after the drain (slot s owns state row s + 1)."""
    if eng.sched.running or sorted(eng.sched._free_slots) != \
            list(range(eng.n_slots)) or eng.rstate.state["h"] \
            .shape[0] != eng.n_slots + 1:
        raise AssertionError(f"{tag} pool tier {name}: a slot (and its "
                             "state row) is still held")


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
    from repro_torch.launch.serve import scaled_sibling
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


# ----------------------------------------------------------------- phase 4g
def _all_counters():
    """{kernel name: its wrapper, whose ``launches`` counts launches}."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_decode_attention import ops as pdec
    from repro_torch.kernels.paged_prefill_attention import ops as ppre
    from repro_torch.kernels.ssd_scan import ops as ssd
    return {"paged_decode_attention": pdec.paged_decode_attention_gqa,
            "paged_prefill_attention": ppre.paged_prefill_attention_gqa,
            "flash_attention": fa.flash_attention,
            "decode_attention": dec.decode_attention_kv,
            "ssd_chunk_scan": ssd.ssd_chunk_scan}


def _count_drops(moe_mod, into):
    """Wrap ``moe_mod.moe_forward`` (where the decoder and the hybrid stack
    call it) to add each call's assignments dropped by capacity to
    ``into[0]``, a device counter read after the run (no sync per call).
    Returns the original, to put back."""
    original = moe_mod.moe_forward

    def counted(moe, x, cfg):
        into[0] += (~moe_mod.route(moe, x, cfg)[2]).sum()
        return original(moe, x, cfg)
    moe_mod.moe_forward = counted
    return original


def jamba_phase(torch, card: str, smi: str):
    """Phase 4g, the MoE and hybrid slice at Jamba's published widths: two
    jamba-v0.1-52b tiers cut to one 8-layer block ("full": every published
    width; "half": scaled_sibling(., 2), d_model 2048, 16 heads over 8,
    d_ff 7168), 7 Mamba layers and 1 attention layer a block, MoE (16
    experts, top-2) every other layer, behind a router at
    DeBERTa-v3-large's widths over Jamba's vocabulary gating at the
    prompts' median score. Phase 4's traffic (16 prompts of 32-512 tokens,
    32 new tokens, 8 slots) through the continuous pool, then through the
    dense hybrid path (``_jamba_serve``). Logs the peak memory. Returns
    the half tier's model and config (phase 5), each kernel's launches on
    both paths, and the router, prompts and routing (phase 11(b))."""
    import numpy as np
    from repro_torch.configs.jamba_v01_52b import CONFIG as JAMBA
    from repro_torch.core.routing import HybridRouter
    from repro_torch.launch.serve import scaled_sibling
    from repro_torch.models.encoder import RouterConfig, init_router_encoder
    from repro_torch.models.model import build_model

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfgs = {"half": dataclasses.replace(scaled_sibling(JAMBA, 2),
                                        n_layers=JAMBA.attn_every),
            "full": dataclasses.replace(JAMBA, n_layers=JAMBA.attn_every)}
    t0 = time.monotonic()
    models = {n: build_model(c).init(torch.Generator(device=dev)
                                     .manual_seed(400 + i), dev)
              for i, (n, c) in enumerate(cfgs.items())}
    rcfg = RouterConfig(vocab_size=JAMBA.vocab_size, **DEBERTA_V3_LARGE)
    probe = HybridRouter(init_router_encoder(
        rcfg, torch.Generator(device=dev).manual_seed(407), dev), rcfg, 0.0)
    rng = np.random.default_rng(40)
    lens = rng.integers(32, 513, N_PROMPTS)
    tokens = rng.integers(4, JAMBA.vocab_size, (N_PROMPTS, 512)
                          ).astype(np.int32)
    mask = (np.arange(512)[None] < lens[:, None]).astype(np.float32)
    tokens[mask == 0] = 0
    threshold = float(np.median(probe.scores(tokens, mask).cpu().numpy()))
    torch.cuda.synchronize()
    for name, cfg in cfgs.items():
        log(f"[jamba] tier {name}: {cfg.n_layers} layers "
            f"({_n_mamba(cfg)} Mamba of {cfg.ssm_nheads} SSD heads of "
            f"{cfg.ssm_headdim}, state {cfg.ssm_state}; 1 attention of "
            f"{cfg.n_heads} heads of {cfg.resolved_head_dim} over "
            f"{cfg.n_kv_heads}), d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
            f"{cfg.n_experts} experts top-{cfg.top_k} every "
            f"{cfg.moe_every}nd layer, vocab {cfg.vocab_size}, "
            f"{cfg.param_count() / 1e9:.2f} B params "
            f"({4 * cfg.param_count() / 1e9:.1f} GB fp32)")
    log(f"[jamba] random init and the router's threshold on the card: "
        f"{time.monotonic() - t0:.1f} s, {_peak(torch)} allocated")
    run = dict(cfgs=cfgs, models=models, tokens=tokens, mask=mask,
               router=probe.with_threshold(threshold))
    out = _jamba_serve(torch, card, smi, "jamba", run)
    log(f"[jamba] peak memory in phase 4g: {_peak(torch)}")
    return dict(run, model=models["half"], cfg=cfgs["half"],
                tier_idx=out["tier_idx"], pool=out["pool"],
                dense=out["dense"],
                launches={k: out["pool_launches"][k]
                          + out["dense_launches"][k]
                          for k in out["pool_launches"]})


def _n_mamba(cfg):
    """Mamba layers in a block of ``cfg``."""
    return sum(not cfg.layer_kind(j)["attn"] for j in range(cfg.attn_every))


def _jamba_serve(torch, card: str, smi: str, tag: str, run: dict,
                 tier_idx=None):
    """``run``'s two hybrid tiers ({"models", "cfgs"}) behind its router
    serve its prompts through the continuous pool, then through the dense
    hybrid path (a HybridEngine over two dense Engines), which must route
    as the pool did (and the pool as ``tier_idx`` where given). Each
    kernel's launches, counted from 0 on each tier, must be exactly: on
    the pool K2 = prefill dispatches, K3 = 7 x prefill dispatches, K1 =
    decode steps; on the dense path K4 = 1 and K3 = 7 a prefill, K5 = 1 a
    decode step; nothing else. No page may leak, and every slot's state
    row must be free after the drain. The MoE assignments dropped by
    capacity are counted on both paths (the drop counter recomputes each
    MoE call's routing, in the timed runs). Returns the pool's routing,
    {kernel: launches} on each path (also by dtype) and each path's
    (tokens, wall)."""
    import numpy as np
    from repro_torch.core.routing import ThresholdPolicy
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine, Engine
    from repro_torch.serving.hybrid import HybridEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    dev = torch.device("cuda")
    counters = _all_counters()
    cfgs, models, router = run["cfgs"], run["models"], run["router"]
    tokens, mask = run["tokens"], run["mask"]
    vocab = cfgs["full"].vocab_size
    n_mamba = _n_mamba(cfgs["full"])
    bundles = {n: build_model(c) for n, c in cfgs.items()}
    drops = [torch.zeros((), dtype=torch.int64, device=dev)]
    original = _count_drops(moe, drops)
    try:
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
        _reset_counts(counters)
        drops[0].zero_()
        t0 = time.monotonic()
        res = pool.serve(tokens, mask, seed=0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        pool_drops = int(drops[0])
        pool_launches = {k: w.launches for k, w in counters.items()}
        pool_by_dtype = _by_dtype(counters)
        summary = pool.meter.summary()
        for name, eng in tiers:
            st = eng.stats
            want = {**dict.fromkeys(counters, 0),
                    "paged_prefill_attention": st.prefill_dispatches,
                    "ssd_chunk_scan": n_mamba * st.prefill_dispatches,
                    "paged_decode_attention": st.decode_steps}
            log(f"[{tag}] pool {name}: calls {summary[name]['calls']}, "
                f"tokens {summary[name]['gen_tokens']}, decode steps "
                f"{st.decode_steps}, prefill dispatches "
                f"{st.prefill_dispatches}, kernel launches {per_tier[name]}"
                f" (expected {want}), state "
                f"{eng.rstate.state_bytes / 1e6:.1f} MB, free pages "
                f"{eng.cache.free_pages} of {eng.cache.num_pages}")
            if per_tier[name] != want or min(st.prefill_dispatches,
                                             st.decode_steps) <= 0:
                raise AssertionError(f"{tag} pool tier {name}: launches "
                                     f"{per_tier[name]} != {want}")
            if eng.cache.free_pages != eng.cache.num_pages - 1:
                raise AssertionError(f"{tag} pool tier {name}: pages "
                                     "leaked")
            _slots_free(tag, name, eng)
        if not np.array_equal(res.tier_idx, (res.scores < router.threshold)):
            raise AssertionError(f"{tag} pool: tier_idx disagrees with "
                                 "score < threshold")
        if tier_idx is not None and not np.array_equal(res.tier_idx,
                                                       tier_idx):
            raise AssertionError(f"{tag} pool: routes differently from "
                                 "phase 4g")
        if sum(v["calls"] for v in summary.values()) != N_PROMPTS \
                or not 0 < res.tier_idx.sum() < N_PROMPTS:
            raise AssertionError(f"{tag} pool: calls {summary}")
        if not (res.lengths >= 1).all() or res.responses.max() >= vocab \
                or res.responses.min() < 0:
            raise AssertionError(f"{tag} pool: responses out of range")
        n_tok = int(res.lengths.sum())
        log(f"[{tag}] pool: {N_PROMPTS} requests retired "
            f"({np.bincount(res.tier_idx, minlength=2).tolist()} half/full),"
            f" threshold {router.threshold:.6f}, {n_tok} tokens in "
            f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s on {card} ({smi});"
            f" launches by dtype {pool_by_dtype}; peak memory "
            f"{_peak(torch)}")
        del pool, tiers
        gc.collect()

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
            eng.stats = type(eng.stats)()
        _reset_counts(counters)
        drops[0].zero_()
        t0 = time.monotonic()
        dres = hy.serve(tokens, mask, seed=0)
        torch.cuda.synchronize()
        dwall = time.monotonic() - t0
        dense_drops = int(drops[0])
        dense_launches = {k: w.launches for k, w in counters.items()}
        dense_by_dtype = _by_dtype(counters)
    finally:
        moe.moe_forward = original
    for name, eng in engines.items():
        n = eng.stats.batches
        want = {**dict.fromkeys(counters, 0), "flash_attention": n,
                "ssd_chunk_scan": n_mamba * n,
                "decode_attention": NEW_TOKENS * n}
        log(f"[{tag}] dense {name}: {eng.stats.requests} requests in {n} "
            f"batches, kernel launches {per_tier[name]} (expected {want}: "
            f"K4 once and K3 {n_mamba} times a prefill, K5 once a decode "
            "step)")
        if per_tier[name] != want or n <= 0:
            raise AssertionError(f"{tag} dense tier {name}: launches "
                                 f"{per_tier[name]} != {want}")
    if not np.array_equal(dres.routed_small, res.tier_idx == 0):
        raise AssertionError(f"{tag}: the dense hybrid path routes "
                             "differently from the pool")
    if hy.meter.tiers.total_calls != N_PROMPTS or not (dres.lengths >= 1) \
            .all() or dres.responses.max() >= vocab \
            or dres.responses.min() < 0:
        raise AssertionError(f"{tag} dense: calls or responses out of range")
    dn_tok = int(dres.lengths.sum())
    same = sum(np.array_equal(a[:n], b[:n]) for a, b, n in
               zip(res.responses, dres.responses, res.lengths))
    log(f"[{tag}] dense: {N_PROMPTS} requests "
        f"({int(dres.routed_small.sum())} half, "
        f"{int((~dres.routed_small).sum())} full), {dn_tok} tokens in "
        f"{dwall:.3f} s = {dn_tok / dwall:.1f} tokens/s on {card} ({smi}); "
        f"launches by dtype {dense_by_dtype}")
    log(f"[{tag}] MoE assignments dropped by capacity: pool {pool_drops}, "
        f"dense {dense_drops} (chunked prefill and decode cannot drop; a "
        f"512-token dense prefill can); the paths' greedy tokens agree on "
        f"{same} of {N_PROMPTS} requests")
    if pool_drops:
        raise AssertionError(f"{tag} pool: {pool_drops} assignments dropped"
                             " where the capacity cannot be reached")
    return dict(tier_idx=res.tier_idx, pool_launches=pool_launches,
                dense_launches=dense_launches, pool_by_dtype=pool_by_dtype,
                dense_by_dtype=dense_by_dtype, pool=(n_tok, wall),
                dense=(dn_tok, dwall))


# ----------------------------------------------------------------- phase 4h
INTERNVL2_LAYERS = 8     # internvl2-26b's depth on the card (internvl2_phase)


def _generate_phase(torch, card, smi, tag, bundle, model, inputs,
                    per_prefill, per_step, cache_len):
    """Serve ``inputs`` (tokens plus the family's frontend inputs, on the
    card) through ``build_generate_fn`` at NEW_TOKENS greedy tokens: a
    warm-up on two rows and one prefill timed alone, outside the counts,
    then the counted serve. Launches counted from 0 must be exactly
    ``per_prefill`` for the prefill plus ``per_step`` for each of the
    NEW_TOKENS decode steps ({kernel: count}, every other kernel 0), and
    at a bf16 config only the kernels' bf16 instances; the cache must hold
    ``cache_len`` positions and end there. Logs prefill ms, tokens/s and
    the peak memory. Returns {"launches": by kernel, "by_dtype": by kernel
    and dtype, "prefill_ms", "tokens_s", "peak_gb"}."""
    import numpy as np
    from repro_torch.serving.generate import build_generate_fn
    counters = _all_counters()
    seen = {}
    prefill = bundle.prefill

    def watched(m, batch, max_seq=None):
        logits, cache = prefill(m, batch, max_seq)
        seen.update(slab=cache["k"].shape[2], cache=cache)
        return logits, cache

    gen = build_generate_fn(dataclasses.replace(bundle, prefill=watched),
                            NEW_TOKENS, 0.0)
    dev = inputs["tokens"].device
    gen(model, {k: v[:2] for k, v in inputs.items()},
        torch.Generator(device=dev).manual_seed(1))
    seen.clear()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        bundle.prefill(model, inputs, cache_len)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.monotonic() - t0)
    _reset_counts(counters)
    t0 = time.monotonic()
    toks, lens = gen(model, inputs, torch.Generator(device=dev)
                     .manual_seed(0))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: w.launches for k, w in counters.items()}
    by_dtype = _by_dtype(counters)
    want = {k: per_prefill.get(k, 0) + NEW_TOKENS * per_step.get(k, 0)
            for k in counters}
    slab, pos = seen["slab"], seen["cache"]["pos"]
    seen.clear()
    toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
    B = inputs["tokens"].shape[0]
    n_tok = int(lens.sum())
    log(f"[{tag}] {B} requests x {NEW_TOKENS} greedy tokens: prefill alone "
        f"{prefill_ms:.3f} ms; serve {wall:.3f} s = {n_tok / wall:.1f} "
        f"tokens/s to EOS ({n_tok} tokens; {B * NEW_TOKENS / wall:.1f} "
        f"decode positions/s) on {card} ({smi}); cache {slab} positions, "
        f"pos {pos} after the serve; kernel launches {launches} (expected "
        f"{want}), by dtype {by_dtype}; peak memory {_peak(torch)}")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    if bundle.cfg.dtype == "bfloat16":
        _only_bf16(tag, by_dtype, [k for k, n in want.items() if n])
    if slab != cache_len or pos != cache_len:
        raise AssertionError(f"{tag}: the cache holds {slab} positions and "
                             f"ends at {pos}, not {cache_len}")
    if toks.shape != (B, NEW_TOKENS) or not (lens >= 1).all() or \
            toks.min() < 0 or toks.max() >= bundle.cfg.vocab_size:
        raise AssertionError(f"{tag}: tokens out of range")
    return dict(launches=launches, by_dtype=by_dtype, prefill_ms=prefill_ms,
                tokens_s=n_tok / wall,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def _model_at(torch, bundle, seed, fp32):
    """The phase's model: drawn from ``seed`` on the card, or (phase 11)
    the bf16 twin of ``fp32["model"]``, an earlier run's, which it takes
    from ``fp32`` and frees; the peak memory is counted from there."""
    from repro_torch import bridge
    dev = torch.device("cuda")
    if fp32 is None:
        return bundle.init(torch.Generator(device=dev).manual_seed(seed), dev)
    model = bridge.twin(fp32.pop("model"), bundle.cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return model


def whisper_phase(torch, card: str, smi: str, fp32=None):
    """Phase 4h, the encoder-decoder: whisper-large-v3 as published (32
    encoder and 32 decoder layers at every width, enc_seq 1500, 2.02 B
    params), weights from a seed. 16 requests, each with its own stub
    frame embeddings (16 x 1500 x 1280) and a 48-token prompt drawn inside
    the vocabulary, through ``build_generate_fn`` at 32 greedy tokens.
    Launches counted from 0 must be exactly 64 flash launches per prefill
    (32 encoder, non-causal; 32 decoder, causal) and 64 dense decode
    launches per decode step (32 self, 32 cross over the 1500 encoder
    keys). ``fp32``: phase 4h's run, whose model phase 11(c) serves again
    as its bf16 twin (``bridge.twin``) on the same seeds' inputs at bf16,
    the bf16 instances alone launching. Returns the model and config
    (phase 5), the launches and the serve's figures."""
    from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER
    from repro_torch.models.frontends import make_batch
    from repro_torch.models.model import build_model
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = WHISPER if fp32 is None else \
        dataclasses.replace(WHISPER, dtype="bfloat16")
    tag = "whisper" if fp32 is None else "whisper bf16"
    bundle = build_model(cfg)
    t0 = time.monotonic()
    model = _model_at(torch, bundle, 600, fp32)
    inputs = make_batch(torch.Generator(device=dev).manual_seed(601), cfg,
                        N_PROMPTS, 48, for_train=False, device=dev)
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name}: {cfg.n_enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim} over "
        f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"enc_seq {cfg.enc_seq}: {cfg.param_count() / 1e9:.2f} B params "
        f"({4 * cfg.param_count() / 1e9:.1f} GB fp32), {cfg.dtype}; "
        f"weights and inputs {time.monotonic() - t0:.1f} s, {_peak(torch)} "
        "allocated")
    L = cfg.n_layers
    run = _generate_phase(
        torch, card, smi, tag, bundle, model, inputs,
        {"flash_attention": cfg.n_enc_layers + L},
        {"decode_attention": 2 * L}, 48 + NEW_TOKENS)
    return dict(run, model=model, cfg=cfg)


def internvl2_phase(torch, card: str, smi: str, fp32=None):
    """Phase 4h, the vision frontend: internvl2-26b at every published
    width (d_model 6144, 48 heads over 8 of 128, d_ff 16384, vocabulary
    92553), cut to INTERNVL2_LAYERS layers of its 48 (17.0 GB fp32; the
    published depth's weights alone take 79.4 GB, more than the card
    holds), weights from a seed. 16 requests, each 256 stub patch
    embeddings and a 256-token prompt (S = 512), through
    ``build_generate_fn`` at 32 greedy tokens; the cache must hold 256 +
    256 + 32 positions. Launches counted from 0 must be exactly one flash
    launch a layer per prefill and one dense decode launch a layer per
    decode step. ``fp32``: as ``whisper_phase``'s. Returns the model and
    config (phase 5), the launches and the serve's figures."""
    from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2
    from repro_torch.models.frontends import make_batch
    from repro_torch.models.model import build_model
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(
        INTERNVL2, n_layers=INTERNVL2_LAYERS,
        dtype="float32" if fp32 is None else "bfloat16")
    tag = "internvl2" if fp32 is None else "internvl2 bf16"
    bundle = build_model(cfg)
    t0 = time.monotonic()
    model = _model_at(torch, bundle, 700, fp32)
    inputs = make_batch(torch.Generator(device=dev).manual_seed(701), cfg,
                        N_PROMPTS, 256, for_train=False, device=dev)
    torch.cuda.synchronize()
    n_front = cfg.num_frontend_tokens
    log(f"[{tag}] {cfg.name} cut to {cfg.n_layers} of "
        f"{INTERNVL2.n_layers} layers: d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim} over "
        f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_front} frontend tokens: {cfg.param_count() / 1e9:.2f} B params "
        f"({4 * cfg.param_count() / 1e9:.1f} GB fp32; the published depth "
        f"{4 * INTERNVL2.param_count() / 1e9:.1f} GB), {cfg.dtype}; "
        f"weights and inputs {time.monotonic() - t0:.1f} s, {_peak(torch)} "
        "allocated")
    run = _generate_phase(
        torch, card, smi, tag, bundle, model, inputs,
        {"flash_attention": cfg.n_layers}, {"decode_attention": cfg.n_layers},
        n_front + 256 + NEW_TOKENS)
    return dict(run, model=model, cfg=cfg)


# ------------------------------------------------------------------ phase 5
def _compare(torch, tag, gpu_logits, cpu_logits, tol=DEVICE_TOL):
    """Max abs error of card against CPU logits within ``tol``; greedy
    tokens must agree on every row whose CPU top-2 margin exceeds it."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(gpu_logits, cpu_logits)):
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        top2 = b.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol
        same = (a.argmax(-1) == b.argmax(-1))[sure]
        log(f"[device-vs-cpu] {tag} logits {i} "
            f"({'prefill' if i == 0 else 'decode'}): max abs err {err:.3g}; "
            f"greedy tokens agree on {int(same.sum())}/{int(sure.sum())} "
            f"rows with a top-2 margin > {tol:.4g}")
        if not torch.isfinite(a).all() or not same.all():
            raise AssertionError(f"{tag}: card and CPU disagree on greedy "
                                 "tokens")
    if not worst <= tol:
        raise AssertionError(f"{tag}: card vs CPU logits {worst} > {tol}")


def _cpu_twins(torch, gpu, cfg, dtype_gap):
    """``gpu``'s weights on the CPU, as {"cpu": a module for ``cfg``} and,
    with ``dtype_gap`` (a bf16 ``cfg``), also {"cpu32": one for its fp32
    config holding the same values, widened}. Returns (modules, their
    configs)."""
    cpu = type(gpu)(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    mods, cfgs = {"cpu": cpu}, {"cpu": cfg}
    if dtype_gap:
        cfgs["cpu32"] = dataclasses.replace(cfg, dtype="float32")
        mods["cpu32"] = type(gpu)(cfgs["cpu32"], device="cpu")
        mods["cpu32"].load_state_dict(cpu.state_dict())
    return mods, cfgs


def _compare_runs(torch, tag, out, V):
    """Card against CPU logits (``out``: {"card", "cpu"[, "cpu32"]: [logits
    (B, V') fp32]}): at DEVICE_TOL, or where the CPU's fp32 twin ran (a
    bf16 model), within twice the dtype's gap (``_dtype_tol``: the CPU's
    bf16 logits against its fp32 twin's on the same weights and tokens)."""
    tol = DEVICE_TOL
    if "cpu32" in out:
        gap, tol = _dtype_tol(out["cpu"], out["cpu32"], V)
        err32 = max((a[..., :V] - b[..., :V]).abs().max().item()
                    for a, b in zip(out["card"], out["cpu32"]))
        log(f"[device-vs-cpu] {tag} the dtype's gap (CPU bf16 against CPU "
            f"fp32) {gap:.4g}, tolerance {tol:.4g}; card bf16 against CPU "
            f"fp32 {err32:.4g}")
    _compare(torch, tag, out["card"], out["cpu"], tol)


def device_vs_cpu_phase(torch, full_model, full_cfg, depth=1,
                        lens=(16, 11)):
    """A full decoder tier's first ``depth`` layers at full width, on the
    card and on the CPU (``card_vs_cpu``)."""
    from repro_torch.models import decoder
    cfg = dataclasses.replace(full_cfg, n_layers=depth)
    gpu = decoder.Decoder(cfg, device="meta")
    for name in ("embed", "ln_f", "head"):
        if hasattr(full_model, name):
            setattr(gpu, name, getattr(full_model, name))
    gpu.layers = torch.nn.ModuleList(full_model.layers[:depth])
    card_vs_cpu(torch, gpu, cfg, f"at depth {depth}", lens)


def card_vs_cpu(torch, gpu, cfg, what, lens=(16, 11), dtype_gap=False):
    """``gpu``, a model for ``cfg`` on the card, and a copy on the CPU, same
    inputs: two prompts of ``lens`` tokens through the paged path (16-token
    prefill chunks, two decode steps; a recurrent stack's state in
    recurrent-state rows 1 and 2; window layers walk from the engine's
    first page, ``window_start_page``) and through the dense path (a
    prefill over both prompts padded to the longer one, two decode steps),
    all through the bundle's entry points, logits compared
    (``_compare_runs``; ``dtype_gap``: a bf16 model, held within twice the
    dtype's gap, its fp32 twin run on the CPU too)."""
    import numpy as np
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import window_start_page
    cpus, cfgs = _cpu_twins(torch, gpu, cfg, dtype_gap)

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
        for key, model in (("card", gpu), *cpus.items()):
            dev = "cuda" if key == "card" else "cpu"
            bundle = build_model(cfgs.get(key, cfg))
            T = lambda a: torch.tensor(a, device=dev)
            cache = bundle.init_paged_cache(1 + sum(n_pg), ps, device=dev)
            if bundle.init_recurrent_state is not None:
                cache["rec"] = bundle.init_recurrent_state(3, device=dev)
            last = [None, None]
            for c0 in range(0, S, C):
                n_new = np.clip(lens - c0, 0, C).astype(np.int32)
                start = np.minimum(lens, c0).astype(np.int32)
                live = n_new > 0
                ws = window_start_page(int(start[live].min()) - (w - 1),
                                       ps) if w else 0
                x = bundle.prefill_paged_chunk(
                    model, cache, T(tokens[:, c0:c0 + C]), T(pt), T(start),
                    T(n_new), window_start=ws,
                    state_rows=T(np.where(live, [1, 2], 0).astype(np.int32)))
                for b in np.flatnonzero(live & (lens <= c0 + C)):
                    last[b] = x[b]
            logits = [bundle.lm_head(model, torch.stack(last))[:, 0]]
            sl = lens.copy()
            for step in range(2):
                # both devices feed the card's greedy tokens
                tok = (paged["card"][step] if key != "card"
                       else logits[-1]).argmax(-1).cpu().numpy()
                ws = window_start_page(int(sl.min()) + 1 - w, ps) if w else 0
                logits.append(bundle.decode_step_paged(
                    model, cache, T(tok[:, None]), T(pt), T(sl),
                    T(np.ones(2, bool)), window_start=ws))
                sl = sl + 1
            paged[key] = [t.float().cpu() for t in logits]

            last, cache = bundle.prefill(model, {"tokens": T(tokens)},
                                         max_seq=S + 2)
            logits = [last]
            for step in range(2):
                tok = (dense["card"][step] if key != "card"
                       else logits[-1]).argmax(-1).cpu().numpy()
                out, cache = bundle.decode_step(model, cache,
                                                T(tok[:, None]))
                logits.append(out)
            dense[key] = [t.float().cpu() for t in logits]
    tag = f"{cfg.name} {what}, prompts of {lens.tolist()} tokens,"
    _compare_runs(torch, f"{tag} paged", paged, cfg.vocab_size)
    _compare_runs(torch, f"{tag} dense", dense, cfg.vocab_size)


def moe_vs_cpu_phase(torch):
    """phi3.5-moe-42b-a6.6b at every published width and depth 2 (16
    experts top-2, 2.9 B params), weights from a seed, card against CPU
    (``card_vs_cpu``)."""
    from repro_torch.configs.phi35_moe_42b import CONFIG as PHI
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(PHI, n_layers=2)
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(500), "cuda")
    log(f"[device-vs-cpu] {cfg.name} at depth 2: "
        f"{cfg.param_count() / 1e9:.2f} B params")
    card_vs_cpu(torch, model, cfg, "at depth 2", lens=(40, 27))


def dense_vs_cpu(torch, gpu, cfg, what, inputs):
    """``gpu``, a model for ``cfg`` on the card, and a copy on the CPU, same
    ``inputs`` (CPU tensors: tokens plus the family's frontend inputs): a
    prefill and two decode steps through the bundle's entry points (both
    devices feed the card's greedy tokens), logits compared
    (``_compare_runs``: a bf16 ``cfg`` within twice the dtype's gap, its
    fp32 twin run on the CPU too, on the same inputs widened)."""
    from repro_torch.models.model import build_model
    cpus, cfgs = _cpu_twins(torch, gpu, cfg, cfg.dtype == "bfloat16")
    extra = cfg.frontend_positions
    B, S = inputs["tokens"].shape
    out = {}
    with torch.no_grad():
        for key, model in (("card", gpu), *cpus.items()):
            dev = "cuda" if key == "card" else "cpu"
            c = cfgs.get(key, cfg)
            bundle = build_model(c)
            batch = {k: v.to(dev, getattr(torch, c.dtype))
                     if v.is_floating_point() else v.to(dev)
                     for k, v in inputs.items()}
            last, cache = bundle.prefill(model, batch, max_seq=extra + S + 2)
            logits = [last]
            for step in range(2):
                tok = (out["card"][step] if key != "card"
                       else logits[-1]).argmax(-1).to(dev)
                o, cache = bundle.decode_step(model, cache, tok[:, None])
                logits.append(o)
            out[key] = [t.float().cpu() for t in logits]
    _compare_runs(torch, f"{cfg.name} {what}, {B} prompts of {S} tokens "
                  f"({extra} frontend positions),", out, cfg.vocab_size)


def whisper_vs_cpu(torch, full_model, full_cfg):
    """whisper-large-v3 at every width with 2 encoder and 2 decoder layers
    (the phase-4h model's first two of each) and enc_seq 1500, card
    against CPU (``dense_vs_cpu``) on two requests' stub frame embeddings
    and 16-token prompts."""
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.frontends import make_batch
    cfg = dataclasses.replace(full_cfg, n_layers=2, n_enc_layers=2)
    gpu = EncDec(cfg, device="meta")
    for name in ("embed", "enc_pos", "enc_ln_f", "ln_f", "head"):
        if hasattr(full_model, name):
            setattr(gpu, name, getattr(full_model, name))
    gpu.enc_layers = torch.nn.ModuleList(full_model.enc_layers[:2])
    gpu.dec_layers = torch.nn.ModuleList(full_model.dec_layers[:2])
    inputs = make_batch(torch.Generator().manual_seed(8), cfg, 2, 16,
                        for_train=False, device="cpu")
    dense_vs_cpu(torch, gpu, cfg, "at 2 + 2 layers", inputs)


def internvl2_vs_cpu(torch, full_model, full_cfg):
    """internvl2-26b at every width and depth 1 (the phase-4h model's
    first layer), card against CPU (``dense_vs_cpu``) on two requests'
    256 stub patch embeddings and 16-token prompts."""
    from repro_torch.models import decoder
    from repro_torch.models.frontends import make_batch
    cfg = dataclasses.replace(full_cfg, n_layers=1)
    gpu = decoder.Decoder(cfg, device="meta")
    for name in ("embed", "ln_f", "head"):
        if hasattr(full_model, name):
            setattr(gpu, name, getattr(full_model, name))
    gpu.layers = torch.nn.ModuleList(full_model.layers[:1])
    inputs = make_batch(torch.Generator().manual_seed(9), cfg, 2, 16,
                        for_train=False, device="cpu")
    dense_vs_cpu(torch, gpu, cfg, "at depth 1", inputs)


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
    from repro_torch.launch.serve import scaled_sibling
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


# ------------------------------------------------------------------ phase 7
LAUNCH_REQUESTS = 64
LAUNCH_CUT = ["--steps", "60", "--requests", str(LAUNCH_REQUESTS),
              "--samples", "2"]
LAUNCH_SERVES = {  # launches_by_path key: the serving launcher's own flags
    "launch-serve-mixed": ["--arch", "gemma3-4b", "--tiers", "mamba2-130m",
                           "qwen1.5-32b", "full", "--continuous",
                           "--prefix-cache", "16", "--escalate", "0.25"],
    "launch-serve-spec": ["--arch", "qwen1.5-32b", "--tiers", "quarter",
                          "half", "full", "--continuous", "--spec-gamma",
                          "2"],
    "launch-serve-dense": ["--arch", "gemma3-4b"],
}
LAUNCH_TRAIN = ["--arch", "mamba2-130m", "--steps", "20"]


def _launch_serve(torch, path, argv, card, smi):
    """One run of the serving launcher, ``launch.serve.main(argv +
    LAUNCH_CUT)``, on the card: its printed lines logged; each kernel's
    launches counted from 0 over the whole run (training, labelling,
    serving), and by tier model over its own paged calls (prefill chunks,
    decode steps and verify chunks, a draft's calls on its own model) or
    its dense serves; windowed paged launches by model; the request
    stream's wall and tokens. Raises unless the calls sum to the
    requests; every tier's model prefilled, with exactly one K2 per
    attention layer and one K3 per SSM layer a prefill chunk, one K1 per
    attention layer a decode step and one K2 a verify chunk (a dense
    tier: one K4 per layer a batch, one K5 per layer a decode step);
    windowed K1 and K2 launches ran on a window stack; the pools ran K1,
    K2 (and K3 where a tier is an SSM); and every continuous tier drained
    (free pages plus the prefix tree's are the pool's, refcounts clean,
    the draft mirror's too); with ``--prefix-cache``, every tier without
    window or SSM layers hit its prefix tree and every other tier names
    why it shares none. Returns the run's launches by kernel."""
    from unittest import mock
    from repro_torch.launch import serve
    from repro_torch.models import attention
    from repro_torch.serving.engine import ContinuousEngine, Engine
    from repro_torch.serving.hybrid import HybridEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    counters = _all_counters()
    calls = collections.Counter()             # (model, function): calls
    got = collections.defaultdict(collections.Counter)   # ...: launches
    watched = collections.Counter()
    tier, restore = _watch_attention(torch, attention, watched)
    stream = dict(wall=0.0, tokens=0)
    wrapped = set()

    def counting(name, what, fn):
        def run(*args, **kw):
            tier[0] = name
            before = {k: w.launches for k, w in counters.items()}
            try:
                return fn(*args, **kw)
            finally:
                tier[0] = None
                calls[name, what] += 1
                for k, w in counters.items():
                    got[name, what][k] += w.launches - before[k]
        return run

    def counted(bundle):
        new = dataclasses.replace(bundle, **{
            f: counting(bundle.cfg.name, f, getattr(bundle, f))
            for f in ("prefill_paged_chunk", "decode_step_paged",
                      "verify_paged_chunk") if getattr(bundle, f)})
        wrapped.add(id(new))
        return new

    def step(orig):         # ContinuousEngine.step: count through its
        def run(self, *args, **kw):     # tier's and its draft's bundles
            for attr in ("bundle", "draft_bundle"):
                b = getattr(self, attr)
                if b is not None and id(b) not in wrapped:
                    setattr(self, attr, counted(b))
            return orig(self, *args, **kw)
        return run

    def dense(orig):        # Engine.serve
        def run(self, *args, **kw):
            return counting(self.bundle.cfg.name, "serve",
                            lambda: orig(self, *args, **kw))()
        return run

    def timed(orig):        # the pool's and the dense pair's serve
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = orig(self, *args, **kw)
            torch.cuda.synchronize()
            stream["wall"] += time.monotonic() - t0
            stream["tokens"] += int(out.lengths.sum())
            return out
        return run

    for w in counters.values():
        w.launches = 0
    printed = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.ExitStack() as patches:
            for owner, attr, make in ((ContinuousEngine, "step", step),
                                      (Engine, "serve", dense),
                                      (ContinuousPoolEngine, "serve", timed),
                                      (HybridEngine, "serve", timed)):
                patches.enter_context(mock.patch.object(
                    owner, attr, make(getattr(owner, attr))))
            patches.enter_context(contextlib.redirect_stdout(printed))
            hy = serve.main(argv + LAUNCH_CUT)
        torch.cuda.synchronize()
    finally:
        restore()
        for line in printed.getvalue().splitlines():
            log(f"[launch] {path}: {line}")
    wall = time.monotonic() - t0
    launches = {k: w.launches for k, w in counters.items()}

    pool = isinstance(hy, ContinuousPoolEngine)
    summary = (hy.meter if pool else hy.meter.tiers).summary()
    n_calls = sum(r["calls"] for r in summary.values())
    if n_calls != LAUNCH_REQUESTS:
        raise AssertionError(f"{path}: {n_calls} calls for "
                             f"{LAUNCH_REQUESTS} requests: {summary}")
    K1, K2, K3 = ("paged_decode_attention", "paged_prefill_attention",
                  "ssd_chunk_scan")
    engines = hy.engines if pool else [hy.small, hy.large]
    for eng in engines:
        cfg = eng.bundle.cfg
        kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
        n_attn = sum(k["attn"] for k in kinds)
        n_ssm = sum(k["ssm"] for k in kinds)
        if pool:
            per_call = {"prefill_paged_chunk": {K2: n_attn, K3: n_ssm},
                        "decode_step_paged": {K1: n_attn},
                        "verify_paged_chunk": {K2: n_attn}}
        else:   # one batch a serve: a prefill, max_new_tokens decode steps
            per_call = {"serve": {"flash_attention": n_attn,
                                  "decode_attention": n_attn
                                  * eng.max_new_tokens}}
        first = next(iter(per_call))
        if not calls[cfg.name, first]:
            raise AssertionError(f"{path}: tier {cfg.name} never ran {first}")
        for what, per in per_call.items():
            want = {k: per.get(k, 0) * calls[cfg.name, what]
                    for k in counters}
            if any(got[cfg.name, what][k] != want[k] for k in counters):
                raise AssertionError(
                    f"{path}: tier {cfg.name}'s {calls[cfg.name, what]} "
                    f"{what} calls launched {dict(got[cfg.name, what])}, "
                    f"not {want}")
        if pool and cfg.has_window_layers:
            windowed = {n: sum(v for key, v in watched.items()
                               if key[:3] == (cfg.name, n, True))
                        for n in ("paged_decode_attention_gqa",
                                  "paged_prefill_attention_gqa")}
            log(f"[launch] {path}: {cfg.name} windowed launches {windowed}")
            if not all(windowed.values()):
                raise AssertionError(f"{path}: no windowed launch on "
                                     f"{cfg.name}: {windowed}")
        if pool:
            caches = [eng.cache] + ([eng.draft_cache] if eng.draft_cache
                                    is not None else [])
            for c in caches:
                tree = c.prefix.resident if c.prefix is not None else 0
                if c.free_pages + tree != c.num_pages - 1 \
                        or c.check_refcounts():
                    raise AssertionError(
                        f"{path}: tier {cfg.name} did not drain: "
                        f"{c.free_pages} free + {tree} in the tree of "
                        f"{c.num_pages - 1} pages")
        if pool and "--prefix-cache" in argv:
            shares = not (cfg.has_window_layers or cfg.ssm_state)
            if (eng.cache.prefix is not None) != shares \
                    or (not shares and not eng.prefix_reason) \
                    or (shares and eng.stats.prefix_hits <= 0):
                raise AssertionError(
                    f"{path}: tier {cfg.name} prefix tree "
                    f"{eng.cache.prefix is not None}, reason "
                    f"{eng.prefix_reason!r}, {eng.stats.prefix_hits} hits")
            log(f"[launch] {path}: {cfg.name} prefix "
                + (f"{eng.stats.prefix_hits} hits, "
                   f"{eng.stats.prefix_misses} misses, "
                   f"{eng.stats.prefix_hit_tokens} prefill tokens skipped"
                   if shares else f"off: {eng.prefix_reason}"))
    served = sum(got.values(), collections.Counter())
    need = [K1, K2] if pool else ["flash_attention", "decode_attention"]
    need += [K3] if any(e.bundle.cfg.ssm_state for e in engines) else []
    if any(served[k] <= 0 for k in need):
        raise AssertionError(f"{path}: serving launched {dict(served)}")
    log(f"[launch] {path}: calls and launches by tier model "
        + json.dumps({f"{n} {w}": [calls[n, w], {k: v for k, v in
                                                  got[n, w].items() if v}]
                      for n, w in sorted(calls)}))
    log(f"[launch] {path}: the run {wall:.3f} s (training, labelling and "
        f"serving); the stream of {LAUNCH_REQUESTS} requests "
        f"{stream['wall']:.3f} s, {stream['tokens']} tokens, "
        f"{stream['tokens'] / stream['wall']:.1f} tokens/s on {card} ({smi}); "
        f"launches {launches}")
    return launches


def _launch_train(torch, card, smi):
    """``launch.train.main(LAUNCH_TRAIN + --out)`` on the card; the
    checkpoint it writes (the JAX package's layout) must load back into a
    fresh port module with exactly the trained weights, and serve the same
    greedy tokens."""
    from repro_torch import bridge
    from repro_torch.launch import serve, train
    from repro_torch.serving.generate import build_generate_fn
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import load_checkpoint
    out = ROOT / "build" / "launch" / "mamba2-130m-smoke.npz"
    t0 = time.monotonic()
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            model = train.main(LAUNCH_TRAIN + ["--out", str(out)])
        torch.cuda.synchronize()
    finally:
        for line in printed.getvalue().splitlines():
            log(f"[launch] train: {line}")
    wall = time.monotonic() - t0
    cfg = serve._reduced(LAUNCH_TRAIN[1])
    loaded = bridge.params_from_numpy(load_checkpoint(str(out)), cfg, "cuda")
    trained, back = model.state_dict(), loaded.state_dict()
    if trained.keys() != back.keys() or not all(
            torch.equal(trained[k], back[k]) for k in trained):
        raise AssertionError("train: the checkpoint does not load back the "
                             "trained weights")
    gen = build_generate_fn(build_model(cfg), 12, 0.0)
    prompts = {"tokens": torch.randint(
        4, cfg.vocab_size, (8, 16), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(7))}
    g = torch.Generator(device="cuda")
    a, b = gen(model, prompts, g)[0], gen(loaded, prompts, g)[0]
    if not torch.equal(a, b):
        raise AssertionError("train: the reloaded module serves other "
                             "greedy tokens")
    log(f"[launch] train: {LAUNCH_TRAIN} in {wall:.3f} s on {card} ({smi}); "
        f"{len(trained)} tensors, {out.stat().st_size} bytes, reloaded "
        "exactly")


def launcher_phase(torch, card: str, smi: str):
    """Phase 7: the launchers, as a user starts them, on the card (runs
    (a) to (c) of LAUNCH_SERVES, then LAUNCH_TRAIN). Returns {path:
    launches by kernel}."""
    t0 = time.monotonic()
    by_path = {path: _launch_serve(torch, path, argv, card, smi)
               for path, argv in LAUNCH_SERVES.items()}
    _launch_train(torch, card, smi)
    log(f"[launch] phase 7 {time.monotonic() - t0:.3f} s on {card} ({smi})")
    return by_path


# ------------------------------------------------------------------ phase 8
AUDIT_PROMPTS, AUDIT_TOKENS = 6, 8    # phase 8(c)'s short serves
# the C entries each serve of phase 8(c) must launch
AUDIT_SERVES = {"qwen1.5-32b pool": ("paged_decode_attention_f32",
                                     "paged_prefill_attention_f32"),
                "qwen1.5-32b dense": ("flash_attention_f32",
                                      "decode_attention_f32"),
                "mamba2-130m pool": ("ssd_chunk_scan_f32",)}


def _audited(kernel_check, tag, calls, entries, must=()):
    """Audit ``calls``; log the launches by entry and the findings. Raises
    on a finding or on an entry of ``must`` never launched."""
    found = kernel_check.audit(calls, entries)
    by_entry = collections.Counter(c.entry for c in calls
                                   if c.kind == "launch")
    queries = sum(c.kind == "query" for c in calls)
    log(f"[analysis] {tag}: audited {dict(sorted(by_entry.items()))} "
        f"launches and {queries} queries: {len(found)} findings")
    for f in found[:20]:
        log(f"[analysis]   {f.format()}")
    if found:
        raise AssertionError(f"{tag}: {len(found)} launch audit findings")
    missing = [e for e in must if not by_entry[e]]
    if missing:
        raise AssertionError(f"{tag}: no audited launch of {missing}")
    return by_entry


def _rows_noted(rec, bundle):
    """``bundle`` whose paged decode step tells the recorder which rows it
    uses (its ``active`` argument) while the step runs."""
    step = bundle.decode_step_paged

    def decode(*args, **kw):
        rec.rows_in_use = args[5].to("cpu").numpy().astype(bool)
        try:
            return step(*args, **kw)
        finally:
            rec.rows_in_use = None
    return dataclasses.replace(bundle, decode_step_paged=decode)


def analysis_phase(torch, card: str, smi: str, pool_run: dict,
                   ssm_run: dict):
    """Phase 8 on the models phases 4 and 4c hold. (a) The port's four
    static passes over this checkout's src/repro_torch, in process: no
    finding and no allowlist problem. (b) kernel_check's probes on CUDA
    tensors, each call passed through to the real entry and audited, each
    output held against its plain version at phase 3's tolerances. (c)
    Three short serves of their own (never timed) with the recorder on:
    the qwen1.5-32b pool (K1, K2), the dense hybrid path on the same
    models and router (K4, K5) and a mamba2-130m pool engine (K3); every
    launch audited with its int operands copied to the host. K1's rows
    are held to the walk only where the decode step uses them."""
    import numpy as np
    from repro_torch.analysis import __main__ as analysis_cli
    from repro_torch.analysis import kernel_check
    from repro_torch.core.routing import ThresholdPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine, Engine
    from repro_torch.serving.hybrid import HybridEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    t0 = time.monotonic()
    # ---- (a) the four passes
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = analysis_cli.main(["--root", str(ROOT / "src" / "repro_torch")])
    for line in printed.getvalue().splitlines():
        log(f"[analysis] {line}")
    if rc != 0:
        raise AssertionError(f"python -m repro_torch.analysis exited {rc}")
    entries = kernel_check.read_entries(ROOT / "src" / "repro_torch" / "csrc")

    # ---- (b) the probes on the card
    with kernel_check.capture(live=True) as rec:
        for family, modes in kernel_check.probe_modes(
                "cuda", "cuda", seed=1).items():
            for mode in modes:
                rec.mode = mode.name
                got = mode.run()
                torch.cuda.synchronize()
                want = mode.plain()
                err, scale = _max_err(got, want)
                tol = SSD_TOL * max(1.0, scale) if mode.scaled \
                    else KERNEL_TOL
                what = "max abs err"
                if not isinstance(got, tuple) and \
                        got.dtype == torch.bfloat16:   # a bf16 mode
                    tol, err = BF16_TOL, _bf16_excess(got, want)
                    what = f"allclose(rtol=atol={BF16_TOL:g}) excess"
                finite = all(torch.isfinite(t).all().item() for t in
                             (got if isinstance(got, tuple) else (got,)))
                log(f"[analysis] probe {family}[{mode.name}]: {what} "
                    f"{err:.3g} <= {tol:.3g}")
                if not (finite and err <= tol):
                    raise AssertionError(
                        f"probe {family}[{mode.name}]: max abs err {err} > "
                        f"{tol} (finite: {finite})")
    _audited(kernel_check, "probes", rec.calls, entries,
             must=tuple(e.name for e in entries.values() if e.is_launch))

    # ---- (c) three short serves, every launch audited
    n = AUDIT_PROMPTS
    tokens, mask = pool_run["tokens"][:n], pool_run["mask"][:n]
    router = pool_run["router"]
    audited = {}
    with kernel_check.capture(live=True) as rec:
        rec.mode = "qwen pool"
        tiers = [(name, ContinuousEngine(
            _rows_noted(rec, build_model(pool_run["cfgs"][name])),
            pool_run["models"][name], max_new_tokens=AUDIT_TOKENS,
            n_slots=N_SLOTS, max_seq=MAX_SEQ)) for name in ("half", "full")]
        ContinuousPoolEngine(ThresholdPolicy(router), tiers).serve(
            tokens, mask, seed=0)
        torch.cuda.synchronize()
    audited["qwen1.5-32b pool"] = rec.calls
    with kernel_check.capture(live=True) as rec:
        rec.mode = "qwen dense"
        engines = {name: Engine(build_model(pool_run["cfgs"][name]),
                                pool_run["models"][name],
                                max_new_tokens=AUDIT_TOKENS)
                   for name in ("half", "full")}
        HybridEngine(router, engines["half"], engines["full"]).serve(
            tokens, mask, seed=0)
        torch.cuda.synchronize()
    audited["qwen1.5-32b dense"] = rec.calls
    rng = np.random.default_rng(11)
    with kernel_check.capture(live=True) as rec:
        rec.mode = "mamba2 pool"
        eng = ContinuousEngine(build_model(ssm_run["cfg"]), ssm_run["model"],
                               max_new_tokens=AUDIT_TOKENS, n_slots=N_SLOTS,
                               max_seq=MAX_SEQ)
        for length in rng.integers(24, 300, n):
            eng.submit(rng.integers(4, ssm_run["cfg"].vocab_size, length)
                       .astype(np.int32))
        eng.run()
        torch.cuda.synchronize()
    audited["mamba2-130m pool"] = rec.calls
    for tag, calls in audited.items():
        _audited(kernel_check, tag, calls, entries, must=AUDIT_SERVES[tag])
    # what the rows filter is for: decode launches whose unused rows (idle
    # or prefilling slots) lie past the walk
    dec = [dataclasses.replace(c, rows=None)
           for c in audited["qwen1.5-32b pool"]
           if c.entry == "paged_decode_attention_f32"]
    past = sum(bool(kernel_check.audit([c], entries, {"kernel-page-walk"}))
               for c in dec)
    log(f"[analysis] qwen pool: {past} of {len(dec)} K1 launches hand the "
        "kernel unused rows outside the walk (masked by the step)")
    log(f"[analysis] phase 8 {time.monotonic() - t0:.3f} s on {card} ({smi})")


# ------------------------------------------------------------------ phase 9
# (a) the dry run's combinations, each a subprocess on the host
DRYRUN_COMBOS = (("qwen1.5-32b", "decode_32k"), ("gemma3-4b", "train_4k"),
                 ("mamba2-130m", "prefill_32k"))
DRYRUN_TIMEOUT_S = 600
STEP_DEPTH = 2                          # (b): qwen1.5-32b's layers
FUSED_B, FUSED_PROMPT = 8, 32           # (c): rows, prompt tokens a row


def _step_runs():
    """(tag, config, shape, kernel the step launches, launches a run):
    phase 9(b)'s steps on the card."""
    from repro_torch.configs.mamba2_130m import CONFIG as MAMBA
    from repro_torch.configs.qwen15_32b import CONFIG as QWEN
    from repro_torch.models.config import InputShape
    qwen = dataclasses.replace(QWEN, n_layers=STEP_DEPTH)
    return (("qwen decode", qwen, InputShape("card-decode", 4096, 8,
                                             "decode"),
             "decode_attention", qwen.n_layers),
            ("qwen prefill", qwen, InputShape("card-prefill", 4096, 2,
                                              "prefill"),
             "flash_attention", qwen.n_layers),
            ("qwen train", qwen, InputShape("card-train", 1024, 1, "train"),
             None, 0),
            ("mamba2 prefill", MAMBA, InputShape("card-prefill", 4096, 2,
                                                 "prefill"),
             "ssd_chunk_scan", MAMBA.n_layers))


def _step_args(torch, bundle, model, shape, dev, gen):
    """The step's arguments on ``dev``, drawn from ``gen``: a decode cache
    of random K/V with every entry valid (the new token at the last
    position, as the dry run's ``cache_specs``), a prompt batch, or a
    training batch with the dry run's bf16 moments."""
    from repro_torch.launch.steps import DRYRUN_OPT
    from repro_torch.training.optim import init_opt_state
    cfg, B, S = bundle.cfg, shape.global_batch, shape.seq_len
    tok = lambda n: torch.randint(4, cfg.vocab_size, (B, n), generator=gen,
                                  device=dev)
    if shape.kind == "decode":
        cache = bundle.init_cache(B, S, device=dev)
        for k in ("k", "v"):
            cache[k].normal_(generator=gen)
        cache["pos"] = S - 1
        return (model, cache, tok(1))
    if shape.kind == "prefill":
        return (model, {"tokens": tok(S)})
    batch = {"tokens": tok(S), "labels": tok(S),
             "loss_mask": torch.ones((B, S), device=dev)}
    return (model, init_opt_state(dict(model.named_parameters()),
                                  DRYRUN_OPT), batch)


def _to_cpu(torch, args, cpu_model):
    """The step's arguments copied to the CPU, ``cpu_model`` in the
    model's place."""
    out = [cpu_model]
    for a in args[1:]:
        if isinstance(a, dict):
            out.append({k: v.to("cpu", copy=True) if hasattr(v, "to") else v
                        for k, v in a.items()})
        else:
            out.append(a.to("cpu", copy=True))
    return tuple(out)


def card_steps_phase(torch, card: str, smi: str, counters: dict):
    """Phase 9(b): the dry run's decode, prefill and train steps as
    entry points on the card, each predicted first by the fake run of the
    same config and shape on one device (``launch.dryrun.trace_step``):
    predicted against measured peak memory (the card's peak over what was
    allocated before the step's model), the count of products on the card
    by the port's dispatch counter against ``FlopCounterMode`` on the same
    run (equal exactly; the train step's also equal to the fake run's,
    the kernels of decode and prefill doing products neither mode sees),
    the step's wall, and decode and prefill outputs against the CPU at
    DEVICE_TOL. Returns the kernels' launches over the steps."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import cost_analysis, steps
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models.model import build_model

    dev = torch.device("cuda")
    for c in counters.values():
        c.launches = 0
    # config name -> (its model on the card, bytes allocated before it)
    model_of = {}
    for tag, cfg, shape, kernel, per_run in _step_runs():
        bundle = build_model(cfg)
        t0 = time.monotonic()
        pred = trace_step(cfg, shape)
        log(f"[steps] {tag}: fake run on one device {time.monotonic() - t0:.2f}"
            f" s: predicted peak {pred['memory']['peak_gb']:.3f} GB, "
            f"{pred['flops_per_dev']:.6g} products' FLOPs")
        if cfg.name not in model_of:
            model_of.clear()
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            g = torch.Generator(device=dev).manual_seed(900)
            model_of[cfg.name] = (bundle.init(g, dev), base)
        model, base = model_of[cfg.name]
        gen = torch.Generator(device=dev).manual_seed(901)
        args = _step_args(torch, bundle, model, shape, dev, gen)
        cpu_args = None
        if shape.kind != "train":
            cpu = type(model)(cfg, device="cpu")
            cpu.load_state_dict(model.state_dict())
            cpu_args = _to_cpu(torch, args, cpu)
            if tag == "qwen prefill":    # the CPU's prefill on one row
                cpu_args = (cpu, {"tokens": cpu_args[1]["tokens"][:1]})
        fn = {"decode": lambda: steps.build_decode_step(bundle, False),
              "prefill": lambda: steps.build_prefill_step(bundle,
                                                          shape.seq_len),
              "train": lambda: steps.build_train_step(bundle)}[shape.kind]()
        k0 = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc, \
                cost_analysis.CostCounter() as cc:
            out = fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if shape.kind == "decode":      # the timed step writes there again
            args[1]["pos"] = shape.seq_len - 1
        t0 = time.monotonic()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        ran = {k: c.launches - k0[k] for k, c in counters.items()}
        want = {k: (2 * per_run if k == kernel else 0) for k in counters}
        log(f"[steps] {tag} on {card} ({smi}): measured peak "
            f"{peak / 1e9:.3f} GB against {pred['memory']['peak_gb']:.3f} GB "
            f"predicted; products {cc.flops:.6g} FLOPs by the counter, "
            f"{fc.get_total_flops():.6g} by FlopCounterMode "
            f"({pred['flops_per_dev']:.6g} in the fake run); wall "
            f"{wall * 1e3:.3f} ms a step; launches {ran} (expected {want})")
        if cc.flops != fc.get_total_flops():
            raise AssertionError(f"{tag}: counter {cc.flops} != "
                                 f"FlopCounterMode {fc.get_total_flops()}")
        if shape.kind == "train" and cc.flops != pred["flops_per_dev"]:
            raise AssertionError(f"{tag}: card {cc.flops} != fake run "
                                 f"{pred['flops_per_dev']} FLOPs")
        if ran != want:
            raise AssertionError(f"{tag}: launches {ran} != {want}")
        if shape.kind == "train":
            if not torch.isfinite(out[2]):
                raise AssertionError(f"{tag}: loss {out[2]}")
            log(f"[steps] {tag}: loss {float(out[2]):.6f}")
        else:
            with torch.no_grad():
                want_logits = fn(*cpu_args)[0]
            got = out[0][:len(want_logits)].float().cpu()
            if got.shape != want_logits.shape:
                raise AssertionError(f"{tag}: logits {tuple(got.shape)}")
            _compare(torch, f"phase 9 {tag}", [got], [want_logits])
        del args, out, cpu_args, model
    del model_of
    gc.collect()
    torch.cuda.empty_cache()
    return {k: c.launches for k, c in counters.items() if c.launches}


def fused_pool_phase(torch, card: str, smi: str, pool_run: dict,
                     counters: dict):
    """Phase 9(c): ``build_fused_pool_step`` on phase 4's two qwen1.5-32b
    tiers and router: FUSED_B rows, one step after each tier's prefill
    of FUSED_PROMPT tokens. Every row's logits equal its tier's own
    ``decode_step`` logits exactly (cut to the smaller padded vocab), and
    K5 launches once a layer of each tier."""
    import numpy as np
    from repro_torch.models.model import build_model
    from repro_torch.serving.pool import build_fused_pool_step

    dev = torch.device("cuda")
    names = ("half", "full")
    cfgs, models = pool_run["cfgs"], pool_run["models"]
    bundles = [build_model(cfgs[n]) for n in names]
    router = pool_run["router"]
    prompts = torch.as_tensor(pool_run["tokens"][:FUSED_B, :FUSED_PROMPT]
                              .astype(np.int64), device=dev)
    rtok = torch.as_tensor(pool_run["tokens"][:FUSED_B], device=dev)
    rmask = torch.as_tensor(pool_run["mask"][:FUSED_B], device=dev)
    token = torch.full((FUSED_B, 1), 17, device=dev)
    with torch.no_grad():
        caches = [b.prefill(models[n], {"tokens": prompts},
                            FUSED_PROMPT + 4)[1]
                  for b, n in zip(bundles, names)]
        own = [b.decode_step(models[n], {**c, "k": c["k"].clone(),
                                         "v": c["v"].clone()}, token)[0]
               for b, n, c in zip(bundles, names, caches)]
    step = build_fused_pool_step(router.rcfg, bundles, (router.threshold,))
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.monotonic()
    logits, _, tier = step(router.params, tuple(models[n] for n in names),
                           rtok, rmask, tuple(caches), token)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    want = {"decode_attention": sum(cfgs[n].n_layers for n in names)}
    V = min(o.shape[-1] for o in own)
    exact = [bool(torch.equal(logits[r], own[int(tier[r])][r, :V]))
             for r in range(FUSED_B)]
    agree = int((tier.cpu().numpy() == pool_run["tier_idx"][:FUSED_B]).sum())
    log(f"[fused] {FUSED_B} rows, tiers {tier.tolist()} ({agree} of "
        f"{FUSED_B} as phase 4's pool routed them), logits (B, {V}), "
        f"{sum(exact)} rows bit-equal to their tier's decode_step, launches "
        f"{launches} (expected {want}), {wall * 1e3:.3f} ms on {card} "
        f"({smi})")
    if launches != want:
        raise AssertionError(f"fused pool step: launches {launches} != "
                             f"{want}")
    if logits.shape != (FUSED_B, V) or not all(exact):
        raise AssertionError("fused pool step: a row's logits differ from "
                             "its tier's decode_step")
    return launches


def dryrun_phase(torch, card: str, smi: str, pool_run: dict,
                 meanwhile=None):
    """Phase 9 (after phase 8, before phase 4d frees phases 4-4c's
    models). (a) ``python -m repro_torch.launch.dryrun`` on the host, one
    subprocess a combination, all three started together and run while
    the card works (no GPU visible to them): qwen1.5-32b x decode_32k (40
    KV heads do not divide 16, so the flash decode runs), gemma3-4b x
    train_4k and mamba2-130m x prefill_32k on the single (16, 16) mesh;
    each record must be ok; its peak, roofline terms and dominant term are
    logged. (c) The fused pool step (``fused_pool_phase``). (b) The steps
    on the card (``card_steps_phase``). Cuts: qwen1.5-32b at depth
    STEP_DEPTH for (b), the CPU's qwen prefill on the first row only;
    (c) at FUSED_B rows of FUSED_PROMPT tokens. ``meanwhile`` (phase 10)
    runs after (b), while the host's dry runs finish."""
    import os
    import tempfile
    t0 = time.monotonic()
    out = Path(tempfile.mkdtemp(prefix="dryrun_", dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = {combo: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         combo[0], "--shape", combo[1], "--mesh", "single", "--out",
         str(out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for combo in DRYRUN_COMBOS}
    try:
        counters = _all_counters()
        fused = fused_pool_phase(torch, card, smi, pool_run, counters)
        stepped = card_steps_phase(torch, card, smi, counters)
        t_card = time.monotonic() - t0
        if meanwhile is not None:
            meanwhile()
        for (arch, shape), proc in procs.items():
            text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            for line in text.splitlines()[-6:]:
                log(f"[dryrun] {line}")
            rec = json.loads((out / f"{arch}__{shape}__single.json")
                             .read_text())
            if proc.returncode != 0 or not rec["ok"]:
                raise AssertionError(f"dry run {arch} x {shape}: "
                                     f"{rec.get('error')}")
            rl, mem = rec["roofline"], rec["memory"]
            log(f"[dryrun] {arch} x {shape} on {rec['chips']} fake ranks: "
                f"trace {rec['trace_s']} s on the host, peak "
                f"{mem['peak_gb']:.3f} GB/device (arguments "
                f"{mem['argument_gb']:.3f}), compute {rl['compute_s']:.6g} "
                f"s, memory {rl['memory_s']:.6g} s, collective "
                f"{rl['collective_s']:.6g} s: dominant {rl['dominant']}; "
                f"collective bytes {rec['collective_by_kind']}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"[dryrun] phase 9 {time.monotonic() - t0:.3f} s on {card} ({smi}),"
        f" its card work {t_card:.3f} s" + ("; phase 10 ran while the host's "
                                             "dry runs worked"
                                             if meanwhile else ""))
    return {"dryrun-steps": stepped, "fused-pool": fused}


# ----------------------------------------------------------------- phase 10
BF16_CPU_PROMPTS = 4    # (b): phase 4's shortest prompts, on "full"


def _dtype_tol(cpu16, cpu32, V):
    """The card's bf16 tolerance from the dtype itself: ``gap``, the
    largest gap between the CPU's bf16 and fp32 logits (the same bf16
    weights), is how far one bf16 computation of the model lands from
    fp32. The card's bf16 and the CPU's bf16 are two such computations,
    rounding in other orders (and the kernels keep the scores in fp32,
    where the plain versions round them), so each as close to fp32 as the
    other lies within 2 gap of it: returns (gap, 2 gap)."""
    gap = max((a[..., :V] - b[..., :V]).abs().max().item()
              for a, b in zip(cpu16, cpu32))
    return gap, 2 * gap


def _reset_counts(counters):
    for c in counters.values():
        c.launches = 0
        if hasattr(c, "launches_by_dtype"):
            c.launches_by_dtype = {}


def _by_dtype(counters):
    """{kernel: {dtype: launches}} of the wrappers that launched."""
    return {k: dict(c.launches_by_dtype) for k, c in counters.items()
            if getattr(c, "launches_by_dtype", None)}


def _only_bf16(tag, by_dtype, names):
    """Raise unless each kernel of ``names`` launched, and only its bf16
    instance."""
    for k in names:
        got = by_dtype.get(k, {})
        if not got.get("bfloat16") or set(got) != {"bfloat16"}:
            raise AssertionError(f"{tag}: {k} launches by dtype {got}; "
                                 "the bf16 instance alone must launch")


def bf16_pool_phase(torch, card: str, smi: str, pool_run: dict, bf16: dict):
    """Phase 10(b): phase 4's routed pool with both tiers at bf16 (phase
    4's models cast by ``.to(torch.bfloat16)``, their configs at dtype
    bfloat16, so the pools are bf16 too), phase 4's fp32 router and
    prompts, one warm-up and one counted and timed serve: every query on
    phase 4's tier, K1 and K2 on both tiers and only their bf16 instances,
    no page leaked; tokens/s beside phase 4's, the peak memory."""
    import numpy as np
    from repro_torch.core.routing import ThresholdPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.pool import ContinuousPoolEngine

    counters = _all_counters()
    paged = ("paged_decode_attention", "paged_prefill_attention")
    tiers = [(n, ContinuousEngine(build_model(bf16["cfgs"][n]),
                                  bf16["models"][n], max_new_tokens=NEW_TOKENS,
                                  n_slots=N_SLOTS, max_seq=MAX_SEQ))
             for n in ("half", "full")]
    pool = ContinuousPoolEngine(ThresholdPolicy(pool_run["router"]), tiers)
    tokens, mask = pool_run["tokens"], pool_run["mask"]
    for _, eng in tiers:
        eng.serve(tokens[:2, :48], seed=1)
        eng.stats = type(eng.stats)()
    pool.meter.reset()
    per_tier = {name: {k: 0 for k in paged} for name, _ in tiers}

    def counted(name, step):
        def run(*args, **kw):
            n0 = {k: counters[k].launches for k in paged}
            out = step(*args, **kw)
            for k in paged:
                per_tier[name][k] += counters[k].launches - n0[k]
            return out
        return run

    for name, eng in tiers:
        eng.step = counted(name, eng.step)
    _reset_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    res = pool.serve(tokens, mask, seed=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    by_dtype = _by_dtype(counters)
    for name, eng in tiers:
        log(f"[bf16 pool] {name}: calls {pool.meter.summary()[name]['calls']}"
            f", decode steps {eng.stats.decode_steps}, prefill dispatches "
            f"{eng.stats.prefill_dispatches}, kernel launches "
            f"{per_tier[name]}, free pages {eng.cache.free_pages} of "
            f"{eng.cache.num_pages}")
        if not all(per_tier[name].values()):
            raise AssertionError(f"bf16 tier {name}: a paged kernel never "
                                 f"launched: {per_tier[name]}")
        if eng.cache.free_pages != eng.cache.num_pages - 1:
            raise AssertionError(f"bf16 tier {name}: pages leaked")
    _only_bf16("phase 10(b)", by_dtype, paged)
    if not np.array_equal(res.tier_idx, pool_run["tier_idx"]):
        raise AssertionError("the bf16 pool routes differently from phase 4")
    if not (res.lengths >= 1).all() or res.responses.max() >= \
            pool_run["cfgs"]["full"].vocab_size or res.responses.min() < 0:
        raise AssertionError("bf16 responses out of range")
    n_tok = int(res.lengths.sum())
    n4 = int(pool_run["lengths"].sum())
    same = sum(np.array_equal(a[:n], b[:n]) for a, b, n, m in zip(
        res.responses, pool_run["responses"], res.lengths,
        pool_run["lengths"]) if n == m)
    log(f"[bf16 pool] {N_PROMPTS} requests on phase 4's tiers, launches by "
        f"dtype {by_dtype}; {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s (phase 4, fp32: {n4} tokens in "
        f"{pool_run['wall']:.3f} s = {n4 / pool_run['wall']:.1f} tokens/s); "
        f"{same} of {N_PROMPTS} streams emit phase 4's fp32 tokens; peak "
        f"memory {peak / 1e9:.3f} GB on {card} ({smi})")
    return by_dtype


def _greedy_margins(eng):
    """Record on ``eng`` each request's first-token logits
    (``_first_logits``) and the top-2 margin of the logits behind each
    token it emits. Returns ({rid: first logits}, {rid: [margins]}),
    filled as the engine runs (one host read a token: the CPU's)."""
    firsts = _first_logits(eng)
    margins = collections.defaultdict(list)
    last = [None]
    bundle = eng.bundle

    def decode(*args, **kw):
        last[0] = bundle.decode_step_paged(*args, **kw)
        return last[0]

    eng.bundle = dataclasses.replace(bundle, decode_step_paged=decode)
    push = eng._push_token

    def push_token(req, token):
        first, slot = not req.out, req.slot
        out = push(req, token)        # sets firsts[req.rid] on the first
        row = firsts[req.rid] if first else last[0][slot]
        top2 = row.float().topk(2).values
        margins[req.rid].append(float(top2[0] - top2[1]))
        return out

    eng._push_token = push_token
    return firsts, margins


def bf16_vs_cpu(torch, card: str, smi: str, pool_run: dict, bf16: dict):
    """Phase 10(b), the card against the CPU on the BF16_CPU_PROMPTS
    shortest of phase 4's prompts through the "full" tier at bf16
    (``_engine_vs_cpu``)."""
    import numpy as np
    lens = pool_run["lens"]
    idx = [int(i) for i in np.argsort(lens, kind="stable")
           [:BF16_CPU_PROMPTS]]
    _engine_vs_cpu(torch, card, smi, "bf16 vs cpu", bf16["models"]["full"],
                   bf16["cfgs"]["full"], pool_run["tokens"], lens, idx)


def _engine_vs_cpu(torch, card: str, smi: str, tag: str, gpu, cfg16,
                   tokens, lens, idx):
    """A bf16 model on the card against the CPU, each device's model
    through a pool engine of phase 4's geometry, on the prompts ``idx`` of
    ``tokens`` (their ``lens``). The tolerance comes from the dtype
    (``_dtype_tol``: twice the largest gap between the CPU's bf16 and fp32
    first-token logits). The card's bf16 first-token logits must lie
    within it of the CPU's bf16, and the card's greedy tokens must equal
    the CPU's bf16 greedy tokens up to the first position where the CPU's
    top-2 margin is under it."""
    import numpy as np
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine

    prompts = [tokens[i, :lens[i]].astype(np.int32) for i in idx]

    def run(model, cfg, new_tokens):
        eng = ContinuousEngine(build_model(cfg), model,
                               max_new_tokens=new_tokens, n_slots=N_SLOTS,
                               max_seq=MAX_SEQ)
        firsts, margins = _greedy_margins(eng)
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        return ([firsts[r.rid].float().cpu() for r in reqs],
                [list(r.out) for r in reqs], [margins[r.rid] for r in reqs])

    t0 = time.monotonic()
    with torch.no_grad():
        card_first, card_tok, _ = run(gpu, cfg16, NEW_TOKENS)
        cpus, cfgs = _cpu_twins(torch, gpu, cfg16, True)
        first16, tok16, marg16 = run(cpus["cpu"], cfg16, NEW_TOKENS)
        first32, _, _ = run(cpus["cpu32"], cfgs["cpu32"], 1)
        del cpus
    V = cfg16.vocab_size
    gap, tol = _dtype_tol(first16, first32, V)
    err = max((a[:V] - b[:V]).abs().max().item()
              for a, b in zip(card_first, first16))
    err32 = max((a[:V] - b[:V]).abs().max().item()
                for a, b in zip(card_first, first32))
    log(f"[{tag}] {cfg16.name}: {len(idx)} prompts of "
        f"{[len(p) for p in prompts]} tokens: the dtype's gap (CPU bf16 "
        f"against CPU fp32 first-token logits) {gap:.4g}, tolerance "
        f"{tol:.4g}; card bf16 against CPU bf16 {err:.4g}, against CPU "
        f"fp32 {err32:.4g}")
    if not err <= tol:
        raise AssertionError(f"{tag}: bf16 card vs CPU first-token logits "
                             f"{err} > {tol}, twice the dtype's gap")
    for i, got, want, margins in zip(idx, card_tok, tok16, marg16):
        sure = next((j for j, m in enumerate(margins) if m < tol),
                    len(margins))
        agree = next((j for j, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
        log(f"[{tag}] prompt {i}: card and CPU agree on the first "
            f"{agree} of {len(want)} greedy tokens; the CPU's top-2 margin "
            f"first falls under {tol:.4g} at position "
            f"{sure if sure < len(margins) else 'none'}")
        if agree < min(sure, len(want)):
            raise AssertionError(f"{tag}: prompt {i}: card and CPU bf16 "
                                 f"greedy tokens differ at {agree}, before "
                                 f"the first near-tie ({sure})")
    log(f"[{tag}] {time.monotonic() - t0:.1f} s (most of it the CPU's bf16 "
        f"serve) on {card} ({smi})")


def bf16_steps_phase(torch, card: str, smi: str, runs=None, tag="bf16 steps"):
    """Phase 10(d): phase 9(b)'s qwen1.5-32b decode and prefill steps at
    ``dryrun_config``'s bf16 (depth STEP_DEPTH) on the card, each predicted
    first by the bf16 fake run on one device: predicted against measured
    peak, K5 / K4 once a layer a run, their bf16 instances only, finite
    logits, and the decode logits against the CPU's bf16 within the
    dtype's tolerance there (``_dtype_tol``: the CPU's bf16 against its
    fp32 on the same weights). ``runs``: other entries of ``_step_runs``
    (phase 11(d): mamba2-130m's prefill, K3, its first row's logits held
    to the CPU's the same way). Returns {kernel: {dtype: launches}}."""
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.inputs import dryrun_config
    from repro_torch.models.model import build_model

    dev = torch.device("cuda")
    counters = _all_counters()
    t_phase = time.monotonic()
    model_of = {}   # config name -> (its bf16 model on the card, base)
    launched = {}
    for name, cfg, shape, kernel, per_run in (runs or _step_runs()[:2]):
        rcfg = dryrun_config(cfg, shape)
        bundle = build_model(rcfg)
        t0 = time.monotonic()
        pred = trace_step(rcfg, shape)
        log(f"[{tag}] {name}: bf16 fake run on one device "
            f"{time.monotonic() - t0:.2f} s: predicted peak "
            f"{pred['memory']['peak_gb']:.3f} GB")
        if cfg.name not in model_of:
            model_of.clear()
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            model_of[cfg.name] = (bundle.init(
                torch.Generator(device=dev).manual_seed(900), dev), base)
        model, base = model_of[cfg.name]
        gen = torch.Generator(device=dev).manual_seed(901)
        args = _step_args(torch, bundle, model, shape, dev, gen)
        cpu_args = None
        if shape.kind == "decode" or rcfg.family == "ssm":
            cpu16 = type(model)(rcfg, device="cpu")
            cpu16.load_state_dict(model.state_dict())
            cpu_args = _to_cpu(torch, args, cpu16)
            if shape.kind == "prefill":    # the CPU's prefill on one row
                cpu_args = (cpu16, {"tokens": cpu_args[1]["tokens"][:1]})
        fn = (steps.build_decode_step(bundle, False) if shape.kind == "decode"
              else steps.build_prefill_step(bundle, shape.seq_len))
        _reset_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if shape.kind == "decode":
            args[1]["pos"] = shape.seq_len - 1
        t0 = time.monotonic()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        by_dtype = _by_dtype(counters)
        want = {kernel: {"bfloat16": 2 * per_run}}
        logits = out[0]
        log(f"[{tag}] {name} on {card} ({smi}): measured peak "
            f"{peak / 1e9:.3f} GB against {pred['memory']['peak_gb']:.3f} "
            f"GB predicted (bf16 fake run); wall {wall * 1e3:.3f} ms a "
            f"step; launches by dtype {by_dtype} (expected {want}); logits "
            f"{tuple(logits.shape)} {logits.dtype}")
        if by_dtype != want:
            raise AssertionError(f"{tag} {name}: launches {by_dtype} != "
                                 f"{want}")
        if logits.dtype != torch.bfloat16 or \
                not torch.isfinite(logits.float()).all():
            raise AssertionError(f"{tag} {name}: logits not finite bf16")
        for k, d in by_dtype.items():
            launched.setdefault(k, {})["bfloat16"] = \
                launched.get(k, {}).get("bfloat16", 0) + d["bfloat16"]
        if cpu_args is not None:
            cfg32 = dataclasses.replace(rcfg, dtype="float32")
            with torch.no_grad():
                cpu32 = type(model)(cfg32, device="cpu")
                cpu32.load_state_dict(cpu16.state_dict())  # widened
                a32 = (cpu32,) + tuple(
                    {k: v.float() if torch.is_tensor(v)
                     and v.is_floating_point() else v
                     for k, v in a.items()} if isinstance(a, dict) else a
                    for a in cpu_args[1:])
                c16 = fn(*cpu_args)[0].float()
                fn32 = (steps.build_decode_step(build_model(cfg32), False)
                        if shape.kind == "decode" else
                        steps.build_prefill_step(build_model(cfg32),
                                                 shape.seq_len))
                c32 = fn32(*a32)[0]
            gap, tol = _dtype_tol([c16], [c32], rcfg.vocab_size)
            err = (logits[:len(c16)].float().cpu() - c16)[
                :, :rcfg.vocab_size].abs().max().item()
            log(f"[{tag}] {name}: card against CPU bf16 logits {err:.4g}"
                f"; the dtype's gap (CPU bf16 against fp32) {gap:.4g}, "
                f"tolerance {tol:.4g}")
            if not err <= tol:
                raise AssertionError(f"{tag} {name}: card vs CPU {err} > "
                                     f"{tol}")
            del cpu16, cpu32, cpu_args, a32
        del args, out, logits
    del model_of, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] {time.monotonic() - t_phase:.1f} s")
    return launched


def bf16_phase(torch, card: str, smi: str, pool_run: dict):
    """Phase 10 (after phase 9's card work, while its dry runs finish on
    the host; on phase 4's models, router and prompts): the tiers' bf16
    twins (``bridge.twin``: each weight in its parameter's dtype at the
    bf16 config, as the bridge loads it there), then (a) is phase 3's bf16
    cases, (b) the routed pool (``bf16_pool_phase``) and the card against
    the CPU (``bf16_vs_cpu``), (c) phase 4b's dense hybrid path at bf16
    (K4 once a layer a prefill, K5 once a layer a decode step, their bf16
    instances only) and (d) the dry run's decode and prefill steps at bf16
    (``bf16_steps_phase``). Returns {kernel: {dtype: launches}} over (b)
    and (c)."""
    from repro_torch import bridge
    t0 = time.monotonic()
    cfgs = {n: dataclasses.replace(c, dtype="bfloat16")
            for n, c in pool_run["cfgs"].items()}
    # each fp32 tier gives way to its twin: nothing after phase 10 uses
    # phase 4's models at fp32
    models = pool_run["models"]
    bf16 = dict(cfgs=cfgs, models={n: bridge.twin(models.pop(n), cfgs[n])
                                   for n in list(models)})
    gc.collect()
    torch.cuda.empty_cache()
    launches = bf16_pool_phase(torch, card, smi, pool_run, bf16)
    bf16_vs_cpu(torch, card, smi, pool_run, bf16)
    counters = _all_counters()
    _reset_counts(counters)
    dense = dense_hybrid_phase(torch, card, smi, dict(pool_run, **bf16),
                               tag="bf16 dense")
    # its warm-up serve and its counted serve: the bf16 instances only
    _only_bf16("phase 10(c)", _by_dtype(counters), dense)
    launches.update({k: {"bfloat16": n} for k, n in dense.items()})
    del bf16
    bf16_steps_phase(torch, card, smi)
    log(f"[bf16] phase 10 {time.monotonic() - t0:.3f} s on {card} ({smi})")
    return launches


# ----------------------------------------------------------------- phase 11
# the kernels line's keys of phase 11's paths, launches by dtype
BF16_PATHS = ("mamba2-130m-bf16", "jamba-v0.1-52b-bf16",
              "whisper-large-v3-bf16", "internvl2-26b-bf16")


def _frontend_bf16(run32, run16, tag, card, smi):
    """Phase 11(c)'s serve beside phase 4h's: prefill ms, tokens/s and
    the peak memory at bf16 and fp32."""
    log(f"[{tag}] prefill alone {run16['prefill_ms']:.3f} ms, "
        f"{run16['tokens_s']:.1f} tokens/s, peak {run16['peak_gb']:.2f} GB "
        f"at bf16; phase 4h at fp32: {run32['prefill_ms']:.3f} ms, "
        f"{run32['tokens_s']:.1f} tokens/s, peak {run32['peak_gb']:.2f} GB; "
        f"on {card} ({smi})")


def _add_by_dtype(*counts):
    """{kernel: {dtype: launches}} summed over ``counts``."""
    out = {}
    for c in counts:
        for k, d in c.items():
            for dt, n in d.items():
                out.setdefault(k, {})[dt] = out.get(k, {}).get(dt, 0) + n
    return out


def ssm_bf16_phase(torch, card: str, smi: str, ssm_run: dict):
    """Phase 11(a) (after phase 10, while phase 9's dry runs finish on the
    host): phase 4c's two mamba2-130m tiers as their bf16 twins
    (``bridge.twin``: ``A_log``, ``D`` and ``dt_bias`` stay fp32), behind
    4c's router and on its prompts, through the pool and the dense hybrid
    path (``_ssm_serve``: K3 exactly layers x prefill dispatches on the
    pool and layers a prefill on the dense path, nothing else, no page or
    state row leaked), each routing as 4c's pool did and launching only
    K3's bf16 instance; tokens/s beside 4c's. Then the card against the
    CPU at depth 1 (the full tier's first layer) through pool engines, as
    phase 10's ``bf16_vs_cpu``. Returns {kernel: {dtype: launches}} over
    both paths."""
    import numpy as np
    from repro_torch import bridge
    from repro_torch.models import decoder
    t0 = time.monotonic()
    cfgs = {n: dataclasses.replace(c, dtype="bfloat16")
            for n, c in ssm_run["cfgs"].items()}
    run = dict(ssm_run, cfgs=cfgs, models={
        n: bridge.twin(m, cfgs[n]) for n, m in ssm_run["models"].items()})
    out = _ssm_serve(torch, card, smi, "ssm bf16", run,
                     tier_idx=ssm_run["tier_idx"])
    by_dtype = _add_by_dtype(out["pool_by_dtype"], out["dense_by_dtype"])
    _only_bf16("phase 11(a)", by_dtype, ["ssd_chunk_scan"])
    if set(by_dtype) != {"ssd_chunk_scan"}:
        raise AssertionError(f"phase 11(a): launches {by_dtype}")
    for path in ("pool", "dense"):
        (n16, w16), (n32, w32) = out[path], ssm_run[path]
        log(f"[ssm bf16] {path}: {n16 / w16:.1f} tokens/s at bf16 against "
            f"phase 4c's {n32 / w32:.1f} at fp32 on {card} ({smi})")
    full = run["models"]["full"]
    cfg1 = dataclasses.replace(cfgs["full"], n_layers=1)
    gpu = decoder.Decoder(cfg1, device="meta")
    for name in ("embed", "ln_f", "head"):
        if hasattr(full, name):
            setattr(gpu, name, getattr(full, name))
    gpu.layers = torch.nn.ModuleList(full.layers[:1])
    lens = ssm_run["lens"]
    idx = [int(i) for i in np.argsort(lens, kind="stable")
           [:BF16_CPU_PROMPTS]]
    _engine_vs_cpu(torch, card, smi, "ssm bf16 vs cpu", gpu, cfg1,
                   ssm_run["tokens"], lens, idx)
    del run, gpu, full
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ssm bf16] phase 11(a) {time.monotonic() - t0:.3f} s on {card} "
        f"({smi})")
    return by_dtype


def jamba_bf16_phase(torch, card: str, smi: str, jamba_run: dict):
    """Phase 11(b) (after phase 4g and its phase-5 check, on the memory
    they held): phase 4g's two jamba-v0.1-52b tiers at bf16, drawn from
    4g's seeds in fp32 and stored in each parameter's dtype
    (``bridge.init_twin``: 4g's weights rounded, without an fp32 build,
    which would not fit beside the other tier), behind 4g's router on its
    prompts, through the pool and the dense hybrid path
    (``_jamba_serve``: exact launches by kernel, no page or state row
    leaked, the MoE drops logged), routing as 4g's pool did and launching
    only the bf16 instances; tokens/s beside 4g's and the peak memory.
    Then the "half" tier against the CPU as phase 5 checks it
    (``card_vs_cpu``), within twice the dtype's gap. Returns {kernel:
    {dtype: launches}} over both paths."""
    from repro_torch import bridge
    dev = torch.device("cuda")
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    cfgs = {n: dataclasses.replace(c, dtype="bfloat16")
            for n, c in jamba_run["cfgs"].items()}
    models = {n: bridge.init_twin(cfgs[n], torch.Generator(device=dev)
                                  .manual_seed(400 + i), dev)
              for i, n in enumerate(cfgs)}
    torch.cuda.synchronize()
    log(f"[jamba bf16] the tiers at bf16 from phase 4g's seeds: "
        f"{time.monotonic() - t0:.1f} s, {_peak(torch)} allocated")
    run = dict(jamba_run, cfgs=cfgs, models=models)
    out = _jamba_serve(torch, card, smi, "jamba bf16", run,
                       tier_idx=jamba_run["tier_idx"])
    by_dtype = _add_by_dtype(out["pool_by_dtype"], out["dense_by_dtype"])
    _only_bf16("phase 11(b)", by_dtype, list(by_dtype))
    for path in ("pool", "dense"):
        (n16, w16), (n32, w32) = out[path], jamba_run[path]
        log(f"[jamba bf16] {path}: {n16 / w16:.1f} tokens/s at bf16 "
            f"against phase 4g's {n32 / w32:.1f} at fp32 on {card} ({smi})")
    log(f"[jamba bf16] peak memory in phase 11(b): {_peak(torch)}")
    del models["full"], run
    gc.collect()
    torch.cuda.empty_cache()
    card_vs_cpu(torch, models["half"], cfgs["half"], "(one block, bf16)",
                lens=(40, 27), dtype_gap=True)
    log(f"[jamba bf16] phase 11(b) {time.monotonic() - t0:.3f} s on {card} "
        f"({smi})")
    return by_dtype


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
    shared_launches = prefix_spec_phase(torch, card, smi, pool_run)
    ssm_run = ssm_phase(torch, card, smi, pool_run["router"])
    launches["ssd_chunk_scan"] = ssm_run["launches"]
    # "launches": the first main path that runs the kernel (qwen1.5-32b's
    # pool and dense path, mamba2-130m's for K3); "launches_by_path": each
    # path's own count, zeroed just before that path ran
    by_path = {n: {"mamba2-130m" if n == "ssd_chunk_scan"
                   else "qwen1.5-32b": k} for n, k in launches.items()}
    for name, n in fault_launches.items():
        by_path[name]["qwen1.5-32b-faults"] = n
    for name, paths in shared_launches.items():
        by_path[name].update(paths)
    device_vs_cpu_phase(torch, pool_run["models"]["full"],
                        pool_run["cfgs"]["full"])
    device_vs_cpu_phase(torch, ssm_run["model"], ssm_run["cfg"])
    analysis_phase(torch, card, smi, pool_run, ssm_run)
    # phases 10 and 11(a), (d) run while phase 9's dry runs work on the
    # host, after 9(b) and (c), on the bf16 twins of phases 4 and 4c's
    # models; phase 10 drops phase 4's fp32 models for theirs
    bf16_launches, bf16_paths = {}, {}

    def phase10():
        bf16_launches.update(bf16_phase(torch, card, smi, pool_run))
        bf16_paths["mamba2-130m-bf16"] = ssm_bf16_phase(torch, card, smi,
                                                        ssm_run)
        bf16_steps_phase(torch, card, smi, runs=_step_runs()[3:],
                         tag="ssm bf16 step")
    for path, counts in dryrun_phase(torch, card, smi, pool_run,
                                     meanwhile=phase10).items():
        for name, n in counts.items():
            by_path[name][path] = n
    # phase 4d holds 3.88 B + 0.76 B params, their pools and a router over
    # 2048 positions: it runs on the memory phases 4-4c held
    del pool_run, ssm_run
    gc.collect()     # the engines' wrapped methods hold them in cycles
    torch.cuda.empty_cache()
    gemma_run = gemma_phase(torch, card, smi)
    for name, n in gemma_run["launches"].items():
        by_path[name]["gemma3-4b"] = n
    # one local:global period of gemma3-4b (layers 0-4 local, 5 global),
    # past the window: late walk starts on the card and on the CPU
    device_vs_cpu_phase(torch, gemma_run["model"], gemma_run["cfg"],
                        depth=6, lens=(1096, 1085))
    del gemma_run   # phase 4g needs the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    # phase 4g holds 13.27 B + 3.45 B params (68.4 GB with the router)
    jamba_run = jamba_phase(torch, card, smi)
    for name, n in jamba_run["launches"].items():
        by_path[name]["jamba-v0.1-52b"] = n
    card_vs_cpu(torch, jamba_run["model"], jamba_run["cfg"], "(one block)",
                lens=(40, 27))
    del jamba_run["models"], jamba_run["model"]  # phase 11(b) needs the
    gc.collect()                                 # card's memory
    torch.cuda.empty_cache()
    bf16_paths["jamba-v0.1-52b-bf16"] = jamba_bf16_phase(torch, card, smi,
                                                         jamba_run)
    del jamba_run   # phase 4h needs the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    # phase 4h: whisper-large-v3 (8.1 GB of weights, 7.9 GB of cross K/V),
    # then internvl2-26b at 8 layers (17.0 GB), each checked against the
    # CPU before its memory is freed
    whisper_run = whisper_phase(torch, card, smi)
    for name, n in whisper_run["launches"].items():
        by_path[name]["whisper-large-v3"] = n
    whisper_vs_cpu(torch, whisper_run["model"], whisper_run["cfg"])
    # phase 11(c): the bf16 twin of each phase-4h model in its place
    whisper16 = whisper_phase(torch, card, smi, fp32=whisper_run)
    _frontend_bf16(whisper_run, whisper16, "whisper bf16", card, smi)
    bf16_paths["whisper-large-v3-bf16"] = whisper16["by_dtype"]
    whisper_vs_cpu(torch, whisper16["model"], whisper16["cfg"])
    del whisper_run, whisper16
    gc.collect()
    torch.cuda.empty_cache()
    vlm_run = internvl2_phase(torch, card, smi)
    for name, n in vlm_run["launches"].items():
        by_path[name]["internvl2-26b"] = n
    internvl2_vs_cpu(torch, vlm_run["model"], vlm_run["cfg"])
    vlm16 = internvl2_phase(torch, card, smi, fp32=vlm_run)
    _frontend_bf16(vlm_run, vlm16, "internvl2 bf16", card, smi)
    bf16_paths["internvl2-26b-bf16"] = vlm16["by_dtype"]
    internvl2_vs_cpu(torch, vlm16["model"], vlm16["cfg"])
    del vlm_run, vlm16     # phase 6 needs the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    moe_vs_cpu_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    router_training_phase(torch, card, smi)
    lm_training_phase(torch, card, smi)
    pipeline_phase(torch, card, smi)
    gc.collect()
    torch.cuda.empty_cache()
    for path, counts in launcher_phase(torch, card, smi).items():
        for name, n in counts.items():
            by_path[name][path] = n
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = by_path[row["name"]]
        row["qwen1.5-32b-bf16"] = bf16_launches.get(row["name"], {})
        for path, counts in bf16_paths.items():
            row[path] = counts.get(row["name"], {})
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "bf16", "qwen1.5-32b-bf16",
            *BF16_PATHS)
    log(smi)
    log(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
