"""Serving launcher (the port of ``repro.launch.serve``): K-tier model-pool
serving on an assigned architecture family, at its reduced configs, on the
card unless ``--device cpu``.

``--tiers`` names the pool, cheapest -> priciest, K >= 2 entries. Each name
is either a sibling scale of ``--arch`` (``eighth`` / ``quarter`` / ``half``
/ ``full``: the reduced config with layers and width divided by that
factor) or any architecture id of ``ARCH_IDS`` (that architecture's reduced
config), so a pool can mix scales of one family or whole families. The
default ``half full`` is the two-tier halved-layer sibling pair.

Every tier LM trains briefly on the synthetic suite (cheaper tiers fewer
steps), the r_trans router trains on the (cheapest, priciest) quality gap,
and ONE ``calibration_frontier`` sweep at the requested drop budget yields
the routing policy: the paper-exact threshold for K=2, a ``CascadePolicy``
bucketing queries across the K tiers otherwise. The request stream then
reports per-tier traffic plus the calls- and token-weighted cost advantage
against the all-priciest baseline.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-32b \\
      --tiers quarter half full --continuous
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
      --tiers mamba2-130m qwen1.5-32b full --continuous --device cpu

``--continuous`` serves the stream through the continuous-batching paged
engines (``serving.pool.ContinuousPoolEngine``) instead of the dense-batch
pair. Dense, sliding-window (gemma3-4b), MoE, SSM (mamba2-130m) and hybrid
(jamba-v0.1-52b) stacks all serve continuously. K > 2 tiers require
``--continuous``.

The encoder-decoder (whisper-large-v3) and vision-frontend (internvl2-26b)
families are refused before training: the launcher trains and serves on
tokens alone, and those models need their frontend inputs beside the
tokens. The JAX launcher accepts them and fails inside its first training
step; both serve through ``serving.generate.build_generate_fn``.

``--prefix-cache N`` gives each continuous tier an N-page shared-prefix
tree (``serving.prefix``); tiers that cannot share (window/SSM, one-shot
prefill) recompute and the report prints why. ``--spec-gamma G`` turns on
the pool's cross-tier speculative step plane. ``--escalate FRAC`` turns on
mid-stream quality escalation: an observe-only pass records each stream's
peak decode uncertainty, per-tier abort thresholds are set so at most FRAC
of streams escalate, and a crossing stream resumes one tier up as one
chunked prefill.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.experiment import make_labels
from repro_torch.core.quality import edit_similarity
from repro_torch.core.router import (RouterTrainConfig, score_dataset,
                                     train_router)
from repro_torch.core.routing import (CascadePolicy, CostMeter,
                                      HybridRouter, ThresholdPolicy,
                                      TierMeter)
from repro_torch.core.thresholds import (best_feasible,
                                         calibrate_abort_threshold,
                                         calibration_frontier,
                                         cascade_thresholds)
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import generate_dataset, lm_training_arrays
from repro_torch.models.encoder import RouterConfig
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EscalationMonitor, make_engine
from repro_torch.serving.generate import check_token_only, sample_responses
from repro_torch.serving.hybrid import HybridEngine
from repro_torch.serving.pool import ContinuousPoolEngine
from repro_torch.training.trainer import TrainConfig, train_lm

# sibling scales: divide layers/width of --arch's reduced config. "half" is
# the original small sibling; "full" the unscaled config.
SIBLING_SCALES = {"eighth": 8, "quarter": 4, "half": 2, "full": 1}
_SCALE_SUFFIX = {8: "-e", 4: "-q", 2: "-s", 1: ""}


def scaled_sibling(full, factor: int):
    """A capacity-scaled sibling of ``full`` (factor 1 = the config itself),
    shrinking layers, width, heads, and FFN together. Hybrid stacks keep
    ``n_layers`` a multiple of ``attn_every`` (their block period) so a
    scaled sibling still has at least one complete block."""
    if factor == 1:
        return full
    n_layers = max(1, full.n_layers // factor)
    if full.family == "hybrid" and full.attn_every:
        n_layers = max(full.attn_every,
                       n_layers - n_layers % full.attn_every)
    return dataclasses.replace(
        full, n_layers=n_layers,
        d_model=max(8, full.d_model // factor),
        n_heads=max(1, full.n_heads // factor),
        n_kv_heads=max(1, min(full.n_kv_heads, full.n_heads // factor))
        if full.n_kv_heads else 0,
        d_ff=max(8, full.d_ff // factor) if full.d_ff else 0,
        name=full.name + _SCALE_SUFFIX[factor])


def _reduced(arch: str):
    return dataclasses.replace(get_config(arch).reduced(),
                               vocab_size=tok.VOCAB_SIZE,
                               vocab_pad_multiple=16)


def resolve_tiers(arch: str, tier_names):
    """Tier configs for ``--tiers``, cheapest -> priciest: sibling-scale
    names resolve against ``--arch``, architecture ids stand alone."""
    full = _reduced(arch)
    cfgs = []
    for name in tier_names:
        if name in SIBLING_SCALES:
            cfgs.append(scaled_sibling(full, SIBLING_SCALES[name]))
        elif name in ARCH_IDS:
            cfgs.append(_reduced(name))
        else:
            raise SystemExit(
                f"--tiers entry {name!r} is neither a sibling scale "
                f"{tuple(SIBLING_SCALES)} nor an architecture id")
    seen = set()
    for cfg in cfgs:
        if cfg.name in seen:
            raise SystemExit(f"--tiers resolves to duplicate config "
                             f"{cfg.name!r}; each tier needs its own model")
        seen.add(cfg.name)
    # an inverted pool would send easy queries to the big model and report
    # a confidently wrong cost advantage
    counts = [c.param_count() for c in cfgs]
    if any(a > b for a, b in zip(counts, counts[1:])):
        raise SystemExit(
            "--tiers must be ordered cheapest -> priciest; resolved "
            "param counts are "
            + ", ".join(f"{c.name}={n:,}" for c, n in zip(cfgs, counts)))
    return cfgs


def reduced_pair(arch: str):
    """The two-tier (halved sibling, full) pair: the default ``--tiers
    half full`` resolution."""
    return tuple(resolve_tiers(arch, ("half", "full")))


def require_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device on a machine without one is
    refused, never replaced by the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return dev


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-4b")
    ap.add_argument("--tiers", nargs="+", default=["half", "full"],
                    metavar="TIER",
                    help="K >= 2 tier configs, cheapest -> priciest: sibling "
                         f"scales {tuple(SIBLING_SCALES)} of --arch and/or "
                         "architecture ids (default: half full)")
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--drop-budget", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--continuous", action="store_true",
                    help="serve via continuous-batching paged-KV engines")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill width for --continuous (tokens "
                         "admitted per chunk; 0 = one-shot prefill; "
                         "default: the architecture's prefill_chunk knob)")
    ap.add_argument("--prefill-pack", type=int, default=None,
                    help="max PREFILLING slots stacked into one prefill "
                         "kernel launch for --continuous (0 = per-slot "
                         "dispatch; default: n_slots)")
    ap.add_argument("--walk-bound", choices=("live", "static"),
                    default="live",
                    help="bound the paged kernels' page walk by the "
                         "bucketed live max context (live, default) or "
                         "walk the full static page-table width (static)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="bound each continuous tier's pending queue; "
                         "overflow load-sheds with finish reason 'rejected' "
                         "(default: unbounded)")
    ap.add_argument("--spec-gamma", type=int, default=0,
                    help="cross-tier speculative decoding for --continuous: "
                         "each tier t >= 1 drafts this many tokens per round "
                         "on tier t-1 and verifies the chunk in one launch "
                         "(greedy-exact; 0 = off, the default). Tiers the "
                         "capability check refuses serve plainly.")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="shared-prefix KV reuse for --continuous: per-tier "
                         "page budget for the copy-on-write prefix tree "
                         "(0 = off, the default; greedy-exact either way). "
                         "Window/SSM tiers fall back to recompute with a "
                         "recorded reason.")
    ap.add_argument("--escalate", type=float, default=None, metavar="FRAC",
                    help="mid-stream quality escalation for --continuous: "
                         "an observe-only pass calibrates per-tier abort "
                         "thresholds so at most this fraction of streams "
                         "escalate; a crossed stream is cancelled and "
                         "resumes one tier up as ONE chunked prefill of "
                         "(prompt + emitted prefix), greedy-exact")
    ap.add_argument("--device", default="cuda",
                    help="where the models train and serve (default: the "
                         "card)")
    return ap


def check_flags(args) -> list:
    """Every refusal that needs no training, in the JAX launcher's order
    and words. Returns the resolved tier configs."""
    if args.spec_gamma and not args.continuous:
        raise SystemExit("--spec-gamma rides the continuous pool's step "
                         "plane; pass --continuous")
    if args.prefix_cache and not args.continuous:
        raise SystemExit("--prefix-cache shares pages of the continuous "
                         "paged KV pool; pass --continuous")
    if args.escalate is not None and not args.continuous:
        raise SystemExit("--escalate cancels and re-admits continuous "
                         "streams via preemption mechanics; pass "
                         "--continuous")
    if args.escalate is not None and not 0.0 <= args.escalate <= 1.0:
        raise SystemExit("--escalate is an escalation-fraction budget "
                         "in [0, 1]")
    cfgs = resolve_tiers(args.arch, args.tiers)
    K = len(cfgs)
    if K < 2:
        raise SystemExit("--tiers needs at least two tiers")
    if K > 2 and not args.continuous:
        raise SystemExit("K > 2 tiers serve through the continuous pool "
                         "engine; pass --continuous")
    if K > 2:
        no_paged = [c.name for c in cfgs if not c.supports_paged_kv]
        if no_paged:
            raise SystemExit(f"{', '.join(no_paged)}: no paged-KV path, and "
                             "K > 2 tiers have no dense fallback")
    # departure from the JAX launcher, which fails in its first training
    # step here (train_lm feeds tokens only): refuse before training
    for cfg in cfgs:
        try:
            check_token_only(build_model(cfg))
        except ValueError as e:
            raise SystemExit(f"{e}; this launcher trains and serves on "
                             "tokens alone") from None
    return cfgs


def train_tiers(cfgs, steps: int, arrays: dict, device) -> list:
    """Each tier's LM trained on ``arrays``, cheaper tiers for fewer steps.
    Returns the trained modules, cheapest first."""
    print(f"== training {', '.join(c.name for c in cfgs)} ==")
    models = []
    for i, cfg in enumerate(cfgs):
        # cheaper tiers train less: capacity AND compute gaps, like the
        # paper's FLAN-t5(800m) vs Llama-2(13b)
        n = max(1, steps * (i + 1) // len(cfgs))
        model, hist = train_lm(build_model(cfg), arrays,
                               TrainConfig(steps=n, batch_size=32, lr=2e-3),
                               device=device)
        models.append(model)
        print(f"  {cfg.name}: loss {hist[-1]['loss']:.3f}")
    return models


def label_and_route(cfgs, models, n_samples: int, drop_budget: float, rng,
                    device):
    """Label a calibration set by the tiers' sampled responses, train the
    r_trans router on the (cheapest, priciest) gap and calibrate it.
    Returns (router module, router config, threshold, cascade thresholds
    or None for K = 2)."""
    print("== labelling + router training ==")
    cal_ds = generate_dataset(rng, 300)
    qualities = []
    for cfg, model in zip(cfgs, models):
        resp, lens = sample_responses(build_model(cfg), model, cal_ds.query,
                                      n_samples, 12, 0.8)
        q = np.zeros(resp.shape[:2], np.float32)
        for s in range(resp.shape[1]):
            q[:, s] = edit_similarity(resp[:, s], lens[:, s], cal_ds.ref,
                                      cal_ds.ref_len)
        qualities.append(q)
    # middle tiers share the (cheapest, priciest) easiness score and are
    # gated by cascade thresholds
    y, t_star = make_labels("trans", qualities[0], qualities[-1])
    rcfg = RouterConfig(vocab_size=tok.VOCAB_SIZE, n_layers=2, d_model=64,
                        n_heads=4, d_ff=256)
    rparams, _ = train_router(rcfg, cal_ds.query, cal_ds.query_mask, y,
                              RouterTrainConfig(epochs=3), device=device)
    scores = score_dataset(rparams, rcfg, cal_ds.query, cal_ds.query_mask)
    frontier = calibration_frontier(scores, qualities[0], qualities[-1])
    cal = best_feasible(frontier, drop_budget)
    print(f"  t*={t_star:.3f} threshold={cal.threshold:.3f} "
          f"(expect {cal.expected_cost_advantage:.0%} cost adv)")
    thresholds = None
    if len(cfgs) > 2:
        thresholds = cascade_thresholds(frontier, len(cfgs), drop_budget)
        print(f"  cascade thresholds: "
              f"{', '.join(f'{t:.3f}' for t in thresholds)}")
    return rparams, rcfg, cal.threshold, thresholds


def serve_tiers(cfgs, models, rparams, rcfg, threshold: float, thresholds,
                args, rng):
    """The serving half: one engine per tier (paged with ``--continuous``,
    else dense), the routing policy, the optional escalation calibration,
    the request stream in batches of 64 and the report. ``models``: the
    tier modules, cheapest first; ``thresholds``: the cascade's for K > 2.
    Returns the engine that served (a ``ContinuousPoolEngine`` or a
    ``HybridEngine``)."""
    print("== serving ==")
    layout = "paged" if args.continuous else "dense"
    engines = [make_engine(build_model(dataclasses.replace(
                   cfg, cache_layout=layout)), model, max_new_tokens=12,
                   n_slots=8, max_seq=64, prefill_chunk=args.prefill_chunk,
                   prefill_pack=args.prefill_pack,
                   walk_bound=args.walk_bound, max_pending=args.max_pending,
                   prefix_cache=args.prefix_cache)
               for cfg, model in zip(cfgs, models)]
    router = HybridRouter(rparams, rcfg, threshold)
    # check_flags leaves only token-only tiers, every one with a paged
    # path: --continuous always builds the pool, and the flags that need
    # it were refused without it
    if args.continuous:
        policy = ThresholdPolicy(router) if len(cfgs) == 2 \
            else CascadePolicy(router, thresholds)
        hy = ContinuousPoolEngine(policy,
                                  [(c.name, e) for c, e in zip(cfgs, engines)],
                                  spec_gamma=args.spec_gamma)
        for t, reason in hy.plan.skipped:
            print(f"  (tier {cfgs[t].name}: serving non-speculatively — "
                  f"{reason})")
        if args.escalate is not None:
            _calibrate_escalation(hy, cfgs, args.escalate, rng)
    else:
        hy = HybridEngine(router, engines[0], engines[1])
        # name the meter's tiers after the real configs, not small/large
        hy.meter = CostMeter(TierMeter((cfgs[0].name, cfgs[1].name)))
    req = generate_dataset(rng, args.requests)
    for i in range(0, args.requests, 64):
        hy.serve(req.query[i:i + 64], req.query_mask[i:i + 64])
    report(hy, cfgs, args)
    return hy


def _calibrate_escalation(hy, cfgs, budget: float, rng) -> None:
    """Observe-only pass: every tier below the priciest watches per-stream
    peak uncertainty without cancelling anyone, then gets its own abort
    threshold at the escalation-fraction budget."""
    engines = hy.engines
    for eng in engines[:-1]:
        eng.escalation = EscalationMonitor(abort_threshold=None)
    obs = generate_dataset(rng, 64)
    obs_reqs, obs_tiers, _ = hy.submit(obs.query, obs.query_mask)
    hy.run()
    for t, eng in enumerate(engines[:-1]):
        peaks = [r.esc_peak_score
                 for r, ti in zip(obs_reqs, obs_tiers) if ti == t]
        if peaks:
            thr = calibrate_abort_threshold(peaks, budget)
            eng.escalation = EscalationMonitor(abort_threshold=thr)
            print(f"  {cfgs[t].name}: abort threshold {thr:.3f} "
                  f"({len(peaks)} calibration streams)")
        else:
            # nothing routed here during observation: no frontier to
            # calibrate on, so this tier serves unmonitored
            eng.escalation = None
            print(f"  {cfgs[t].name}: no calibration stream "
                  "routed here; escalation off")
    hy.meter.reset()   # the observation pass is not traffic


def report(hy, cfgs, args) -> None:
    """The per-tier rows, the speculation, escalation and prefix-tree
    lines, and §2.3's cost advantage against the all-priciest baseline."""
    pool = isinstance(hy, ContinuousPoolEngine)
    meter = hy.meter if pool else hy.meter.tiers
    for name, row in meter.summary().items():
        # robustness and speculative tallies only print when nonzero: the
        # uncontended non-speculative stream reads as before
        rob = "".join(f"  {row[k]} {k.replace('_', ' ')}"
                      for k in ("preemptions", "sheds", "deadline_misses",
                                "reprefill_tokens", "drafted", "accepted",
                                "rejected", "escalations", "esc_tokens")
                      if row.get(k))
        print(f"  {name:<16} {row['calls']:>5} calls  "
              f"{row['gen_tokens']:>6} tokens{rob}")
    if pool and hy.plan.gamma:
        for _, t in hy.plan.pairs:
            st = hy.engines[t].stats
            if st.spec_rounds and st.decode_tokens:
                steps_per = (st.decode_steps + st.verify_steps) \
                    / st.decode_tokens
                print(f"  {cfgs[t].name}: {st.spec_rounds} spec rounds, "
                      f"{st.acceptance_rate:.0%} acceptance, "
                      f"{steps_per:.2f} target steps/token")
    if pool and args.escalate is not None:
        n_esc = len(hy.escalation_log)
        print(f"  {n_esc} stream{'s'[:n_esc != 1]} escalated mid-decode "
              f"(budget {args.escalate:.0%}); each resumed one tier up "
              "as one chunked prefill")
    if pool and args.prefix_cache:
        # per-tier prefix-tree columns: each tier shares only with itself
        for cfg, eng in zip(cfgs, hy.engines):
            if eng.cache.prefix is None:
                print(f"  {cfg.name}: prefix sharing off — "
                      f"{eng.prefix_reason}")
                continue
            st, ts = eng.stats, eng.cache.prefix.stats
            print(f"  {cfg.name}: prefix {st.prefix_hits} hits / "
                  f"{st.prefix_misses} misses "
                  f"({ts.hit_rate:.0%} hit rate), "
                  f"{st.prefix_hit_tokens} prefill tokens skipped, "
                  f"{ts.published_pages} pages published / "
                  f"{ts.evicted_pages} evicted, "
                  f"{st.cow_splits} cow splits")
    print(f"  cost advantage: {meter.cost_advantage:.0%} of calls, "
          f"{meter.token_cost_advantage:.0%} of generated tokens "
          f"off {cfgs[-1].name}")


def main(argv=None):
    """Parse ``argv`` (None: the command line), refuse what cannot run,
    train the tiers and the router on ``--device`` and serve the stream.
    Returns the engine that served."""
    args = parser().parse_args(argv)
    cfgs = check_flags(args)
    device = require_device(args.device)
    rng = np.random.default_rng(0)
    arrays = lm_training_arrays(generate_dataset(rng, 1500))
    models = train_tiers(cfgs, args.steps, arrays, device)
    rparams, rcfg, threshold, thresholds = label_and_route(
        cfgs, models, args.samples, args.drop_budget, rng, device)
    return serve_tiers(cfgs, models, rparams, rcfg, threshold, thresholds,
                       args, rng)


if __name__ == "__main__":
    main()
