"""Three-tier pool serving with a runtime quality dial through the PyTorch
port, on the card by default — the deployment story generalized past the
paper's small/large pair.

Trains a tiny/small/large LM zoo, one BCE gate per ADJACENT tier pair
(``train_pool_router``'s per-boundary default — boundary b learns the
(tiers[b], tiers[b+1]) quality gap instead of every middle tier sharing
the (cheapest, priciest) score), and serves the same request stream
through a ``ContinuousPoolEngine`` twice over:

  1. a per-boundary ``CascadePolicy`` whose K-1 gates are each calibrated
     on their OWN calibration-frontier sweep at a drop budget (plus the
     parity check: one shared head behind every gate reproduces the
     legacy shared-score cascade exactly), and
  2. a ``QualityTargetPolicy`` swept across targets at serve time — the
     paper's "desired quality level" dial with no retraining and no
     recalibration: each query goes to the cheapest tier whose calibrated
     score->quality map clears the target.

It then turns on the pool's speculative step plane (``spec_gamma=2``: each
tier drafts on its next-cheaper sibling, the target verifies the chunk in
one launch) and re-serves the same stream — byte-identical responses at
temperature 0, with the pricier tiers running fewer launches than tokens
emitted.

Finally it walks the mid-stream escalation loop: an observe-only
``EscalationMonitor`` records each stream's peak decode uncertainty,
``calibrate_abort_threshold`` turns those peaks into an abort threshold
at an escalation-fraction budget, and the live pool cancels crossing
streams and re-admits each one tier up as ONE chunked prefill — the
token accounting splits across tiers while every CALL still lands once.

Run: PYTHONPATH=src python examples/tiered_serving_torch.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.core.experiment import (build_experiment, pool_policy,
                                         train_pool_router)
from repro_torch.core.routing import CascadePolicy
from repro_torch.core.thresholds import calibrate_abort_threshold
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ContinuousEngine, EscalationMonitor
from repro_torch.serving.pool import ContinuousPoolEngine

TIERS3 = ("tiny", "small", "large")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = ap.parse_args().device
    exp = build_experiment(seed=1, n_train_queries=300, n_test_queries=150,
                           n_samples=3, steps_scale=0.2, tiers=TIERS3,
                           device=dev)
    router_out = train_pool_router(exp, TIERS3, epochs=2, device=dev)
    ds = exp.datasets["test"]

    # one engine per tier, cheapest -> priciest, on the trained modules'
    # device; the paged layout selects the continuous-batching path
    def fresh_engines():
        engs = []
        for t in TIERS3:
            lm = exp.lms[t]
            bundle = build_model(dataclasses.replace(lm.cfg,
                                                     cache_layout="paged"))
            engs.append((t, ContinuousEngine(bundle, lm.params,
                                             max_new_tokens=12, n_slots=8,
                                             max_seq=64)))
        return engs

    engines = fresh_engines()

    def serve(policy):
        pool = ContinuousPoolEngine(policy, engines)
        pool.serve(ds.query[:64], ds.query_mask[:64])
        return pool.meter

    print("== per-boundary cascade (one frontier sweep PER GATE, "
          "2% drop budget) ==")
    cascade = pool_policy(exp, router_out, TIERS3, kind="cascade",
                          max_drop_pct=2.0)
    print("  gates: " + ", ".join(f"{g.threshold:.3f}"
                                  for g in cascade.boundaries))
    # parity: one head behind every gate + the legacy non-increasing
    # threshold vector routes *identically* to the shared-score cascade —
    # the upgrade path changes nothing until the heads differ
    g0 = cascade.boundaries[0]
    ts = sorted((g.threshold for g in cascade.boundaries), reverse=True)
    legacy = CascadePolicy(g0, tuple(ts))
    same_head = CascadePolicy(boundaries=tuple(g0.with_threshold(t)
                                               for t in ts))
    t_legacy, _ = legacy.decide(ds.query[:64], ds.query_mask[:64])
    t_same, _ = same_head.decide(ds.query[:64], ds.query_mask[:64])
    assert (t_legacy == t_same).all(), "per-boundary != shared-score parity"
    print("  per-boundary == shared-score with identical heads: True")
    meter = serve(cascade)
    for name, row in meter.summary().items():
        print(f"  {name:<6} {row['calls']:>4} calls {row['gen_tokens']:>5} tok")
    print(f"  cost advantage vs all-large: {meter.cost_advantage:.0%} calls, "
          f"{meter.token_cost_advantage:.0%} tokens")

    print("\n== quality-target dial (same pool, tuned at serve time) ==")
    qt = pool_policy(exp, router_out, TIERS3, kind="quality_target")
    q_lo = float(exp.qualities["tiny"]["val"].mean())
    q_hi = float(exp.qualities["large"]["val"].mean())
    hdr = " ".join(f"{t:>6}" for t in TIERS3)
    print(f"{'target':>8} {hdr} {'calls-adv':>10} {'tokens-adv':>11}")
    for target in np.linspace(q_lo, q_hi, 4):
        qt.set_target(float(target))
        meter = serve(qt)
        frac = " ".join(f"{c / meter.total_calls:>6.0%}"
                        for c in meter.calls)
        print(f"{target:8.3f} {frac} {meter.cost_advantage:>10.0%} "
              f"{meter.token_cost_advantage:>11.0%}")

    print("\n== speculative step plane (spec_gamma=2, same stream) ==")
    # fresh engines per pool: attach_draft installs draft state on the
    # target engines, and the baseline must stay truly non-speculative
    results = {}
    for gamma in (0, 2):
        pool = ContinuousPoolEngine(cascade, fresh_engines(),
                                    spec_gamma=gamma)
        results[gamma] = pool.serve(ds.query[:64], ds.query_mask[:64])
        if gamma:
            for _, t in pool.plan.pairs:
                st = pool.engines[t].stats
                if not st.decode_tokens:
                    continue
                steps_per = (st.decode_steps + st.verify_steps) \
                    / st.decode_tokens
                print(f"  {TIERS3[t]:<6} {st.spec_rounds:>4} rounds "
                      f"{st.acceptance_rate:>5.0%} accepted "
                      f"{steps_per:>5.2f} target steps/token")
    exact = bool(np.array_equal(results[0].responses, results[2].responses)
                 and np.array_equal(results[0].lengths, results[2].lengths))
    print(f"  greedy-exact vs non-speculative pool: {exact}")
    assert exact, "speculation changed a temperature-0 response"

    print("\n== mid-stream escalation (observe -> calibrate -> live) ==")
    # observe-only pass: monitors on the two cheaper tiers record each
    # stream's peak decode uncertainty without cancelling anyone; the
    # priciest tier has nowhere to escalate to and takes no monitor
    pool = ContinuousPoolEngine(
        cascade, fresh_engines(),
        escalation=[EscalationMonitor(min_tokens=1),
                    EscalationMonitor(min_tokens=1)])
    obs, tiers, _ = pool.submit(ds.query[:64], ds.query_mask[:64])
    pool.run()
    peaks = [r.esc_peak_score for r, t in zip(obs, tiers)
             if t < 2 and r.esc_peak_score > 0]
    thr = calibrate_abort_threshold(peaks, 0.25)   # <= 25% may escalate
    print(f"  abort threshold {thr:.3f} "
          f"({len(peaks)} observed streams, 25% budget)")
    # live pass: a stream crossing the threshold aborts (pages freed,
    # prompt + emitted prefix kept) and resumes one tier up as ONE
    # chunked prefill — escalation costs a prefill, not a restart, and
    # the continuation is byte-identical to the upper tier decoding
    # greedily from that prefix
    mon = EscalationMonitor(abort_threshold=thr, min_tokens=1)
    pool = ContinuousPoolEngine(cascade, fresh_engines(),
                                escalation=[mon, dataclasses.replace(mon)])
    pool.serve(ds.query[:64], ds.query_mask[:64])
    m = pool.meter
    for name, row in m.summary().items():
        esc = (f"  {row['escalations']} escalated away "
               f"({row['esc_tokens']} tok billed here)"
               if row["escalations"] else "")
        print(f"  {name:<6} {row['calls']:>4} calls "
              f"{row['gen_tokens']:>5} tok{esc}")
    # tokens split across the tiers that emitted them; the CALL lands
    # once, at the tier that finished — §2.3 cost metrics stay undiluted
    print(f"  {len(pool.escalation_log)} hand-offs; "
          f"{int(m.total_calls)} calls for 64 requests; "
          f"cost advantage {m.cost_advantage:.0%} calls / "
          f"{m.token_cost_advantage:.0%} tokens")
    assert int(m.total_calls) == 64, "a call split across tiers"


if __name__ == "__main__":
    main()
