"""Hybrid serving at different quality targets through the PyTorch port,
on the card by default.

Serves the same request stream at several routing thresholds, showing the
dynamic quality/cost dial the paper advertises (tuned at test time, no
retraining). Also prints the per-engine serve stats.

Run: PYTHONPATH=src python examples/hybrid_serving_torch.py [--device cpu]
"""
import argparse

from repro_torch.core.experiment import build_experiment, train_pair_routers
from repro_torch.core.metrics import (mixture_quality, perf_drop_pct,
                                      threshold_for_cost_advantage)
from repro_torch.core.routing import HybridRouter
from repro_torch.serving.engine import Engine
from repro_torch.serving.hybrid import HybridEngine


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = ap.parse_args().device
    exp = build_experiment(seed=1, n_train_queries=400, n_test_queries=250,
                           n_samples=4, steps_scale=0.3,
                           tiers=("small", "large"), device=dev)
    routers = train_pair_routers(exp, "small", "large", kinds=("trans",),
                                 epochs=3, device=dev)
    r = routers["trans"]
    qs, ql = exp.qualities["small"]["test"], exp.qualities["large"]["test"]
    scores = r["scores"]["test"]
    ds = exp.datasets["test"]

    small = Engine(exp.lms["small"].bundle, exp.lms["small"].params,
                   max_new_tokens=12)
    large = Engine(exp.lms["large"].bundle, exp.lms["large"].params,
                   max_new_tokens=12)

    print(f"{'target':>8} {'achieved':>9} {'drop%':>7}")
    for target in (0.1, 0.2, 0.4, 0.6):
        thr = threshold_for_cost_advantage(scores, target)
        router = HybridRouter(r["params"], r["rcfg"], thr)
        hy = HybridEngine(router, small, large)
        hy.serve(ds.query[:128], ds.query_mask[:128])
        qmix, _ = mixture_quality(scores, thr, qs, ql)
        drop = perf_drop_pct(qmix, float(ql.mean()))
        print(f"{target:8.0%} {hy.meter.cost_advantage:9.0%} {drop:7.2f}")

    print(f"\nsmall engine: {small.stats.requests} reqs, "
          f"{small.stats.gen_tokens} tokens, {small.stats.wall_s:.1f}s")
    print(f"large engine: {large.stats.requests} reqs, "
          f"{large.stats.gen_tokens} tokens, {large.stats.wall_s:.1f}s")


if __name__ == "__main__":
    main()
