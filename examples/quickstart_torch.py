"""Quickstart through the PyTorch port: the paper's pipeline end to end,
on the card by default.

1. Train a small and a large LM on the synthetic instruction suite.
2. Sample responses, measure quality, build y_trans(t*) labels (§3.3).
3. Train the router, calibrate a threshold for <=2% drop (§4.5).
4. Serve a batch of queries through the hybrid engine and report the
   realised cost advantage (§2.3).

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(about a minute on 4 CPU threads; the card runs the serving kernels)
"""
import argparse

from repro_torch.core.experiment import build_experiment, train_pair_routers
from repro_torch.core.routing import HybridRouter
from repro_torch.core.thresholds import calibrate_threshold, evaluate_threshold
from repro_torch.serving.engine import Engine
from repro_torch.serving.hybrid import HybridEngine


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    dev = ap.parse_args().device

    print(f"== building experiment on {dev} (training S/L pair + sampling) ==")
    exp = build_experiment(seed=0, n_train_queries=400, n_test_queries=250,
                           n_samples=4, steps_scale=0.3,
                           tiers=("small", "large"), device=dev)
    for t in ("small", "large"):
        print(f"  {t}: mean test quality "
              f"{exp.qualities[t]['test'].mean():+.3f}")

    print("== training r_trans router ==")
    routers = train_pair_routers(exp, "small", "large", kinds=("trans",),
                                 epochs=3, device=dev)
    r = routers["trans"]
    print(f"  t* = {r['t_star']:.3f}")

    qs_v, ql_v = exp.qualities["small"]["val"], exp.qualities["large"]["val"]
    cal = calibrate_threshold(r["scores"]["val"], qs_v, ql_v, max_drop_pct=2.0)
    print(f"  calibrated threshold {cal.threshold:.3f} -> expect "
          f"{cal.expected_cost_advantage:.0%} cost advantage at "
          f"{cal.expected_drop_pct:.2f}% drop")

    ev = evaluate_threshold(cal.threshold, r["scores"]["test"],
                            exp.qualities["small"]["test"],
                            exp.qualities["large"]["test"])
    print(f"  test: {ev['cost_advantage']:.0%} cost advantage at "
          f"{ev['drop_pct']:.2f}% drop")

    print("== hybrid serving ==")
    router = HybridRouter(r["params"], r["rcfg"], cal.threshold)
    small = Engine(exp.lms["small"].bundle, exp.lms["small"].params,
                   max_new_tokens=12)
    large = Engine(exp.lms["large"].bundle, exp.lms["large"].params,
                   max_new_tokens=12)
    hybrid = HybridEngine(router, small, large)
    ds = exp.datasets["test"]
    for i in range(0, 192, 64):   # three batches of requests
        hybrid.serve(ds.query[i:i + 64], ds.query_mask[i:i + 64])
    print(f"  served {hybrid.meter.to_small + hybrid.meter.to_large} queries, "
          f"cost advantage {hybrid.meter.cost_advantage:.0%} "
          f"({hybrid.meter.to_small} -> small, "
          f"{hybrid.meter.to_large} -> large)")


if __name__ == "__main__":
    main()
