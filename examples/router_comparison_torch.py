"""End-to-end run through the PyTorch port, on the card by default:
train all three routers (r_det / r_prob / r_trans) on a large-gap pair and
reproduce the paper's Table-1 ordering (r_trans dominates when the
capability gap is large).

Run: PYTHONPATH=src python examples/router_comparison_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.experiment import build_experiment, train_pair_routers
from repro_torch.core.metrics import (drop_at_cost_advantages,
                                      random_routing_curve)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = ap.parse_args().device
    exp = build_experiment(seed=2, n_train_queries=600, n_test_queries=300,
                           n_samples=6, steps_scale=0.4,
                           tiers=("tiny", "large"), device=dev)
    routers = train_pair_routers(exp, "tiny", "large", epochs=3, device=dev)
    qs, ql = exp.qualities["tiny"]["test"], exp.qualities["large"]["test"]

    print(f"{'router':>8} {'t*':>6} {'drop@10%':>9} {'drop@20%':>9} "
          f"{'drop@40%':>9}")
    for kind, r in routers.items():
        d = drop_at_cost_advantages(r["scores"]["test"], qs, ql)
        print(f"{kind:>8} {r['t_star']:6.2f} {d[0.1]['drop_pct']:9.2f} "
              f"{d[0.2]['drop_pct']:9.2f} {d[0.4]['drop_pct']:9.2f}")
    rng = np.random.default_rng(0)
    rand = random_routing_curve(rng, len(qs), qs, ql, n_points=21)
    for ca in (0.1, 0.2, 0.4):
        pts = [p.drop_pct for p in rand if abs(p.cost_advantage - ca) < 0.03]
        print(f"  random@{ca:.0%}: {np.mean(pts):.2f}% drop")


if __name__ == "__main__":
    main()
