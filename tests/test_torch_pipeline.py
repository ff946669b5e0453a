"""The paper's pipeline through the port, end to end on the CPU, at
tests/test_system.py's scale: train a tiny/large LM pair, sample
responses, build the three label kinds, train the three routers, and hold
the paper's qualitative claims against the port:

  (1) trained routers beat random routing,
  (2) r_trans balances labels in the large-gap regime (t* > 0),
  (3) threshold calibration meets its drop budget on held-out data,
  (4) the hybrid engine realises the predicted cost advantage,

then serve the test queries through a calibrated two-tier cascade pool and
a quality-target dial. Sampled qualities come from torch.Generator
streams, not the reference's, so they are held to these statistics, never
bit for bit. The module's fixtures took 47 s of wall time on 4 PyTorch
threads of an 8-core CPU (the LMs' 247 training steps are most of it),
its tests 2 s more (52 s for the file alone)."""
import numpy as np
import pytest
import torch

from repro_torch.core.experiment import (build_experiment, pool_policy,
                                         train_pair_routers,
                                         train_pool_router)
from repro_torch.core.metrics import (drop_at_cost_advantages,
                                      random_routing_curve)
from repro_torch.core.routing import HybridRouter
from repro_torch.core.thresholds import calibrate_threshold, evaluate_threshold
from repro_torch.serving.engine import ContinuousEngine, Engine
from repro_torch.serving.hybrid import HybridEngine
from repro_torch.serving.pool import ContinuousPoolEngine

THREADS = 4   # the LMs' training steps are matmul-bound


@pytest.fixture(scope="module")
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def exp(threads):
    return build_experiment(seed=0, n_train_queries=220, n_test_queries=150,
                            n_samples=4, steps_scale=0.15,
                            tiers=("tiny", "large"), device="cpu")


@pytest.fixture(scope="module")
def routers(exp):
    return train_pair_routers(exp, "tiny", "large", epochs=2, device="cpu")


def test_capacity_gap_exists(exp):
    q_t = exp.qualities["tiny"]["test"].mean()
    q_l = exp.qualities["large"]["test"].mean()
    assert q_l > q_t + 0.05, (q_t, q_l)
    for t in ("tiny", "large"):
        assert not any(p.requires_grad for p in exp.lms[t].params.parameters())
        for split, ds in exp.datasets.items():
            q = exp.qualities[t][split]
            assert q.shape == (len(ds.query), 4)
            assert ((q >= -1.0) & (q <= 0.0)).all()


def test_routers_beat_random(exp, routers):
    """Paper §4.2, LARGE-gap regime: r_trans clearly beats random and
    dominates r_det / r_prob, which hug the random curve."""
    qs = exp.qualities["tiny"]["test"]
    ql = exp.qualities["large"]["test"]
    rand = random_routing_curve(np.random.default_rng(0), len(qs), qs, ql,
                                n_points=11)
    rand40 = min(p.drop_pct for p in rand if abs(p.cost_advantage - 0.4) < 0.06)
    drops = {kind: drop_at_cost_advantages(r["scores"]["test"], qs, ql)
             [0.4]["drop_pct"] for kind, r in routers.items()}
    assert drops["trans"] < rand40, (drops, rand40)
    assert drops["prob"] < rand40 * 1.2, (drops, rand40)
    assert drops["det"] < rand40 * 1.2, (drops, rand40)
    assert drops["trans"] < min(drops["det"], drops["prob"]), drops


def test_trans_router_balances_large_gap(exp, routers):
    assert routers["trans"]["t_star"] > 0.0
    assert routers["det"]["t_star"] == routers["prob"]["t_star"] == 0.0
    for kind, r in routers.items():
        assert r["label_kind"] == kind and len(r["history"]["val_loss"]) == 2
        assert not any(p.requires_grad for p in r["params"].parameters())


def test_calibration_generalises(exp, routers):
    qs_v = exp.qualities["tiny"]["val"]
    ql_v = exp.qualities["large"]["val"]
    r = routers["trans"]
    res = calibrate_threshold(r["scores"]["val"], qs_v, ql_v, max_drop_pct=5.0)
    test_ev = evaluate_threshold(res.threshold, r["scores"]["test"],
                                 exp.qualities["tiny"]["test"],
                                 exp.qualities["large"]["test"])
    assert test_ev["drop_pct"] < 15.0
    assert abs(test_ev["cost_advantage"] - res.expected_cost_advantage) < 0.25


def test_hybrid_engine_cost_advantage(exp, routers):
    r = routers["trans"]
    thr = float(np.quantile(r["scores"]["test"], 0.7))
    router = HybridRouter(r["params"], r["rcfg"], thr)
    lms = exp.lms
    small = Engine(lms["tiny"].bundle, lms["tiny"].params, max_new_tokens=8)
    large = Engine(lms["large"].bundle, lms["large"].params, max_new_tokens=8)
    hy = HybridEngine(router, small, large)
    ds = exp.datasets["test"]
    res = hy.serve(ds.query[:64], ds.query_mask[:64])
    assert 0.05 < hy.meter.cost_advantage < 0.75
    assert res.responses.shape == (64, 8)


def test_calibrated_pool_policies_serve_the_test_split(exp):
    """The K-tier path on the experiment's two tiers: a per-boundary router
    calibrated into a cascade, and the quality-target dial, each driving a
    ContinuousPoolEngine over the test queries."""
    tiers = ("tiny", "large")
    out = train_pool_router(exp, tiers, epochs=2, device="cpu")
    ds = exp.datasets["test"]
    q, mask = ds.query[:48], ds.query_mask[:48]
    engines = [(t, ContinuousEngine(exp.lms[t].bundle, exp.lms[t].params,
                                    max_new_tokens=8, n_slots=8, max_seq=64))
               for t in tiers]
    cascade = pool_policy(exp, out, tiers, kind="cascade", max_drop_pct=5.0)
    assert cascade.per_boundary and cascade.n_tiers == 2
    pool = ContinuousPoolEngine(cascade, engines)
    res = pool.serve(q, mask, seed=0)
    np.testing.assert_array_equal(res.tier_idx, cascade.decide(q, mask)[0])
    assert pool.meter.total_calls == len(q) and (res.lengths >= 1).all()
    qt = pool_policy(exp, out, tiers, kind="quality_target")
    pool = ContinuousPoolEngine(qt, engines)
    prev = None
    for target in np.quantile(exp.qualities["large"]["val"], [0.1, 0.5, 0.9]):
        qt.set_target(float(target))
        res = pool.serve(q, mask, seed=0)
        np.testing.assert_array_equal(res.tier_idx, qt.decide(q, mask)[0])
        if prev is not None:
            assert (res.tier_idx >= prev).all()
        prev = res.tier_idx
    for _, e in engines:
        assert e.cache.free_pages == e.cache.num_pages - 1
