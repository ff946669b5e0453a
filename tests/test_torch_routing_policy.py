"""The port's K-tier routing policies (repro_torch.core.routing) against
the JAX package's, mirroring tests/test_routing_policy.py (its fused-step
cases stay with the TPU tooling) and tests/test_routing_properties.py.

Decisions are held exactly: both sides' policies decide on the same fixed
host scores (``_VecRouter``, a stand-in router), so a port decision must
equal the reference's bit for bit. Scores of a real router are compared
apart, on weights carried across by the bridge, within SCORE_TOL."""
import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import routing as ref_routing
from repro.core.experiment import ExperimentData as JaxExperimentData
from repro.core.experiment import pool_policy as jax_pool_policy
from repro.data import tokenizer as jax_tok
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.models import init_router_encoder as jax_init_router
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import ContinuousPoolEngine as JaxPool
from repro_torch import bridge
from repro_torch.core.experiment import ExperimentData, TIER_ORDER, pool_policy
from repro_torch.core.routing import (CascadePolicy, HybridRouter,
                                      QualityTargetPolicy, RoutingPolicy,
                                      ThresholdPolicy, TierMeter,
                                      fit_quality_map)
from repro_torch.core.thresholds import (best_feasible, calibration_frontier,
                                         cascade_thresholds,
                                         calibrate_threshold)
from repro_torch.data import tokenizer as tok
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.pool import ContinuousPoolEngine
from conftest import tiny_cfg

SCORE_TOL = 1e-5   # sigmoid scores, fp32 encoders, another summation order


@pytest.fixture(autouse=True)
def highest_precision():
    """fp32 matmuls at full precision on both sides, one PyTorch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(threads)


@dataclasses.dataclass
class _VecRouter:
    """Fixed-score stand-in for HybridRouter on either side: ``scores``
    ignores the query batch and returns the instance's vector."""
    vec: np.ndarray
    threshold: float = 0.5

    def scores(self, tokens, mask):
        return self.vec

    def with_threshold(self, threshold):
        return dataclasses.replace(self, threshold=float(threshold))


def _dummy_queries(n):
    return np.zeros((n, 1), np.int32), np.ones((n, 1), np.float32)


_RCFG = JaxRouterConfig(vocab_size=jax_tok.VOCAB_SIZE, n_layers=1, d_model=32,
                        n_heads=2, d_ff=64)


@pytest.fixture(scope="module")
def routers():
    """(reference router params, the port's bridged RouterEncoder)."""
    p = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(0),
                                                    _RCFG)
    return p, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p),
        RouterConfig(**dataclasses.asdict(_RCFG)), "cpu")


def _pair(routers, threshold):
    p, port = routers
    return (ref_routing.HybridRouter(p, _RCFG, threshold),
            HybridRouter(port, RouterConfig(**dataclasses.asdict(_RCFG)),
                         threshold))


def _synchronous(eng):
    """Make a reference continuous engine wait for each jitted dispatch:
    under CPU async dispatch it races the host arrays it hands over, so
    identical runs can emit different greedy tokens (ROADMAP.md, Queue 3);
    waiting changes no value (as tests/test_torch_serving.py does)."""
    for name in ("_prefill_chunk_fn", "_decode", "_lm_head"):
        fn = getattr(eng, name)
        setattr(eng, name,
                lambda *a, fn=fn: jax.block_until_ready(fn(*a)))
    return eng


def _queries(n=12, l=10, seed=0):
    q = np.random.default_rng(seed).integers(4, tok.VOCAB_SIZE,
                                             (n, l)).astype(np.int32)
    return q, np.ones_like(q, np.float32)


# ----------------------------------------------------------------- router
def test_hybrid_router_scores_and_route_match_reference(routers):
    q, mask = _queries()
    ref, port = _pair(routers, 0.5)
    want = np.asarray(ref.scores(jnp.asarray(q), jnp.asarray(mask)))
    got = port.scores(q, mask)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=SCORE_TOL)
    assert port.label_kind == ref.label_kind == "trans"
    # a threshold between two reference scores, away from both
    s = np.sort(want)
    thr = float(s[5] + s[6]) / 2
    np.testing.assert_array_equal(
        port.with_threshold(thr).route(q, mask).numpy(),
        np.asarray(ref.with_threshold(thr).route(jnp.asarray(q),
                                                 jnp.asarray(mask))))


def test_threshold_policy_matches_router_route(routers):
    q, mask = _queries()
    _, r = _pair(routers, 0.5)
    scores = r.scores(q, mask).numpy()
    pol = ThresholdPolicy(r.with_threshold(float(np.median(scores))))
    assert isinstance(pol, RoutingPolicy) and pol.n_tiers == 2
    tier, s = pol.decide(q, mask)
    np.testing.assert_array_equal(s, scores)
    np.testing.assert_array_equal(tier == 0,
                                  pol.router.route(q, mask).numpy())


# ---------------------------------------------------------------- policies
# the port's policy classes under the reference module's names
_PORT = types.SimpleNamespace(CascadePolicy=CascadePolicy,
                              QualityTargetPolicy=QualityTargetPolicy,
                              ThresholdPolicy=ThresholdPolicy,
                              fit_quality_map=fit_quality_map)


def _both(make, *args):
    """The same policy built on each side from ``make(routing_module,
    *args)``: (reference's, port's)."""
    return make(ref_routing, *args), make(_PORT, *args)


def _same_decisions(ref_pol, port_pol, n):
    q, m = _dummy_queries(n)
    rt, rs = ref_pol.decide(q, m)
    pt, ps = port_pol.decide(q, m)
    np.testing.assert_array_equal(pt, np.asarray(rt))
    np.testing.assert_array_equal(ps, np.asarray(rs))
    assert pt.dtype == np.asarray(rt).dtype
    return pt, ps


def test_cascade_two_tier_reduces_to_threshold_policy():
    s = np.random.default_rng(1).uniform(size=40)
    t = float(np.median(s))
    t2, _ = ThresholdPolicy(_VecRouter(s, t)).decide(*_dummy_queries(40))
    tc, _ = CascadePolicy(_VecRouter(s), (t,)).decide(*_dummy_queries(40))
    np.testing.assert_array_equal(t2, tc)
    _same_decisions(*_both(lambda m: m.ThresholdPolicy(_VecRouter(s, t))), 40)


def test_cascade_buckets_are_score_monotone():
    s = np.random.default_rng(2).uniform(size=64)
    lo, hi = float(np.quantile(s, 1 / 3)), float(np.quantile(s, 2 / 3))
    ref_pol, pol = _both(lambda m: m.CascadePolicy(_VecRouter(s), (hi, lo)))
    assert pol.n_tiers == 3 and not pol.per_boundary
    tier, scores = _same_decisions(ref_pol, pol, len(s))
    assert set(np.unique(tier)) <= {0, 1, 2}
    order = np.argsort(-scores)
    assert (np.diff(tier[order]) >= 0).all()
    with pytest.raises(ValueError):
        CascadePolicy(_VecRouter(s), (lo, hi))   # ascending thresholds
    with pytest.raises(ValueError):
        CascadePolicy(_VecRouter(s), ())


def test_cascade_per_boundary_validation():
    r = _VecRouter(np.zeros(3))
    with pytest.raises(ValueError):   # both modes at once
        CascadePolicy(router=r, thresholds=(0.5,),
                      boundaries=(r.with_threshold(0.5),))
    with pytest.raises(ValueError):   # shared mode still needs a router
        CascadePolicy(thresholds=(0.5,))
    with pytest.raises(ValueError):   # and at least one threshold
        CascadePolicy(router=r)
    pol = CascadePolicy(boundaries=(r.with_threshold(0.3),
                                    r.with_threshold(0.9)))
    assert pol.n_tiers == 3 and pol.per_boundary


def test_cascade_per_boundary_matches_shared_score_with_identical_heads(
        routers):
    """One real head repeated per gate with the shared-score thresholds IS
    the shared-score cascade, on the port's own scores."""
    q, mask = _queries(n=24)
    _, r = _pair(routers, 0.0)
    s = np.sort(r.scores(q, mask).numpy())
    thresholds = tuple(float(s[i] + s[i + 1]) / 2 for i in (17, 11, 5))
    shared = CascadePolicy(router=r, thresholds=thresholds)
    per_b = CascadePolicy(boundaries=tuple(r.with_threshold(t)
                                           for t in thresholds))
    assert per_b.n_tiers == shared.n_tiers == 4
    tier_s, score_s = shared.decide(q, mask)
    tier_b, score_b = per_b.decide(q, mask)
    np.testing.assert_array_equal(tier_s, tier_b)
    np.testing.assert_array_equal(score_s, score_b)
    assert np.bincount(tier_s, minlength=4).tolist() == [6, 6, 6, 6]


def test_quality_target_policy_dial():
    rng = np.random.default_rng(3)
    scores = rng.uniform(size=32)
    quals = [np.clip(scores[:, None] * 0.5 + k * 0.2
                     + rng.normal(0, 0.01, (len(scores), 3)), 0, 2)
             for k in range(3)]
    ref_pol, pol = _both(lambda m: m.QualityTargetPolicy.fit(
        _VecRouter(scores), scores, quals, target=0.0))
    assert pol.n_tiers == 3
    tier_lo, _ = _same_decisions(ref_pol, pol, len(scores))
    assert (tier_lo == 0).all()
    prev = np.zeros(len(scores), np.int64)
    for target in (0.1, 0.3, 0.5, 0.7, 10.0):
        pol.set_target(target)
        ref_pol.set_target(target)
        tier, _ = _same_decisions(ref_pol, pol, len(scores))
        assert (tier >= prev).all()
        prev = tier
    assert (prev == 2).all()   # nothing clears 10: the priciest tier
    np.testing.assert_array_equal(pol.predicted_quality(scores),
                                  ref_pol.predicted_quality(scores))


@pytest.mark.parametrize("n_bins,constant", [(8, False), (3, False),
                                             (8, True)],
                         ids=["8_bins", "3_bins", "constant_scores"])
def test_fit_quality_map_matches_reference(n_bins, constant):
    rng = np.random.default_rng(4)
    scores = np.full(500, 0.3) if constant else rng.uniform(size=500)
    q = (scores[:, None] + rng.normal(0, 0.05, (500, 4))).astype(np.float32)
    m = fit_quality_map(scores, q, n_bins=n_bins)
    want = ref_routing.fit_quality_map(scores, q, n_bins=n_bins)
    np.testing.assert_array_equal(m.bin_edges, want.bin_edges)
    np.testing.assert_array_equal(m.quality, want.quality)
    probe = np.linspace(-0.1, 1.1, 25)
    np.testing.assert_array_equal(m(probe), want(probe))
    assert (np.diff(m.bin_edges) > 0).all()
    if not constant:
        assert (np.diff(m.quality) > -0.05).all()


def test_tier_meter_accounting_and_advantages():
    m = TierMeter(("tiny", "small", "large"))
    m.record(np.array([0, 0, 1, 2, 2]), np.array([4, 6, 10, 3, 7]))
    m.record(np.array([1]), gen_tokens=5)
    assert list(m.calls) == [2, 2, 2] and m.total_calls == 6
    assert list(m.tokens) == [10, 15, 10] and m.total_tokens == 35
    assert abs(m.cost_advantage - 4 / 6) < 1e-9
    assert abs(m.token_cost_advantage - 25 / 35) < 1e-9
    ref = ref_routing.TierMeter(("tiny", "small", "large"))
    ref.record(np.array([0, 0, 1, 2, 2]), np.array([4, 6, 10, 3, 7]))
    ref.record(np.array([1]), gen_tokens=5)
    assert m.summary() == ref.summary()


# -------------------------------------------------------- calibration glue
def _cal_problem(rng, n=400):
    gap = rng.normal(-0.3, 0.4, n)
    scores = 1 / (1 + np.exp(-gap * 4))
    q_large = rng.normal(0, 0.05, (n, 4)).astype(np.float32) - 1.0
    q_small = (q_large + gap[:, None]).astype(np.float32)
    return scores, q_small, q_large


def test_cascade_from_frontier_matches_reference(rng):
    scores, qs, ql = _cal_problem(rng)
    frontier = calibration_frontier(scores, qs, ql)
    pol = CascadePolicy.from_frontier(_VecRouter(scores), frontier, 4,
                                      max_drop_pct=1.0)
    ref_pol = ref_routing.CascadePolicy.from_frontier(
        _VecRouter(scores), frontier, 4, max_drop_pct=1.0)
    assert pol.thresholds == ref_pol.thresholds == tuple(
        cascade_thresholds(frontier, 4, 1.0))
    assert pol.thresholds[0] == calibrate_threshold(scores, qs, ql,
                                                    1.0).threshold
    _same_decisions(ref_pol, pol, len(scores))


def _exps(qualities):
    """The same qualities as the port's and the reference's
    ExperimentData."""
    return (ExperimentData({}, {}, qualities, {}, {}),
            JaxExperimentData({}, {}, qualities, {}, {}))


def test_pool_policy_from_experiment_vocabulary(rng, routers):
    """pool_policy speaks the TIERS vocabulary: cascade and quality-target
    policies come out of one experiment's qualities, with the
    reference's thresholds and maps."""
    scores, qs, ql = _cal_problem(rng)
    qm_ = ((qs + ql) / 2).astype(np.float32)
    exp, jexp = _exps({"tiny": {"val": qs}, "small": {"val": qm_},
                       "large": {"val": ql}})
    p, port = routers
    tiers = ("tiny", "small", "large")
    assert all(t in TIER_ORDER for t in tiers)
    out = {"params": port, "rcfg": RouterConfig(**dataclasses.asdict(_RCFG)),
           "scores": {"val": scores}}
    jout = {"params": p, "rcfg": _RCFG, "scores": {"val": scores}}
    cas = pool_policy(exp, out, tiers, kind="cascade", max_drop_pct=1.0)
    jcas = jax_pool_policy(jexp, jout, tiers, kind="cascade",
                           max_drop_pct=1.0)
    assert isinstance(cas, CascadePolicy) and cas.n_tiers == 3
    assert cas.thresholds == jcas.thresholds
    assert cas.router.threshold == cas.thresholds[0]
    assert cas.router.params is port
    qt = pool_policy(exp, out, tiers, kind="quality_target",
                     quality_target=0.25)
    jqt = jax_pool_policy(jexp, jout, tiers, kind="quality_target",
                          quality_target=0.25)
    assert isinstance(qt, QualityTargetPolicy) and qt.target == 0.25
    for m, jm in zip(qt.maps, jqt.maps):
        np.testing.assert_array_equal(m.bin_edges, jm.bin_edges)
        np.testing.assert_array_equal(m.quality, jm.quality)
    with pytest.raises(ValueError):   # priciest -> cheapest is rejected
        pool_policy(exp, out, ("large", "tiny"))
    with pytest.raises(ValueError):
        pool_policy(exp, out, tiers, kind="nope")


def test_pool_policy_per_boundary_calibrates_each_gate(rng, routers):
    scores, qs, ql = _cal_problem(rng)
    qm_ = ((qs + ql) / 2).astype(np.float32)
    exp, jexp = _exps({"tiny": {"val": qs}, "small": {"val": qm_},
                       "large": {"val": ql}})
    p, port = routers
    scores1 = np.clip(scores + rng.normal(0, 0.05, scores.shape), 0, 1)
    prcfg = RouterConfig(**dataclasses.asdict(_RCFG))
    out = {"boundaries": [
        {"params": port, "rcfg": prcfg, "scores": {"val": s},
         "label_kind": "prob"} for s in (scores, scores1)],
        "tiers": ("tiny", "small", "large"), "kind": "prob"}
    jout = {"boundaries": [
        {"params": p, "rcfg": _RCFG, "scores": {"val": s},
         "label_kind": "prob"} for s in (scores, scores1)]}
    tiers = ("tiny", "small", "large")
    cas = pool_policy(exp, out, tiers, kind="cascade", max_drop_pct=1.0)
    jcas = jax_pool_policy(jexp, jout, tiers, kind="cascade",
                           max_drop_pct=1.0)
    assert cas.per_boundary and len(cas.boundaries) == 2
    for b, (s, lo, hi) in enumerate([(scores, qs, qm_), (scores1, qm_, ql)]):
        cal = best_feasible(calibration_frontier(s, lo, hi), 1.0)
        assert cas.boundaries[b].threshold == cal.threshold \
            == jcas.boundaries[b].threshold
        assert cas.boundaries[b].label_kind == "prob"
    qt = pool_policy(exp, out, tiers, kind="quality_target",
                     quality_target=0.25)
    assert isinstance(qt, QualityTargetPolicy) and qt.n_tiers == 3
    with pytest.raises(ValueError):   # boundary count must match the tiers
        pool_policy(exp, {"boundaries": out["boundaries"][:1]}, tiers,
                    kind="cascade")
    with pytest.raises(ValueError):
        pool_policy(exp, out, tiers, kind="nope")


# ------------------------------------------------------------ pool serving
def test_cascade_pool_three_tiers_matches_reference(routers):
    """A 3-tier shared-score CascadePolicy in front of three continuous
    engines: the same dispatch, greedy tokens and per-tier meter as the
    reference's pool, on bridged weights (thresholds sit between
    scores, so both sides' scores fall on the same side)."""
    # one config for the three tiers (distinct weights): the reference
    # engines then share their compiled programs
    cfgs = [tiny_cfg("dense", vocab_size=tok.VOCAB_SIZE)] * 3
    ref_ms = [jax_build_model(c) for c in cfgs]
    ref_ps = [jax.jit(m.init)(jax.random.PRNGKey(s + 1))
              for s, m in enumerate(ref_ms)]
    pcfgs = [ArchConfig(**dataclasses.asdict(c)) for c in cfgs]
    port_ms = [bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                        c, "cpu")
               for p, c in zip(ref_ps, pcfgs)]
    q, mask = _queries(n=12, l=8, seed=6)
    ref_r, port_r = _pair(routers, 0.5)
    s = np.sort(port_r.scores(q, mask).numpy())
    ts = (float(s[7] + s[8]) / 2, float(s[3] + s[4]) / 2)
    kw = dict(max_new_tokens=4, n_slots=2, page_size=8, max_seq=32)
    names = ("tiny", "mid", "big")
    ref_pool = JaxPool(ref_routing.CascadePolicy(ref_r, ts), [
        (n, _synchronous(JaxEngine(m, p, **kw)))
        for n, m, p in zip(names, ref_ms, ref_ps)])
    want = ref_pool.serve(q, mask, seed=0)
    engines = [(n, ContinuousEngine(build_model(c), m, **kw))
               for n, c, m in zip(names, pcfgs, port_ms)]
    pool = ContinuousPoolEngine(CascadePolicy(port_r, ts), engines)
    got = pool.serve(q, mask, seed=0)
    np.testing.assert_array_equal(got.tier_idx, want.tier_idx)
    assert np.bincount(got.tier_idx, minlength=3).tolist() == [4, 4, 4]
    np.testing.assert_allclose(got.scores, want.scores, atol=SCORE_TOL)
    np.testing.assert_array_equal(got.responses, want.responses)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert pool.meter.summary() == ref_pool.meter.summary()
    np.testing.assert_array_equal(pool.meter.calls,
                                  np.bincount(got.tier_idx, minlength=3))
    for _, e in engines:
        assert e.cache.free_pages == e.cache.num_pages - 1
    with pytest.raises(ValueError):   # policy/engine arity mismatch
        ContinuousPoolEngine(CascadePolicy(port_r, ts), engines[:2])


class _BadPolicy:
    n_tiers = 2

    def decide(self, tokens, mask):
        n = len(tokens)
        return np.full(n, -1, np.int64), np.zeros(n)


def test_pool_rejects_out_of_range_tiers_and_dedups_aliased_engine():
    cfg = ArchConfig(**dataclasses.asdict(tiny_cfg(
        "dense", vocab_size=tok.VOCAB_SIZE)))
    m = build_model(cfg)
    eng = ContinuousEngine(m, m.init(torch.Generator().manual_seed(1), "cpu"),
                           max_new_tokens=3, n_slots=2, page_size=8,
                           max_seq=32)
    q, mask = _queries(n=3, l=6, seed=7)
    pool = ContinuousPoolEngine(_BadPolicy(), [("a", eng), ("b", eng)])
    with pytest.raises(ValueError):
        pool.submit(q, mask)
    pool = ContinuousPoolEngine(ThresholdPolicy(_VecRouter(np.ones(3), 0.0)),
                                [("a", eng), ("b", eng)])
    pool.submit(q, mask)
    pool.step()
    assert eng.stats.steps == 1             # stepped once, not per alias
    pool.run()
    assert pool.meter.total_calls == 3


# ------------------------------------------------------------- properties
unit_floats = st.floats(0.0, 1.0, allow_nan=False, allow_infinity=False)
score_vecs = st.lists(unit_floats, min_size=1, max_size=24).map(
    lambda xs: np.asarray(xs, np.float64))
tier_counts = st.integers(2, 5)


@st.composite
def cascade_instances(draw):
    scores = draw(score_vecs)
    k = draw(tier_counts)
    gates = draw(st.lists(unit_floats, min_size=k - 1, max_size=k - 1))
    return scores, k, gates


@st.composite
def shared_instances(draw):
    scores = draw(score_vecs)
    k = draw(tier_counts)
    ts = sorted(draw(st.lists(unit_floats, min_size=k - 1, max_size=k - 1)),
                reverse=True)
    return scores, k, ts


@settings(max_examples=200, deadline=None)
@given(cascade_instances(), st.integers(0, 3), st.floats(0.0, 1.0))
def test_per_boundary_gate_raise_never_routes_cheaper(inst, which, delta):
    scores, k, gates = inst
    b = which % (k - 1)
    gate_pols = lambda m, gs: m.CascadePolicy(boundaries=tuple(
        _VecRouter(scores, t) for t in gs))
    ref_pol, pol = _both(gate_pols, gates)
    raised = list(gates)
    raised[b] = min(1.0 + 1e-9, raised[b] + delta)
    ref_pol2, pol2 = _both(gate_pols, raised)
    tier, s0 = _same_decisions(ref_pol, pol, len(scores))
    tier2, _ = _same_decisions(ref_pol2, pol2, len(scores))
    assert (tier2 >= tier).all()
    assert (0 <= tier).all() and (tier < k).all()
    np.testing.assert_array_equal(s0, scores)   # gate 0's head is reported


@settings(max_examples=200, deadline=None)
@given(shared_instances(), st.lists(st.floats(0.0, 0.5), min_size=4,
                                    max_size=4))
def test_shared_threshold_raise_never_routes_cheaper(inst, deltas):
    scores, k, ts = inst
    raised = sorted((t + d for t, d in zip(ts, deltas)), reverse=True)
    shared = lambda m, t: m.CascadePolicy(router=_VecRouter(scores, ts[0]),
                                          thresholds=tuple(t))
    tier, _ = _same_decisions(*_both(shared, ts), len(scores))
    tier2, _ = _same_decisions(*_both(shared, raised), len(scores))
    assert (tier2 >= tier).all()


@settings(max_examples=150, deadline=None)
@given(score_vecs, tier_counts, st.floats(-1.0, 1.0), st.floats(0.0, 0.5),
       st.integers(0, 2 ** 31 - 1))
def test_quality_target_monotone_in_target(scores, k, target, bump, seed):
    rng = np.random.default_rng(seed)
    cal_scores = rng.uniform(size=64)
    qs = [rng.normal(0, 1, 64) for _ in range(k)]
    ref_pol, pol = _both(lambda m: m.QualityTargetPolicy(
        _VecRouter(scores), [m.fit_quality_map(cal_scores, q, n_bins=4)
                             for q in qs], target))
    tier, _ = _same_decisions(ref_pol, pol, len(scores))
    pol.set_target(target + bump)
    ref_pol.set_target(target + bump)
    tier2, _ = _same_decisions(ref_pol, pol, len(scores))
    assert (tier2 >= tier).all()
    assert (0 <= tier).all() and (tier2 < k).all()


@settings(max_examples=200, deadline=None)
@given(shared_instances())
def test_per_boundary_equals_shared_with_identical_heads(inst):
    scores, k, ts = inst
    shared = CascadePolicy(router=_VecRouter(scores, ts[0]),
                           thresholds=tuple(ts))
    per_b = CascadePolicy(boundaries=tuple(
        _VecRouter(scores, t) for t in ts))
    tier_s, score_s = shared.decide(*_dummy_queries(len(scores)))
    tier_b, score_b = per_b.decide(*_dummy_queries(len(scores)))
    np.testing.assert_array_equal(tier_s, tier_b)
    np.testing.assert_array_equal(score_s, score_b)
