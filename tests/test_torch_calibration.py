"""The port's labels, metrics and threshold calibration (numpy copies in
repro_torch.core) against the JAX package's: the same inputs give equal
arrays, bit for bit, and the properties of tests/test_labels.py,
tests/test_metrics.py and tests/test_thresholds.py hold for the port."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import labels as ref_labels, metrics as ref_metrics
from repro.core import thresholds as ref_thresholds
from repro_torch.core import labels as L, metrics as M, thresholds as T


def _same(got, want):
    """Equal results, element for element: arrays, floats, dataclasses
    and the containers the functions return."""
    if dataclasses.is_dataclass(got):
        assert type(got).__name__ == type(want).__name__
        _same(dataclasses.asdict(got), dataclasses.asdict(want))
    elif isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _same(got[k], want[k])
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _qpair(rng, n=50, s=6, gap=0.3):
    q_small = rng.normal(-gap, 0.2, (n, s)).astype(np.float32)
    q_large = rng.normal(0.0, 0.2, (n, s)).astype(np.float32)
    return q_small, q_large


def _routing_problem(rng, n=200):
    gap = rng.normal(-0.5, 0.5, n)
    scores = 1 / (1 + np.exp(-(gap + rng.normal(0, 0.1, n))))
    q_large = rng.normal(0, 0.05, (n, 4)).astype(np.float32)
    q_small = (q_large.mean(1, keepdims=True) + gap[:, None]
               + rng.normal(0, 0.05, (n, 4))).astype(np.float32)
    return scores, q_small, q_large


# ------------------------------------------------------------------ labels
LABEL_CALLS = {
    "gap_samples": lambda m, qs, ql: m.quality_gap_samples(qs, ql),
    "det": lambda m, qs, ql: m.det_labels(qs, ql),
    "det_sample_3": lambda m, qs, ql: m.det_labels(qs, ql, sample_idx=3),
    "prob": lambda m, qs, ql: m.prob_labels(qs, ql),
    "prob_t": lambda m, qs, ql: m.prob_labels(qs, ql, 0.25),
    "prob_paired": lambda m, qs, ql: m.prob_labels(qs, ql, 0.1, paired=True),
    "mean_abs_diff": lambda m, qs, ql: m.mean_abs_pairwise_diff(qs[:, 0]),
    "t_grid": lambda m, qs, ql: m.default_t_grid(qs, ql),
    "objective": lambda m, qs, ql: m.transform_objective(
        qs, ql, np.linspace(0, 1, 9)),
    "optimal_transform": lambda m, qs, ql: m.optimal_transform(qs, ql),
    "trans": lambda m, qs, ql: m.trans_labels(qs, ql),
    "trans_paired": lambda m, qs, ql: m.trans_labels(qs, ql, paired=True),
}


@pytest.mark.parametrize("gap", [0.3, 3.0], ids=["small_gap", "large_gap"])
@pytest.mark.parametrize("name", list(LABEL_CALLS))
def test_labels_equal_reference(name, gap, rng):
    qs, ql = _qpair(rng, gap=gap)
    _same(LABEL_CALLS[name](L, qs, ql), LABEL_CALLS[name](ref_labels, qs, ql))


def test_det_equals_prob_with_one_sample(rng):
    qs, ql = _qpair(rng)
    np.testing.assert_array_equal(L.det_labels(qs, ql),
                                  L.prob_labels(qs[:, :1], ql[:, :1]))


def test_prob_labels_monotone_in_t(rng):
    """Pr[H >= -t] is nondecreasing in t (§3.3: relaxation only adds mass)."""
    qs, ql = _qpair(rng)
    prev = L.prob_labels(qs, ql, 0.0)
    assert ((prev >= 0) & (prev <= 1)).all()
    for t in (0.1, 0.3, 0.7, 2.0):
        cur = L.prob_labels(qs, ql, t)
        assert (cur >= prev - 1e-7).all()
        prev = cur


def test_transform_balances_skewed_labels(rng):
    """Large-gap regime: y_prob ~ all-zero; t* spreads the labels (the
    paper's Fig. 4 effect)."""
    q_small = rng.normal(-3.0, 0.3, (200, 8)).astype(np.float32)
    q_large = rng.normal(0.0, 0.3, (200, 8)).astype(np.float32)
    y0 = L.prob_labels(q_small, q_large)
    assert y0.mean() < 0.02
    y_t, t_star = L.trans_labels(q_small, q_large)
    assert t_star > 0
    assert L.mean_abs_pairwise_diff(y_t) > L.mean_abs_pairwise_diff(y0) + 0.05


@settings(max_examples=50, deadline=None)
@given(st.lists(st.floats(0, 1), min_size=2, max_size=60))
def test_mean_abs_pairwise_property(ys):
    y = np.asarray(ys)
    brute = float(np.abs(y[:, None] - y[None, :]).mean())
    assert abs(brute - L.mean_abs_pairwise_diff(y)) < 1e-9
    assert L.mean_abs_pairwise_diff(y) == ref_labels.mean_abs_pairwise_diff(y)


# ----------------------------------------------------------------- metrics
METRIC_CALLS = {
    "mixture_quality": lambda m, s, qs, ql: m.mixture_quality(
        s, float(np.median(s)), qs, ql),
    "mixture_quality_sample": lambda m, s, qs, ql: m.mixture_quality(
        s, float(np.median(s)), qs, ql, sample_idx=2),
    "threshold_for_ca": lambda m, s, qs, ql: [
        m.threshold_for_cost_advantage(s, ca)
        for ca in (0.0, 0.1, 0.25, 0.5, 0.9, 1.0)],
    "error_cost_curve": lambda m, s, qs, ql: m.error_cost_curve(
        s, qs, ql, n_points=21),
    "drop_at_cost_advantages": lambda m, s, qs, ql:
        m.drop_at_cost_advantages(s, qs, ql),
    "random_routing_curve": lambda m, s, qs, ql: m.random_routing_curve(
        np.random.default_rng(7), len(s), qs, ql, n_points=11),
    "quality_gap_difference": lambda m, s, qs, ql:
        m.quality_gap_difference(s, qs, ql, 0.3),
    "correlations": lambda m, s, qs, ql: [m.pearson(s, qs.mean(1)),
                                          m.spearman(s, qs.mean(1))],
}


@pytest.mark.parametrize("name", list(METRIC_CALLS))
def test_metrics_equal_reference(name, rng):
    s, qs, ql = _routing_problem(rng)
    _same(METRIC_CALLS[name](M, s, qs, ql),
          METRIC_CALLS[name](ref_metrics, s, qs, ql))


def test_oracle_router_beats_random(rng):
    scores, qs, ql = _routing_problem(rng)
    oracle = qs.mean(1) - ql.mean(1)
    d_oracle = M.drop_at_cost_advantages(oracle, qs, ql)[0.4]["drop_pct"]
    rand = M.random_routing_curve(rng, len(qs), qs, ql, n_points=21)
    d_rand = [p.drop_pct for p in rand if abs(p.cost_advantage - 0.4) < 0.03]
    assert d_oracle < d_rand[0]
    assert M.quality_gap_difference(scores, qs, ql, 0.3) > 0.0


@settings(max_examples=30, deadline=None)
@given(st.integers(10, 200), st.floats(0.05, 0.95))
def test_threshold_property(n, ca):
    scores = np.random.default_rng(n).uniform(size=n)
    thr = M.threshold_for_cost_advantage(scores, ca)
    assert thr == ref_metrics.threshold_for_cost_advantage(scores, ca)
    assert (scores >= thr).mean() <= ca + 1.0 / n + 1e-9


# -------------------------------------------------------------- thresholds
def _cal_problem(rng, n=400):
    gap = rng.normal(-0.3, 0.4, n)
    scores = 1 / (1 + np.exp(-gap * 4))
    q_large = rng.normal(0, 0.05, (n, 4)).astype(np.float32) - 1.0
    q_small = (q_large + gap[:, None]).astype(np.float32)
    return scores, q_small, q_large


THRESHOLD_CALLS = {
    "frontier": lambda m, s, qs, ql: m.calibration_frontier(s, qs, ql),
    "frontier_sample": lambda m, s, qs, ql: m.calibration_frontier(
        s, qs, ql, n_grid=51, sample_idx=1),
    "best_feasible": lambda m, s, qs, ql: [
        m.best_feasible(m.calibration_frontier(s, qs, ql), b)
        for b in (0.0, 1.0, 5.0)],
    "calibrate_threshold": lambda m, s, qs, ql: m.calibrate_threshold(
        s, qs, ql, max_drop_pct=1.0),
    "cascade_thresholds": lambda m, s, qs, ql: [
        m.cascade_thresholds(m.calibration_frontier(s, qs, ql), k, 1.0)
        for k in (2, 3, 4)],
    "evaluate_threshold": lambda m, s, qs, ql: m.evaluate_threshold(
        float(np.median(s)), s, qs, ql),
    "abort_threshold": lambda m, s, qs, ql: [
        m.calibrate_abort_threshold(s, f) for f in (0.0, 0.1, 0.5, 1.0)],
}


@pytest.mark.parametrize("name", list(THRESHOLD_CALLS))
def test_thresholds_equal_reference(name, rng):
    s, qs, ql = _cal_problem(rng)
    _same(THRESHOLD_CALLS[name](T, s, qs, ql),
          THRESHOLD_CALLS[name](ref_thresholds, s, qs, ql))


def test_calibration_respects_drop_budget(rng):
    scores, q_small, q_large = _cal_problem(rng)
    res = T.calibrate_threshold(scores, q_small, q_large, max_drop_pct=1.0)
    assert res.expected_drop_pct <= 1.0 + 1e-6
    assert res.expected_cost_advantage > 0.05
    ev = T.evaluate_threshold(res.threshold, scores, q_small, q_large)
    assert abs(ev["cost_advantage"] - res.expected_cost_advantage) < 1e-6


def test_calibration_zero_budget_stays_all_large(rng):
    n = 100
    scores = rng.uniform(size=n)
    q_large = np.zeros((n, 2), np.float32)
    q_small = np.full((n, 2), -10.0, np.float32)
    res = T.calibrate_threshold(scores, q_small, q_large, max_drop_pct=0.0)
    assert res.expected_cost_advantage == 0.0


def test_abort_threshold_rejects_what_the_reference_rejects():
    for peaks, frac in (([], 0.1), ([0.5], -0.1), ([0.5], 1.5)):
        with pytest.raises(ValueError):
            T.calibrate_abort_threshold(peaks, frac)
        with pytest.raises(ValueError):
            ref_thresholds.calibrate_abort_threshold(peaks, frac)
