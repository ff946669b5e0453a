"""Routing evaluation metrics (paper §2.3, §4): a copy of
``repro.core.metrics`` (numpy only).

Conventions:
  * ``scores``: router score per query, higher = easier = route to SMALL.
  * ``q_small`` / ``q_large``: (N, n_samples) quality samples per query; the
    evaluation quality of a query under a model is the sample mean (the
    paper evaluates one sampled response; the mean is the low-variance
    version — ``sample_idx`` selects single-sample evaluation instead).
  * cost advantage = fraction routed to the small model (§2.3).
  * performance drop % = (Q_all_large - Q_mix) / |Q_all_large| * 100.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _q(q_samples: np.ndarray, sample_idx: int | None) -> np.ndarray:
    if sample_idx is None:
        return q_samples.mean(axis=1)
    return q_samples[:, sample_idx]


def mixture_quality(scores: np.ndarray, threshold: float, q_small, q_large,
                    sample_idx: int | None = None) -> tuple[float, float]:
    """Returns (mean quality of routed mixture, cost advantage)."""
    to_small = scores >= threshold
    qs, ql = _q(q_small, sample_idx), _q(q_large, sample_idx)
    q = np.where(to_small, qs, ql)
    return float(q.mean()), float(to_small.mean())


def perf_drop_pct(q_mix: float, q_all_large: float) -> float:
    return 100.0 * (q_all_large - q_mix) / max(abs(q_all_large), 1e-9)


def threshold_for_cost_advantage(scores: np.ndarray, cost_adv: float) -> float:
    """Threshold routing exactly `cost_adv` fraction to the small model."""
    if cost_adv <= 0:
        return float(np.max(scores)) + 1.0
    if cost_adv >= 1:
        return float(np.min(scores)) - 1.0
    return float(np.quantile(scores, 1.0 - cost_adv, method="higher"))


@dataclasses.dataclass
class CurvePoint:
    cost_advantage: float
    quality: float
    drop_pct: float
    threshold: float


def error_cost_curve(scores: np.ndarray, q_small, q_large,
                     n_points: int = 51,
                     sample_idx: int | None = None) -> list[CurvePoint]:
    """Fig-5 style tradeoff curve: quality drop vs cost advantage."""
    ql = _q(q_large, sample_idx)
    q_all_large = float(ql.mean())
    pts = []
    for ca in np.linspace(0.0, 1.0, n_points):
        thr = threshold_for_cost_advantage(scores, ca)
        qm, ca_actual = mixture_quality(scores, thr, q_small, q_large,
                                        sample_idx)
        pts.append(CurvePoint(ca_actual, qm, perf_drop_pct(qm, q_all_large),
                              thr))
    return pts


def drop_at_cost_advantages(scores, q_small, q_large, cost_advs=(0.1, 0.2, 0.4),
                            sample_idx: int | None = None) -> dict:
    """Table-1 style: perf drop % at fixed cost advantages."""
    ql = _q(q_large, sample_idx)
    q_all_large = float(ql.mean())
    out = {}
    for ca in cost_advs:
        thr = threshold_for_cost_advantage(scores, ca)
        qm, ca_act = mixture_quality(scores, thr, q_small, q_large, sample_idx)
        out[ca] = dict(drop_pct=perf_drop_pct(qm, q_all_large),
                       cost_advantage=ca_act, threshold=thr)
    return out


def random_routing_curve(rng: np.random.Generator, n_queries: int, q_small,
                         q_large, n_points: int = 51,
                         sample_idx: int | None = None) -> list[CurvePoint]:
    """The paper's `random` baseline."""
    scores = rng.uniform(size=n_queries)
    return error_cost_curve(scores, q_small, q_large, n_points, sample_idx)


def quality_gap_difference(scores: np.ndarray, q_small, q_large,
                           cost_adv: float) -> float:
    """Fig-6 validation: avg H(x) of queries routed to small minus avg H(x)
    of queries routed to large. Positive = router sends easy queries small."""
    gap = q_small.mean(axis=1) - q_large.mean(axis=1)
    thr = threshold_for_cost_advantage(scores, cost_adv)
    to_small = scores >= thr
    if to_small.all() or (~to_small).all():
        return 0.0
    return float(gap[to_small].mean() - gap[~to_small].mean())


# ------------------------------------------------------------ correlations
def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / max(denom, 1e-12))


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return pearson(ra, rb)
