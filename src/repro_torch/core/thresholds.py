"""Empirical routing-threshold calibration (paper §4.5): a copy of
``repro.core.thresholds`` (numpy only).

Given router scores + quality samples on a small calibration set, sweep the
score threshold once (``calibration_frontier``) and read answers off the
resulting (threshold, cost_advantage, drop_pct) frontier:

* ``calibrate_threshold`` — the paper's scalar answer: the threshold that
  maximises cost advantage subject to a performance-drop budget (the paper
  uses 500 validation samples and a <=1% drop budget, then shows the chosen
  threshold generalises to test).
* ``cascade_thresholds`` — K-1 descending thresholds for a K-tier
  ``CascadePolicy``, all picked from the same single sweep: the strictest
  one is the scalar answer (only queries safe for the cheapest tier), and
  the remaining off-priciest mass is split evenly across the middle tiers
  along the frontier's cost-advantage axis.
* ``calibrate_abort_threshold`` — the serve-time escalation dial: from an
  observe-only pass's per-stream peak uncertainty scores, the threshold
  at which at most ``max_escalate_frac`` of comparable streams abort
  mid-decode and re-admit one tier up (serving.engine.EscalationMonitor).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .metrics import mixture_quality, perf_drop_pct


@dataclasses.dataclass
class CalibrationResult:
    threshold: float
    expected_cost_advantage: float
    expected_drop_pct: float


@dataclasses.dataclass
class FrontierPoint:
    """One candidate threshold's operating point on the calibration set."""
    threshold: float
    cost_advantage: float
    drop_pct: float
    quality: float


def calibration_frontier(scores: np.ndarray, q_small: np.ndarray,
                         q_large: np.ndarray, n_grid: int = 201,
                         sample_idx: int | None = None) -> List[FrontierPoint]:
    """One grid sweep over candidate thresholds (score quantiles plus the
    open ends), ascending in threshold — so cost advantage is non-increasing
    along the list. Every downstream calibration question (scalar threshold,
    cascade thresholds, feasibility at a drop budget) reads off this."""
    q_all_large = float(q_large.mean(axis=1).mean()
                        if sample_idx is None else
                        q_large[:, sample_idx].mean())
    cands = np.quantile(scores, np.linspace(0.0, 1.0, n_grid))
    cands = np.concatenate([[scores.min() - 1e-6], cands,
                            [scores.max() + 1e-6]])
    pts = []
    for thr in np.unique(cands):
        qm, ca = mixture_quality(scores, float(thr), q_small, q_large,
                                 sample_idx)
        pts.append(FrontierPoint(float(thr), ca, perf_drop_pct(qm, q_all_large),
                                 qm))
    return pts


def best_feasible(frontier: List[FrontierPoint],
                  max_drop_pct: float) -> CalibrationResult:
    """Max cost advantage subject to the drop budget; all-large (the last,
    empty-mixture point) when nothing is feasible."""
    best = CalibrationResult(frontier[-1].threshold, 0.0, 0.0)
    for p in frontier:
        if p.drop_pct <= max_drop_pct \
                and p.cost_advantage > best.expected_cost_advantage:
            best = CalibrationResult(p.threshold, p.cost_advantage, p.drop_pct)
    return best


def calibrate_threshold(scores: np.ndarray, q_small: np.ndarray,
                        q_large: np.ndarray, max_drop_pct: float = 1.0,
                        n_grid: int = 201,
                        sample_idx: int | None = None) -> CalibrationResult:
    """Grid-search the score threshold (paper: grid search on 500 samples).
    Wrapper over ``calibration_frontier`` + ``best_feasible``."""
    return best_feasible(calibration_frontier(scores, q_small, q_large,
                                              n_grid, sample_idx),
                         max_drop_pct)


def cascade_thresholds(frontier: List[FrontierPoint], n_tiers: int,
                       max_drop_pct: float = 1.0) -> List[float]:
    """K-1 non-increasing thresholds for a K-tier cascade, from ONE sweep.

    t_0 (the cheapest tier's gate) is the scalar calibration answer at the
    drop budget — the frontier point routing the largest feasible fraction
    ca* past the priciest model when only the cheapest alternative exists.
    The middle gates t_1..t_{K-2} split the remaining (1 - ca*) mass evenly
    along the frontier's cost-advantage axis: t_i is the candidate whose
    cost advantage is closest to ca* + (1 - ca*) * i / (K - 1), so each
    middle tier absorbs an equal share of the queries too hard for the
    tiers below it. K=2 reduces exactly to ``calibrate_threshold``.
    """
    if n_tiers < 2:
        raise ValueError(f"a cascade needs at least two tiers, got {n_tiers}")
    best = best_feasible(frontier, max_drop_pct)
    if best.expected_cost_advantage == 0.0:
        # nothing feasible: no tier below the priciest has a bounded drop,
        # so every gate closes — splitting the mass across middle tiers
        # here would route unvalidated traffic cheap precisely when the
        # budget is at its strictest
        return [best.threshold] * (n_tiers - 1)
    ts = [best.threshold]
    cas = np.array([p.cost_advantage for p in frontier])
    for i in range(1, n_tiers - 1):
        level = best.expected_cost_advantage \
            + (1.0 - best.expected_cost_advantage) * i / (n_tiers - 1)
        t = frontier[int(np.abs(cas - level).argmin())].threshold
        ts.append(min(ts[-1], t))   # keep non-increasing under grid ties
    return ts


def calibrate_abort_threshold(peak_scores, max_escalate_frac: float) -> float:
    """The mid-stream escalation dial's calibration contract.

    ``peak_scores`` are per-stream PEAK running uncertainty scores from an
    observe-only pass (``EscalationMonitor(abort_threshold=None)`` — the
    monitor tracks each stream's EMA-smoothed entropy/margin score without
    aborting anyone, and the peak lands in ``Request.esc_peak_score``).
    Returns the abort threshold at which a fraction ``max_escalate_frac``
    of comparable streams would have crossed mid-decode: the
    (1 - max_escalate_frac) quantile of the observed peaks. A stream
    escalates when its running score reaches the threshold, so escalation
    volume — the extra prefill cost paid on the tier above — is budgeted
    the same way the routing thresholds budget quality drop.
    ``max_escalate_frac=0`` returns a threshold strictly above every
    observed peak (escalation effectively off); ``1`` returns the minimum
    peak (every comparable stream escalates)."""
    peaks = np.asarray(peak_scores, np.float64).reshape(-1)
    if peaks.size == 0:
        raise ValueError("abort-threshold calibration needs at least one "
                         "observed stream peak")
    if not 0.0 <= max_escalate_frac <= 1.0:
        raise ValueError(f"max_escalate_frac={max_escalate_frac}: the "
                         "escalation budget is a fraction in [0, 1]")
    if max_escalate_frac == 0.0:
        return float(peaks.max()) + 1e-6
    return float(np.quantile(peaks, 1.0 - max_escalate_frac))


def evaluate_threshold(threshold: float, scores: np.ndarray,
                       q_small: np.ndarray, q_large: np.ndarray,
                       sample_idx: int | None = None) -> dict:
    """Apply a calibrated threshold to a (test) set — Table 3 columns."""
    q_all_large = float(q_large.mean(axis=1).mean()
                        if sample_idx is None else
                        q_large[:, sample_idx].mean())
    qm, ca = mixture_quality(scores, threshold, q_small, q_large, sample_idx)
    return {"cost_advantage": ca, "drop_pct": perf_drop_pct(qm, q_all_large),
            "quality": qm}
