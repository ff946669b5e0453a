"""Router training labels (paper §3.1–3.3): a copy of
``repro.core.labels`` (numpy only).

Given per-query response-quality samples from the small and large models,
builds the three label families:

  y_det      = 1[q(S(x)) >= q(L(x))]                          (Eq. 1 labels)
  y_prob     = Pr[H(x) >= 0],  H = q(S(x)) - q(L(x))          (Eq. 2 labels)
  y_trans(t) = Pr[H(x) >= -t]                                  (§3.3 labels)

and the data-transformation relaxation t* (Eq. 3):

  t* = argmax_t (1/N^2) sum_{i,i'} | y_i(t) - y_{i'}(t) |

The probability is estimated from samples; the paper draws 10 responses per
model. With independent sample sets {s_a}, {l_b} the natural estimator of
Pr[q(S) >= q(L) - t] is the all-pairs mean (a U-statistic); ``paired=True``
reproduces the weaker matched-index estimator instead.
"""
from __future__ import annotations

import numpy as np


def quality_gap_samples(q_small: np.ndarray, q_large: np.ndarray) -> np.ndarray:
    """All-pairs H samples. q_small: (N, a); q_large: (N, b) -> (N, a*b)."""
    return (q_small[:, :, None] - q_large[:, None, :]).reshape(len(q_small), -1)


def det_labels(q_small: np.ndarray, q_large: np.ndarray,
               sample_idx: int = 0) -> np.ndarray:
    """Deterministic labels from a single response per model (Eq. 1)."""
    return (q_small[:, sample_idx] >= q_large[:, sample_idx]).astype(np.float32)


def prob_labels(q_small: np.ndarray, q_large: np.ndarray, t: float = 0.0,
                paired: bool = False) -> np.ndarray:
    """Soft labels Pr[H(x) >= -t] (Eq. 2 for t=0; §3.3 for t>0)."""
    if paired:
        n = min(q_small.shape[1], q_large.shape[1])
        h = q_small[:, :n] - q_large[:, :n]
        return (h >= -t).mean(axis=1).astype(np.float32)
    h = quality_gap_samples(q_small, q_large)
    return (h >= -t).mean(axis=1).astype(np.float32)


def mean_abs_pairwise_diff(y: np.ndarray) -> float:
    """(1/N^2) sum_{i,i'} |y_i - y_{i'}| in O(N log N) via the sorted identity
    sum_{i<j} (y_(j) - y_(i)) = sum_j (2j + 1 - N) y_(j)."""
    n = len(y)
    if n < 2:
        return 0.0
    ys = np.sort(y.astype(np.float64))
    coef = 2.0 * np.arange(n) + 1.0 - n
    return float(2.0 * np.sum(coef * ys) / (n * n))


def transform_objective(q_small: np.ndarray, q_large: np.ndarray,
                        ts: np.ndarray, paired: bool = False) -> np.ndarray:
    """Eq. 3 objective for each candidate t."""
    return np.array([mean_abs_pairwise_diff(prob_labels(q_small, q_large, t,
                                                        paired=paired))
                     for t in ts])


def default_t_grid(q_small: np.ndarray, q_large: np.ndarray,
                   n: int = 41) -> np.ndarray:
    """Grid over the support of -H: 0 .. max(q_large - q_small) quantiles."""
    h = quality_gap_samples(q_small, q_large)
    hi = max(1e-6, float(np.quantile(-h, 0.99)))
    return np.linspace(0.0, hi, n)


def optimal_transform(q_small: np.ndarray, q_large: np.ndarray,
                      ts: np.ndarray | None = None, paired: bool = False):
    """Grid-search t* (Eq. 3). Returns (t_star, objective_values, ts)."""
    if ts is None:
        ts = default_t_grid(q_small, q_large)
    obj = transform_objective(q_small, q_large, ts, paired=paired)
    return float(ts[int(np.argmax(obj))]), obj, ts


def trans_labels(q_small: np.ndarray, q_large: np.ndarray,
                 ts: np.ndarray | None = None, paired: bool = False):
    """y_trans(t*) labels (§3.3). Returns (labels, t_star)."""
    t_star, _, _ = optimal_transform(q_small, q_large, ts, paired=paired)
    return prob_labels(q_small, q_large, t_star, paired=paired), t_star
