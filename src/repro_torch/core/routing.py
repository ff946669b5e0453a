"""Routing policies and tier cost accounting (the port of
``repro.core.routing``, without the fused XLA scoring helper
``route_scores_jit``): ``HybridRouter``, ``RoutingPolicy``, the policies,
``TierMeter`` and its two-tier view ``CostMeter``.

The paper's router is binary: a score threshold splits queries between one
small and one large model. ``RoutingPolicy`` is the protocol the serving
pool consumes: ``decide(tokens, mask) -> (tier_idx, scores)`` with
``tier_idx`` an (N,) int array over an ordered pool of engines, cheapest
(0) to priciest (K-1), and ``scores`` the raw router scores (higher =
easier = cheaper-tier-safe). Besides the paper's binary
``ThresholdPolicy``:

* ``CascadePolicy`` — two modes. Shared-score: K-1 descending thresholds
  over ONE router's scores bucket queries across K tiers, all picked from
  a single ``core.thresholds.calibration_frontier`` sweep
  (``from_frontier``). Per-boundary: K-1 independent calibrated gates
  (``boundaries``), one ``HybridRouter`` per adjacent tier pair; a query
  goes to the cheapest tier whose gate it passes.
* ``QualityTargetPolicy`` — per-tier calibrated score->quality maps
  (``TierQualityMap``, ``fit_quality_map``); each query goes to the
  cheapest tier whose predicted quality clears a runtime-tunable target.

Every policy compares a score with a threshold by ``>=``, as the reference
does, and decides on host numpy scores, so a policy given fixed scores
decides exactly as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.models.encoder import RouterConfig, router_encode


@dataclasses.dataclass
class HybridRouter:
    params: torch.nn.Module         # a RouterEncoder
    rcfg: RouterConfig
    threshold: float
    label_kind: str = "trans"       # det | prob | trans — provenance only

    @torch.no_grad()
    def scores(self, tokens, mask) -> torch.Tensor:
        """Sigmoid router scores (N,) in [0, 1] for a padded query batch
        ``tokens`` (N, L) with validity ``mask`` (N, L), on the router's
        device; higher = easier = safer to serve on a cheaper tier. Runs
        without autograd, so scoring a module fresh from training builds
        no graph."""
        dev = next(self.params.parameters()).device
        tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
        mask = torch.as_tensor(np.asarray(mask, np.float32), device=dev)
        return torch.sigmoid(router_encode(self.params, tokens, mask,
                                           self.rcfg))

    def route(self, tokens, mask) -> torch.Tensor:
        """True where the query goes to the SMALL model ("easy")."""
        return self.scores(tokens, mask) >= self.threshold

    def with_threshold(self, threshold: float) -> "HybridRouter":
        """A copy of this router gating at ``threshold`` (params shared)."""
        return dataclasses.replace(self, threshold=threshold)


@runtime_checkable
class RoutingPolicy(Protocol):
    """Admission-time dispatch over an ordered pool of K model tiers."""

    @property
    def n_tiers(self) -> int: ...

    def decide(self, tokens, mask) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tier_idx (N,) int — 0 = cheapest tier, scores (N,))."""
        ...


@dataclasses.dataclass
class ThresholdPolicy:
    """The paper's binary router as a two-tier policy: tier 0 (cheap) iff
    score >= the wrapped router's threshold."""
    router: HybridRouter

    @property
    def n_tiers(self) -> int:
        return 2

    def decide(self, tokens, mask) -> Tuple[np.ndarray, np.ndarray]:
        scores = _host_scores(self.router, tokens, mask)
        return np.where(scores >= self.router.threshold, 0, 1), scores


@dataclasses.dataclass
class CascadePolicy:
    """K-tier cascade routing, in one of two modes (exactly one is set):

    Shared-score (``thresholds``): K-1 descending thresholds over ONE
    router's scores — tier k takes scores in [t_k, t_{k-1}), tier 0
    everything >= t_0, tier K-1 everything below t_{K-2}. With one
    threshold this is exactly ``ThresholdPolicy``. ``router`` supplies the
    scores; its own threshold is ignored.

    Per-boundary (``boundaries``): K-1 independent gates, one
    ``HybridRouter`` per adjacent tier pair (cheapest pair first), each
    trained on its own pair's quality gap and gating at its own calibrated
    threshold. A query routes to the cheapest tier b whose gate it passes
    (score_b >= boundaries[b].threshold), falling through to tier K-1 when
    every gate refuses. With one head behind every gate and the
    shared-score thresholds installed per gate, the two modes route
    identically.

    Reported ``scores`` are the shared router's in shared-score mode and
    the cheapest gate's in per-boundary mode.
    """
    router: Optional[HybridRouter] = None
    thresholds: Tuple[float, ...] = ()
    boundaries: Tuple[HybridRouter, ...] = ()

    def __post_init__(self):
        self.thresholds = tuple(float(t) for t in self.thresholds)
        self.boundaries = tuple(self.boundaries)
        if self.boundaries:
            if self.thresholds:
                raise ValueError("CascadePolicy takes shared-score "
                                 "thresholds OR per-boundary gates, not "
                                 "both")
            return
        if self.router is None:
            raise ValueError("shared-score CascadePolicy needs the router "
                             "that supplies its scores")
        if not self.thresholds:
            raise ValueError("CascadePolicy needs at least one threshold "
                             "(two tiers)")
        if any(a < b for a, b in zip(self.thresholds, self.thresholds[1:])):
            raise ValueError(f"cascade thresholds must be non-increasing "
                             f"(cheapest tier takes the highest scores): "
                             f"{self.thresholds}")

    @property
    def per_boundary(self) -> bool:
        return bool(self.boundaries)

    @property
    def n_tiers(self) -> int:
        return (len(self.boundaries) if self.boundaries
                else len(self.thresholds)) + 1

    def decide(self, tokens, mask) -> Tuple[np.ndarray, np.ndarray]:
        if self.boundaries:
            # first passing gate, cheapest first: walk the boundaries
            # priciest-first so cheaper gates overwrite — the final value
            # is the smallest b with score_b >= gate b's threshold
            tier = np.full((len(tokens),), len(self.boundaries), np.int64)
            scores0: Optional[np.ndarray] = None
            for b in reversed(range(len(self.boundaries))):
                gate = self.boundaries[b]
                s = _host_scores(gate, tokens, mask)
                tier = np.where(s >= gate.threshold, b, tier)
                if b == 0:
                    scores0 = s
            return tier, scores0
        scores = _host_scores(self.router, tokens, mask)
        tier = np.zeros(scores.shape, np.int64)
        for t in self.thresholds:
            tier += scores < t
        return tier, scores

    @classmethod
    def from_frontier(cls, router: HybridRouter, frontier, n_tiers: int,
                      max_drop_pct: float = 1.0) -> "CascadePolicy":
        """Pick K-1 thresholds from one ``calibration_frontier`` sweep (see
        core.thresholds.cascade_thresholds for the selection rule)."""
        from .thresholds import cascade_thresholds
        return cls(router, tuple(cascade_thresholds(frontier, n_tiers,
                                                    max_drop_pct)))


@dataclasses.dataclass
class TierQualityMap:
    """Piecewise-constant calibrated score -> expected-quality map for one
    tier: quantile score bins over a calibration set, mean quality per bin."""
    bin_edges: np.ndarray   # (n_bins + 1,) ascending score edges
    quality: np.ndarray     # (n_bins,) mean quality inside each bin

    def __call__(self, scores: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.bin_edges, scores, side="right") - 1
        return self.quality[np.clip(idx, 0, len(self.quality) - 1)]


def fit_quality_map(scores: np.ndarray, q_samples: np.ndarray,
                    n_bins: int = 8) -> TierQualityMap:
    """Calibrate one tier's score->quality map on (scores, quality samples).
    Quantile bin edges keep every bin populated on the calibration set;
    ``q_samples`` is (N,) or (N, n_samples) (sample mean used)."""
    q = np.asarray(q_samples, np.float64)
    if q.ndim == 2:
        q = q.mean(axis=1)
    edges = np.unique(np.quantile(scores, np.linspace(0.0, 1.0, n_bins + 1)))
    if len(edges) < 2:   # constant scores: one bin
        edges = np.array([edges[0] - 1e-6, edges[0] + 1e-6])
    idx = np.clip(np.searchsorted(edges, scores, side="right") - 1,
                  0, len(edges) - 2)
    quality = np.full(len(edges) - 1, float(q.mean()))
    for b in range(len(quality)):
        sel = idx == b
        if sel.any():
            quality[b] = float(q[sel].mean())
    return TierQualityMap(edges, quality)


@dataclasses.dataclass
class QualityTargetPolicy:
    """Cheapest tier whose calibrated score->quality map clears ``target`` —
    the paper's "desired quality level" dial, generalized to K tiers and
    tunable at serve time (``set_target``; no retraining, no recalibration).
    Queries no tier clears fall through to the priciest tier."""
    router: HybridRouter
    maps: Sequence[TierQualityMap]   # cheapest -> priciest
    target: float

    def __post_init__(self):
        if len(self.maps) < 2:
            raise ValueError("QualityTargetPolicy needs a map per tier for "
                             "at least two tiers")

    @property
    def n_tiers(self) -> int:
        return len(self.maps)

    def set_target(self, target: float):
        self.target = float(target)

    def predicted_quality(self, scores: np.ndarray) -> np.ndarray:
        """(K, N) calibrated quality prediction per tier."""
        return np.stack([m(scores) for m in self.maps])

    def decide(self, tokens, mask) -> Tuple[np.ndarray, np.ndarray]:
        scores = _host_scores(self.router, tokens, mask)
        ok = self.predicted_quality(scores) >= self.target
        tier = np.where(ok.any(axis=0), ok.argmax(axis=0), self.n_tiers - 1)
        return tier.astype(np.int64), scores

    @classmethod
    def fit(cls, router: HybridRouter, scores: np.ndarray,
            tier_qualities: Sequence[np.ndarray], target: float,
            n_bins: int = 8) -> "QualityTargetPolicy":
        """Calibrate per-tier maps from one calibration set: ``scores`` (N,)
        and ``tier_qualities`` [(N,) or (N, S)] cheapest -> priciest."""
        return cls(router, [fit_quality_map(scores, q, n_bins)
                            for q in tier_qualities], float(target))


def _host_scores(router, tokens, mask) -> np.ndarray:
    """``router.scores`` as a host numpy array (a ``HybridRouter`` returns a
    tensor on its device; a stand-in may return numpy)."""
    s = router.scores(tokens, mask)
    if isinstance(s, torch.Tensor):
        s = s.cpu().numpy()
    return np.asarray(s)


class TierMeter:
    """Per-tier serving cost accounting against the all-priciest baseline.

    Tiers are named cheapest -> priciest. §2.3's cost advantage generalizes
    as the traffic the priciest tier did NOT serve: calls-weighted
    (fraction of requests) and token-weighted (fraction of generated
    tokens — §2.3 charges generated tokens). For K=2 both reduce to the
    paper's "fraction routed to the small model".

    Side columns, each an (n_tiers,) array attribute:

    * ``sheds``: requests load-shed ("rejected") on their tier. Not calls:
      they consumed no service. ``deadline_misses`` are calls that also
      missed; ``preemptions`` and ``reprefill_tokens`` the recompute cost
      of evictions (``record_shed``, ``record_robustness``).
    * ``escalations`` and ``esc_tokens``: streams that left the tier
      mid-decode for the one above, and the tokens they emitted here,
      which also bill to this tier's ``tokens`` (``record_escalation``).
      The call lands once, at the tier that finishes the request, so the
      calls-weighted advantage stays undiluted while the token split is
      honest.
    * ``drafted``, ``accepted``, ``rejected``: speculative decoding's
      columns, zero until that slice is ported.
    """

    _SIDE = ("sheds", "deadline_misses", "preemptions", "reprefill_tokens",
             "drafted", "accepted", "rejected", "escalations", "esc_tokens")

    def __init__(self, names: Sequence[str]):
        if len(names) < 2:
            raise ValueError("a tier meter needs at least two tiers")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {tuple(names)}")
        self.names: Tuple[str, ...] = tuple(names)
        self.calls = np.zeros(len(self.names), np.int64)
        self.tokens = np.zeros(len(self.names), np.int64)
        for k in self._SIDE:
            setattr(self, k, np.zeros(len(self.names), np.int64))

    @property
    def n_tiers(self) -> int:
        return len(self.names)

    def record(self, tier_idx: np.ndarray, gen_tokens):
        """Record a batch of served requests. ``gen_tokens`` is the number
        of tokens each request actually generated: a per-request array
        aligned with ``tier_idx``, or a scalar applied to every request."""
        tier = np.asarray(tier_idx, np.int64).reshape(-1)
        if tier.size and (tier.min() < 0 or tier.max() >= self.n_tiers):
            raise ValueError(f"tier index out of range for {self.names}: "
                             f"{tier}")
        lens = np.broadcast_to(np.asarray(gen_tokens, np.int64), tier.shape)
        self.calls += np.bincount(tier, minlength=self.n_tiers)
        self.tokens += np.bincount(tier, weights=lens,
                                   minlength=self.n_tiers).astype(np.int64)

    def _check_tier(self, tier: int) -> int:
        tier = int(tier)
        if not 0 <= tier < self.n_tiers:
            raise ValueError(f"tier index out of range for {self.names}: "
                             f"{tier}")
        return tier

    def record_shed(self, tier_idx: int):
        """Record one load-shed request on its assigned tier (no call)."""
        self.sheds[self._check_tier(tier_idx)] += 1

    def record_robustness(self, tier_idx: int, preemptions: int = 0,
                          reprefill_tokens: int = 0,
                          deadline_miss: bool = False):
        """Fold one served request's robustness tallies into its tier, at
        retirement beside ``record``."""
        t = self._check_tier(tier_idx)
        self.preemptions[t] += preemptions
        self.reprefill_tokens[t] += reprefill_tokens
        if deadline_miss:
            self.deadline_misses[t] += 1

    def record_escalation(self, from_tier: int, gen_tokens: int):
        """Record one stream leaving ``from_tier`` mid-decode after
        emitting ``gen_tokens`` tokens there since its last hand-off: they
        bill to that tier's tokens now, and no call is recorded (the call
        lands at the final tier, whose ``record`` subtracts these)."""
        t = self._check_tier(from_tier)
        if t == self.n_tiers - 1:
            raise ValueError(f"cannot escalate off the priciest tier "
                             f"{self.names[-1]!r}: there is nothing above")
        if gen_tokens < 0:
            raise ValueError(f"negative escalated token count {gen_tokens}")
        self.escalations[t] += 1
        self.esc_tokens[t] += int(gen_tokens)
        self.tokens[t] += int(gen_tokens)

    def reset(self):
        """Zero the counters — e.g. after a warmup pass."""
        self.calls[:] = 0
        self.tokens[:] = 0
        for k in self._SIDE:
            getattr(self, k)[:] = 0

    @property
    def total_calls(self) -> int:
        return int(self.calls.sum())

    @property
    def total_tokens(self) -> int:
        return int(self.tokens.sum())

    @property
    def cost_advantage(self) -> float:
        """Calls-weighted: fraction of requests the priciest tier never saw."""
        total = self.total_calls
        return 1.0 - int(self.calls[-1]) / total if total else 0.0

    @property
    def token_cost_advantage(self) -> float:
        """Token-weighted: fraction of generated tokens produced off the
        priciest tier."""
        total = self.total_tokens
        return 1.0 - int(self.tokens[-1]) / total if total else 0.0

    def summary(self) -> Dict[str, dict]:
        """Per-tier calls/tokens plus the side columns, keyed by tier name
        (cheapest first) — the reference's ``TierMeter.summary`` layout."""
        return {name: {"calls": int(self.calls[t]),
                       "gen_tokens": int(self.tokens[t]),
                       **{k: int(getattr(self, k)[t]) for k in self._SIDE}}
                for t, name in enumerate(self.names)}


class CostMeter:
    """Two-tier facade over ``TierMeter`` keeping the paper's small/large
    vocabulary (§2.3). Pass an existing meter to expose a live view of it
    (the continuous hybrid facade shares its pool's meter this way)."""

    def __init__(self, tier_meter: Optional[TierMeter] = None):
        self._m = tier_meter if tier_meter is not None \
            else TierMeter(("small", "large"))
        if self._m.n_tiers != 2:
            raise ValueError(f"CostMeter is the two-tier view; got "
                             f"{self._m.n_tiers} tiers {self._m.names}")

    @property
    def tiers(self) -> TierMeter:
        """The underlying two-tier meter (cheapest first)."""
        return self._m

    def record(self, routed_small: np.ndarray, gen_tokens):
        """Record a batch of routed requests (see ``TierMeter.record`` for
        the ``gen_tokens`` contract)."""
        routed = np.asarray(routed_small, bool)
        self._m.record(np.where(routed, 0, 1), gen_tokens)

    @property
    def to_small(self) -> int:
        return int(self._m.calls[0])

    @property
    def to_large(self) -> int:
        return int(self._m.calls[1])

    @property
    def small_tokens(self) -> int:
        return int(self._m.tokens[0])

    @property
    def large_tokens(self) -> int:
        return int(self._m.tokens[1])

    @property
    def cost_advantage(self) -> float:
        return self._m.cost_advantage

    @property
    def token_cost_advantage(self) -> float:
        return self._m.token_cost_advantage
