"""Routing policies and tier cost accounting (the port of
``repro.core.routing``: ``HybridRouter``, ``RoutingPolicy``,
``ThresholdPolicy``, ``TierMeter`` and its two-tier view ``CostMeter``).

The paper's router is binary: a score threshold splits queries between one
small and one large model. ``RoutingPolicy`` is the protocol the serving
pool consumes: ``decide(tokens, mask) -> (tier_idx, scores)`` with
``tier_idx`` an (N,) int array over an ordered pool of engines, cheapest
(0) to priciest (K-1), and ``scores`` the raw router scores (higher =
easier = cheaper-tier-safe). ``CascadePolicy`` and ``QualityTargetPolicy``
come with a later slice.
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

    def scores(self, tokens, mask) -> torch.Tensor:
        """Sigmoid router scores (N,) in [0, 1] for a padded query batch
        ``tokens`` (N, L) with validity ``mask`` (N, L), on the router's
        device; higher = easier = safer to serve on a cheaper tier."""
        dev = next(self.params.parameters()).device
        tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
        mask = torch.as_tensor(np.asarray(mask, np.float32), device=dev)
        return torch.sigmoid(router_encode(self.params, tokens, mask,
                                           self.rcfg))

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
        scores = self.router.scores(tokens, mask).cpu().numpy()
        return np.where(scores >= self.router.threshold, 0, 1), scores


class TierMeter:
    """Per-tier serving cost accounting against the all-priciest baseline.

    Tiers are named cheapest -> priciest. §2.3's cost advantage generalizes
    as the traffic the priciest tier did NOT serve: calls-weighted
    (fraction of requests) and token-weighted (fraction of generated
    tokens — §2.3 charges generated tokens). For K=2 both reduce to the
    paper's "fraction routed to the small model".

    ``summary`` reports the reference's full column set. The robustness,
    speculative and escalation columns stay zero until the slices that
    record them are ported.
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
        self.side = {k: np.zeros(len(self.names), np.int64)
                     for k in self._SIDE}

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

    def reset(self):
        """Zero the counters — e.g. after a warmup pass."""
        self.calls[:] = 0
        self.tokens[:] = 0
        for v in self.side.values():
            v[:] = 0

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
                       **{k: int(v[t]) for k, v in self.side.items()}}
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
