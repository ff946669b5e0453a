"""Continuous model-pool serving: K tiers, one admission-time policy (the
port of ``repro.serving.pool.ContinuousPoolEngine``, without speculation
or escalation).

``ContinuousPoolEngine`` runs an ordered pool of named
``ContinuousEngine``s (cheapest -> priciest) under a ``RoutingPolicy``: each
submitted query is scored once at admission and enqueued on the engine of
its tier; every engine steps independently, so a cheap tier's requests
admit, decode and retire while pricier tiers are still in flight — the
paper's edge/cloud split generalized to K tiers. ``TierMeter`` does the
§2.3 accounting: per-tier calls and generated tokens against the
all-priciest baseline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.routing import RoutingPolicy, TierMeter
from repro_torch.data import tokenizer as tok
from .engine import ContinuousEngine
from .scheduler import Request

Engines = Union[Mapping[str, ContinuousEngine],
                Sequence[Tuple[str, ContinuousEngine]]]


@dataclasses.dataclass
class PoolResult:
    """Batch-API result: responses/lengths row-aligned with the submitted
    queries, ``tier_idx`` the policy's dispatch (0 = cheapest tier)."""
    responses: np.ndarray   # (N, T)
    lengths: np.ndarray     # (N,)
    tier_idx: np.ndarray    # (N,) int
    scores: np.ndarray      # (N,)


class ContinuousPoolEngine:
    """Admission-time policy-routed serving over K independently stepping
    continuous engines. No tier's stream ever barriers on another."""

    def __init__(self, policy: RoutingPolicy, engines: Engines):
        items = list(engines.items()) if isinstance(engines, Mapping) \
            else list(engines)
        if len(items) != policy.n_tiers:
            raise ValueError(f"policy routes over {policy.n_tiers} tiers but "
                             f"the pool has {len(items)} engines: "
                             f"{[n for n, _ in items]}")
        self.policy = policy
        self.names: Tuple[str, ...] = tuple(n for n, _ in items)
        self.engines: List[ContinuousEngine] = [e for _, e in items]
        # every engine starts on salt 0; distinct salts keep their
        # temperature>0 sample streams uncorrelated (a tier aliasing
        # another's engine is bumped once)
        seen_salts: set = set()
        for eng in self._distinct_engines():
            if eng._rng_salt in seen_salts:
                eng.set_rng_salt(max(seen_salts) + 1)
            seen_salts.add(eng._rng_salt)
        self.meter = TierMeter(self.names)
        self._tier_of: Dict[int, int] = {}   # rid -> tier idx

    @property
    def n_tiers(self) -> int:
        return len(self.engines)

    def engine(self, name: str) -> ContinuousEngine:
        return self.engines[self.names.index(name)]

    @property
    def has_work(self) -> bool:
        return any(e.sched.has_work for e in self.engines)

    def submit(self, query_tokens: np.ndarray, query_mask: np.ndarray,
               max_new_tokens: Optional[np.ndarray] = None,
               temperature: Optional[Union[float, np.ndarray]] = None
               ) -> Tuple[List[Request], np.ndarray, np.ndarray]:
        """Score and enqueue a batch of queries. Returns (requests,
        tier_idx, scores); requests retire later via step()/run(). Each
        row's PAD tail (from ``query_mask``) is dropped before enqueueing:
        paged prefill only pays for real tokens.

        ``max_new_tokens``: optional per-request output caps (N,).
        ``temperature``: per-request sampling temperatures, a scalar for
        the whole batch or an (N,) array (None = each engine's default,
        0 = greedy)."""
        tier_idx, scores = self.policy.decide(query_tokens, query_mask)
        tier_idx = np.asarray(tier_idx, np.int64)
        if tier_idx.size and (tier_idx.min() < 0
                              or tier_idx.max() >= self.n_tiers):
            raise ValueError(f"policy returned tier indices outside "
                             f"[0, {self.n_tiers}): {np.unique(tier_idx)}")
        reqs = []
        for i, (row, tier) in enumerate(zip(query_tokens, tier_idx)):
            # one past the last true mask position: a mask with interior
            # holes must not drop real prompt tokens
            nz = np.flatnonzero(np.asarray(query_mask[i]))
            row = row[:int(nz[-1]) + 1] if len(nz) else row[:1]
            cap = None if max_new_tokens is None else int(max_new_tokens[i])
            temp = None if temperature is None else float(
                temperature[i] if np.ndim(temperature) else temperature)
            req = self.engines[int(tier)].submit(row, max_new_tokens=cap,
                                                 temperature=temp)
            self._tier_of[req.rid] = int(tier)
            reqs.append(req)
        return reqs, tier_idx, scores

    def submit_to(self, tier: Union[int, str], tokens: np.ndarray,
                  max_new_tokens: Optional[int] = None, *,
                  temperature: Optional[float] = None) -> Request:
        """Enqueue one request on a named (or indexed) tier, bypassing the
        routing policy (targeted bursts, health probes). Accounting is
        that of policy-routed traffic."""
        t = self.names.index(tier) if isinstance(tier, str) else int(tier)
        if not 0 <= t < self.n_tiers:
            raise ValueError(f"tier {tier!r} not in pool {self.names}")
        req = self.engines[t].submit(tokens, max_new_tokens=max_new_tokens,
                                     temperature=temperature)
        self._tier_of[req.rid] = t
        return req

    def _account(self, retired: List[Request]):
        for req in retired:
            # pop: the registry must not grow for the life of the process
            tier = self._tier_of.pop(req.rid)
            self.meter.record(np.array([tier]), req.n_generated)

    def _distinct_engines(self) -> List[ContinuousEngine]:
        """Engines deduped by identity, cheapest tier first: a tier may
        alias another's engine, which must still step (and reseed) once."""
        out: List[ContinuousEngine] = []
        for eng in self.engines:
            if not any(eng is e for e in out):
                out.append(eng)
        return out

    def step(self) -> List[Request]:
        """Advance every engine with work by one step (see
        ContinuousEngine.step), cheapest tier first, with no cross-engine
        join. Returns the requests retired this step."""
        retired: List[Request] = []
        for eng in self._distinct_engines():
            if eng.sched.has_work:
                retired.extend(eng.step())
        self._account(retired)
        return retired

    def run(self) -> List[Request]:
        done: List[Request] = []
        while self.has_work:
            done.extend(self.step())
        return done

    def serve(self, query_tokens: np.ndarray, query_mask: np.ndarray,
              seed: int = 0) -> PoolResult:
        """Batch API: submit every row, drain, join the results."""
        for eng in self._distinct_engines():
            eng.reseed(seed)
        reqs, tier_idx, scores = self.submit(query_tokens, query_mask)
        self.run()
        T = max(e.max_new_tokens for e in self.engines)
        N = len(reqs)
        responses = np.full((N, T), tok.PAD, np.int32)
        lengths = np.zeros((N,), np.int32)
        for i, req in enumerate(reqs):
            lengths[i] = req.n_generated
            responses[i, :req.n_generated] = req.out[:T]
        return PoolResult(responses, lengths, tier_idx, scores)
