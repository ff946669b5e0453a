"""Continuous model-pool serving: K tiers, one admission-time policy (the
port of ``repro.serving.pool.ContinuousPoolEngine``, without speculation).

``ContinuousPoolEngine`` runs an ordered pool of named
``ContinuousEngine``s (cheapest -> priciest) under a ``RoutingPolicy``: each
submitted query is scored once at admission and enqueued on the engine of
its tier; every engine steps independently, so a cheap tier's requests
admit, decode and retire while pricier tiers are still in flight — the
paper's edge/cloud split generalized to K tiers. ``TierMeter`` does the
§2.3 accounting: per-tier calls and generated tokens against the
all-priciest baseline, with sheds, deadline misses and preemptions beside
them.

With ``escalation`` monitors (``serving.engine.EscalationMonitor``, one per
boundary) routing stops being final: a monitored tier cancels a stream
whose smoothed uncertainty crosses its threshold, and the pool re-admits
it ONE TIER UP as one chunked prefill of prompt + emitted tokens. The
meter splits the tokens across the tiers that emitted them; the call
lands once, at the tier that finishes the request.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.routing import RoutingPolicy, TierMeter
from repro_torch.data import tokenizer as tok
from .engine import ContinuousEngine, EscalationMonitor
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

    def __init__(self, policy: RoutingPolicy, engines: Engines, *,
                 escalation: Optional[
                     Sequence[Optional[EscalationMonitor]]] = None):
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
        # one optional monitor per boundary (K-1, cheapest first: the
        # priciest tier has nothing above it). A monitor is engine state,
        # so one on a tier whose engine another tier shares would watch
        # both: refused
        if escalation is not None:
            if len(escalation) != self.n_tiers - 1:
                raise ValueError(
                    f"a {self.n_tiers}-tier pool has {self.n_tiers - 1} "
                    f"escalation boundaries, got {len(escalation)} monitors")
            for t, mon in enumerate(escalation):
                if mon is None:
                    continue
                if any(self.engines[t] is e for i, e in enumerate(self.engines)
                       if i != t):
                    raise ValueError(
                        f"tier {self.names[t]!r} shares its engine with "
                        "another tier; an escalation monitor there would "
                        "watch both")
                self.engines[t].escalation = mon
        # rid -> tokens already billed to lower tiers at hand-offs, and the
        # log of every hand-off: (rid, from_tier, to_tier, n_generated)
        self._esc_billed: Dict[int, int] = {}
        self.escalation_log: List[Tuple[int, int, int, int]] = []

    @property
    def n_tiers(self) -> int:
        return len(self.engines)

    def engine(self, name: str) -> ContinuousEngine:
        return self.engines[self.names.index(name)]

    @property
    def has_work(self) -> bool:
        # a shed request still needs one step to reach the meter, and a
        # stream awaiting its hand-off holds no scheduler entry
        return any(e.sched.has_work or e._shed_buf or e._escalated_buf
                   for e in self.engines)

    def submit(self, query_tokens: np.ndarray, query_mask: np.ndarray,
               max_new_tokens: Optional[np.ndarray] = None,
               temperature: Optional[Union[float, np.ndarray]] = None, *,
               priority: int = 0, deadline_s: Optional[float] = None,
               timeout_s: Optional[float] = None
               ) -> Tuple[List[Request], np.ndarray, np.ndarray]:
        """Score and enqueue a batch of queries. Returns (requests,
        tier_idx, scores); requests retire later via step()/run(), shed
        ones ("rejected") come back done and reach the meter at the next
        step. Each row's PAD tail (from ``query_mask``) is dropped before
        enqueueing: paged prefill only pays for real tokens.

        ``max_new_tokens``: optional per-request output caps (N,).
        ``temperature``: per-request sampling temperatures, a scalar for
        the whole batch or an (N,) array (None = each engine's default,
        0 = greedy). ``priority``, ``deadline_s`` and ``timeout_s`` apply
        to the whole batch (``ContinuousEngine.submit``)."""
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
            req = self.engines[int(tier)].submit(
                row, max_new_tokens=cap, priority=priority,
                deadline_s=deadline_s, timeout_s=timeout_s, temperature=temp)
            self._tier_of[req.rid] = int(tier)
            reqs.append(req)
        return reqs, tier_idx, scores

    def submit_to(self, tier: Union[int, str], tokens: np.ndarray,
                  max_new_tokens: Optional[int] = None, *,
                  priority: int = 0, deadline_s: Optional[float] = None,
                  timeout_s: Optional[float] = None,
                  temperature: Optional[float] = None) -> Request:
        """Enqueue one request on a named (or indexed) tier, bypassing the
        routing policy (targeted bursts, health probes, fault injection).
        Accounting is that of policy-routed traffic."""
        t = self.names.index(tier) if isinstance(tier, str) else int(tier)
        if not 0 <= t < self.n_tiers:
            raise ValueError(f"tier {tier!r} not in pool {self.names}")
        req = self.engines[t].submit(tokens, max_new_tokens=max_new_tokens,
                                     priority=priority, deadline_s=deadline_s,
                                     timeout_s=timeout_s,
                                     temperature=temperature)
        self._tier_of[req.rid] = t
        return req

    def _account(self, retired: List[Request]):
        for req in retired:
            # pop: the registry must not grow for the life of the process
            tier = self._tier_of.pop(req.rid)
            # the final tier bills only what it emitted itself: the token
            # split sums to n_generated
            billed_below = self._esc_billed.pop(req.rid, 0)
            if req.finish_reason == "rejected":
                # shed, not served: no call, or §2.3's metrics would count
                # traffic no tier ran
                self.meter.record_shed(tier)
                continue
            self.meter.record(np.array([tier]),
                              req.n_generated - billed_below)
            self.meter.record_robustness(
                tier, preemptions=req.preemptions,
                reprefill_tokens=req.reprefill_tokens,
                deadline_miss=req.finish_reason == "deadline")

    def _handoff(self, req: Request) -> None:
        """Deliver one escalated stream to the next tier up: bill the tier
        it leaves the tokens it emitted there (no call), move its registry
        entry up, log the hand-off and re-queue it there. A continuation
        the upper tier could never fit sheds there."""
        t = self._tier_of[req.rid]
        if t + 1 >= self.n_tiers:
            raise RuntimeError(
                f"stream {req.rid} escalated off the priciest tier "
                f"{self.names[t]!r}: monitor misconfiguration")
        billed = self._esc_billed.get(req.rid, 0)
        self.meter.record_escalation(t, req.n_generated - billed)
        self._esc_billed[req.rid] = req.n_generated
        self._tier_of[req.rid] = t + 1
        self.escalation_log.append((req.rid, t, t + 1, req.n_generated))
        self.engines[t + 1].resubmit(req)

    def _distinct_engines(self) -> List[ContinuousEngine]:
        """Engines deduped by identity, cheapest tier first: a tier may
        alias another's engine, which must still step (and reseed) once."""
        out: List[ContinuousEngine] = []
        for eng in self.engines:
            if not any(eng is e for e in out):
                out.append(eng)
        return out

    def step(self, stalled: Sequence[str] = ()) -> List[Request]:
        """Advance every engine with work by one step (see
        ContinuousEngine.step), cheapest tier first, with no cross-engine
        join, then hand each escalated stream up a tier. ``stalled`` names
        tiers that skip this step (a wedged device: its queue holds, the
        other tiers go on); their sheds and hand-offs, host-side
        bookkeeping, still drain. Returns the requests retired this
        step."""
        skip = [self.engine(n) for n in stalled]
        retired: List[Request] = []
        for eng in self._distinct_engines():
            retired.extend(eng.drain_shed())
            if eng.sched.has_work and not any(eng is s for s in skip):
                retired.extend(eng.step())
            for req in eng.drain_escalated():
                self._handoff(req)
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
