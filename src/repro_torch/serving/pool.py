"""Continuous model-pool serving: K tiers, one admission-time policy (the
port of ``repro.serving.pool``: ``StepPlan`` and ``ContinuousPoolEngine``).

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

With ``spec_gamma > 0`` a ``StepPlan`` links each expensive tier to its
next-cheaper sibling as a draft model (cross-tier speculative decoding:
the cheap tier drafts gamma tokens, the expensive tier verifies them in
one chunk; ``ContinuousEngine.attach_draft``). Tiers the capability check
refuses (window, SSM and hybrid stacks, one-shot prefill) keep plain
decode, recorded in ``plan.skipped``; a target whose draft tier is
stalled plain-decodes until the stall lifts. Shared-prefix reuse is per tier: each
engine built with ``prefix_cache > 0`` keeps its own tree over its own
pages.

``build_fused_pool_step`` is the reference's one-token K-tier decode step
over dense caches: the router scores the batch and every tier decodes all
of it. The reference lowers it as one XLA program; the port runs it
eagerly (no CUDA graph, no ``torch.compile``), each tier's step one dense
decode kernel launch a layer on the card.
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


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Which expensive tier drafts on which cheap one. ``gamma`` is the
    draft chunk per speculative round (0: no speculation, every engine
    steps on its own); ``pairs`` holds (draft_tier, target_tier) index
    pairs (tier t >= 1 drafts on t - 1); ``skipped`` each
    wanted pair the capability check refused, with the reason (such a
    target keeps plain decode)."""
    gamma: int = 0
    pairs: Tuple[Tuple[int, int], ...] = ()
    skipped: Tuple[Tuple[int, str], ...] = ()

    @property
    def draft_of(self) -> Dict[int, int]:
        """target tier index -> its draft tier index."""
        return {t: d for d, t in self.pairs}

    @staticmethod
    def _refusal(draft: ContinuousEngine, target: ContinuousEngine) -> str:
        """Why (draft, target) cannot speculate, "" when they can: the
        contract ``ContinuousEngine.attach_draft`` enforces by raising,
        checked first so a refusal keeps plain decode instead of failing
        the pool's construction."""
        if draft is target:
            return "draft and target tiers share one engine"
        tb, db = target.bundle, draft.bundle
        if tb.verify_paged_chunk is None:
            return (f"{tb.cfg.name}: recurrent state or sliding-window "
                    "layers cannot roll back a rejected draft suffix")
        if target.prefill_chunk == 0:
            return (f"{tb.cfg.name}: one-shot prefill — the verify chunk "
                    "rides the chunked-prefill machinery")
        if db.decode_step_paged is None or db.prefill_paged_chunk is None:
            return (f"{db.cfg.name}: a draft must serve paged with "
                    "chunked prefill")
        if db.init_recurrent_state is not None or db.cfg.has_window_layers:
            return (f"{db.cfg.name}: a draft must be pure global "
                    "attention (its cache mirrors the target's pages)")
        return ""

    @classmethod
    def build(cls, engines: Sequence[ContinuousEngine], gamma: int
              ) -> "StepPlan":
        """Pair each tier t >= 1 with tier t - 1 as its draft, keeping
        only the pairs the capability check approves."""
        if gamma < 0:
            raise ValueError(f"spec_gamma={gamma}: the draft-chunk length "
                             "cannot be negative (0 disables speculation)")
        if gamma == 0:
            return cls()
        ok: List[Tuple[int, int]] = []
        skipped: List[Tuple[int, str]] = []
        for t in range(1, len(engines)):
            reason = cls._refusal(engines[t - 1], engines[t])
            if reason:
                skipped.append((t, reason))
            else:
                ok.append((t - 1, t))
        return cls(gamma=gamma, pairs=tuple(ok), skipped=tuple(skipped))


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
                 spec_gamma: int = 0,
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
        # cross-tier speculation: each approved pair hosts its draft tier's
        # model inside the target engine
        self.plan = StepPlan.build(self.engines, spec_gamma)
        for d, t in self.plan.pairs:
            de = self.engines[d]
            self.engines[t].attach_draft(de.bundle, de.params,
                                         self.plan.gamma)
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
            if req.drafted_tokens and tier in self.plan.draft_of:
                # drafted tokens bill to the cheap tier (its model ran
                # them), accepted and rejected to the target: side columns,
                # so §2.3's metrics stay undiluted
                self.meter.record_spec(
                    self.plan.draft_of[tier], tier,
                    drafted=req.drafted_tokens,
                    accepted=req.accepted_tokens,
                    rejected=req.rejected_tokens)

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
        bookkeeping, still drain. A target whose draft tier is stalled
        steps with speculation off: it plain-decodes rather than wait on
        a wedged draft device, and its draft cache catches up when the
        stall lifts. Returns the requests retired this step."""
        skip = [self.engine(n) for n in stalled]
        stalled_idx = {self.names.index(n) for n in stalled}
        no_spec = [self.engines[t] for d, t in self.plan.pairs
                   if d in stalled_idx]
        retired: List[Request] = []
        for eng in self._distinct_engines():
            retired.extend(eng.drain_shed())
            if eng.sched.has_work and not any(eng is s for s in skip):
                retired.extend(eng.step(
                    spec=not any(eng is s for s in no_spec)))
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


def build_fused_pool_step(router_cfg, bundles: Sequence, thresholds:
                          Sequence[float]):
    """One-token K-tier decode step over dense caches.

    ``bundles`` are ordered cheapest -> priciest; ``thresholds`` are the
    K-1 non-increasing cascade gates (``core.thresholds
    .cascade_thresholds``).

    fn(router_model, models_tuple, router_tokens, router_mask,
       caches_tuple, token) -> (logits, caches_tuple, tier_idx)

    The router scores each query (``models.encoder.router_score``); its
    tier counts the gates its score falls below. Every tier decodes the
    full batch through its ``decode_step`` (caches updated in place), and
    each row takes its tier's logits. Vocabs may differ in padding, so
    logits align on the smallest padded width.
    """
    import torch
    from repro_torch.models.encoder import router_score
    thresholds = tuple(float(t) for t in thresholds)
    if len(thresholds) != len(bundles) - 1:
        raise ValueError(f"{len(bundles)} tiers need {len(bundles) - 1} "
                         f"cascade thresholds, got {len(thresholds)}")
    if any(a < b for a, b in zip(thresholds, thresholds[1:])):
        raise ValueError(f"cascade thresholds must be non-increasing: "
                         f"{thresholds}")

    @torch.no_grad()
    def step(router_model, models, router_tokens, router_mask, caches,
             token):
        score = router_score(router_model, router_tokens, router_mask,
                             router_cfg)
        tier = torch.zeros(score.shape, dtype=torch.int64,
                           device=score.device)                  # (B,)
        for t in thresholds:
            tier += (score < t).long()
        outs = [b.decode_step(m, c, token)
                for b, m, c in zip(bundles, models, caches)]
        V = min(lg.shape[-1] for lg, _ in outs)
        stacked = torch.stack([lg[:, :V] for lg, _ in outs])     # (K, B, V)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        logits = stacked[tier.to(stacked.device), rows]
        return logits, tuple(c for _, c in outs), tier

    return step
